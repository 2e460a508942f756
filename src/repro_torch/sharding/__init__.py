"""Distributed-optimization pieces (port of ``sharding/``): the int8
gradient compression only. The mesh rules and ``int8_psum`` wait for the
sharding item (ROADMAP Queue 1 item 5)."""
