"""Cassandra core: format transformation + speculative acceptance."""
