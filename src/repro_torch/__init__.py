"""PyTorch/CUDA port of the Cassandra reproduction (NVIDIA Hopper).

Mirrors the JAX package's subpackages (``configs``, ``core``, ``kernels``,
``models``, ``serving``, ``launch``) so each module has a counterpart of
the same name. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; asking for the card without CUDA raises.

This slice covers the dense-GQA, Cassandra-1, greedy path of the
fixed-batch speculative engine. Everything off that path raises
``NotImplementedError`` naming the ROADMAP step that brings it.
"""
