"""PyTorch/CUDA port of the Cassandra reproduction (NVIDIA Hopper).

Mirrors the JAX package's subpackages (``configs``, ``core``, ``kernels``,
``models``, ``serving``, ``launch``) so each module has a counterpart of
the same name. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; asking for the card without CUDA raises.

It covers dense decoders with GQA or MLA attention under Cassandra-1 and
-2: the fixed-batch speculative engine and the paged continuous-batching
scheduler (prefix cache, preemption with host swap), greedy or with
rejection sampling (paper Eq. 1) from a ``torch.Generator``, and Wanda
calibration. Everything else raises ``NotImplementedError`` naming the
ROADMAP step that brings it.
"""
