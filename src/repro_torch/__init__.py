"""PyTorch/CUDA port of the Cassandra reproduction (NVIDIA Hopper).

Mirrors the JAX package's subpackages (``configs``, ``core``, ``kernels``,
``models``, ``serving``, ``launch``) so each module has a counterpart of
the same name. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; asking for the card without CUDA raises.

It covers decoders with GQA or MLA attention or Mamba-1 mixers (falcon-
mamba, the Jamba hybrid) and dense or MoE FFNs under Cassandra-1 and -2:
the fixed-batch speculative engine and the paged continuous-batching
scheduler (prefix cache and preemption with host swap for attention-only
models), greedy or with rejection sampling (paper Eq. 1) from a
``torch.Generator``, and Wanda calibration. Encoder-decoder and frontend
models raise ``NotImplementedError`` naming the ROADMAP step that brings
them.
"""
