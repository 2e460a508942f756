"""PyTorch/CUDA port of the Cassandra reproduction (NVIDIA Hopper).

Mirrors the JAX package's subpackages (``configs``, ``core``, ``kernels``,
``models``, ``serving``, ``training``, ``data``, ``checkpoint``,
``sharding``, ``launch``) so each module has a counterpart of the same
name. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; asking for the card without CUDA raises.

It covers every architecture the reference registers (decoders with GQA
or MLA attention or Mamba-1 mixers, dense or MoE FFNs, the encoder-
decoder audio family and a vision frontend's backbone) under Cassandra-1
and -2: the fixed-batch speculative engine and the paged continuous-
batching scheduler (prefix cache and preemption with host swap for
attention-only models), greedy or with rejection sampling (paper Eq. 1)
from a ``torch.Generator``, and Wanda calibration. Training: AdamW with
fp32 or int8 moments, the chunked CE loss and its backward (autograd,
optional remat), microbatch accumulation, int8 gradient compression, the
synthetic data stream, checkpoints in the reference's format and the
fault-tolerant trainer ``launch/train.py``. Format selection: the
paper's Eq. 2 grid search (``core/dse.py``), the exponent statistics of
Fig. 6 (``coding.shannon_entropy`` / ``avg_code_bits``),
``format.compression_summary`` and a calibrated KV codebook
(``kvcache.calibrate_kv_codebook``). Not ported yet (ROADMAP Queue 1):
the paper-figure drivers and examples (item 2), and ``sharding/rules.py``,
``collectives.int8_psum`` and ``launch/mesh.py`` / ``dryrun.py`` /
``roofline.py`` (item 4).
"""
