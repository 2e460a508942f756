"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Import modules explicitly (``repro_torch.kernels.draft_matmul``); the CUDA
sources under ``csrc/`` build at first use (``kernels.build``).
"""
