"""Serving: the slot-layout KV cache and the fixed-batch speculative engine.

Import submodules explicitly (``repro_torch.serving.engine``,
``….kvcache``); this init stays empty to avoid model↔serving cycles.
"""
