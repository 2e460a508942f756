"""Dense GQA model: layers, attention, SwiGLU FFN and the forwards.

Import modules explicitly (``repro_torch.models.model`` …).
"""
