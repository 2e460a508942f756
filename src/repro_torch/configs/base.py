"""Model configuration schema (port of the reference ``configs/base.py``).

The dataclass and ``layer_groups`` are field-for-field the reference's so
the two packages describe the same model. Per-layer structure is a
repeating ``block_pattern`` of two-character codes::

    first char  — mixer:  'a' attention (GQA/MLA)   's' mamba-1 SSM
    second char — ffn:    'm' dense MLP   'M' MoE   '-' none

``layer_groups`` stacks consecutive repeats of the pattern period along a
leading R axis; the port walks that axis with a Python loop.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    ffn_act: str = "swiglu"          # swiglu | relu2 | gelu
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    moe_d_ff: int = 0
    # --- MLA ---
    mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    mtp_depth: int = 0
    # --- SSM ---
    block_pattern: tuple[str, ...] = ("am",)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0
    # --- enc-dec / modality frontends ---
    n_encoder_layers: int = 0
    cross_attention: bool = False
    frontend: str = ""
    frontend_tokens: int = 0
    causal_encoder: bool = False
    max_wavelength_pos: int = 4096

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_r(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def attn_free(self) -> bool:
        return all(e[0] != "a" for e in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        return any(e[0] == "s" for e in self.block_pattern)

    def pattern_for_layer(self, i: int) -> str:
        if i < self.first_dense_layers:
            base = self.block_pattern[i % len(self.block_pattern)]
            return base[0] + ("m" if base[1] == "M" else base[1])
        return self.block_pattern[i % len(self.block_pattern)]


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    """A stacked group: ``repeats`` copies of the ``entries`` period."""
    entries: tuple[str, ...]
    repeats: int


def layer_groups(cfg: ModelConfig) -> list[LayerGroup]:
    """Split the decoder stack into homogeneous stacked groups."""
    groups: list[LayerGroup] = []
    period = len(cfg.block_pattern)
    fd = cfg.first_dense_layers
    if fd:
        entries = tuple(cfg.pattern_for_layer(i) for i in range(fd))
        if len(set(entries)) == 1:
            groups.append(LayerGroup((entries[0],), fd))
        else:
            groups.append(LayerGroup(entries, 1))
    rest = cfg.n_layers - fd
    if rest:
        if rest % period != 0:
            raise ValueError(
                f"{cfg.name}: {rest} layers not a multiple of pattern "
                f"period {period}")
        groups.append(LayerGroup(cfg.block_pattern, rest // period))
    return groups
