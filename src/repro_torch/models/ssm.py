"""Mamba-1 selective SSM mixer (port of ``models/ssm.py``): falcon-mamba's
blocks and Jamba's Mamba layers.

The recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t`` runs step by
step in f32, one position after another, where the reference combines
positions in a chunked associative scan (a tree). Both compute the same
function; they round differently. Step by step, the state a verify pass
reaches at position t is what an autoregressive step computes from the
state it committed at t-1, bit for bit, so speculative tokens can equal an
autoregressive run at the verify width exactly, as they do for the
attention models.

Decode carries ``(conv_state, h)``: the last (d_conv-1) inputs of the
causal conv and the SSM state. There is no KV cache, so Cassandra applies
through the weights only: the four projections go through ``L.dense``, so
a draft pass reads their packed draft views and a verify pass their exact
ones. ``conv_w``, ``conv_b``, ``A_log``, ``D`` and ``dt_bias`` are bare
leaves and never packed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import Runtime


def _selective_scan(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    h0: torch.Tensor, with_states: bool = False):
    """a, b (B,S,di,n) f32, c (B,S,n) f32, h0 (B,di,n) f32.

    Returns (y (B,S,di), h_final, h_all (B,S,di,n) or None): ``h_t = a_t
    h_{t-1} + b_t`` and ``y_t = h_t · c_t`` position by position, each step
    on (B,di,n) operands whatever S is; ``with_states`` stacks every
    position's ``h`` into ``h_all``. There is no chunk: the reference's
    ``chunk`` sizes its associative scan."""
    h = h0
    ys, states = [], []
    for t in range(a.shape[1]):
        h = torch.addcmul(b[:, t], a[:, t], h)
        ys.append(torch.matmul(h, c[:, t, :, None])[..., 0])
        if with_states:
            states.append(h)
    h_all = torch.stack(states, dim=1) if with_states else None
    return torch.stack(ys, dim=1), h, h_all


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 prepend: torch.Tensor | None):
    """Depthwise causal conv. x (B,S,di), w (dc,di); ``prepend`` the
    (B,dc-1,di) inputs before x (zeros when None). The taps are summed in
    the reference's order, in x's dtype. Returns (y, new_state)."""
    dc, s = w.shape[0], x.shape[1]
    if prepend is None:
        prepend = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    xw = torch.cat([prepend.to(x.dtype), x], dim=1)        # (B,S+dc-1,di)
    y = xw[:, 0:s] * w[0]
    for i in range(1, dc):
        y = y + xw[:, i:i + s] * w[i]
    return y + bias, xw[:, -(dc - 1):]


def mamba(rt: Runtime, p: dict, u: torch.Tensor, state: tuple | None = None,
          with_states: bool = False):
    """Mamba-1 mixer. u (B,S,d_model); state = (conv_state, h) or None.

    Returns (out (B,S,d_model), (conv_state, h), extras). The state is the
    one at the end of this call. ``with_states`` (decode) adds extras =
    {"h_all" (B,S,di,n), "conv_win" (B,S+dc-1,di)}, from which the state
    after any prefix of the S tokens is a slice (``engine.commit``). The
    reference's ``valid_len`` (dt = 0 on padded positions) has no port:
    a padded prefill chunk's state is taken at its last real token by the
    same slice (``engine.chunk_prefill_step``)."""
    cfg = rt.cfg
    bsz = u.shape[0]
    di, n, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_r

    xz = L.dense(rt, p["in_proj"], u, "ssm.in_proj")       # (B,S,2di)
    x, z = xz[..., :di], xz[..., di:]
    conv_state = state[0] if state is not None else None
    pre_conv_x = x
    x, new_conv = _causal_conv(x, p["conv_w"].to(x.dtype),
                               p["conv_b"].to(x.dtype), conv_state)
    x = F.silu(x.to(torch.float32)).to(u.dtype)

    dbc = L.dense(rt, p["x_proj"], x, "ssm.x_proj")        # (B,S,dtr+2n)
    dt_low = dbc[..., :dtr]
    b_mat = dbc[..., dtr:dtr + n].to(torch.float32)        # (B,S,n)
    c_mat = dbc[..., dtr + n:].to(torch.float32)
    dt = L.dense(rt, p["dt_proj"], dt_low, "ssm.dt_proj").to(torch.float32)
    dt = F.softplus(dt + p["dt_bias"].to(torch.float32))

    a_mat = -torch.exp(p["A_log"].to(torch.float32))       # (di,n)
    xf = x.to(torch.float32)
    a_bar = torch.exp(dt[..., None] * a_mat)               # (B,S,di,n)
    b_bar = (dt * xf)[..., None] * b_mat[:, :, None, :]    # (B,S,di,n)

    h0 = (state[1].to(torch.float32) if state is not None else
          torch.zeros((bsz, di, n), dtype=torch.float32, device=u.device))
    y, h_fin, h_all = _selective_scan(a_bar, b_bar, c_mat, h0,
                                      with_states=with_states)

    y = y + p["D"].to(torch.float32) * xf
    y = (y * F.silu(z.to(torch.float32))).to(u.dtype)
    out = L.dense(rt, p["out_proj"], y, "ssm.out_proj")
    extras = None
    if with_states:
        prep = (conv_state.to(pre_conv_x.dtype) if conv_state is not None
                else pre_conv_x.new_zeros((bsz, cfg.ssm_conv - 1, di)))
        extras = {"h_all": h_all,
                  "conv_win": torch.cat([prep, pre_conv_x], dim=1)}
    return out, (new_conv, h_fin), extras
