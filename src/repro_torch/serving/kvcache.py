"""KV cache, slot layout: plain bf16 or Cassandra-packed (port of the slot
half of ``serving/kvcache.py``).

Each (token, head) vector is packed online with magnitude top-k pruning,
mantissa truncation and unary/delta exponent coding against a
cache-global book; the verification side keeps raw pruned values and
8-bit corrections, so the target view is bit-exact for any vector.

Layout (R = repeats of the layer group; every request owns a contiguous
(S_max,) row)::

  attn (GQA)  {"k": store, "v": store}    store leaf (R,B,S,Hkv,1,*)

plain store = bf16 tensor; packed store = {"spec": {...}, "verif": {...}}.
The cache also carries ``length`` (B,) int32 and, when packed, the book
(``book_exp_of_rank``/``book_rank_of_exp``, 256 uint8 each).

Appends write into the cache's tensors in place (the reference returns
new arrays); callers never read a cache again after committing to it, so
no copy of the stores is ever needed. The paged layout is ROADMAP Queue 1
step 6.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, layer_groups
from repro_torch.core import format as fmt
from repro_torch.core.format import CassandraConfig

ONLINE_CORR_BITS = 8
_PAGED = ("the paged KV layout is not ported yet: ROADMAP Queue 1 step 6 "
          "(paged serving core)")


# ---------------------------------------------------------------------------
# Codebook
# ---------------------------------------------------------------------------

def default_kv_codebook(device="cpu"):
    """Generic frequency ranking: exponents ordered by distance from 125,
    the smaller exponent first on ties."""
    center = 125
    order = sorted(range(256), key=lambda e: (abs(e - center), e))
    exp_of_rank = torch.tensor(order, dtype=torch.uint8, device=device)
    rank_of_exp = torch.zeros(256, dtype=torch.uint8, device=device)
    rank_of_exp[exp_of_rank.to(torch.int64)] = torch.arange(
        256, device=device).clamp(max=255).to(torch.uint8)
    return exp_of_rank, rank_of_exp


def cache_codebook(cache: dict):
    if "book_exp_of_rank" not in cache:
        return None
    return cache["book_exp_of_rank"], cache["book_rank_of_exp"]


# ---------------------------------------------------------------------------
# Per-vector codec (block = vector dim)
# ---------------------------------------------------------------------------

def is_packed(store) -> bool:
    return isinstance(store, dict) and "spec" in store


def encode_store(cass: CassandraConfig, x: torch.Tensor, d: int,
                 codebook) -> dict:
    """Pack (..., d) bf16 vectors into a {"spec", "verif"} store."""
    scores = x.to(torch.float32).abs()
    spec, verif = fmt.format_tensor(
        x, scores, cass, d, cass.kv_keep(d), fmt.kv_group(cass, d),
        cass.kv_trunc, codebook=codebook, corr_bits=ONLINE_CORR_BITS,
        pruned_raw=True)
    return {"spec": spec, "verif": verif}


def read_store(cass: CassandraConfig, store, d: int, view: str,
               codebook) -> torch.Tensor:
    """Materialise dense (..., d) bf16 from a store per the runtime view."""
    if not is_packed(store):
        return store
    keep = cass.kv_keep(d)
    if view == "draft":
        out = fmt.draft_tensor(store["spec"], cass, d, keep,
                               fmt.kv_group(cass, d), cass.kv_trunc, d,
                               codebook=codebook, corr_bits=ONLINE_CORR_BITS)
    else:
        out = fmt.target_tensor(store["spec"], store["verif"], cass, d, keep,
                                fmt.kv_group(cass, d), cass.kv_trunc, d,
                                codebook=codebook,
                                corr_bits=ONLINE_CORR_BITS)
    return out.reshape(*store["spec"]["bitmap"].shape[:-2], d)


def _zip_leaves(store, new_store):
    if not is_packed(store):
        return [(store, new_store)]
    return [(store[z][k], new_store[z][k])
            for z in ("spec", "verif") for k in store[z]]


def append_store(store, new_store, at: int):
    """Write every leaf's new (B,q,…) run at S offset ``at`` (axis 1)."""
    for c, n in _zip_leaves(store, new_store):
        c[:, at:at + n.shape[1]] = n.to(c.dtype)
    return store


def row_slots(pos: torch.Tensor, s: int):
    """Where rows' runs land in (B,S,…) leaves: row b's run at slots
    ``pos[b]`` (B,q) ascending. Slots past S are dropped, as the
    reference's scatter drops them: each such write is sent to a slot the
    run leaves alone (the row's slot before ``pos[b, 0]``, or S-1 when the
    whole run is past S) and stores that slot's own value back, so no
    result depends on which of two writes to one slot wins. Computed once
    and shared by every leaf the runs go to. Returns (rows, slot, inside)."""
    pos = pos.to(torch.int64)
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    inside = pos < s
    spare = (pos[:, :1] - 1).clamp(0, s - 1)
    return rows, torch.where(inside, pos, spare), inside


def write_rows(dst: torch.Tensor, new: torch.Tensor, slots) -> torch.Tensor:
    """Write ``new`` (B,q,…) into ``dst`` (B,S,…) in place at ``slots``
    (``row_slots``)."""
    rows, slot, inside = slots
    keep = inside.reshape(*inside.shape, *([1] * (new.ndim - 2)))
    dst[rows, slot] = torch.where(keep, new.to(dst.dtype), dst[rows, slot])
    return dst


def append_store_batched(store, new_store, at: torch.Tensor):
    """Per-row append: leaf (B,S,…) gets new (B,q,…) at row offsets ``at``.

    Rows accept different counts, so each writes at its own offset; slots
    past a row's committed length hold stale data the validity mask hides.
    A row that runs past its (S,) region (a fast row of a batch still
    waiting on its slowest one) has those writes dropped (``row_slots``).
    """
    leaves = _zip_leaves(store, new_store)
    c, n = leaves[0]
    slots = row_slots(at.to(torch.int64)[:, None]
                      + torch.arange(n.shape[1], device=c.device), c.shape[1])
    for c, n in leaves:
        write_rows(c, n, slots)
    return store


def append_batched(store, new_store, at: torch.Tensor, table=None):
    """The append path; the slot layout only in this slice."""
    if table is not None:
        raise NotImplementedError(_PAGED)
    return append_store_batched(store, new_store, at)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def _store_struct(cass, lead: tuple, d: int, packed: bool):
    """(shape, dtype) table of one store: a packed store's leaf shapes come
    from encoding one zero vector on the CPU."""
    if not packed:
        return (*lead, d), torch.bfloat16
    one = encode_store(cass, torch.zeros((1, d), dtype=torch.bfloat16), d,
                       default_kv_codebook())
    return {z: {k: ((*lead, *t.shape[1:]), t.dtype)
                for k, t in one[z].items()} for z in ("spec", "verif")}


def cache_specs(cfg: ModelConfig, cass: CassandraConfig | None, b: int,
                s_max: int, packed: bool) -> dict:
    """Plain shape table of the full cache: leaves are (shape, dtype)."""
    if cfg.cross_attention or cfg.mla or cfg.sub_quadratic:
        raise NotImplementedError(
            f"{cfg.name}: the port's cache holds GQA stores only; MLA, SSM "
            "and cross-attention caches are ROADMAP Queue 1 step 9")
    cache: dict = {"dec": [], "length": ((b,), torch.int32)}
    for g in layer_groups(cfg):
        lead = (g.repeats, b, s_max, cfg.n_kv_heads)
        cache["dec"].append({
            f"e{j}": {"k": _store_struct(cass, lead, cfg.hd, packed),
                      "v": _store_struct(cass, lead, cfg.hd, packed)}
            for j in range(len(g.entries))})
    if packed:
        cache["book_exp_of_rank"] = ((256,), torch.uint8)
        cache["book_rank_of_exp"] = ((256,), torch.uint8)
    return cache


def _install_book(cache: dict, codebook) -> dict:
    device = cache["length"].device
    book = codebook or default_kv_codebook(device)
    eor = torch.zeros(256, dtype=torch.uint8, device=device)
    eor[:book[0].shape[0]] = book[0]
    cache["book_exp_of_rank"] = eor
    cache["book_rank_of_exp"] = book[1].to(device)
    return cache


def init_cache(cfg: ModelConfig, cass: CassandraConfig | None, b: int,
               s_max: int, packed: bool, codebook=None,
               device="cuda") -> dict:
    """Allocate a zeroed slot cache on ``device``."""
    def alloc(node):
        if isinstance(node, dict):
            return {k: alloc(v) for k, v in node.items()}
        if isinstance(node, list):
            return [alloc(v) for v in node]
        shape, dtype = node
        return torch.zeros(shape, dtype=dtype, device=device)

    cache = alloc(cache_specs(cfg, cass, b, s_max, packed))
    if packed:
        cache = _install_book(cache, codebook)
    return cache
