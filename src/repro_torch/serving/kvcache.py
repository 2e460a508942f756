"""KV cache: plain bf16 or Cassandra-packed, in the slot or the paged
layout (port of ``serving/kvcache.py``).

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

Two layouts share the store codecs:

* **slot** (``init_cache``) — every request owns a contiguous ``(S_max,)``
  row: leaves (R,B,S_max,…);
* **paged** (``init_paged_cache``) — stores hold a pool of fixed-size
  token blocks shared by all rows, leaves (R,NB,BS,…), addressed through a
  per-row ``block_table`` (B,MB) int32. Block 0 is the trash block
  (``serving.blockpool``): unmapped table entries point at it.

Appends write into the cache's tensors in place (the reference returns
new arrays); callers never read a cache again after committing to it, so
no copy of the stores is ever needed. Block copies, spill and restore
(prefix cache, swap) are ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, layer_groups
from repro_torch.core import format as fmt
from repro_torch.core.format import CassandraConfig
from repro_torch.serving.blockpool import TRASH_BLOCK

ONLINE_CORR_BITS = 8


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


def is_paged(cache: dict) -> bool:
    return "block_table" in cache


def gather_block_leaf(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(NB,BS,…) pool + (B,MB) table -> (B,MB*BS,…) request-major copy.

    Out-of-range table entries read the trash block (index 0), as the
    paged-attention kernels do."""
    nb = pool.shape[0]
    ok = (table >= 0) & (table < nb)
    idx = torch.where(ok, table, TRASH_BLOCK).to(torch.int64)
    out = pool[idx]                                        # (B,MB,BS,…)
    return out.reshape(table.shape[0], table.shape[1] * pool.shape[1],
                       *pool.shape[2:])


def gather_store(store, table: torch.Tensor):
    """Pool store (NB,BS,…) + table (B,MB) -> per-request store (B,MB*BS,…),
    leaf by leaf (packed stores gather without decoding)."""
    if not is_packed(store):
        return gather_block_leaf(store, table)
    return {z: {k: gather_block_leaf(v, table) for k, v in store[z].items()}
            for z in ("spec", "verif")}


def append_paged_batched(store, new_store, table: torch.Tensor,
                         at: torch.Tensor):
    """Scatter per-row runs into the block pool through the table, in place.

    ``store`` leaves (NB,BS,…); ``new_store`` leaves (B,q,…); row ``b``
    writes at logical positions ``at[b]+i``, physical slot
    ``table[b, pos//BS]*BS + pos%BS``. Positions past the row's table or
    on an unmapped entry go to the trash block and store that slot's own
    value back, so the trash block never changes and no result depends on
    which of two writes to one slot wins (real blocks belong to one row
    each, so only trash slots are written twice)."""
    leaves = _zip_leaves(store, new_store)
    c, n = leaves[0]
    nb, bs = c.shape[0], c.shape[1]
    b, q = n.shape[0], n.shape[1]
    mb = table.shape[1]
    pos = at.to(torch.int64)[:, None] + torch.arange(q, device=c.device)
    lblk = pos // bs
    phys = torch.gather(table.to(torch.int64), 1, lblk.clamp(max=mb - 1))
    phys = torch.where((lblk < mb) & (phys > TRASH_BLOCK) & (phys < nb),
                       phys, TRASH_BLOCK)
    idx = (phys * bs + pos % bs).reshape(-1)
    keep = (phys != TRASH_BLOCK).reshape(-1)
    for c, n in leaves:
        flat = c.view(nb * bs, *c.shape[2:])
        new = n.to(c.dtype).reshape(b * q, *n.shape[2:])
        k = keep.reshape(-1, *([1] * (new.ndim - 1)))
        flat[idx] = torch.where(k, new, flat[idx])
    return store


def append_batched(store, new_store, at: torch.Tensor, table=None):
    """THE append path: per-row runs into either layout (``table`` None:
    the row's slot region; a (B,MB) table: the block pool)."""
    if table is None:
        return append_store_batched(store, new_store, at)
    return append_paged_batched(store, new_store, table, at)


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


def _alloc(node, device):
    """Zeroed tensors for a (shape, dtype) table."""
    if isinstance(node, dict):
        return {k: _alloc(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_alloc(v, device) for v in node]
    shape, dtype = node
    return torch.zeros(shape, dtype=dtype, device=device)


def init_cache(cfg: ModelConfig, cass: CassandraConfig | None, b: int,
               s_max: int, packed: bool, codebook=None,
               device="cuda") -> dict:
    """Allocate a zeroed slot cache on ``device``."""
    cache = _alloc(cache_specs(cfg, cass, b, s_max, packed), device)
    if packed:
        cache = _install_book(cache, codebook)
    return cache


def paged_cache_specs(cfg: ModelConfig, cass: CassandraConfig | None, b: int,
                      num_blocks: int, block_size: int, max_blocks: int,
                      packed: bool) -> dict:
    """Plain shape table of a paged cache: stores become block pools
    (R,NB,BS,…) shared by all rows; ``block_table`` (B,MB) maps each row's
    logical blocks to pool blocks; ``length`` stays (B,)."""
    cache = cache_specs(cfg, cass, num_blocks, block_size, packed)
    cache["length"] = ((b,), torch.int32)
    cache["block_table"] = ((b, max_blocks), torch.int32)
    return cache


def init_paged_cache(cfg: ModelConfig, cass: CassandraConfig | None, b: int,
                     num_blocks: int, block_size: int, max_blocks: int,
                     packed: bool, codebook=None, device="cuda") -> dict:
    """Allocate a zeroed paged cache on ``device``; every table entry starts
    at the trash block (0)."""
    cache = _alloc(paged_cache_specs(cfg, cass, b, num_blocks, block_size,
                                     max_blocks, packed), device)
    if packed:
        cache = _install_book(cache, codebook)
    return cache
