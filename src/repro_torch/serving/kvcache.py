"""KV cache: plain bf16 or Cassandra-packed, in the slot or the paged
layout (port of ``serving/kvcache.py``).

Each (token, head) vector is packed online with magnitude top-k pruning,
mantissa truncation and unary/delta exponent coding against a
cache-global book; the verification side keeps raw pruned values and
8-bit corrections, so the target view is bit-exact for any vector. On the
card a Cassandra-1 store's encode is one ``kv_encode`` launch and each
view one ``kv_view`` launch (Cassandra-2: ``kv_topk`` in the format's
chain, one ``mx_view`` per view); on the CPU the format's chains run
(``encode_store_plain`` / ``read_store_plain``).

Layout (R = repeats of the layer group; every request owns a contiguous
(S_max,) row)::

  attn (GQA)  {"k": store, "v": store}    store leaf (R,B,S,Hkv,1,*)
  attn (MLA)  {"c": store, "kr": store}   latent + rope key, (R,B,S,1,*)

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
(prefix cache, swap) are ROADMAP Queue 1.

MLA stores pack like GQA's when their widths are multiples of 32 (the
32-lane bitmap): DeepSeek-V3's ``c`` (512) and ``kr`` (64) both do, and
the reference packs them under Cassandra-1 too. A 16-wide rope key (the
reference's SMOKE config) cannot pack in either package.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, layer_groups
from repro_torch.core import format as fmt
from repro_torch.core.format import CassandraConfig
from repro_torch.kernels import kv_topk as KT
from repro_torch.kernels import mx_decode as MXD
from repro_torch.kernels import unary_decode as UD
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
    """Pack (..., d) bf16 vectors into a {"spec", "verif"} store. A
    Cassandra-1 store on the card is one ``kv_encode`` launch; every other
    store runs the format's chain :func:`encode_store_plain`."""
    if cass.variant == 1 and x.is_cuda:
        if codebook is None:
            raise ValueError("encode_store: a Cassandra-1 store on the card "
                             "packs against the cache-global book")
        spec, verif = KT.kv_encode(
            x.to(torch.bfloat16).contiguous(), codebook[1],
            keep=cass.kv_keep(d), trunc=cass.kv_trunc,
            exp_bits=cass.exp_bits)
        return {"spec": spec, "verif": verif}
    return encode_store_plain(cass, x, d, codebook)


def encode_store_plain(cass: CassandraConfig, x: torch.Tensor, d: int,
                       codebook) -> dict:
    """The format's chain (``format.format_tensor`` at one block per
    vector; its magnitude selection through ``kernels.kv_topk``): what
    ``kv_encode`` is held to, and what CPU tensors and Cassandra-2 run."""
    spec, verif = fmt.format_tensor(
        x, None, cass, d, cass.kv_keep(d), fmt.kv_group(cass, d),
        cass.kv_trunc, codebook=codebook, corr_bits=ONLINE_CORR_BITS,
        pruned_raw=True)
    return {"spec": spec, "verif": verif}


def read_store(cass: CassandraConfig, store, d: int, view: str,
               codebook) -> torch.Tensor:
    """Materialise dense (..., d) bf16 from a store per the runtime view.
    On the card a Cassandra-1 store is one ``kv_view`` launch and a
    Cassandra-2 store one ``mx_view`` launch; a store on the CPU runs the
    format's chain :func:`read_store_plain`."""
    if not is_packed(store):
        return store
    if not store["spec"]["bitmap"].is_cuda:
        return read_store_plain(cass, store, d, view, codebook)
    verif = None if view == "draft" else store["verif"]
    if cass.variant == 1:
        book = store["spec"].get("codebook")
        return UD.kv_view(store["spec"], verif,
                          codebook[0] if book is None else book, d=d,
                          keep=cass.kv_keep(d), trunc=cass.kv_trunc,
                          exp_bits=cass.exp_bits)
    return MXD.mx_view(store["spec"], verif, block=d, keep=cass.kv_keep(d),
                       group=fmt.kv_group(cass, d),
                       draft_bits=cass.mx_draft_bits)


def read_store_plain(cass: CassandraConfig, store: dict, d: int, view: str,
                     codebook) -> torch.Tensor:
    """The format's chain (``format.draft_tensor`` / ``target_tensor``; a
    Cassandra-1 exponent decode through ``unary_decode``): what ``kv_view``
    is held to, and what CPU stores run."""
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

def store_dims(cfg: ModelConfig) -> dict:
    """Each attention entry's stores and their vector widths: GQA's
    per-head K and V, or MLA's latent ``c`` and rope key ``kr``."""
    if cfg.mla:
        return {"c": cfg.kv_lora_rank, "kr": cfg.qk_rope_dim}
    return {"k": cfg.hd, "v": cfg.hd}


def store_heads(cfg: ModelConfig) -> tuple:
    """The head axis of a store leaf: (Hkv,) for GQA, none for MLA (one
    latent per token, shared by every head)."""
    return () if cfg.mla else (cfg.n_kv_heads,)


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
    if cfg.cross_attention or cfg.sub_quadratic:
        raise NotImplementedError(
            f"{cfg.name}: the port's cache holds GQA and MLA stores only; "
            "SSM and cross-attention caches are ROADMAP Queue 1")
    cache: dict = {"dec": [], "length": ((b,), torch.int32)}
    for g in layer_groups(cfg):
        lead = (g.repeats, b, s_max, *store_heads(cfg))
        cache["dec"].append({
            f"e{j}": {nm: _store_struct(cass, lead, d, packed)
                      for nm, d in store_dims(cfg).items()}
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
