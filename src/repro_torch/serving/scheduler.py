"""Continuous-batching speculative serving scheduler (port of
``serving/scheduler.py``).

Many independent requests are multiplexed through one serving step per
cycle; requests are admitted and retired per row, so no row waits for the
slowest one.

* **Fused serving step (default)** — ``step()`` is a planner: each cycle
  it builds one ``CyclePlan`` (which rows consume prompt-chunk tokens,
  which run a draft+verify cycle, which idle) and runs it with one
  ``engine.unified_step`` at the verify width γ+1, so admission rides on
  decode cycles. ``max_prefill_tokens_per_step`` caps the cycle's prefill
  tokens. A second, wide ``chunk_size`` bucket (``chunk_prefill_step``)
  serves the cycles where riding is wrong: an empty decode pool, or a
  token-cost comparison showing riding is dearer than one stall of the
  resident decode rows (``_plan_wide_cycle``).
* **Alternating mode** (``fused=False``) — cycles alternate between
  ``chunk_prefill_step`` (decode rows frozen) and ``spec_decode_step``
  (prefilling rows frozen): the losslessness baseline.
  ``speculative=False`` (autoregressive) always uses it.
* **Cache layouts** — ``paged=False``: a fixed (B, S_max) slot cache;
  ``paged=True``: a pool of fixed-size token blocks shared by all rows,
  addressed through per-row block tables (``serving.blockpool``). A
  request reserves its worst-case blocks at admission and allocates them
  as it grows. ``attn_kernel="on"`` walks the tables in the paged
  attention kernels instead of gathering each row's prefix.
* **Prefix sharing** (``prefix_cache=True``, paged only) — a host-side
  radix index (``serving.prefixcache``) maps block-aligned prompt-prefix
  runs to ref-counted pool blocks. Admission matches the longest cached
  prefix, aliases the matched blocks into the row's table, seeds
  ``pos``/``length`` past the matched tokens and reserves only the
  unshared blocks; prefill then starts mid-prompt. A request diverging
  inside a cached block gets a fresh block and one block copy
  (copy-on-write, ``kvcache.copy_pool_blocks``); shared blocks are never
  written. Retired requests park their indexed blocks: resident, and
  evicted least recently used first when reservations need the space.
  The index persists across ``reset()``. Prefill chunks end on multiples
  of the pass width (``_chunk_len``) and a target pass's attention suffix
  starts on that grid (``engine.window_start``), so a prompt token gets
  the same bits whether its row's prefill started at 0, after a hit or
  at a resume: the paged kernels' pool walk and the suffix merge sum in
  an order that depends on where the suffix starts.
* **Preemption + host swap** (``swap=True``, paged only) — when the
  queue head cannot reserve (blocks or slots), the victim policy may swap
  a resident row out: its committed blocks are gathered on the device
  (``kvcache.spill_pool_blocks``) into pinned host buffers of a
  ``SpillStore`` (``serving.swapstore``), its blocks and reservation
  return to the pool, and the head admits at once. The victim requeues
  and resumes as an ordinary admission: a prefix match re-aliases what
  the cache still holds, and ``kvcache.restore_pool_blocks`` brings back
  the rest bit for bit. Victims: the lowest priority first, only rows
  whose remaining work exceeds the head's time to first token plus the
  swap margin, and among equal priorities only rows with more remaining
  work than the head (no thrashing between two long rows); in goodput
  mode a row whose live SLO is still winnable is never a victim.
* **Retirement** — per row on ``max_new``, the global ``eos_id`` or any of
  the request's ``stop_tokens``; the slot and its blocks free at once.
* **Async overlap** (``overlap=True``, fused mode's default) — a
  one-cycle-deep dispatch/harvest pipeline in CUDA stream order. A
  dispatch enqueues the step and the copies of its results into pinned
  host buffers, then records one event; the next call waits on that event
  (the one sync per cycle) and folds the results in. Whenever a decision
  could read stale state (queued requests, prefilling rows) the call
  drains first. On pure-decode stretches it free-runs: it dispatches
  first, chaining ``cur`` off the in-flight cycle's ``next_token`` on the
  device with the device-authoritative ``length`` (``engine.commit``
  advances it in the step), then harvests the previous cycle. A row
  retired one cycle late rides one more cycle as a *zombie* whose results
  are discarded. Host arrays reach the device through pinned copies, so
  no push waits for the in-flight step. A spill's device-to-host copies
  and a restore's scatter are enqueued in the same stream order (so no
  later step can rewrite a freed block before its copy is taken, and the
  next step reads restored blocks) and are waited on, each on its own
  event, at the next harvest.
* **Latency accounting** — every delivered token records its cycle and
  wall time; ``summary()`` reports TTFT and inter-token latency.

jit retraces have no eager counterpart: each step instead records the
operand shapes it was dispatched with (``step_shapes``; ``trace_counts``
counts them per step), the bucket discipline a CUDA graph per step needs.

Non-greedy decoding (``EngineConfig(greedy=False)``) draws from the
scheduler's ``generator`` (default: seeded with 0 on its device) on the
stream that runs the cycle, in dispatch order; such a run never free-runs
(``_free_run_ok``), so overlap on and off draw alike.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.format import CassandraConfig
from repro_torch.models.layers import Runtime
from repro_torch.serving import kvcache as KC
from repro_torch.serving import telemetry as TM
from repro_torch.serving.blockpool import (BlockAllocator, TRASH_BLOCK,
                                          blocks_needed)
from repro_torch.serving.costmodel import CostModel
from repro_torch.serving.engine import (EngineConfig, autoregressive_step,
                                        chunk_prefill_step, spec_decode_step,
                                        unified_step, validate_request_slos,
                                        validate_serving_knobs)
from repro_torch.serving.prefixcache import PrefixCache, PrefixMatch
from repro_torch.serving.swapstore import SpillStore
from repro_torch.serving.telemetry import Telemetry

QUEUED, RUNNING, FINISHED = "queued", "running", "finished"
# preempted: swapped out to the host SpillStore, waiting to resume
SWAPPED = "swapped"

# cycles a preemption is budgeted to cost the victim (spill + restore):
# part of the bar the queue head's TTFT gain must clear
SWAP_MARGIN_CYCLES = 2


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request moving through the scheduler lifecycle.

    ``priority`` orders admission (higher first among ready requests, FIFO
    within a priority) and shields against preemption (lower priority
    preempted first). A preempted request carries its ``swap_key`` into
    the host ``SpillStore`` until it resumes. ``ttft_deadline_ms`` /
    ``itl_target_ms`` are per-request SLOs: once any request declares one,
    admission order, the wide-cycle choice and the preemption victims
    switch to deadline-hit goodput. SLOs never change a request's tokens,
    only when they land."""
    rid: int
    tokens: np.ndarray                  # (L,) int prompt
    max_new: int
    arrival: float = 0.0                # scheduler-clock cycle of arrival
    stop_tokens: tuple = ()             # per-request stop ids (besides eos)
    priority: int = 0
    ttft_deadline_ms: float | None = None
    itl_target_ms: float | None = None
    state: str = QUEUED
    slot: int = -1
    pos: int = 0                        # prompt tokens prefilled so far
    prefix_matched: int = 0             # prompt tokens seeded from the cache
    prefill_done: bool = False
    output: list = dataclasses.field(default_factory=list)
    token_cycles: list = dataclasses.field(default_factory=list)
    token_walls: list = dataclasses.field(default_factory=list)
    admitted_at: float = -1.0
    finished_at: float = -1.0
    swap_key: object = None             # SpillStore key while SWAPPED
    preemptions: int = 0                # times this request was swapped out

    @property
    def done(self) -> bool:
        return self.state == FINISHED

    @property
    def ttft_cycles(self) -> float | None:
        if not self.token_cycles:
            return None
        return self.token_cycles[0] - self.arrival

    @property
    def itl_cycles(self) -> np.ndarray:
        return np.diff(np.asarray(self.token_cycles, np.float64))

    @property
    def has_slo(self) -> bool:
        return (self.ttft_deadline_ms is not None
                or self.itl_target_ms is not None)


@dataclasses.dataclass
class CyclePlan:
    """One fused cycle's work descriptor: ``chunk_tokens`` (slots, γ+1) /
    ``prefill_valid`` (slots,) carry each prefilling row's next prompt
    tokens; ``decode_mask`` (slots,) marks draft+verify rows; the rest
    idle frozen."""
    chunk_tokens: np.ndarray
    prefill_valid: np.ndarray
    decode_mask: np.ndarray
    prefilling: list
    decoding: list


@dataclasses.dataclass
class PendingCycle:
    """One dispatched, unharvested cycle: the pipeline's depth-1 record.

    ``host`` are pinned host buffers whose copies from the step's results
    were enqueued right after the step; ``done`` is the CUDA event
    recorded after them (None on the CPU, where the copies are the
    results themselves). ``res`` keeps the unified step's device results,
    so a free-running dispatch can chain ``cur`` off ``res.next_token``.
    ``clock`` is the scheduler clock at dispatch: harvest-side stamps
    book to the cycle that produced them."""
    kind: str                   # "unified" | "chunk" (wide admission)
    plan: CyclePlan | None      # unified cycles
    prefilling: list            # chunk cycles: rows fed this chunk
    valid: np.ndarray | None    # chunk cycles: per-slot token counts
    res: object                 # unified: AcceptResult on the device
    host: tuple                 # host copies of the results
    done: object                # event after the copies, or None
    clock: float
    t0: float                   # perf_counter at dispatch start
    t_dispatch: float           # perf_counter when dispatch returned


def _stage_to_host(tensors: tuple) -> tuple:
    """Enqueue copies of step results into pinned host buffers and record
    one event after them. Returns (host tensors, event or None)."""
    if tensors[0].device.type != "cuda":
        return tuple(tensors), None
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    done = torch.cuda.Event()
    done.record()
    return tuple(host), done


def _land(p: PendingCycle) -> tuple:
    """The pipeline's one sync per cycle: wait for ``p``'s host copies;
    returns them as numpy arrays."""
    if p.done is not None:
        p.done.synchronize()
    return tuple(h.numpy() for h in p.host)


# ---------------------------------------------------------------------------
# Masked steps: a step runs every row; rows not active in it keep their
# ``length`` (their KV writes land past it: masked stale data in the slot
# layout, their own stale region or the trash block in the paged one) and
# their SSM state.
# ---------------------------------------------------------------------------

def _ssm_entries(cache: dict) -> list:
    """(entry, conv, h) of every SSM entry of ``cache``: the state tensors
    a step starts from."""
    return [(e, e["conv"], e["h"]) for g in cache["dec"] for e in g.values()
            if KC.is_ssm(e)]


def _freeze_rows(length0: torch.Tensor, ssm0: list, cache: dict,
                 active: torch.Tensor) -> dict:
    """Pin the per-row live state of rows not active in the step: their
    ``length``, and their SSM ``conv`` and ``h`` (reference
    ``_freeze_rows``). ``engine.commit`` replaces an SSM entry's tensors
    and never writes into them, so the tensors the step started from
    (``ssm0``, from ``_ssm_entries``) are still intact: a ``torch.where``
    on the device puts them back for inactive rows, inside the dispatched
    work, with no copy beforehand and no host sync."""
    cache["length"] = torch.where(active, cache["length"], length0)
    for e, conv0, h0 in ssm0:
        act = active.reshape(1, -1, 1, 1)
        e["conv"] = torch.where(act, e["conv"], conv0)
        e["h"] = torch.where(act, e["h"], h0)
    return cache


def _masked_spec(rt: Runtime, params, cache: dict, cur, active,
                 ecfg: EngineConfig, generator: torch.Generator):
    length0, ssm0 = cache["length"], _ssm_entries(cache)
    res, cache = spec_decode_step(rt, params, cache, cur, ecfg, generator)
    return res, _freeze_rows(length0, ssm0, cache, active)


def _masked_auto(rt: Runtime, params, cache: dict, cur, active):
    length0, ssm0 = cache["length"], _ssm_entries(cache)
    nxt, _, cache = autoregressive_step(rt, params, cache, cur)
    return nxt, _freeze_rows(length0, ssm0, cache, active)


def _masked_chunk(rt: Runtime, params, cache: dict, tokens, valid):
    length0, ssm0 = cache["length"], _ssm_entries(cache)
    last, cache = chunk_prefill_step(rt, params, cache, tokens, valid)
    return last, _freeze_rows(length0, ssm0, cache, valid > 0)


def _masked_unified(rt: Runtime, params, cache: dict, cur, chunk_tokens,
                    prefill_valid, decode_mask, ecfg: EngineConfig,
                    generator: torch.Generator):
    length0, ssm0 = cache["length"], _ssm_entries(cache)
    res, last, cache = unified_step(rt, params, cache, cur, chunk_tokens,
                                    prefill_valid, decode_mask, ecfg,
                                    generator)
    active = decode_mask | (prefill_valid > 0)
    return res, last, _freeze_rows(length0, ssm0, cache, active)


class Scheduler:
    """Continuous-batching front end over the speculative decode step.

    ``rt_extra`` sets further ``Runtime`` fields (the flash chunks; MoE's
    ``moe_capacity_factor``: capacity overflow couples the rows of a step,
    so the bitwise serving paths agree only where nothing is dropped, as
    in the reference). The MoE aux is ignored, as in the reference."""

    def __init__(self, cfg: ModelConfig, params,
                 cass: CassandraConfig | None = None,
                 ecfg: EngineConfig = EngineConfig(),
                 num_slots: int = 4, s_max: int = 256,
                 eos_id: int | None = None, speculative: bool = True,
                 paged: bool = False, block_size: int = 16,
                 num_blocks: int | None = None, chunk_size: int = 32,
                 fused: bool = True,
                 max_prefill_tokens_per_step: int | None = None,
                 prefix_cache: bool = False,
                 prefix_cache_blocks: int | None = None,
                 swap: bool = False,
                 swap_store_blocks: int | None = None,
                 slo_aware: bool = True, attn_kernel: str = "off",
                 overlap: bool = True,
                 debug_invariants: int | None = None,
                 telemetry: Telemetry | None = None, device="cuda",
                 generator: torch.Generator | None = None,
                 rt_extra: dict | None = None):
        if cfg.frontend:
            # the reference's admission takes token prompts only: no
            # request carries frame or patch embeddings
            raise NotImplementedError(
                "scheduler admission is token-prompt only for now")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Scheduler(device='cuda') but CUDA is not "
                               "available; pass device='cpu' explicitly")
        # the draws of non-greedy cycles, in dispatch order (wide prefill
        # cycles draw nothing); every run from reset() starts from the
        # generator's state here, as the reference restarts its key
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(0))
        self._generator_state = self.generator.get_state()
        self.cfg, self.cass, self.ecfg = cfg, cass, ecfg
        self.params = params
        self.num_slots, self.s_max = num_slots, s_max
        self.eos_id, self.speculative = eos_id, speculative
        self.paged, self.block_size = paged, block_size
        self.chunk_size = chunk_size
        # the fused step IS a speculative cycle; the autoregressive
        # baseline keeps the alternating loop
        self.fused = fused and speculative
        validate_serving_knobs(
            cfg, gamma=ecfg.gamma, num_slots=num_slots, s_max=s_max,
            chunk_size=chunk_size, fused=self.fused,
            speculative=speculative, paged=paged, block_size=block_size,
            num_blocks=num_blocks,
            max_prefill_tokens_per_step=max_prefill_tokens_per_step,
            prefix_cache=prefix_cache,
            prefix_cache_blocks=prefix_cache_blocks, swap=swap,
            swap_store_blocks=swap_store_blocks, attn_kernel=attn_kernel,
            variant=cass.variant if cass else 0)
        self.attn_kernel = attn_kernel
        self.overlap = overlap and self.fused
        if paged:
            self.max_blocks = blocks_needed(s_max, block_size)
            # default pool: the slot layout's capacity (+ the trash block)
            self.num_blocks = (num_blocks if num_blocks is not None
                               else num_slots * self.max_blocks + 1)
        self.max_prefill_tokens_per_step = max_prefill_tokens_per_step
        self.prefix_cache_enabled = prefix_cache
        self.prefix_cache_blocks = prefix_cache_blocks
        self.swap = swap
        self.swap_store_blocks = swap_store_blocks
        self.slo_aware = slo_aware
        # online measured cost model (ms per step bucket); persists
        # across reset()
        self.cost = CostModel()
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.telemetry.bind_cost(self.cost)
        if debug_invariants is None:
            env = os.environ.get("REPRO_DEBUG_INVARIANTS", "")
            debug_invariants = int(env) if env else 0
        self.debug_invariants = int(debug_invariants)
        self.rt = Runtime(cfg=cfg, cass=cass,
                          view="target" if cass else "plain",
                          attn_kernel=attn_kernel, **(rt_extra or {}))
        packed = cass is not None
        if paged:
            self.cache = KC.init_paged_cache(
                cfg, cass, num_slots, self.num_blocks, block_size,
                self.max_blocks, packed=packed, device=self.device)
            self.capacity = self.max_blocks * block_size
        else:
            self.cache = KC.init_cache(cfg, cass, num_slots, s_max,
                                       packed=packed, device=self.device)
            self.capacity = s_max
        # operand shapes each step was dispatched with (persist across
        # reset(), like the steps they describe)
        self.step_shapes: dict[str, set] = {}
        self._reset_state()

    def _reset_state(self) -> None:
        prev_slots: list = getattr(self, "slots", [])
        prev_pool: BlockAllocator | None = getattr(self, "pool", None)
        prev_prefix: PrefixCache | None = getattr(self, "prefix", None)
        prev_spill: SpillStore | None = getattr(self, "spill", None)
        self.slots: list[Request | None] = [None] * self.num_slots
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.lengths = np.zeros(self.num_slots, np.int64)
        self.cur = np.zeros((self.num_slots, 1), np.int32)
        self.clock = 0.0
        self.generator.set_state(self._generator_state)
        self.telemetry.reset()
        self.tracer = self.telemetry.tracer
        self.metrics = self.telemetry.metrics
        self.metrics.declare(
            "cycles", "prefill_cycles", "mixed_cycles", "prefill_tokens",
            "committed", "accepted", "drafted", "admitted", "finished",
            "prefix_queries", "prefix_hits", "prefix_matched_tokens",
            "prefix_blocks_aliased", "cow_copies", "preemptions",
            "swap_resumes", "swap_out_blocks", "swap_in_blocks",
            "swap_matched_blocks")
        for peak in ("peak_prefill_tokens_per_cycle",
                     "peak_resident_tokens", "peak_reserved_tokens",
                     "peak_swapped_tokens"):
            self.metrics.gauge(peak, 0)
        # slots admitted since the last push: their SSM state starts at 0
        self._fresh_rows: set[int] = set()
        self._next_rid = 0
        self._next_swap_key = 0
        self._steps_since_check = 0
        self._slo_seen = False
        self.prefix: PrefixCache | None = None
        self._pending_cow: list[tuple[int, int]] = []
        # pipeline state: the dispatched-unharvested cycle, the staged
        # next-chunk operands, and spill / restore copies waiting for the
        # next harvest; reset() drops them (a spill still staged in the
        # previous store is waited on first)
        self._in_flight: PendingCycle | None = None
        self._staged_chunk: tuple | None = None
        self._swaps_in_flight: list[tuple] = []
        if prev_spill is not None:
            prev_spill.clear()
        if self.paged:
            if prev_pool is not None and prev_prefix is not None:
                # the radix index persists across reset: every live owner
                # is released, so only parked (cacheable) chains stay
                # resident, their device bytes intact (parked blocks are
                # never on the free list) and matchable next run
                for slot, r in enumerate(prev_slots):
                    if r is not None:
                        prev_pool.release(slot)
                for key in prev_pool.swapped_keys():
                    prev_pool.drop_swapped(key)
                # per-run peak: restart at the parked chains' occupancy
                prev_pool.high_water = (prev_pool.allocated_total
                                        + prev_pool.parked_total)
                self.pool = prev_pool
                self.prefix = prev_prefix
            else:
                self.pool = BlockAllocator(self.num_blocks)
                if self.prefix_cache_enabled:
                    self.prefix = PrefixCache(self.pool, self.block_size,
                                              self.prefix_cache_blocks)
            self.table = np.full((self.num_slots, self.max_blocks),
                                 TRASH_BLOCK, np.int32)
            # per-slot logical->physical block lists (shared prefix blocks
            # first, then blocks charged to the slot's reservation)
            self.row_blocks: list[list[int]] = \
                [[] for _ in range(self.num_slots)]
            # per-slot (trie node, block index) insert watermark, so the
            # incremental prefix indexing never re-walks committed blocks
            self.row_index: list[tuple] = [(None, 0)] * self.num_slots
        # host spill store for preempted rows (fresh per run: swapped
        # requests of the previous run were dropped with the queue)
        self.spill = SpillStore(self.swap_store_blocks) if self.swap \
            else None
        self.metrics.set_config("paged", self.paged)
        self.metrics.set_config("prefix_cache", self.prefix is not None)
        self.metrics.set_config("swap", self.swap)
        self.metrics.set_config("slo_aware", self.slo_aware)
        self.metrics.set_config("slo_declared", self._slo_seen)
        self.metrics.set_config("attn_kernel", self.attn_kernel)
        self.metrics.set_config("fused", self.fused)
        self.metrics.set_config("speculative", self.speculative)
        self.metrics.set_config("overlap", self.overlap)

    def reset(self) -> None:
        """Clear queue, slots and stats for a fresh run on the same cache:
        admission re-prefills a slot's region (or re-points its table), so
        stale cache contents are harmless. The prefix index persists:
        parked chains stay resident and matchable, while live rows are
        released so their private blocks return to the pool."""
        self._reset_state()

    @property
    def trace_counts(self) -> dict:
        """Distinct operand shapes per step (1 each: one bucket)."""
        return {k: len(v) for k, v in sorted(self.step_shapes.items())}

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the scheduler's device, as a copy: through a
        pinned buffer, so the copy waits for no in-flight step."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _record_shapes(self, name: str, *operands) -> None:
        shapes = tuple(tuple(t.shape) for t in operands)
        if self.paged:
            shapes += (tuple(self.cache["block_table"].shape),)
        self.step_shapes.setdefault(name, set()).add(shapes)

    # -- queue -------------------------------------------------------------

    def _worst_case_tokens(self, n_prompt: int, max_new: int) -> int:
        """Cache tokens a request can touch: prompt + outputs + the decode
        horizon past the last committed token (γ+1 for a verify pass, 1
        for an autoregressive step)."""
        horizon = self.ecfg.gamma + 1 if self.speculative else 1
        return n_prompt + max_new + horizon

    def submit(self, tokens, max_new: int, arrival: float = 0.0,
               rid: int | None = None, stop_tokens=None, priority: int = 0,
               ttft_deadline_ms: float | None = None,
               itl_target_ms: float | None = None) -> Request:
        """Queue one request (see ``Request`` for the knobs)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        validate_request_slos(ttft_deadline_ms=ttft_deadline_ms,
                              itl_target_ms=itl_target_ms)
        need = self._worst_case_tokens(len(tokens), max_new)
        if need > self.capacity:
            raise ValueError(
                f"request needs {need} cache slots (prompt {len(tokens)} "
                f"+ max_new {max_new} + decode horizon), "
                f"capacity={self.capacity}")
        if self.paged and blocks_needed(
                need, self.block_size) > self.pool.capacity:
            raise ValueError(
                f"request needs {blocks_needed(need, self.block_size)} "
                f"blocks, pool has {self.pool.capacity}")
        req = Request(rid=self._next_rid if rid is None else rid,
                      tokens=tokens, max_new=max_new, arrival=arrival,
                      stop_tokens=tuple(stop_tokens or ()),
                      priority=priority, ttft_deadline_ms=ttft_deadline_ms,
                      itl_target_ms=itl_target_ms)
        self._next_rid = req.rid + 1
        if req.has_slo:
            self._slo_seen = True
            self.metrics.set_config("slo_declared", True)
        self.queue.append(req)
        self.tracer.emit(TM.SUBMIT, rid=req.rid, cycle=self.clock,
                         args=(len(tokens), max_new))
        return req

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slots)

    # -- admission ---------------------------------------------------------

    def _request_blocks(self, req: Request) -> int:
        return blocks_needed(
            self._worst_case_tokens(len(req.tokens), req.max_new),
            self.block_size)

    def _admission_plan(self, req: Request
                        ) -> tuple[int, PrefixMatch | None, int]:
        """(blocks to reserve, cached-prefix match, parked blocks the
        admission would pin). The reservation charges only unshared
        blocks: fully matched prefix blocks are aliased, not allocated.
        The copy-on-write block of a partial match is charged (it is a
        private divergence copy)."""
        need = self._request_blocks(req)
        if self.prefix is None:
            return need, None, 0
        m = self.prefix.match(req.tokens)
        pinned = list(m.nodes)
        if m.partial is not None and m.partial_len > 0:
            pinned.append(m.partial)
        pins = sum(1 for n in pinned if self.pool.is_parked(n.block))
        return need - len(m.nodes), m, pins

    def _resume_plan(self, req: Request) -> tuple[int, list, int]:
        """(blocks to reserve, matched trie nodes to re-alias, parked
        blocks the resume would pin) for a SWAPPED request: an
        admission-shaped prefix match capped at the row's own committed
        full blocks (a since-deepened cache never fast-forwards the row
        past its saved position); the spilled chain covers the rest."""
        chain = self.spill.get(req.swap_key)
        need = self._request_blocks(req)
        if self.prefix is None:
            return need, [], 0
        m = self.prefix.match(req.tokens)
        usable = min(len(m.nodes), req.pos // self.block_size,
                     chain.n_blocks)
        nodes = list(m.nodes[:usable])
        pins = sum(1 for n in nodes if self.pool.is_parked(n.block))
        return need - len(nodes), nodes, pins

    def _admit_resumed(self, req: Request, slot: int,
                       plan: tuple[int, list, int]) -> None:
        """Swap a preempted request back in: re-reserve, re-alias the
        still-cached prefix, restore the spilled tail bit for bit, and
        re-seed the slot's host state (length, position, last token).
        Output, latency stamps and ``admitted_at`` survive: the request
        continues, it does not restart."""
        chain = self.spill.get(req.swap_key)
        n_reserve, nodes, _ = plan
        req.state, req.slot = RUNNING, slot
        self.slots[slot] = req
        self.pool.swap_in(req.swap_key, slot, n_reserve)
        self.table[slot, :] = TRASH_BLOCK
        blocks: list[int] = []
        for node in nodes:
            self.pool.share(slot, node.block)
            blocks.append(node.block)
        matched = len(nodes)
        restore_n = chain.n_blocks - matched
        for _ in range(restore_n):
            blocks.append(self.pool.alloc(slot))
        if restore_n:
            vec = np.full(self.max_blocks, TRASH_BLOCK, np.int32)
            vec[:restore_n] = blocks[matched:]
            data = chain.slice_blocks(matched, chain.n_blocks,
                                      self.max_blocks)
            vec_d = self._to_device(vec)
            self._record_shapes("restore", vec_d)
            t0 = time.perf_counter()
            self.cache, marker = KC.restore_pool_blocks_marked(
                self.cache, vec_d, data)
            if self.overlap:
                # the host-to-device copies and the scatter overlap the
                # fused step this admission rides (enqueued before it, so
                # stream order makes the step read the restored blocks);
                # the marker is waited on at the next harvest
                self._stamp_wall("restore.dispatch", t0)
                self._swaps_in_flight.append(
                    ("restore", marker, time.perf_counter() - t0,
                     self.clock))
            else:
                # wait on the restore's own event, not the device, so the
                # stamped wall covers the copies and the scatter
                if marker is not None:
                    marker.synchronize()
                self._stamp_wall("restore", t0)
            self.tracer.emit(TM.RESTORE, rid=req.rid, slot=slot,
                             cycle=self.clock, args=(restore_n,))
        self.row_blocks[slot] = blocks
        self.row_index[slot] = (nodes[-1] if nodes else None, matched)
        if blocks:
            self.table[slot, :len(blocks)] = blocks
        self.lengths[slot] = chain.length
        self.cur[slot, 0] = chain.cur
        req.pos = chain.pos
        self.spill.pop(req.swap_key)
        req.swap_key = None
        self.metrics.inc("swap_resumes")
        self.metrics.inc("swap_in_blocks", restore_n)
        self.metrics.inc("swap_matched_blocks", matched)
        self.tracer.emit(TM.RESUME, rid=req.rid, slot=slot,
                         cycle=self.clock, args=(matched, restore_n))

    def _admit(self, req: Request, slot: int,
               plan: tuple[int, PrefixMatch | None, int] | None) -> None:
        if req.state == SWAPPED:
            self._admit_resumed(req, slot, plan)
            return
        req.state, req.slot, req.admitted_at = RUNNING, slot, self.clock
        req.pos, req.prefill_done, req.output = 0, False, []
        req.prefix_matched = 0
        req.token_cycles, req.token_walls = [], []
        self.slots[slot] = req
        self.lengths[slot] = 0
        self._fresh_rows.add(slot)
        if self.paged:
            n_reserve, m, _ = plan
            # keyed by slot, not rid: slots are unique while occupied
            self.pool.reserve(slot, n_reserve)
            self.table[slot, :] = TRASH_BLOCK
            blocks: list[int] = []
            if m is not None:
                self.metrics.inc("prefix_queries")
                for node in m.nodes:
                    self.pool.share(slot, node.block)
                    blocks.append(node.block)
                matched = m.full_tokens
                self.metrics.inc("prefix_blocks_aliased", len(m.nodes))
                if m.partial is not None and m.partial_len > 0:
                    # diverges inside a cached block: pin the source for
                    # the row's lifetime (it must survive until the copy
                    # lands) and take a fresh block to diverge in
                    self.pool.share(slot, m.partial.block)
                    dst = self.pool.cow(slot, m.partial.block)
                    self._pending_cow.append((m.partial.block, dst))
                    blocks.append(dst)
                    matched += m.partial_len
                    self.metrics.inc("cow_copies")
                if matched:
                    self.metrics.inc("prefix_hits")
                    self.metrics.inc("prefix_matched_tokens", matched)
                self.metrics.observe("prefix_hit_depth", matched)
                # prefill starts past the matched tokens
                req.pos = req.prefix_matched = matched
                self.lengths[slot] = matched
            self.row_blocks[slot] = blocks
            # the matched chain is indexed already: incremental insertion
            # starts at its tail (the CoW block is indexed once prefill
            # fills it)
            if self.prefix is not None:
                self.row_index[slot] = (
                    m.nodes[-1] if m.nodes else None, len(m.nodes))
            if blocks:
                self.table[slot, :len(blocks)] = blocks
        self.metrics.inc("admitted")
        self.tracer.emit(TM.ADMIT, rid=req.rid, slot=slot,
                         cycle=self.clock, args=(req.prefix_matched,))

    def _admit_ready(self) -> None:
        """Admit ready requests in order (``_next_ready_index``). When
        paged, the head request gates on its reservation (its unshared
        blocks plus the parked cache blocks it would pin) and waits rather
        than being skipped, so small requests cannot starve it, unless
        preemption (``swap=True``) frees the room by swapping out a
        resident row the victim policy deems cheaper."""
        while True:
            idx = self._next_ready_index()
            if idx is None:
                return
            req = self.queue[idx]
            slot = next((s for s in range(self.num_slots)
                         if self.slots[s] is None), None)
            plan = self._plan_for(req) if self.paged else None
            fits = plan is None or self.pool.can_reserve(plan[0], plan[2])
            if slot is None or not fits:
                if not self.swap:
                    return
                plan = self._try_preempt_for(
                    req, self._matched_plan_tokens(plan))
                if plan is None:
                    return
                # preemption requeued victims at the front: re-resolve the
                # head's queue position and the (now free) slot
                idx = next(i for i, r in enumerate(self.queue) if r is req)
                slot = next((s for s in range(self.num_slots)
                             if self.slots[s] is None), None)
                if slot is None:
                    return
            del self.queue[idx]
            self._admit(req, slot, plan)

    @staticmethod
    def _matched_plan_tokens(plan) -> int:
        """Cached-prefix tokens the head's plan would skip (0 without the
        cache): the victim policy's TTFT estimate input."""
        if plan is None:
            return 0
        m = plan[1]
        if m is None:
            return 0
        if isinstance(m, PrefixMatch):
            return m.full_tokens
        return sum(len(n.key) for n in m)       # resume plan: node list

    # -- SLO goodput model ---------------------------------------------------

    @property
    def _slo_active(self) -> bool:
        """Goodput mode engages only when enabled AND some request this
        run declared an SLO: an all-default run takes the plain paths."""
        return self.slo_aware and self._slo_seen

    def _ttft_deadline_cycles(self, req: Request) -> float | None:
        if req.ttft_deadline_ms is None:
            return None
        return req.arrival + self.cost.ms_to_cycles(req.ttft_deadline_ms)

    def _next_event_deadline_cycles(self, req: Request) -> float | None:
        """Cycle by which the request's next token must land: the TTFT
        deadline before its first token, last commit + ITL target after."""
        if not req.token_cycles:
            return self._ttft_deadline_cycles(req)
        if req.itl_target_ms is None:
            return None
        return (req.token_cycles[-1]
                + self.cost.ms_to_cycles(req.itl_target_ms))

    def _admit_to_first_token_cycles(self, req: Request,
                                     matched: int) -> int:
        """Cycles from admitting ``req`` now to its first (or, resumed,
        next) token: prefill of the unmatched prompt at the riding width,
        plus the cycle that commits the token."""
        width = self.ecfg.gamma + 1 if self.speculative else 1
        unprefilled = max(len(req.tokens) - max(req.pos, matched), 0)
        return -(-unprefilled // width) + 1

    def _admission_key(self, idx: int, req: Request) -> tuple:
        """EDF order: (0 feasible deadline | 1 none | 2 hopeless,
        deadline, -priority, queue index)."""
        dl = self._next_event_deadline_cycles(req)
        if dl is None:
            return (1, 0.0, -req.priority, idx)
        feasible = (self.clock
                    + self._admit_to_first_token_cycles(req, req.pos) <= dl)
        return (0 if feasible else 2, dl, -req.priority, idx)

    def _next_ready_index(self) -> int | None:
        """Queue index of the next request to admit among the ready ones
        (arrival <= clock): the highest priority, FIFO within it; in
        goodput mode, earliest feasible deadline first."""
        best, best_key = None, None
        for i, r in enumerate(self.queue):
            if r.arrival > self.clock:
                continue
            key = (self._admission_key(i, r) if self._slo_active
                   else (-r.priority, i))
            if best is None or key < best_key:
                best, best_key = i, key
        return best

    # -- preemption (victim policy + host swap) ------------------------------

    def _remaining_cycles(self, req: Request) -> int:
        """A row's remaining work in worst-case cycles: γ+1-wide prefill
        passes for the unprefilled prompt plus one cycle per owed token."""
        width = self.ecfg.gamma + 1 if self.speculative else 1
        prefill = 0 if req.prefill_done else \
            -(-max(len(req.tokens) - req.pos, 0) // width)
        return prefill + max(req.max_new - len(req.output), 0)

    def _head_admit_cycles(self, head: Request, matched: int) -> int:
        """The head's time to first token if admitted now, plus the swap
        round-trip margin a preemption spends to make room."""
        return (self._admit_to_first_token_cycles(head, matched)
                + SWAP_MARGIN_CYCLES)

    def _victim_slo_at_risk(self, req: Request) -> bool:
        """Would preempting this resident row sacrifice an SLO it can
        still hit (its next-token deadline live and reachable if it stays
        resident)? Rows with no pending or an already hopeless deadline
        cost no goodput."""
        dl = self._next_event_deadline_cycles(req)
        if dl is None:
            return False
        return self.clock + self._admit_to_first_token_cycles(
            req, req.pos) <= dl

    def _preempt(self, victim: Request) -> None:
        """Swap ``victim`` out: flush any copy-on-write it is owed, gather
        its committed blocks into the host store (before the allocator
        frees them), release its blocks and reservation (``swap_out``:
        shared prefix blocks drop a pin and stay matchable), and requeue
        it at the front with its original arrival. The chain holds all a
        bit-exact resume needs (length, prompt position, last token, KV
        bytes)."""
        if self._pending_cow:
            self._flush_cow()
        slot = victim.slot
        n_res = blocks_needed(int(self.lengths[slot]), self.block_size)
        vec = np.full(self.max_blocks, TRASH_BLOCK, np.int32)
        vec[:n_res] = self.row_blocks[slot][:n_res]
        # an opaque token disjoint from the slot-index owners: a bare int
        # would collide with a slot in the allocator's reservation maps
        key = ("swap", self._next_swap_key)
        self._next_swap_key += 1
        vec_d = self._to_device(vec)
        self._record_shapes("spill", vec_d)
        t0 = time.perf_counter()
        bytes_before = self.spill.nbytes
        data = KC.spill_pool_blocks(self.cache, vec_d)
        if self.overlap:
            # the gather lands in buffers of its own, and any later step
            # that rewrites the freed blocks is enqueued after it, so block
            # reuse is ordered after the copy; the device-to-host copies
            # are waited on at the next harvest
            self.spill.put_async(key, data, n_res,
                                 length=int(self.lengths[slot]),
                                 pos=victim.pos, cur=int(self.cur[slot, 0]))
            self._stamp_wall("spill.dispatch", t0)
            self._swaps_in_flight.append(
                ("spill", key, time.perf_counter() - t0, self.clock))
        else:
            self.spill.put(key, data, n_res, length=int(self.lengths[slot]),
                           pos=victim.pos, cur=int(self.cur[slot, 0]))
            self._stamp_wall("spill", t0)
        self.tracer.emit(TM.SPILL, rid=victim.rid, slot=slot,
                         cycle=self.clock,
                         args=(n_res, self.spill.nbytes - bytes_before))
        self.pool.swap_out(slot, key, n_res)
        self.table[slot, :] = TRASH_BLOCK
        self.row_blocks[slot] = []
        self.row_index[slot] = (None, 0)
        self.slots[slot] = None
        self.lengths[slot] = 0
        victim.state, victim.slot, victim.swap_key = SWAPPED, -1, key
        victim.preemptions += 1
        self.queue.appendleft(victim)
        self.metrics.inc("preemptions")
        self.metrics.inc("swap_out_blocks", n_res)
        self.tracer.emit(TM.PREEMPT, rid=victim.rid, slot=slot,
                         cycle=self.clock, args=(n_res,))

    def _plan_for(self, req: Request):
        """The request's admission plan: resume-shaped for a SWAPPED
        request, fresh otherwise; both (blocks to reserve, cached match,
        parked blocks the admission would pin)."""
        return (self._resume_plan(req) if req.state == SWAPPED
                else self._admission_plan(req))

    def _try_preempt_for(self, head: Request, matched: int):
        """Victim policy: free room for the queue head by swapping out
        resident rows whose remaining work exceeds the head's time to
        first token (plus the swap margin). Order: lowest priority first,
        most remaining work within a priority. An equal-priority victim
        also needs more remaining work than the head's total (shortest
        remaining first), so two long rows never preempt each other in a
        loop. In goodput mode a row whose live SLO is still winnable is
        never a victim, SLO-free rows go before blown-SLO rows, and
        ``priority`` breaks ties; a deadline-free head keeps the plain bar.

        Returns the head's refreshed plan once it fits the pool, else None
        (rows already preempted stay out and resume on their own merit)."""
        head_cost = self._head_admit_cycles(head, matched)
        head_rem = self._remaining_cycles(head)
        slo_mode = self._slo_active
        head_dl = (self._next_event_deadline_cycles(head)
                   if slo_mode else None)
        cands = []
        for r in self.slots:
            if r is None:
                continue
            rem = self._remaining_cycles(r)
            if rem <= head_cost:
                continue                    # not worth the head's wait
            if slo_mode:
                if self._victim_slo_at_risk(r):
                    continue                # never sacrifice a live SLO
                if head_dl is None:
                    if r.priority > head.priority:
                        continue            # never preempt upward
                    if r.priority == head.priority and rem <= head_rem:
                        continue            # anti-thrash: SRPT order
                cands.append(((1 if r.has_slo else 0), r.priority,
                              -rem, r.slot, r))
                continue
            if r.priority > head.priority:
                continue                    # never preempt upward
            if r.priority == head.priority and rem <= head_rem:
                continue                    # anti-thrash: SRPT order
            cands.append((r.priority, -rem, r.slot, r))
        for cand in sorted(cands, key=lambda c: c[:-1]):
            victim = cand[-1]
            n_res = blocks_needed(int(self.lengths[victim.slot]),
                                  self.block_size)
            if not self.spill.can_hold(n_res):
                continue                    # host store full: skip victim
            self._preempt(victim)
            plan = self._plan_for(head)
            if self.pool.can_reserve(plan[0], plan[2]):
                return plan
        return None

    # -- retirement --------------------------------------------------------

    def _maybe_retire(self, req: Request, cycle: float | None = None) -> None:
        cyc = self.clock if cycle is None else cycle
        capped = req.output[:req.max_new]
        stops = set(req.stop_tokens)
        if self.eos_id is not None:
            stops.add(self.eos_id)
        cut = next((i + 1 for i, t in enumerate(capped) if t in stops),
                   None) if stops else None
        if cut is not None:
            req.output = capped[:cut]
        elif len(req.output) >= req.max_new:
            req.output = capped
        else:
            return
        req.token_cycles = req.token_cycles[:len(req.output)]
        req.token_walls = req.token_walls[:len(req.output)]
        req.state, req.finished_at = FINISHED, cyc
        self.tracer.emit(TM.RETIRE, rid=req.rid, slot=req.slot, cycle=cyc,
                         args=(len(req.output),))
        self.slots[req.slot] = None
        if self.paged:
            self.pool.release(req.slot)
            self.row_blocks[req.slot] = []
            self.table[req.slot, :] = TRASH_BLOCK
        self.finished.append(req)
        self.metrics.inc("finished")

    def _stamp_wall(self, name: str, t0: float) -> None:
        """Fold one step's wall (perf_counter, a monotonic clock) into the
        registry and the cost model, and emit a STEP trace event."""
        self._stamp_wall_at(name, time.perf_counter() - t0)

    def _stamp_wall_at(self, name: str, dt: float,
                       cycle: float | None = None) -> None:
        self.metrics.observe_wall(name, dt)
        self.tracer.emit(TM.STEP,
                         cycle=self.clock if cycle is None else cycle,
                         args=(name, dt * 1e3))

    def _record_tokens(self, req: Request, k: int,
                       cycle: float | None = None) -> None:
        now = time.perf_counter()
        cyc = self.clock if cycle is None else cycle
        req.token_cycles.extend([cyc + 1.0] * k)
        req.token_walls.extend([now] * k)

    def _harvest_decode_row(self, req: Request, tokens: np.ndarray,
                            valid: np.ndarray, n: np.ndarray,
                            nxt: np.ndarray,
                            cycle: float | None = None) -> None:
        """Fold one decode row's cycle results into the request (shared by
        the fused and alternating paths)."""
        slot = req.slot
        before = len(req.output)
        req.output.extend(tokens[slot][valid[slot]].tolist())
        self._record_tokens(req, len(req.output) - before, cycle=cycle)
        self.lengths[slot] += int(n[slot]) + 1
        self.cur[slot, 0] = nxt[slot]
        if self.speculative:
            self.metrics.observe("acceptance_len", int(n[slot]))
        self._maybe_retire(req, cycle=cycle)
        delivered = len(req.output) - before
        self.metrics.inc("committed", delivered)
        self.tracer.emit(TM.CYCLE, rid=req.rid, slot=slot,
                         cycle=self.clock if cycle is None else cycle,
                         args=(self.ecfg.gamma if self.speculative else 0,
                               int(n[slot]), delivered))

    def _fast_forward(self) -> bool:
        """No resident work: jump the clock to the next queued arrival
        (True) or report the scheduler idle (False)."""
        if self.queue:
            self.clock = max(self.clock, min(r.arrival for r in self.queue))
            return True
        return False

    # -- device-state sync ---------------------------------------------------

    def _grow_blocks(self, req: Request, n_tokens: int) -> None:
        """Allocate pool blocks until ``req`` covers ``n_tokens`` (within
        its reservation) and map them into its table row. Shared prefix
        blocks head the row's list; only the unshared tail draws on the
        reservation."""
        blocks = self.row_blocks[req.slot]
        while len(blocks) * self.block_size < n_tokens:
            blocks.append(self.pool.alloc(req.slot))
        self.table[req.slot, :len(blocks)] = blocks

    def _flush_cow(self) -> None:
        """Enqueue the pending copy-on-write block copies, ``num_slots``
        pairs a call padded with trash -> trash no-ops (one operand
        shape), before the cycle's step so a diverging row's seeded
        tokens are in place before anything reads them."""
        k = self.num_slots
        while self._pending_cow:
            batch, self._pending_cow = (self._pending_cow[:k],
                                        self._pending_cow[k:])
            src = np.full(k, TRASH_BLOCK, np.int32)
            dst = np.full(k, TRASH_BLOCK, np.int32)
            for i, (s, d) in enumerate(batch):
                src[i], dst[i] = s, d
            src_d, dst_d = self._to_device(src), self._to_device(dst)
            self._record_shapes("cow", src_d, dst_d)
            t0 = time.perf_counter()
            self.cache = KC.copy_pool_blocks(self.cache, src_d, dst_d)
            # a dispatch-only stamp: the copy stays asynchronous
            self._stamp_wall("cow", t0)

    def _index_prefix(self, req: Request) -> None:
        """Register the row's newly committed full prompt blocks in the
        radix cache (incremental: from the slot's watermark)."""
        if self.prefix is None:
            return
        slot = req.slot
        node, start = self.row_index[slot]
        node, _ = self.prefix.insert(req.tokens, self.row_blocks[slot],
                                     req.pos, node=node, start=start)
        # the returned node's depth, not pos // block_size, is the resume
        # point: insert may stop early (another row's identical run) or
        # restart from the root (a stale hint)
        self.row_index[slot] = (node, node.depth)

    def _push_host_state(self) -> None:
        if self._pending_cow:
            self._flush_cow()
        self.cache["length"] = self._to_device(self.lengths.astype(np.int32))
        if self.paged:
            self.cache["block_table"] = self._to_device(self.table)
        if self._fresh_rows:
            self._zero_ssm_rows(sorted(self._fresh_rows))
            self._fresh_rows.clear()

    def _zero_ssm_rows(self, slots: list) -> None:
        """Start the SSM state of newly admitted rows from zero, on the
        device in stream order (new tensors, as ``engine.commit`` gives
        them). A recycled slot otherwise carries the state its previous
        request left, where a fresh prompt must start from none (the
        Engine's prefill does); the reference's scheduler carries it."""
        ssm = _ssm_entries(self.cache)
        if not ssm:
            return
        rows = self._to_device(np.asarray(slots, np.int64))
        for e, conv, h in ssm:
            e["conv"] = conv.index_fill(1, rows, 0)
            e["h"] = h.index_fill(1, rows, 0)

    def _track_residency(self, cycle: float | None = None) -> None:
        resident = int(sum(self.lengths[r.slot] for r in self.slots
                           if r is not None))
        self.metrics.gauge_max("peak_resident_tokens", resident)
        if self.paged:
            reserved = (self.pool.reserved_total
                        + self.pool.uncharged_total) * self.block_size
        else:
            reserved = sum(r is not None for r in self.slots) * self.s_max
        self.metrics.gauge_max("peak_reserved_tokens", reserved)
        if self.paged and self.swap:
            # swapped rows hold no device blocks: their tokens live on the
            # host and are reported apart from the pool's residency
            self.metrics.gauge_max(
                "peak_swapped_tokens",
                self.pool.swapped_blocks_total * self.block_size)
        if self.tracer.enabled:
            occ = self.pool.occupancy() if self.paged else None
            self.tracer.emit(TM.COUNTERS,
                             cycle=self.clock if cycle is None else cycle,
                             args=(resident,
                                   occ["allocated"] if occ else 0,
                                   occ["parked"] if occ else 0,
                                   occ["swapped_blocks"] if occ else 0,
                                   len(self.queue)))

    # -- prefill -----------------------------------------------------------

    def _dispatch_wide(self, prefilling: list[Request]) -> PendingCycle:
        """Dispatch one wide (``chunk_size``) admission cycle over every
        prefilling row; returns its unharvested record."""
        c = self.chunk_size
        tokens = np.zeros((self.num_slots, c), np.int32)
        valid = np.zeros(self.num_slots, np.int32)
        for r in prefilling:
            v = self._chunk_len(r, r.pos, c)
            tokens[r.slot, :v] = r.tokens[r.pos:r.pos + v]
            valid[r.slot] = v
            if self.paged:
                self._grow_blocks(r, r.pos + v)
        self._push_host_state()
        tokens_d, valid_d = self._to_device(tokens), self._to_device(valid)
        self._record_shapes("chunk", tokens_d, valid_d)
        t0 = time.perf_counter()
        last, self.cache = _masked_chunk(self.rt, self.params, self.cache,
                                         tokens_d, valid_d)
        host, done = _stage_to_host((last,))
        return PendingCycle(kind="chunk", plan=None,
                            prefilling=list(prefilling), valid=valid,
                            res=None, host=host, done=done, clock=self.clock,
                            t0=t0, t_dispatch=time.perf_counter())

    def _harvest_wide(self, p: PendingCycle) -> None:
        """Fold one wide admission cycle's logits into host state."""
        (last,) = _land(p)
        for r in p.prefilling:
            v = int(p.valid[r.slot])
            r.pos += v
            self.lengths[r.slot] += v
            self.metrics.inc("prefill_tokens", v)
            self.tracer.emit(TM.PREFILL_CHUNK, rid=r.rid, slot=r.slot,
                             cycle=p.clock, args=(v, r.pos))
            self._index_prefix(r)
            if r.pos >= len(r.tokens):
                self._finish_prefill(r, last[r.slot], cycle=p.clock)
        self.metrics.inc("prefill_cycles")

    def _prefill_cycle(self, prefilling: list[Request]) -> None:
        """One chunk of every prefilling row, synchronously."""
        p = self._dispatch_wide(prefilling)
        _land(p)
        self._stamp_wall("chunk", p.t0)
        self._harvest_wide(p)

    @staticmethod
    def _chunk_len(req: Request, pos: int, width: int) -> int:
        """Prompt tokens a ``width``-wide pass takes from ``pos``: up to
        the next multiple of ``width``, so a row that starts mid-grid (a
        prefix hit, a resume) gets the same chunk boundaries, and with
        them the same attention sums (``engine.window_start``), as a row
        prefilled from position 0."""
        return min(width - pos % width, len(req.tokens) - pos)

    def _finish_prefill(self, req: Request, last_logits: np.ndarray,
                        cycle: float | None = None) -> None:
        """Prompt exhausted: its last-position logits give the first
        generated token; the row decodes from the next cycle."""
        first = int(np.argmax(last_logits))
        req.prefill_done = True
        req.output = [first]
        self._record_tokens(req, 1, cycle=cycle)
        self.cur[req.slot, 0] = first
        self._maybe_retire(req, cycle=cycle)

    # -- planner (fused mode) ----------------------------------------------

    def _plan_cycle(self) -> CyclePlan | None:
        """Give every resident row a role: PREFILL (up to γ+1 prompt tokens,
        capped across rows by ``max_prefill_tokens_per_step``), DRAFT+VERIFY
        or IDLE. None when no resident row has work."""
        width = self.ecfg.gamma + 1
        chunk = np.zeros((self.num_slots, width), np.int32)
        valid = np.zeros(self.num_slots, np.int32)
        dmask = np.zeros(self.num_slots, bool)
        prefilling: list[Request] = []
        decoding: list[Request] = []
        budget = self.max_prefill_tokens_per_step
        budget = budget if budget is not None else self.num_slots * width
        for slot, r in enumerate(self.slots):
            if r is None:
                continue
            if r.prefill_done:
                dmask[slot] = True
                decoding.append(r)
            elif budget > 0:
                v = min(self._chunk_len(r, r.pos, width), budget)
                chunk[slot, :v] = r.tokens[r.pos:r.pos + v]
                valid[slot] = v
                budget -= v
                prefilling.append(r)
        if not prefilling and not decoding:
            return None
        return CyclePlan(chunk_tokens=chunk, prefill_valid=valid,
                         decode_mask=dmask, prefilling=prefilling,
                         decoding=decoding)

    def _plan_wide_cycle(self, plan: CyclePlan) -> bool:
        """Run the wide admission bucket instead of the fused step?

        Always with an empty decode pool. Otherwise compare token costs:
        riding keeps each prefilling row busy ceil(R/(γ+1)) cycles instead
        of ceil(R/chunk), while one wide cycle stalls every decode row one
        cycle; stall only when riding is strictly dearer. In goodput mode
        deadlines vote first, and a tie re-runs the comparison in measured
        milliseconds (the cost model's bucket means)."""
        if not plan.decoding:
            return True
        if not plan.prefilling:
            return False
        w, c = self.ecfg.gamma + 1, self.chunk_size
        ride_extra = sum(
            -(-(len(r.tokens) - r.pos) // w)
            - -(-(len(r.tokens) - r.pos) // c)
            for r in plan.prefilling)
        if not self._slo_active:
            return ride_extra > len(plan.decoding)
        stall_votes = ride_votes = 0
        for r in plan.prefilling:
            dl = self._next_event_deadline_cycles(r)
            if dl is None:
                continue
            rem = len(r.tokens) - r.pos
            wide_first = self.clock + -(-rem // c) + 1
            ride_first = self.clock + -(-rem // w) + 1
            if wide_first <= dl < ride_first:
                stall_votes += 1
        for r in plan.decoding:
            dl = self._next_event_deadline_cycles(r)
            if dl is None:
                continue
            if self.clock + 1 <= dl < self.clock + 2:
                ride_votes += 1
        if stall_votes != ride_votes:
            return stall_votes > ride_votes
        ride_ms = ride_extra * self.cost.bucket_ms("unified")
        stall_ms = len(plan.decoding) * self.cost.bucket_ms("chunk")
        return ride_ms > stall_ms

    def _dispatch_unified(self, plan: CyclePlan,
                          stale: bool = False) -> PendingCycle:
        """Dispatch one planned mixed-role cycle; returns its unharvested
        record (no sync).

        ``stale=True`` is the free-run dispatch: host state is one cycle
        behind, so ``cur`` chains off the in-flight cycle's ``next_token``
        on the device, ``length`` stays as the device has it, and decode
        rows grow blocks for two decode horizons (the in-flight commit
        plus the next verify), capped at their reservation."""
        horizon = self.ecfg.gamma + 1
        if self.paged:
            for r in plan.prefilling:
                self._grow_blocks(r, r.pos + int(plan.prefill_valid[r.slot]))
            for r in plan.decoding:
                need = (min(int(self.lengths[r.slot]) + 2 * horizon,
                            self._worst_case_tokens(len(r.tokens),
                                                    r.max_new))
                        if stale else int(self.lengths[r.slot]) + horizon)
                self._grow_blocks(r, need)
        if stale:
            if self.paged:
                self.cache["block_table"] = self._to_device(self.table)
            cur = self._in_flight.res.next_token[:, None]
        else:
            self._push_host_state()
            cur = self._to_device(self.cur)
        chunk_d, valid_d = self._take_staged_chunk(plan)
        dmask = self._to_device(plan.decode_mask)
        self._record_shapes("unified", cur, chunk_d, valid_d, dmask)
        t0 = time.perf_counter()
        res, last, self.cache = _masked_unified(
            self.rt, self.params, self.cache, cur, chunk_d, valid_d, dmask,
            self.ecfg, self.generator)
        outs = (res.tokens, res.valid, res.n_accepted, res.next_token)
        if plan.prefilling:
            outs += (last,)
        host, done = _stage_to_host(outs)
        pending = PendingCycle(kind="unified", plan=plan, prefilling=[],
                               valid=None, res=res, host=host, done=done,
                               clock=self.clock, t0=t0,
                               t_dispatch=time.perf_counter())
        self._stage_next_chunk(plan)
        return pending

    def _harvest_unified(self, p: PendingCycle) -> None:
        """Fold one fused cycle's results into host state. A row retired
        between the cycle's dispatch and its harvest (free-run: the retire
        decision came one cycle late) is a zombie: its results are
        discarded and it adds nothing to the acceptance counts."""
        plan, cycle = p.plan, p.clock
        outs = _land(p)
        if plan.prefilling:
            last = outs[4]
            for r in plan.prefilling:
                v = int(plan.prefill_valid[r.slot])
                r.pos += v
                self.lengths[r.slot] += v
                self.metrics.inc("prefill_tokens", v)
                self.tracer.emit(TM.PREFILL_CHUNK, rid=r.rid, slot=r.slot,
                                 cycle=cycle, args=(v, r.pos))
                self._index_prefix(r)
                if r.pos >= len(r.tokens):
                    self._finish_prefill(r, last[r.slot], cycle=cycle)
            self.metrics.inc("prefill_cycles")
            self.metrics.inc("mixed_cycles")
            self.metrics.gauge_max("peak_prefill_tokens_per_cycle",
                                   int(plan.prefill_valid.sum()))
        live = [r for r in plan.decoding if r.state != FINISHED]
        if len(live) < len(plan.decoding):
            self.metrics.inc("zombie_rows", len(plan.decoding) - len(live))
        if live:
            tokens, valid, n, nxt = outs[:4]
            for r in live:
                self._harvest_decode_row(r, tokens, valid, n, nxt,
                                         cycle=cycle)
            lmask = np.zeros(self.num_slots, bool)
            lmask[[r.slot for r in live]] = True
            self.metrics.inc("accepted", int(n[lmask].sum()))
            self.metrics.inc("drafted", self.ecfg.gamma * len(live))

    def _fused_step(self) -> bool:
        """One planned cycle, synchronously: dispatch, wait, harvest."""
        plan = self._plan_cycle()
        if plan is None:
            return self._fast_forward()
        if self._plan_wide_cycle(plan):
            self._prefill_cycle([r for r in self.slots
                                 if r is not None and not r.prefill_done])
        else:
            p = self._dispatch_unified(plan)
            _land(p)
            self._stamp_wall("unified", p.t0)
            self._harvest_unified(p)
        self._track_residency()
        self.metrics.inc("cycles")
        self.clock += 1.0
        return True

    # -- pipelined dispatch/harvest (async overlap) --------------------------

    def _free_run_ok(self) -> bool:
        """May this call dispatch before harvesting the in-flight cycle?
        Only on pure-decode stretches where planning from one-cycle-stale
        host state cannot change the schedule: nothing queued, every
        resident row past prefill and more than γ+1 tokens from its cap
        (cap-driven retires are foreseen; only stop tokens make zombies),
        no copy-on-write owed, the in-flight cycle itself pure decode, and
        greedy decoding: a non-greedy run always drains, so its draws never
        depend on the overlap."""
        p = self._in_flight
        horizon = self.ecfg.gamma + 1
        return (p is not None and p.kind == "unified"
                and not p.plan.prefilling
                and not self.queue
                and not self._pending_cow
                and self.ecfg.greedy
                and all(r is None or (r.prefill_done
                                      and len(r.output) + horizon
                                      < r.max_new)
                        for r in self.slots))

    def _harvest_pending(self) -> None:
        """Land the in-flight cycle (its event is the one sync, one cycle
        late), stamp its walls split into dispatch / effective step /
        overlapped host time, fold its results in, and land the spill /
        restore copies in flight."""
        p, self._in_flight = self._in_flight, None
        if p is None:
            return
        t_h = time.perf_counter()
        if p.done is not None:
            p.done.synchronize()
        now = time.perf_counter()
        dispatch_dt = p.t_dispatch - p.t0
        self._stamp_wall_at(p.kind + ".dispatch", dispatch_dt, p.clock)
        self._stamp_wall_at(p.kind, dispatch_dt + (now - t_h), p.clock)
        self._stamp_wall_at(p.kind + ".overlap", t_h - p.t_dispatch, p.clock)
        if p.kind == "unified":
            self._harvest_unified(p)
        else:
            self._harvest_wide(p)
        self._finalize_swaps()
        self._track_residency(cycle=p.clock)

    def _finalize_swaps(self) -> None:
        """Land the spill / restore copies dispatched since the last
        harvest, each on its own event (they have overlapped the fused
        step since, so the wait is short), and stamp their walls:
        dispatch plus the residual wait."""
        in_flight, self._swaps_in_flight = self._swaps_in_flight, []
        for kind, handle, dispatch_dt, cycle in in_flight:
            t0 = time.perf_counter()
            if kind == "spill":
                self.spill.finalize(handle)
            elif handle is not None:
                handle.synchronize()
            self._stamp_wall_at(
                kind, dispatch_dt + time.perf_counter() - t0, cycle)

    def _take_staged_chunk(self, plan: CyclePlan):
        """The fused step's chunk operands: the staged device copies when
        the staged prediction matches this plan exactly (a host compare,
        never a correctness input), a fresh copy otherwise."""
        st, self._staged_chunk = self._staged_chunk, None
        if (st is not None and np.array_equal(st[0], plan.chunk_tokens)
                and np.array_equal(st[1], plan.prefill_valid)):
            return st[2], st[3]
        return (self._to_device(plan.chunk_tokens),
                self._to_device(plan.prefill_valid))

    def _stage_next_chunk(self, plan: CyclePlan) -> None:
        """Copy the next cycle's predicted prefill-chunk operands to the
        device while the just-dispatched step runs (the planner's budget
        walk one chunk ahead; a changed plan fails the match and the
        copies drop)."""
        if not self.overlap or not plan.prefilling:
            self._staged_chunk = None
            return
        width = self.ecfg.gamma + 1
        chunk = np.zeros((self.num_slots, width), np.int32)
        valid = np.zeros(self.num_slots, np.int32)
        budget = self.max_prefill_tokens_per_step
        budget = budget if budget is not None else self.num_slots * width
        staged = False
        for slot, r in enumerate(self.slots):
            if r is None or r.prefill_done or budget <= 0:
                continue
            pos = r.pos + (int(plan.prefill_valid[slot])
                           if r in plan.prefilling else 0)
            v = min(self._chunk_len(r, pos, width), budget)
            if v <= 0:
                continue
            chunk[slot, :v] = r.tokens[pos:pos + v]
            valid[slot] = v
            budget -= v
            staged = True
        self._staged_chunk = ((chunk, valid, self._to_device(chunk),
                               self._to_device(valid)) if staged else None)

    def _fused_step_pipelined(self) -> bool:
        """One pipelined call. Drain regime: harvest, admit, plan,
        dispatch. Free-run regime (pure decode): plan from one-cycle-stale
        host state, dispatch first, then harvest the previous cycle while
        the device runs the new one."""
        free_run = self._free_run_ok()
        if not free_run:
            self._harvest_pending()
            self._admit_ready()
        plan = self._plan_cycle()
        if plan is None:
            # drain a trailing zombie-only cycle before idling
            self._harvest_pending()
            return self._fast_forward()
        if self._plan_wide_cycle(plan):
            nxt = self._dispatch_wide(
                [r for r in self.slots
                 if r is not None and not r.prefill_done])
        else:
            nxt = self._dispatch_unified(plan, stale=free_run)
        self.metrics.inc("cycles")
        self.clock += 1.0
        if free_run:
            self._harvest_pending()
        self._in_flight = nxt
        return True

    # -- invariants --------------------------------------------------------

    def check_invariants(self) -> None:
        """Cross-registry checks: allocator refcounts and reservations,
        host tables inside the pool (the device side reads out-of-range
        entries as the trash block, so an out-of-range host entry is
        scheduler corruption), the prefix trie against the pool, and the
        spill store against the allocator's swapped keys."""
        if not self.paged:
            return
        self.pool.check_invariants()
        assert self.table.min() >= 0 and self.table.max() < self.num_blocks, \
            "host block table entry outside [0, num_blocks)"
        if self.prefix is not None:
            self.prefix.check_invariants()
        if self.spill is not None:
            assert set(self.pool.swapped_keys()) == set(self.spill.keys()), \
                "spill store out of sync with allocator swapped keys"

    # -- decode ------------------------------------------------------------

    def step(self) -> bool:
        """Admit what's ready, then run one serving cycle: the pipelined
        fused step (default), the synchronous fused step
        (``overlap=False``), or the alternating prefill-chunk / decode
        cycle (``fused=False`` and the autoregressive baseline). Returns
        False when there was nothing to do."""
        if self.debug_invariants > 0 and self.paged:
            self._steps_since_check += 1
            if self._steps_since_check >= self.debug_invariants:
                self._steps_since_check = 0
                self.check_invariants()
        if self.overlap:
            return self._fused_step_pipelined()
        self._admit_ready()
        if self.fused:
            return self._fused_step()
        prefilling = [r for r in self.slots
                      if r is not None and not r.prefill_done]
        if prefilling:
            self._prefill_cycle(prefilling)
            self._track_residency()
            self.metrics.inc("cycles")
            self.clock += 1.0
            return True
        active = np.array([r is not None for r in self.slots])
        if not active.any():
            return self._fast_forward()
        horizon = (self.ecfg.gamma + 1) if self.speculative else 1
        if self.paged:
            for slot in np.flatnonzero(active):
                self._grow_blocks(self.slots[slot],
                                  int(self.lengths[slot]) + horizon)
        self._push_host_state()
        cur = self._to_device(self.cur)
        act = self._to_device(active)
        t0 = time.perf_counter()
        if self.speculative:
            self._record_shapes("spec", cur, act)
            res, self.cache = _masked_spec(self.rt, self.params, self.cache,
                                           cur, act, self.ecfg,
                                           self.generator)
            host, done = _stage_to_host(
                (res.tokens, res.valid, res.n_accepted, res.next_token))
            if done is not None:
                done.synchronize()
            tokens, valid, n, nxt = (h.numpy() for h in host)
            self.metrics.inc("accepted", int(n[active].sum()))
            self.metrics.inc("drafted", self.ecfg.gamma * int(active.sum()))
            self._stamp_wall("spec", t0)
        else:
            self._record_shapes("auto", cur, act)
            nxt_d, self.cache = _masked_auto(self.rt, self.params,
                                             self.cache, cur, act)
            host, done = _stage_to_host((nxt_d,))
            if done is not None:
                done.synchronize()
            nxt = host[0].numpy()
            tokens = nxt[:, None]
            valid = np.ones_like(tokens, bool)
            n = np.zeros(self.num_slots, np.int64)
            self._stamp_wall("auto", t0)
        for slot in np.flatnonzero(active):
            self._harvest_decode_row(self.slots[slot], tokens, valid, n, nxt)
        self._track_residency()
        self.metrics.inc("cycles")
        self.clock += 1.0
        return True

    def run(self, max_cycles: int = 100_000) -> list[Request]:
        """Drive until every submitted request finishes."""
        for _ in range(max_cycles):
            if not self.step():
                break
        if not self.idle:
            raise RuntimeError(f"scheduler not idle after {max_cycles} "
                               "cycles")
        return self.finished

    def latency_summary(self) -> dict:
        """TTFT and inter-token latency percentiles over finished requests
        (cycles, and wall ms for the gaps); None where there is no data."""
        ttft = [r.ttft_cycles for r in self.finished
                if r.ttft_cycles is not None]
        gaps = np.concatenate(
            [r.itl_cycles for r in self.finished] or [np.zeros(0)])
        wall_gaps = np.concatenate(
            [np.diff(np.asarray(r.token_walls, np.float64))
             for r in self.finished] or [np.zeros(0)])
        out: dict = {k: None for k in (
            "ttft_cycles_mean", "ttft_cycles_p50", "ttft_cycles_p95",
            "itl_cycles_mean", "itl_cycles_p50", "itl_cycles_p95",
            "itl_ms_p50", "itl_ms_p95")}
        if ttft:
            out["ttft_cycles_mean"] = float(np.mean(ttft))
            out["ttft_cycles_p50"] = float(np.percentile(ttft, 50))
            out["ttft_cycles_p95"] = float(np.percentile(ttft, 95))
        if gaps.size:
            out["itl_cycles_mean"] = float(np.mean(gaps))
            out["itl_cycles_p50"] = float(np.percentile(gaps, 50))
            out["itl_cycles_p95"] = float(np.percentile(gaps, 95))
        if wall_gaps.size:
            out["itl_ms_p50"] = float(np.percentile(wall_gaps, 50) * 1e3)
            out["itl_ms_p95"] = float(np.percentile(wall_gaps, 95) * 1e3)
        return out

    def _request_slo_hit(self, req: Request) -> bool:
        dl = self._ttft_deadline_cycles(req)
        if dl is not None:
            if req.ttft_cycles is None:
                return False
            if req.arrival + req.ttft_cycles > dl:
                return False
        if req.itl_target_ms is not None and len(req.token_cycles) > 1:
            tgt = self.cost.ms_to_cycles(req.itl_target_ms)
            if float(req.itl_cycles.max()) > tgt:
                return False
        return True

    def goodput_summary(self) -> dict:
        slo = [r for r in self.finished if r.has_slo]
        hits = sum(self._request_slo_hit(r) for r in slo)
        return {"slo_finished": len(slo), "slo_hits": hits,
                "slo_hit_rate": hits / len(slo) if slo else None}

    def summary(self) -> dict:
        """The run report from the metrics registry: counters, gauges
        (the prefix cache's and the spill store's among them), derived
        ratios, per-bucket walls beside the cost model (``cow``,
        ``spill`` and ``restore`` included), latency and goodput, the step
        shapes and the tracer's health."""
        m = self.metrics
        if self.paged:
            m.gauge("pool_blocks", self.pool.capacity)
            m.gauge("pool_high_water_blocks", self.pool.high_water)
            m.gauge("block_size", self.block_size)
        if self.prefix is not None:
            for k, v in self.prefix.snapshot().items():
                m.gauge(k, v)
        if self.swap:
            m.gauge("swapped_now", self.pool.swapped_total)
            for k, v in self.spill.snapshot().items():
                m.gauge(k, v)
        s = m.snapshot()
        if self.finished:
            lat = [r.finished_at - r.arrival for r in self.finished]
            s["mean_latency_cycles"] = float(np.mean(lat))
        s.update(self.latency_summary())
        s.update(self.goodput_summary())
        s["trace_counts"] = self.trace_counts
        s["step_shapes"] = {k: sorted(v)
                            for k, v in sorted(self.step_shapes.items())}
        s["telemetry"] = {"trace_enabled": self.tracer.enabled,
                          "trace_events": len(self.tracer.ring),
                          "trace_dropped": self.tracer.dropped}
        return s
