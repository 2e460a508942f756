"""Host-side serving observability: one event stream, three faces.

The serving stack's value claim is a wall-clock ratio driven by
per-request acceptance dynamics, but until this module the only
visibility was end-of-run aggregates spread over three parallel ad-hoc
stores: ``Scheduler.stats`` (a plain dict), ``Scheduler.step_walls``
(wall-time pairs), and per-benchmark JSON assembled by hand. This module
replaces all three with one layered subsystem:

* :class:`Tracer` — a **request-lifecycle tracer**. Every request emits
  SUBMIT → ADMIT (with prefix-hit depth) → PREFILL_CHUNK* → CYCLE
  (γ proposed, k accepted) → PREEMPT/SPILL/RESTORE/RESUME → RETIRE
  events into a bounded ring buffer of plain tuples, stamped with
  ``time.perf_counter()`` and the scheduler's cycle index. Events are
  fed exclusively from the scheduler's host-authoritative state (planner
  decisions, harvested numpy results, allocator transitions) so
  instrumentation **never touches a traced value**: no device syncs, no
  new compile buckets — tracing on or off is bitwise identical serving.
  A full ring drops the *oldest* events (``dropped`` counts them); emit
  never blocks and never grows without bound.

* :class:`MetricsRegistry` — typed **counters / gauges / histograms**
  plus the per-compile-bucket wall store. ``observe_wall`` is the single
  entry point for step timings: it feeds both the ``bucket_wall_ms``
  view and the online :class:`~repro.serving.costmodel.CostModel`, so
  the two can never diverge on bucket keys again. ``snapshot()`` is the
  one source ``Scheduler.summary()``, the ``serve.py`` stats lines, and
  the ``benchmarks/throughput.py`` gate JSON all read.

* **Exporters** — :func:`perfetto_trace` renders the ring as Chrome
  ``trace_event`` JSON (one track per slot, one for device steps, one
  for the spill subsystem, counter tracks for pool occupancy /
  per-cycle accepted tokens; loads directly in ``chrome://tracing`` or
  https://ui.perfetto.dev), and :func:`metrics_jsonl` renders a
  snapshot as newline-delimited JSON. Both are wired as
  ``--trace-out`` / ``--metrics-out`` on ``repro.launch.serve`` and
  ``benchmarks/throughput.py``.

The zero-sync guarantee is machine-checked: ``tools/speclint`` flags any
telemetry sink call (``emit``/``inc``/``gauge``/``observe``/…) whose
argument dataflows from a jit entry point (rule ``sync-item``), with a
seeded corpus case proving the rule fires.
"""
from __future__ import annotations

import json
import time
from collections import deque

# -- event taxonomy ---------------------------------------------------------
# One request's lifecycle, in order. Every event is a plain tuple
#   (ts: float perf_counter, cycle: float, kind: str, rid: int,
#    slot: int, args: tuple)
# with host-only payloads; ``args`` per kind:
SUBMIT = "submit"            # (n_prompt, max_new)
ADMIT = "admit"              # (prefix_matched_tokens,) — prefix-hit depth
RESUME = "resume"            # (matched_blocks, restored_blocks)
PREFILL_CHUNK = "prefill"    # (tokens_consumed, pos_after)
CYCLE = "cycle"              # (gamma_proposed, k_accepted, delivered)
PREEMPT = "preempt"          # (spilled_blocks,)
SPILL = "spill"              # (blocks, bytes)
RESTORE = "restore"          # (blocks,)
RETIRE = "retire"            # (output_tokens,)
STEP = "step"                # (bucket_name, wall_ms) — one device step
COUNTERS = "counters"        # (resident_tokens, allocated_blocks,
#                               parked_blocks, swapped_blocks, queue_depth)

LIFECYCLE_KINDS = (SUBMIT, ADMIT, RESUME, PREFILL_CHUNK, CYCLE, PREEMPT,
                   SPILL, RESTORE, RETIRE, STEP, COUNTERS)


class Tracer:
    """Bounded ring of lifecycle events (plain tuples, host values only).

    ``enabled=False`` (the default) makes :meth:`emit` a single attribute
    check — telemetry-off serving does no per-event work at all. The ring
    is a ``deque(maxlen=capacity)``: a saturated trace drops its oldest
    events rather than growing; ``dropped`` reports how many."""

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1 (got {capacity})")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.ring: deque = deque(maxlen=self.capacity)
        self.emitted = 0

    def emit(self, kind: str, rid: int = -1, slot: int = -1,
             cycle: float = -1.0, args: tuple = ()) -> None:
        """Append one event. Callers must pass HOST values only (numpy
        scalars coerced to int/float before the call) — speclint's
        ``sync-item`` rule flags any traced argument at lint time."""
        if not self.enabled:
            return
        self.emitted += 1
        self.ring.append((time.perf_counter(), cycle, kind, rid, slot,
                          args))

    @property
    def dropped(self) -> int:
        """Events evicted by the ring bound (oldest-first)."""
        return self.emitted - len(self.ring)

    def events(self) -> list[tuple]:
        return list(self.ring)

    def reset(self) -> None:
        self.ring.clear()
        self.emitted = 0


class Histogram:
    """Exact small-domain histogram (counts per value) with running
    sum/min/max — sized for per-cycle acceptance lengths (k ∈ [0, γ]),
    prefix-hit depths and block counts, not for unbounded floats."""

    __slots__ = ("counts", "n", "total", "min", "max")

    def __init__(self):
        self.counts: dict = {}
        self.n = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def observe(self, value) -> None:
        v = int(value) if float(value).is_integer() else float(value)
        self.counts[v] = self.counts.get(v, 0) + 1
        self.n += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> float | None:
        return self.total / self.n if self.n else None

    def snapshot(self) -> dict:
        return {"counts": {str(k): v for k, v in sorted(self.counts.items())},
                "n": self.n, "mean": self.mean,
                "min": self.min, "max": self.max}


class MetricsRegistry:
    """Typed metric store: the ONE keyed place serving numbers live.

    * ``inc(name)`` — monotone counters (events, tokens, cycles).
    * ``gauge(name, v)`` — point-in-time values (pool size, queue depth).
    * ``gauge_max(name, v)`` — peak-tracking gauges (high-water marks).
    * ``observe(name, v)`` — histograms (acceptance length, hit depth).
    * ``observe_wall(name, seconds)`` — per-compile-bucket wall store;
      also feeds the bound :class:`CostModel` so the ``bucket_wall_ms``
      and ``cost_model`` views share one set of keys by construction.
    * ``set_config(name, v)`` — subsystem on/off flags the formatter
      keys off (a disabled subsystem prints an explicit "off", never
      silence).

    ``snapshot()`` returns a flat JSON-ready dict: counters and gauges at
    top level (backwards-compatible with the old ``Scheduler.stats``
    spellings), derived ratios (``tokens_per_cycle``, ``acceptance``,
    ``prefix_hit_rate``) computed here once, plus structured
    ``histograms`` / ``bucket_wall_ms`` / ``cost_model`` /
    ``subsystems`` / ``telemetry`` sections.
    """

    def __init__(self, cost=None):
        self._cost = cost
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, Histogram] = {}
        self.walls: dict[str, list] = {}     # name -> [calls, total_s]
        self.config: dict[str, object] = {}

    def bind_cost(self, cost) -> None:
        """Attach the online cost model ``observe_wall`` feeds. The model
        persists across ``reset()`` (it outlives runs, like the compiled
        steps it measures)."""
        self._cost = cost

    def reset(self) -> None:
        """Clear per-run state; the bound cost model persists."""
        self.counters.clear()
        self.gauges.clear()
        self.hists.clear()
        self.walls.clear()
        self.config.clear()

    # -- writes ----------------------------------------------------------

    def declare(self, *names: str) -> None:
        """Zero-init counters so every snapshot carries the full key set
        (consumers index, never ``.get``)."""
        for n in names:
            self.counters.setdefault(n, 0)

    def inc(self, name: str, v: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + v

    def gauge(self, name: str, v) -> None:
        self.gauges[name] = v

    def gauge_max(self, name: str, v) -> None:
        self.gauges[name] = max(self.gauges.get(name, v), v)

    def observe(self, name: str, v) -> None:
        self.hists.setdefault(name, Histogram()).observe(v)

    def observe_wall(self, name: str, seconds: float) -> None:
        """Fold one device-step invocation's wall seconds into the
        bucket — and into the cost model, through the same key."""
        w = self.walls.setdefault(name, [0, 0.0])
        w[0] += 1
        w[1] += seconds
        if self._cost is not None:
            self._cost.observe(name, seconds * 1e3)

    def set_config(self, name: str, v) -> None:
        self.config[name] = v

    # -- reads -----------------------------------------------------------

    def counter(self, name: str) -> float:
        return self.counters.get(name, 0)

    def wall_snapshot(self) -> dict:
        """The ``bucket_wall_ms`` view: per-bucket calls/total/mean ms."""
        return {name: {"calls": calls, "total_ms": total * 1e3,
                       "mean_ms": total * 1e3 / max(calls, 1)}
                for name, (calls, total) in sorted(self.walls.items())}

    def snapshot(self) -> dict:
        s: dict = dict(self.counters)
        s.update(self.gauges)
        c = self.counters
        s["tokens_per_cycle"] = (c.get("committed", 0)
                                 / max(c.get("cycles", 0), 1))
        s["acceptance"] = (c["accepted"] / c["drafted"]
                           if c.get("drafted") else None)
        if self.config.get("prefix_cache"):
            s["prefix_hit_rate"] = (c.get("prefix_hits", 0)
                                    / max(c.get("prefix_queries", 0), 1))
        s["histograms"] = {name: h.snapshot()
                           for name, h in sorted(self.hists.items())}
        s["bucket_wall_ms"] = self.wall_snapshot()
        # pipelined-dispatch overlap ratio, derived from the wall store:
        # ``<step>.overlap`` buckets hold the host time that ran in the
        # shadow of an in-flight device step, their base buckets the
        # effective (non-overlapped) step cost. None until some deferred
        # harvest has stamped an overlap window (overlap off, or a run
        # too short to leave the drain regime).
        overlap_s = sum(t for name, (_, t) in self.walls.items()
                        if name.endswith(".overlap"))
        busy_s = sum(t for name, (_, t) in self.walls.items()
                     if name + ".overlap" in self.walls)
        s["overlap_ratio"] = (overlap_s / (overlap_s + busy_s)
                              if overlap_s + busy_s > 0 else None)
        if self._cost is not None:
            s["cost_model"] = self._cost.snapshot()
        s["subsystems"] = dict(self.config)
        return s


class Telemetry:
    """One scheduler's observability bundle: tracer + registry.

    Constructed once and handed to the :class:`Scheduler`; ``reset()``
    clears per-run state (ring, counters) while the compile-lifetime
    pieces (the bound cost model, the ``trace`` enable flag and ring
    capacity) persist — mirroring how the scheduler's jit cache and
    ``trace_counts`` survive ``Scheduler.reset()``."""

    def __init__(self, trace: bool = False, trace_capacity: int = 65536):
        self.trace = bool(trace)
        self.trace_capacity = int(trace_capacity)
        self.tracer = Tracer(self.trace_capacity, enabled=self.trace)
        self.metrics = MetricsRegistry()

    def bind_cost(self, cost) -> None:
        self.metrics.bind_cost(cost)

    def reset(self) -> None:
        self.tracer = Tracer(self.trace_capacity, enabled=self.trace)
        self.metrics.reset()


# -- exporters --------------------------------------------------------------

_PID = 1
_TID_DEVICE = 2        # compiled device steps (one at a time)
_TID_SPILL = 3         # preemption / spill subsystem instants
_TID_DISPATCH = 4      # host dispatch + overlap spans (pipelined mode)
_TID_SLOT0 = 10        # slot i -> tid 10 + i


def _tid_slot(slot: int) -> int:
    return _TID_SLOT0 + max(slot, 0)


def perfetto_trace(tracer: Tracer, process_name: str = "cassandra-serve"
                   ) -> dict:
    """Render the ring as Chrome/Perfetto ``trace_event`` JSON.

    Track layout: one thread track per slot carrying request lifecycle
    spans (``X`` complete events ADMIT→RETIRE/PREEMPT) with per-cycle
    instants (prefill chunks, draft/verify cycles with γ/k args); a
    device track of compiled-step spans (from STEP events, start
    back-computed as end − duration); a dispatch track carrying the
    pipelined scheduler's ``*.dispatch`` (host time to enqueue the
    step) and ``*.overlap`` (device time hidden behind host work)
    spans; a spill track of preempt/spill/restore instants; and counter
    tracks (``C``) for pool occupancy, queue depth and per-cycle
    accepted tokens. Timestamps are
    µs relative to the first event; events within a track are emitted in
    non-decreasing ``ts`` order."""
    events = tracer.events()
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = events[0][0]

    def us(ts: float) -> float:
        return (ts - t0) * 1e6

    tracks: dict[int, list] = {}

    def put(tid: int, ev: dict) -> None:
        ev["pid"] = _PID
        ev["tid"] = tid
        tracks.setdefault(tid, []).append(ev)

    counters: list[dict] = []

    def put_counter(ts_us: float, name: str, series: dict) -> None:
        counters.append({"name": name, "ph": "C", "ts": ts_us,
                         "pid": _PID, "args": series})

    open_spans: dict[int, tuple] = {}   # slot -> (start_us, rid, kind)

    def close_span(slot: int, end_us: float, how: str, args: dict) -> None:
        start_us, rid, opened = open_spans.pop(slot, (None, None, None))
        if start_us is None:
            return
        put(_tid_slot(slot), {
            "name": f"req {rid}", "ph": "X", "ts": start_us,
            "dur": max(end_us - start_us, 0.0), "cat": "request",
            "args": {"opened_by": opened, "closed_by": how, **args}})

    accepted_by_cycle: dict[float, int] = {}
    last_us = 0.0
    for ts, cycle, kind, rid, slot, args in events:
        t = us(ts)
        last_us = max(last_us, t)
        if kind in (ADMIT, RESUME):
            close_span(slot, t, "reopened", {})
            open_spans[slot] = (t, rid, kind)
            depth = args[0] if args else 0
            put(_tid_slot(slot), {"name": kind, "ph": "i", "ts": t,
                                  "s": "t", "cat": "lifecycle",
                                  "args": {"rid": rid, "cycle": cycle,
                                           "prefix_depth": depth}})
        elif kind == RETIRE:
            close_span(slot, t, RETIRE,
                       {"output_tokens": args[0] if args else None})
        elif kind == PREEMPT:
            close_span(slot, t, PREEMPT,
                       {"spilled_blocks": args[0] if args else None})
            put(_TID_SPILL, {"name": PREEMPT, "ph": "i", "ts": t,
                             "s": "t", "cat": "swap",
                             "args": {"rid": rid, "cycle": cycle}})
        elif kind == PREFILL_CHUNK:
            put(_tid_slot(slot), {
                "name": PREFILL_CHUNK, "ph": "i", "ts": t, "s": "t",
                "cat": "prefill",
                "args": {"rid": rid, "cycle": cycle,
                         "tokens": args[0] if args else None}})
        elif kind == CYCLE:
            g, k = (args[0], args[1]) if len(args) >= 2 else (None, None)
            put(_tid_slot(slot), {
                "name": CYCLE, "ph": "i", "ts": t, "s": "t",
                "cat": "decode",
                "args": {"rid": rid, "cycle": cycle, "gamma": g,
                         "accepted": k}})
            if k is not None:
                accepted_by_cycle[cycle] = (
                    accepted_by_cycle.get(cycle, 0) + int(k))
                put_counter(t, "accepted_tokens_per_cycle",
                            {"accepted": accepted_by_cycle[cycle]})
        elif kind in (SPILL, RESTORE):
            put(_TID_SPILL, {"name": kind, "ph": "i", "ts": t, "s": "t",
                             "cat": "swap",
                             "args": {"rid": rid, "cycle": cycle,
                                      "blocks": args[0] if args else None}})
        elif kind == STEP:
            name, wall_ms = args
            dur = max(float(wall_ms) * 1e3, 0.0)       # ms -> us
            pipelined = name.endswith((".dispatch", ".overlap"))
            put(_TID_DISPATCH if pipelined else _TID_DEVICE,
                {"name": name, "ph": "X",
                 "ts": max(t - dur, 0.0), "dur": dur,
                 "cat": "dispatch" if pipelined else "device",
                 "args": {"cycle": cycle}})
        elif kind == COUNTERS:
            resident, allocated, parked, swapped, qdepth = args
            put_counter(t, "pool_blocks",
                        {"allocated": allocated, "parked": parked,
                         "swapped": swapped})
            put_counter(t, "resident_tokens", {"tokens": resident})
            put_counter(t, "queue_depth", {"requests": qdepth})
        elif kind == SUBMIT:
            put(_TID_SPILL, {"name": SUBMIT, "ph": "i", "ts": t,
                             "s": "t", "cat": "lifecycle",
                             "args": {"rid": rid}})
    for slot in list(open_spans):
        close_span(slot, last_us, "trace-end", {})

    out = [{"name": "process_name", "ph": "M", "pid": _PID,
            "args": {"name": process_name}}]
    names = {_TID_DEVICE: "device steps", _TID_SPILL: "spill/preempt",
             _TID_DISPATCH: "dispatch/overlap"}
    for tid in sorted(tracks):
        label = names.get(tid, f"slot {tid - _TID_SLOT0}")
        out.append({"name": "thread_name", "ph": "M", "pid": _PID,
                    "tid": tid, "args": {"name": label}})
        out.extend(sorted(tracks[tid], key=lambda e: e["ts"]))
    out.extend(sorted(counters, key=lambda e: e["ts"]))
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"dropped_events": tracer.dropped,
                          "emitted_events": tracer.emitted}}


def metrics_jsonl(snapshot: dict) -> str:
    """Render a ``MetricsRegistry.snapshot()``-shaped dict (or a full
    ``Scheduler.summary()``) as newline-delimited JSON: one object per
    metric, ``{"name": ..., "kind": ..., "value": ...}``. Nested
    sections (histograms, wall buckets, cost model, subsystems) flatten
    to dotted names."""
    lines = []

    def put(name: str, kind: str, value) -> None:
        lines.append(json.dumps({"name": name, "kind": kind,
                                 "value": value}, sort_keys=True))

    for key in sorted(snapshot):
        val = snapshot[key]
        if key == "histograms":
            for hname, h in val.items():
                put(f"hist.{hname}", "histogram", h)
        elif key == "bucket_wall_ms":
            for bname, b in val.items():
                put(f"wall.{bname}", "wall_bucket", b)
        elif key == "cost_model":
            put("cost_model", "cost_model", val)
        elif key == "subsystems":
            for cname, c in val.items():
                put(f"config.{cname}", "config", c)
        elif key == "trace_counts":
            for tname, t in val.items():
                put(f"traces.{tname}", "counter", t)
        elif isinstance(val, dict):
            put(key, "section", val)
        else:
            put(key, "scalar", val)
    return "\n".join(lines) + "\n"


def write_trace(path: str, tracer: Tracer) -> None:
    with open(path, "w") as f:
        json.dump(perfetto_trace(tracer), f)


def write_metrics(path: str, snapshot: dict) -> None:
    with open(path, "w") as f:
        f.write(metrics_jsonl(snapshot))


# -- the one stats formatter ------------------------------------------------

def format_stats_lines(s: dict, *, mode: str, wall_s: float,
                       n_done: int, slots: int) -> list[str]:
    """The single formatter behind every ``serve.py`` stats line.

    ``s`` is a ``Scheduler.summary()`` dict. Section lines key off the
    ``subsystems`` config flags — a subsystem that is ON prints even
    when its counters are all zero (the old per-dict ``if`` guards
    silently printed *nothing* when e.g. SLO requests were declared but
    none finished), and every key is indexed directly so a missing key
    raises ``KeyError`` instead of formatting garbage."""
    sub = s["subsystems"]
    lines = [
        (f"[sched:{mode}] {n_done} reqs through {slots} slots, "
         f"cycles={s['cycles']} (prefill={s['prefill_cycles']}, "
         f"mixed={s['mixed_cycles']}), "
         f"tokens/cycle={s['tokens_per_cycle']:.2f}, "
         f"acceptance={s['acceptance']}, "
         f"mean latency={s.get('mean_latency_cycles', 0):.1f} cycles, "
         f"wall={wall_s:.1f}s"),
        (f"[latency] ttft p50/p95={s['ttft_cycles_p50'] or 0:.1f}/"
         f"{s['ttft_cycles_p95'] or 0:.1f} cycles, "
         f"itl p50/p95={s['itl_cycles_p50'] or 0:.1f}/"
         f"{s['itl_cycles_p95'] or 0:.1f} cycles"),
    ]
    if sub["slo_declared"]:
        cm = s["cost_model"]
        rate = s["slo_hit_rate"]
        lines.append(
            f"[slo] deadline hits {s['slo_hits']}/{s['slo_finished']} "
            f"(rate={rate if rate is None else format(rate, '.2f')}), "
            f"cost model: cycle_ms={cm['cycle_ms']:.2f} "
            f"(warm={cm['warm']}), "
            f"mode={'slo-aware' if sub['slo_aware'] else 'fifo'}")
    if sub["paged"]:
        lines.append(
            f"[paged] pool={s['pool_blocks']} blocks x "
            f"{s['block_size']} tok, high water="
            f"{s['pool_high_water_blocks']} blocks, peak resident="
            f"{s['peak_resident_tokens']} tok "
            f"(reserved {s['peak_reserved_tokens']})")
    if sub["swap"]:
        lines.append(
            f"[swap] preemptions={s['preemptions']} "
            f"(resumes={s['swap_resumes']}), spilled="
            f"{s['swap_out_blocks']} blocks out / "
            f"{s['swap_in_blocks']} restored / "
            f"{s['swap_matched_blocks']} re-aliased from the prefix "
            f"cache, peak swapped={s['peak_swapped_tokens']} tok "
            f"({s['spill_peak_bytes'] / 1e6:.2f}MB host)")
    if sub["prefix_cache"]:
        lines.append(
            f"[prefix] hit rate={s['prefix_hit_rate']:.2f} "
            f"({s['prefix_hits']}/{s['prefix_queries']} admissions), "
            f"matched={s['prefix_matched_tokens']} tok, "
            f"aliased={s['prefix_blocks_aliased']} blocks, "
            f"cow={s['cow_copies']}, prefill computed="
            f"{s['prefill_tokens']} tok, parked now="
            f"{s['prefix_parked_blocks']} blocks")
    if sub["attn_kernel"] != "off":
        walls = s["bucket_wall_ms"]
        uni = walls.get("unified", {"calls": 0, "mean_ms": 0.0})
        lines.append(
            f"[kernel] attn={sub['attn_kernel']}, unified step "
            f"mean={uni['mean_ms']:.2f}ms over {uni['calls']} calls, "
            f"traces={s['trace_counts'].get('unified', 0)}")
    if sub.get("overlap"):
        ratio = s.get("overlap_ratio")
        walls = s["bucket_wall_ms"]
        disp = walls.get("unified.dispatch", {"calls": 0, "mean_ms": 0.0})
        lines.append(
            f"[overlap] pipelined dispatch/harvest on, ratio="
            f"{'n/a' if ratio is None else format(ratio, '.2f')}, "
            f"dispatch mean={disp['mean_ms']:.2f}ms over "
            f"{disp['calls']} calls")
    return lines
