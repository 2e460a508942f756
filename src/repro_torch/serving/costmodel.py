"""Online measured cost model: tokens → milliseconds per compile bucket.

The serving planner historically traded in abstract *cycle units*: one
fused step, one wide prefill chunk, one spill — each "costs 1". That is
the right model for determinism (the λ arrival clock runs in cycles) but
the wrong one for deadlines, which users state in milliseconds. Every
serving-step bucket (``unified``, ``chunk``, ``spec``, ``auto``,
``spill``, ``restore``, ``cow``) is a *fixed-shape* jit executable, so
one invocation's wall cost is a constant the scheduler can measure
instead of assume: the tokens→ms fit collapses to a running ms-per-call
mean per bucket, because the token width per call is static — the
compile bucket IS the token bucket. ``Scheduler._stamp_wall`` feeds one
observation per device step, so the fit refreshes online as cycles
retire.

The pipelined scheduler (``overlap=True``) stamps walls at *harvest*,
not dispatch, and splits each observation three ways: the base bucket
name (``unified``) keeps the *effective* cost — host dispatch time plus
whatever device wait was NOT hidden behind host work — while
``unified.dispatch`` and ``unified.overlap`` book the enqueue time and
the hidden device time separately. Only the base names appear in
``DECODE_BUCKETS``, so the suffixed buckets are pure telemetry: they
feed the Perfetto dispatch track and the derived ``overlap_ratio``
metric without ever polluting the cycle_ms fit the deadline math uses.

Cold start falls back to the cycle-unit model the planner used before
SLOs existed: every bucket costs ``nominal_cycle_ms`` (default 1.0), so
``ms_to_cycles`` degrades to the identity and deadline math in ms reads
as deadline math in cycles. The model is *advisory*: it converts SLO
deadlines into cycle budgets and breaks planner ties — it never changes
what tokens a request produces (scheduling only reorders work), and the
all-default (no-SLO) scheduler never consults it at a decision point.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class BucketCost:
    """Running per-bucket fit: calls, total ms, total tokens processed.
    ``discarded`` counts warmup observations dropped from the fit (the
    first call of a jit bucket pays trace+compile — seconds, not the
    steady-state cost the planner needs)."""
    calls: int = 0
    total_ms: float = 0.0
    tokens: int = 0
    discarded: int = 0

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.calls, 1)

    @property
    def ms_per_token(self) -> float | None:
        """Marginal token cost — None until token counts were reported."""
        if self.tokens <= 0:
            return None
        return self.total_ms / self.tokens


class CostModel:
    """Per-bucket measured wall costs with a cycle↔ms exchange rate.

    ``observe`` folds one device-step invocation in; ``refresh`` bulk-fits
    from a ``Scheduler.step_walls``-shaped dict (``name -> [calls,
    total_seconds]``), replacing any prior state — the constructor-style
    entry point for fitting a model from a finished run's summary.
    """

    # the buckets whose per-call cost IS one decode cycle, in preference
    # order (a fused serving run measures "unified"; the alternating and
    # autoregressive baselines measure "spec"/"auto")
    DECODE_BUCKETS = ("unified", "spec", "auto")

    def __init__(self, nominal_cycle_ms: float = 1.0,
                 warmup_discard: int = 1):
        if nominal_cycle_ms <= 0:
            raise ValueError(
                f"nominal_cycle_ms must be > 0 (got {nominal_cycle_ms})")
        if warmup_discard < 0:
            raise ValueError(
                f"warmup_discard must be >= 0 (got {warmup_discard})")
        self.nominal_cycle_ms = float(nominal_cycle_ms)
        self.warmup_discard = int(warmup_discard)
        self.buckets: dict[str, BucketCost] = {}

    # -- fitting -----------------------------------------------------------

    def observe(self, bucket: str, wall_ms: float, tokens: int = 0) -> None:
        """Fold one invocation's measured wall time into the bucket.

        Each bucket's first ``warmup_discard`` observations are dropped:
        a jit bucket's first call pays trace+compile (seconds), which
        would dominate the running mean for the rest of the run and
        inflate every ms→cycles conversion. Negative observations are
        clamped to zero — the fit must stay usable even if a caller
        stamps with a misbehaving clock."""
        b = self.buckets.setdefault(bucket, BucketCost())
        if b.discarded < self.warmup_discard:
            b.discarded += 1
            return
        b.calls += 1
        b.total_ms += max(float(wall_ms), 0.0)
        b.tokens += int(tokens)

    def refresh(self, step_walls: dict) -> None:
        """Re-fit from a ``Scheduler.step_walls`` dict (replaces state)."""
        self.buckets = {}
        for name, (calls, total_s) in step_walls.items():
            b = BucketCost(calls=int(calls),
                           total_ms=max(float(total_s), 0.0) * 1e3)
            self.buckets[name] = b

    # -- queries -----------------------------------------------------------

    def __contains__(self, bucket: str) -> bool:
        """A bucket exists once its FIRST observation lands — even while
        warmup discard holds its fit at zero calls. The telemetry
        regression gate leans on this: every compile bucket that ever
        ran must be visible here and in ``bucket_wall_ms``, never only
        in ``trace_counts``."""
        return bucket in self.buckets

    @property
    def warm(self) -> bool:
        """True once any decode-cycle bucket has a measurement."""
        return any(self.buckets.get(n, BucketCost()).calls > 0
                   for n in self.DECODE_BUCKETS)

    def bucket_ms(self, bucket: str) -> float:
        """Measured mean ms per invocation; nominal cycle cost when cold.

        The cold fallback makes every bucket cost one cycle unit, so
        measured-cost comparisons degrade to exactly the cycle-count
        comparisons the pre-SLO planner made."""
        b = self.buckets.get(bucket)
        if b is None or b.calls == 0:
            return self.nominal_cycle_ms
        return b.mean_ms

    def cycle_ms(self) -> float:
        """Measured ms of one decode cycle (the λ clock's tick)."""
        for name in self.DECODE_BUCKETS:
            b = self.buckets.get(name)
            if b is not None and b.calls > 0 and b.total_ms > 0:
                return b.mean_ms
        return self.nominal_cycle_ms

    def ms_to_cycles(self, ms: float) -> float:
        return ms / self.cycle_ms()

    def cycles_to_ms(self, cycles: float) -> float:
        return cycles * self.cycle_ms()

    def snapshot(self) -> dict:
        """JSON-ready view: per-bucket mean ms and the exchange rate."""
        return {
            "cycle_ms": self.cycle_ms(),
            "warm": self.warm,
            "buckets": {
                name: {"calls": b.calls, "mean_ms": b.mean_ms,
                       **({"ms_per_token": b.ms_per_token}
                          if b.ms_per_token is not None else {})}
                for name, b in sorted(self.buckets.items())},
        }
