"""Soak-mode leak/drift detectors over the telemetry windows.

``sim --soak`` runs the simulator for a long horizon (100k virtual
cycles is the reference tier) with the telemetry layer recording every
cycle, then fits trends over the rolled windows (``obs/telemetry.py``):

- **growth detectors** fit a least-squares line to each resource
  watermark series (RSS, allocator blocks, CUDA allocator bytes, the
  compiled-variant census, device-resident snapshot bytes, metrics
  label-series cardinality, verdict-registry size) and trip when the fit shows a
  *sustained, explained, material* climb — slope positive, R^2 above a
  noise gate, and the projected growth over the fitted span past BOTH
  an absolute floor and a relative floor. The three gates together are
  what makes the detector noise-aware: a GC sawtooth fails R^2, a
  one-off allocation step fails the slope fit, a 2 MB wiggle on a 200 MB
  heap fails the floors.
- **drift detectors** bound a series instead: per-queue fairness drift
  (allocated minus water-filled deserved share) must keep its windowed
  mean inside ``bound`` — sustained breach over ``patience``
  consecutive windows trips (one overshoot window is one gang landing;
  three in a row is systematic unfairness). Invariant-violation and
  cycle-error series are bounded at zero.

Warmup windows are skipped (caches, pools, and jit compilation
legitimately grow early); the fit runs on the post-warmup tail.

A trip names the offending series, the fitted slope/R^2/growth, the
window where the climb steepened, and a **replay-bisect pointer**: the
JSONL trace (when recorded) replays bit-exactly, so
``sim --replay <trace>`` with ``--replay-cycles`` clamped to the
suspect window's end reproduces the exact state just past the
inflection — halve from there.

A copy of the JAX package's ``sim/soak.py``. The reference's device
series are JAX's; the port's telemetry probes the CUDA caching allocator
instead (``obs/telemetry.py``): ``jax_device_memory_bytes``'s policy
now holds ``cuda_memory_allocated_bytes`` and
``cuda_memory_reserved_bytes``. No probe of the port counts live device
buffers, so ``jax_live_buffers`` keeps its policy and its detector gets
no data (a series absent from the windows is skipped, as in the
reference). ``jit_cache_entries`` is the port's census
(``solver.kernels.jit_compilation_count``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class GrowthPolicy:
    """Trip thresholds for one watermark series."""

    abs_floor: float          # minimum projected growth over the fit span
    rel_floor: float = 0.05   # ... and as a fraction of the baseline
    r2_min: float = 0.6       # fit quality gate (noise fails this)


@dataclass
class DriftPolicy:
    """Bound for one drift series (checked on window means)."""

    bound: float              # |windowed mean| must stay <= bound
    patience: int = 3         # consecutive breaching windows to trip
    signed: bool = True       # False: only positive breach trips
    warmup_exempt: bool = False  # hard invariant: no warmup skip


# Default soak policy. Keys match the telemetry watermark probes;
# ``fairness_drift:*`` matches per-queue series by prefix. Floors are
# deliberately generous — a soak failure must mean a real leak, not an
# allocator mood; the injected-leak tests pin that the gates still
# catch a genuine linear climb.
GROWTH_POLICY: Dict[str, GrowthPolicy] = {
    "rss_bytes": GrowthPolicy(abs_floor=32 * 1024 * 1024, rel_floor=0.08),
    "alloc_blocks": GrowthPolicy(abs_floor=200_000, rel_floor=0.05),
    # No port probe emits this series (see the module docstring).
    "jax_live_buffers": GrowthPolicy(abs_floor=2_000, rel_floor=0.25),
    "cuda_memory_allocated_bytes": GrowthPolicy(
        abs_floor=16 * 1024 * 1024, rel_floor=0.10
    ),
    "cuda_memory_reserved_bytes": GrowthPolicy(
        abs_floor=16 * 1024 * 1024, rel_floor=0.10
    ),
    "jit_cache_entries": GrowthPolicy(
        # ANY steady post-warmup growth in compiled variants is a
        # retrace leak; 8 entries is far past jitter.
        abs_floor=8, rel_floor=0.0, r2_min=0.5
    ),
    "device_resident_bytes": GrowthPolicy(
        abs_floor=8 * 1024 * 1024, rel_floor=0.20
    ),
    "metrics_series": GrowthPolicy(abs_floor=64, rel_floor=0.10),
    "explain_verdicts": GrowthPolicy(abs_floor=256, rel_floor=0.50),
    # Placement-ledger occupancy (obs/latency.py): entries must die
    # with their pods/jobs — sustained linear growth here is a per-pod
    # ledger leak, exactly the class the metrics-GC pattern forbids.
    "latency_entries": GrowthPolicy(abs_floor=512, rel_floor=0.50),
    # Carried-backlog depth (solver/warm.py): the jobs subset solves
    # rotate through between periodic cycles. Congestion legitimately
    # holds it high and bursty — but a sustained LINEAR climb means
    # arrivals outpace the micro steady state's drain budget and the
    # scheduler is quietly falling behind (placements still land, just
    # ever later). Floors sized so saturation plateaus and burst waves
    # pass while an unbounded admission leak trips.
    "carried_backlog_depth": GrowthPolicy(
        abs_floor=64, rel_floor=0.50, r2_min=0.7
    ),
}

DRIFT_POLICY: Dict[str, DriftPolicy] = {
    "fairness_drift:": DriftPolicy(bound=0.35, patience=3, signed=False),
    # Per-queue p99 arrival→bind placement latency (virtual seconds,
    # obs/latency.py): a slow scheduling-latency regression must fail
    # a soak instead of hiding — same trip semantics as fairness
    # drift. The bound is generous (2 virtual minutes): saturation
    # waves legitimately push p99 to many cycles; a systematic climb
    # past the bound for `patience` windows is a scheduler regression.
    "placement_p99:": DriftPolicy(bound=120.0, patience=3, signed=False),
    # Zero-bound series are hard invariants, not steady-state
    # properties — a cycle error in the first quarter of the run is as
    # fatal as one at the end, so they opt out of the warmup skip.
    "invariant_violations": DriftPolicy(
        bound=0.0, patience=1, warmup_exempt=True
    ),
    "sim_cycle_errors": DriftPolicy(
        bound=0.0, patience=1, warmup_exempt=True
    ),
    # Serving SLO-miss rate (cumulative, obs/latency.py; emitted only
    # once serving placements exist): attainment drift — a regression
    # that slowly erodes serving placement latency — must fail a soak
    # the same way fairness drift does. Bound = twice the default
    # violation budget (1 - KBT_SERVING_ATTAINMENT_TARGET).
    "serving_slo_miss_rate": DriftPolicy(
        bound=0.02, patience=3, signed=False
    ),
    # Placement-quality scorecard (obs/quality.py). Unfairness =
    # 1 - Jain index over per-queue satisfaction ratios: transient
    # imbalance is normal while gangs land, but a windowed mean past
    # the bound for `patience` windows means the scheduler is
    # systematically over-serving some queues — the drift the ROADMAP
    # item-1 quality gate exists to catch. Bound is generous for the
    # same reason fairness_drift's is: a trip must mean a regression,
    # not one gang's worth of overshoot.
    "quality:unfairness": DriftPolicy(
        bound=0.5, patience=3, signed=False
    ),
    # Disruption churn: evictions + re-binds per placement over each
    # scorecard interval. Steady-state churn near zero is the
    # contract; a sustained windowed mean above 1.0 means the
    # scheduler is thrashing (every placement paid for by more than
    # one disruption).
    "quality:churn_per_placement": DriftPolicy(
        bound=1.0, patience=3, signed=False
    ),
}

# Fraction of windows treated as warmup (jit compiles, pool growth).
WARMUP_FRAC = 0.25
# Minimum post-warmup windows for a meaningful fit.
MIN_WINDOWS = 8


@dataclass
class DetectorResult:
    series: str
    kind: str                       # "growth" | "drift"
    tripped: bool
    message: str
    slope_per_kcycle: Optional[float] = None
    r2: Optional[float] = None
    growth: Optional[float] = None
    baseline: Optional[float] = None
    suspect_cycles: Optional[Tuple[int, int]] = None
    windows_fit: int = 0

    def to_dict(self) -> dict:
        out = {
            "series": self.series,
            "kind": self.kind,
            "tripped": self.tripped,
            "message": self.message,
            "windows_fit": self.windows_fit,
        }
        if self.slope_per_kcycle is not None:
            out["slope_per_kcycle"] = round(self.slope_per_kcycle, 4)
        if self.r2 is not None:
            out["r2"] = round(self.r2, 4)
        if self.growth is not None:
            out["growth"] = round(self.growth, 3)
        if self.baseline is not None:
            out["baseline"] = round(self.baseline, 3)
        if self.suspect_cycles is not None:
            out["suspect_cycles"] = list(self.suspect_cycles)
        return out


def fit_linear(points: Sequence[Tuple[float, float]]):
    """Least-squares (slope, intercept, r2) over (x, y) points."""
    n = len(points)
    if n < 2:
        return 0.0, points[0][1] if points else 0.0, 0.0
    sx = sum(p[0] for p in points)
    sy = sum(p[1] for p in points)
    mx, my = sx / n, sy / n
    sxx = sum((p[0] - mx) ** 2 for p in points)
    sxy = sum((p[0] - mx) * (p[1] - my) for p in points)
    if sxx == 0:
        return 0.0, my, 0.0
    slope = sxy / sxx
    intercept = my - slope * mx
    syy = sum((p[1] - my) ** 2 for p in points)
    if syy == 0:
        # A perfectly flat series: zero slope explains it perfectly,
        # but report r2=0 so "no variance" can never pass an r2 gate.
        return slope, intercept, 0.0
    ss_res = sum(
        (p[1] - (intercept + slope * p[0])) ** 2 for p in points
    )
    return slope, intercept, max(0.0, 1.0 - ss_res / syy)


def _windows_series(windows: List[dict], key: str, stat: str):
    """(mid_cycle, stat, start, end) per window carrying ``key``."""
    out = []
    for w in windows:
        ks = w["keys"].get(key)
        if ks is None:
            continue
        out.append((
            (w["start_cycle"] + w["end_cycle"]) / 2.0,
            float(ks[stat]),
            w["start_cycle"],
            w["end_cycle"],
        ))
    return out


def check_growth(
    windows: List[dict], key: str, policy: GrowthPolicy,
    warmup_frac: float = WARMUP_FRAC,
) -> Optional[DetectorResult]:
    """Fit the post-warmup windowed means of ``key``; trip on a
    sustained material climb. None when the series is absent or too
    short to judge."""
    pts = _windows_series(windows, key, "mean")
    if len(pts) < MIN_WINDOWS:
        return None
    skip = int(len(pts) * warmup_frac)
    tail = pts[skip:]
    if len(tail) < MIN_WINDOWS:
        tail = pts[-MIN_WINDOWS:]
    xy = [(p[0], p[1]) for p in tail]
    slope, _intercept, r2 = fit_linear(xy)
    span = xy[-1][0] - xy[0][0]
    growth = slope * span
    baseline = sum(p[1] for p in tail[:3]) / min(3, len(tail))
    rel_gate = policy.rel_floor * max(abs(baseline), 1e-9)
    tripped = (
        slope > 0
        and r2 >= policy.r2_min
        and growth >= policy.abs_floor
        and growth >= rel_gate
    )
    suspect = None
    if tripped:
        # The window with the steepest single-step climb post-warmup:
        # the bisect entry point.
        best, best_delta = tail[-1], -1.0
        for prev, cur in zip(tail, tail[1:]):
            delta = cur[1] - prev[1]
            if delta > best_delta:
                best_delta, best = delta, cur
        suspect = (int(best[2]), int(best[3]))
    msg = (
        f"{key}: slope {slope * 1000:+.3f}/kcycle over "
        f"{len(tail)} windows (r2 {r2:.2f}), projected growth "
        f"{growth:,.1f} from baseline {baseline:,.1f}"
    )
    return DetectorResult(
        series=key, kind="growth", tripped=tripped, message=msg,
        slope_per_kcycle=slope * 1000.0, r2=r2, growth=growth,
        baseline=baseline, suspect_cycles=suspect,
        windows_fit=len(tail),
    )


def check_drift(
    windows: List[dict], key: str, policy: DriftPolicy,
    warmup_frac: float = WARMUP_FRAC,
) -> Optional[DetectorResult]:
    """Bound ``key``'s windowed mean; trip on ``patience`` consecutive
    breaching windows past warmup."""
    pts = _windows_series(windows, key, "mean")
    if not pts:
        return None
    skip = (
        int(len(pts) * warmup_frac)
        if len(pts) >= MIN_WINDOWS and not policy.warmup_exempt
        else 0
    )
    tail = pts[skip:]
    streak = 0
    streak_start = 0
    worst = 0.0
    suspect = None
    tripped = False
    for mid, mean, start, end in tail:
        breach = (
            abs(mean) > policy.bound if policy.signed
            else mean > policy.bound
        )
        if breach:
            if streak == 0:
                streak_start = int(start)
            streak += 1
            if abs(mean) > abs(worst):
                worst = mean
            if streak >= policy.patience and not tripped:
                # The bisect pointer names the FIRST streak that
                # tripped, not whichever isolated window had the worst
                # mean — an isolated spike that never met patience is
                # noise, not the systematic drift being flagged.
                tripped = True
                suspect = (streak_start, int(end))
        else:
            streak = 0
    msg = (
        f"{key}: worst windowed mean {worst:+.4f} vs bound "
        f"{policy.bound:+.4f} ({len(tail)} windows, "
        f"patience {policy.patience})"
    )
    return DetectorResult(
        series=key, kind="drift", tripped=tripped, message=msg,
        growth=worst, suspect_cycles=suspect if tripped else None,
        windows_fit=len(tail),
    )


def run_detectors(
    windows: List[dict],
    growth_policy: Optional[Dict[str, GrowthPolicy]] = None,
    drift_policy: Optional[Dict[str, DriftPolicy]] = None,
    warmup_frac: float = WARMUP_FRAC,
) -> List[DetectorResult]:
    """Evaluate every policy entry against the rolled windows. Series
    absent from the run are skipped (probe not available), not failed."""
    growth_policy = GROWTH_POLICY if growth_policy is None else growth_policy
    drift_policy = DRIFT_POLICY if drift_policy is None else drift_policy
    keys = set()
    for w in windows:
        keys.update(w["keys"])
    results: List[DetectorResult] = []
    for key, policy in sorted(growth_policy.items()):
        r = check_growth(windows, key, policy, warmup_frac)
        if r is not None:
            results.append(r)
    for prefix, policy in sorted(drift_policy.items()):
        matches = (
            sorted(k for k in keys if k.startswith(prefix))
            if prefix.endswith(":") else ([prefix] if prefix in keys else [])
        )
        for key in matches:
            r = check_drift(windows, key, policy, warmup_frac)
            if r is not None:
                results.append(r)
    return results


@dataclass
class SoakVerdict:
    detectors: List[DetectorResult] = field(default_factory=list)
    telemetry_dump: Optional[str] = None
    trace_path: Optional[str] = None

    @property
    def tripped(self) -> List[DetectorResult]:
        return [d for d in self.detectors if d.tripped]

    def to_dict(self) -> dict:
        return {
            "detectors": [d.to_dict() for d in self.detectors],
            "tripped": [d.series for d in self.tripped],
            "telemetry_dump": self.telemetry_dump,
            "replay_bisect": self.replay_hints(),
        }

    def replay_hints(self) -> List[str]:
        """One actionable line per trip: where to point the replay."""
        hints = []
        for d in self.tripped:
            if d.suspect_cycles and self.trace_path:
                a, b = d.suspect_cycles
                hints.append(
                    f"{d.series}: breach steepens in cycles {a}..{b} — "
                    f"bisect with `python -m kube_batch_tpu_torch sim "
                    f"--replay {self.trace_path} --replay-cycles {b}` "
                    f"(replay is bit-exact; halve from there)"
                )
            elif d.suspect_cycles:
                a, b = d.suspect_cycles
                hints.append(
                    f"{d.series}: breach steepens in cycles {a}..{b} — "
                    f"re-run with --trace to get a bisectable recording"
                )
            else:
                hints.append(f"{d.series}: {d.message}")
        return hints
