"""Scheduling metrics.

Mirrors reference pkg/scheduler/metrics/metrics.go (:37-120 definitions,
:122-170 update helpers): e2e/action/plugin/task scheduling latency
histograms, schedule attempts, preemption counters, unschedulable gauges.
The reference exports via Prometheus under namespace "volcano"
(metrics.go:27); here a dependency-free registry with a Prometheus
text-exposition dump serves the same purpose (served by cli.server).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

NAMESPACE = "tpu_batch"

# Default latency buckets (seconds), log-spaced like prometheus.DefBuckets.
_DEF_BUCKETS = [
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
]

# Millisecond-scale buckets (seconds) for the cycle-shaped histograms
# (e2e / per-action / solver-phase). A steady production cycle runs
# ~10-300 ms; prometheus.DefBuckets puts exactly FOUR boundaries in
# that range (25/50/100/250 ms), so every cycle-latency quantile
# collapsed into the same handful of buckets. These give ~15%
# resolution across 1 ms - 1 s and keep a coarse multi-second tail for
# cold/degraded cycles. Bucket policy: doc/design/metrics.md.
MS_BUCKETS = [
    0.001, 0.0025, 0.005, 0.0075, 0.01, 0.015, 0.02, 0.03, 0.045,
    0.065, 0.09, 0.125, 0.175, 0.25, 0.35, 0.5, 0.75, 1.0, 2.5, 10.0,
]


class _Metric:
    def __init__(self, name: str, help_text: str):
        self.name = f"{NAMESPACE}_{name}"
        self.help = help_text
        self._lock = threading.Lock()


class Counter(_Metric):
    def __init__(self, name, help_text=""):
        super().__init__(name, help_text)
        self._values: Dict[Tuple, float] = {}

    def inc(self, labels: Tuple = (), amount: float = 1.0) -> None:
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + amount

    def get(self, labels: Tuple = ()) -> float:
        return self._values.get(labels, 0.0)

    def total(self) -> float:
        """Sum across every label set (engagement asserts in smokes)."""
        with self._lock:
            return sum(self._values.values())

    def remove(self, labels: Tuple) -> bool:
        """Drop one label set (label GC for deleted subjects — without
        this, per-job series accumulate forever; Prometheus clients
        call this deleteLabelValues). Returns True if it existed."""
        with self._lock:
            return self._values.pop(labels, None) is not None

    def series_count(self) -> int:
        return len(self._values)

    def expose(self, label_names: Tuple = ()) -> List[str]:
        lines = [f"# TYPE {self.name} counter"]
        for labels, v in sorted(self._values.items()):
            sel = ",".join(f'{n}="{val}"' for n, val in zip(label_names, labels))
            lines.append(f"{self.name}{{{sel}}} {v}" if sel else f"{self.name} {v}")
        return lines


class Gauge(_Metric):
    def __init__(self, name, help_text=""):
        super().__init__(name, help_text)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, labels: Tuple = ()) -> None:
        with self._lock:
            self._values[labels] = value

    def get(self, labels: Tuple = ()) -> float:
        return self._values.get(labels, 0.0)

    def remove(self, labels: Tuple) -> bool:
        """Drop one label set (see Counter.remove)."""
        with self._lock:
            return self._values.pop(labels, None) is not None

    def series_count(self) -> int:
        return len(self._values)

    def label_sets(self) -> List[Tuple]:
        """Snapshot of live label sets (label GC sweeps diff against
        this)."""
        with self._lock:
            return list(self._values)

    def expose(self, label_names: Tuple = ()) -> List[str]:
        lines = [f"# TYPE {self.name} gauge"]
        for labels, v in sorted(self._values.items()):
            sel = ",".join(f'{n}="{val}"' for n, val in zip(label_names, labels))
            lines.append(f"{self.name}{{{sel}}} {v}" if sel else f"{self.name} {v}")
        return lines


class Histogram(_Metric):
    def __init__(self, name, help_text="", buckets: Optional[List[float]] = None):
        super().__init__(name, help_text)
        self.buckets = sorted(buckets or _DEF_BUCKETS)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}

    def observe(self, value: float, labels: Tuple = ()) -> None:
        with self._lock:
            if labels not in self._counts:
                self._counts[labels] = [0] * len(self.buckets)
            # Prometheus `le` is inclusive: value lands in the first bucket
            # with bound >= value.
            idx = bisect_left(self.buckets, value)
            for i in range(idx, len(self.buckets)):
                self._counts[labels][i] += 1
            self._sums[labels] = self._sums.get(labels, 0.0) + value
            self._totals[labels] = self._totals.get(labels, 0) + 1

    def observe_many(self, values, labels: Tuple = ()) -> None:
        """Batched :meth:`observe`: one lock hold and vectorized bucket
        math for a whole array of samples (50k per cold apply — the
        per-call Python bucket loop was measurable there)."""
        import numpy as np

        arr = np.asarray(values, dtype=np.float64)
        if arr.size == 0:
            return
        n_buckets = len(self.buckets)
        idx = np.searchsorted(self.buckets, arr, side="left")
        binc = np.bincount(idx, minlength=n_buckets + 1)
        # observe() adds 1 to every bucket >= the sample's: bucket i
        # gains the count of samples with idx <= i (cumulative counts).
        cum = np.cumsum(binc[:n_buckets])
        with self._lock:
            if labels not in self._counts:
                self._counts[labels] = [0] * n_buckets
            counts = self._counts[labels]
            for i in range(n_buckets):
                counts[i] += int(cum[i])
            self._sums[labels] = self._sums.get(labels, 0.0) + float(arr.sum())
            self._totals[labels] = self._totals.get(labels, 0) + int(arr.size)

    def count(self, labels: Tuple = ()) -> int:
        with self._lock:
            return self._totals.get(labels, 0)

    def sum(self, labels: Tuple = ()) -> float:
        with self._lock:
            return self._sums.get(labels, 0.0)

    def remove(self, labels: Tuple) -> bool:
        """Drop one label set (see Counter.remove)."""
        with self._lock:
            existed = self._totals.pop(labels, None) is not None
            self._counts.pop(labels, None)
            self._sums.pop(labels, None)
            return existed

    def series_count(self) -> int:
        with self._lock:
            return len(self._totals)

    def expose(self, label_names: Tuple = ()) -> List[str]:
        lines = [f"# TYPE {self.name} histogram"]
        # Under the lock: a scrape iterating the label maps while the
        # scheduler thread observes (or GC removes a series) is a
        # dict-changed-during-iteration crash on the HTTP worker
        # (kbtlint guarded-by bring-up).
        with self._lock:
            for labels in sorted(self._totals):
                base = ",".join(
                    f'{n}="{val}"' for n, val in zip(label_names, labels)
                )
                for b, c in zip(self.buckets, self._counts[labels]):
                    sel = f'{base},le="{b}"' if base else f'le="{b}"'
                    lines.append(f"{self.name}_bucket{{{sel}}} {c}")
                inf_sel = f'{base},le="+Inf"' if base else 'le="+Inf"'
                lines.append(
                    f"{self.name}_bucket{{{inf_sel}}} {self._totals[labels]}"
                )
                sel = f"{{{base}}}" if base else ""
                lines.append(f"{self.name}_sum{sel} {self._sums[labels]}")
                lines.append(f"{self.name}_count{sel} {self._totals[labels]}")
        return lines


class Registry:
    def __init__(self):
        self._metrics: List[Tuple[_Metric, Tuple]] = []

    def register(self, metric: _Metric, label_names: Tuple = ()):
        self._metrics.append((metric, label_names))
        return metric

    def names(self) -> List[str]:
        """Registered metric names WITHOUT the namespace prefix — the
        census drift guard (tests/unit/test_metrics_census.py) compares
        these against doc/design/metrics.md's tables."""
        prefix = f"{NAMESPACE}_"
        out = []
        for metric, _labels in self._metrics:
            name = metric.name
            if name.startswith(prefix):
                name = name[len(prefix):]
            out.append(name)
        return out

    def series_count(self) -> int:
        """Total label sets held across every registered metric — the
        cardinality watermark the soak-mode leak detector fits growth
        on (a per-job label leak shows here as a line going up)."""
        return sum(
            metric.series_count() for metric, _labels in self._metrics
        )

    def expose_text(self) -> str:
        lines: List[str] = []
        for metric, label_names in self._metrics:
            lines.extend(metric.expose(label_names))
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

# Metric set mirrors reference metrics.go:37-120. The cycle-shaped
# histograms (e2e / action / solver-phase) get ms-scale buckets: a
# steady cycle is ~10-300 ms and the default log-spaced set has almost
# no resolution there (doc/design/metrics.md, bucket policy).
e2e_scheduling_latency = REGISTRY.register(
    Histogram("e2e_scheduling_latency_seconds", "E2E scheduling latency",
              buckets=MS_BUCKETS)
)
plugin_scheduling_latency = REGISTRY.register(
    Histogram("plugin_scheduling_latency_seconds", "Plugin latency"),
    ("plugin", "OnSession"),
)
action_scheduling_latency = REGISTRY.register(
    Histogram("action_scheduling_latency_seconds", "Action latency",
              buckets=MS_BUCKETS),
    ("action",),
)
task_scheduling_latency = REGISTRY.register(
    Histogram("task_scheduling_latency_seconds", "Task scheduling latency")
)
schedule_attempts = REGISTRY.register(
    Counter("schedule_attempts_total", "Scheduling attempts by result"),
    ("result",),
)
preemption_victims = REGISTRY.register(
    Gauge("pod_preemption_victims", "Number of selected preemption victims")
)
preemption_attempts = REGISTRY.register(
    Counter("total_preemption_attempts", "Total preemption attempts")
)
unschedule_task_count = REGISTRY.register(
    Gauge("unschedule_task_count", "Unschedulable tasks per job"), ("job_id",)
)
unschedule_job_count = REGISTRY.register(
    Gauge("unschedule_job_count", "Number of unschedulable jobs")
)
job_retry_count = REGISTRY.register(
    Counter("job_retry_counts", "Job retries"), ("job_id",)
)
pod_group_phase_count = REGISTRY.register(
    Gauge("pod_group_phase_count", "PodGroups per phase"), ("phase",)
)
solver_iterations = REGISTRY.register(
    Gauge("solver_iterations", "TPU solver rounds used in the last cycle")
)
solver_backend_cycles = REGISTRY.register(
    Counter(
        "solver_backend_cycles",
        "Cycles solved per backend (torch device vs native CPU fallback)",
    ),
    ("backend",),
)
solver_phase_latency = REGISTRY.register(
    Histogram(
        "solver_phase_latency_seconds",
        "allocate_tpu per-phase latency (tensorize/solve/apply/epilogue)",
        buckets=MS_BUCKETS,
    ),
    ("phase",),
)
# Incremental-snapshot + device-residency counters (the dirty-name
# ledger and the device cache): cache-hit regressions must show in
# Prometheus, not just bench JSON.
tensorize_cycles = REGISTRY.register(
    Counter(
        "tensorize_cycles_total",
        "Tensorize node-array refreshes by path (incremental vs "
        "full-rebuild reason)",
    ),
    ("path",),
)
tensorize_dirty_rows = REGISTRY.register(
    Counter(
        "tensorize_dirty_rows_total",
        "Node rows patched by incremental tensorize",
    )
)
tensorize_wave_patches = REGISTRY.register(
    Counter(
        "tensorize_wave_patches_total",
        "Node rows patched through the allocation-only (placement "
        "wave) path: idle + task-count columns only, driven by the "
        "narrow dirty ledger",
    )
)
scheduler_micro_cycles = REGISTRY.register(
    Counter(
        "scheduler_micro_cycles_total",
        "Event-driven micro cycles by outcome: solve (warm placement "
        "made), noop (nothing to place), deferred (warm plan could "
        "not engage; left to the periodic cycle)",
    ),
    ("outcome",),
)
solver_warm_starts = REGISTRY.register(
    Counter(
        "solver_warm_starts_total",
        "Warm-start plan outcomes per solving cycle: noop (previous "
        "verdicts reused bit-for-bit, solve skipped), solve (new work "
        "only, residual capacities), or the full-solve fallback reason "
        "(cold/stale/node-dirty/releasing/carried-changed/"
        "deserved-changed/drift/disabled; subset = rank-stable "
        "subset solve of carried+new work)",
    ),
    ("outcome",),
)
device_cache_rows_patched = REGISTRY.register(
    Counter(
        "device_cache_rows_patched_total",
        "Rows scatter-patched into resident device buffers",
    )
)
device_cache_bytes_shipped = REGISTRY.register(
    Counter(
        "device_cache_bytes_shipped_total",
        "Host->device bytes actually shipped by the snapshot pack",
    )
)
device_cache_fields = REGISTRY.register(
    Counter(
        "device_cache_fields_total",
        "Per-field pack outcomes (reuse / patch / upload)",
    ),
    ("outcome",),
)
device_cache_full_uploads = REGISTRY.register(
    Counter(
        "device_cache_full_uploads_total",
        "Full-buffer uploads by reason "
        "(cold/shape-change/bulk-dirty/small-buffer)",
    ),
    ("reason",),
)
solver_jit_compilations = REGISTRY.register(
    Gauge(
        "solver_jit_compilations",
        "Distinct compiled variants across the solver and patch jits "
        "(growth across steady cycles = a retrace regression)",
    )
)
# Candidate-sparsified solve counters (solver/topk.py + the sparse
# kernels/native loop): engagement, refill work, and dense fallbacks
# must be observable in Prometheus, not just bench JSON.
solver_sparse_solves = REGISTRY.register(
    Counter(
        "solver_sparse_solves_total",
        "Cycles solved through the top-K candidate-sparsified path",
    )
)
solver_sparse_refill_rounds = REGISTRY.register(
    Counter(
        "solver_sparse_refill_rounds_total",
        "Candidate refill rounds (slab exhaustion -> widened/compacted "
        "dense stages) across sparse solves",
    )
)
solver_sparse_dense_fallbacks = REGISTRY.register(
    Counter(
        "solver_sparse_dense_fallbacks_total",
        "Solves that fell back to the dense path by reason "
        "(class-budget/sharded-mesh/env-disabled/ladder-degraded)",
    ),
    ("reason",),
)
solver_sparse_slab_bytes = REGISTRY.register(
    Counter(
        "solver_sparse_slab_bytes_shipped_total",
        "Host->device bytes shipped for candidate-slab fields "
        "(cand_idx/cand_static/cand_info) by the snapshot pack",
    )
)
solver_sparse_sharded = REGISTRY.register(
    Counter(
        "solver_sparse_sharded_solves_total",
        "Cycles whose sparse solve ran sharded over the device mesh, "
        "by mode (flat = bit-parity task-sharded shard_map, two-level "
        "= per-rack solve + global reconciliation)",
    ),
    ("mode",),
)
solver_selection_device = REGISTRY.register(
    Counter(
        "solver_selection_device_total",
        "Selection passes whose per-class scoring and top-K extraction "
        "ran on the device-resident key matrix "
        "(solver/select_device.py; host fallbacks are labeled in "
        "tensorize stats, not here)",
    )
)
# Scheduling-loop robustness + simulator counters (the long-horizon
# harness in kube_batch_tpu/sim must be observable like everything
# else: a fault run that silently stops injecting, or an invariant
# violation eaten by a log filter, would void the whole exercise).
scheduler_cycle_errors = REGISTRY.register(
    Counter(
        "scheduler_cycle_errors_total",
        "Scheduling cycles that raised (caught by the guarded loop, "
        "retried with capped exponential backoff)",
    )
)
# Solver fault containment (kube_batch_tpu/solver/containment.py +
# actions/allocate_tpu.py ladder): every time a cycle's solve descends
# a rung (sparse -> dense -> native), why, plus the circuit breaker's
# state machine and the loop watchdog.
solver_fallback = REGISTRY.register(
    Counter(
        "solver_fallback_total",
        "Solve-ladder descents by rung pair and reason "
        "(exception/timeout/breaker-open/tensorize/rejected) — the "
        "fault-containment layer re-solving a cycle on a lower rung "
        "instead of failing it",
    ),
    ("from", "to", "reason"),
)
solver_breaker_state = REGISTRY.register(
    Gauge(
        "solver_breaker_state",
        "Device-path circuit breaker state (0=closed, 1=half-open, "
        "2=open); open pins cycles to the native floor until the "
        "canary probe re-promotes",
    )
)
solver_breaker_transitions = REGISTRY.register(
    Counter(
        "solver_breaker_transitions_total",
        "Circuit breaker state transitions by target state",
    ),
    ("to",),
)
scheduler_watchdog_trips = REGISTRY.register(
    Counter(
        "scheduler_watchdog_trips_total",
        "Loop-watchdog detections of a cycle exceeding its no-progress "
        "budget (flight recorder dumped, leadership fenced)",
    )
)
task_resync_terminal = REGISTRY.register(
    Counter(
        "task_resync_terminal_total",
        "Poisoned tasks dropped from the resync queue after exhausting "
        "the max reconcile attempts (named in the job's unschedulable "
        "verdict detail)",
    )
)
cache_binds_fenced = REGISTRY.register(
    Counter(
        "cache_binds_fenced_total",
        "Bind/evict side effects refused by the leadership fencing "
        "check (a deposed or watchdog-fenced leader must not mutate "
        "the cluster)",
    )
)
# Crash-tolerant failover (doc/design/robustness.md, failover section):
# the bind-intent journal's lifecycle and the successor recovery pass's
# per-task reconciliation outcomes.
bind_journal_intents = REGISTRY.register(
    Counter(
        "bind_journal_intents_total",
        "Bind-intent journal events: appended (one per dispatched "
        "batch), applied/failed (one per task as its side effect "
        "drains), resolved (records fully marked and self-pruned)",
    ),
    ("event",),
)
# Cluster-truth anti-entropy (doc/design/robustness.md, event-stream
# hardening): watch-ingest guard absorptions, gap-repair relists, the
# divergence sweep's detections/repairs, and post-solve placement
# validation rejections.
cache_event_anomalies = REGISTRY.register(
    Counter(
        "cache_event_anomalies_total",
        "Watch-event anomalies absorbed by the cache ingest guards: "
        "duplicate (same resourceVersion redelivered), stale (older "
        "than the applied version), reorder (out-of-order arrival that "
        "filled a stream hole), gap (a hole confirmed as a DROPPED "
        "event — queues a rate-limited relist)",
    ),
    ("kind",),
)
cache_relists = REGISTRY.register(
    Counter(
        "cache_relists_total",
        "Watch-gap repair relists (bounded, rate-limited full "
        "reconciles through the anti-entropy engine) by outcome",
    ),
    ("outcome",),
)
cache_divergence_detected = REGISTRY.register(
    Counter(
        "cache_divergence_detected_total",
        "Mirror-vs-cluster-truth divergences found by the anti-entropy "
        "sweep, by kind (phantom-task/missed-pod/missed-bind/"
        "stale-task/vanished-node/missed-node/stale-node)",
    ),
    ("kind",),
)
cache_divergence_repaired = REGISTRY.register(
    Counter(
        "cache_divergence_repaired_total",
        "Divergences repaired through the dirty-ledger-stamping event "
        "handlers, by kind — detected minus repaired is the deferred "
        "backlog the next sweep retries",
    ),
    ("kind",),
)
solver_output_rejected = REGISTRY.register(
    Counter(
        "solver_output_rejected_total",
        "Solver placements rejected by post-solve validation before "
        "bind dispatch, by reason (bad-index/infeasible/capacity) — a "
        "device rung whose output fails validation re-solves one rung "
        "down; the native floor drops the offending placements",
    ),
    ("reason",),
)
scheduler_failover_recoveries = REGISTRY.register(
    Counter(
        "scheduler_failover_recoveries_total",
        "Successor-recovery task reconciliations by outcome: applied "
        "(bind landed; confirmed or mark back-filled), failed (the "
        "dead leader already reverted it), redriven (lost bind "
        "re-issued to its journaled node to complete a partial gang), "
        "requeued (lost bind left to normal scheduling), evicted "
        "(partial gang below minMember torn down — all-or-nothing "
        "restored), superseded (another leader placed it elsewhere), "
        "vanished (pod gone)",
    ),
    ("outcome",),
)
sim_cycles = REGISTRY.register(
    Counter("sim_cycles_total", "Simulated scheduling cycles driven")
)
sim_faults_injected = REGISTRY.register(
    Counter(
        "sim_faults_injected_total",
        "Simulator faults injected by kind "
        "(bind/node-flap/node-death/evict/solver/crash)",
    ),
    ("kind",),
)
sim_invariant_violations = REGISTRY.register(
    Counter(
        "sim_invariant_violations_total",
        "Invariant-checker violations by invariant "
        "(oversubscribe/gang/conservation/queue-share)",
    ),
    ("invariant",),
)
# Explainability (kube_batch_tpu/obs/explain.py): unassigned pending
# tasks bucketed by the solver's last-cycle verdict, so a dashboard
# can split "pending because predicates" from "pending because gang
# threshold" without scraping /debug/jobs.
unschedulable_tasks = REGISTRY.register(
    Gauge(
        "unschedulable_tasks",
        "Unassigned pending tasks by last-cycle verdict reason "
        "(predicate-blocked/queue-overused/refill-exhausted/"
        "gang-minmember/no-fit)",
    ),
    ("reason",),
)
# Placement-latency SLI (kube_batch_tpu/obs/latency.py): per-pod
# arrival→bind latency, stage-decomposed, observed at the bind-applied
# seam. MS_BUCKETS resolution for the fast stages (the micro-path
# budget is quoted in milliseconds) PLUS a multi-minute tail: the
# queue_wait/total/gang_total stages routinely exceed 10 s under
# saturation (the soak drift bound is 120 s), and a histogram whose
# top bucket is 10 s would pin every saturated-quantile at +Inf.
LATENCY_BUCKETS = MS_BUCKETS + [30.0, 60.0, 120.0, 300.0]
pod_placement_latency = REGISTRY.register(
    Histogram(
        "pod_placement_latency_seconds",
        "Per-pod placement latency by stage (queue_wait/solve/dispatch/"
        "bind/total, plus gang_total = a gang's last-member "
        "bind-applied), queue, and the placing cycle kind "
        "(periodic/micro)",
        buckets=LATENCY_BUCKETS,
    ),
    ("stage", "queue", "cycle_kind"),
)
# Long-horizon telemetry watermarks (kube_batch_tpu/obs/telemetry.py):
# the Prometheus face of the per-cycle watermark probes the soak-mode
# leak detectors fit trends on. Gauges, updated once per cycle.
process_rss_bytes = REGISTRY.register(
    Gauge("process_rss_bytes", "Scheduler process resident set size")
)
cuda_memory_allocated_bytes = REGISTRY.register(
    Gauge(
        "cuda_memory_allocated_bytes",
        "CUDA memory held by live tensors (torch.cuda.memory_allocated; "
        "0 until CUDA is initialised)",
    )
)
metrics_label_series = REGISTRY.register(
    Gauge(
        "metrics_label_series",
        "Label sets held across this registry — unbounded growth here "
        "is a label-cardinality leak (per-job series must be GC'd on "
        "job deletion)",
    )
)
telemetry_windows_rolled = REGISTRY.register(
    Gauge(
        "telemetry_windows_rolled",
        "Telemetry rollup windows closed since start",
    )
)
telemetry_ring_occupancy = REGISTRY.register(
    Gauge(
        "telemetry_ring_occupancy",
        "Per-cycle samples currently held in the telemetry raw ring",
    )
)
queue_fairness_drift = REGISTRY.register(
    Gauge(
        "queue_fairness_drift",
        "Per-queue (allocated - deserved) on the dominant dimension as "
        "a fraction of cluster capacity; sustained positive drift "
        "means a queue is being over-served",
    ),
    ("queue",),
)
# Serving SLO accounting (kube_batch_tpu/obs/latency.py serving
# extension, doc/design/serving.md): placement-latency SLO verdicts
# per workload class, observed at the bind-applied seam.
pod_slo_placements = REGISTRY.register(
    Counter(
        "pod_slo_placements_total",
        "Placements of pods carrying a placement-latency SLO target, "
        "by workload class and verdict (met = total latency within "
        "the per-job target at bind-applied)",
    ),
    ("workload_class", "outcome"),
)
serving_slo_attainment = REGISTRY.register(
    Gauge(
        "serving_slo_attainment",
        "Fraction of serving-class targeted placements that met their "
        "placement-latency SLO (cumulative; 1.0 until the first "
        "targeted placement)",
    )
)
serving_slo_budget_burn = REGISTRY.register(
    Gauge(
        "serving_slo_budget_burn",
        "Serving violation-budget burn: SLO misses divided by the "
        "misses allowed at KBT_SERVING_ATTAINMENT_TARGET (>1 = the "
        "attainment budget is blown)",
    )
)
# Placement-quality scorecard (kube_batch_tpu/obs/quality.py,
# doc/design/quality.md): the Prometheus face of the per-card quality
# signals. Gauges updated once per KBT_QUALITY_EVERY cycles; the churn
# counters tick at the cache's evict/bind seams.
quality_packing_density = REGISTRY.register(
    Gauge(
        "quality_packing_density",
        "Cluster-aggregate used/allocatable per resource dimension "
        "(the packing-density headline of the quality scorecard)",
    ),
    ("resource",),
)
quality_fairness_jain = REGISTRY.register(
    Gauge(
        "quality_fairness_jain",
        "Jain fairness index over per-queue satisfaction ratios "
        "(allocated vs water-filled deserved; 1.0 = perfectly "
        "proportional)",
    )
)
quality_emptiable_nodes = REGISTRY.register(
    Gauge(
        "quality_emptiable_nodes",
        "Nodes that are empty or could be drained into the remaining "
        "idle headroom (fragmentation/consolidation watermark)",
    )
)
quality_largest_placeable_gang = REGISTRY.register(
    Gauge(
        "quality_largest_placeable_gang",
        "Per queue: members of its largest pending gang the current "
        "idle vectors could hold (series GC'd when the queue has no "
        "pending gang)",
    ),
    ("queue",),
)
quality_churn_per_placement = REGISTRY.register(
    Gauge(
        "quality_churn_per_placement",
        "Disruption churn: (evictions + re-binds) per placement over "
        "the last scorecard interval",
    )
)
quality_evictions = REGISTRY.register(
    Counter(
        "quality_evictions_total",
        "Task evictions observed by the quality monitor, by reason "
        "(preempt/reclaim/node-death/...)",
    ),
    ("reason",),
)
quality_rebinds = REGISTRY.register(
    Counter(
        "quality_rebinds_total",
        "Re-binds: binds of tasks previously evicted (the disruption "
        "half of preemption churn actually paid back)",
    )
)


# Update helpers (reference metrics.go:122-170).

def update_e2e_duration(seconds: float) -> None:
    e2e_scheduling_latency.observe(seconds)


def update_plugin_duration(plugin: str, on_session: str, seconds: float) -> None:
    plugin_scheduling_latency.observe(seconds, (plugin, on_session))


def update_action_duration(action: str, seconds: float) -> None:
    action_scheduling_latency.observe(seconds, (action,))


def update_task_schedule_duration(seconds: float) -> None:
    task_scheduling_latency.observe(seconds)


def update_task_schedule_durations(seconds_list) -> None:
    """Batched form for the 50k-task apply path."""
    task_scheduling_latency.observe_many(seconds_list)


def update_pod_group_phase(phase: str, count: int) -> None:
    pod_group_phase_count.set(count, (phase,))


def update_preemption_victims(count: int) -> None:
    preemption_victims.set(count)


def register_preemption_attempts() -> None:
    preemption_attempts.inc()


def update_unschedulable_task_count(job_id: str, count: int) -> None:
    unschedule_task_count.set(count, (job_id,))


def update_unschedulable_job_count(count: int) -> None:
    unschedule_job_count.set(count)


def register_job_retries(job_id: str) -> None:
    job_retry_count.inc((job_id,))


def forget_job(job_id: str) -> None:
    """Label-set GC for a deleted job: drop its per-job series from
    the gauges/counters keyed on ``job_id``. Without this, every job
    that ever went unschedulable leaves an immortal series behind —
    an unbounded-cardinality leak over a production-length run (the
    soak detector watches ``metrics_label_series`` for exactly this).
    Called from the cache's job-cleanup path."""
    if not job_id:
        return
    unschedule_task_count.remove((job_id,))
    job_retry_count.remove((job_id,))


def update_solver_cycle(rounds: int, backend: str) -> None:
    """Record one allocate_tpu cycle: rounds used and which backend
    solved it ("torch-cuda", "torch-cpu" or "native")."""
    solver_iterations.set(rounds)
    solver_backend_cycles.inc((backend,))


def update_solver_phase(phase: str, seconds: float) -> None:
    """Per-phase allocate_tpu latency (the cycle budget split the
    reference has no analog for: host tensorize vs device solve vs host
    apply)."""
    solver_phase_latency.observe(seconds, (phase,))


def update_tensorize_cycle(
    incremental: bool, dirty_rows: int, full_reason=None,
    wave_patched: int = 0,
) -> None:
    """Record one tensorize node-array refresh: which path ran and how
    many rows it actually touched."""
    path = "incremental" if incremental else f"full-{full_reason}"
    tensorize_cycles.inc((path,))
    # Only rows actually patched count; a full rebuild reports N "dirty"
    # rows but ships through the rebuild path, not the patch path.
    if incremental and dirty_rows:
        tensorize_dirty_rows.inc(amount=float(dirty_rows))
    if incremental and wave_patched:
        tensorize_wave_patches.inc(amount=float(wave_patched))


def register_warm_start(outcome: str) -> None:
    solver_warm_starts.inc((outcome,))


def register_micro_cycle(outcome: str) -> None:
    scheduler_micro_cycles.inc((outcome,))


def register_device_selection() -> None:
    """One selection pass ran on the device-resident key matrix."""
    solver_selection_device.inc()


def update_device_cache(stats: dict) -> None:
    """Fold one device-cache pack into the counters (``stats`` is
    device_cache.last_pack_stats' schema)."""
    if stats.get("rows_patched"):
        device_cache_rows_patched.inc(amount=float(stats["rows_patched"]))
    if stats.get("bytes_shipped"):
        device_cache_bytes_shipped.inc(
            amount=float(stats["bytes_shipped"])
        )
    for key, outcome in (
        ("reuses", "reuse"), ("patches", "patch"), ("uploads", "upload")
    ):
        if stats.get(key):
            device_cache_fields.inc((outcome,), amount=float(stats[key]))
    for reason in stats.get("full_reasons", {}).values():
        device_cache_full_uploads.inc((reason,))
    if stats.get("slab_bytes_shipped"):
        solver_sparse_slab_bytes.inc(
            amount=float(stats["slab_bytes_shipped"])
        )


# Dense-fallback reasons that represent a genuine fallback (the sparse
# path was wanted but could not run), as opposed to the size policy
# simply preferring dense on a small problem.
_SPARSE_FALLBACK_REASONS = frozenset(
    ("class-budget", "sharded-mesh", "env-disabled", "ladder-degraded")
)


def update_solver_sparse(
    engaged: bool, refill_rounds: int, fallback_reason=None
) -> None:
    """Record one allocate_tpu solve's sparse-path outcome."""
    if engaged:
        solver_sparse_solves.inc()
        if refill_rounds:
            solver_sparse_refill_rounds.inc(amount=float(refill_rounds))
    elif fallback_reason in _SPARSE_FALLBACK_REASONS:
        solver_sparse_dense_fallbacks.inc((fallback_reason,))


def register_sparse_sharded(mode: str) -> None:
    """One cycle's sparse solve ran sharded over the mesh (mode =
    flat | two-level, solver/sharding.sparse_shard_mode)."""
    solver_sparse_sharded.inc((mode or "unknown",))


def update_solver_jit_cache(count: int) -> None:
    """Gauge of compiled solver/patch variants (retrace forensics)."""
    solver_jit_compilations.set(float(count))


def register_cycle_error() -> None:
    """One scheduling cycle raised and was absorbed by the guarded loop."""
    scheduler_cycle_errors.inc()


def register_solver_fallback(frm: str, to: str, reason: str) -> None:
    """One solve-ladder descent: the ``frm`` rung failed (``reason`` in
    exception/timeout/breaker-open) and the cycle re-solved on ``to``."""
    solver_fallback.inc((frm, to, reason))


_BREAKER_STATE_VALUES = {"closed": 0.0, "half-open": 1.0, "open": 2.0}


def update_breaker_state(state: str, transition: bool = True) -> None:
    solver_breaker_state.set(_BREAKER_STATE_VALUES.get(state, -1.0))
    if transition:
        solver_breaker_transitions.inc((state,))


def register_watchdog_trip() -> None:
    scheduler_watchdog_trips.inc()


def register_resync_terminal() -> None:
    task_resync_terminal.inc()


def register_bind_fenced() -> None:
    cache_binds_fenced.inc()


def observe_placement_latency(
    stage: str, queue: str, cycle_kind: str, seconds: float
) -> None:
    """One pod's stage latency sample, observed by the placement
    ledger at bind-applied (obs/latency.py)."""
    pod_placement_latency.observe(seconds, (stage, queue, cycle_kind))


def update_unschedulable_reasons(counts: dict) -> None:
    """Per-cycle unschedulable-task counts by verdict reason. Absent
    reasons are zeroed so the gauge never carries a stale bucket."""
    from ..obs.explain import ALL_REASONS

    for reason in ALL_REASONS:
        unschedulable_tasks.set(float(counts.get(reason, 0)), (reason,))
    for reason in counts:
        if reason not in ALL_REASONS:  # defensive: unknown classifier
            unschedulable_tasks.set(float(counts[reason]), (reason,))


def update_telemetry_watermarks(
    values: dict, raw_occupancy: int = 0, windows_rolled: int = 0,
    fairness_ran: bool = False,
) -> None:
    """Push one telemetry cycle's watermark probes to the gauges
    (obs/telemetry.py feeds this once per scheduling cycle)."""
    rss = values.get("rss_bytes")
    if rss is not None:
        process_rss_bytes.set(float(rss))
    cuda_memory_allocated_bytes.set(
        float(values.get("cuda_memory_allocated_bytes", 0.0))
    )
    series = values.get("metrics_series")
    if series is not None:
        metrics_label_series.set(float(series))
    telemetry_windows_rolled.set(float(windows_rolled))
    telemetry_ring_occupancy.set(float(raw_occupancy))
    fairness = {
        key.split(":", 1)[1]: float(v)
        for key, v in values.items()
        if key.startswith("fairness_drift:")
    }
    if fairness_ran:
        # The amortized probe reports every live queue at once, so a
        # gauge series outside the incoming set belongs to a deleted
        # queue — drop it (same label-GC contract as forget_job: a
        # stale {queue=...} series is exactly the cardinality-leak
        # shape the soak detector fits growth on). Gated on the probe
        # having RUN, not on a non-empty result: an empty dict (fewer
        # than two live queues) means every existing series is stale.
        for labels in queue_fairness_drift.label_sets():
            if labels and labels[0] not in fairness:
                queue_fairness_drift.remove(labels)
        for queue, v in fairness.items():
            queue_fairness_drift.set(v, (queue,))


def register_journal_event(event: str) -> None:
    """One bind-intent journal lifecycle event (cache/cache.py)."""
    bind_journal_intents.inc((event,))


def register_event_anomaly(kind: str, n: int = 1) -> None:
    """``n`` absorbed watch-event anomalies of ``kind`` (cache ingest
    guards, cache/cache.py _admit_event)."""
    if n:
        cache_event_anomalies.inc((kind,), amount=float(n))


def register_relist(outcome: str) -> None:
    """One watch-gap repair relist attempt (cache/cache.py)."""
    cache_relists.inc((outcome,))


def register_divergence(event: str, kind: str, n: int = 1) -> None:
    """``n`` anti-entropy divergences of ``kind``; ``event`` is
    detected|repaired (cache/antientropy.py)."""
    if not n:
        return
    if event == "detected":
        cache_divergence_detected.inc((kind,), amount=float(n))
    else:
        cache_divergence_repaired.inc((kind,), amount=float(n))


def register_solver_output_rejected(reason: str, n: int = 1) -> None:
    """``n`` solver placements rejected by post-solve validation
    (solver/validate.py via the allocate_tpu ladder)."""
    if n:
        solver_output_rejected.inc((reason,), amount=float(n))


def register_failover_recovery(outcome: str, count: int = 1) -> None:
    """``count`` task reconciliations with ``outcome`` from one
    successor recovery pass (cache/recovery.py)."""
    if count:
        scheduler_failover_recoveries.inc((outcome,), amount=float(count))


def register_quality_eviction(reason: str) -> None:
    """One eviction seen by the quality monitor (obs/quality.py)."""
    quality_evictions.inc((reason,))


def register_quality_rebinds(n: int) -> None:
    """``n`` binds of previously-evicted tasks (obs/quality.py)."""
    if n:
        quality_rebinds.inc(amount=float(n))


def update_quality(card: dict) -> None:
    """Push one quality scorecard to the gauges (obs/quality.py feeds
    this every KBT_QUALITY_EVERY cycles)."""
    for dim, v in card.get("density", {}).items():
        quality_packing_density.set(float(v), (dim,))
    fairness = card.get("fairness", {})
    quality_fairness_jain.set(float(fairness.get("jain", 1.0)))
    frag = card.get("frag", {})
    quality_emptiable_nodes.set(float(frag.get("emptiable_nodes", 0)))
    quality_churn_per_placement.set(
        float(card.get("churn", {}).get("per_placement", 0.0))
    )
    # Every card reports every queue with a pending gang at once, so a
    # gauge series outside the incoming set is stale — drop it (same
    # label-GC contract as queue_fairness_drift).
    gangs = frag.get("largest_gang", {})
    for labels in quality_largest_placeable_gang.label_sets():
        if labels and labels[0] not in gangs:
            quality_largest_placeable_gang.remove(labels)
    for queue, v in gangs.items():
        quality_largest_placeable_gang.set(float(v), (queue,))


def register_sim_cycle() -> None:
    sim_cycles.inc()


def register_sim_fault(kind: str) -> None:
    sim_faults_injected.inc((kind,))


def register_sim_violation(invariant: str) -> None:
    sim_invariant_violations.inc((invariant,))
