"""ClusterSimulator: the event loop that drives the real scheduler.

One simulated cycle:

1. apply this cycle's EVENTS (workload arrivals/completions/churn —
   from the seeded generator, or verbatim from a replayed trace);
2. apply + arm this cycle's FAULTS (planned from the seeded fault
   stream, or from the trace);
3. run ONE real scheduling cycle (``Scheduler.run_once_guarded`` — the
   production ``run_once``, crash faults included);
4. BARRIER: wait out every async bind/evict side effect, then drain the
   cache's resync and cleanup queues deterministically — virtual time
   only advances when the world has settled, which is what makes the
   run replayable;
5. post-cycle cleanup (pods orphaned by a mid-cycle node death), gang
   degradation bookkeeping, invariant check, trace record.

The scheduler, cache, plugins, and actions are the production objects —
the simulator only owns the clock, the churn, and the assertions.

A copy of the JAX package's ``sim/harness.py``. What differs:

- ``SimConfig.device`` (default ``cuda``; ``cpu`` on request): every
  scheduler instance the run builds, failover successors included,
  solves there, and so does the breaker's canary. Without CUDA a
  ``cuda`` run raises at construction.
- The backends: ``dense`` is ``KBT_SOLVER_TOPK=off`` and ``sparse``
  ``KBT_SOLVER_TOPK=K``, both on the run's device (the reference's
  ``KBT_SOLVER=jax`` has no counterpart); ``native`` pins the floor.
- The solve runs the shared ``allocate_tpu`` action's chain: the bid
  kernels by default (the reference's ``KBT_PALLAS=1`` path on a TPU).
  With ``use_kernel=False`` set on that action, the plain six-commit
  chain runs, which is the JAX package's default chain, and the run
  equals the JAX package's on the CPU record for record.
- Before the first scheduler is built, the run builds the bid library
  and solves one small dense and one small sparse bundle on its device,
  so no first use of a kernel lands inside the small wall-clock solve
  budget a device-fault run stamps.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import metrics
from ..api import PodPhase, build_resource_list
from ..cache import SchedulerCache
from ..cluster import InProcessCluster
from ..device import resolve_device
from ..obs import RECORDER
from ..obs.quality import (
    QUALITY,
    compute_scorecard,
    replay_view,
    telemetry_values,
)
from ..obs.tracer import TRACER
from ..scheduler import Scheduler
from ..utils.test_utils import build_node, build_pod, build_pod_group, build_queue
from .clock import VirtualClock
from .failover import CUT_POINTS, SimClusterEndpoint
from .faults import FaultInjector, parse_fault_spec
from .invariants import InvariantChecker
from .trace import TRACE_VERSION, TraceReader, TraceWriter, canon
from .workload import WorkloadGenerator, WorkloadSpec

logger = logging.getLogger(__name__)

SIM_NAMESPACE = "sim"

SIM_DEFAULT_CONF = """
actions: "allocate_tpu, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
  - name: serving
"""

# Backend name -> env overrides (None = unset). "auto" leaves the
# process environment alone. Dense and sparse solve on the run's device
# (an unset KBT_SOLVER); only "native" pins the floor.
_BACKEND_ENV = {
    "dense": {"KBT_SOLVER": None, "KBT_SOLVER_TOPK": "off"},
    "sparse": {"KBT_SOLVER": None},
    "native": {"KBT_SOLVER": "native", "KBT_SOLVER_TOPK": None},
}


@dataclass
class SimConfig:
    cycles: int = 200
    seed: int = 0
    faults: str = ""
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    conf: str = SIM_DEFAULT_CONF
    backend: str = "auto"           # auto | dense | sparse | native
    topk: Optional[int] = None      # sparse K override (KBT_SOLVER_TOPK)
    period: float = 1.0             # virtual seconds per cycle
    trace_path: Optional[str] = None
    replay: Optional[TraceReader] = None
    # Replay only the first N recorded cycles (soak replay-bisect:
    # reproduce the state just past a detector's suspect window).
    replay_limit: Optional[int] = None
    check_invariants: bool = True
    recreate_killed: bool = True    # controller analog for killed pods
    # Chrome trace-event export of the whole run (--trace-out): spans
    # carry the virtual clock's timestamp in their args.
    trace_out: Optional[str] = None
    # Soak mode (--soak): telemetry records every cycle (window size
    # scaled so the whole horizon fits the window ring), and the
    # leak/drift detectors (sim/soak.py) run over the rolled windows
    # at the end; their verdict lands in report.soak and the telemetry
    # windows are dumped next to the trace (or to telemetry_out).
    soak: bool = False
    telemetry_out: Optional[str] = None
    # Event-driven micro-cycle mode (--micro-every N, N >= 2): only
    # every Nth sim cycle runs the full periodic scheduling cycle; the
    # cycles in between run Scheduler.run_micro — the bounded warm-path
    # fast cycle — against that cycle's arrivals. The invariant checker
    # still runs EVERY cycle, so the micro path carries the same
    # correctness obligations as the periodic one. 0 disables.
    micro_every: int = 0
    # Failover kill drill (--kill-at): cycle -> cut point; the leader
    # is hard-stopped at that cut (sim/failover.py) and a successor
    # instance takes the lease and recovers. Probabilistic kills ride
    # the fault spec as leader-kill:p instead.
    kill_plan: Dict[int, str] = field(default_factory=dict)
    # Virtual-time lease TTL for the drill's takeover wait.
    lease_duration: float = 15.0
    # Decision-audit dump (--audit-out): the placement ledger's audit
    # stream as canonical JSONL — virtual-clock-stamped, so a replay's
    # dump is byte-identical to the recording's (make latency-smoke
    # pins this). Defaults to <trace>.audit.jsonl when a trace is
    # recorded.
    audit_out: Optional[str] = None
    # Per-cycle placement-quality scorecard stream (--quality-out):
    # canonical JSONL, one card per cycle — byte-identical under a
    # same-config --replay (the in-trace comparison additionally
    # strips the path-dependent solver deltas; obs/quality.py).
    quality_out: Optional[str] = None
    # Anti-entropy sweep cadence override for the run (None = the
    # process default, KBT_ANTIENTROPY_EVERY): event-fault storms run
    # at 1 so every cycle's divergence is swept before its invariant
    # check. Recorded in the trace header — the sweep repairs mutate
    # scheduling state, so replay must run the same cadence.
    antientropy_every: Optional[int] = None
    # Where allocate_tpu solves: "cuda" (raises without CUDA) or "cpu".
    # Not recorded in the trace: a trace replays on either device.
    device: str = "cuda"


@dataclass
class SimReport:
    cycles: int = 0
    placements: int = 0
    violations: List[dict] = field(default_factory=list)
    fault_counts: Dict[str, int] = field(default_factory=dict)
    bind_failures: int = 0
    cycle_errors: int = 0
    replay_mismatches: List[int] = field(default_factory=list)
    jobs_created: int = 0
    jobs_completed: int = 0
    wall_seconds: float = 0.0
    check_seconds: float = 0.0
    # Flight-recorder dump files written alongside the JSONL trace
    # (one per invariant-violation/cycle-error event) and the exported
    # Chrome trace path, when armed.
    flight_dumps: List[str] = field(default_factory=list)
    trace_out: Optional[str] = None
    # Soak-mode verdict (sim/soak.py): detector results, tripped series,
    # the telemetry dump path, and replay-bisect hints.
    soak: Optional[dict] = None
    # End-of-run circuit-breaker snapshot (solver/containment.py): a
    # chaos run asserts re-promotion (state == closed once the injected
    # fault windows end) straight off the report.
    breaker: Optional[dict] = None
    # Failover drill bookkeeping: one entry per leader kill (cut,
    # cycle, takeover wait, recovery outcome summary).
    leader_kills: int = 0
    failovers: List[dict] = field(default_factory=list)
    recovery_failures: int = 0
    # Placement-latency ledger engagement summary (obs/latency.py) and
    # the decision-audit dump written alongside the trace.
    latency: Optional[dict] = None
    audit_records: int = 0
    audit_path: Optional[str] = None
    # Cluster-truth integrity summary (event-stream hardening +
    # anti-entropy): absorbed anomalies, relists, divergence
    # detected/repaired, post-solve validation rejections, and the
    # end-of-run cleanliness verdict (unrepaired_end must be 0 for the
    # DIVERGE acceptance artifact; --require-divergence-repaired).
    integrity: Optional[dict] = None
    # Placement-quality scorecard: replay-compared card mismatches
    # (exit 2, same class as placement divergence) and the end-of-run
    # summary the A/B study driver (sim/study.py) pairs across seeds.
    quality_mismatches: List[int] = field(default_factory=list)
    quality: Optional[dict] = None

    @property
    def cycles_per_sec(self) -> float:
        return self.cycles / self.wall_seconds if self.wall_seconds else 0.0

    def to_dict(self) -> dict:
        return {
            "cycles": self.cycles,
            "placements": self.placements,
            "violations": self.violations,
            "fault_counts": {
                k: v for k, v in sorted(self.fault_counts.items()) if v
            },
            "bind_failures": self.bind_failures,
            "cycle_errors": self.cycle_errors,
            "replay_mismatches": self.replay_mismatches,
            "jobs_created": self.jobs_created,
            "jobs_completed": self.jobs_completed,
            "wall_seconds": round(self.wall_seconds, 3),
            "cycles_per_sec": round(self.cycles_per_sec, 1),
            "invariant_check_seconds": round(self.check_seconds, 3),
            "flight_dumps": list(self.flight_dumps),
            "trace_out": self.trace_out,
            **({"soak": self.soak} if self.soak is not None else {}),
            **({"breaker": self.breaker} if self.breaker is not None
               else {}),
            **({
                "leader_kills": self.leader_kills,
                "failovers": list(self.failovers),
                "recovery_failures": self.recovery_failures,
            } if self.leader_kills else {}),
            **({
                "latency": self.latency,
                "audit_records": self.audit_records,
                "audit_path": self.audit_path,
            } if self.latency is not None else {}),
            **({"integrity": self.integrity}
               if self.integrity is not None else {}),
            **({"quality": self.quality}
               if self.quality is not None else {}),
            **({"quality_mismatches": list(self.quality_mismatches)}
               if self.quality_mismatches else {}),
        }


def _prewarm_solves(device) -> None:
    """Build the bid library (on a card) and solve one small dense and
    one small sparse bundle on ``device`` with the kernels, each ended
    by the device->host read of its assignment."""
    import torch

    from ..solver.kernels import make_inputs, solve_auto

    if device.type == "cuda":
        from ..solver._build import load_library

        load_library()
    T, N, K = 8, 4, 2

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=device)

    dense = make_inputs(
        task_req=t([[1.0, 1.0]] * T),
        task_fit=t([[1.0, 1.0]] * T),
        task_rank=t(list(range(T)), torch.int32),
        task_job=t(list(range(T)), torch.int32),
        task_queue=t([0] * T, torch.int32),
        node_idle=t([[4.0, 4.0]] * N),
        node_releasing=t([[0.0, 0.0]] * N),
        node_cap=t([[4.0, 4.0]] * N),
        node_task_count=t([0] * N, torch.int32),
        node_max_tasks=t([0] * N, torch.int32),
        queue_deserved=t([[float("inf"), float("inf")]]),
        queue_allocated=t([[0.0, 0.0]]),
        eps=t([1e-3, 1e-3]),
        lr_weight=t(1.0),
        br_weight=t(0.0),
    )
    sparse = dense._replace(
        task_cand=t([0] * T, torch.int32),
        cand_idx=t([list(range(K))], torch.int32),
        cand_static=t([[0.0] * K]),
        cand_info=t([[N], [0], [0]], torch.int32),
    )
    for inputs in (dense, sparse):
        solve_auto(inputs, max_rounds=8, use_kernel=True).assigned.cpu()


class _RecordingBinder:
    """Outermost binder layer: records successful binds (the cycle's
    placements). Appends AFTER the inner bind returns, so injected
    failures never show up as placements."""

    def __init__(self, inner):
        self.inner = inner
        self.records: List[Tuple[str, str]] = []

    def bind(self, pod, hostname: str) -> None:
        self.inner.bind(pod, hostname)
        self.records.append((f"{pod.namespace}/{pod.name}", hostname))

    def drain(self) -> List[List[str]]:
        out = sorted(self.records)
        self.records = []
        return [list(p) for p in out]


class ClusterSimulator:
    def __init__(self, cfg: SimConfig):
        if cfg.replay is not None:
            # The recorded run's identity lives in its header: the bind
            # fault seam re-decides per-attempt failures from
            # (seed, fault spec), so replaying under CLI defaults would
            # silently inject a DIFFERENT fault pattern and report it as
            # scheduler divergence.
            header = cfg.replay.header
            cfg.seed = header.get("seed", cfg.seed)
            cfg.faults = header.get("faults", cfg.faults)
            cfg.period = header.get("period", cfg.period)
            # The cycle-kind schedule (periodic vs micro) is part of
            # the recorded run's semantics; so is the drill's lease TTL
            # (it decides the recorded takeover wait).
            cfg.micro_every = header.get("micro_every", cfg.micro_every)
            cfg.lease_duration = header.get(
                "lease_duration", cfg.lease_duration
            )
            cfg.antientropy_every = header.get(
                "antientropy_every", cfg.antientropy_every
            )
            cfg.cycles = len(cfg.replay.cycles)
            if cfg.replay_limit is not None:
                cfg.cycles = min(cfg.cycles, max(1, cfg.replay_limit))
        self.cfg = cfg
        self.clock = VirtualClock()
        # Validate BEFORE mutating process state: a bad fault spec (or a
        # cuda run without CUDA, below) must not leak env overrides or a
        # live cache thread pool.
        fault_spec = parse_fault_spec(cfg.faults)
        # Device-fault kinds fire inside the device-solve
        # materialization and the canary probe; the native backend
        # never dispatches either, so such a run would count injected
        # faults while exercising nothing — reject it like an unknown
        # kind rather than green-lighting a vacuous chaos run.
        device_kinds = [
            k for k in (
                "solver-exc", "solver-hang", "backend-loss",
                "solver-corrupt",
            )
            if fault_spec.get(k)
        ]
        if cfg.backend == "native" and device_kinds:
            raise ValueError(
                f"fault kinds {device_kinds} require a device backend "
                "(dense/sparse); --backend native never runs a device "
                "solve, so they would inject nothing"
            )
        self.device = resolve_device(cfg.device)
        self._env_backup: Dict[str, Optional[str]] = {}
        self._apply_backend_env(cfg.backend, cfg.topk)
        if cfg.antientropy_every is not None:
            # Same backup/restore discipline as the backend env: the
            # sweep cadence is part of the run's recorded semantics.
            self._env_backup.setdefault(
                "KBT_ANTIENTROPY_EVERY",
                os.environ.get("KBT_ANTIENTROPY_EVERY"),
            )
            os.environ["KBT_ANTIENTROPY_EVERY"] = str(
                cfg.antientropy_every
            )
        # Fault-containment state is process-global; a run must start
        # from a closed breaker and must not inherit (or leak) a device
        # fault hook — breaker state bleeding from a recording run into
        # its replay would silently desynchronize them.
        from ..solver import containment as _containment

        self._containment = _containment
        _containment.reset_breaker()
        # Placement-latency ledger + decision audit are process-global
        # (like the breaker): a run must start them empty, or a second
        # sim in the same process inherits the first's entries and its
        # replay can never be byte-identical. The scheduler built in
        # _build_instance installs the virtual clock.
        from ..obs.latency import AUDIT, LEDGER

        LEDGER.reset()
        AUDIT.reset()
        # The quality monitor's churn counters are process-global too
        # (fed by the cache's evict/bind seams); a run starts them from
        # zero, and reset() re-reads the KBT_QUALITY* env the run may
        # have been launched under.
        QUALITY.reset()
        self._quality_enabled = QUALITY.enabled
        # Failover drill state: device-kind memo (successor instances
        # must re-stamp the 0.5 s solve budget their Scheduler
        # construction resets) and the kill switchboard.
        self._device_kinds = device_kinds
        for cut in sorted(set(cfg.kill_plan.values())):
            if cut not in CUT_POINTS:
                raise ValueError(
                    f"unknown leader-kill cut {cut!r} "
                    f"(known: {', '.join(CUT_POINTS)})"
                )
        self._failover_enabled = (
            bool(fault_spec.get("leader-kill")) or bool(cfg.kill_plan)
        )
        if cfg.replay is not None and not self._failover_enabled:
            # Replay re-applies kills from the RECORDED fault events,
            # so lease bookkeeping (whose takeover wait is part of the
            # compared failover block) must arm off the trace, not the
            # (empty) CLI spec.
            self._failover_enabled = any(
                f.get("kind") == "leader-kill"
                for rec in cfg.replay.cycles
                for f in rec.get("faults", [])
            )
        self.instance_id = 0
        try:
            if cfg.backend != "native":
                # First use of the bid library and the solve's torch
                # kernels, outside every solve budget and before the
                # quality state swallows the solver counters.
                _prewarm_solves(self.device)
            self.cluster = InProcessCluster(simulate_kubelet=True)
            self.injector = FaultInjector(fault_spec, cfg.seed)
            self.injector.attach_cluster(self.cluster)
            # The active scheduler instance (endpoint/cache/binder/
            # scheduler); failover discards it and builds a successor.
            self._build_instance()
            # Small REAL-time solve budget, stamped AFTER the Scheduler
            # (whose constructor stamps the period-derived one): an
            # injected hang costs a fraction of a second of wall time,
            # not the production 30 s. Only when device faults are
            # actually planned — the deadline measures WALL time, and a
            # fault-free (or native) soak on a contended box must not
            # turn a >0.5 s scheduling stall of a healthy solve into a
            # SolveTimeout cycle error. The hook is the chaos seam the
            # solver-exc/solver-hang/backend-loss kinds fire through.
            # (_build_instance re-stamps it for successors too.)
            _containment.set_device_fault_hook(
                self.injector.device_fault_hook()
            )
            # solver-corrupt tamper seam: rewrites a device rung's
            # fetched assignment vector on armed cycles; the post-solve
            # validation layer must reject it before dispatch.
            _containment.set_result_tamper_hook(
                self.injector.result_tamper_hook()
            )
            if cfg.backend in ("dense", "sparse"):
                # Pre-warm the breaker's canary jit so an in-run probe
                # costs milliseconds against the 0.5 s budget — probe
                # success must never hinge on a cold compile racing the
                # deadline (that would make replays timing-dependent).
                try:
                    _containment._canary_probe(
                        timeout=60.0, device=self.device
                    )
                except Exception:
                    logger.exception("sim canary prewarm failed")
            self.checker = InvariantChecker()
            # Soak runs stream the trace to disk without the in-memory
            # record list (O(cycles) RAM the leak detector would —
            # correctly — flag as a linear alloc_blocks climb).
            self.writer = TraceWriter(
                cfg.trace_path, retain=not cfg.soak
            )
            self.replaying = cfg.replay is not None
            if self.replaying:
                self.generator = None
            else:
                self.generator = WorkloadGenerator(cfg.workload, cfg.seed)
        except BaseException:
            if getattr(self, "cache", None) is not None:
                self.cache.shutdown()
            # Undo the process-global containment stamps made above —
            # close() is unreachable when __init__ raises, and a leaked
            # 0.5 s wall-clock budget / fault hook would poison later
            # solves in the same process.
            _containment.set_device_fault_hook(None)
            _containment.set_result_tamper_hook(None)
            _containment.configure(None)
            self._restore_env()
            raise

        self.report = SimReport()
        # Integrity accounting: cross-instance run totals, and the
        # process-global validation-rejection baseline (metrics persist
        # across sims in one process; only this run's delta counts).
        self._integrity_totals: Dict[str, object] = {}
        self._rejected_prev = int(metrics.solver_output_rejected.total())
        # Soak mode: telemetry records every cycle; size the rollup
        # window so the WHOLE horizon fits the window ring (100k cycles
        # at /512 → ~195-cycle windows, 512 windows resident), and
        # force-enable the scheduler's per-cycle feed.
        if cfg.soak:
            from ..obs.telemetry import TELEMETRY

            TELEMETRY.configure(
                window_cycles=max(4, cfg.cycles // 512),
                max_windows=1024,
                raw_capacity=512,
            )
            self.scheduler._telemetry = True
        # Chrome-trace export of the run: enable the global tracer and
        # stamp every span with the virtual clock, so the exported
        # timeline can be correlated with trace-cycle records.
        self._tracing = cfg.trace_out is not None
        if self._tracing:
            TRACER.reset()
            TRACER.enable()
            TRACER.annotator = lambda: {"vtime": self.clock.now()}
        # Deterministic bookkeeping.
        self._seq = 0                      # event timestamp tiebreaker
        self._job_specs: Dict[str, dict] = {}
        self._rebirths: Dict[str, int] = {}
        self._running_since: Dict[str, int] = {}
        # Generate-mode future event queues (flap returns, recreations).
        self._scheduled: Dict[int, List[dict]] = {}
        # Quality-card delta state, harness-owned: the scheduler's
        # cadence-gated feed keeps its own (QUALITY._prev/_state), so
        # the two delta streams never corrupt each other. The series
        # dict keeps four floats per cycle for the end-of-run summary
        # (bounded and tiny even at soak horizons); the card stream
        # itself goes straight to disk.
        self._quality_state: dict = {}
        if self._quality_enabled:
            # Swallow the process's pre-existing solver counter totals
            # so the first card's solver deltas measure THIS run, not
            # whatever ran earlier in the process — a replay in the
            # same process must produce byte-identical cards.
            from ..obs.quality import _solver_deltas

            _solver_deltas(self._quality_state)
        self._quality_churn: Dict[str, float] = {}
        self._quality_series: Dict[str, List[float]] = {}
        self._quality_file = None
        if cfg.quality_out:
            parent = os.path.dirname(os.path.abspath(cfg.quality_out))
            os.makedirs(parent, exist_ok=True)
            self._quality_file = open(cfg.quality_out, "w")

    # -- environment ---------------------------------------------------------

    def _apply_backend_env(self, backend: str, topk: Optional[int]) -> None:
        overrides = dict(_BACKEND_ENV.get(backend, {}))
        if backend == "sparse":
            overrides["KBT_SOLVER_TOPK"] = str(topk or 64)
        for key, value in overrides.items():
            self._env_backup[key] = os.environ.get(key)
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value

    def _restore_env(self) -> None:
        for key, value in self._env_backup.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        self._env_backup = {}

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        try:
            self.cache.shutdown()
        finally:
            self._containment.set_device_fault_hook(None)
            self._containment.set_result_tamper_hook(None)
            self._containment.configure(None)
            self.writer.close()
            if self._quality_file is not None:
                self._quality_file.close()
                self._quality_file = None
            if self._tracing:
                try:
                    self.report.trace_out = TRACER.export(
                        self.cfg.trace_out
                    )
                except OSError:
                    logger.exception("sim trace export failed")
                TRACER.annotator = None
                TRACER.disable()
            self._restore_env()

    def run(self) -> SimReport:
        cfg = self.cfg
        started = time.perf_counter()
        try:
            self._write_header()
            self._bootstrap()
            for cycle in range(cfg.cycles):
                self._run_cycle(cycle)
                self.clock.advance(cfg.period)
            self.report.cycles = cfg.cycles
            self._finish_integrity()
            self.report.breaker = self._containment.BREAKER.state_dict()
            self._finish_latency()
            self._finish_quality()
            if cfg.soak:
                self._finish_soak()
        finally:
            self.report.wall_seconds = time.perf_counter() - started
            self.close()
        return self.report

    def _write_header(self) -> None:
        cfg = self.cfg
        if self.replaying:
            header = dict(cfg.replay.header)
            header["replayed"] = True
            header["backend"] = cfg.backend
        else:
            header = {
                "type": "header",
                "version": TRACE_VERSION,
                "seed": cfg.seed,
                "cycles": cfg.cycles,
                "faults": cfg.faults,
                "backend": cfg.backend,
                "period": cfg.period,
                "micro_every": cfg.micro_every,
                "lease_duration": cfg.lease_duration,
                "antientropy_every": cfg.antientropy_every,
                "workload": cfg.workload.to_dict(),
            }
            if cfg.kill_plan:
                # Provenance only — replay re-applies kills from the
                # recorded fault events, not from the plan.
                header["kill_plan"] = {
                    str(c): cut for c, cut in sorted(cfg.kill_plan.items())
                }
        self.writer.write(header)

    def _bootstrap(self) -> None:
        if self.replaying:
            return  # cycle 0's recorded events carry the bootstrap
        for event in self.generator.initial_events():
            self._scheduled.setdefault(0, []).append(event)

    # -- scheduler instances (failover drill) --------------------------------

    def _build_instance(self) -> None:
        """(Re)build the ACTIVE scheduler instance: its own cluster
        endpoint (the process-death seam, sim/failover.py), a fresh
        SchedulerCache ingesting the shared cluster, the recording
        binder stack, and a real Scheduler. Instance 0 is the bootstrap
        leader; later instances are failover successors."""
        cfg = self.cfg
        self.endpoint = SimClusterEndpoint(
            self.cluster, cfg.seed, fault_injector=self.injector
        )
        self.cache = SchedulerCache(
            cluster=self.endpoint,
            scheduler_name="tpu-batch",
            default_queue="default",
        )
        self.cache.leader_identity = f"sim-leader-{self.instance_id}"
        # Relist rate limiting gates on the VIRTUAL clock, so record
        # and replay allow/deny every gap-repair relist identically.
        self.cache._relist_clock = self.clock.now
        # Integrity deltas restart with the instance (a successor's
        # cache counts from zero).
        self._integrity_prev = None
        self.cache.binder = self.binder = _RecordingBinder(
            self.injector.wrap_binder(self.cache.binder)
        )
        # Ingest without the background resync/cleanup loops: the
        # sim drains those queues itself at deterministic points.
        self.cache.start_ingest()
        self.scheduler = Scheduler(
            self.cache,
            scheduler_conf=cfg.conf,
            schedule_period=cfg.period,
            clock=self.clock,
            device=self.device,
        )
        if self._device_kinds:
            # Scheduler construction re-stamped the period-derived
            # budget; restore the drill's small wall-clock one.
            self._containment.configure(solve_budget=0.5)
        if self._failover_enabled:
            # Virtual-time lease: the drill's takeover waits out the
            # real TTL on the virtual clock (renewed per cycle).
            self.cluster.try_acquire_lease(
                SIM_NAMESPACE, "leader", self.cache.leader_identity,
                cfg.lease_duration, now=self.clock.now(),
            )

    def _failover(self, cycle: int, cut: str) -> dict:
        """Process-death aftermath: finalize the dead instance, wait
        out the (virtual) lease TTL, build the successor, and run the
        production recovery pass — returning the trace's failover block
        (wall-clock-free, so record and replay compare byte-equal)."""
        dead_cache = self.cache
        dead_endpoint = self.endpoint
        dead_binder = self.binder
        dead_identity = dead_cache.leader_identity
        # The dead instance's side effects were already barriered by
        # _run_cycle's step-4 kill branch (before the injector's seam
        # drain); the landed-bind set is final here.
        dead_endpoint.finalize_death()
        dead_cache.shutdown()

        # Lease takeover: a killed leader released nothing, so the
        # successor must wait out the TTL in virtual time.
        self.instance_id += 1
        successor_id = f"sim-leader-{self.instance_id}"
        takeover_wait = 0.0
        if not self.cluster.try_acquire_lease(
            SIM_NAMESPACE, "leader", successor_id,
            self.cfg.lease_duration, now=self.clock.now(),
        ):
            takeover_wait = self.cfg.lease_duration + 1.0
            self.clock.advance(takeover_wait)
            if not self.cluster.try_acquire_lease(
                SIM_NAMESPACE, "leader", successor_id,
                self.cfg.lease_duration, now=self.clock.now(),
            ):
                raise RuntimeError(
                    "failover: successor could not take the expired lease"
                )

        self._build_instance()
        # Landed binds of the dead leader are this cycle's placements:
        # carry them into the successor's recorder so the trace (and
        # the replay verifier) sees them where they happened.
        self.binder.records.extend(dead_binder.records)

        # The production successor-recovery pass (cache/recovery.py via
        # the Scheduler entry point): classify the dead leader's
        # surviving intents, complete or evict partial gangs.
        report = self.scheduler.recover_from_journal()
        summary = report.summary() if report is not None else {}
        if report is not None:
            if report.errors:
                self.report.recovery_failures += report.errors
            for item in report.evicted:
                job_key = item["job"]
                self.checker.mark_degraded(job_key, cycle)
                ns, _, job_name = job_key.partition("/")
                pod_ns, _, pod_name = item["pod"].partition("/")
                if (
                    not self.replaying
                    and self.cfg.recreate_killed
                    and job_name in self._job_specs
                ):
                    self._schedule_recreation(job_name, pod_name, cycle)
        # Wall-clock fields are forensics, not semantics: the trace's
        # failover block must be bit-equal between record and replay.
        summary.pop("duration_ms", None)
        info = {
            "cut": cut,
            "cycle": cycle,
            "killed": dead_identity,
            "successor": successor_id,
            "takeover_wait_s": round(takeover_wait, 3),
            "binds_refused": dead_endpoint.binds_refused,
            "marks_dropped": dead_endpoint.marks_dropped,
            "recovery": summary,
        }
        self.report.leader_kills += 1
        self.report.failovers.append(info)
        return info

    # -- the cycle -----------------------------------------------------------

    def _run_cycle(self, cycle: int) -> None:
        cfg = self.cfg

        # 0. arm the event-stream fault seam for the whole cycle window
        # (workload events apply before the scheduling step; the seam
        # disarms in end_cycle, so post-event cleanup and the settle
        # drains run fault-free and the cycle converges).
        self.injector.begin_cycle_events(cycle)

        # 1. events
        if self.replaying:
            rec = (
                cfg.replay.cycles[cycle]
                if cycle < len(cfg.replay.cycles) else {}
            )
            events = list(rec.get("events", []))
            fault_events = list(rec.get("faults", []))
        else:
            rec = None
            events = self._scheduled.pop(cycle, [])
            events.extend(self.generator.events_for_cycle(
                cycle, self._running_since, self._node_names()
            ))
        for event in events:
            self._apply_event(event, cycle)
        if not self.replaying:
            # Faults are planned AFTER this cycle's events have landed:
            # targeting pre-event state would let a flap pick a node
            # drained this very cycle (its scheduled return would then
            # resurrect a permanently-removed node) or an evict pick a
            # pod whose job-delete already ran (a recorded "fault" that
            # injected nothing).
            fault_events = self.injector.plan_cycle(
                cycle, self._node_names(), self._running_pod_keys()
            )
            planned_cut = cfg.kill_plan.get(cycle)
            if planned_cut is not None and not any(
                f["kind"] == "leader-kill" for f in fault_events
            ):
                fault_events.append(
                    {"kind": "leader-kill", "cut": planned_cut}
                )

        # 2. faults
        doomed: List[str] = []
        solver_fault = crash_fault = corrupt_fault = False
        kill_cut: Optional[str] = None
        device_fault = None  # "exc" | "hang" for this cycle's solves
        for fault in fault_events:
            kind = fault["kind"]
            self.report.fault_counts[kind] = (
                self.report.fault_counts.get(kind, 0) + 1
            )
            metrics.register_sim_fault(kind)
            if kind == "node-flap":
                self._kill_node(fault["name"], cycle, reason="flap")
                if not self.replaying:
                    self._scheduled.setdefault(
                        cycle + fault["down_for"], []
                    ).append(self._node_add_event(fault["name"]))
            elif kind == "node-death":
                doomed.append(fault["name"])
            elif kind == "evict":
                self._kill_pod(fault["pod"], cycle)
            elif kind == "solver":
                solver_fault = True
            elif kind == "crash":
                crash_fault = True
            elif kind == "solver-exc":
                device_fault = "exc"
            elif kind == "solver-hang":
                # A planned hang wins over a planned exception: it
                # exercises the strictly harsher path (deadline
                # abandonment + immediate quarantine).
                device_fault = "hang"
            elif kind == "backend-loss":
                self.injector.note_backend_loss(cycle, fault["down_for"])
            elif kind == "solver-corrupt":
                corrupt_fault = True
            elif kind == "leader-kill":
                kill_cut = fault["cut"]

        # 3. one real scheduling cycle. In micro mode only every Nth
        # cycle is periodic; the rest run the bounded warm-path micro
        # cycle (crash-fault cycles always run periodic so the injected
        # crash action actually executes; a leader kill needs the full
        # dispatch pipeline its cut points are defined against).
        micro_cycle = (
            cfg.micro_every > 1
            and cycle % cfg.micro_every != 0
            and not crash_fault
            and kill_cut is None
        )
        if self._failover_enabled and kill_cut is None:
            # The live leader renews its lease each cycle; a killed
            # leader deliberately does NOT — its last renewal is what
            # the successor's takeover must wait out.
            self.cluster.try_acquire_lease(
                SIM_NAMESPACE, "leader", self.cache.leader_identity,
                cfg.lease_duration, now=self.clock.now(),
            )
        if kill_cut is not None:
            self.endpoint.arm_kill(kill_cut, cycle)
        self.injector.begin_cycle(
            cycle, doomed_nodes=doomed, solver_fault=device_fault,
            corrupt=corrupt_fault,
        )
        prev_solver = None
        if solver_fault:
            prev_solver = os.environ.get("KBT_SOLVER")
            os.environ["KBT_SOLVER"] = "native"
        if crash_fault:
            self.scheduler.actions.insert(
                0, self.injector.crash_action_factory()
            )
        try:
            if micro_cycle:
                ok = self.scheduler.run_micro()
            else:
                ok = self.scheduler.run_once_guarded()
        finally:
            if crash_fault:
                self.scheduler.actions.pop(0)
            if solver_fault:
                if prev_solver is None:
                    os.environ.pop("KBT_SOLVER", None)
                else:
                    os.environ["KBT_SOLVER"] = prev_solver
        if not ok:
            self.report.cycle_errors += 1
            # Forensics alongside the JSONL trace: the flight recorder's
            # last record carries the failing phase + traceback
            # (committed by run_once_guarded's error path).
            self._flight_dump(cycle, "cycle-error")
            # The guarded production loop would back off; virtual time
            # pays the same penalty.
            self.clock.advance(self.scheduler.cycle_error_backoff())

        # 4. barrier + deterministic queue drains. The event-fault
        # reorder stash flushes FIRST: a stashed swap delivered at this
        # fixed point means the settle's gap checkpoints see only
        # genuine drops as stream holes. A killed leader's
        # instance is only barriered on its in-flight (refusing) side
        # effects — BEFORE end_cycle, so the bind seam's forensics are
        # complete when drained; its resync/cleanup queues die with the
        # process and the successor settles after recovery instead.
        self.injector.flush_events()
        if kill_cut is not None:
            if not self.cache.wait_for_side_effects(timeout=60.0):
                logger.warning(
                    "sim: dead leader side effects still in flight"
                )
        else:
            self._settle()
        seam = self.injector.end_cycle()
        if cycle % 256 == 255:
            # Periodic deterministic GC of dead pods' bind-attempt
            # counters (leak over long soaks; dead uids never bind
            # again so pruning changes no fault decision). Runs on the
            # settled cluster, so record and replay prune identically.
            self.injector.prune_bind_attempts(
                p.uid for p in self.cluster.list_objects("Pod")
            )
        for pod_key, _host in seam["bind_failures"]:
            self._degrade_pod(pod_key, cycle)
        self.report.bind_failures += len(seam["bind_failures"])
        # Hash-decided bind faults (a subset of the seam failures — the
        # rest are doomed-node rejections) count as injected faults too.
        for _ in range(seam["bind_faults"]):
            metrics.register_sim_fault("bind")
        if seam["bind_faults"]:
            self.report.fault_counts["bind"] = (
                self.report.fault_counts.get("bind", 0)
                + seam["bind_faults"]
            )
        # Event-stream fault forensics (hash-decided at the delivery
        # seam, like the bind faults): count them, and register every
        # DROPPED event's subject with the invariant checker — the
        # mirror is knowingly diverged until the relist/anti-entropy
        # machinery repairs it, and the checker judges that repair
        # (suppressed subjects must all clear by run end).
        for kind, n in seam.get("event_faults", {}).items():
            self.report.fault_counts[kind] = (
                self.report.fault_counts.get(kind, 0) + n
            )
            for _ in range(n):
                metrics.register_sim_fault(kind)
        if seam.get("relist_fails"):
            n = seam["relist_fails"]
            self.report.fault_counts["relist-fail"] = (
                self.report.fault_counts.get("relist-fail", 0) + n
            )
            for _ in range(n):
                metrics.register_sim_fault("relist-fail")
        dropped = seam.get("events_dropped", ())
        if dropped:
            self.checker.note_divergence(
                cycle,
                uids=[s for k, _e, s in dropped if k == "Pod"],
                nodes=[s for k, _e, s in dropped if k == "Node"],
            )

        # 4b. failover: the killed leader is torn down, the successor
        # takes the lease, runs the production journal-recovery pass,
        # and the world settles under the NEW instance before the
        # invariant check judges the failover boundary.
        failover_info = None
        if kill_cut is not None:
            failover_info = self._failover(cycle, kill_cut)
            self._settle()

        # 5. post-cycle cleanup (orphans of mid-cycle node deaths)
        if self.replaying:
            post_events = list((rec or {}).get("post_events", []))
        else:
            post_events = self._plan_post_events(cycle, doomed, seam)
        for event in post_events:
            self._apply_event(event, cycle)
        if post_events:
            self._settle()

        placements = self.binder.drain()
        self._update_running_since(cycle)
        # Per-cycle integrity delta (anomalies absorbed, relists,
        # divergence detected/repaired, validation rejections) — part
        # of the trace record as FORENSICS; deliberately NOT
        # replay-compared (see the note at the replay verifier below):
        # which cycle a gap confirmation lands on depends on worker-
        # thread rv assignment order. Placements + the end-state
        # repair gate are the determinism contract.
        integrity_delta = self._integrity_delta()

        # 6. invariants
        violations = []
        if cfg.check_invariants:
            t0 = time.perf_counter()
            violations = [
                v.to_dict() for v in self.checker.check(
                    self.cache, cycle, namespace=SIM_NAMESPACE
                )
            ]
            self.report.check_seconds += time.perf_counter() - t0
            for v in violations:
                metrics.register_sim_violation(v["invariant"])
            self.report.violations.extend(violations)
            if violations:
                self._flight_dump(cycle, "violation")
        metrics.register_sim_cycle()
        self.report.placements += len(placements)

        # Per-cycle placement-quality card on the SETTLED world (the
        # sim bypasses the production KBT_QUALITY_EVERY cadence — sim
        # clusters are small). Churn deltas come from the process-
        # global monitor's seam counters against the harness-owned
        # prev, so the scheduler's own cadence feed stays untouched.
        quality_card = None
        if self._quality_enabled:
            try:
                quality_card = compute_scorecard(
                    self.cache,
                    churn=QUALITY.churn_delta(self._quality_churn),
                    state=self._quality_state,
                )
            except Exception:
                logger.exception("sim quality card failed")
        if quality_card is not None:
            for key, val in (
                ("density_dom", quality_card["density_dom"]),
                ("jain", quality_card["fairness"]["jain"]),
                ("churn_per_placement",
                 quality_card["churn"]["per_placement"]),
                ("emptiable_frac",
                 quality_card["frag"]["emptiable_frac"]),
            ):
                self._quality_series.setdefault(key, []).append(
                    float(val)
                )
            if self._quality_file is not None:
                self._quality_file.write(canon(quality_card) + "\n")

        stats = self._cycle_stats()
        if cfg.soak:
            # Soak-only series: invariant/error counts (bounded at zero
            # by the drift detectors) and the cluster's population —
            # folded into the cycle's open telemetry window, which
            # run_once already started with the watermark probes.
            from ..obs.telemetry import TELEMETRY

            if not ok:
                # An errored cycle never reaches run_once's telemetry
                # feed, so the series' internal cycle counter would
                # drift from the trace's cycle numbers — and with it
                # every replay-bisect pointer. Feed the missing sample
                # at the true trace cycle; the explicit index also
                # realigns the counter for all later cycles.
                TELEMETRY.observe_values({}, cycle=cycle)
            soak_values = {
                "invariant_violations": float(len(violations)),
                "sim_cycle_errors": 0.0 if ok else 1.0,
                "placements": float(len(placements)),
                "pods": float(stats["pods"]),
                "pending": float(stats["pending"]),
                "running": float(stats["running"]),
                "nodes": float(stats["nodes"]),
                "jobs": float(stats["jobs"]),
            }
            if quality_card is not None:
                # quality:* series — the drift detectors (sim/soak.py)
                # bound unfairness and churn-per-placement over the
                # soak horizon.
                soak_values.update(telemetry_values(quality_card))
            TELEMETRY.annotate_cycle(soak_values)

        record = {
            "type": "cycle",
            "cycle": cycle,
            "events": events,
            "faults": fault_events,
            "post_events": post_events,
            "placements": placements,
            "bind_failures": [list(b) for b in seam["bind_failures"]],
            "stats": stats,
            "violations": violations,
        }
        if failover_info is not None:
            record["failover"] = failover_info
        if integrity_delta is not None:
            record["integrity"] = integrity_delta
        if quality_card is not None:
            record["quality"] = quality_card
        self.writer.write(record)
        if self.replaying and rec is not None:
            if placements != rec.get("placements", []):
                self.report.replay_mismatches.append(cycle)
            elif failover_info != rec.get("failover"):
                # The failover boundary is part of the replay contract:
                # the successor must classify, re-drive and evict
                # identically, or the drill is not deterministic.
                self.report.replay_mismatches.append(cycle)
            elif (
                quality_card is not None
                and "quality" in rec
                and replay_view(quality_card)
                != replay_view(rec["quality"])
            ):
                # Minus the path-dependent solver deltas, a card is a
                # pure function of the replayed cluster state: a
                # mismatch means the replayed WORLD diverged even
                # though the placements matched. (Traces recorded
                # before the quality block, or under KBT_QUALITY=0 on
                # either side, skip the comparison.)
                self.report.quality_mismatches.append(cycle)
            # The integrity block is deliberately NOT byte-compared:
            # which CYCLE a gap confirmation / relist lands on depends
            # on the cluster's event-rv assignment order across
            # concurrent side-effect workers (a dropped terminal rv's
            # hole only becomes visible once a later write passes it).
            # The true determinism contract — placements, and the
            # end-state "every divergence repaired" gate
            # (--require-divergence-repaired) — holds in both runs;
            # the per-cycle block stays in the record as forensics.

    def _integrity_snapshot(self) -> dict:
        cur = self.cache.integrity_state()
        return {
            "anomalies": dict(cur["event_anomalies"]),
            "relists": {
                k: v for k, v in cur["relists"].items() if v
            },
            "detected": dict(cur["divergence_detected"]),
            "repaired": dict(cur["divergence_repaired"]),
        }

    def _integrity_delta(self) -> Optional[dict]:
        """This cycle's integrity activity as deltas of the cache's
        cumulative counters (plus the validation-rejection metric),
        folded into the run totals. None when nothing happened — the
        common case, keeping clean traces byte-identical to pre-
        integrity recordings."""
        cur = self._integrity_snapshot()
        prev = self._integrity_prev or {}
        self._integrity_prev = cur
        rejected_now = int(metrics.solver_output_rejected.total())
        d_rejected = rejected_now - self._rejected_prev
        self._rejected_prev = rejected_now
        out: Dict[str, object] = {}
        for key in ("anomalies", "relists", "detected", "repaired"):
            base = prev.get(key, {})
            delta = {
                k: v - base.get(k, 0)
                for k, v in sorted(cur[key].items())
                if v - base.get(k, 0)
            }
            if delta:
                out[key] = delta
        if d_rejected:
            out["rejected"] = d_rejected
        if not out:
            return None
        for key, val in out.items():
            if key == "rejected":
                self._integrity_totals["rejected"] = (
                    self._integrity_totals.get("rejected", 0) + val
                )
            else:
                totals = self._integrity_totals.setdefault(key, {})
                for k, v in val.items():
                    totals[k] = totals.get(k, 0) + v
        return out

    def _finish_integrity(self) -> None:
        """End of run: flush any stashed event, settle, run an
        UNBUDGETED anti-entropy reconcile, verify the next sweep finds
        nothing, and run one final invariant check — every injected
        divergence must provably have cleared (unrepaired_end = 0 is
        the DIVERGE acceptance gate; --require-divergence-repaired)."""
        self.injector.flush_events()
        self._settle()
        # Controller-analog cleanup of pods orphaned on dead nodes by
        # the FINAL cycles: every earlier cycle's step-5 post events
        # handled its predecessors, but a pod ghost-bound in the last
        # cycle (bind landed while a dropped node-delete kept the
        # ghost in the mirror) has no later cycle to clean it — and
        # its conservation flag would stay suppressed forever.
        # Deterministic in replay too: it reads settled cluster state.
        post = self._plan_post_events(
            self.cfg.cycles, [], {"bind_failures": []}
        )
        for event in post:
            self._apply_event(event, self.cfg.cycles)
        if post:
            self._settle()
        unrepaired = 0
        verify_detected: dict = {}
        reconcile_failed = False
        try:
            self.cache.antientropy.sweep(budget=None)
            self._settle()
            verify = self.cache.antientropy.sweep(budget=None)
            verify_detected = dict(sorted(verify["detected"].items()))
            unrepaired = sum(verify["detected"].values())
        except Exception:
            logger.exception("final anti-entropy reconcile failed")
            reconcile_failed = True
        if self.cfg.check_invariants:
            final = [
                v.to_dict() for v in self.checker.check(
                    self.cache, self.cfg.cycles, namespace=SIM_NAMESPACE
                )
            ]
            for v in final:
                metrics.register_sim_violation(v["invariant"])
            self.report.violations.extend(final)
        self._integrity_delta()  # fold the final sweeps into the totals
        totals = self._integrity_totals
        self.report.integrity = {
            "anomalies": dict(sorted(
                totals.get("anomalies", {}).items()
            )),
            "relists": dict(sorted(totals.get("relists", {}).items())),
            "divergence_detected": dict(sorted(
                totals.get("detected", {}).items()
            )),
            "divergence_repaired": dict(sorted(
                totals.get("repaired", {}).items()
            )),
            "validation_rejected": totals.get("rejected", 0),
            "suppressed_violations": self.checker.suppressed_total,
            "unrepaired_end": (
                unrepaired
                + self.checker.outstanding_divergence()
                + (1 if reconcile_failed else 0)
            ),
            # Forensics for a nonzero verdict: what the verify sweep
            # still saw, and which exempt subjects never cleared.
            "unrepaired_verify": verify_detected,
            "unrepaired_outstanding": sorted(
                list(self.checker.diverged_uids)
                + list(self.checker.diverged_nodes)
            ),
        }

    def _finish_latency(self) -> None:
        """End of run: land the placement ledger's engagement summary
        in the report and dump the decision-audit stream (JSONL,
        virtual-clock-stamped → byte-identical under replay) alongside
        the trace or to --audit-out."""
        from ..obs.latency import AUDIT, LEDGER

        if not LEDGER.enabled:
            return
        self.report.latency = LEDGER.summary()
        self.report.audit_records = AUDIT.meta()["records"]
        path = self.cfg.audit_out or (
            f"{self.cfg.trace_path}.audit.jsonl"
            if self.cfg.trace_path else None
        )
        if path:
            try:
                self.report.audit_path = AUDIT.dump_jsonl(path)
            except OSError:
                logger.exception("sim audit dump failed")

    def _finish_quality(self) -> None:
        """End of run: fold the per-cycle card series into the report's
        quality summary — the medians are what the A/B study driver
        (sim/study.py) pairs across seeds."""
        series = self._quality_series
        if not any(series.values()):
            return
        import statistics

        summary: Dict[str, object] = {
            key: {
                "mean": round(statistics.fmean(vals), 6),
                "median": round(statistics.median(vals), 6),
                "last": round(vals[-1], 6),
            }
            for key, vals in sorted(series.items()) if vals
        }
        summary["cards"] = len(series.get("density_dom", ()))
        summary["counters"] = {
            k: round(v, 6) for k, v in QUALITY.counters().items()
        }
        if self.cfg.quality_out:
            summary["stream"] = self.cfg.quality_out
        self.report.quality = summary

    def _finish_soak(self) -> None:
        """End of a soak run: close the tail window, fit the leak/drift
        detectors over the rolled windows, dump the telemetry
        (alongside the JSONL trace, or to --telemetry-out), and land
        the verdict in the report. Detector trips do NOT raise — the
        CLI turns them into exit code 4 so the report still prints."""
        import json as _json

        from ..obs.telemetry import TELEMETRY
        from .soak import SoakVerdict, run_detectors

        TELEMETRY.flush()
        windows = TELEMETRY.windows()
        verdict = SoakVerdict(
            detectors=run_detectors(windows),
            trace_path=self.cfg.trace_path,
        )
        dump_path = self.cfg.telemetry_out or (
            f"{self.cfg.trace_path}.telemetry.json"
            if self.cfg.trace_path else None
        )
        if dump_path:
            try:
                # Set before to_dict so the on-disk dump names itself;
                # reset if the write fails.
                verdict.telemetry_dump = dump_path
                payload = TELEMETRY.snapshot(recent_raw=128)
                payload["soak"] = verdict.to_dict()
                payload["config"] = {
                    "cycles": self.cfg.cycles,
                    "seed": self.cfg.seed,
                    "faults": self.cfg.faults,
                    "backend": self.cfg.backend,
                    "workload": self.cfg.workload.to_dict(),
                }
                parent = os.path.dirname(os.path.abspath(dump_path))
                os.makedirs(parent, exist_ok=True)
                with open(dump_path, "w") as f:
                    _json.dump(payload, f, sort_keys=True)
            except OSError:
                verdict.telemetry_dump = None
                logger.exception("soak telemetry dump failed")
        self.report.soak = verdict.to_dict()
        for trip in verdict.tripped:
            logger.error("soak detector tripped: %s", trip.message)
        for hint in verdict.replay_hints():
            logger.error("soak replay-bisect: %s", hint)

    def _flight_dump(self, cycle: int, reason: str) -> None:
        """Write the flight-recorder ring next to the JSONL trace (no-op
        without a trace path — the ring still holds the records for
        callers that read the recorder directly)."""
        base = self.cfg.trace_path
        if not base:
            return
        path = f"{base}.flight-{reason}-c{cycle}.json"
        try:
            RECORDER.dump_to(path, reason=f"sim-{reason}")
            self.report.flight_dumps.append(path)
        except OSError:
            logger.exception("sim flight dump failed")

    # -- settling ------------------------------------------------------------

    def _settle(self) -> None:
        """Quiesce: all async side effects done, resync/cleanup queues
        drained (in sorted order — queue arrival order depends on worker
        timing), repeated until a full pass changes nothing."""
        for _ in range(8):
            if not self.cache.wait_for_side_effects(timeout=60.0):
                logger.warning("sim settle: side effects still in flight")
            resynced = self.cache.drain_resync_queue()
            cleaned = self.cache.drain_cleanup_queue()
            if not resynced and not cleaned:
                return
        logger.warning("sim settle: world still churning after 8 passes")

    # -- event application ---------------------------------------------------

    def _next_ts(self, cycle: int) -> float:
        self._seq += 1
        return cycle * self.cfg.period + self._seq * 1e-6

    def _node_names(self) -> List[str]:
        return sorted(
            n.name for n in self.cluster.list_objects("Node")
        )

    def _running_pod_keys(self) -> List[str]:
        return sorted(
            f"{p.namespace}/{p.name}"
            for p in self.cluster.list_objects("Pod")
            if p.namespace == SIM_NAMESPACE
            and p.status.phase == PodPhase.RUNNING
        )

    def _node_add_event(self, name: str) -> dict:
        spec = self.cfg.workload
        return {
            "kind": "node-add", "name": name,
            "cpu_m": spec.node_cpu_m, "mem_mi": spec.node_mem_mi,
        }

    def _apply_event(self, event: dict, cycle: int) -> None:
        kind = event["kind"]
        if kind == "queue-add":
            q = build_queue(event["name"], weight=event["weight"])
            q.metadata.uid = f"uid-queue-{event['name']}"
            q.metadata.creation_timestamp = self._next_ts(cycle)
            self.cluster.create_queue(q)
        elif kind == "node-add":
            node = build_node(
                event["name"],
                build_resource_list(
                    cpu=f"{event['cpu_m']}m",
                    memory=f"{event['mem_mi']}Mi",
                    pods=110,
                ),
                labels=event.get("labels"),
            )
            node.metadata.uid = f"uid-node-{event['name']}"
            node.metadata.creation_timestamp = self._next_ts(cycle)
            self.cluster.create_node(node)
        elif kind == "node-remove":
            self._kill_node(event["name"], cycle, reason=event.get(
                "reason", "drain"
            ))
        elif kind == "job-create":
            self._create_job(event, cycle)
        elif kind == "job-complete":
            self._complete_job(event["name"], cycle)
        elif kind == "job-delete":
            self._delete_job(event["name"])
        elif kind == "pod-recreate":
            self._recreate_pods(event, cycle)
        elif kind == "pod-delete":
            self._kill_pod(event["pod"], cycle, recreate=False)
        else:
            raise ValueError(f"unknown sim event kind {kind!r}")

    def _create_job(self, event: dict, cycle: int) -> None:
        name = event["name"]
        self._job_specs[name] = dict(event)
        self.report.jobs_created += 1
        ts = self._next_ts(cycle)
        pg = build_pod_group(
            name, namespace=SIM_NAMESPACE,
            min_member=event["min_member"], queue=event["queue"],
        )
        pg.metadata.uid = f"uid-pg-{name}"
        pg.metadata.creation_timestamp = ts
        self.cluster.create_pod_group(pg)
        req = build_resource_list(
            cpu=f"{event['cpu_m']}m", memory=f"{event['mem_mi']}Mi"
        )
        for i in range(event["replicas"]):
            self._create_pod(name, f"{name}-{i}", req, ts)

    def _create_pod(self, job: str, pod_name: str, req, ts: float) -> None:
        pod = build_pod(
            SIM_NAMESPACE, pod_name, "", PodPhase.PENDING, dict(req),
            group_name=job,
        )
        # Serving annotations (api/serving.py schema) ride the job
        # spec, so churn/fault replacements inherit the class, SLO
        # target and replica floor of the pods they replace.
        extra = self._job_specs.get(job, {}).get("annotations")
        if extra:
            pod.metadata.annotations.update(extra)
        pod.metadata.creation_timestamp = ts
        self.cluster.create_pod(pod)

    def _complete_job(self, name: str, cycle: int) -> None:
        self.report.jobs_completed += 1
        for pod in self._job_pods(name):
            if pod.status.phase == PodPhase.RUNNING:
                pod.status.phase = PodPhase.SUCCEEDED
                self.cluster.update("Pod", pod)
        self._running_since.pop(name, None)

    def _delete_job(self, name: str) -> None:
        for pod in self._job_pods(name):
            self.cluster.delete_pod(pod)
        for pg in self.cluster.list_objects("PodGroup"):
            if pg.namespace == SIM_NAMESPACE and pg.name == name:
                self.cluster.delete("PodGroup", pg)
        self._job_specs.pop(name, None)
        self._running_since.pop(name, None)
        self._rebirths = {
            k: v for k, v in self._rebirths.items()
            if not k.startswith(f"{name}-")
        }

    def _job_pods(self, job: str):
        from ..api.objects import GROUP_NAME_ANNOTATION_KEY

        return sorted(
            (
                p for p in self.cluster.list_objects("Pod")
                if p.namespace == SIM_NAMESPACE
                and p.metadata.annotations.get(
                    GROUP_NAME_ANNOTATION_KEY
                ) == job
            ),
            key=lambda p: p.name,
        )

    def _job_of_pod(self, pod) -> Optional[str]:
        from ..api.objects import GROUP_NAME_ANNOTATION_KEY

        return pod.metadata.annotations.get(GROUP_NAME_ANNOTATION_KEY)

    def _kill_node(self, name: str, cycle: int, reason: str) -> None:
        for node in self.cluster.list_objects("Node"):
            if node.name == name:
                self.cluster.delete("Node", node)
                break
        for pod in sorted(
            (
                p for p in self.cluster.list_objects("Pod")
                if p.namespace == SIM_NAMESPACE
                and p.spec.node_name == name
            ),
            key=lambda p: p.name,
        ):
            self._kill_pod(f"{pod.namespace}/{pod.name}", cycle)

    def _kill_pod(self, pod_key: str, cycle: int, recreate: bool = True) -> None:
        ns, _, name = pod_key.partition("/")
        pod = self.cluster.get_pod(ns, name)
        if pod is None:
            return
        job = self._job_of_pod(pod)
        self.cluster.delete_pod(pod)
        if job:
            self.checker.mark_degraded(f"{ns}/{job}", cycle)
            if (
                recreate
                and not self.replaying
                and self.cfg.recreate_killed
                and job in self._job_specs
            ):
                self._schedule_recreation(job, name, cycle)

    def _schedule_recreation(self, job: str, pod_name: str, cycle: int) -> None:
        # "simjob-00001-3r2" → base "simjob-00001-3": rebirths of a
        # rebirth share the original replica's generation counter.
        stem, dash, tail = pod_name.rpartition("-")
        base = f"{stem}{dash}{tail.split('r', 1)[0]}"
        gen = self._rebirths.get(base, 0) + 1
        self._rebirths[base] = gen
        self._scheduled.setdefault(cycle + 1, []).append({
            "kind": "pod-recreate",
            "job": job,
            "names": [f"{base}r{gen}"],
        })

    def _recreate_pods(self, event: dict, cycle: int) -> None:
        job = event["job"]
        spec = self._job_specs.get(job)
        if spec is None:
            return  # job finished in the meantime
        req = build_resource_list(
            cpu=f"{spec['cpu_m']}m", memory=f"{spec['mem_mi']}Mi"
        )
        ts = self._next_ts(cycle)
        for name in event["names"]:
            if self.cluster.get_pod(SIM_NAMESPACE, name) is not None:
                continue
            self._create_pod(job, name, req, ts)

    def _degrade_pod(self, pod_key: str, cycle: int) -> None:
        ns, _, name = pod_key.partition("/")
        pod = self.cluster.get_pod(ns, name)
        if pod is None:
            return
        job = self._job_of_pod(pod)
        if job:
            self.checker.mark_degraded(f"{ns}/{job}", cycle)

    def _plan_post_events(self, cycle, doomed, seam) -> List[dict]:
        """Generate mode: clean up after mid-cycle node deaths — the
        node object (when no bind got to kill it first) and the Running
        pods orphaned on it."""
        post: List[dict] = []
        live_nodes = set(self._node_names())
        removed_now = set()
        for name in doomed:
            if name in live_nodes:
                # The node-remove event's application (_kill_node)
                # deletes this node's pods and schedules their
                # recreations itself — listing them here too would
                # recreate each orphan TWICE (r<N> and r<N+1>),
                # permanently inflating the job.
                post.append({
                    "kind": "node-remove", "name": name, "reason": "death",
                })
                live_nodes.discard(name)
                removed_now.add(name)
        for pod in self.cluster.list_objects("Pod"):
            node_name = pod.spec.node_name
            if (
                pod.namespace == SIM_NAMESPACE
                and node_name
                and node_name not in live_nodes
                and node_name not in removed_now
            ):
                # Orphans of a node the injector already deleted
                # mid-cycle: no node-remove event will clean these up.
                post.append({
                    "kind": "pod-delete",
                    "pod": f"{pod.namespace}/{pod.name}",
                })
                job = self._job_of_pod(pod)
                if (
                    job is not None
                    and self.cfg.recreate_killed
                    and job in self._job_specs
                ):
                    self._schedule_recreation(job, pod.name, cycle)
        post.sort(key=lambda e: (e["kind"], e.get("name", e.get("pod", ""))))
        return post

    # -- observation ---------------------------------------------------------

    def _update_running_since(self, cycle: int) -> None:
        running: Dict[str, int] = {}
        for pod in self.cluster.list_objects("Pod"):
            if (
                pod.namespace == SIM_NAMESPACE
                and pod.status.phase == PodPhase.RUNNING
            ):
                job = self._job_of_pod(pod)
                if job:
                    running[job] = running.get(job, 0) + 1
        for job, count in running.items():
            spec = self._job_specs.get(job)
            if spec is None:
                continue
            if count >= spec["min_member"]:
                self._running_since.setdefault(job, cycle)
        # A gang knocked below min_member (node death, eviction) is no
        # longer fully running: its completion clock restarts when the
        # reborn members bind — otherwise a half-dead job would still
        # "succeed" on schedule with its rebirths sitting Pending.
        for job in list(self._running_since):
            spec = self._job_specs.get(job)
            if spec is None:
                continue
            if running.get(job, 0) < spec["min_member"]:
                del self._running_since[job]

    def _cycle_stats(self) -> dict:
        pods = [
            p for p in self.cluster.list_objects("Pod")
            if p.namespace == SIM_NAMESPACE
        ]
        return {
            "nodes": len(self.cluster.list_objects("Node")),
            "jobs": len(self._job_specs),
            "pods": len(pods),
            "running": sum(
                1 for p in pods if p.status.phase == PodPhase.RUNNING
            ),
            "pending": sum(
                1 for p in pods if p.status.phase == PodPhase.PENDING
            ),
            # Carried-backlog depth (solver/warm.py): a pure function
            # of solve history, so replay-stable — congested-regime
            # benches read the series straight off the trace records.
            "carried": self._carried_depth(),
        }

    def _carried_depth(self) -> int:
        ws = getattr(self.cache, "_warm_solve_state", None)
        if ws is None or not getattr(ws, "valid", False):
            return 0
        return len(ws.carried)


def run_sim(cfg: SimConfig) -> Tuple[SimReport, List[dict]]:
    """Run one simulation; returns (report, trace records)."""
    sim = ClusterSimulator(cfg)
    report = sim.run()
    return report, sim.writer.records
