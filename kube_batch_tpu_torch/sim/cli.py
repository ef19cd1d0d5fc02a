"""``python -m kube_batch_tpu_torch sim`` — the simulator entry point.

A copy of the JAX package's ``sim/cli.py`` with the port's device:
``--device`` (``cuda`` by default, ``cpu`` on request) is where every
scheduler of the run solves; ``--device cuda`` without CUDA exits 11
with a message. ``--host-devices N`` sets the process's virtual shard
count to N before the first solve (``device.set_host_device_count``):
every scheduler of the run then solves on a mesh of N shards of its
device (the reference forces N virtual CPU devices instead).

Exit codes: 0 clean; 1 invariant violations (always — a sim run that
breaks the contract must fail CI); 2 replay mismatch (placements, a
failover block, or a placement-quality scorecard);
3 scheduler-cycle errors with ``--fail-on-cycle-errors``; 4 soak-mode
leak/drift detector trip (``--soak``); 5 the sharded-sparse engagement
assert failed (``--require-sparse-sharded`` — the run never solved
through the multi-device sparse path); 6 the failover drill was
incomplete (``--require-kill-cuts`` — a required leader-kill cut never
fired, or a successor recovery pass reported errors); 7 the
divergence-repair assert failed (``--require-divergence-repaired`` —
a divergence was left unrepaired at run end, or the run injected no
event/solver-corrupt faults at all and proved nothing); 8 the
device-selection assert failed (``--require-device-selection`` — no
selection pass ran on the device-resident key matrix); 9 a congested
steady-state assert failed (``--require-queue-p99`` — some queue's
arrival→bind total p99 exceeded the bound, or the ledger stamped
nothing; ``--max-micro-defer-ratio`` — too many micro cycles deferred
to the periodic authority instead of placing, or no micro cycle ran
at all; ``--require-warm-subset`` — no rank-stable subset solve ever
engaged, so the storm proved nothing about the subset path); 10 a
serving-SLO assert failed (``--min-serving-attainment`` — serving
placement-latency SLO attainment came in under the floor, or serving
pods saw violations with ``--max-serving-violations``;
``--require-serving-engaged`` — no SLO-targeted serving placement ever
landed, so the mix proved nothing about the serving path); 11 the
device asked for is not available.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..device import resolve_device, set_host_device_count

from .harness import SIM_DEFAULT_CONF, ClusterSimulator, SimConfig
from .trace import TraceReader
from .workload import WorkloadSpec


def add_sim_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--cycles", type=int, default=200,
                        help="virtual scheduling cycles to run")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed for the workload + fault streams")
    parser.add_argument(
        "--faults", default="",
        help="fault spec, e.g. 'bind:0.05,node-flap:0.02' (kinds: bind, "
             "node-flap, node-death, evict, solver, crash, solver-exc, "
             "solver-hang, backend-loss, leader-kill)")
    parser.add_argument(
        "--kill-at", default="", metavar="CYCLE:CUT,...",
        help="failover kill drill: hard-stop the leader at the named "
             "cut point of each listed cycle (cuts: pre-solve, "
             "post-solve-pre-drain, mid-bind-drain, mid-close); a "
             "successor takes the lease and runs journal recovery")
    parser.add_argument(
        "--require-kill-cuts", default="", metavar="CUT,...|all",
        help="exit 6 unless a leader kill fired (and its successor "
             "recovered without errors) at every listed cut point "
             "('all' = every known cut)")
    parser.add_argument(
        "--report-out", default=None, metavar="PATH",
        help="write the run's JSON report to PATH (drill artifacts)")
    parser.add_argument("--nodes", type=int, default=12)
    parser.add_argument("--node-cpu-m", type=int, default=8000)
    parser.add_argument("--node-mem-mi", type=int, default=16384)
    parser.add_argument(
        "--queues", default="default:1,batch:2",
        help="comma-separated name:weight queue set")
    parser.add_argument("--arrival-rate", type=float, default=1.5,
                        help="expected job arrivals per cycle")
    parser.add_argument(
        "--arrival-profile", choices=("poisson", "sustained", "burst"),
        default="poisson",
        help="arrival shape: seeded Poisson draws (default), a flat "
             "sustained firehose of round(rate) jobs every cycle, or "
             "Poisson plus a burst spike every --burst-every cycles")
    parser.add_argument("--burst-every", type=int, default=16,
                        help="cycles between burst spikes "
                             "(--arrival-profile burst)")
    parser.add_argument("--burst-size", type=int, default=64,
                        help="jobs per burst spike "
                             "(--arrival-profile burst)")
    parser.add_argument(
        "--max-jobs-in-flight", type=int, default=64,
        help="arrival back-pressure bound (jobs alive at once)")
    parser.add_argument(
        "--node-churn", type=float, default=0.0,
        help="per-cycle probability of a planned node add AND drain")
    parser.add_argument(
        "--serving-rate", type=float, default=0.0,
        help="expected serving-deployment arrivals per cycle (0 keeps "
             "the run batch-only and byte-identical to the pre-serving "
             "event stream)")
    parser.add_argument(
        "--serving-slo", type=float, default=2.0, metavar="SECONDS",
        help="placement-latency SLO target stamped on serving pods "
             "(virtual seconds, tpu-batch/slo-seconds)")
    parser.add_argument(
        "--serving-churn", type=float, default=0.0,
        help="per-cycle probability of replica churn on one running "
             "serving job (rolling-restart analog: one replica deleted "
             "+ a fresh Pending replacement)")
    parser.add_argument(
        "--reserved-frac", type=float, default=1.0,
        help="fraction of nodes labeled reserved capacity (rest spot; "
             "10%% granularity, only labeled when --serving-rate > 0)")
    parser.add_argument(
        "--node-tiers", type=int, default=1,
        help="topology tiers cycled over node indices (node-class "
             "labels, only with --serving-rate > 0)")
    parser.add_argument(
        "--backend", choices=("auto", "dense", "sparse", "native"),
        default="auto",
        help="solver backend routing for the run (env override)")
    parser.add_argument("--topk", type=int, default=None,
                        help="sparse K (with --backend sparse)")
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where allocate_tpu solves (default cuda; cpu runs the "
             "plain versions of the kernels)")
    parser.add_argument("--scheduler-conf", default="",
                        help="YAML policy (default: allocate_tpu,backfill)")
    parser.add_argument("--trace", default=None, metavar="PATH",
                        help="record the run's JSONL trace to PATH")
    parser.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="export a Chrome trace-event JSON of the run's spans to "
             "PATH (open in Perfetto; spans carry virtual timestamps)")
    parser.add_argument(
        "--replay", default=None, metavar="PATH",
        help="replay a recorded trace instead of generating events; "
             "per-cycle placements are verified against the recording")
    parser.add_argument(
        "--replay-cycles", type=int, default=None, metavar="N",
        help="with --replay: stop after the first N recorded cycles "
             "(the soak detectors' replay-bisect entry point)")
    parser.add_argument(
        "--soak", action="store_true",
        help="long-horizon soak mode: record per-cycle telemetry "
             "(resource watermarks, fairness drift), run the "
             "leak/drift detectors over the rollup windows at the "
             "end, dump the telemetry next to the trace (or to "
             "--telemetry-out), and exit 4 on any detector trip")
    parser.add_argument(
        "--telemetry-out", default=None, metavar="PATH",
        help="with --soak: write the telemetry windows + detector "
             "verdict JSON here (default: <trace>.telemetry.json)")
    parser.add_argument(
        "--audit-out", default=None, metavar="PATH",
        help="write the placement decision-audit stream (canonical "
             "JSONL, virtual-clock-stamped — byte-identical under "
             "--replay) here; default: <trace>.audit.jsonl when "
             "--trace is set")
    parser.add_argument(
        "--quality-out", default=None, metavar="PATH",
        help="write the per-cycle placement-quality scorecard stream "
             "(canonical JSONL, obs/quality.py) to PATH — "
             "byte-identical under a same-config --replay")
    parser.add_argument("--no-check", dest="check", action="store_false",
                        default=True, help="skip the invariant checker")
    parser.add_argument("--fail-on-cycle-errors", action="store_true",
                        help="exit 3 if any scheduling cycle raised")
    parser.add_argument(
        "--micro-every", type=int, default=0, metavar="N",
        help="event-driven micro-cycle mode: run the full periodic "
             "cycle only every Nth sim cycle and the bounded warm-path "
             "micro cycle in between (0 disables)")
    parser.add_argument(
        "--period", type=float, default=None, metavar="SECONDS",
        help="virtual seconds per sim cycle (default 1.0). The "
             "congested smokes shrink this to the micro coalescing "
             "window (e.g. 0.005) so each tick IS one micro cycle and "
             "virtual latencies read in wall-SLO units; recorded in "
             "the trace header for replay")
    parser.add_argument(
        "--require-queue-p99", type=float, default=None,
        metavar="SECONDS",
        help="exit 9 unless every queue's arrival→bind total p99 "
             "(virtual clock, obs/latency.py ledger) stays under "
             "SECONDS — and the ledger actually stamped arrivals (a "
             "vacuous run proves nothing)")
    parser.add_argument(
        "--require-warm-subset", action="store_true",
        help="exit 9 unless at least one rank-stable subset solve "
             "engaged (solver_warm_starts_total{outcome=subset}) — a "
             "congested storm that never forms a carried backlog "
             "proves nothing about the subset path")
    parser.add_argument(
        "--max-micro-defer-ratio", type=float, default=None,
        metavar="R",
        help="exit 9 if deferred micro cycles exceed fraction R of "
             "all micro cycles (scheduler_micro_cycles_total by "
             "outcome), or if no micro cycle ran — the congested "
             "steady state must place through the warm/subset path, "
             "not punt to the periodic authority")
    parser.add_argument(
        "--host-devices", type=int, default=0, metavar="N",
        help="virtual shards of the run's --device for the solve's mesh, "
             "set before the first solve (multi-device sharding smokes)")
    parser.add_argument(
        "--antientropy-every", type=int, default=None, metavar="N",
        help="anti-entropy sweep cadence for the run (cycles between "
             "sweeps; 1 = every cycle, recorded in the trace header "
             "for replay; default: the process KBT_ANTIENTROPY_EVERY)")
    parser.add_argument(
        "--require-divergence-repaired", action="store_true",
        help="exit 7 unless every fault-induced divergence was "
             "repaired by run end (report.integrity.unrepaired_end == "
             "0) and at least one event-stream/solver-corrupt fault "
             "actually fired")
    parser.add_argument(
        "--require-sparse-sharded", action="store_true",
        help="exit 5 unless at least one cycle's sparse solve ran "
             "sharded over the device mesh "
             "(solver_sparse_sharded_solves_total)")
    parser.add_argument(
        "--require-device-selection", action="store_true",
        help="exit 8 unless at least one selection pass ran on the "
             "device-resident key matrix "
             "(solver_selection_device_total)")
    parser.add_argument(
        "--min-serving-attainment", type=float, default=None,
        metavar="PCT",
        help="exit 10 unless serving-class SLO attainment "
             "(report.latency.serving, obs/latency.py) is at least PCT "
             "percent")
    parser.add_argument(
        "--max-serving-violations", type=int, default=None, metavar="N",
        help="exit 10 if more than N serving placements missed their "
             "SLO target")
    parser.add_argument(
        "--require-serving-engaged", action="store_true",
        help="exit 10 unless at least one SLO-targeted serving "
             "placement landed — a mix that never exercised the "
             "serving path proves nothing")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress the JSON report on stdout")


def parse_kill_plan(spec: str) -> dict:
    """``"5:pre-solve,9:mid-close"`` → ``{5: "pre-solve", ...}``.
    Unknown cuts are hard errors (same typo discipline as the fault
    spec)."""
    from .failover import CUT_POINTS

    plan = {}
    for term in (spec or "").split(","):
        term = term.strip()
        if not term:
            continue
        cycle_s, sep, cut = term.partition(":")
        cut = cut.strip()
        if not sep or cut not in CUT_POINTS:
            raise ValueError(
                f"bad --kill-at term {term!r} "
                f"(cuts: {', '.join(CUT_POINTS)})"
            )
        plan[int(cycle_s)] = cut
    return plan


def config_from_args(ns: argparse.Namespace) -> SimConfig:
    queues = {}
    for term in ns.queues.split(","):
        term = term.strip()
        if not term:
            continue
        name, _, weight = term.partition(":")
        queues[name] = int(weight or 1)
    workload = WorkloadSpec(
        nodes=ns.nodes,
        node_cpu_m=ns.node_cpu_m,
        node_mem_mi=ns.node_mem_mi,
        queues=queues or {"default": 1},
        arrival_rate=ns.arrival_rate,
        arrival_profile=ns.arrival_profile,
        burst_every=ns.burst_every,
        burst_size=ns.burst_size,
        max_jobs_in_flight=ns.max_jobs_in_flight,
        node_add_rate=ns.node_churn,
        node_drain_rate=ns.node_churn,
        serving_rate=ns.serving_rate,
        serving_slo_s=ns.serving_slo,
        serving_churn=ns.serving_churn,
        reserved_frac=ns.reserved_frac,
        node_tiers=ns.node_tiers,
    )
    # Replay normalization (cycles/seed/faults/period from the trace
    # header) is owned by ClusterSimulator.__init__ — single site.
    replay = TraceReader.load(ns.replay) if ns.replay else None
    return SimConfig(
        cycles=ns.cycles,
        seed=ns.seed,
        faults=ns.faults,
        **({"period": ns.period} if ns.period is not None else {}),
        workload=workload,
        conf=ns.scheduler_conf or SIM_DEFAULT_CONF,
        backend=ns.backend,
        topk=ns.topk,
        trace_path=ns.trace,
        trace_out=ns.trace_out,
        replay=replay,
        replay_limit=ns.replay_cycles,
        micro_every=ns.micro_every,
        antientropy_every=ns.antientropy_every,
        kill_plan=parse_kill_plan(ns.kill_at),
        check_invariants=ns.check,
        soak=ns.soak,
        telemetry_out=ns.telemetry_out,
        audit_out=ns.audit_out,
        quality_out=ns.quality_out,
        device=ns.device,
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpu-batch sim",
        description="deterministic long-horizon cluster simulator",
    )
    add_sim_flags(parser)
    ns = parser.parse_args(argv)
    try:
        resolve_device(ns.device)
    except RuntimeError:
        print(
            f"tpu-batch: sim --device {ns.device}: no CUDA device is "
            "available; pass --device cpu to run the plain versions on "
            "the CPU",
            file=sys.stderr,
        )
        return 11
    if ns.host_devices:
        # Before the harness's first solve: every default mesh of the run
        # repeats the device this many times.
        set_host_device_count(ns.host_devices)
    cfg = config_from_args(ns)

    sim = ClusterSimulator(cfg)
    report = sim.run()

    out = report.to_dict()
    out["seed"] = cfg.seed
    out["backend"] = cfg.backend
    out["faults"] = cfg.faults
    out["replayed"] = cfg.replay is not None
    sharded_solves = None
    if ns.require_sparse_sharded:
        from .. import metrics

        sharded_solves = int(metrics.solver_sparse_sharded.total())
        out["sparse_sharded_solves"] = sharded_solves
    device_selections = None
    if ns.require_device_selection:
        from .. import metrics

        device_selections = int(metrics.solver_selection_device.total())
        out["device_selections"] = device_selections
    micro_outcomes = None
    if ns.max_micro_defer_ratio is not None:
        from .. import metrics

        micro_outcomes = {
            o: int(metrics.scheduler_micro_cycles.get((o,)))
            for o in ("solve", "noop", "deferred")
        }
        out["micro_outcomes"] = micro_outcomes
    subset_solves = None
    if ns.require_warm_subset:
        from ..metrics.metrics import solver_warm_starts

        subset_solves = int(solver_warm_starts.get(("subset",)))
        out["warm_subset_solves"] = subset_solves
    if ns.report_out:
        with open(ns.report_out, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
            f.write("\n")
    if not ns.quiet:
        print(json.dumps(out, indent=2, sort_keys=True))

    if report.violations:
        print(
            f"sim: {len(report.violations)} invariant violation(s)",
            file=sys.stderr,
        )
        return 1
    if report.replay_mismatches:
        print(
            f"sim: replay diverged at cycles "
            f"{report.replay_mismatches[:10]}",
            file=sys.stderr,
        )
        return 2
    if report.quality_mismatches:
        print(
            f"sim: quality scorecard diverged under replay at cycles "
            f"{report.quality_mismatches[:10]}",
            file=sys.stderr,
        )
        return 2
    if ns.fail_on_cycle_errors and report.cycle_errors:
        print(
            f"sim: {report.cycle_errors} scheduling cycle error(s)",
            file=sys.stderr,
        )
        return 3
    if report.soak and report.soak.get("tripped"):
        print(
            f"sim: soak detector(s) tripped: "
            f"{', '.join(report.soak['tripped'])}",
            file=sys.stderr,
        )
        for hint in report.soak.get("replay_bisect", []):
            print(f"sim:   {hint}", file=sys.stderr)
        return 4
    if ns.require_sparse_sharded and not sharded_solves:
        print(
            "sim: no cycle solved through the sharded sparse path "
            "(--require-sparse-sharded)",
            file=sys.stderr,
        )
        return 5
    if ns.require_device_selection and not device_selections:
        print(
            "sim: no selection pass ran on the device-resident key "
            "matrix (--require-device-selection)",
            file=sys.stderr,
        )
        return 8
    if ns.require_kill_cuts:
        from .failover import CUT_POINTS

        wanted = (
            list(CUT_POINTS) if ns.require_kill_cuts.strip() == "all"
            else [c.strip() for c in ns.require_kill_cuts.split(",")
                  if c.strip()]
        )
        fired = {f["cut"] for f in report.failovers}
        missing = [c for c in wanted if c not in fired]
        if missing or report.recovery_failures:
            print(
                f"sim: failover drill incomplete — missing cuts "
                f"{missing}, recovery failures "
                f"{report.recovery_failures} (--require-kill-cuts)",
                file=sys.stderr,
            )
            return 6
    if ns.require_divergence_repaired:
        from .faults import EVENT_FAULT_KINDS

        integrity = report.integrity or {}
        injected = sum(
            report.fault_counts.get(k, 0)
            for k in EVENT_FAULT_KINDS + ("relist-fail", "solver-corrupt")
        )
        unrepaired = integrity.get("unrepaired_end", -1)
        if unrepaired != 0 or injected == 0:
            print(
                f"sim: divergence-repair assert failed — "
                f"unrepaired_end={unrepaired}, "
                f"event/corrupt faults injected={injected} "
                f"(--require-divergence-repaired)",
                file=sys.stderr,
            )
            return 7
    if ns.require_queue_p99 is not None:
        latency = report.latency or {}
        queue_p99 = latency.get("queue_p99_s") or {}
        applied = latency.get("applied", 0)
        # queue_p99_s omits all-zero queues (sub-tick placement on the
        # virtual clock is exactly 0.0s), so an empty dict with binds
        # applied means every queue beat the bound.
        worst = max(queue_p99.values(), default=0.0)
        if not applied or worst > ns.require_queue_p99:
            print(
                f"sim: congested p99 assert failed — per-queue total "
                f"p99 {queue_p99} (worst {worst}) vs bound "
                f"{ns.require_queue_p99}s, applied={applied} "
                f"(--require-queue-p99)",
                file=sys.stderr,
            )
            return 9
    if ns.require_warm_subset and not subset_solves:
        print(
            "sim: no rank-stable subset solve engaged "
            "(--require-warm-subset)",
            file=sys.stderr,
        )
        return 9
    if ns.max_micro_defer_ratio is not None:
        ran = sum(micro_outcomes.values())
        deferred = micro_outcomes["deferred"]
        if not ran or deferred > ns.max_micro_defer_ratio * ran:
            print(
                f"sim: micro defer-ratio assert failed — "
                f"{micro_outcomes} → deferred {deferred}/{ran} vs "
                f"bound {ns.max_micro_defer_ratio} "
                f"(--max-micro-defer-ratio)",
                file=sys.stderr,
            )
            return 9
    if (
        ns.min_serving_attainment is not None
        or ns.max_serving_violations is not None
        or ns.require_serving_engaged
    ):
        serving = (report.latency or {}).get("serving") or {}
        cls = serving.get("classes", {}).get("serving", {})
        placed = cls.get("placed", 0)
        attainment = cls.get("attainment_pct", 100.0)
        violations = serving.get("violations", 0)
        if ns.require_serving_engaged and not placed:
            print(
                "sim: no SLO-targeted serving placement landed "
                "(--require-serving-engaged)",
                file=sys.stderr,
            )
            return 10
        if (
            ns.min_serving_attainment is not None
            and attainment < ns.min_serving_attainment
        ):
            print(
                f"sim: serving SLO attainment {attainment}% under the "
                f"{ns.min_serving_attainment}% floor over {placed} "
                f"targeted placements (--min-serving-attainment)",
                file=sys.stderr,
            )
            return 10
        if (
            ns.max_serving_violations is not None
            and violations > ns.max_serving_violations
        ):
            print(
                f"sim: {violations} serving SLO violation(s) exceed "
                f"the bound {ns.max_serving_violations} "
                f"(--max-serving-violations)",
                file=sys.stderr,
            )
            return 10
    return 0
