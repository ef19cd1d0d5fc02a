"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload kb5k-storm --seed 7 --seconds 48 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the program (``kube_batch_tpu_torch``). The cell names a
configuration (``benchmark/configs/<name>.json``) and a traffic mix
(``benchmark/traffic/<name>.json``); with ``--trace 1`` each per-layer
metric of the cell is read by ``benchmark/metrics/<metric>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, last,
``checks``: every number the reference compared, beside its limit. The
same numbers are the last lines of standard error.

Exits non-zero, printing no result, without a CUDA device, with fewer
devices than the cell asks for, or when the process has loaded JAX or
the JAX package. ``--control`` puts the benchmark's control scheduler
in the program's place (the check that the comparison fails it); no
measured run uses it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One process with few threads: the host's math libraries run on the
# calling thread, so their worker pools do not contend with the loop,
# the informer and the binds for the machine's cores. Set before numpy
# or torch is imported.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Top-level module names the process may not hold once the window has
# closed, compared whole: the program's own name begins with the last.
FORBIDDEN = ("jax", "jaxlib", "flax", "kube_batch_tpu")


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic mix and metrics, each resolved from its own file."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metric):
        return name in metric.get("workloads", [name])

    return {
        "cell": cell, "config": config, "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def forbidden_modules() -> list:
    loaded = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def finite_ms(value: float, fallback: float) -> float:
    """A percentile that lands on a pod never bound reads as the time
    from its due time to the end of the grace period (a lower bound);
    the run is then not correct."""
    return fallback if math.isinf(value) else value


def end_to_end_values(rec: dict) -> dict:
    """Every end-to-end number a run can report, whether or not its cell
    lists it."""
    from . import reference

    lat = rec["latency_ms"]
    grace_ms = (rec["t_closed"] - rec["t0"] + rec["phases"]["drain_s"]) * 1e3
    values = {
        "pod_sched_p50_ms": finite_ms(reference.percentile(lat, 50), grace_ms),
        "pod_sched_p95_ms": finite_ms(reference.percentile(lat, 95), grace_ms),
        "loop_busy_pct": 100.0 * rec["busy_s"] / rec["window_s"],
        "setup_s": rec["setup_s"],
    }
    return values


def end_to_end(values: dict, metrics: list) -> dict:
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in metrics}


def per_layer(rec: dict, tracing, metrics: list):
    from . import readings

    ctx = readings.Context((rec["t0"], rec["t_closed"]), rec["cycles"],
                           rec["log"], tracing)
    out = {}
    for m in metrics:
        value = readings.load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {}
    if tracing.profiled is not None:
        lo, hi = tracing.profiled
        device = {
            "busy_s": readings.union_length(
                [(a, b) for _, a, b in tracing.kernels], lo, hi),
            "window_s": hi - lo,
        }
    return out, device, readings.breakdown(ctx)


def roofline_kernel(metrics: list):
    for m in metrics:
        if m["name"].endswith("_roofline"):
            return m["name"][: -len("_roofline")]
    return None


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def main(argv=None, device: str = "cuda", root: Path = ROOT,
         t_start: float = None, patch=None) -> int:
    """``device`` and ``patch(cell)`` (a hook run before the window's
    program is built) are for the benchmark's own tests, which drive a
    run on the CPU; a measured run takes neither."""
    args = parse_args(argv)
    t_start = T_START if t_start is None else t_start
    spec = load_cell(args.workload, root)
    cell, config, traffic = spec["cell"], spec["config"], spec["traffic"]

    import torch

    kind = "cpu"
    if device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: nothing measured", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"the cell needs {cell['chips']} devices, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        torch.cuda.init()
        kind = torch.cuda.get_device_name(0)

    from . import control, harness, reference, trace

    factory = control.factory if args.control else None
    if patch is not None:
        patch(spec)
    tracing = None
    if args.trace:
        tracing = trace.Tracing(roofline_kernel(spec["per_layer"]), device)
    rec = harness.run(
        config, traffic, args.seed, args.seconds, device=device,
        t_start=t_start, scheduler_factory=factory,
        tracing=tracing,
    )
    if rec["loop_alive_after_stop"]:
        print("harness fault: the loop did not stop", file=sys.stderr)
        return 4
    for err in rec["event_errors"]:
        print(f"event refused: {err}", file=sys.stderr)
    if tracing is not None:
        tracing.finish()
    checks = reference.judge(rec["counts"])

    harness.log(
        f"phases {json.dumps({k: round(v, 3) if isinstance(v, float) else v for k, v in rec['phases'].items()})}")
    harness.log(
        f"feeder late s: mean {rec['feeder_late_s']['mean']:.4f} "
        f"max {rec['feeder_late_s']['max']:.4f}; storms {rec['plan']['storms']} "
        f"of {rec['plan']['storm_pods']} pods; pods/s {rec['plan']['pods_per_s']:.1f}; "
        f"cycles {len(rec['cycles'])}; evictions {rec['evictions']}; "
        f"backlog at each storm {rec['backlog']}")
    harness.log(f"each storm's p50 / p95 / max ms {rec['storm_ms']}")
    values = end_to_end_values(rec)
    harness.log("end to end " + json.dumps(values))
    harness.log("cycles in the window (kind, start s, ms, placed, rounds, "
                "warm outcome): " + " ".join(
                    f"{c['kind'][0]}@{c['t0'] - rec['t0']:.2f}/"
                    f"{(c['t1'] - c['t0']) * 1e3:.0f}/{c.get('placed', 0)}/"
                    f"{c.get('stats', {}).get('rounds', '-')}/"
                    f"{c.get('stats', {}).get('warm_outcome', '-')}"
                    for c in rec["cycles"]
                    if "t1" in c and rec["t0"] <= c["t0"] < rec["t_closed"]))
    device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": kind, "count": cell["chips"] if device == "cuda" else 1,
                   "memory_peak_bytes": rec["memory_peak_bytes"] or 0}
    out = {"correct": reference.correct(checks),
           "attempted": rec["attempted"], "failed": rec["failed"]}
    if args.trace:
        metrics, dev_trace, brk = per_layer(rec, tracing, spec["per_layer"])
        device_info.update(dev_trace)
        out["metrics"] = metrics
        out["device"] = device_info
        if brk is not None:
            out["breakdown"] = brk
        if tracing.kernel_ms is not None:
            harness.log(f"{tracing.kernel}: {tracing.kernel_rows} rows, "
                        f"{tracing.kernel_ms:.6f} ms, work {tracing.kernel_work}")
    else:
        out["metrics"] = end_to_end(values, spec["end_to_end"])
        out["device"] = device_info
    out["checks"] = checks

    bad = forbidden_modules()
    if bad:
        print(f"loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
