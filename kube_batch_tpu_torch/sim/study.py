"""Multi-seed paired A/B placement-quality study.

``python -m kube_batch_tpu_torch sim-study`` runs the SAME seeded workload
trace under two configurations (the arms), pairs the per-seed quality
summaries, and reports per-seed deltas plus a median/IQR roll-up and an
explicit gating verdict — the artifact format ROADMAP's "two-level by
default" decision consumes (the committed ``QUALITY_r20.json`` is one
such study).

Design:

- **Paired, not pooled.** Both arms of a seed see the byte-identical
  arrival/churn stream (``WorkloadGenerator`` is a pure function of
  ``(spec, seed)``), so the per-seed delta cancels workload variance and
  a handful of seeds carries real signal. The roll-up is median/IQR over
  the per-seed deltas, never a mean over pooled runs.
- **Process isolation.** Every (seed, arm) runs as its own
  ``python -m kube_batch_tpu_torch sim`` subprocess on the study's
  ``--device``: the arm knobs are env vars, so in-process arm switching
  would silently leak config between runs. The pool fans
  subprocesses, results are assembled in seed order, and the output
  contains no wall-clock — same seeds, same arms → byte-identical JSON
  (a pinned test).
- **Quality source.** Each run's ``--report-out`` JSON carries the sim
  harness's ``quality`` summary (per-cycle scorecard medians,
  sim/harness.py ``_finish_quality``); the study pairs those medians.

Presets:

- ``twolevel`` — flat vs two-level rack-aligned sparse sharding
  (``KBT_SPARSE_SHARD_MODE``) on a 4-device virtual host mesh: the
  two-level-by-default gating study.
- ``topk`` — sparse candidate width K=32 vs K=64
  (``--topk``): does the wider candidate set buy placement quality?

A copy of the JAX package's ``sim/study.py``. The presets drop the
reference's ``KBT_SOLVER=jax`` base env (the port's sparse backend
solves on the device already); ``twolevel``'s ``--host-devices 4`` runs
each leg on a mesh of 4 virtual shards of the study's ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..device import resolve_device

# Metrics paired per seed: report.quality medians (plus the run's total
# placements). Higher-is-better for density/jain/placements,
# lower-is-better for churn/emptiable — the verdict only gates on the
# first two; the rest are reported for the record.
STUDY_METRICS = (
    "density_dom",
    "fairness_jain",
    "churn_per_placement",
    "emptiable_frac",
    "placements",
)

# Gating tolerances (median delta B−A): the B arm keeps its default if
# it does not regress packing density or fairness beyond these.
DENSITY_TOL = 0.01
JAIN_TOL = 0.02


@dataclass(frozen=True)
class Arm:
    name: str
    env: Tuple[Tuple[str, str], ...] = ()
    flags: Tuple[str, ...] = ()

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "env": dict(self.env),
            "flags": list(self.flags),
        }


@dataclass(frozen=True)
class Preset:
    question: str
    a: Arm
    b: Arm
    base_env: Tuple[Tuple[str, str], ...] = ()
    base_flags: Tuple[str, ...] = ()
    # Verdict labels: what a pass/fail of the gating criterion MEANS.
    keep: str = "keep-b-default"
    revisit: str = "revisit-b-default"


PRESETS: Dict[str, Preset] = {
    "twolevel": Preset(
        question=(
            "does two-level rack-aligned sparse sharding (the default) "
            "place at least as well as flat sharding?"
        ),
        a=Arm("flat", (("KBT_SPARSE_SHARD_MODE", "flat"),)),
        b=Arm("two-level", (("KBT_SPARSE_SHARD_MODE", "two-level"),)),
        base_flags=(
            "--backend", "sparse", "--topk", "8", "--host-devices", "4",
        ),
        keep="keep-two-level-default",
        revisit="revisit-two-level-default",
    ),
    "topk": Preset(
        question=(
            "does doubling the sparse candidate width (K=64 vs K=32) "
            "buy placement quality?"
        ),
        a=Arm("k32", flags=("--topk", "32")),
        b=Arm("k64", flags=("--topk", "64")),
        base_flags=("--backend", "sparse"),
    ),
}


@dataclass
class StudyConfig:
    preset: str = "twolevel"
    seeds: Sequence[int] = field(default_factory=lambda: range(5))
    cycles: int = 60
    nodes: int = 12
    arrival_rate: float = 1.5
    max_jobs_in_flight: int = 64
    workers: int = 2
    timeout: float = 900.0
    device: str = "cuda"


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolation quantile over an ascending list (the
    ``statistics.quantiles`` inclusive method, without its n>=2
    restriction)."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    if n == 1:
        return sorted_vals[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def _arm_metrics(report: dict) -> Dict[str, float]:
    quality = report.get("quality") or {}

    def med(key: str) -> float:
        return float((quality.get(key) or {}).get("median", 0.0))

    return {
        "density_dom": round(med("density_dom"), 6),
        "fairness_jain": round(med("jain"), 6),
        "churn_per_placement": round(med("churn_per_placement"), 6),
        "emptiable_frac": round(med("emptiable_frac"), 6),
        "placements": float(report.get("placements", 0)),
    }


def _run_sim(
    cfg: StudyConfig, preset: Preset, arm: Arm, seed: int
) -> dict:
    """One (seed, arm) leg as a subprocess; returns the parsed
    --report-out JSON. Raises on a nonzero exit (an invariant violation
    in EITHER arm invalidates the whole study)."""
    env = dict(os.environ)
    env.update(dict(preset.base_env))
    env.update(dict(arm.env))
    with tempfile.TemporaryDirectory(prefix="kbt-study-") as tmp:
        report_path = os.path.join(tmp, "report.json")
        cmd = [
            sys.executable, "-m", "kube_batch_tpu_torch", "sim",
            "--device", cfg.device,
            "--cycles", str(cfg.cycles),
            "--seed", str(seed),
            "--nodes", str(cfg.nodes),
            "--arrival-rate", str(cfg.arrival_rate),
            "--max-jobs-in-flight", str(cfg.max_jobs_in_flight),
            "--quiet",
            "--report-out", report_path,
            *preset.base_flags,
            *arm.flags,
        ]
        proc = subprocess.run(
            cmd, env=env, capture_output=True, text=True,
            timeout=cfg.timeout,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"study leg failed (seed={seed}, arm={arm.name}, "
                f"exit={proc.returncode}):\n{proc.stderr[-2000:]}"
            )
        with open(report_path) as f:
            return json.load(f)


def build_study(
    cfg: StudyConfig,
    runner: Optional[Callable[..., dict]] = None,
) -> dict:
    """Run the full paired study and return the artifact dict.
    ``runner(cfg, preset, arm, seed) -> report`` is injectable so the
    paired-stats path is testable without subprocesses."""
    preset = PRESETS[cfg.preset]
    runner = runner or _run_sim
    seeds = sorted(set(int(s) for s in cfg.seeds))
    legs = [
        (seed, which, arm)
        for seed in seeds
        for which, arm in (("a", preset.a), ("b", preset.b))
    ]
    results: Dict[Tuple[int, str], dict] = {}
    with ThreadPoolExecutor(max_workers=max(1, cfg.workers)) as pool:
        futures = {
            pool.submit(runner, cfg, preset, arm, seed): (seed, which)
            for seed, which, arm in legs
        }
        for future, key in futures.items():
            results[key] = future.result()

    per_seed = []
    deltas: Dict[str, List[float]] = {m: [] for m in STUDY_METRICS}
    for seed in seeds:
        a = _arm_metrics(results[(seed, "a")])
        b = _arm_metrics(results[(seed, "b")])
        delta = {
            m: round(b[m] - a[m], 6) for m in STUDY_METRICS
        }
        for m in STUDY_METRICS:
            deltas[m].append(delta[m])
        per_seed.append({"seed": seed, "a": a, "b": b, "delta": delta})

    summary = {}
    for m in STUDY_METRICS:
        vals = sorted(deltas[m])
        summary[m] = {
            "p25": round(_quantile(vals, 0.25), 6),
            "median": round(_quantile(vals, 0.5), 6),
            "p75": round(_quantile(vals, 0.75), 6),
            "min": round(vals[0], 6),
            "max": round(vals[-1], 6),
        }

    density_delta = summary["density_dom"]["median"]
    jain_delta = summary["fairness_jain"]["median"]
    passed = (
        density_delta >= -DENSITY_TOL and jain_delta >= -JAIN_TOL
    )
    verdict = {
        "criterion": (
            f"median paired delta (b−a): density_dom >= -{DENSITY_TOL} "
            f"and fairness_jain >= -{JAIN_TOL}"
        ),
        "density_dom_median_delta": density_delta,
        "fairness_jain_median_delta": jain_delta,
        "pass": passed,
        "verdict": preset.keep if passed else preset.revisit,
    }

    return {
        "type": "quality-study",
        "preset": cfg.preset,
        "question": preset.question,
        "arms": {"a": preset.a.to_dict(), "b": preset.b.to_dict()},
        "base": {
            "env": dict(preset.base_env),
            "flags": list(preset.base_flags),
        },
        "config": {
            "cycles": cfg.cycles,
            "nodes": cfg.nodes,
            "arrival_rate": cfg.arrival_rate,
            "max_jobs_in_flight": cfg.max_jobs_in_flight,
            "seeds": seeds,
        },
        "per_seed": per_seed,
        "summary": summary,
        "verdict": verdict,
    }


def render(study: dict) -> str:
    """Canonical artifact rendering: sorted keys, stable indentation,
    no wall-clock anywhere — same seeds, same arms → same bytes."""
    return json.dumps(study, indent=2, sort_keys=True) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpu-batch sim-study",
        description="multi-seed paired A/B placement-quality study",
    )
    parser.add_argument(
        "--preset", choices=sorted(PRESETS), default="twolevel",
        help="which A/B question to run (default: twolevel — flat vs "
             "two-level sparse sharding)")
    parser.add_argument("--seeds", type=int, default=5,
                        help="number of paired seeds (seed-base..+N-1)")
    parser.add_argument("--seed-base", type=int, default=0,
                        help="first seed of the paired range")
    parser.add_argument("--cycles", type=int, default=60,
                        help="sim cycles per leg")
    parser.add_argument("--nodes", type=int, default=12,
                        help="cluster size per leg")
    parser.add_argument("--arrival-rate", type=float, default=1.5,
                        help="expected job arrivals per cycle")
    parser.add_argument("--max-jobs-in-flight", type=int, default=64,
                        help="arrival back-pressure bound per leg")
    parser.add_argument("--workers", type=int, default=2,
                        help="concurrent sim subprocesses")
    parser.add_argument("--timeout", type=float, default=900.0,
                        help="per-leg subprocess timeout (seconds)")
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where every leg solves (default cuda)")
    parser.add_argument("--out", default=None, metavar="PATH",
                        help="write the study JSON to PATH")
    parser.add_argument(
        "--gate", action="store_true",
        help="exit 3 when the gating verdict fails (acceptance runs; "
             "without it the study is evidence and always exits 0)")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress the study JSON on stdout")
    ns = parser.parse_args(argv)
    try:
        resolve_device(ns.device)
    except RuntimeError:
        print(
            f"tpu-batch: sim-study --device {ns.device}: no CUDA device "
            "is available; pass --device cpu to run the plain versions "
            "on the CPU",
            file=sys.stderr,
        )
        return 11

    cfg = StudyConfig(
        preset=ns.preset,
        seeds=range(ns.seed_base, ns.seed_base + ns.seeds),
        cycles=ns.cycles,
        nodes=ns.nodes,
        arrival_rate=ns.arrival_rate,
        max_jobs_in_flight=ns.max_jobs_in_flight,
        workers=ns.workers,
        timeout=ns.timeout,
        device=ns.device,
    )
    try:
        study = build_study(cfg)
    except RuntimeError as exc:
        print(f"sim-study: {exc}", file=sys.stderr)
        return 1
    text = render(study)
    if ns.out:
        with open(ns.out, "w") as f:
            f.write(text)
    if not ns.quiet:
        print(text, end="")
    if ns.gate and not study["verdict"]["pass"]:
        print(
            f"sim-study: gating verdict failed — "
            f"{study['verdict']['verdict']}",
            file=sys.stderr,
        )
        return 3
    return 0
