"""Parity of the port's simulator (``kube_batch_tpu_torch.sim``) with the
JAX package's, on the CPU.

Every run goes through a subprocess of its package, as
``tests/test_torch_cli.py`` runs the process layer: a driver per package
and stage runs a list of ``SimConfig`` jobs and writes each job's report
and trace. The JAX side runs with ``JAX_PLATFORMS=cpu
KBT_SELECT_DEVICE=0`` on one device (its device selection calls the
``enable_x64`` that JAX 0.9 removed); the port on ``device="cpu"`` with
``use_kernel=False`` set on its registered ``allocate_tpu``:
the plain six-commit chain, which equals the JAX package's default
chain (its Pallas pass runs only on a TPU). The port's kernel path is
held against the same recordings through a replay.

Tolerance: none. Trace records after the header are compared byte for
byte as canonical JSON, the quality card of each through
``obs.quality.replay_view`` (which drops the path-dependent solver
deltas). Reports are compared key for key, apart from wall-clock
fields.

- generate mode: seed 5, 60 cycles, dense, the smoke faults of
  ``tests/sim/test_sim_smoke.py``, equal records;
- cross-package replay: the JAX trace replays in the port, and the
  port's trace in the JAX package, under ``dense`` and under ``sparse``
  at K=16, with no mismatch;
- chaos: ``solver-exc``, ``solver-hang`` and ``solver-corrupt`` beside
  bind faults: equal fault counts, breaker trips and placements;
- a ``kill_plan`` failover drill: equal successors and placements;
- the ``native`` backend: equal placement counts;
- ``python -m <pkg> sim ... --report-out`` and ``sim-study --preset
  topk``: equal JSON apart from wall times (and the study's base env,
  where the reference sets ``KBT_SOLVER=jax``).
"""

import json
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKGS = ("kube_batch_tpu", "kube_batch_tpu_torch")
SMOKE_FAULTS = "bind:0.05,node-flap:0.02"
SMOKE = dict(cycles=60, seed=5, faults=SMOKE_FAULTS, backend="dense",
             workload=dict(nodes=10, arrival_rate=1.2))
CHAOS = dict(cycles=40, seed=11, backend="dense",
             faults="solver-exc:0.1,solver-hang:0.03,solver-corrupt:0.08,"
                    "bind:0.05",
             workload=dict(nodes=10, arrival_rate=1.2))
DRILL = dict(cycles=16, seed=7, backend="dense", faults="bind:0.03",
             kill_plan={"6": "mid-bind-drain"})
NATIVE = dict(cycles=30, seed=5, faults="bind:0.05", backend="native",
              workload=dict(nodes=10, arrival_rate=1.2))

# One package's jobs: each is a SimConfig (workload as a dict, replay as
# the path of a JSONL trace), run in order in one process. Writes
# {name: {"report", "records", "counts"}} to argv[3]; "records" are the
# canonical records after the header with replay_view'ed quality cards.
DRIVER = r"""
import json, sys
pkg, jobs_path, out_path = sys.argv[1:4]
import importlib
if pkg.endswith("_torch"):
    import kube_batch_tpu_torch.actions
    from kube_batch_tpu_torch.framework import get_action
    action = get_action("allocate_tpu")[0]
sim = importlib.import_module(pkg + ".sim")
harness = importlib.import_module(pkg + ".sim.harness")
trace_mod = importlib.import_module(pkg + ".sim.trace")
quality = importlib.import_module(pkg + ".obs.quality")
out = {}
for job in json.load(open(jobs_path)):
    cfg = dict(job["cfg"])
    if "workload" in cfg:
        cfg["workload"] = sim.WorkloadSpec(**cfg["workload"])
    if "kill_plan" in cfg:
        cfg["kill_plan"] = {int(c): cut for c, cut in cfg["kill_plan"].items()}
    if cfg.get("replay"):
        cfg["replay"] = sim.TraceReader.load(cfg["replay"])
    if pkg.endswith("_torch"):
        cfg.setdefault("device", "cpu")
        action.use_kernel = cfg.pop("use_kernel", False)
    cfg["trace_path"] = job["trace"]
    report, trace = harness.run_sim(sim.SimConfig(**cfg))
    records = []
    for rec in trace[1:]:
        rec = dict(rec)
        if "quality" in rec:
            rec["quality"] = quality.replay_view(rec["quality"])
        records.append(trace_mod.canon(rec))
    out[job["name"]] = {"report": report.to_dict(), "records": records,
                        "counts": trace_mod.placement_counts(trace[1:])}
json.dump(out, open(out_path, "w"))
"""


def child_env(pkg):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")
           and not k.startswith("KBT_")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    if pkg == PKGS[0]:
        env["KBT_SELECT_DEVICE"] = "0"
    return env


def run_jobs(pkg, jobs, tmp):
    """Run ``jobs`` through the driver in a subprocess of ``pkg``."""
    tag = f"{pkg}-{jobs[0]['name']}"
    for job in jobs:
        job["trace"] = str(tmp / f"{pkg}-{job['name']}.jsonl")
    jobs_path, out_path = tmp / f"{tag}.jobs.json", tmp / f"{tag}.out.json"
    jobs_path.write_text(json.dumps(jobs))
    proc = subprocess.run(
        [sys.executable, "-c", DRIVER, pkg, str(jobs_path), str(out_path)],
        capture_output=True, text=True, cwd=REPO, env=child_env(pkg),
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out_path.read_text())


# ``python -m kube_batch_tpu_torch`` with the plain chain: the registered
# allocate_tpu is the one every scheduler of the process solves with.
PORT_MAIN = r"""
import kube_batch_tpu_torch.actions
from kube_batch_tpu_torch.framework import get_action
get_action("allocate_tpu")[0].use_kernel = False
import runpy, sys
sys.argv = ["kube_batch_tpu_torch", *sys.argv[1:]]
runpy.run_module("kube_batch_tpu_torch", run_name="__main__")
"""


def run_cli(pkg, argv, tmp, name):
    """``python -m <pkg> sim ... --report-out``, the port on the CPU."""
    out = tmp / f"{pkg}-{name}.json"
    cmd = ([sys.executable, "-m", pkg] if pkg == PKGS[0] else
           [sys.executable, "-c", PORT_MAIN, "--device", "cpu"])
    proc = subprocess.run(
        [*cmd[:3], *argv, *cmd[3:], "--report-out", str(out)],
        capture_output=True, text=True, cwd=REPO, env=child_env(pkg),
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def run_study(pkg, argv, tmp, name):
    """``sim-study``: the JAX package's CLI, and the port's study with
    each leg a plain-chain ``sim`` on the CPU (``build_study``'s
    runner)."""
    out = tmp / f"{pkg}-{name}.json"
    if pkg == PKGS[0]:
        proc = subprocess.run(
            [sys.executable, "-m", pkg, *argv, "--out", str(out)],
            capture_output=True, text=True, cwd=REPO, env=child_env(pkg),
            timeout=600,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads(out.read_text())
    from kube_batch_tpu_torch.sim import study

    def leg(cfg, preset, arm, seed):
        report = tmp / f"{name}-{arm.name}-{seed}.json"
        proc = subprocess.run(
            [sys.executable, "-c", PORT_MAIN, "sim", "--device", "cpu",
             "--cycles", str(cfg.cycles), "--seed", str(seed),
             "--nodes", str(cfg.nodes),
             "--arrival-rate", str(cfg.arrival_rate),
             "--max-jobs-in-flight", str(cfg.max_jobs_in_flight),
             "--quiet", "--report-out", str(report),
             *preset.base_flags, *arm.flags],
            capture_output=True, text=True, cwd=REPO,
            env=dict(child_env(pkg), **dict(preset.base_env, **dict(
                arm.env))), timeout=600,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads(report.read_text())

    opts = dict(zip(argv[1::2], argv[2::2]))
    cfg = study.StudyConfig(
        preset=opts["--preset"], seeds=range(int(opts["--seeds"])),
        cycles=int(opts["--cycles"]), workers=int(opts["--workers"]),
        device="cpu")
    return json.loads(study.render(study.build_study(cfg, runner=leg)))


CLI_SIM = ["sim", "--cycles", "20", "--seed", "3", "--backend", "dense",
           "--faults", "bind:0.05,evict:0.05", "--quiet"]
CLI_STUDY = ["sim-study", "--preset", "topk", "--seeds", "1", "--cycles",
             "12", "--workers", "2"]


def replay_jobs(trace, kernels=False):
    """Replays of ``trace`` under dense and sparse at K=16 (on the port,
    ``kernels`` runs them through the bid kernels instead)."""
    return [{"name": f"{'kernels' if kernels else 'replay'}-{b}",
             "cfg": {"replay": trace, "backend": b,
                     **({"topk": 16} if b == "sparse" else {}),
                     **({"use_kernel": True} if kernels else {})}}
            for b in ("dense", "sparse")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package generates the smoke run first and the chaos, drill
    and native runs beside it, and runs the two CLIs; once both smoke
    traces exist, each package replays the other one's (the port also
    through its kernels)."""
    tmp = tmp_path_factory.mktemp("sim")
    smoke = {pkg: str(tmp / f"{pkg}-smoke.jsonl") for pkg in PKGS}
    rest = [{"name": n, "cfg": c} for n, c in (
        ("chaos", CHAOS), ("drill", DRILL), ("native", NATIVE))]
    with ThreadPoolExecutor(max_workers=8) as pool:
        def submit(fn, *args):
            return {pkg: pool.submit(fn, pkg, *args) for pkg in PKGS}

        gen_smoke = submit(lambda pkg: run_jobs(
            pkg, [{"name": "smoke", "cfg": SMOKE}], tmp))
        gen_rest = submit(lambda pkg: run_jobs(
            pkg, json.loads(json.dumps(rest)), tmp))
        cli = submit(run_cli, CLI_SIM, tmp, "cli")
        study = submit(run_study, CLI_STUDY, tmp, "study")
        for f in gen_smoke.values():
            f.result()
        replay = {
            PKGS[0]: pool.submit(run_jobs, PKGS[0],
                                 replay_jobs(smoke[PKGS[1]]), tmp),
            PKGS[1]: pool.submit(run_jobs, PKGS[1],
                                 replay_jobs(smoke[PKGS[0]])
                                 + replay_jobs(smoke[PKGS[0]], True), tmp),
        }

        def results(futures):
            return {pkg: f.result() for pkg, f in futures.items()}

        return {
            "gen": {pkg: {**gen_smoke[pkg].result(), **gen_rest[pkg].result()}
                    for pkg in PKGS},
            "replay": results(replay),
            "cli": results(cli),
            "study": results(study),
        }


WALL = ("wall_seconds", "cycles_per_sec", "invariant_check_seconds")


def without_wall(report):
    """A report minus its wall-clock fields: the run's times, the
    breaker's quarantine age and last failure time, and the latency
    stages that split a wait by the measured solve time."""
    out = {k: v for k, v in report.items() if k not in WALL}
    if out.get("breaker"):
        breaker = dict(out["breaker"], quarantine_age_seconds=None)
        if breaker["last_failure"]:
            breaker["last_failure"] = dict(breaker["last_failure"], ts=None)
        out["breaker"] = breaker
    if out.get("latency"):
        stages = dict(out["latency"]["stage_p99_s"])
        stages.pop("solve", None)
        stages.pop("queue_wait", None)
        out["latency"] = dict(out["latency"], stage_p99_s=stages)
    for key in ("trace_out", "audit_path", "flight_dumps"):
        out.pop(key, None)
    return out


def test_generate_mode_records_equal(runs):
    ref, got = (runs["gen"][p]["smoke"] for p in PKGS)
    assert len(got["records"]) == 60
    assert got["records"] == ref["records"]
    assert got["report"]["placements"] > 0
    assert got["report"]["violations"] == []
    assert without_wall(got["report"]) == without_wall(ref["report"])


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_cross_package_replay_has_no_mismatch(runs, direction, backend):
    recorder, replayer = PKGS if direction == "jax-to-port" else PKGS[::-1]
    got = runs["replay"][replayer][f"replay-{backend}"]
    assert got["report"]["replay_mismatches"] == []
    assert got["report"].get("quality_mismatches", []) == []
    assert got["report"]["violations"] == []
    assert got["report"]["placements"] == (
        runs["gen"][recorder]["smoke"]["report"]["placements"])


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_port_kernels_replay_the_jax_trace(runs, backend):
    """The bid kernels (their plain versions on the CPU) under a replay
    of the JAX package's default-chain recording: the cycles where one
    commit a round places otherwise are replay mismatches, and nothing
    else breaks. Dense and sparse at K=16 >= N place alike."""
    got = {b: runs["replay"][PKGS[1]][f"kernels-{b}"]["report"]
           for b in ("dense", "sparse")}
    assert got[backend]["violations"] == []
    assert got[backend]["cycle_errors"] == 0
    assert got["sparse"]["replay_mismatches"] == (
        got["dense"]["replay_mismatches"])


def test_chaos_faults_breaker_and_placements_equal(runs):
    ref, got = (runs["gen"][p]["chaos"] for p in PKGS)
    for kind in ("solver-exc", "solver-hang", "solver-corrupt", "bind"):
        assert got["report"]["fault_counts"].get(kind, 0) > 0, kind
    assert got["report"]["fault_counts"] == ref["report"]["fault_counts"]
    assert got["report"]["breaker"]["trips"] >= 1
    assert (without_wall(got["report"])["breaker"]
            == without_wall(ref["report"])["breaker"])
    assert got["report"]["cycle_errors"] == 0
    assert got["report"]["violations"] == []
    assert got["records"] == ref["records"]


def test_failover_drill_successors_and_placements_equal(runs):
    ref, got = (runs["gen"][p]["drill"] for p in PKGS)
    assert got["report"]["leader_kills"] == 1
    assert got["report"]["failovers"] == ref["report"]["failovers"]
    assert got["report"]["recovery_failures"] == 0
    assert got["records"] == ref["records"]


def test_native_backend_placement_counts_equal(runs):
    ref, got = (runs["gen"][p]["native"] for p in PKGS)
    assert got["report"]["placements"] > 0
    assert got["counts"] == ref["counts"]


def test_sim_cli_report_equal(runs):
    ref, got = (runs["cli"][p] for p in PKGS)
    assert sorted(got) == sorted(ref)
    assert got["placements"] > 0
    assert without_wall(got) == without_wall(ref)


def test_sim_study_topk_equal(runs):
    ref, got = (runs["study"][p] for p in PKGS)
    assert ref["base"]["env"] == {"KBT_SOLVER": "jax"}
    assert got["base"]["env"] == {}
    assert dict(got, base=None) == dict(ref, base=None)
    assert got["base"]["flags"] == ref["base"]["flags"]
    assert len(got["per_seed"]) == 1


def test_unported_mesh_modes_exit_with_a_message(capsys):
    from kube_batch_tpu_torch import device
    from kube_batch_tpu_torch.sim import cli, study

    # The mesh modes are ported: --host-devices N runs the sim on N
    # virtual shards of --device (process-wide, so restored after), and
    # the twolevel study runs its flat/two-level legs.
    try:
        assert cli.main(["--host-devices", "4", "--device", "cpu",
                         "--cycles", "2", "--nodes", "2", "--quiet"]) == 0
        assert device.host_device_count() == 4
    finally:
        device.set_host_device_count(1)
    assert capsys.readouterr().err == ""
    assert study.main(["--preset", "twolevel", "--device", "cpu",
                       "--seeds", "1", "--cycles", "2", "--nodes", "2",
                       "--quiet"]) == 0
    # One host device is the one device every run has.
    assert cli.main(["--host-devices", "1", "--device", "cpu",
                     "--cycles", "2", "--nodes", "2", "--quiet"]) == 0
    assert device.host_device_count() == 1


def test_sim_needs_cuda_unless_cpu_is_asked_for(capsys):
    import torch

    from kube_batch_tpu_torch.sim import SimConfig, cli
    from kube_batch_tpu_torch.sim.harness import ClusterSimulator

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda is a valid default")
    assert cli.main(["--cycles", "2", "--quiet"]) == 11
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        ClusterSimulator(SimConfig(cycles=2))
