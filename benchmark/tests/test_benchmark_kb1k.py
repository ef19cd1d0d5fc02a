"""The ``kb1k-churn`` cell on the CPU, cut to a cluster under the sparse
path's 1,024 nodes: a sound run is correct and every solving cycle of
it takes the full dense solve; the control is not correct, and neither
is a run with a fault planted under the dense path. The cell's traffic
holds its population."""

import json
import time

import numpy as np
import pytest

from benchmark import harness, run
from benchmark import traffic as T
from test_benchmark_faults import _scores_inverted, _solve_returns_nothing

NODES, POPULATION, RATE, SECONDS = 60, 600, 40.0, 8


def cut_churn(spec: dict, nodes: int, population: int, rate: float) -> None:
    """A Poisson cell's shape at a small cluster: ``nodes`` and
    ``population``, ``rate`` pods a second, and lifetimes (a mean of
    population over rate, spread as the mix spreads its own) that hold
    the population. Gang sizes, minMembers and queues stay the mix's."""
    spec["config"].update(nodes=nodes, population=population)
    mix = spec["traffic"]
    a, b = mix["lifetime_s"]
    scale = population / rate / ((a + b) / 2)
    mix["rate"] = rate
    mix["lifetime_s"] = [a * scale, b * scale]


def _run(capsys, monkeypatch, *extra, patch_program=None):
    from kube_batch_tpu_torch.solver import containment

    containment.reset_breaker()
    kept = {}
    inner = harness.run

    def keep(*a, **k):
        kept["rec"] = inner(*a, **k)
        return kept["rec"]

    monkeypatch.setattr(harness, "run", keep)

    def patch(spec):
        cut_churn(spec, NODES, POPULATION, RATE)
        if patch_program is not None:
            patch_program()

    code = run.main(["--workload", "kb1k-churn", "--seed", "2147483671",
                     "--seconds", str(SECONDS), *extra],
                    device="cpu", t_start=time.perf_counter(), patch=patch)
    assert code == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return out, kept["rec"]


def test_a_sound_run_is_correct_and_solves_dense(capsys, monkeypatch):
    out, rec = _run(capsys, monkeypatch, "--trace", "1")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    paths = [c["stats"]["solve_path"] for c in rec["cycles"]
             if "rounds" in c.get("stats", {})]
    assert paths and set(paths) == {"dense"}
    metrics = out["metrics"]
    assert metrics["dense.cycles_pct"]["value"] == 100.0
    for name in ("tensorize_ms", "dense.prep_ms", "solve_ms",
                 "solve.round_ms", "session.open_ms"):
        assert metrics[name]["value"] > 0, name
    # Every reader the cell lists reads something but those of the
    # device trace, which the CPU has not.
    for metric in run.load_cell("kb1k-churn")["per_layer"]:
        on_device = metric["source"] == "device_trace"
        assert (metric["name"] in metrics) != on_device, metric["name"]


def test_the_control_is_not_correct(capsys, monkeypatch):
    out, _ = _run(capsys, monkeypatch, "--trace", "0", "--control")
    assert not out["correct"]
    checks = out["checks"]
    assert checks["gang_below_min"]["value"] > 0
    assert checks["score_gap"]["value"] > checks["score_gap"]["limit"]


@pytest.mark.parametrize("fault,number", [
    (_solve_returns_nothing, "unbound"),
    (_scores_inverted, "score_gap"),
], ids=["state-unchanged", "scores-inverted"])
def test_a_fault_on_the_dense_path_is_not_correct(capsys, monkeypatch, fault,
                                                  number):
    monkeypatch.setattr(harness, "WARMUP_TIMEOUT_S", 10.0)
    monkeypatch.setattr(harness, "GRACE_S", 10.0)
    out, rec = _run(capsys, monkeypatch, "--trace", "0",
                    patch_program=lambda: fault(monkeypatch))
    assert {c["stats"]["solve_path"] for c in rec["cycles"]
            if "rounds" in c.get("stats", {})} == {"dense"}
    assert not out["correct"]
    check = out["checks"][number]
    assert check["value"] > check["limit"]


def test_poisson_200_holds_its_population_over_the_window():
    mix = T.load_json("traffic", "poisson-200")
    config = T.load_json("configs", "kb1k")
    pop = config["population"]
    assert abs(T.pods_per_second(mix) * sum(mix["lifetime_s"]) / 2
               / pop - 1) < 1e-9
    runs = []
    for seed in range(2147483671, 2147483671 + 40):
        plan = T.make_plan(mix, config, seed, 48)
        runs.append(T.simulate_population(plan, 48.0)["running"] / pop)
        arrivals = [g for g in plan.arrivals if not g.warmup]
        # One gang an arrival, from the mix's sizes.
        assert len({g.due for g in arrivals}) == len(arrivals) > 300
        assert {len(g.cpu_m) for g in arrivals} <= {2, 8, 32, 128}
    runs = np.array(runs)
    # The mean over seeds holds 10,000 at every second of the window
    # (within 1 %; 3 % is three of its standard deviations). One seed's
    # population is a random walk of whole gangs, 6 % of it one standard
    # deviation after 48 s, so a seed strays by 10-18 %, never by a
    # quarter.
    assert abs(runs.mean(axis=0) - 1).max() < 0.03
    assert abs(runs - 1).max() < 0.25
