"""The traffic generator: seeded, balanced, and holding its population."""

import numpy as np
import pytest

from benchmark import traffic as T

STORM = T.load_json("traffic", "storm-1250-3s")
ZIPF = [0.08, 0.11, 0.15, 0.22, 0.44]
TRICKLE = {
    "arrivals": {"kind": "poisson"}, "rate": 100.0,
    "gang_sizes": {"1": 0.45, "2": 0.25, "4": 0.2, "8": 0.1},
    "min_member": "size", "lifetime_s": [250.0, 750.0], "queue_share": ZIPF,
}
SMALL = dict(T.load_json("configs", "kb5k"), nodes=100, population=2000)
# 80 pods every 3 s at a mean of 75 s holds 2,000.
SMALL_STORM = dict(STORM, gangs={"32": 1, "8": 4, "2": 8},
                   lifetime_s=[37.5, 112.5])


def _pods(plan):
    return [(g.name, g.queue, g.min_member, round(g.due, 9),
             tuple(g.cpu_m), tuple(g.mem_mi),
             tuple(np.round(g.lifetime, 9)))
            for g in plan.initial + plan.arrivals]


@pytest.mark.parametrize("mix", [SMALL_STORM, TRICKLE],
                         ids=["storm", "trickle"])
def test_same_seed_same_pods_other_seed_other_pods(mix):
    a = _pods(T.make_plan(mix, SMALL, 2**31 + 11, 40))
    b = _pods(T.make_plan(mix, SMALL, 2**31 + 11, 40))
    c = _pods(T.make_plan(mix, SMALL, 2**31 + 12, 40))
    assert a == b
    assert a != c


@pytest.mark.parametrize("mix", [SMALL_STORM, TRICKLE],
                         ids=["storm", "trickle"])
def test_population_held_over_a_simulated_hour(mix):
    config = dict(SMALL, population=50000) if mix is TRICKLE else SMALL
    plan = T.make_plan(mix, config, 5, 3600)
    run = T.simulate_population(plan, 3600.0)["running"]
    pop = config["population"]
    assert run[0] == pop
    # Arrivals balance completions: the hour's mean, and its last ten
    # minutes', stay within 3 % of the population.
    assert abs(run.mean() / pop - 1) < 0.03
    assert abs(run[-600:].mean() / pop - 1) < 0.03


def test_storms_are_the_configured_gangs_and_count():
    config = T.load_json("configs", "kb5k")
    arr = STORM["arrivals"]
    plan = T.make_plan(STORM, config, 3, 48)
    storms = {}
    for g in plan.arrivals:
        storms.setdefault(g.due, []).append(g)
    warm = [d for d in storms if storms[d][0].warmup]
    assert len(warm) == 1
    # Due at k * every + an offset in [0, jitter), k = 0 .. 48 / every - 1.
    assert len(storms) - 1 == int(48 / arr["every_s"])
    want = sorted(T.storm_sizes(STORM))
    for gangs in storms.values():
        assert sorted(len(g.cpu_m) for g in gangs) == want
        assert all(1 <= g.min_member <= len(g.cpu_m) for g in gangs)
    initial = sum(len(g.cpu_m) for g in plan.initial)
    assert initial + sum(want) == config["population"]
    # The rate times the mean lifetime is the population.
    held = T.pods_per_second(STORM) * sum(STORM["lifetime_s"]) / 2
    assert abs(held / config["population"] - 1) < 1e-9
    life = np.concatenate([g.lifetime for g in plan.arrivals])
    a, b = STORM["lifetime_s"]
    assert life.min() >= a and life.max() <= b


def test_queues_take_their_shares_of_the_gangs():
    config = T.load_json("configs", "kb5k")
    plan = T.make_plan(STORM, config, 9, 48)
    storm = [g for g in plan.arrivals if not g.warmup]
    counts = np.bincount([g.queue for g in storm], minlength=5)
    assert len(STORM["queue_share"]) == config["queues"]
    assert np.allclose(counts / counts.sum(), STORM["queue_share"],
                       atol=0.03)
    assert counts[0] < counts[1] < counts[2] < counts[3] < counts[4]


def test_every_seed_gets_the_same_sizes_and_arrivals_in_another_order():
    a = T.make_plan(STORM, SMALL, 1, 36)
    b = T.make_plan(STORM, SMALL, 2, 36)
    for key in ("cpu_m", "mem_mi"):
        ca = np.sort(np.concatenate([getattr(g, key) for g in a.arrivals]))
        cb = np.sort(np.concatenate([getattr(g, key) for g in b.arrivals]))
        assert (ca == cb).all()
    assert (sorted((len(g.cpu_m), g.min_member) for g in a.arrivals)
            == sorted((len(g.cpu_m), g.min_member) for g in b.arrivals))
    assert (sorted((len(g.cpu_m), g.queue) for g in a.arrivals)
            == sorted((len(g.cpu_m), g.queue) for g in b.arrivals))
    every = STORM["arrivals"]["every_s"]
    da = sorted({g.due % every for g in a.arrivals if not g.warmup})
    db = sorted({g.due % every for g in b.arrivals if not g.warmup})
    assert np.allclose(da, db)
    assert [g.min_member for g in a.arrivals] != [g.min_member
                                                   for g in b.arrivals]


def test_residual_lifetimes_follow_the_stationary_law():
    rng = np.random.default_rng(0)
    r = T.residual_lifetimes(rng, 200000, 20.0, 40.0)
    assert r.min() >= 0 and r.max() <= 40.0
    # E[residual] = E[L^2] / (2 E[L]) for L ~ U(20, 40).
    ell2 = (40.0**3 - 20.0**3) / (3 * 20.0)
    assert abs(r.mean() - ell2 / (2 * 30.0)) < 0.1
