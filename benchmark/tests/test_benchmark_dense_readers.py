"""The readers of the full dense solve (``dense.cycles_pct``,
``dense.prep_ms`` and ``bid_dense_roofline_pct``) on a synthetic
``Context``: each reads only the window's solving cycles whose solve the
program names ``dense``,
and a program without that counter, without the span, or a run without
a device trace reads ``None``. The bytes of a dense bid launch equal
``chip_smoke.py``'s ``dense_work``."""

from types import SimpleNamespace

import pytest

from benchmark import readings, work, work_dense

WINDOW = (100.0, 110.0)
NAMES = ("dense.cycles_pct", "dense.prep_ms", "bid_dense_roofline_pct")
SMALL = {"launches": 2, "rows": 64, "nodes": 1000, "dims": 2,
         "static": False}
WIDE = {"launches": 3, "rows": 128, "nodes": 1000, "dims": 2,
        "static": True}


def _solve(cycle, t, tensorize, rounds, tid=5):
    """Spans of one solving cycle starting at ``t``: tensorize, dispatch
    (10 ms), a prep span of 4 ms, ``rounds`` rounds of 10 ms, and the
    block to the last round's end."""
    spans = [("tensorize", t, t + tensorize, cycle, 1),
             ("solve_dispatch", t + tensorize, t + tensorize + 0.010,
              cycle, 1),
             ("solve.prep", t + tensorize + 0.010, t + tensorize + 0.014,
              cycle, tid)]
    r0 = t + tensorize + 0.020
    for r in range(rounds):
        spans.append(("solve.round", r0 + 0.010 * r, r0 + 0.010 * (r + 1),
                      cycle, tid))
    end = r0 + 0.010 * rounds
    spans.append(("solve_block", t + tensorize + 0.010, end, cycle, 1))
    return spans, (t + tensorize, end)


def _kernels(lo, bid, bid_us, others):
    """``bid`` dense bid kernels of ``bid_us`` each and ``others`` other
    kernels, 1 ms apart from ``lo``."""
    out = [("void bid_dense_kernel<2, false>(...)", lo + 0.001 * (i + 1),
            lo + 0.001 * (i + 1) + bid_us * 1e-6) for i in range(bid)]
    out += [("void at::native::radixSort(...)",
             lo + 0.001 * (bid + i + 1), lo + 0.001 * (bid + i + 1) + 1e-6)
            for i in range(others)]
    return out


def context(paths=("dense", "dense", "sparse"), prep=True, device=True,
            bid_events=(2, 3)):
    """Three solving cycles in the window (paths as given, the program's
    stats for each), an idle cycle, and a dense one before the window;
    with ``device`` a device trace over the window."""
    spans, cycles, kernels = [], [], []
    plan = [(101.0, 0.020, 2, SMALL), (103.0, 0.040, 3, WIDE),
            (105.0, 0.100, 4, None)]
    for i, ((t, tz, rounds, bid), path) in enumerate(zip(plan, paths)):
        s, (s0, s1) = _solve(10 + i, t, tz, rounds)
        spans += s
        stats = {"rounds": rounds}
        if path is not None:
            stats["solve_path"] = path
        if bid is not None and path == "dense":
            stats["bid_dense"] = dict(bid)
        cycles.append({"t0": t - 0.001, "t1": s1 + 0.001, "stats": stats})
        if i < 2:
            kernels += _kernels(s0, bid_events[i], 10 * (i + 1), 8 + 4 * i)
        else:
            kernels += _kernels(s0, 0, 0, 20)
    cycles.append({"t0": 107.0, "t1": 107.2, "stats": {}})
    early, (e0, e1) = _solve(9, 99.0, 0.020, 2)
    spans = early + spans
    cycles.insert(0, {"t0": 98.999, "t1": e1 + 0.001,
                      "stats": {"rounds": 2, "solve_path": "dense",
                                "bid_dense": dict(SMALL)}})
    if not prep:
        spans = [s for s in spans if s[0] != "solve.prep"]
    tracing = SimpleNamespace(
        spans=spans, kernels=sorted(kernels, key=lambda k: k[1]) if device
        else [], profiled=WINDOW if device else None, kernel=None,
        kernel_ms=None, kernel_work=None)
    return readings.Context(WINDOW, cycles, [], tracing)


def read(name, ctx):
    return readings.load_reader(name)(ctx)


def test_cycles_pct_counts_every_solving_cycle_of_the_window():
    assert read("dense.cycles_pct", context()) == pytest.approx(200 / 3)
    assert read("dense.cycles_pct",
                context(paths=("dense",) * 3)) == 100.0


def test_prep_reads_only_the_dense_cycles():
    # The sparse cycle's prep span is there too, but not counted.
    ctx = context()
    assert read("dense.prep_ms", ctx) == pytest.approx(4.0)
    assert len(work_dense.dense_solves(ctx)) == 2


def test_roofline_is_least_time_over_the_kernels_device_time():
    least = (2 * work_dense.launch_bytes(64, 1000, 2, False)
             + 3 * work_dense.launch_bytes(128, 1000, 2, True)
             ) / work.HBM_BYTES_PER_S
    took = 2 * 10e-6 + 3 * 20e-6
    got = read("bid_dense_roofline_pct", context())
    assert got == pytest.approx(100 * least / took)
    assert 0 < got <= 100


def test_roofline_leaves_out_a_cycle_whose_launches_were_not_all_seen():
    # The second cycle shows 2 of its 3 launches: only the first counts.
    least = 2 * work_dense.launch_bytes(64, 1000, 2, False) \
        / work.HBM_BYTES_PER_S
    got = read("bid_dense_roofline_pct", context(bid_events=(2, 2)))
    assert got == pytest.approx(100 * least / (2 * 10e-6))


@pytest.mark.parametrize("name", NAMES)
def test_a_program_that_names_no_path_reads_none(name):
    # The parent's stats: rounds, but no solve_path nor bid_dense.
    assert read(name, context(paths=(None, None, None))) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_window_with_no_dense_cycle_reads_none(name):
    ctx = context(paths=("sparse", "native", "staged"))
    if name == "dense.cycles_pct":
        assert read(name, ctx) == 0.0
    else:
        assert read(name, ctx) is None


def test_no_device_trace_reads_none():
    assert read("bid_dense_roofline_pct", context(device=False)) is None


def test_no_prep_span_reads_none():
    assert read("dense.prep_ms", context(prep=False)) is None


@pytest.mark.parametrize("static", [False, True], ids=["plain", "static"])
def test_launch_bytes_are_chip_smokes_dense_work(static):
    import torch

    import chip_smoke

    T, N, R = 5, 7, 3
    g = torch.Generator().manual_seed(3)
    args = (torch.rand(T, R, generator=g), torch.rand(T, R, generator=g),
            torch.ones(T, dtype=torch.bool),
            torch.rand(T, N, generator=g) > 0.3,
            torch.rand(N, R, generator=g), torch.ones(N, R),
            torch.ones(N, dtype=torch.bool), torch.full((R,), 1e-3),
            1.0, 1.0, torch.arange(T, dtype=torch.int32),
            torch.rand(T, N, generator=g) if static else None)
    nbytes, _ = chip_smoke.dense_work(args)
    assert work_dense.launch_bytes(T, N, R, static) == nbytes
