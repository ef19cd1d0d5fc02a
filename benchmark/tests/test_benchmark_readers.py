"""The readers of the loop's, the solver's, the collector's and the
informer's spans and of the per-job wait counter, on a synthetic
``Context``: each reads what it names, only from the window, and a
program without the span or counter reads ``None``."""

from types import SimpleNamespace

import pytest

from benchmark import readings

WINDOW = (100.0, 110.0)
NEW = ("solve.round_ms", "solve.round_issue_ms", "pod.wait_for_cycle_p50_ms",
       "gc.pause_pct", "cycle.epilogue_ms", "cache.ingest_pct")


def context(spans=(), cycles=()):
    """A traced run's ``Context`` holding ``spans`` as ``(name, t0, t1,
    thread)`` on the host clock, and the harness's ``cycles``."""
    tracing = SimpleNamespace(
        spans=[(name, t0, t1, 0, tid) for name, t0, t1, tid in spans],
        kernels=[], profiled=None, kernel=None, kernel_ms=None,
        kernel_work=None)
    return readings.Context(WINDOW, list(cycles), [], tracing)


def read(name, ctx):
    return readings.load_reader(name)(ctx)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_span_or_counter_reads_none(name):
    ctx = context(spans=[("cycle", 101.0, 102.0, 1)],
                  cycles=[{"t0": 101.0, "t1": 102.0, "stats": {"rounds": 3}}])
    assert read(name, ctx) is None


def test_round_ms_is_the_mean_round_in_the_window():
    ctx = context(spans=[("solve.round", 101.0, 101.010, 7),
                         ("solve.round", 102.0, 102.020, 7),
                         ("solve.round", 99.0, 99.5, 7),
                         ("solve.sync", 101.005, 101.010, 7)])
    assert read("solve.round_ms", ctx) == pytest.approx(15.0)


def test_round_issue_ms_takes_out_the_sync_on_the_same_thread_only():
    ctx = context(spans=[("solve.round", 101.0, 101.010, 7),
                         ("solve.sync", 101.008, 101.010, 7),
                         ("solve.round", 102.0, 102.004, 7),
                         ("solve.sync", 102.001, 102.004, 7),
                         # Another thread's sync inside the first round.
                         ("solve.sync", 101.001, 101.002, 8)])
    # (10 - 2 + 4 - 3) / 2 ms.
    assert read("solve.round_issue_ms", ctx) == pytest.approx(4.5)
    assert read("solve.round_issue_ms", ctx) <= read("solve.round_ms", ctx)


def test_wait_for_cycle_counts_each_program_cycle_once():
    first = {"cycle": 5, "waits": [[4, 100.0]]}
    cycles = [
        {"t0": 101.0, "t1": 101.5, "stats": {"job_waits": first}},
        # The same record, seen again in a later cycle's stats.
        {"t0": 102.0, "t1": 102.5, "stats": {"job_waits": dict(first)}},
        {"t0": 103.0, "t1": 103.5,
         "stats": {"job_waits": {"cycle": 6, "waits": [[5, 300.0]]}}},
        # Outside the window.
        {"t0": 99.0, "t1": 99.5,
         "stats": {"job_waits": {"cycle": 4, "waits": [[50, 1.0]]}}},
    ]
    # Once: 4 pods at 100 ms, 5 at 300 ms; counted twice, 100 ms.
    assert read("pod.wait_for_cycle_p50_ms", context(cycles=cycles)) == 300.0


def test_gc_pause_pct_is_the_union_cut_to_the_window():
    ctx = context(spans=[("gc", 101.0, 102.0, 1),
                         ("gc", 101.5, 102.5, 2),
                         ("gc", 109.5, 111.0, 1),
                         ("gc", 99.0, 100.5, 1)])
    # (1.5 + 0.5) s of a 10 s window.
    assert read("gc.pause_pct", ctx) == pytest.approx(20.0)


def test_epilogue_ms_is_the_mean_epilogue_span():
    ctx = context(spans=[("cycle_epilogue", 101.0, 101.002, 1),
                         ("cycle_epilogue", 102.0, 102.004, 1),
                         ("quality", 102.0, 102.003, 1)])
    assert read("cycle.epilogue_ms", ctx) == pytest.approx(3.0)


def test_ingest_pct_is_the_union_of_every_handler():
    ctx = context(spans=[("ingest", 104.0, 104.5, 3),
                         ("ingest", 104.25, 105.0, 4),
                         ("ingest", 106.0, 106.5, 3)])
    assert read("cache.ingest_pct", ctx) == pytest.approx(15.0)
