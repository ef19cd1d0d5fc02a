"""The port's solver fault containment, on the CPU.

Counterparts of ``tests/unit/test_containment.py``'s deadline, fetch
memoisation, degradation ladder, circuit breaker and loop watchdog
cases, run through the port's ``allocate_tpu`` on ``device="cpu"`` with
the fault and tamper hooks; plus the port's own contracts: the device
solve runs off the caller's thread, an abandoned solve drops the
resident pack, the canary probe solves on the action's device, and the
native floor equals the JAX package's bit for bit.
"""

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest
import torch

import kube_batch_tpu_torch.actions  # noqa: F401 (registers actions)
import kube_batch_tpu_torch.plugins  # noqa: F401 (registers plugins)
from kube_batch_tpu_torch.actions import allocate_tpu as atpu
from kube_batch_tpu_torch.actions.allocate_tpu import AsyncSolveHandle
from kube_batch_tpu_torch.api import PodPhase, build_resource_list
from kube_batch_tpu_torch.cache import SchedulerCache
from kube_batch_tpu_torch.cache.cache import CacheFencedError
from kube_batch_tpu_torch.framework import (
    close_session,
    get_action,
    open_session,
)
from kube_batch_tpu_torch.metrics import metrics as m
from kube_batch_tpu_torch.native import greedy as port_native
from kube_batch_tpu_torch.obs import RECORDER, explain
from kube_batch_tpu_torch.scheduler import LoopWatchdog, Scheduler
from kube_batch_tpu_torch.solver import containment, device_cache
from kube_batch_tpu_torch.solver.containment import (
    CircuitBreaker,
    SolveFailed,
    SolveTimeout,
    call_with_deadline,
)
from kube_batch_tpu_torch.solver.snapshot import pack_inputs
from kube_batch_tpu_torch.utils.test_utils import (
    DEFAULT_TIERS_ARGS,
    FakeBinder,
    FakeEvictor,
    FakeStatusUpdater,
    FakeVolumeBinder,
    build_node,
    build_pod,
    build_pod_group,
    build_queue,
    make_tiers,
)

from tests.test_torch_snapshot import cluster_bench, env, jax_pkg, tiers

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_containment(monkeypatch):
    """Breaker, hooks, budget and the registered action's device are
    process-global; every test starts (and leaves) them pristine."""
    action, _ = get_action("allocate_tpu")
    saved = (action.device, action.use_kernel)
    action.device, action.use_kernel = "cpu", True
    monkeypatch.delenv("KBT_SOLVER", raising=False)
    monkeypatch.delenv("KBT_SOLVER_TOPK", raising=False)
    containment.reset_breaker()
    containment.set_device_fault_hook(None)
    containment.set_result_tamper_hook(None)
    containment.configure(None)
    explain.clear()
    yield
    action.device, action.use_kernel = saved
    containment.reset_breaker()
    containment.set_device_fault_hook(None)
    containment.set_result_tamper_hook(None)
    containment.configure(None)
    explain.clear()


def make_cache():
    return SchedulerCache(
        binder=FakeBinder(), evictor=FakeEvictor(),
        status_updater=FakeStatusUpdater(),
        volume_binder=FakeVolumeBinder(),
    )


def req(cpu="1", mem="1Gi"):
    return build_resource_list(cpu=cpu, memory=mem)


def run_action(cache, name="allocate_tpu"):
    ssn = open_session(cache, make_tiers(*DEFAULT_TIERS_ARGS))
    action, found = get_action(name)
    assert found
    action.execute(ssn)
    close_session(ssn)
    return ssn


def ladder_of():
    return [(e["rung"], e["outcome"]) for e in atpu.last_stats["solve_ladder"]]


def _build_pending_cluster(groups=4, pods=6, nodes=8):
    c = make_cache()
    c.add_queue(build_queue("default"))
    for j in range(nodes):
        c.add_node(build_node(
            f"n{j}", build_resource_list(cpu="4", memory="8Gi")
        ))
    for g in range(groups):
        c.add_pod_group(build_pod_group(
            f"pg{g}", namespace="ns", min_member=1
        ))
        for i in range(pods):
            c.add_pod(build_pod(
                "ns", f"pg{g}-p{i}", "", PodPhase.PENDING, req(),
                group_name=f"pg{g}",
            ))
    return c


def _add_one_pending(c, name="pgx"):
    c.add_pod_group(build_pod_group(name, namespace="ns", min_member=1))
    c.add_pod(build_pod("ns", f"{name}-p0", "", PodPhase.PENDING, req(),
                        group_name=name))


def _tiny_packed():
    c = _build_pending_cluster(groups=1, pods=2, nodes=2)
    ssn = open_session(c, make_tiers(*DEFAULT_TIERS_ARGS))
    from kube_batch_tpu_torch.solver import tensorize

    _, ctx = tensorize(ssn, device=False)
    close_session(ssn)
    c.shutdown()
    return pack_inputs(ctx.host_inputs, "cpu")


# ---------------------------------------------------------------- deadline


class TestCallWithDeadline:
    def test_returns_result(self):
        assert call_with_deadline(lambda: 41 + 1, 1.0) == 42

    def test_propagates_exception(self):
        with pytest.raises(ValueError):
            call_with_deadline(
                lambda: (_ for _ in ()).throw(ValueError("x")), 1.0
            )

    def test_timeout_abandons_and_discards_late_result(self):
        done = threading.Event()

        def slow():
            time.sleep(0.3)
            done.set()
            return "late"

        t0 = time.perf_counter()
        with pytest.raises(SolveTimeout):
            call_with_deadline(slow, 0.05, label="t")
        assert time.perf_counter() - t0 < 0.25
        assert not done.is_set()
        assert done.wait(2.0)


# -------------------------------------------------------- fetch memoization


class _Result:
    rounds = 3
    refills = None
    stages = 2


class TestFetchMemoization:
    def test_failed_fetch_memoized_as_typed_error(self):
        h = AsyncSolveHandle("native")
        fut = Future()
        fut.set_exception(ValueError("device exploded"))
        h._future = fut
        with pytest.raises(SolveFailed) as e1:
            h.fetch()
        assert isinstance(e1.value.__cause__, ValueError)
        assert h.failed() and h._future is None  # detached
        with pytest.raises(SolveFailed) as e2:
            h.fetch()
        assert "already failed" in str(e2.value)

    def test_timeout_abandons_device_handle_and_discards_late_result(self):
        worker = atpu._AbandonableWorker("test-device")
        done = threading.Event()

        def slow():
            time.sleep(0.3)
            done.set()
            return _Result(), np.asarray([0, 1])

        h = AsyncSolveHandle("torch-cpu")
        h._worker = worker
        h._future = worker.submit(slow)
        with pytest.raises(SolveTimeout):
            h.fetch(timeout=0.05)
        assert h.failed() and h._future is None  # detached
        assert worker._pool is None  # the slot was abandoned
        assert done.wait(2.0)
        with pytest.raises(SolveFailed):
            h.fetch()
        assert h.done()

    def test_device_fetch_reads_result_counters(self):
        h = AsyncSolveHandle("torch-cpu")
        fut = Future()
        fut.set_result((_Result(), np.asarray([1, -1])))
        h._future = fut
        assert h.fetch(timeout=1.0).tolist() == [1, -1]
        assert (h.rounds, h.stages, h.refills) == (3, 2, None)
        assert h.fetch() is h.fetch()  # memoized

    def test_native_timeout_abandons_worker(self):
        pool = ThreadPoolExecutor(1)
        h = AsyncSolveHandle("native")
        h._worker = atpu._AbandonableWorker("test-native")
        h._future = pool.submit(lambda: (time.sleep(0.3), None) and None)
        with pytest.raises(SolveTimeout):
            h.fetch(timeout=0.05)
        with pytest.raises(SolveFailed):
            h.fetch(timeout=5.0)
        pool.shutdown(wait=True)

    def test_keyboard_interrupt_not_swallowed(self):
        h = AsyncSolveHandle("native")
        fut = Future()
        fut.set_exception(KeyboardInterrupt())
        h._future = fut
        with pytest.raises(KeyboardInterrupt):
            h.fetch()

    def test_fault_hook_failure_is_typed(self):
        h = AsyncSolveHandle.launch(
            _tiny_packed(), False, 8, device="cpu",
            fault_hook=lambda stage: (_ for _ in ()).throw(
                RuntimeError("injected")
            ),
        )
        with pytest.raises(SolveFailed) as e:
            h.fetch(timeout=10.0)
        assert isinstance(e.value.__cause__, RuntimeError)

    def test_launch_returns_before_the_solve_ends(self):
        """The device solve runs on the worker: launch returns while the
        solve is still in flight, and fetch is the one block point."""
        release = threading.Event()
        stages = []

        def hook(stage):
            stages.append(stage)
            assert release.wait(10.0)

        h = AsyncSolveHandle.launch(_tiny_packed(), False, 8, device="cpu",
                                    fault_hook=hook)
        assert h.backend == "torch-cpu"
        time.sleep(0.05)
        assert not h.done()
        release.set()
        assigned = h.fetch(timeout=10.0)
        assert h.done() and stages == ["solve"]
        assert (assigned[:2] >= 0).all() and h.rounds >= 1


# ------------------------------------------------------------------ ladder


class TestDegradationLadder:
    def test_mid_cycle_exception_degrades_not_fails(self):
        calls = []

        def hook(stage):
            if stage == "solve" and not calls:
                calls.append(stage)
                raise RuntimeError("injected device fault")

        containment.set_device_fault_hook(hook)
        before = m.solver_fallback.get(("dense", "native", "exception"))
        RECORDER.begin_cycle()
        c = _build_pending_cluster()
        run_action(c)
        assert c.wait_for_side_effects()
        rec = RECORDER.end_cycle()
        assert len(c.binder.binds) == 24
        ladder = atpu.last_stats["solve_ladder"]
        assert ladder_of() == [("dense", "exception"), ("native", "ok")]
        assert ladder[0]["exc"] == "RuntimeError"
        assert atpu.last_stats["solve_degraded"] is True
        assert atpu.last_stats["backend"] == "native"
        assert rec["solver"]["ladder"] == ladder
        assert rec["solver"]["degraded"] is True
        assert m.solver_fallback.get(
            ("dense", "native", "exception")
        ) == before + 1
        assert containment.last_fallback["reason"] == "exception"
        c.shutdown()

    def test_sparse_rung_falls_to_dense_first(self, monkeypatch):
        monkeypatch.setenv("KBT_SOLVER_TOPK", "4")
        calls = []

        def hook(stage):
            if stage == "solve" and not calls:
                calls.append(stage)
                raise RuntimeError("injected")

        containment.set_device_fault_hook(hook)
        c = _build_pending_cluster()
        run_action(c)
        assert c.wait_for_side_effects()
        assert ladder_of() == [("sparse", "exception"), ("dense", "ok")]
        assert atpu.last_stats["backend"] == "torch-cpu"
        assert atpu.last_stats["sparse_fallback_reason"] == "ladder-degraded"
        assert len(c.binder.binds) == 24
        c.shutdown()

    def test_timeout_jumps_to_native_and_opens_breaker(self):
        # The budget bounds the native rung's fetch too. In a process
        # that has loaded torch, greedy.cpp's OpenMP regions run on
        # torch's libgomp, and on a loaded CPU host the floor's small
        # solve has taken up to 1.2 s: 5 s keeps it inside.
        containment.configure(solve_budget=5.0)
        finished = threading.Event()

        def hook(stage):
            if stage == "solve":
                time.sleep(6.0)  # outsleep the budget
                finished.set()

        containment.set_device_fault_hook(hook)
        c = _build_pending_cluster()
        run_action(c)
        assert c.wait_for_side_effects()
        assert ladder_of() == [("dense", "timeout"), ("native", "ok")]
        assert len(c.binder.binds) == 24
        assert containment.BREAKER.state == "open"
        # The abandoned solve may still read the resident buffers: the
        # device cache was dropped, so no later pack patches them.
        dc = device_cache.device_cache_of(c)
        assert dc.dev == {} and dc.drop_reason == "solve-abandoned"
        assert finished.wait(10.0)

        containment.set_device_fault_hook(None)
        _add_one_pending(c)
        run_action(c)
        assert atpu.last_stats.get("breaker_pinned") is True
        assert atpu.last_stats["backend"] == "native"
        assert atpu.last_stats["solve_ladder"] == [
            {"rung": "native", "outcome": "ok"}
        ]
        # Re-promoted, the next device pack is a labelled full upload
        # into fresh buffers.
        containment.reset_breaker()
        _add_one_pending(c, "pgy")
        run_action(c)
        assert atpu.last_stats["backend"] == "torch-cpu"
        reasons = device_cache.last_pack_stats["full_reasons"]
        assert reasons and set(reasons.values()) == {"solve-abandoned"}
        assert atpu.last_stats["device_uploads"] == len(reasons)
        c.shutdown()

    def test_rescued_cycle_keeps_failure_streak(self, monkeypatch):
        monkeypatch.setenv("KBT_SOLVER_TOPK", "4")
        containment.reset_breaker(failure_threshold=2, cooldown_cycles=8)
        state = {}

        def hook(stage):
            if stage == "solve" and state.pop("armed", False):
                raise RuntimeError("sparse-only fault")

        containment.set_device_fault_hook(hook)
        c = _build_pending_cluster()
        state["armed"] = True
        run_action(c)
        assert ladder_of() == [("sparse", "exception"), ("dense", "ok")]
        assert containment.BREAKER.failure_streak == 1
        _add_one_pending(c)
        state["armed"] = True
        run_action(c)
        assert containment.BREAKER.state == "open"
        c.shutdown()

    def test_synchronous_dispatch_exception_contained(self, monkeypatch):
        orig = atpu.AllocateTpuAction._launch_rung

        def boom(self, rung, inputs, ctx):
            if rung != "native":
                raise RuntimeError("device lost at dispatch")
            return orig(self, rung, inputs, ctx)

        monkeypatch.setattr(atpu.AllocateTpuAction, "_launch_rung", boom)
        c = _build_pending_cluster()
        run_action(c)
        assert c.wait_for_side_effects()
        assert len(c.binder.binds) == 24
        ladder = atpu.last_stats["solve_ladder"]
        assert ladder[-1] == {"rung": "native", "outcome": "ok"}
        assert ("dense", "exception") in ladder_of()
        assert atpu.last_stats["backend"] == "native"
        assert containment.BREAKER.failure_streak >= 1
        c.shutdown()

    def test_device_tensorize_exception_contained(self, monkeypatch):
        orig = atpu.tensorize

        def boom(ssn, device=True, **kw):
            if device is not False:
                raise RuntimeError("backend dead during upload")
            return orig(ssn, device=device, **kw)

        monkeypatch.setattr(atpu, "tensorize", boom)
        before = m.solver_fallback.get(("device", "native", "tensorize"))
        c = _build_pending_cluster()
        run_action(c)
        assert c.wait_for_side_effects()
        assert len(c.binder.binds) == 24
        assert atpu.last_stats["backend"] == "native"
        assert atpu.last_stats["solve_ladder"] == [
            {"rung": "native", "outcome": "ok"}
        ]
        assert m.solver_fallback.get(
            ("device", "native", "tensorize")
        ) == before + 1
        assert containment.BREAKER.failure_streak >= 1
        assert containment.last_fallback["reason"] == "tensorize"
        c.shutdown()

    def test_tampered_device_output_is_rejected_one_rung_down(self):
        """The tamper hook corrupts a device rung's fetched vector: post
        -solve validation rejects it and the cycle re-solves below."""
        seen = []

        def tamper(assigned):
            seen.append(1)
            if len(seen) == 1:
                bad = np.array(assigned, copy=True)
                bad[0] = 10_000
                return bad
            return assigned

        containment.set_result_tamper_hook(tamper)
        c = _build_pending_cluster()
        run_action(c)
        assert c.wait_for_side_effects()
        assert ladder_of() == [("dense", "rejected"), ("native", "ok")]
        assert atpu.last_stats["solve_ladder"][0]["reasons"] == {
            "bad-index": 1
        }
        assert atpu.last_stats["validation_rejected"] == 1
        assert len(c.binder.binds) == 24
        c.shutdown()


# ----------------------------------------------------------------- breaker


class TestCircuitBreaker:
    def test_opens_at_threshold_and_recloses_via_probe(self):
        probe_ok = [False]
        b = CircuitBreaker(
            failure_threshold=3, cooldown_cycles=2,
            probe=lambda t, dev: probe_ok[0],
        )
        b.record_device_failure("exception", exc="E")
        b.record_device_failure("exception", exc="E")
        assert b.state == "closed" and b.allow_device()
        b.record_device_failure("exception", exc="E")
        assert b.state == "open"
        assert b.allow_device() is False
        assert b.allow_device() is False  # probe ran and failed
        assert b.state == "open" and b.probes_failed == 1
        probe_ok[0] = True
        assert b.allow_device() is False
        assert b.allow_device() is True
        assert b.state == "closed" and b.reclosures == 1
        assert b.allow_device() is True

    def test_success_resets_streak(self):
        b = CircuitBreaker(failure_threshold=3)
        b.record_device_failure("exception")
        b.record_device_failure("exception")
        b.record_device_success()
        b.record_device_failure("exception")
        assert b.state == "closed"

    def test_timeout_opens_immediately(self):
        b = CircuitBreaker(failure_threshold=3)
        b.record_device_failure("timeout", open_now=True)
        assert b.state == "open" and b.trips == 1

    def test_pin_open_blocks_until_unpinned(self):
        b = CircuitBreaker(cooldown_cycles=1, probe=lambda t, dev: True)
        b.pin_open("bench-degraded")
        for _ in range(5):
            assert b.allow_device() is False
        assert b.state_dict()["pinned"] == "bench-degraded"
        b.unpin()
        assert b.allow_device() is True

    def test_state_dict_shape(self):
        b = CircuitBreaker()
        b.record_device_failure("exception", exc="RuntimeError",
                                open_now=True)
        d = b.state_dict()
        assert d["state"] == "open"
        assert d["last_failure"]["exc"] == "RuntimeError"
        assert d["quarantine_age_seconds"] is not None
        assert d["cooldown_cycles_left"] > 0

    def test_canary_probe_solves_on_the_given_device(self):
        assert containment._canary_probe(30.0, "cpu") is True
        b = CircuitBreaker(cooldown_cycles=1)
        b.record_device_failure("timeout", open_now=True)
        # The default probe re-closed it, on the device the gate named.
        assert b.allow_device("cpu") is True
        assert b.state == "closed" and b.probes_ok == 1

    def test_probe_hands_the_gate_device_to_the_probe(self):
        seen = []
        b = CircuitBreaker(cooldown_cycles=1,
                           probe=lambda t, dev: seen.append(dev) or True)
        b.record_device_failure("timeout", open_now=True)
        assert b.allow_device(torch.device("cpu")) is True
        assert seen == [torch.device("cpu")]

    def test_canary_probe_fails_under_the_fault_hook(self):
        containment.set_device_fault_hook(
            lambda stage: (_ for _ in ()).throw(RuntimeError(stage))
        )
        b = CircuitBreaker(cooldown_cycles=1)
        b.record_device_failure("timeout", open_now=True)
        assert b.allow_device("cpu") is False
        assert b.state == "open" and b.probes_failed == 1


# ---------------------------------------------------------------- watchdog


class TestLoopWatchdog:
    def test_trips_once_per_wedged_cycle(self):
        trips = []
        before = m.scheduler_watchdog_trips.get()
        wd = LoopWatchdog(budget=0.1, on_trip=trips.append)
        now = time.monotonic()
        wd.cycle_begin(0)
        assert wd.check(now=now) is False
        assert wd.check(now=now + 1.0) is True
        assert wd.check(now=now + 2.0) is False
        assert len(trips) == 1 and "cycle 0" in trips[0]
        assert wd.last_trip["cycle"] == 0
        wd.cycle_end()
        wd.cycle_begin(1)
        assert wd.check(now=now + 9.0) is True
        assert m.scheduler_watchdog_trips.get() == before + 2

    def test_no_trip_when_idle_or_healthy(self):
        wd = LoopWatchdog(budget=0.05, on_trip=None)
        assert wd.check() is False
        wd.cycle_begin(0)
        wd.cycle_end()
        assert wd.check(now=time.monotonic() + 9.0) is False

    def test_trip_fences_cache_and_hooks_via_scheduler(self):
        cache = make_cache()
        s = Scheduler(cache, schedule_period=0.01, device="cpu")
        fenced = []
        s.fence_hooks.append(fenced.append)
        wd = LoopWatchdog(budget=0.01, on_trip=s._on_watchdog_trip)
        wd.cycle_begin(7)
        assert wd.check(now=time.monotonic() + 1.0) is True
        assert fenced and "cycle 7" in fenced[0]
        assert cache.fence_reason() is not None
        with pytest.raises(CacheFencedError):
            cache.bind(type("T", (), {"uid": "t1"})(), "n1")
        cache.shutdown()

    def test_trip_stops_standalone_run_loop(self):
        cache = make_cache()
        s = Scheduler(cache, schedule_period=0.01, device="cpu")
        stop = threading.Event()
        s._run_stop = stop
        s._on_watchdog_trip("watchdog: cycle 3 exceeded budget")
        assert stop.is_set()
        assert cache.fence_reason() is not None
        cache.shutdown()


# ------------------------------------------------------------ native floor


@pytest.mark.parametrize("topk", ["off", "4"])
def test_native_floor_equals_the_jax_packages(topk):
    """The port's copy of greedy.cpp, built from its own source, gives
    the reference's assignment and stats on the same host bundle."""
    J = jax_pkg()
    from kube_batch_tpu.native import greedy as jax_native

    with env(KBT_SOLVER_TOPK=topk):
        cache = cluster_bench(J)
        ssn = J.open_session(cache, tiers(J))
        _, ctx = J.snapshot.tensorize(ssn, device=False)
        J.close_session(ssn)
    host = ctx.host_inputs
    ref, ref_placed = jax_native.solve_native(host)
    ref_stats = dict(jax_native.last_solve_stats)
    got, placed = port_native.solve_native(host)
    assert np.array_equal(got, ref) and placed == ref_placed
    assert port_native.last_solve_stats == ref_stats
    assert ref_stats["sparse"] is (topk != "off")
    assert placed > 0


def test_native_floor_builds_into_the_package():
    import os

    assert port_native.native_available()
    build = port_native._BUILD_DIR
    assert build.endswith(os.path.join(
        "kube_batch_tpu_torch", "native", "csrc", "build"))
    assert os.path.isfile(os.path.join(build, "libgreedy.so"))


# ---------------------------------------------------------------- dispatch


def test_solve_sharded_solves_on_one_device_and_refuses_a_mesh():
    from kube_batch_tpu_torch.solver import sharding

    packed = _tiny_packed()
    res = sharding.solve_sharded(packed, max_rounds=8)
    assert sharding.last_dispatch == {
        "mode": "single", "shards": 1, "sparse_sharded": False,
    }
    assert sharding.prospective_layout_token() == "1dev:auto"
    assert (res.assigned[:2] >= 0).all()
    # A mesh of two (virtual) shards solves the node-sharded program,
    # bit-equal to the single device's plain chain; the unported GSPMD
    # implementation is refused.
    plain = sharding.solve_sharded(packed, max_rounds=8, use_kernel=False)
    two = sharding.solve_sharded(packed, mesh=["cpu", "cpu"], max_rounds=8)
    assert sharding.last_dispatch == {
        "mode": "dense-spmd", "shards": 2, "sparse_sharded": False,
    }
    assert torch.equal(two.assigned, plain.assigned)
    assert torch.equal(two.node_idle, plain.node_idle)
    with pytest.raises(ValueError, match="gspmd"):
        sharding.solve_sharded(packed, mesh=["cpu", "cpu"], impl="gspmd")
