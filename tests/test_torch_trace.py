"""The port's span tracer on the scheduler's whole path, on the CPU.

With the tracer off, nothing is recorded. With it on: one ``solve.round``
span per round the solver counts, each round's blocking fetch in a
``solve.sync`` inside it; a ``gc`` span per collection, through a
``gc.callbacks`` hook that lives only while the tracer is enabled; the
loop's think time (``loop.*``), each cycle's ``cycle_epilogue`` and the
informer's ``ingest`` spans from a few seconds of ``Scheduler.run``; and
a Chrome trace that still loads. ``allocate_tpu.last_stats["job_waits"]``
accounts for every pod a cycle places, each with a wait of at least the
time it was pending before the cycle started.
"""

import gc
import json
import pathlib
import threading
import time

import pytest
import torch

import kube_batch_tpu_torch.actions  # noqa: F401 (registers actions)
import kube_batch_tpu_torch.plugins  # noqa: F401 (registers plugins)
from kube_batch_tpu_torch.actions import allocate_tpu as P_atpu
from kube_batch_tpu_torch.api import PodPhase, build_resource_list
from kube_batch_tpu_torch.cache import SchedulerCache
from kube_batch_tpu_torch.framework import close_session, open_session
from kube_batch_tpu_torch.obs import LEDGER
from kube_batch_tpu_torch.obs.tracer import TRACER, Tracer, _on_gc
from kube_batch_tpu_torch.scheduler import Scheduler
from kube_batch_tpu_torch.solver import kernels as PK
from kube_batch_tpu_torch.solver.snapshot import pack_inputs, tensorize
from kube_batch_tpu_torch.utils.test_utils import (
    build_cluster,
    build_in_process_cluster,
    build_pod,
    build_pod_group,
    make_tiers,
)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TPU_CONF = str(REPO / "config" / "tpu-batch-conf-tpu.yaml")
TIERS = (["priority", "gang", "conformance"],
         ["drf", "predicates", "proportion", "nodeorder"])


@pytest.fixture
def tracer():
    """The process tracer, emptied and enabled, disabled after."""
    TRACER.disable()
    TRACER.reset()
    TRACER.enable()
    try:
        yield TRACER
    finally:
        TRACER.disable()
        TRACER.reset()


def spans(name=None):
    return [e for e in TRACER.events() if name is None or e["name"] == name]


def host_bundle(monkeypatch, topk, nodes=48):
    """A tensorized 600-task snapshot of the port's own ``build_cluster``
    on ``nodes`` nodes; ``topk`` as ``KBT_SOLVER_TOPK`` (``off``:
    dense)."""
    monkeypatch.setenv("KBT_SOLVER_TOPK", topk)
    monkeypatch.setenv("KBT_SELECT_DEVICE", "0")
    cache = build_cluster(600, nodes, 3, 12, seed=3)
    ssn = open_session(cache, make_tiers(*TIERS), device="cpu")
    _, ctx = tensorize(ssn, device=False)
    close_session(ssn)
    cache.shutdown()
    return ctx.host_inputs


def run_loop(seconds, gangs=2):
    """``Scheduler.run`` with the TPU policy for ``seconds`` on an
    in-process cluster of 16 nodes and 120 pods, with ``gangs`` gangs of
    8 pods created mid-run through the cluster, so the informer ingests
    them and the loop's micro cycles place them. Returns the cache."""
    cluster = build_in_process_cluster(120, 16, 2, 6, seed=1)
    cache = SchedulerCache(cluster=cluster)
    sched = Scheduler(cache, TPU_CONF, schedule_period=0.2, device="cpu")
    stop = threading.Event()
    loop = threading.Thread(target=sched.run, args=(stop,), daemon=True)
    loop.start()
    time.sleep(seconds / 2)
    for g in range(gangs):
        name = f"late{g}"
        cluster.create("PodGroup", build_pod_group(
            name, namespace="bench", min_member=8, queue="q0"))
        for i in range(8):
            cluster.create("Pod", build_pod(
                "bench", f"{name}-{i}", "", PodPhase.PENDING,
                build_resource_list(cpu="100m", memory="64Mi"),
                group_name=name))
    time.sleep(seconds / 2)
    stop.set()
    loop.join(timeout=30.0)
    assert not loop.is_alive()
    cache.shutdown()
    return cache


def test_disabled_tracer_records_nothing(monkeypatch):
    TRACER.disable()
    TRACER.reset()
    host = host_bundle(monkeypatch, "4")
    result = PK.solve_auto(pack_inputs(host, "cpu"), use_kernel=False)
    assert result.rounds > 0
    run_loop(1.0, gangs=1)
    assert TRACER.spans_recorded == 0 and TRACER.events() == []
    assert _on_gc not in gc.callbacks


@pytest.mark.parametrize("topk, nodes, solver", [
    ("4", 48, "solve_sparse"), ("off", 24, "solve_staged")])
def test_one_round_span_per_round(monkeypatch, tracer, topk, nodes, solver):
    host = host_bundle(monkeypatch, topk, nodes)
    inputs = pack_inputs(host, "cpu")
    if solver == "solve_sparse":
        assert inputs.cand_idx.shape[0] > 0
    TRACER.reset()
    result = getattr(PK, solver)(inputs, use_kernel=False, tail_bucket=64)
    rounds = spans("solve.round")
    assert len(rounds) == result.rounds > 1
    assert len(spans("solve.tail")) == result.stages >= 1
    by_sid = {e["args"]["sid"]: e for e in rounds}
    syncs = spans("solve.sync")
    assert len(syncs) == len(rounds)
    for s in syncs:
        r = by_sid[s["args"]["parent"]]
        assert r["tid"] == s["tid"]
        assert r["ts"] <= s["ts"]
        assert s["ts"] + s["dur"] <= r["ts"] + r["dur"] + 1e-3


def test_gc_span_while_enabled_and_hook_removed_after():
    gc.disable()
    try:
        TRACER.reset()
        TRACER.enable()
        assert gc.callbacks.count(_on_gc) == 1
        other = Tracer()
        other.enable()
        other.disable()
        assert gc.callbacks.count(_on_gc) == 1
        gc.collect(1)
        TRACER.disable()
        gc.collect(1)
    finally:
        gc.enable()
        TRACER.disable()
    got = spans("gc")
    TRACER.reset()
    assert len(got) == 1
    assert got[0]["args"]["generation"] == 1
    assert got[0]["args"]["collected"] >= 0
    assert _on_gc not in gc.callbacks


def test_loop_think_time_epilogue_and_ingest_spans(tracer):
    run_loop(3.0)
    names = {e["name"] for e in spans()}
    assert names & {"loop.park", "loop.sleep"}
    assert {"loop.drain", "cycle_epilogue", "quality", "flight_record",
            "ingest", "cycle"} <= names
    kinds = {e["args"]["kind"] for e in spans("ingest")}
    assert {"add_pod", "add_pod_group", "update_pod"} <= kinds
    loop_tid = {e["tid"] for e in spans("cycle")}
    assert len(loop_tid) == 1
    assert {e["tid"] for e in spans("loop.sleep") + spans("loop.park")} \
        <= loop_tid
    # The in-process cluster delivers the mid-run arrivals on the thread
    # that created them.
    assert threading.get_ident() in {
        e["tid"] for e in spans("ingest") if e["args"]["kind"] == "add_pod"}
    epilogues = spans("cycle_epilogue")
    assert len(epilogues) >= len(spans("cycle")) - 1


def test_job_waits_cover_every_placed_pod(monkeypatch):
    monkeypatch.setenv("KBT_SOLVER_TOPK", "off")
    LEDGER.configure(enabled=True, clock=time.perf_counter)
    LEDGER.reset()
    cache = build_cluster(300, 24, 2, 10, seed=5)
    sched = Scheduler(cache, TPU_CONF, device="cpu")
    pending_ms = 20.0
    time.sleep(pending_ms / 1e3)
    sched.run_once()
    cache.wait_for_side_effects(timeout=30.0)
    stats = dict(P_atpu.last_stats)
    cache.shutdown()
    record = stats["job_waits"]
    assert stats["placed"] > 0
    assert record["cycle"] == sched._cycle_count - 1
    waits = record["waits"]
    assert sum(n for n, _ in waits) == stats["placed"]
    assert all(n > 0 and ms >= pending_ms for n, ms in waits)
    assert len(waits) <= 10


def test_export_writes_chrome_json(tracer, tmp_path, monkeypatch):
    host = host_bundle(monkeypatch, "4")
    with TRACER.span("device_solve", cycle_note="x"):
        PK.solve_auto(pack_inputs(host, "cpu"), use_kernel=False)
    gc.collect(0)
    path = TRACER.export(str(tmp_path / "trace.json"))
    doc = json.loads(pathlib.Path(path).read_text())
    events = doc["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    complete = [e for e in events if e["ph"] == "X"]
    assert meta and all(e["name"] == "thread_name" for e in meta)
    names = {e["name"] for e in complete}
    assert {"device_solve", "solve.round", "solve.sync", "gc"} <= names
    for e in complete:
        assert e["dur"] >= 0 and {"sid", "parent", "cycle"} <= set(e["args"])
    assert doc["displayTimeUnit"] == "ms"


def test_nvtx_ranges_only_with_the_knob_and_a_card(monkeypatch):
    monkeypatch.setenv("KBT_TRACE_NVTX", "1")
    TRACER.reset()
    TRACER.enable()
    try:
        assert (TRACER._nvtx is not None) == torch.cuda.is_available()
        with TRACER.span("outer"):
            with TRACER.span("inner"):
                pass
    finally:
        TRACER.disable()
    assert TRACER._nvtx is None
    assert [e["name"] for e in spans()] == ["inner", "outer"]
    TRACER.reset()
