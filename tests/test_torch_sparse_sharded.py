"""Parity of the port's sharded sparse solve (``solver/spmd.py``, the
``flat`` and ``two-level`` modes) and of its dispatch, tokens and
residency with the JAX package's, on the CPU.

Slab-carrying host bundles come from a NumPy seed through the JAX
package's host candidate selection (the cases of
``tests/solver/test_sparse_sharded.py``). The JAX package solves them on
the conftest's virtual CPU mesh (8 devices, or a submesh), the port on a
mesh of as many virtual CPU shards:

- ``flat`` equals the JAX package's flat solve and the port's own
  single-device plain chain (``solve_sparse(use_kernel=False)``);
- ``two-level`` is not bit-equal to the single solve (it is
  quality-approximate by design): it equals the JAX package's two-level
  run, keeps the invariants (valid nodes, idle reconciled to the
  placements, the predicate mask) and repeats itself.

Tolerance: none for the parity checks (``assigned``, ``node_idle``,
``queue_allocated``, ``rounds``, ``stages``, ``refills`` and the
reconcile rounds bit for bit). The two-level idle reconstruction in
float64 keeps the reference's ``atol=1.0`` (the psum reconcile and the
reconstruction add the same deltas in different orders; 1.0 is ten
times under the 10.0 epsilon).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.solver import kernels as JK
from kube_batch_tpu.solver import sharding as JSH
from kube_batch_tpu.solver import spmd as JSP
from kube_batch_tpu.solver.masks import CombinedMask as JMask
from kube_batch_tpu.solver.topk import select_candidates as jax_select

from kube_batch_tpu_torch import device as PDEV
from kube_batch_tpu_torch.solver import kernels as PK
from kube_batch_tpu_torch.solver import sharding as PSH
from kube_batch_tpu_torch.solver import spmd as PSP
from kube_batch_tpu_torch.solver.collectives import Mesh

from tests.test_torch_spmd import jax_mesh, to_jax, to_port

torch.set_num_threads(1)


def sparse_host(T, N, R=3, Q=3, seed=0, k=8, tight=False, gang=True,
                starve_queue=False):
    """The reference's ``sparse_inputs`` as a NumPy host bundle: slabs
    from the JAX package's host selection; ``tight`` shrinks capacity so
    truncated slabs exhaust and the refill stage engages."""
    rng = np.random.RandomState(seed)
    task_req = rng.uniform(400.0, 4000.0, size=(T, R)).astype(np.float32)
    hi = 9000.0 if tight else 32000.0
    node_idle = rng.uniform(3000.0, hi, size=(N, R)).astype(np.float32)
    feas = rng.rand(T, N) < 0.85
    eps = np.full(R, 10.0, np.float32)
    mask = JMask(
        node_ok=np.ones(N, bool),
        task_group=np.arange(T, dtype=np.int32),
        group_rows=feas,
        pair_idx=np.zeros((0,), np.int32),
        pair_rows=np.zeros((0, N), bool),
    )
    cs = jax_select(
        mask, {}, task_req, task_req, node_idle, node_idle,
        np.zeros_like(node_idle), np.zeros(N, np.int32),
        np.zeros(N, np.int32), eps, 1.0, 1.0, k,
    )
    deserved = np.full((Q, R), np.inf, np.float32)
    if starve_queue:
        deserved[0] = 9000.0
    jobs = (
        np.sort(rng.randint(0, max(T // 6, 1), size=T)).astype(np.int32)
        if gang else np.arange(T, dtype=np.int32)
    )
    inputs = JK.make_inputs(
        feas=jnp.asarray(feas),
        task_req=jnp.asarray(task_req),
        task_fit=jnp.asarray(task_req),
        task_rank=jnp.arange(T, dtype=jnp.int32),
        task_job=jnp.asarray(jobs),
        task_queue=jnp.asarray(rng.randint(0, Q, size=T), jnp.int32),
        node_idle=jnp.asarray(node_idle),
        node_releasing=jnp.zeros((N, R), jnp.float32),
        node_cap=jnp.asarray(node_idle),
        node_task_count=jnp.zeros(N, jnp.int32),
        node_max_tasks=jnp.asarray(rng.randint(0, 4, size=N), jnp.int32),
        queue_deserved=jnp.asarray(deserved),
        queue_allocated=jnp.zeros((Q, R), jnp.float32),
        eps=jnp.asarray(eps),
        lr_weight=jnp.asarray(1.0, jnp.float32),
        br_weight=jnp.asarray(1.0, jnp.float32),
        task_cand=jnp.asarray(cs.task_cand),
        cand_idx=jnp.asarray(cs.cand_idx),
        cand_static=jnp.asarray(cs.cand_static),
        cand_info=jnp.asarray(cs.cand_info),
    )
    return JK.SolverInputs(*[None if v is None else np.asarray(v)
                             for v in inputs])


def as_numpy(r, T=None):
    opt = lambda v: None if v is None else int(v)  # noqa: E731
    assigned = np.asarray(r.assigned)
    return {
        "assigned": assigned if T is None else assigned[:T],
        "node_idle": np.asarray(r.node_idle),
        "queue_allocated": np.asarray(r.queue_allocated),
        "rounds": int(r.rounds),
        "stages": opt(r.stages),
        "refills": opt(r.refills),
        "reconcile_rounds": opt(getattr(r, "reconcile_rounds", None)),
    }


def assert_bits(got, ref, keys=("rounds", "stages", "refills",
                                "reconcile_rounds")):
    for key in keys:
        assert got[key] == ref[key], (key, got[key], ref[key])
    for key in ("assigned", "node_idle", "queue_allocated"):
        a, b = got[key], ref[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (
            key, np.flatnonzero(a.reshape(-1) != b.reshape(-1))[:10],
        )


def both_sparse(host, size, two_level=False, **kw):
    """(port, jax) results of ``solve_sparse_spmd`` on ``size`` shards
    (tasks padded, and nodes for two-level)."""
    pad_j = JSH.pad_tasks(to_jax(host), size)
    pad_p = PSH.pad_tasks(to_port(host), size)
    if two_level:
        pad_j = JSH.pad_nodes(pad_j, size)
        pad_p = PSH.pad_nodes(pad_p, size)
    jr = JSP.solve_sparse_spmd(pad_j, jax_mesh(size), two_level=two_level,
                               **kw)
    pr = PSP.solve_sparse_spmd(pad_p, Mesh(["cpu"] * size),
                               two_level=two_level, **kw)
    return pr, jr


def port_single(host, **kw):
    return PK.solve_sparse(to_port(host), use_kernel=False, **kw)


@pytest.fixture
def shards():
    """Set the process's virtual shard count for one test."""
    saved = PDEV.host_device_count()
    yield PDEV.set_host_device_count
    PDEV.set_host_device_count(saved)


# ---------------------------------------------------------------- flat


@pytest.mark.parametrize("seed,T,N,tight", [
    (0, 200, 96, False), (1, 300, 72, True), (3, 513, 64, True),
])
def test_flat_bit_equal(seed, T, N, tight):
    # Tight capacity, pod-count caps, a starved queue and gang job-break
    # verdicts route slab exhaustion through refill and the shared dense
    # tail; T=513 exercises ragged task padding.
    host = sparse_host(T, N, seed=seed, tight=tight, starve_queue=tight)
    pr, jr = both_sparse(host, 8, max_rounds=64)
    got = as_numpy(pr, T)
    assert_bits(got, as_numpy(jr, T))
    single = as_numpy(port_single(host, max_rounds=64))
    assert_bits(got, single, keys=("rounds", "stages", "refills"))
    assert got["reconcile_rounds"] >= 1
    assert (got["assigned"] >= 0).sum() > 0
    if tight:
        assert got["refills"] > 0


def test_flat_two_device_submesh():
    host = sparse_host(160, 64, seed=4, tight=True)
    pr, jr = both_sparse(host, 2, max_rounds=64)
    assert_bits(as_numpy(pr, 160), as_numpy(jr, 160))
    assert_bits(as_numpy(pr, 160), as_numpy(port_single(host, max_rounds=64)),
                keys=("rounds", "stages", "refills"))


def test_one_device_mesh_is_single():
    # A one-shard mesh dispatches the single-device sparse solve.
    host = sparse_host(200, 96, seed=0)
    via = PSH.solve_sharded(to_port(host), Mesh(["cpu"]), use_kernel=False)
    assert PSH.last_dispatch["mode"] == "single"
    assert torch.equal(via.assigned, port_single(host).assigned)


def test_forced_flat_through_solve_sharded(monkeypatch):
    monkeypatch.setenv("KBT_SPARSE_SHARD_MODE", "flat")
    host = sparse_host(240, 64, seed=9, tight=True)
    res = PSH.solve_sharded(to_port(host), Mesh(["cpu"] * 8))
    assert PSH.last_dispatch == {
        "mode": "flat", "shards": 8, "sparse_sharded": True,
    }
    ref = JSH.solve_sharded(to_jax(host), jax_mesh(8))
    assert JSH.last_dispatch["mode"] == "flat"
    assert_bits(as_numpy(res), as_numpy(ref))
    assert torch.equal(res.assigned, port_single(host).assigned)
    assert res.reconcile_rounds >= 1
    # The commit collective's byte accounting for this dispatch.
    assert PSP.last_commit_stats == JSP.last_commit_stats
    assert (PSP.last_commit_stats["commit_bytes_exchanged"]
            < PSP.last_commit_stats["commit_bytes_full_broadcast"])


def test_forced_flat_ragged_bundle(monkeypatch):
    # 201 tasks pad to 208 rows for 8 shards: the result is sliced back
    # and the commit's byte accounting is the unpadded bundle's, as in
    # the reference.
    monkeypatch.setenv("KBT_SPARSE_SHARD_MODE", "flat")
    host = sparse_host(201, 48, seed=6, tight=True)
    res = PSH.solve_sharded(to_port(host), Mesh(["cpu"] * 8))
    ref = JSH.solve_sharded(to_jax(host), jax_mesh(8))
    assert_bits(as_numpy(res), as_numpy(ref))
    assert res.assigned.shape[0] == 201
    assert PSP.last_commit_stats == JSP.last_commit_stats


def test_auto_small_problem_stays_single(monkeypatch):
    monkeypatch.delenv("KBT_SPARSE_SHARD_MODE", raising=False)
    host = sparse_host(240, 64, seed=9)
    res = PSH.solve_sharded(to_port(host), Mesh(["cpu"] * 8),
                            use_kernel=False)
    assert PSH.last_dispatch["mode"] == "single"
    assert PSH.last_dispatch["shards"] == 8
    assert torch.equal(res.assigned, port_single(host).assigned)


def test_ragged_packed_bundle_falls_back_labeled(monkeypatch):
    from kube_batch_tpu_torch.solver.snapshot import pack_inputs

    monkeypatch.setenv("KBT_SPARSE_SHARD_MODE", "flat")
    host = sparse_host(200, 64, seed=2)
    # 200 tasks do not divide by 3 shards, and a packed bundle is not
    # re-padded: the single-device solve runs, labeled.
    res = PSH.solve_sharded(pack_inputs(host, "cpu"), Mesh(["cpu"] * 3),
                            use_kernel=False)
    assert PSH.last_dispatch == {
        "mode": "single", "shards": 3, "sparse_sharded": False,
        "reason": "ragged-axes",
    }
    assert torch.equal(res.assigned, port_single(host).assigned)
    with pytest.raises(ValueError, match="divisible"):
        PSH.sharded_step(pack_inputs(host, "cpu"), Mesh(["cpu"] * 3),
                         impl="sparse")


def test_policy_table(monkeypatch):
    monkeypatch.delenv("KBT_SPARSE_SHARD_MODE", raising=False)
    m8, m2 = Mesh(["cpu"] * 8), Mesh(["cpu"] * 2)
    j8 = jax_mesh(8)
    cases = [(1 << 20, None), (1 << 10, m8), (1 << 17, m8), (1 << 20, m8),
             (1 << 20, m2), (16, m8)]
    jcases = {None: None, m8: j8, m2: jax_mesh(2)}

    def table():
        return ([PSH.sparse_shard_mode(t, m) for t, m in cases],
                [JSH.sparse_shard_mode(t, jcases[m]) for t, m in cases])

    got, ref = table()
    assert got == ref == ["single", "single", "flat", "two-level", "flat",
                          "single"]
    for forced in ("off", "flat", "two-level", "hierarchical", "1"):
        monkeypatch.setenv("KBT_SPARSE_SHARD_MODE", forced)
        got, ref = table()
        assert got == ref
        # No mesh wins over any forcing (nothing to shard over).
        assert got[0] == "single"


def test_commit_bytes_and_bit_packing_match_reference():
    for shape in ((65536, 4096, 4, 3, 64), (100, 7, 2, 2, 300),
                  (33, 5, 1, 3, 8)):
        assert PSP.commit_exchange_bytes(*shape) == (
            JSP.commit_exchange_bytes(*shape))
    rng = np.random.RandomState(0)
    for n in (1, 31, 32, 33, 200):
        bits = rng.rand(n) < 0.5
        words = PSP._pack_bits(torch.from_numpy(bits))
        ref = np.asarray(JSP._pack_bits(jnp.asarray(bits)))
        assert np.array_equal(words.numpy().view(np.uint32), ref)
        assert np.array_equal(PSP._unpack_bits(words, n).numpy(), bits)
        rows = torch.stack([words, words])
        assert PSP._unpack_bits(rows, n).shape == (2, n)


# ---------------------------------------------------------------- two-level


@pytest.mark.parametrize("size", [4, 8])
def test_two_level_matches_reference(size):
    host = sparse_host(240, 64, seed=9, tight=True, starve_queue=True)
    pr, jr = both_sparse(host, size, two_level=True, max_rounds=64)
    assert_bits(as_numpy(pr), as_numpy(jr))


def test_two_level_invariants_and_determinism():
    host = sparse_host(240, 64, seed=9, tight=True, starve_queue=True)
    padded = PSH.pad_tasks(to_port(host), 8)
    mesh = Mesh(["cpu"] * 8)
    two = PSP.solve_sparse_spmd(padded, mesh, max_rounds=64, two_level=True)
    T, n = 240, host.node_idle.shape[0]
    assigned = two.assigned.numpy()
    req = padded.task_req.numpy()
    assert assigned.max(initial=-1) < n
    assert (assigned[T:] == -1).all()
    expect = host.node_idle.astype(np.float64).copy()
    for i in np.nonzero(assigned >= 0)[0]:
        expect[assigned[i]] -= req[i]
    np.testing.assert_allclose(expect, two.node_idle.numpy()[:n], atol=1.0)
    for i in np.nonzero(assigned[:T] >= 0)[0]:
        j = assigned[i]
        assert host.node_feas[j] and host.group_feas[host.task_group[i], j]
    # Pod-count caps hold.
    counts = np.bincount(assigned[assigned >= 0], minlength=n)
    caps = host.node_max_tasks
    assert ((caps == 0) | (counts <= caps)).all()
    again = PSP.solve_sparse_spmd(padded, mesh, max_rounds=64,
                                  two_level=True)
    assert np.array_equal(assigned, again.assigned.numpy())
    single_placed = int((port_single(host, max_rounds=64).assigned >= 0).sum())
    assert int((assigned >= 0).sum()) >= single_placed // 2
    assert two.reconcile_rounds >= 1


# ------------------------------------------------- warm plan layout token


def _fake_ssn(token):
    from kube_batch_tpu_torch.solver.warm import warm_state_of

    cache = types.SimpleNamespace()
    ws = warm_state_of(cache)
    ws.valid = True
    ws.snap_gen = 4
    ws.mesh_token = token
    ws.has_releasing = False
    ws.carried = {}
    return types.SimpleNamespace(
        cache=cache, snap_gen=5, dirty_nodes={"n1"},
        dirty_jobs=set(), dirty_jobs_narrow=set(), jobs={}, queues={},
    )


@pytest.fixture
def dispatched(monkeypatch, shards):
    """A process whose last dispatch solved on the CPU, with 8 virtual
    shards and the auto mode."""
    monkeypatch.setitem(PSH._layout_state, "device", torch.device("cpu"))
    monkeypatch.delenv("KBT_SPARSE_SHARD_MODE", raising=False)
    shards(8)


def test_warm_plan_falls_back_on_layout_change(dispatched):
    from kube_batch_tpu_torch.solver.warm import plan_warm

    assert PSH.prospective_layout_token() == "8dev:auto:c8"
    assert plan_warm(_fake_ssn("8dev:two-level"))[0] == "mesh-changed"


def test_warm_plan_passes_on_matching_layout(dispatched):
    from kube_batch_tpu_torch.solver.warm import plan_warm

    # Past the mesh gate, the dirty node gives the ordinary fallback.
    assert plan_warm(_fake_ssn("8dev:auto:c8"))[0] == "node-dirty"


def test_warm_plan_unknown_layout_never_falls_back(monkeypatch):
    from kube_batch_tpu_torch.solver.warm import plan_warm

    monkeypatch.setitem(PSH._layout_state, "device", None)
    assert PSH.prospective_layout_token() is None
    assert plan_warm(_fake_ssn("8dev:auto:c8"))[0] == "node-dirty"


def test_warm_plan_falls_back_on_rack_map_change(dispatched, monkeypatch):
    from kube_batch_tpu_torch.solver.warm import plan_warm

    # Same shard count and mode, a moved node->rack decomposition.
    monkeypatch.setattr(
        PSH, "rack_perm", lambda mesh: np.arange(mesh.size)[::-1].astype(
            np.int32),
    )
    token = PSH.prospective_layout_token()
    assert token.startswith("8dev:auto:") and token != "8dev:auto:c8"
    assert plan_warm(_fake_ssn("8dev:auto:c8"))[0] == "mesh-changed"


def test_warm_plan_falls_back_on_shard_count_change(dispatched, shards):
    from kube_batch_tpu_torch.solver.warm import plan_warm

    shards(4)
    assert plan_warm(_fake_ssn("8dev:auto:c8"))[0] == "mesh-changed"
    shards(1)
    assert PSH.prospective_layout_token() == "1dev:auto"
    assert plan_warm(_fake_ssn("1dev:auto"))[0] == "node-dirty"


# ---------------------------------------------------- device-cache layout


def _packed_arrays(seed=0, T=256, N=256, R=3):
    rng = np.random.RandomState(seed)
    return {
        "task_f32": rng.rand(2, T, R).astype(np.float32),
        "task_i32": rng.randint(0, 4, size=(6, T)).astype(np.int32),
        "node_f32": rng.rand(3, N, R).astype(np.float32),
        "node_i32": rng.randint(0, 2, size=(3, N)).astype(np.int32),
        "group_feas": np.ones((2, N), bool),
        "pair_idx": np.zeros((0,), np.int32),
        "pair_feas": np.zeros((0, N), bool),
        "score_idx": np.zeros((0,), np.int32),
        "score_rows": np.zeros((0, N), np.float32),
        "queue_f32": rng.rand(2, 2, R).astype(np.float32),
        "misc": np.zeros(R + 2, np.float32),
        "cand_idx": rng.randint(0, N, size=(4, 8)).astype(np.int32),
        "cand_static": rng.rand(4, 8).astype(np.float32),
        "cand_info": rng.randint(0, 9, size=(3, 4)).astype(np.int32),
    }


def test_device_cache_layout_flip_forces_labeled_full_reupload():
    from kube_batch_tpu_torch.solver.device_cache import (
        DeviceSnapshotCache, last_pack_stats,
    )

    dc = DeviceSnapshotCache("cpu")
    arrays = _packed_arrays()
    dc.pack(dict(arrays), placement=None, layout_token="1dev:single")
    assert last_pack_stats["full_reasons"]["node_f32"] == "cold"
    dc.pack(dict(arrays), placement=None, layout_token="1dev:single")
    assert last_pack_stats["uploads"] == 0
    assert last_pack_stats["reuses"] == len(arrays)
    mesh = Mesh(["cpu"] * 8)
    out = dc.pack(dict(arrays), placement=mesh, layout_token="8dev:flat:c8")
    assert last_pack_stats.get("layout_change") is True
    assert last_pack_stats["full_reasons"]["node_f32"] == "mesh-change"
    assert last_pack_stats["uploads"] == len(arrays)
    assert dc.placement == mesh and dc.layout_token == "8dev:flat:c8"
    np.testing.assert_array_equal(out.node_f32.numpy(), arrays["node_f32"])


def test_device_cache_patch_keeps_the_placement():
    from kube_batch_tpu_torch.solver.device_cache import (
        DeviceSnapshotCache, last_pack_stats,
    )

    mesh = Mesh(["cpu"] * 8)
    dc = DeviceSnapshotCache("cpu")
    arrays = _packed_arrays(seed=1, N=512)
    dc.pack(dict(arrays), placement=mesh, layout_token="8dev:flat:c8")
    arrays2 = dict(arrays)
    arr2 = arrays["node_f32"].copy()
    arr2[:, 7] += 1.0  # one dirty row -> patch path
    arrays2["node_f32"] = arr2
    out = dc.pack(arrays2, placement=mesh, layout_token="8dev:flat:c8")
    assert last_pack_stats["field_outcomes"]["node_f32"] == "patch"
    assert "layout_change" not in last_pack_stats
    assert dc.placement == mesh
    np.testing.assert_array_equal(out.node_f32.numpy(), arr2)


# ------------------------------------------------ through the scheduler


def _scheduler_binds(mode, monkeypatch):
    from kube_batch_tpu_torch.actions import allocate_tpu as atpu
    from kube_batch_tpu_torch.framework import get_action
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.utils.test_utils import build_cluster

    from tests.test_torch_scheduler import TPU_CONF

    monkeypatch.setenv("KBT_SOLVER_TOPK", "4")
    monkeypatch.setenv("KBT_SPARSE_SHARD_MODE", mode)
    action, _ = get_action("allocate_tpu")
    saved = action.use_kernel
    cache = build_cluster(240, 16, 2, 12, seed=0)
    try:
        sched = Scheduler(cache, TPU_CONF, device="cpu")
        action.use_kernel = False
        sched.run_once()
        assert cache.wait_for_side_effects(timeout=60.0)
        return dict(cache.binder.binds), dict(atpu.last_stats)
    finally:
        action.use_kernel = saved
        cache.shutdown()


def test_forced_flat_through_the_scheduler(monkeypatch, shards):
    from kube_batch_tpu_torch import metrics

    shards(4)
    before = metrics.solver_sparse_sharded.get(("flat",))
    flat_binds, stats = _scheduler_binds("flat", monkeypatch)
    assert stats["sparse_engaged"] is True
    assert stats["sparse_sharded_engaged"] is True
    assert stats["sparse_shard_mode"] == "flat"
    assert stats["sparse_shard_count"] == 4
    assert stats["sparse_reconcile_rounds"] >= 1
    assert (stats["commit_bytes_exchanged"]
            < stats["commit_bytes_full_broadcast"])
    assert stats["backend"] == "torch-cpu"
    assert metrics.solver_sparse_sharded.get(("flat",)) == before + 1
    single_binds, single = _scheduler_binds("off", monkeypatch)
    assert single["sparse_sharded_engaged"] is False
    assert flat_binds == single_binds and len(flat_binds) > 0
    sharded_keys = {"sparse_shard_mode", "sparse_shard_count",
                    "sparse_reconcile_rounds", "commit_bytes_exchanged",
                    "commit_bytes_full_broadcast", "commit_bytes_per_round"}
    assert set(stats) - set(single) == sharded_keys


def test_shard_count_flip_between_cycles(monkeypatch, shards):
    """One scheduler, a carried backlog, the process's shard count
    raised between two cycles: the second cycle's warm plan falls back
    with ``mesh-changed``, its pack re-uploads every buffer labeled
    ``mesh-change``, and its selection rebuilds every key row."""
    from kube_batch_tpu_torch.actions import allocate_tpu as atpu
    from kube_batch_tpu_torch.framework import get_action
    from kube_batch_tpu_torch.scheduler import Scheduler
    from kube_batch_tpu_torch.solver import device_cache as PD
    from kube_batch_tpu_torch.solver import snapshot as PS
    from kube_batch_tpu_torch.utils.test_utils import build_cluster

    from tests.test_torch_scheduler import SHAPE, TPU_CONF

    monkeypatch.setenv("KBT_SOLVER_TOPK", "4")
    monkeypatch.delenv("KBT_SPARSE_SHARD_MODE", raising=False)
    action, _ = get_action("allocate_tpu")
    saved = action.use_kernel
    cache = build_cluster(*SHAPE, seed=0)
    try:
        sched = Scheduler(cache, TPU_CONF, device="cpu")
        action.use_kernel = False
        sched.run_once()
        assert cache.wait_for_side_effects(timeout=60.0)
        assert atpu.last_stats["warm_outcome"] == "cold"
        assert PD.last_pack_stats.get("layout_change") is None
        shards(4)
        sched.run_once()
        assert cache.wait_for_side_effects(timeout=60.0)
        stats = dict(atpu.last_stats)
        pack = dict(PD.last_pack_stats)
        sel = dict(PS.last_tensorize_stats["sparse"])
    finally:
        action.use_kernel = saved
        cache.shutdown()
    assert stats["warm_outcome"] == "mesh-changed"
    assert pack["layout_change"] is True
    assert set(pack["full_reasons"].values()) == {"mesh-change"}
    assert sel["select_path"] == "device"
    assert sel["sel_cache_hits"] == 0 and sel["sel_rows_rebuilt"] > 0
    assert PSH.last_dispatch["shards"] == 4
