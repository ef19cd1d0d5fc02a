"""Parity of the port's dense SPMD solve (``solver/spmd.py`` through
``sharding.solve_sharded``) with the JAX package's, on the CPU.

The same host bundles, made from a NumPy seed (the shapes and cases of
``tests/solver/test_sharding.py``) or by the JAX package's own
``tensorize``, go through the JAX package's ``solve_sharded`` on the
conftest's virtual 8-device CPU mesh (or a submesh of 2 or 4 devices)
and through the port's on a mesh of as many virtual CPU shards. The
port's sharded result must also equal its own single-device plain chain
(``use_kernel=False``), which the JAX sharded program equals in turn.

Tolerance: none. ``assigned``, ``node_idle``, ``queue_allocated``,
``rounds`` and ``stages`` are compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from kube_batch_tpu.solver import kernels as JK
from kube_batch_tpu.solver import sharding as JSH
from kube_batch_tpu.solver import spmd as JSP

from kube_batch_tpu_torch.solver import kernels as PK
from kube_batch_tpu_torch.solver import sharding as PSH
from kube_batch_tpu_torch.solver import spmd as PSP
from kube_batch_tpu_torch.solver.collectives import Mesh

torch.set_num_threads(1)


def synthetic_host(T, N, R=3, Q=2, J=None, seed=0, feas_p=0.9):
    """A host bundle (NumPy fields) shaped like the reference's
    ``synthetic_inputs``."""
    J = J or max(T // 8, 1)
    rng = np.random.RandomState(seed)
    task_req = rng.uniform(100.0, 2000.0, size=(T, R)).astype(np.float32)
    node_idle = rng.uniform(4000.0, 32000.0, size=(N, R)).astype(np.float32)
    inputs = JK.make_inputs(
        feas=jnp.asarray(rng.rand(T, N) < feas_p),
        task_req=jnp.asarray(task_req),
        task_fit=jnp.asarray(task_req),
        task_rank=jnp.arange(T, dtype=jnp.int32),
        task_job=jnp.asarray(np.sort(rng.randint(0, J, size=T)), jnp.int32),
        task_queue=jnp.asarray(rng.randint(0, Q, size=T), jnp.int32),
        node_idle=jnp.asarray(node_idle),
        node_releasing=jnp.zeros((N, R), jnp.float32),
        node_cap=jnp.asarray(node_idle),
        node_task_count=jnp.zeros(N, jnp.int32),
        node_max_tasks=jnp.zeros(N, jnp.int32),
        queue_deserved=jnp.full((Q, R), np.inf, dtype=jnp.float32),
        queue_allocated=jnp.zeros((Q, R), jnp.float32),
        eps=jnp.full((R,), 10.0, jnp.float32),
        lr_weight=jnp.asarray(1.0, jnp.float32),
        br_weight=jnp.asarray(1.0, jnp.float32),
    )
    return JK.SolverInputs(*[None if v is None else np.asarray(v)
                             for v in inputs])


def to_jax(host):
    return JK.SolverInputs(*[None if v is None else jnp.asarray(v)
                             for v in host])


def to_port(host):
    return PK.SolverInputs(*[
        None if v is None else torch.from_numpy(np.array(v)) for v in host
    ])


def jax_mesh(size):
    devices = jax.devices()
    if len(devices) < size:
        pytest.skip(f"needs the {size}-device virtual CPU mesh (conftest)")
    return JMesh(np.asarray(devices[:size]), ("nodes",))


def as_numpy(r):
    opt = lambda v: None if v is None else int(v)  # noqa: E731
    return {
        "assigned": np.asarray(r.assigned),
        "node_idle": np.asarray(r.node_idle),
        "queue_allocated": np.asarray(r.queue_allocated),
        "rounds": int(r.rounds),
        "stages": opt(r.stages),
    }


def assert_bits(got, ref, n_nodes=None):
    for key in ("rounds", "stages"):
        assert got[key] == ref[key], (key, got[key], ref[key])
    for key in ("assigned", "node_idle", "queue_allocated"):
        a, b = got[key], ref[key]
        if key == "node_idle" and n_nodes is not None:
            a, b = a[:n_nodes], b[:n_nodes]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (
            key, np.flatnonzero(a.reshape(-1) != b.reshape(-1))[:10],
        )


def both_sharded(host, size, **kw):
    """(port, jax) results of ``solve_sharded`` on ``size`` shards."""
    jr = JSH.solve_sharded(to_jax(host), jax_mesh(size), **kw)
    pr = PSH.solve_sharded(to_port(host), Mesh(["cpu"] * size), **kw)
    return as_numpy(pr), as_numpy(jr)


def port_single(host, staged=False, **kw):
    fn = PK.solve_staged if staged else PK.solve
    return as_numpy(fn(to_port(host), use_kernel=False, **kw))


@pytest.mark.parametrize("shape", [(16, 8), (64, 128), (256, 64)])
def test_matches_jax_and_single_device(shape):
    T, N = shape
    host = synthetic_host(T, N, seed=T + N)
    got, ref = both_sharded(host, 8, max_rounds=64, staged=False)
    assert_bits(got, ref)
    assert PSH.last_dispatch == {
        "mode": "dense-spmd", "shards": 8, "sparse_sharded": False,
    }
    assert_bits(got, port_single(host, max_rounds=64))
    assert got["assigned"].max() >= 0


@pytest.mark.parametrize("size", [2, 4])
def test_shard_counts(size):
    host = synthetic_host(96, 40, seed=17)
    got, ref = both_sharded(host, size, max_rounds=64, staged=False)
    assert_bits(got, ref)
    assert_bits(got, port_single(host, max_rounds=64))


@pytest.mark.parametrize("T,N,seed", [(48, 20, 7), (256, 1001, 13)])
def test_ragged_node_count_pads(T, N, seed):
    # N not divisible by 8: pad_nodes inside solve_sharded; padded
    # nodes never receive assignments.
    host = synthetic_host(T, N, seed=seed)
    got, ref = both_sharded(host, 8, max_rounds=64, staged=False)
    assert_bits(got, ref)
    assert got["node_idle"].shape[0] % 8 == 0
    assert got["assigned"].max() < N
    assert_bits(got, port_single(host, max_rounds=64), n_nodes=N)


def test_staged_matches_single_staged():
    # A small tail bucket forces the staged head/tail structure.
    host = synthetic_host(128, 64, seed=3)
    got, ref = both_sharded(host, 8, max_rounds=64, staged=True,
                            tail_bucket=32)
    assert_bits(got, ref)
    assert_bits(got, port_single(host, staged=True, max_rounds=64,
                                 tail_bucket=32))


def test_commit_style_round(monkeypatch):
    # Task blocks above _POOL_MAX_T use the per-commit reconcile; force
    # it on a test-sized instance in both packages.
    monkeypatch.setattr(JSP, "_POOL_MAX_T", 0)
    monkeypatch.setattr(PSP, "_POOL_MAX_T", 0)
    JSP._spmd_step.cache_clear()
    try:
        host = synthetic_host(192, 72, seed=21)
        got, ref = both_sharded(host, 8, max_rounds=64, staged=False)
    finally:
        JSP._spmd_step.cache_clear()
    assert_bits(got, ref)
    assert_bits(got, port_single(host, max_rounds=64))


def test_commit_style_staged_tail(monkeypatch):
    # Both styles in one solve: a commit-style head and pool-style tails.
    monkeypatch.setattr(JSP, "_POOL_MAX_T", 100)
    monkeypatch.setattr(PSP, "_POOL_MAX_T", 100)
    JSP._spmd_step.cache_clear()
    try:
        host = synthetic_host(160, 48, seed=8, feas_p=0.6)
        got, ref = both_sharded(host, 4, max_rounds=64, staged=True,
                                tail_bucket=48)
    finally:
        JSP._spmd_step.cache_clear()
    assert_bits(got, ref)
    assert_bits(got, port_single(host, staged=True, max_rounds=64,
                                 tail_bucket=48))


def test_queue_budgets_and_job_break():
    # Budget-capped queues and the job-break verdict cross the
    # hierarchical reconcile (failed derives from gathered maxima).
    host = synthetic_host(64, 24, Q=2, seed=29, feas_p=0.7)
    deserved = np.full((2, 3), np.inf, np.float32)
    deserved[0] = 3000.0
    group_feas = host.group_feas.copy()
    group_feas[host.task_group[5]] = False
    host = host._replace(queue_deserved=deserved, group_feas=group_feas)
    got, ref = both_sharded(host, 8, max_rounds=64, staged=False)
    assert_bits(got, ref)
    assert_bits(got, port_single(host, max_rounds=64))


def test_staged_smaller_than_tail_bucket():
    # staged=True on a snapshot smaller than the tail bucket falls back
    # to the full-width solve (solve_staged's escape).
    host = synthetic_host(48, 16, seed=5)
    got, ref = both_sharded(host, 8, max_rounds=64, staged=True)
    assert_bits(got, ref)
    assert got["stages"] is None
    assert_bits(got, port_single(host, max_rounds=64))


def test_releasing_capacity_and_static_scores():
    # fits_releasing crosses the mesh by psum, static score rows split
    # by column: a bundle with both.
    host = synthetic_host(80, 32, seed=31, feas_p=0.5)
    rng = np.random.RandomState(31)
    releasing = rng.uniform(0.0, 3000.0, size=host.node_idle.shape)
    idle = host.node_idle.copy()
    idle[::3] = 50.0
    score_idx = np.arange(0, 80, 5, dtype=np.int32)
    score_rows = rng.uniform(0.0, 4.0, size=(len(score_idx), 32))
    host = host._replace(
        node_idle=idle.astype(np.float32),
        node_releasing=releasing.astype(np.float32),
        score_idx=score_idx, score_rows=score_rows.astype(np.float32),
    )
    got, ref = both_sharded(host, 4, max_rounds=64, staged=False)
    assert_bits(got, ref)
    assert_bits(got, port_single(host, max_rounds=64))


def test_two_device_submesh():
    host = synthetic_host(32, 16, seed=11)
    got, ref = both_sharded(host, 2, max_rounds=64, staged=False)
    assert_bits(got, ref)


def test_packed_inputs_from_tensorize():
    """A real session snapshot (the JAX package's tensorize, packed for
    the port) solved sharded equals the JAX package's sharded solve."""
    from kube_batch_tpu_torch.solver.snapshot import pack_inputs
    from tests.test_torch_solver import snapshot_tensorized

    host = snapshot_tensorized("off")
    jr = JSH.solve_sharded(to_jax(host), jax_mesh(4), max_rounds=64,
                           staged=False)
    packed = pack_inputs(host, "cpu")
    pr = PSH.solve_sharded(packed, Mesh(["cpu"] * 4), max_rounds=64,
                           staged=False)
    assert_bits(as_numpy(pr), as_numpy(jr))
    single = PK.solve(packed, max_rounds=64, use_kernel=False)
    assert torch.equal(single.assigned, pr.assigned)
    assert int((pr.assigned >= 0).sum()) > 0


def test_pad_nodes_and_tasks_match_reference():
    host = synthetic_host(13, 10, seed=1)
    host = host._replace(
        task_cand=np.arange(13, dtype=np.int32) % 3,
        cand_idx=np.array([[0, 9, 10], [3, 10, 10], [1, 2, 4]], np.int32),
        cand_static=np.zeros((3, 3), np.float32),
        cand_info=np.zeros((3, 3), np.int32),
    )
    for fn_p, fn_j in ((PSH.pad_nodes, JSH.pad_nodes),
                       (PSH.pad_tasks, JSH.pad_tasks)):
        got = fn_p(to_port(host), 8)
        ref = fn_j(to_jax(host), 8)
        for f in PK.SolverInputs._fields:
            a, b = getattr(got, f), getattr(ref, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f)
    padded = PSH.pad_nodes(to_port(host), 8)
    assert padded.node_idle.shape[0] == 16
    assert not bool(padded.node_feas[10:].any())
    # The slab sentinel moved past the padded node count.
    assert int(padded.cand_idx.max()) == 16
    # No pad needed: the identity.
    same = to_port(synthetic_host(8, 16, seed=1))
    assert PSH.pad_nodes(same, 8) is same
