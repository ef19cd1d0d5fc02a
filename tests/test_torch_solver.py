"""Parity of the port's dense and staged solvers with the JAX package.

The same host snapshots (NumPy ``SolverInputs``, made from a seed or by
the JAX package's own ``tensorize``) go through both packages in two
configurations:

- the JAX default chain against the port's ``use_kernel=False``;
- the JAX package with its Pallas bid kernels forced on (interpret mode
  on the CPU, patched in the test only) against ``use_kernel=True``,
  where the port's wrappers run their plain versions on CPU tensors.

``assigned``, ``node_idle``, ``queue_allocated``, ``rounds`` and
``stages`` must be bit-equal. The snapshot builders here are shared by
the other ``tests/test_torch_*.py`` files.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.solver import kernels as JK
from kube_batch_tpu.solver import pallas_kernels as JP
from kube_batch_tpu.solver.masks import CombinedMask
from kube_batch_tpu.solver.topk import select_candidates as jax_select

from kube_batch_tpu_torch.solver import kernels as PK
from kube_batch_tpu_torch.solver.snapshot import pack_inputs

TAIL_BUCKET = 64

# These tests run beside the rest of the suite in parallel workers: one
# intra-op thread keeps torch from oversubscribing the shared cores.
torch.set_num_threads(1)


def _pow2(n):
    return 1 if n <= 0 else 1 << (n - 1).bit_length()


def _pad(a, rows, fill=0):
    out = np.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _build_host(*, task_req, task_fit, task_job, task_queue, task_group,
                node_idle, node_cap, node_releasing, node_task_count,
                node_max_tasks, node_ok, group_rows, pair_idx, pair_rows,
                score_rows_map, queue_deserved, queue_allocated,
                lr_w, br_w, Tp, Np, k=None):
    """A host bundle padded the way tensorize pads one (tasks to Tp,
    nodes to Np, pair/score/class rows to powers of two), with candidate
    slabs from the JAX package's host selection when ``k`` is given."""
    T, R = task_req.shape
    N = node_idle.shape[0]
    eps = np.full(R, 10.0, np.float32)
    cand = None
    if k is not None:
        mask = CombinedMask(node_ok, task_group, group_rows, pair_idx,
                            pair_rows)
        cand = jax_select(
            mask, score_rows_map, task_req, task_fit, node_idle, node_cap,
            node_releasing, node_task_count, node_max_tasks, eps,
            lr_w, br_w, k,
        )
    P, S = len(pair_idx), len(score_rows_map)
    Pp, Sp = _pow2(P), _pow2(S)
    pair_idx_p = np.full(Pp, Tp, np.int32)
    pair_idx_p[:P] = pair_idx
    pair_feas = np.ones((Pp, Np), bool)
    pair_feas[:P, :N] = pair_rows
    pair_feas[:, N:] = False
    score_idx = np.full(Sp, Tp, np.int32)
    score_rows = np.zeros((Sp, Np), np.float32)
    for i, t in enumerate(sorted(score_rows_map)):
        score_idx[i] = t
        score_rows[i, :N] = score_rows_map[t]
    if cand is not None:
        cand_idx = cand.cand_idx
        cand_idx[cand_idx >= N] = Np
        Cn = cand_idx.shape[0]
        Cp = _pow2(Cn)
        task_cand = _pad(cand.task_cand, Tp)
        cand_idx = _pad(cand_idx, Cp, fill=Np)
        cand_static = _pad(cand.cand_static, Cp)
        cand_info = np.zeros((3, Cp), np.int32)
        cand_info[:, :Cn] = cand.cand_info
    else:
        task_cand = np.zeros(Tp, np.int32)
        cand_idx = np.zeros((0, 1), np.int32)
        cand_static = np.zeros((0, 1), np.float32)
        cand_info = np.zeros((3, 0), np.int32)
    task_valid = np.zeros(Tp, bool)
    task_valid[:T] = True
    return JK.SolverInputs(
        task_req=_pad(task_req, Tp), task_fit=_pad(task_fit, Tp),
        task_rank=np.arange(Tp, dtype=np.int32),
        task_job=np.concatenate(
            [task_job, np.arange(T, Tp)]).astype(np.int32),
        task_queue=_pad(task_queue, Tp), task_valid=task_valid,
        task_group=_pad(task_group, Tp),
        node_feas=_pad(node_ok, Np, fill=False),
        group_feas=np.ascontiguousarray(
            _pad(group_rows.T, Np, fill=False).T),
        pair_idx=pair_idx_p, pair_feas=pair_feas,
        score_idx=score_idx, score_rows=score_rows,
        node_idle=_pad(node_idle, Np), node_releasing=_pad(node_releasing, Np),
        node_cap=_pad(node_cap, Np),
        node_task_count=_pad(node_task_count, Np),
        node_max_tasks=_pad(node_max_tasks, Np),
        queue_deserved=queue_deserved, queue_allocated=queue_allocated,
        eps=eps, lr_weight=np.float32(lr_w), br_weight=np.float32(br_w),
        task_cand=task_cand, cand_idx=cand_idx, cand_static=cand_static,
        cand_info=cand_info,
    )


@functools.lru_cache(maxsize=None)
def snapshot_mixed(seed=0, k=None, T=300, N=40):
    """Queue budgets, job breaks (tasks too large for any idle), the
    Releasing escape (some of those fit Releasing capacity), pod-count
    limits, private feasibility and score rows, fit > req rows, padded
    tasks and nodes, LeastRequested/Balanced weights other than 1."""
    rng = np.random.RandomState(seed)
    R, Q, G = 2, 3, 3
    req = np.c_[
        rng.choice([250, 500, 1000, 2000, 4000], T),
        rng.choice([256, 512, 1024, 4096, 8192], T),
    ].astype(np.float32)
    huge = rng.rand(T) < 0.04
    req[huge, 0] = rng.choice([48000, 96000], int(huge.sum()))
    fit = req.copy()
    grow = rng.rand(T) < 0.1
    fit[grow] += np.float32(100.0)
    idle = np.c_[
        rng.choice([8000, 16000, 32000], N),
        rng.choice([32768, 65536, 131072], N),
    ].astype(np.float32)
    cap = np.tile(np.array([[32000, 131072]], np.float32), (N, 1))
    releasing = np.zeros((N, R), np.float32)
    releasing[:2] = [64000, 262144]        # fits 48000, not 96000 mCPU
    queue = rng.randint(0, Q, T).astype(np.int32)
    demand = np.stack([req[queue == q].sum(0) for q in range(Q)])
    deserved = np.full((Q, R), np.inf, np.float32)
    deserved[1] = demand[1] * np.float32(0.4)
    deserved[2] = demand[2] * np.float32(0.7)
    allocated = np.zeros((Q, R), np.float32)
    allocated[2] = [3000, 6000]
    group_rows = rng.rand(G, N) > 0.2
    pair_idx = np.array(sorted(rng.choice(T, 3, replace=False)), np.int32)
    score_map = {
        int(t): rng.uniform(0, 5, N).astype(np.float32)
        for t in rng.choice(T, 2, replace=False)
    }
    return _build_host(
        task_req=req, task_fit=fit, task_job=(np.arange(T) // 6),
        task_queue=queue, task_group=rng.randint(0, G, T).astype(np.int32),
        node_idle=idle, node_cap=cap, node_releasing=releasing,
        node_task_count=rng.randint(0, 4, N).astype(np.int32),
        node_max_tasks=rng.choice([0, 5, 110], N).astype(np.int32),
        node_ok=rng.rand(N) > 0.05, group_rows=group_rows,
        pair_idx=pair_idx, pair_rows=rng.rand(3, N) > 0.3,
        score_rows_map=score_map, queue_deserved=deserved,
        queue_allocated=allocated, lr_w=0.7, br_w=1.3,
        Tp=_pow2(T + 1), Np=N + 8, k=k,
    )


@functools.lru_cache(maxsize=None)
def snapshot_bigsum(seed=1, k=None, T=2500, N=64):
    """Queue sums past 2^24: thousands of odd-MiB tasks land in one
    queue in one commit, its running allocation starts near 9e6 MiB
    and its budget cuts the queue pass at those magnitudes, where
    float32 addition order decides the last bits."""
    rng = np.random.RandomState(seed)
    R = 2
    req = np.c_[
        rng.choice([250, 500, 1000, 2000], T),
        rng.choice([4097, 8191, 12289], T),
    ].astype(np.float32)
    queue = (rng.rand(T) < 0.1).astype(np.int32)
    idle = np.c_[np.full(N, 200000), np.full(N, 1_000_003)].astype(np.float32)
    allocated = np.array([[1e6, 9_000_001], [0, 0]], np.float32)
    demand0 = req[queue == 0].sum(0)
    deserved = np.full((2, R), np.inf, np.float32)
    deserved[0] = allocated[0] + demand0 * np.float32(0.75)
    return _build_host(
        task_req=req, task_fit=req.copy(), task_job=np.arange(T) // 50,
        task_queue=queue, task_group=np.zeros(T, np.int32),
        node_idle=idle, node_cap=idle.copy(),
        node_releasing=np.zeros((N, R), np.float32),
        node_task_count=np.zeros(N, np.int32),
        node_max_tasks=np.full(N, 60, np.int32),
        node_ok=np.ones(N, bool), group_rows=np.ones((1, N), bool),
        pair_idx=np.zeros(0, np.int32), pair_rows=np.zeros((0, N), bool),
        score_rows_map={}, queue_deserved=deserved,
        queue_allocated=allocated, lr_w=1.0, br_w=1.0,
        Tp=_pow2(T), Np=N, k=k,
    )


@functools.lru_cache(maxsize=None)
def snapshot_tensorized(topk="off"):
    """The JAX package's own tensorize on bench.build_cluster (weighted
    queues, gangs with random minMember, default tiers), with host
    candidate selection. Returns the NumPy ``ctx.host_inputs``."""
    import os

    from bench import TIERS_ARGS, build_cluster
    from kube_batch_tpu.framework import close_session, open_session
    from kube_batch_tpu.solver import tensorize
    from tests.actions.test_actions import make_tiers

    saved = {k: os.environ.get(k) for k in
             ("KBT_SOLVER_TOPK", "KBT_SELECT_DEVICE")}
    os.environ["KBT_SOLVER_TOPK"] = topk
    # Host selection: the device path fails on this JAX version, and
    # the JAX package makes the two bit-equal.
    os.environ["KBT_SELECT_DEVICE"] = "0"
    try:
        cache = build_cluster(600, 48, 3, 12, seed=3)
        ssn = open_session(cache, make_tiers(*TIERS_ARGS))
        _, ctx = tensorize(ssn, device=False)
        close_session(ssn)
        cache.shutdown()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return ctx.host_inputs


SNAPSHOTS = {
    "mixed": lambda: snapshot_mixed(),
    "bigsum": lambda: snapshot_bigsum(),
    "tensorized": lambda: snapshot_tensorized("off"),
}


def to_jax(host):
    return JK.SolverInputs(*[
        None if v is None else jnp.asarray(v) for v in host
    ])


@pytest.fixture
def forced_pallas(monkeypatch):
    """The JAX package's Pallas configuration on the CPU: the gate
    forced on and both kernels in interpret mode."""
    monkeypatch.setattr(JK, "_should_use_pallas", lambda: True)
    monkeypatch.setattr(
        JP, "pallas_bid", functools.partial(JP.pallas_bid, interpret=True)
    )
    monkeypatch.setattr(
        JP, "pallas_bid_sparse",
        functools.partial(JP.pallas_bid_sparse, interpret=True),
    )


JK_JIT = {
    "solve": JK.solve_full_jit,
    "solve_staged": JK.solve_staged_jit,
    "solve_sparse": JK.solve_sparse_jit,
    "solve_auto": JK.solve_jit,
}


def jax_result(name, host, kernel, **kw):
    fn = getattr(JK, name) if kernel else JK_JIT[name]
    r = fn(to_jax(host), **kw)
    opt = lambda v: None if v is None else int(v)  # noqa: E731
    return {
        "assigned": np.asarray(r.assigned),
        "node_idle": np.asarray(r.node_idle),
        "queue_allocated": np.asarray(r.queue_allocated),
        "rounds": int(r.rounds),
        "stages": opt(r.stages),
        "refills": opt(r.refills),
    }


def port_result(name, host, kernel, **kw):
    r = getattr(PK, name)(pack_inputs(host, "cpu"), use_kernel=kernel, **kw)
    return r.to_numpy()


def assert_same(port, ref):
    for key in ("rounds", "stages", "refills"):
        assert port[key] == ref[key], (key, port[key], ref[key])
    for key in ("assigned", "node_idle", "queue_allocated"):
        a, b = port[key], ref[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (
            key, np.flatnonzero(a.reshape(-1) != b.reshape(-1))[:10],
        )


def round0_keys(host):
    """Round-0 quantized bid keys (dynamic + static score, hashed) of
    both packages on the snapshot's full [T, N] surface."""
    j = to_jax(host)
    feas = JK.build_feasibility(j)
    static = JK.build_static_score(j)
    T, N = feas.shape
    key_fn = jax.jit(lambda j: JK.bid_keys(
        JK.dynamic_scores(j.task_req, j.node_idle, j.node_cap,
                          j.lr_weight, j.br_weight) + static,
        j.task_rank[:, None], jnp.arange(N, dtype=jnp.int32)[None, :],
    ))
    jk = np.asarray(key_fn(j))
    p = PK._as_inputs(pack_inputs(host, "cpu"))
    score = PK.dynamic_scores(p.task_req, p.node_idle, p.node_cap,
                              float(p.lr_weight), float(p.br_weight))
    ps = PK.build_static_score(p)
    if ps is not None:
        score = score + ps
    pk = PK.bid_keys(
        score, p.task_rank[:, None],
        torch.arange(N, dtype=torch.int32)[None, :],
    ).numpy()
    return jk, pk


@pytest.mark.parametrize("snap", sorted(SNAPSHOTS))
def test_round0_keys_bit_equal(snap):
    jk, pk = round0_keys(SNAPSHOTS[snap]())
    bad = np.argwhere(jk != pk)
    assert bad.size == 0, f"{len(bad)} keys differ, first at {bad[:5]}"


@pytest.mark.parametrize("kernel", [False, True], ids=["chain", "kernel"])
@pytest.mark.parametrize("snap", sorted(SNAPSHOTS))
def test_solve_bit_equal(snap, kernel, request):
    if kernel:
        request.getfixturevalue("forced_pallas")
    host = SNAPSHOTS[snap]()
    assert_same(port_result("solve", host, kernel),
                jax_result("solve", host, kernel))


@pytest.mark.parametrize("kernel", [False, True], ids=["chain", "kernel"])
@pytest.mark.parametrize("snap", ["bigsum", "mixed"])
def test_solve_staged_bit_equal(snap, kernel, request):
    if kernel:
        request.getfixturevalue("forced_pallas")
    host = SNAPSHOTS[snap]()
    port = port_result("solve_staged", host, kernel, tail_bucket=TAIL_BUCKET)
    if snap == "mixed":
        assert port["stages"] >= 1  # the compacted tail ran
    assert_same(port, jax_result("solve_staged", host, kernel,
                                 tail_bucket=TAIL_BUCKET))


def test_bigsum_queue_sums_pass_2_24():
    """The bigsum snapshot really reaches the magnitudes it is for."""
    r = port_result("solve", snapshot_bigsum(), False)
    assert r["queue_allocated"][0, 1] > 2 ** 24


class TestPrimitives:
    def test_segment_sum_task_order_past_2_24(self):
        rng = np.random.RandomState(5)
        vals = (rng.choice([4097.0, 8191.0, 12289.0, 3.5], (6000, 2))
                * 3.7).astype(np.float32)
        seg = rng.randint(0, 4, 6000).astype(np.int32)
        ref = np.asarray(jax.jit(
            lambda v, s: jax.ops.segment_sum(v, s, num_segments=4)
        )(vals, seg))
        got = PK._segment_sum(torch.from_numpy(vals),
                              torch.from_numpy(seg), 4).numpy()
        # The data is order-sensitive: folding it backwards differs.
        backwards = np.zeros((4, 2), np.float32)
        np.add.at(backwards, seg[::-1], vals[::-1])
        assert ref.max() > 2 ** 24 and not np.array_equal(backwards, ref)
        assert np.array_equal(got, ref)

    @pytest.mark.parametrize("n", [1, 2, 7, 64, 1001])
    def test_segmented_cumsum_same_association(self, n):
        rng = np.random.RandomState(n)
        x = (rng.choice([4097.0, 8191.0, 0.3], (n, 2)) * 997).astype(
            np.float32)
        starts = rng.rand(n) < 0.05
        starts[0] = True
        ref = np.asarray(jax.jit(JK.segmented_cumsum)(x, starts))
        got = PK.segmented_cumsum(torch.from_numpy(x),
                                  torch.from_numpy(starts)).numpy()
        assert np.array_equal(got, ref)

    def test_segmented_cummin(self):
        rng = np.random.RandomState(9)
        x = rng.randint(0, 1000, 257).astype(np.int32)
        starts = rng.rand(257) < 0.1
        starts[0] = True
        ref = np.asarray(jax.jit(JK.segmented_cummin)(x, starts))
        got = PK.segmented_cummin(torch.from_numpy(x),
                                  torch.from_numpy(starts)).numpy()
        assert np.array_equal(got, ref)

    def test_fma_is_one_rounding(self):
        """Correct rounding of a*b + c, including sums whose float64
        value lands exactly on a float32 midpoint."""
        from fractions import Fraction

        rng = np.random.RandomState(2)
        a = rng.uniform(-3, 3, 3000).astype(np.float32)
        b = rng.uniform(-3, 3, 3000).astype(np.float32)
        c = rng.uniform(-3, 3, 3000).astype(np.float32)
        # 1 + 2^-11 + 2^-24 is a float32 midpoint; +-2^-60 moves the
        # exact sum off it while float64 rounds back onto it.
        m = np.float32(1 + 2 ** -12)
        tiny = np.float32(2 ** -60)
        a = np.r_[a, m, m, -m, m]
        b = np.r_[b, m, m, m, m]
        c = np.r_[c, tiny, -tiny, -tiny, np.float32(0)]
        got = PK._fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(c)).numpy()
        for r, x, y, z in zip(got, a, b, c):
            exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
            d = abs(Fraction(float(r)) - exact)
            for nb in (np.nextafter(r, np.float32(np.inf)),
                       np.nextafter(r, np.float32(-np.inf))):
                dn = abs(Fraction(float(nb)) - exact)
                assert d <= dn, (x, y, z, r)
                if d == dn:
                    assert int(r.view(np.int32)) % 2 == 0


def test_make_inputs_dense_mask_and_scores():
    """``make_inputs`` folds dense [T, N] masks and scores the way the
    JAX package's does: the same solve on both."""
    rng = np.random.RandomState(4)
    T, N = 90, 12
    req = np.c_[rng.choice([500, 1000, 2000], T),
                rng.choice([512, 1024], T)].astype(np.float32)
    idle = np.c_[rng.choice([4000, 8000], N),
                 np.full(N, 16384)].astype(np.float32)
    kw = dict(
        task_req=req, task_fit=req, task_rank=np.arange(T, dtype=np.int32),
        task_job=(np.arange(T) // 3).astype(np.int32),
        task_queue=np.zeros(T, np.int32), node_idle=idle,
        node_releasing=np.zeros_like(idle), node_cap=idle,
        node_task_count=np.zeros(N, np.int32),
        node_max_tasks=np.zeros(N, np.int32),
        queue_deserved=np.full((1, 2), np.inf, np.float32),
        queue_allocated=np.zeros((1, 2), np.float32),
        eps=np.full(2, 10.0, np.float32),
        lr_weight=np.float32(1.0), br_weight=np.float32(1.0),
    )
    feas = rng.rand(T, N) > 0.3
    static = rng.uniform(0, 3, (T, N)).astype(np.float32)
    ref = JK.solve_full_jit(JK.make_inputs(
        feas=jnp.asarray(feas), static_score=jnp.asarray(static),
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = PK.solve(PK.make_inputs(
        feas=torch.from_numpy(feas), static_score=torch.from_numpy(static),
        **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}))
    assert np.array_equal(got.assigned.numpy(), np.asarray(ref.assigned))
    assert np.array_equal(got.node_idle.numpy(), np.asarray(ref.node_idle))
    assert got.rounds == int(ref.rounds)
