"""The port's bid functions against the JAX package's Pallas kernels.

``bid_dense_plain`` / ``bid_sparse_plain`` (what the wrappers run on CPU
tensors, and what the Hopper kernels are held to on the card) must be
bit-equal to ``pallas_bid`` / ``pallas_bid_sparse`` in interpret mode
and to the jnp chain (``bid_keys`` then argmax), on the cases of
tests/solver/test_pallas.py: aligned and unaligned T, static rows, an
all-infeasible column, an all-padding slab row, R = 2 and R = 3, and
LeastRequested/Balanced weights of 1 and otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_batch_tpu.solver.kernels import (
    CPU_DIM,
    MEM_DIM,
    _dyn_score_core,
    bid_keys,
    dynamic_scores,
    less_equal,
)
from kube_batch_tpu.solver.pallas_kernels import (
    TILE_T,
    pallas_bid,
    pallas_bid_sparse,
)

from kube_batch_tpu_torch.solver import bid_kernels as BK

WEIGHTS = [(1.0, 1.0), (0.7, 1.3)]

# These tests run beside the rest of the suite in parallel workers: one
# intra-op thread keeps torch from oversubscribing the shared cores.
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu "
                    "tests/test_torch_bid.py` on the card")
    return torch.device("cuda")


def _case(seed, T, N, R, lr_w, br_w, K=None, static=False):
    rng = np.random.RandomState(seed)
    task_req = rng.uniform(100, 3000, (T, R)).astype(np.float32)
    task_fit = task_req * rng.uniform(1.0, 1.2, (T, 1)).astype(np.float32)
    idle = rng.uniform(500, 32000, (N, R)).astype(np.float32)
    cap = idle * rng.uniform(1.0, 1.5, (N, 1)).astype(np.float32)
    case = dict(
        task_fit=task_fit, task_req=task_req,
        task_ok=rng.rand(T) > 0.1,
        idle=idle, cap=cap, cap_ok=rng.rand(N) > 0.1,
        eps=np.full(R, 10.0, np.float32),
        lr_w=np.float32(lr_w), br_w=np.float32(br_w),
    )
    if K is None:
        case["feas"] = rng.rand(T, N) > 0.2
        case["static"] = (
            rng.uniform(0, 10, (T, N)).astype(np.float32) if static else None
        )
    else:
        rng2 = np.random.RandomState(seed + 1000)
        cand = np.argsort(rng2.rand(T, N), axis=1)[:, :K].astype(np.int32)
        cand[rng2.rand(T, K) < 0.15] = N   # padding sentinels
        cand.sort(axis=1)                  # ascending, sentinels last
        case["cand_nodes"] = cand
        case["cand_static"] = rng2.uniform(0, 5, (T, K)).astype(np.float32)
    return case


def _j(case, *names):
    return [None if case[n] is None else jnp.asarray(case[n]) for n in names]


def _t(case, *names):
    return [None if case[n] is None else torch.from_numpy(np.asarray(case[n]))
            for n in names]


DENSE = ("task_fit", "task_req", "task_ok", "feas", "idle", "cap", "cap_ok",
         "eps")
SPARSE = ("task_fit", "task_req", "task_ok", "cand_nodes", "cand_static",
          "idle", "cap", "cap_ok", "eps")


def jax_dense(case):
    """(pallas_bid interpret, jnp chain) on the case."""
    args = _j(case, *DENSE) + _j(case, "lr_w", "br_w")
    static = _j(case, "static")[0]
    bid_p, any_p = pallas_bid(*args, static_score=static, interpret=True)
    fit, req, ok, feas, idle, cap, cap_ok, eps, lw, bw = args
    T, N = feas.shape
    mask = less_equal(fit[:, None, :], idle[None], eps) & feas
    mask = mask & cap_ok[None, :] & ok[:, None]
    score = dynamic_scores(req, idle, cap, lw, bw)
    if static is not None:
        score = score + static
    key = bid_keys(score, jnp.arange(T, dtype=jnp.int32)[:, None],
                   jnp.arange(N, dtype=jnp.int32)[None, :])
    key = jnp.where(mask, key, -1)
    any_j = jnp.any(mask, axis=1)
    bid_j = jnp.where(any_j, jnp.argmax(key, axis=1).astype(jnp.int32), N)
    return (np.asarray(bid_p), np.asarray(any_p)), (
        np.asarray(bid_j), np.asarray(any_j))


def jax_sparse(case):
    args = _j(case, *SPARSE) + _j(case, "lr_w", "br_w")
    bid_p, any_p = pallas_bid_sparse(*args, interpret=True)
    fit, req, ok, cand, cst, idle, cap, cap_ok, eps, lw, bw = args
    T = fit.shape[0]
    N = idle.shape[0]
    safe = jnp.minimum(cand, N - 1)
    slab = idle[safe]
    mask = less_equal(fit[:, None, :], slab, eps) & (cand < N)
    mask = mask & cap_ok[safe] & ok[:, None]
    dims = (CPU_DIM, MEM_DIM)
    score = _dyn_score_core(req[:, None, dims], slab[..., dims],
                            cap[safe][..., dims], lw, bw) + cst
    key = jnp.where(
        mask, bid_keys(score, jnp.arange(T, dtype=jnp.int32)[:, None], cand),
        -1)
    any_j = jnp.any(mask, axis=1)
    bid_j = jnp.where(
        any_j, cand[jnp.arange(T), jnp.argmax(key, axis=1)], N)
    return (np.asarray(bid_p), np.asarray(any_p)), (
        np.asarray(bid_j), np.asarray(any_j))


def port_dense(case, fn=BK.bid_dense_plain):
    T = case["task_fit"].shape[0]
    bid, any_feas = fn(
        *_t(case, *DENSE), float(case["lr_w"]), float(case["br_w"]),
        torch.arange(T, dtype=torch.int32), _t(case, "static")[0],
    )
    return bid.numpy(), any_feas.numpy()


def port_sparse(case, fn=BK.bid_sparse_plain):
    T = case["task_fit"].shape[0]
    bid, any_feas = fn(
        *_t(case, *SPARSE), float(case["lr_w"]), float(case["br_w"]),
        torch.arange(T, dtype=torch.int32),
    )
    return bid.numpy(), any_feas.numpy()


def assert_bits(port, *refs):
    for ref in refs:
        for a, b in zip(port, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b), np.flatnonzero(a != b)[:10]


@pytest.mark.parametrize("weights", WEIGHTS, ids=["w1", "w07_13"])
@pytest.mark.parametrize(
    "T,N,R,static",
    [
        (2 * TILE_T, 256, 3, False),
        (2 * TILE_T, 256, 2, True),
        (TILE_T - 27, 128, 3, True),       # unaligned T
        (TILE_T + 1, 128, 2, False),
        (3 * TILE_T - 64, 128, 3, True),
    ],
)
def test_bid_dense_bit_equal(T, N, R, static, weights):
    case = _case(T * 7 + R, T, N, R, *weights, static=static)
    pallas, chain = jax_dense(case)
    assert_bits(port_dense(case), pallas, chain)


def test_bid_dense_all_infeasible_column():
    case = _case(5, TILE_T, 128, 3, 1.0, 1.0)
    case["cap_ok"] = np.zeros(128, bool)
    bid, any_feas = port_dense(case)
    assert not any_feas.any() and (bid == 128).all()
    assert_bits((bid, any_feas), *jax_dense(case))


@pytest.mark.parametrize("weights", WEIGHTS, ids=["w1", "w07_13"])
@pytest.mark.parametrize(
    "T,N,K,R",
    [(2 * TILE_T, 256, 8, 3), (2 * TILE_T, 256, 16, 2),
     (TILE_T + 5, 256, 64, 2), (TILE_T - 3, 96, 4, 3)],
)
def test_bid_sparse_bit_equal(T, N, K, R, weights):
    case = _case(T + K, T, N, R, *weights, K=K)
    pallas, chain = jax_sparse(case)
    assert_bits(port_sparse(case), pallas, chain)


def test_bid_sparse_all_padded_row():
    case = _case(5, TILE_T, 128, 3, 1.0, 1.0, K=8)
    case["cand_nodes"][0] = 128
    bid, any_feas = port_sparse(case)
    assert not any_feas[0] and bid[0] == 128
    assert_bits((bid, any_feas), *jax_sparse(case))


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the wrappers return the plain result and launch
    nothing."""
    before = (BK.bid_dense.launches, BK.bid_sparse.launches)
    dcase = _case(1, 100, 64, 2, 0.7, 1.3, static=True)
    assert_bits(port_dense(dcase, BK.bid_dense), port_dense(dcase))
    scase = _case(2, 100, 64, 2, 0.7, 1.3, K=16)
    assert_bits(port_sparse(scase, BK.bid_sparse), port_sparse(scase))
    assert (BK.bid_dense.launches, BK.bid_sparse.launches) == before


def test_wrapper_rejects_bad_input_before_launch():
    """Shape/dtype checks raise before anything is built or launched;
    runs on meta tensors, which reach the kernel path."""
    case = _case(3, 64, 32, 2, 1.0, 1.0)
    meta = {k: torch.empty(np.shape(v), dtype=torch.from_numpy(
        np.asarray(v)).dtype, device="meta")
        for k, v in case.items() if v is not None and np.ndim(v)}
    with pytest.raises(TypeError):
        BK.bid_dense(
            meta["task_fit"].double(), meta["task_req"], meta["task_ok"],
            meta["feas"], meta["idle"], meta["cap"], meta["cap_ok"],
            meta["eps"], 1.0, 1.0,
            torch.empty(64, dtype=torch.int32, device="meta"),
        )
    with pytest.raises(ValueError):
        BK.bid_dense(
            meta["task_fit"], meta["task_req"], meta["task_ok"],
            meta["feas"][:, :5], meta["idle"], meta["cap"], meta["cap_ok"],
            meta["eps"], 1.0, 1.0,
            torch.empty(64, dtype=torch.int32, device="meta"),
        )
    assert BK.bid_dense.launches == 0


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda_device):
    """The Hopper kernels against their plain versions on the card
    (skipped without CUDA; chip_smoke.py runs the same comparison at
    the main path's shapes)."""
    for case, run in (
        (_case(7, 1001, 333, 3, 0.7, 1.3, static=True), port_dense),
        (_case(8, 1000, 300, 2, 1.0, 1.0, K=64), port_sparse),
    ):
        dev = {k: (torch.from_numpy(np.asarray(v)).to(cuda_device)
                   if v is not None and np.ndim(v) else v)
               for k, v in case.items()}
        names = DENSE if run is port_dense else SPARSE
        fn, plain = ((BK.bid_dense, BK.bid_dense_plain) if run is port_dense
                     else (BK.bid_sparse, BK.bid_sparse_plain))
        extra = [dev["static"]] if run is port_dense else []
        T = case["task_fit"].shape[0]
        ids = torch.arange(T, dtype=torch.int32, device=cuda_device)
        args = ([dev[n] for n in names]
                + [float(case["lr_w"]), float(case["br_w"]), ids] + extra)
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
