"""The port's bid functions against the JAX package's Pallas kernels.

``bid_dense_plain`` / ``bid_sparse_plain`` (what the wrappers run on CPU
tensors, and what the Hopper kernels are held to on the card) must be
bit-equal to ``pallas_bid`` / ``pallas_bid_sparse`` in interpret mode
and to the jnp chain (``bid_keys`` then argmax), on the cases of
tests/solver/test_pallas.py: aligned and unaligned T, static rows, an
all-infeasible column, an all-padding slab row, R = 2 and R = 3, and
LeastRequested/Balanced weights of 1 and otherwise; and on the cases the
Hopper kernels' design turns on (``EDGE``): identical nodes (ties
everywhere), R = 8, a zero-capacity dimension, capacities from 2^-120 to
2^120, K = 37. The last tests hold the two arithmetic identities the
kernels rest on (the reciprocal route for division, the key's rounding)
against IEEE float32.
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


def _case(seed, T, N, R, lr_w, br_w, K=None, static=False, variant=None):
    """Seeded bid inputs; ``variant`` reshapes the nodes (and requests)
    after the common draws: ``identical`` nodes, ``zero_cap`` (zero or
    negative capacity in one dimension on some nodes), ``extreme``
    (capacities 2^-120..2^120, idle up to twice the capacity, requests
    2^-100..2^100, an epsilon that lets every task fit)."""
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
    rng3 = np.random.RandomState(seed + 2000)
    idle, cap = case["idle"], case["cap"]
    if variant == "identical":
        idle[:] = idle[0]
        cap[:] = cap[0]
        case["cap_ok"][:] = True
    elif variant == "zero_cap":
        cap[rng3.rand(N) < 0.2, 0] = 0.0
        cap[rng3.rand(N) < 0.2, 1] = 0.0
        cap[rng3.rand(N) < 0.05, 0] = -5.0
    elif variant == "extreme":
        cap = (np.exp2(rng3.uniform(-120, 120, (N, R)))
               * rng3.uniform(1.0, 1.5, (N, R))).astype(np.float32)
        case["cap"] = cap
        case["idle"] = (cap * rng3.uniform(0.5, 2.0, (N, R))).astype(
            np.float32)
        req = (np.exp2(rng3.uniform(-100, 100, (T, R)))
               * rng3.uniform(1.0, 2.0, (T, R))).astype(np.float32)
        case["task_req"] = req
        case["task_fit"] = req * rng3.uniform(1.0, 1.2, (T, 1)).astype(
            np.float32)
        case["eps"][:] = np.float32(2.0 ** 126)
    return case


# Cases the Hopper kernels' design turns on, at CPU size:
# (T, N, R, K, static, variant); dense cases ignore K.
EDGE_DENSE = [
    (TILE_T + 1, 4097, 2, None, False, "identical"),
    (2 * TILE_T, 256, 8, None, True, None),
    (TILE_T, 300, 3, None, False, "zero_cap"),
    (TILE_T, 200, 2, None, True, "extreme"),
]
EDGE_SPARSE = [
    (TILE_T + 5, 256, 2, 37, None, None),
    (2 * TILE_T, 4097, 2, 64, None, "identical"),
    (TILE_T, 300, 8, 16, None, None),
    (TILE_T, 300, 3, 32, None, "zero_cap"),
    (TILE_T, 200, 2, 64, None, "extreme"),
]


def _edge_id(c):
    T, N, R, K, static, variant = c
    return f"{variant or 'plain'}-T{T}-N{N}-R{R}" + (f"-K{K}" if K else "")


def _edge_case(c, weights):
    T, N, R, K, static, variant = c
    return _case(T + N + R, T, N, R, *weights, K=K, static=bool(static),
                 variant=variant)


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


@pytest.mark.parametrize("weights", WEIGHTS, ids=["w1", "w07_13"])
@pytest.mark.parametrize("c", EDGE_DENSE, ids=_edge_id)
def test_bid_dense_bit_equal_edge(c, weights):
    case = _edge_case(c, weights)
    pallas, chain = jax_dense(case)
    assert_bits(port_dense(case), pallas, chain)


@pytest.mark.parametrize("weights", WEIGHTS, ids=["w1", "w07_13"])
@pytest.mark.parametrize("c", EDGE_SPARSE, ids=_edge_id)
def test_bid_sparse_bit_equal_edge(c, weights):
    case = _edge_case(c, weights)
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


def _floats(rng, n, elo, ehi, mode):
    """float32 values 2^e * significand, e in [elo, ehi]; the significand
    random, near 2 (``hi``) or near 1 (``lo``)."""
    if mode == "rand":
        m = rng.randint(0, 1 << 23, n)
    elif mode == "hi":
        m = (1 << 23) - 1 - rng.randint(0, 1 << 12, n)
    else:
        m = rng.randint(0, 1 << 12, n)
    e = rng.randint(elo, ehi + 1, n)
    return (((e + 127) << 23) | m).astype(np.int32).view(np.float32)


@pytest.mark.parametrize("s_mode", ["rand", "hi", "lo"])
@pytest.mark.parametrize("a_mode", ["rand", "hi", "lo"])
def test_reciprocal_route_equals_ieee_division(a_mode, s_mode):
    """The kernels' division without MUFU: q0 = a*rcp, r = fma(-s, q0, a),
    q = fma(r, rcp, q0) with rcp = RN(1/s) is RN(a / s) for numerators
    of magnitude 2^-63..2^65 and divisors 2^-40..2^60 (the route's range,
    csrc/bid.cu), including the significands where RN(1/s) and a*rcp
    are least accurate."""
    from kube_batch_tpu_torch.solver.kernels import _fma_f32

    rng = np.random.RandomState(["rand", "hi", "lo"].index(a_mode) * 3
                                + ["rand", "hi", "lo"].index(s_mode))
    n = 1 << 17
    a = _floats(rng, n, -63, 64, a_mode)
    a[rng.rand(n) < 0.5] *= -1
    s = _floats(rng, n, -40, 59, s_mode)
    at, st = torch.from_numpy(a), torch.from_numpy(s)
    rcp = 1.0 / st
    q0 = at * rcp
    q = _fma_f32(_fma_f32(-st, q0, at), rcp, q0)
    assert np.array_equal(q.numpy().view(np.int32), (a / s).view(np.int32))


def _near_midpoint_pairs(max_c):
    """All 24-bit significand pairs (A, B), 2^23 <= A < B < 2^24, whose
    quotient A/B lies within max_c * 2^-25 of its ulp from a rounding
    midpoint M * 2^-25 (M odd, 2^24 <= M < 2^25): 2^25*A - B*M = c with
    0 < |c| <= max_c. For B = 2^k * B' (B' odd), B'*M = -c/2^k modulo
    2^(25-k), so M is B'^-1 * (-c/2^k) plus multiples of 2^(25-k);
    k <= 3, since c is never 0 (a quotient is never a midpoint)."""
    As, Bs = [], []
    for k in range(4):
        Bp = np.arange((1 << 23) >> k, (1 << 24) >> k, dtype=np.int64)
        Bp = Bp[Bp & 1 == 1]
        B = Bp << k
        mod = 1 << (25 - k)
        inv = Bp.copy()  # Newton's iteration for B'^-1 modulo 2^(25-k)
        for _ in range(4):
            inv = inv * ((2 - Bp * inv) % mod) % mod
        for c in range(-max_c, max_c + 1):
            if c == 0 or c % (1 << k):
                continue
            M0 = (-(c >> k) * inv) % mod
            for j in range(1 << k):
                M = M0 + j * mod
                A = (B * M + c) >> 25
                keep = ((M >= 1 << 24) & (M < 1 << 25) & (M & 1 == 1)
                        & (A >= 1 << 23) & (A < B))
                assert np.all((B * M + c)[keep] % (1 << 25) == 0)
                As.append(A[keep])
                Bs.append(B[keep])
    return np.concatenate(As), np.concatenate(Bs)


def test_reciprocal_route_exhaustive_near_midpoints():
    """The reciprocal route is RN(a / s) for every float32 pair in its
    range, not only the sampled ones. Scaling by powers of two is exact
    there, so significands a, s in [1, 2) suffice. Where a >= s,
    q0 = RN(a * RN(1/s)) is within (a/4 + 1/2) ulp of a/s, a faithful
    rounding, and Markstein's theorem gives RN(a/s). Where a < s, q0 can
    be up to 2 ulp off (this test meets ~half of its pairs with q0
    wrong), and q = RN(q0 + RN(r) * rcp) is a/s + e*(d1 + d2 + d1*d2)
    with |e| < 2 ulp and |d1|, |d2| <= 2^-24: within 8 * 2^-25 ulp of
    a/s. It can round otherwise than a/s only when a midpoint lies that
    close, i.e. 2^25*A - B*M = c with 0 < |c| <= 8 (A/B within
    |c| * 2^-24 / s ulp of the midpoint M). Every such pair is checked."""
    from kube_batch_tpu_torch.solver.kernels import _fma_f32

    A, B = _near_midpoint_pairs(max_c=9)
    assert A.size > 20_000_000
    for i in range(0, A.size, 1 << 22):
        a = ((A[i:i + (1 << 22)] - (1 << 23)) | (127 << 23)).astype(
            np.int32).view(np.float32)
        s = ((B[i:i + (1 << 22)] - (1 << 23)) | (127 << 23)).astype(
            np.int32).view(np.float32)
        at, st = torch.from_numpy(a), torch.from_numpy(s)
        rcp = 1.0 / st
        q0 = at * rcp
        q = _fma_f32(_fma_f32(-st, q0, at), rcp, q0)
        assert np.array_equal(q.numpy().view(np.int32),
                              (a / s).view(np.int32))


def test_key_rounding_by_magic_add():
    """The kernels' key score, rint(clip(score*50, -2^19, 2^19-1)) + 2^19
    read from the bits of u + 1.5*2^23, equals clip(rint(score*50) +
    2^19, 0, 2^20-1) with fmaxf/fminf's NaN rule, for every class of
    float32: a stride through all bit patterns (NaN and infinities
    included) and the half-way points of the quantum."""
    bits = np.arange(0, 1 << 32, 4099, dtype=np.uint64).astype(np.uint32)
    half = (np.arange(-600_000, 600_000, dtype=np.float32)
            + np.float32(0.5))
    t = np.concatenate([bits.view(np.float32), half,
                        np.float32([0.0, -0.0, np.inf, -np.inf, np.nan])])
    with np.errstate(all="ignore"):
        want = np.fmin(np.fmax(np.rint(t) + np.float32(2 ** 19),
                               np.float32(0)), np.float32(2 ** 20 - 1))
        u = np.fmin(np.fmax(t, np.float32(-2 ** 19)),
                    np.float32(2 ** 19 - 1))
        v = (u + np.float32(12582912.0)).astype(np.float32)
    got = v.view(np.uint32) - np.uint32(0x4B380000)
    assert np.array_equal(got, want.astype(np.uint32))


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda_device):
    """The Hopper kernels against their plain versions on the card
    (skipped without CUDA; chip_smoke.py runs the same comparison at
    the main path's shapes)."""
    cases = [(_case(7, 1001, 333, 3, 0.7, 1.3, static=True), port_dense),
             (_case(8, 1000, 300, 2, 1.0, 1.0, K=64), port_sparse)]
    for weights in WEIGHTS:
        cases += [(_edge_case(c, weights), port_dense) for c in EDGE_DENSE]
        cases += [(_edge_case(c, weights), port_sparse) for c in EDGE_SPARSE]
    for case, run in cases:
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
