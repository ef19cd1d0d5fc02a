"""The port's host candidate selection against the JAX package's.

``select_candidates`` must return byte-equal ``task_cand``, ``cand_idx``,
``cand_static`` and ``cand_info`` on the same inputs, and ``topk_config``
the same policy.
"""

import numpy as np
import pytest

from kube_batch_tpu.solver import topk as JT
from kube_batch_tpu.solver.masks import CombinedMask as JaxMask

from kube_batch_tpu_torch.solver import topk as PT
from kube_batch_tpu_torch.solver.masks import CombinedMask as PortMask


def _inputs(seed, T, N, *, releasing=False, private=True, shapes=4):
    rng = np.random.RandomState(seed)
    R = 3
    cpu = rng.choice([250, 500, 1000, 2000][:shapes], T)
    mem = rng.choice([256, 512, 1024, 4096][:shapes], T)
    req = np.c_[cpu, mem, rng.choice([0, 10], T)].astype(np.float32)
    fit = req.copy()
    fit[rng.rand(T) < 0.1, 0] += 100
    idle = np.c_[
        rng.choice([1000, 4000, 16000], N), rng.choice([2048, 65536], N),
        np.full(N, 100),
    ].astype(np.float32)
    cap = np.maximum(idle, np.array([[16000, 65536, 100]], np.float32))
    rel = np.zeros_like(idle)
    if releasing:
        rel[: N // 4] = [3000, 8192, 0]
    G = 3
    mask_parts = dict(
        node_ok=rng.rand(N) > 0.05,
        task_group=rng.randint(0, G, T).astype(np.int32),
        group_rows=rng.rand(G, N) > 0.25,
        pair_idx=np.zeros(0, np.int32),
        pair_rows=np.zeros((0, N), bool),
    )
    score_map = {}
    if private:
        pidx = np.array(sorted(rng.choice(T, 4, replace=False)), np.int32)
        mask_parts["pair_idx"] = pidx
        mask_parts["pair_rows"] = rng.rand(4, N) > 0.4
        score_map = {
            int(t): rng.uniform(0, 5, N).astype(np.float32)
            for t in rng.choice(T, 3, replace=False)
        }
    args = (
        score_map, req, fit, idle, cap, rel,
        rng.randint(0, 3, N).astype(np.int32),
        rng.choice([0, 2, 110], N).astype(np.int32),
        np.full(R, 10.0, np.float32), 0.7, 1.3,
    )
    return mask_parts, args


@pytest.mark.parametrize(
    "seed,T,N,k,releasing,private",
    [
        (0, 200, 50, 8, False, True),
        (1, 200, 50, 8, True, True),
        (2, 500, 300, 16, False, False),
        (3, 120, 40, 64, True, True),      # K >= N: complete slabs
        (4, 64, 33, 5, False, True),       # K rounds up to a power of two
    ],
)
def test_select_candidates_byte_equal(seed, T, N, k, releasing, private):
    parts, args = _inputs(seed, T, N, releasing=releasing, private=private)
    ref = JT.select_candidates(JaxMask(**parts), *args, k)
    got = PT.select_candidates(PortMask(**parts), *args, k)
    for name in ("task_cand", "cand_idx", "cand_static", "cand_info"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    for key in ("classes", "k", "slab_bytes", "truncated_classes"):
        assert got.stats[key] == ref.stats[key]


def test_class_budget_falls_back_to_dense_in_both():
    # Every task its own shape: the class count blows the budget.
    parts, args = _inputs(5, 3000, 2000, private=False)
    args = list(args)
    rng = np.random.RandomState(0)
    args[1] = rng.uniform(1, 1000, (3000, 3)).astype(np.float32)
    args[2] = args[1].copy()
    assert JT.select_candidates(JaxMask(**parts), *args, 1) is None
    assert PT.select_candidates(PortMask(**parts), *args, 1) is None


@pytest.mark.parametrize("env", [None, "off", "dense", "12", "4", "junk"])
def test_topk_config_same_policy(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("KBT_SOLVER_TOPK", raising=False)
    else:
        monkeypatch.setenv("KBT_SOLVER_TOPK", env)
    for T, N in [(10, 10), (50_000, 5_000), (64, 16_384), (8192, 200),
                 (100_000, 250), (20_000, 1024)]:
        assert vars(PT.topk_config(T, N)) == vars(JT.topk_config(T, N))
