"""The solver's fused bid pass: Hopper kernels and their plain versions.

Counterpart of ``kube_batch_tpu/solver/pallas_kernels.py``. One round's
[T, N] (or [T, K] candidate-slab) work is a chain of elementwise ops
ending in a row argmax: epsilon fit against idle, static mask AND,
LeastRequested + Balanced scores (+ static rows), integer bid keys,
argmax. The kernels in ``csrc/bid.cu`` compute the chain one task row
per warp and write only ``bid`` (i32[T], N when nothing is feasible) and
``any_feas`` (bool[T]).

``bid_dense`` / ``bid_sparse`` take tensors on one device. On the CPU
they run the plain version below; on a CUDA tensor they launch the
kernel, or raise. Each wrapper counts its launches in ``.launches``.

The plain versions are the specification: the kernels are bit-equal to
them, and they are bit-equal to the JAX package's jnp chain and Pallas
kernels (tests/test_torch_bid.py). Unlike the Pallas dense kernel, which
hashes the row position, both take the hash's task ids explicitly
(``task_ids``, the global rank); on full bundles rank == row position.
"""

from __future__ import annotations

import ctypes

import torch

from .kernels import (
    CPU_DIM,
    MAX_R,
    MEM_DIM,
    _dyn_score_core,
    _fits_all,
    bid_keys,
    dynamic_scores,
    less_equal,
)

# Rows per chunk of the plain dense version: bounds its [rows, N]
# float64 temporaries on the card at full width.
_PLAIN_ROWS = 4096


def bid_dense_plain(task_fit, task_req, task_ok, feas, idle, cap, cap_ok,
                    eps, lr_weight, br_weight, task_ids, static=None):
    """Fused mask + score + key + argmax over [T, N]. Returns
    (bid i32[T] — first column reaching the row's max key, or N when no
    column is feasible — and any_feas bool[T])."""
    T = task_fit.shape[0]
    N = idle.shape[0]
    dev = task_fit.device
    bid = torch.empty(T, dtype=torch.int32, device=dev)
    any_feas = torch.empty(T, dtype=torch.bool, device=dev)
    n_ids = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    for r0 in range(0, T, _PLAIN_ROWS):
        r1 = min(T, r0 + _PLAIN_ROWS)
        mask = (
            _fits_all(task_fit[r0:r1], idle, eps)
            & feas[r0:r1]
            & cap_ok[None, :]
            & task_ok[r0:r1, None]
        )
        score = dynamic_scores(
            task_req[r0:r1], idle, cap, lr_weight, br_weight
        )
        if static is not None:
            score = score + static[r0:r1]
        key = torch.where(
            mask, bid_keys(score, task_ids[r0:r1, None], n_ids), -1
        )
        has = mask.any(dim=1)
        any_feas[r0:r1] = has
        bid[r0:r1] = torch.where(has, key.argmax(dim=1).int(), N)
    return bid, any_feas


def bid_sparse_plain(task_fit, task_req, task_ok, cand_nodes, cand_static,
                     idle, cap, cap_ok, eps, lr_weight, br_weight, task_ids):
    """The same chain over a [T, K] candidate slab of global node ids
    (ids >= N are padding). Returns (bid i32[T] — the lowest global node
    id among the row's max keys, or N — and any_feas bool[T])."""
    N = idle.shape[0]
    valid = (cand_nodes >= 0) & (cand_nodes < N)
    safe = cand_nodes.clamp(0, N - 1).long()
    idle_slab = idle[safe]                                   # [T, K, R]
    mask = (
        less_equal(task_fit[:, None, :], idle_slab, eps)
        & valid
        & cap_ok[safe]
        & task_ok[:, None]
    )
    dims = [CPU_DIM, MEM_DIM]
    score = _dyn_score_core(
        task_req[:, None, dims], idle_slab[..., dims], cap[safe][..., dims],
        lr_weight, br_weight,
    ) + cand_static
    key = torch.where(mask, bid_keys(score, task_ids[:, None], cand_nodes), -1)
    row_max = key.amax(dim=1, keepdim=True)
    best = torch.where(mask & (key == row_max), cand_nodes, N).amin(dim=1)
    any_feas = mask.any(dim=1)
    return torch.where(any_feas, best, N).int(), any_feas


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _common_checks(task_fit, task_req, task_ok, idle, cap, cap_ok, eps,
                   task_ids):
    T, R = task_fit.shape
    N = idle.shape[0]
    dev = task_fit.device
    if R > MAX_R:
        raise ValueError(f"R={R} exceeds the kernel's maximum {MAX_R}")
    if R < 2:
        raise ValueError("the score needs the cpu and memory dimensions")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    _check("task_fit", task_fit, f32, (T, R), dev)
    _check("task_req", task_req, f32, (T, R), dev)
    _check("task_ok", task_ok, b, (T,), dev)
    _check("idle", idle, f32, (N, R), dev)
    _check("cap", cap, f32, (N, R), dev)
    _check("cap_ok", cap_ok, b, (N,), dev)
    _check("eps", eps, f32, (R,), dev)
    _check("task_ids", task_ids, i32, (T,), dev)
    return T, N, R, dev


def _launch(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"bid kernel launch failed: CUDA error {err}")


def bid_dense(task_fit, task_req, task_ok, feas, idle, cap, cap_ok, eps,
              lr_weight, br_weight, task_ids, static=None):
    """Dense bid pass (replaces ``pallas_bid``). CPU tensors take
    :func:`bid_dense_plain`; CUDA tensors launch the kernel."""
    if task_fit.device.type == "cpu":
        return bid_dense_plain(task_fit, task_req, task_ok, feas, idle, cap,
                               cap_ok, eps, lr_weight, br_weight, task_ids,
                               static)
    from ._build import load_library

    T, N, R, dev = _common_checks(task_fit, task_req, task_ok, idle, cap,
                                  cap_ok, eps, task_ids)
    _check("feas", feas, torch.bool, (T, N), dev)
    if static is not None:
        _check("static", static, torch.float32, (T, N), dev)
    bid = torch.empty(T, dtype=torch.int32, device=dev)
    any_feas = torch.empty(T, dtype=torch.bool, device=dev)
    if T == 0:
        return bid, any_feas
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launch(
        lib.kbt_bid_dense,
        _ptr(task_fit), _ptr(task_req), _ptr(task_ok), _ptr(feas),
        _ptr(idle), _ptr(cap), _ptr(cap_ok), _ptr(eps),
        _ptr(static) if static is not None else None,
        _ptr(task_ids), _ptr(bid), _ptr(any_feas),
        T, N, R, float(lr_weight), float(br_weight),
        ctypes.c_void_p(stream),
    )
    bid_dense.launches += 1
    return bid, any_feas


def bid_sparse(task_fit, task_req, task_ok, cand_nodes, cand_static, idle,
               cap, cap_ok, eps, lr_weight, br_weight, task_ids):
    """Candidate-slab bid pass (replaces ``pallas_bid_sparse``). CPU
    tensors take :func:`bid_sparse_plain`; CUDA tensors launch the
    kernel."""
    if task_fit.device.type == "cpu":
        return bid_sparse_plain(task_fit, task_req, task_ok, cand_nodes,
                                cand_static, idle, cap, cap_ok, eps,
                                lr_weight, br_weight, task_ids)
    from ._build import load_library

    T, N, R, dev = _common_checks(task_fit, task_req, task_ok, idle, cap,
                                  cap_ok, eps, task_ids)
    K = cand_nodes.shape[1] if cand_nodes.dim() == 2 else -1
    _check("cand_nodes", cand_nodes, torch.int32, (T, K), dev)
    _check("cand_static", cand_static, torch.float32, (T, K), dev)
    bid = torch.empty(T, dtype=torch.int32, device=dev)
    any_feas = torch.empty(T, dtype=torch.bool, device=dev)
    if T == 0:
        return bid, any_feas
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launch(
        lib.kbt_bid_sparse,
        _ptr(task_fit), _ptr(task_req), _ptr(task_ok), _ptr(cand_nodes),
        _ptr(cand_static), _ptr(idle), _ptr(cap), _ptr(cap_ok), _ptr(eps),
        _ptr(task_ids), _ptr(bid), _ptr(any_feas),
        T, N, K, R, float(lr_weight), float(br_weight),
        ctypes.c_void_p(stream),
    )
    bid_sparse.launches += 1
    return bid, any_feas


bid_dense.launches = 0
bid_sparse.launches = 0
