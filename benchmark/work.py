"""The yardstick of the kernels' rooflines: the card's peaks and the
operations and bytes each bid pass needs on its inputs.

A frozen copy of ``chip_smoke.py``'s ``sparse_work`` and its per-cell
constants, with the epsilon fit written out in plain torch: later
changes to the program's kernels or helpers do not move the ruler.
"""

from __future__ import annotations

# NVIDIA H100 SXM data-sheet peaks (dense, no sparsity), at 700 W.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# float32 operations per scored cell of the bid chain: 2 sub
# (remaining), 2 max + 2 mul + 2 div (LeastRequested), add + mul (mean),
# 2 div + 2 sub (fractions), sub + abs (diff), 2 compares, fma (2) for
# Balanced, mul + fma (3) for the weights, mul + rint + add + min + max
# for the key: 28, plus 1 for a static score; and 2 per dimension for
# every epsilon fit check.
OPS_PER_SCORED_CELL = 28
OPS_PER_FIT_DIM = 2

# Before each timed launch the L2 is flushed (five times the H100's
# 50 MB) and the card spins about 0.5 ms, so the host has queued the
# launch before the card reaches it.
L2_FLUSH_BYTES = 256 << 20
SPIN_CYCLES = 1_000_000


def sparse_work(args):
    """(bytes, operations) the candidate-slab bid pass needs."""
    fit, req, ok, cand, cst, idle, cap, cap_ok, eps, _, _, ids = args
    T, R = fit.shape
    N = idle.shape[0]
    Kw = cand.shape[1]
    nbytes = T * Kw * 8 + T * (8 * R + 1 + 4) + N * (8 * R + 1) + 4 * R + T * 5
    valid = (cand >= 0) & (cand < N)
    safe = cand.clamp(0, N - 1).long()
    live = valid & cap_ok[safe] & ok[:, None]
    fits = (fit[:, None, :] - idle[safe] < eps).all(dim=-1)
    return nbytes, (int(live.sum()) * R * OPS_PER_FIT_DIM
                    + int((live & fits).sum()) * (OPS_PER_SCORED_CELL + 1))


def roofline_pct(nbytes: int, ops: int, kernel_ms: float) -> float:
    """The least time the card could take, over the kernel's time."""
    bound_s = max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)
    return 100.0 * bound_s / (kernel_ms / 1e3)
