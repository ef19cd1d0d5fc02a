"""Solve dispatch: the single-device part of the reference's
``solver/sharding.py``.

The reference shards the node axis (or, for candidate slabs, the task
axis) over a mesh of devices when more than one is visible, and falls
back to its single-device solve otherwise. The port has that single
branch only: :func:`solve_sharded` dispatches to ``solve_auto``,
``solve_staged`` or ``solve`` on the bundle's device, with the bid
kernels unless ``use_kernel=False``. A mesh of more than one device
raises ``NotImplementedError``; it never quietly solves on one device.

What the rest of the cycle reads from here is kept: ``last_dispatch``
(the winning rung's dispatch, read by the action's attribution) and
:func:`prospective_layout_token` (read by the warm-start plan, which
voids carried verdicts when the solver's layout moves).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from .kernels import solve, solve_auto, solve_staged

# Forensics of the most recent solve_sharded dispatch (mode, shard
# count, engagement), read by actions.allocate_tpu for
# last_stats/metrics attribution. Single-threaded by construction,
# like device_cache.last_pack_stats.
last_dispatch: dict = {}

# Device count witnessed by the first dispatch: process-constant once
# set, and never probed outside a solve path (see
# prospective_layout_token). One device here; the reference's rack-map
# digest exists only for meshes.
_layout_state: dict = {"devices": None}


def prospective_layout_token() -> Optional[str]:
    """The solver layout a solve dispatched NOW would run under, or
    None when no dispatch has happened yet (a process that never solved
    on a device has no layout to drift from). Consumed by the warm-start
    plan: a token change voids carried verdicts with the labeled
    ``mesh-changed`` fallback."""
    n = _layout_state["devices"]
    if n is None:
        return None
    mode = os.environ.get("KBT_SPARSE_SHARD_MODE", "").strip().lower()
    return f"{n}dev:{mode or 'auto'}"


def _note_dispatch(mode: str, shards: int, reason: str = None) -> None:
    last_dispatch.clear()
    last_dispatch.update(
        mode=mode,
        shards=shards,
        sparse_sharded=mode in ("flat", "two-level"),
    )
    if reason:
        last_dispatch["reason"] = reason
    # First dispatch pins the process's device count for the warm
    # plan's layout token.
    if _layout_state["devices"] is None:
        _layout_state["devices"] = shards


def solve_sharded(
    inputs,
    mesh: Optional[Sequence] = None,
    max_rounds: int = 256,
    staged=None,
    tail_bucket: int = 3072,
    use_kernel: bool = True,
):
    """Run the batched solve on the bundle's device.

    ``staged``: None dispatches by shape (``solve_auto``: sparse when
    the bundle carries candidate slabs, else full or staged dense), True
    forces the staged solver, False the full-width one. ``mesh`` is a
    sequence of devices; more than one raises ``NotImplementedError``
    (the multi-device solve is not ported). ``use_kernel`` routes the
    head rounds through the bid kernels."""
    if mesh is not None and len(mesh) > 1:
        raise NotImplementedError(
            f"a solve over {len(mesh)} devices is not ported; the port "
            f"solves on one device"
        )
    _note_dispatch("single", 1)
    if staged is None:
        return solve_auto(inputs, max_rounds=max_rounds,
                          use_kernel=use_kernel)
    if staged:
        return solve_staged(inputs, max_rounds=max_rounds,
                            tail_bucket=tail_bucket, use_kernel=use_kernel)
    return solve(inputs, max_rounds=max_rounds, use_kernel=use_kernel)
