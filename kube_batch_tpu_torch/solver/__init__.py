"""The batched allocate solver on PyTorch tensors, and the snapshot that
feeds it: ``tensorize`` turns an open session into the solver bundle and
packs it through the device-resident cache (``device_cache``);
``solve_auto`` solves it (``kernels``, with the hand-written bid kernels
in ``bid_kernels``); ``validate_placements`` checks the result."""

from .kernels import (
    PackedInputs,
    SolverInputs,
    SolverResult,
    solve,
    solve_auto,
    solve_sparse,
    solve_staged,
)
from .snapshot import (
    ResourceLayout,
    SnapshotContext,
    last_tensorize_stats,
    pack_inputs,
    stack_inputs,
    tensorize,
)
from .topk import select_candidates, topk_config
from .validate import validate_placements

__all__ = [
    "PackedInputs",
    "ResourceLayout",
    "SnapshotContext",
    "SolverInputs",
    "SolverResult",
    "last_tensorize_stats",
    "pack_inputs",
    "select_candidates",
    "solve",
    "solve_auto",
    "solve_sparse",
    "solve_staged",
    "stack_inputs",
    "tensorize",
    "topk_config",
    "validate_placements",
]
