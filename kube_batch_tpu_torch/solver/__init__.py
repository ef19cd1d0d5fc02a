"""The batched allocate solver on PyTorch tensors (see ``kernels``)."""

from .kernels import (
    PackedInputs,
    SolverInputs,
    SolverResult,
    solve,
    solve_auto,
    solve_sparse,
    solve_staged,
)
from .snapshot import pack_inputs
from .topk import select_candidates, topk_config
from .validate import validate_placements

__all__ = [
    "PackedInputs",
    "SolverInputs",
    "SolverResult",
    "pack_inputs",
    "select_candidates",
    "solve",
    "solve_auto",
    "solve_sparse",
    "solve_staged",
    "topk_config",
    "validate_placements",
]
