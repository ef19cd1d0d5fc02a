"""The batched allocate solver on PyTorch tensors, and the snapshot that
feeds it: ``tensorize`` turns an open session into the solver bundle and
packs it through the device-resident cache (``device_cache``);
``solve_auto`` solves it (``kernels``, with the hand-written bid kernels
in ``bid_kernels``), dispatched by ``solve_sharded`` (one device);
``validate_placements`` checks the result. The action's fault
containment (``containment``) and warm-start plan (``warm``) live here
too."""

from .device_cache import DeviceSnapshotCache, device_cache_of
from .kernels import (
    PackedInputs,
    SolverInputs,
    SolverResult,
    jit_compilation_count,
    make_inputs,
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
from .sharding import solve_sharded
from .topk import select_candidates, topk_config
from .validate import validate_placements

__all__ = [
    "DeviceSnapshotCache",
    "PackedInputs",
    "ResourceLayout",
    "SnapshotContext",
    "SolverInputs",
    "SolverResult",
    "device_cache_of",
    "jit_compilation_count",
    "last_tensorize_stats",
    "make_inputs",
    "pack_inputs",
    "select_candidates",
    "solve",
    "solve_auto",
    "solve_sharded",
    "solve_sparse",
    "solve_staged",
    "stack_inputs",
    "tensorize",
    "topk_config",
    "validate_placements",
]
