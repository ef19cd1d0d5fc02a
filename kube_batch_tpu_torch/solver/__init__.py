"""The batched allocate solver on PyTorch tensors, and the snapshot that
feeds it: ``tensorize`` turns an open session into the solver bundle and
packs it through the device-resident cache (``device_cache``);
``solve_auto`` solves it (``kernels``, with the hand-written bid kernels
in ``bid_kernels``), dispatched by ``solve_sharded`` (one device, or a
mesh of shards: ``sharding``, ``spmd``, ``collectives``);
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
from .sharding import (
    default_mesh,
    init_distributed,
    pad_nodes,
    pad_tasks,
    sharded_step,
    shardings_for,
    solve_sharded,
    sparse_shard_mode,
)
from .spmd import (
    solve_sparse_spmd,
    solve_spmd,
    sparse_spmd_shardings_for,
    spmd_shardings_for,
)
from .topk import select_candidates, topk_config
from .validate import validate_placements

__all__ = [
    "DeviceSnapshotCache",
    "PackedInputs",
    "ResourceLayout",
    "SnapshotContext",
    "SolverInputs",
    "SolverResult",
    "default_mesh",
    "device_cache_of",
    "init_distributed",
    "jit_compilation_count",
    "last_tensorize_stats",
    "make_inputs",
    "pack_inputs",
    "pad_nodes",
    "pad_tasks",
    "select_candidates",
    "sharded_step",
    "shardings_for",
    "solve",
    "solve_auto",
    "solve_sharded",
    "solve_sparse",
    "solve_sparse_spmd",
    "solve_spmd",
    "solve_staged",
    "sparse_shard_mode",
    "sparse_spmd_shardings_for",
    "spmd_shardings_for",
    "stack_inputs",
    "tensorize",
    "topk_config",
    "validate_placements",
]
