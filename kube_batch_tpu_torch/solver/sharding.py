"""Solve dispatch over a mesh of shards: the port of the reference's
``solver/sharding.py``.

The reference shards the NODE axis of the dense solve over a 1-D mesh
(``solver/spmd.py``), or, for candidate slabs, the TASK axis
(``flat``, bit-equal to the single-device sparse solve, or the per-rack
``two-level`` solve), and falls back to its single-device solve when one
device is visible or the shape policy keeps the slabs on one device.
The port keeps that dispatch, its policy thresholds, its tokens and its
forensics (``last_dispatch``), over the single-controller
:class:`~.collectives.Mesh`:

- :func:`default_mesh` repeats the session's device when the process
  asked for virtual shards (``device.set_host_device_count``; only
  ``sim --host-devices`` and the tests do), else takes every visible
  CUDA device when there are several, else returns None (one device
  needs no mesh);
- the single-device branch runs the bid kernels unless
  ``use_kernel=False``; under a mesh the sharded bodies run the plain
  chain, as the reference's sharded steps run with ``allow_pallas=False``;
- ``impl="gspmd"`` (XLA's auto-partitioner over the single-device
  program) has no PyTorch counterpart and raises ``ValueError``.

``torch.distributed`` enters only where the reference uses
``jax.distributed``: :func:`init_distributed`, the multi-host join under
an "every process runs every solve" contract.
"""

from __future__ import annotations

import functools
import hashlib
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import host_device_count, resolve_device
from .collectives import NODE_AXIS, Mesh, _canonical
from .kernels import PackedInputs, solve, solve_auto, solve_staged

__all__ = [
    "Mesh",
    "NODE_AXIS",
    "default_mesh",
    "init_distributed",
    "last_dispatch",
    "packed_sparse_placement",
    "pad_nodes",
    "pad_tasks",
    "prospective_layout_token",
    "rack_digest",
    "rack_perm",
    "sharded_step",
    "shardings_for",
    "solve_sharded",
    "sparse_shard_mode",
]

# SolverInputs fields whose FIRST axis is the node axis.
_NODE_MAJOR = (
    "node_feas", "node_idle", "node_releasing", "node_cap",
    "node_task_count", "node_max_tasks",
)
# SolverInputs fields whose SECOND axis is the node axis ([G|P|S, N] rows).
_NODE_MINOR = ("group_feas", "pair_feas", "score_rows")
# PackedInputs stacks node tables as [k, N, ...]: node axis is axis 1.
_PACKED_NODE_MINOR = ("node_f32", "node_i32") + _NODE_MINOR

_GSPMD = (
    "impl='gspmd' is XLA's auto-partitioner run over the single-device "
    "program; PyTorch has no counterpart. Use impl='spmd' (the explicit "
    "sharded solver)"
)

INT_MAX = int(np.iinfo(np.int32).max)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device=None) -> bool:
    """Join a ``torch.distributed`` process group (the multi-host join)
    before building the mesh. After this, :func:`default_mesh` spans
    every process's shards, in (rank, local index) order.

    SPMD contract, as in the reference: EVERY process must run every
    sharded solve (a collective waits for all of them). This is for
    symmetric solver deployments, not for scheduler replicas behind
    leader election; the scheduler server never joins.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL);
    without it the ``env://`` convention applies (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). No-op (False) when no
    coordinator is configured; idempotent. The backend is NCCL for a
    CUDA ``device`` and gloo for the CPU."""
    import torch.distributed as dist

    if coordinator_address is None and not os.environ.get("MASTER_ADDR"):
        return False
    if dist.is_initialized():
        return True
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dev = resolve_device(device)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method,
        world_size=int(num_processes),
        rank=int(process_id),
    )
    return True


def default_mesh(devices=None, device=None) -> Optional[Mesh]:
    """A 1-D mesh over ``devices``, or by default over the session's
    ``device`` (``cuda`` unless given): that device repeated when the
    process asked for virtual shards, else every visible CUDA device
    when there are several, else that device alone. None when the mesh
    would hold one shard (single-device solves need no mesh)."""
    if devices is None:
        dev = _canonical(resolve_device(device))
        n = host_device_count()
        if n > 1:
            devices = [dev] * n
        elif dev.type == "cuda" and torch.cuda.device_count() > 1:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [dev]
    mesh = Mesh(devices)
    return mesh if mesh.size >= 2 else None


def _as_mesh(mesh) -> Optional[Mesh]:
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    return Mesh(mesh)


def shardings_for(inputs, mesh: Mesh):
    """The per-field split spec for ``inputs`` (SolverInputs or
    PackedInputs): each field holds the axis split over ``mesh``, or
    None when it is replicated or absent. The node axis is split, as in
    the reference's node-sharded GSPMD layout; ``spmd.spmd_shardings_for``
    is the explicit solver's layout."""
    cls = type(inputs)
    if isinstance(inputs, PackedInputs):
        return cls(**{
            f: 1 if f in _PACKED_NODE_MINOR and getattr(inputs, f) is not None
            else None
            for f in cls._fields
        })
    return cls(**{
        f: None if getattr(inputs, f, None) is None
        else 0 if f in _NODE_MAJOR else 1 if f in _NODE_MINOR else None
        for f in cls._fields
    })


def _pad_axis(x: torch.Tensor, axis: int, pad: int, value=0) -> torch.Tensor:
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


def pad_nodes(inputs, multiple: int):
    """Pad the node axis up to a multiple of ``multiple`` so shards are
    even. Padded nodes are infeasible (node_feas False) and empty, so the
    solver can never assign to them; padded mask/score rows are
    False/zero. An identity on the production path (``tensorize``
    buckets N to multiples of 256)."""
    n = _node_count(inputs)
    pad = (-n) % multiple
    if pad == 0:
        return inputs
    if isinstance(inputs, PackedInputs):
        return inputs._replace(**{
            f: _pad_axis(getattr(inputs, f), 1, pad)
            for f in _PACKED_NODE_MINOR
        })
    repl = {f: _pad_axis(getattr(inputs, f), 0, pad) for f in _NODE_MAJOR}
    repl.update({f: _pad_axis(getattr(inputs, f), 1, pad)
                 for f in _NODE_MINOR})
    if inputs.cand_idx is not None:
        # Candidate slabs use an invalid-node sentinel >= N; after
        # padding, the old sentinel would alias a (padded, empty) REAL
        # row, so move it past the new node count.
        repl["cand_idx"] = torch.where(
            inputs.cand_idx >= n, n + pad, inputs.cand_idx
        )
    return inputs._replace(**repl)


def pad_tasks(inputs, multiple: int):
    """Pad the TASK axis of a SolverInputs bundle up to a multiple of
    ``multiple`` so the sharded sparse solve's row blocks are even.
    Padded rows are invalid (``task_valid`` False), carry no resources,
    isolated job ids and INT_MAX ranks, so no solver path can act on
    them; callers slice ``assigned[:T]`` back."""
    T = inputs.task_req.shape[0]
    pad = (-T) % multiple
    if pad == 0:
        return inputs
    repl = {
        f: _pad_axis(getattr(inputs, f), 0, pad)
        for f in ("task_req", "task_fit", "task_queue", "task_group",
                  "task_valid")
    }
    repl["task_rank"] = _pad_axis(inputs.task_rank, 0, pad, INT_MAX)
    # Isolated job ids: padded rows never join a real job's segments.
    repl["task_job"] = torch.cat([
        inputs.task_job,
        torch.arange(T, T + pad, dtype=inputs.task_job.dtype,
                     device=inputs.task_job.device),
    ])
    if inputs.task_cand is not None:
        repl["task_cand"] = _pad_axis(inputs.task_cand, 0, pad)
    return inputs._replace(**repl)


# ---------------------------------------------------------------------------
# Sharded-sparse dispatch policy and layout tokens.
# ---------------------------------------------------------------------------

# Below this task count the single-device sparse solve wins outright: the
# slab rounds do O(T·K) work with no [T, N] structures, and the sharded
# path pays two collectives per commit.
_SPARSE_SHARD_MIN_TASKS = 1 << 16
# Past this task count (and a >= 4-shard mesh) the per-commit collective
# cadence dominates and the policy moves to the two-level per-rack solve
# (quality-approximate, so far past every parity-suite shape).
_TWO_LEVEL_MIN_TASKS = 1 << 19

# Forensics of the most recent solve_sharded dispatch (mode, shard
# count, engagement), read by actions.allocate_tpu for last_stats and
# metrics. Single-threaded by construction, like
# device_cache.last_pack_stats.
last_dispatch: dict = {}

# The device the most recent dispatch solved on; None until one ran. The
# layout token reads the mesh of that device at the time it is asked:
# unlike a JAX process, whose device set is fixed, the port's virtual
# shard count may change between cycles.
_layout_state: dict = {"device": None}


def rack_perm(mesh: Mesh) -> np.ndarray:
    """Shard→rack map for the two-level solve: ``rack_perm(mesh)[shard]``
    is the rack (node block) shard ``shard`` owns. Torch devices expose
    no interconnect coordinates, so this is the contiguous identity map,
    the reference's own branch for backends without coordinates."""
    return np.arange(mesh.size, dtype=np.int32)


def rack_digest(mesh: Optional[Mesh]) -> Optional[str]:
    """Short content token of the mesh's rack map, carried in the layout
    tokens so the warm-start plan and the selection caches invalidate
    when the node→rack decomposition moves. The contiguous identity map
    is ``c<n>``; None when there is no mesh."""
    if mesh is None:
        return None
    perm = rack_perm(mesh)
    if np.array_equal(perm, np.arange(len(perm), dtype=np.int32)):
        return f"c{len(perm)}"
    return hashlib.blake2b(perm.tobytes(), digest_size=4).hexdigest()


def sparse_shard_mode(n_tasks: int, mesh: Optional[Mesh]) -> str:
    """The sharded-sparse dispatch mode for a snapshot: ``single``
    (single-device sparse solve), ``flat`` (task-sharded, bit-equal to
    single) or ``two-level`` (per-rack solve + global reconciliation,
    quality-approximate). ``KBT_SPARSE_SHARD_MODE`` forces a mode
    (``off``/``single``, ``flat``, ``two-level``); unset = the shape
    policy above."""
    if mesh is None or mesh.size < 2:
        return "single"
    raw = os.environ.get("KBT_SPARSE_SHARD_MODE", "").strip().lower()
    if raw in ("off", "single", "0", "disable", "disabled"):
        return "single"
    if raw in ("flat", "1", "force"):
        return "flat"
    if raw in ("two-level", "two_level", "2", "hierarchical"):
        return "two-level"
    if n_tasks < _SPARSE_SHARD_MIN_TASKS:
        return "single"
    if n_tasks >= _TWO_LEVEL_MIN_TASKS and mesh.size >= 4:
        return "two-level"
    return "flat"


def prospective_layout_token() -> Optional[str]:
    """The solver layout a solve dispatched NOW would run under, or None
    when no dispatch has happened yet (a process that never solved has
    no layout to drift from). Consumed by the warm-start plan (a token
    change voids carried verdicts with the labeled ``mesh-changed``
    fallback) and by the selection caches' signatures."""
    dev = _layout_state["device"]
    if dev is None:
        return None
    mesh = default_mesh(device=dev)
    n = mesh.size if mesh is not None else 1
    mode = os.environ.get("KBT_SPARSE_SHARD_MODE", "").strip().lower()
    token = f"{n}dev:{mode or 'auto'}"
    rack = rack_digest(mesh)
    return f"{token}:{rack}" if rack else token


def packed_sparse_placement(n_tasks: int, device=None
                            ) -> Tuple[Optional[Mesh], str]:
    """Placement and layout token for the packed snapshot (read by
    ``tensorize`` → ``device_cache``): the mesh the bundle is replicated
    over when the sharded sparse path will run, else None. The token
    keys the device cache's residency: a layout flip forces a labeled
    full re-upload."""
    mesh = default_mesh(device=device)
    size = mesh.size if mesh is not None else 1
    mode = sparse_shard_mode(n_tasks, mesh) if n_tasks else "single"
    token = f"{size}dev:{mode}"
    rack = rack_digest(mesh)
    if rack:
        token = f"{token}:{rack}"
    if mesh is None or mode == "single":
        return None, token
    return mesh, token


def _staged_for_shape(inputs, staged):
    """Resolve the ``staged=None`` shape dispatch (solve_auto's rule)."""
    if staged is not None:
        return staged
    from .kernels import _STAGED_MIN_NODES, _STAGED_MIN_TASKS

    return (_node_count(inputs) >= _STAGED_MIN_NODES
            and _task_count(inputs) >= _STAGED_MIN_TASKS)


def _slab_classes(inputs) -> int:
    """Candidate-class count of an inputs bundle (0 = dense)."""
    cand = getattr(inputs, "cand_idx", None)
    return int(cand.shape[0]) if cand is not None else 0


def _task_count(inputs) -> int:
    if isinstance(inputs, PackedInputs):
        return int(inputs.task_f32.shape[1])
    return int(inputs.task_req.shape[0])


def _node_count(inputs) -> int:
    if isinstance(inputs, PackedInputs):
        return int(inputs.node_f32.shape[1])
    return int(inputs.node_idle.shape[0])


def _bundle_device(inputs) -> torch.device:
    if isinstance(inputs, PackedInputs):
        return inputs.task_f32.device
    return inputs.task_req.device


def _note_dispatch(mode: str, shards: int, device, reason: str = None):
    last_dispatch.clear()
    last_dispatch.update(
        mode=mode,
        shards=shards,
        sparse_sharded=mode in ("flat", "two-level"),
    )
    if reason:
        last_dispatch["reason"] = reason
    _layout_state["device"] = device


def _sparse_sharded_step(inputs, mesh: Mesh, mode: str, max_rounds,
                         tail_bucket):
    """(step, inputs) for the task-sharded sparse solve: pad the task
    axis (and the node axis for two-level) to the mesh multiple."""
    from .spmd import note_commit_stats, run_sparse_spmd

    note_commit_stats(inputs)
    two_level = mode == "two-level"
    if not isinstance(inputs, PackedInputs):
        inputs = pad_tasks(inputs, mesh.size)
        if two_level:
            inputs = pad_nodes(inputs, mesh.size)
    elif _task_count(inputs) % mesh.size or (
        two_level and _node_count(inputs) % mesh.size
    ):
        # A silent mis-split would never solve the remainder rows;
        # refuse loudly (solve_sharded routes ragged packed bundles to
        # the single-device solve before ever getting here).
        raise ValueError(
            f"sparse sharded solve needs task{'/node' if two_level else ''} "
            f"axes divisible by the mesh size {mesh.size}"
        )
    step = functools.partial(
        run_sparse_spmd, mesh=mesh, max_rounds=max_rounds,
        tail_bucket=tail_bucket, two_level=two_level,
    )
    return step, inputs


def sharded_step(
    inputs,
    mesh: Mesh,
    max_rounds: int = 256,
    staged=None,
    tail_bucket: int = 3072,
    impl: str = "spmd",
):
    """Return ``(step_fn, inputs)``: inputs padded for the mesh ONCE,
    plus the step to run on them (for re-solving one snapshot).

    ``impl='spmd'`` (default) is the explicit sharded solver
    (``solver/spmd.py``): node columns sharded, node/queue tables
    replicated, two collectives per commit or per round. Candidate-slab
    inputs route to the task-sharded SPARSE step when the shape/mesh
    policy engages it (``impl='sparse'`` forces flat,
    ``'sparse-two-level'`` the two-level mode). ``impl='gspmd'`` raises:
    it has no PyTorch counterpart."""
    mesh = _as_mesh(mesh)
    if impl == "gspmd":
        raise ValueError(_GSPMD)
    if impl not in ("spmd", "sparse", "sparse-two-level"):
        raise ValueError(f"unknown sharded impl {impl!r}")
    sparse_mode = None
    if impl == "sparse":
        sparse_mode = "flat"          # forced: ALWAYS the bit-parity mode
    elif impl == "sparse-two-level":
        sparse_mode = "two-level"
    elif staged is None and _slab_classes(inputs) > 0:
        mode = sparse_shard_mode(_task_count(inputs), mesh)
        ragged = isinstance(inputs, PackedInputs) and (
            _task_count(inputs) % mesh.size
            or (mode == "two-level" and _node_count(inputs) % mesh.size)
        )
        if mode != "single" and not ragged:
            sparse_mode = mode
    if sparse_mode is not None:
        return _sparse_sharded_step(
            inputs, mesh, sparse_mode, max_rounds, tail_bucket
        )
    from .spmd import solve_spmd

    inputs = pad_nodes(inputs, mesh.size)
    step = functools.partial(
        solve_spmd, mesh=mesh, max_rounds=max_rounds,
        staged=_staged_for_shape(inputs, staged), tail_bucket=tail_bucket,
    )
    return step, inputs


def solve_sharded(
    inputs,
    mesh=None,
    max_rounds: int = 256,
    staged=None,
    tail_bucket: int = 3072,
    impl: str = "spmd",
    use_kernel: bool = True,
):
    """Run the batched solve, sharded over ``mesh`` (a :class:`Mesh` or
    a sequence of devices; default :func:`default_mesh` of the bundle's
    device).

    ``staged``: None dispatches by shape (``solve_auto``: sparse when
    the bundle carries candidate slabs, else full or staged dense), True
    forces the staged solver, False the full-width one. Without a mesh
    the single-device solve runs, with the bid kernels unless
    ``use_kernel=False``. Candidate-slab inputs dispatch through
    :func:`sparse_shard_mode`: ``single`` keeps the single-device sparse
    solve (the small-shape default), ``flat`` and ``two-level`` run the
    task-sharded solve; a packed bundle whose axes do not divide the mesh
    falls back to ``single``, labeled ``ragged-axes``. Dense bundles run
    the node-sharded SPMD solve, bit-equal to the single-device plain
    chain. ``use_kernel`` applies only to the single-device branch."""
    if impl == "gspmd":
        raise ValueError(_GSPMD)
    dev = _bundle_device(inputs)
    mesh = default_mesh(device=dev) if mesh is None else _as_mesh(mesh)
    noted = False
    if mesh is not None and staged is None and _slab_classes(inputs) > 0:
        T = _task_count(inputs)
        mode = sparse_shard_mode(T, mesh)
        reason = None
        if mode != "single" and isinstance(inputs, PackedInputs):
            # A packed bundle cannot be re-padded without defeating
            # device residency; production buckets divide every pow2
            # mesh, so ragged axes are a test/tool corner.
            if T % mesh.size or (
                mode == "two-level" and _node_count(inputs) % mesh.size
            ):
                mode, reason = "single", "ragged-axes"
        _note_dispatch(mode, mesh.size, dev, reason)
        noted = True
        if mode != "single":
            step, dev_inputs = _sparse_sharded_step(
                inputs, mesh, mode, max_rounds, tail_bucket
            )
            result = step(dev_inputs)
            if int(result.assigned.shape[0]) != T:
                result = result._replace(assigned=result.assigned[:T])
            return result
        mesh = None
    if mesh is None:
        if not noted:
            _note_dispatch("single", 1, dev)
        if staged is None:
            return solve_auto(inputs, max_rounds=max_rounds,
                              use_kernel=use_kernel)
        if staged:
            return solve_staged(inputs, max_rounds=max_rounds,
                                tail_bucket=tail_bucket,
                                use_kernel=use_kernel)
        return solve(inputs, max_rounds=max_rounds, use_kernel=use_kernel)

    _note_dispatch(f"dense-{impl}", mesh.size, dev)
    step, inputs = sharded_step(
        inputs, mesh, max_rounds=max_rounds, staged=staged,
        tail_bucket=tail_bucket, impl=impl,
    )
    return step(inputs)
