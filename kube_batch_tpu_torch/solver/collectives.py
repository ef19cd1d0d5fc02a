"""A mesh of shards and its two collectives, for one controlling process.

The JAX package writes its sharded solvers with ``shard_map``: one
program per shard, ``lax.all_gather`` and ``lax.psum`` between them,
and one process that drives every device (``jax.devices()``). This
module is the port's counterpart, in the same single-controller form:

- :class:`Mesh` is an ordered tuple of ``torch.device`` values, one per
  shard of this process. A device may repeat: a repeated device is a
  virtual shard, as XLA's host platform hands out several devices on one
  CPU. So the whole sharded program, collectives included, runs on one
  card or on the CPU.
- A shard body is a Python generator. It computes on its own device and
  ``yield``s an :class:`AllGather` or :class:`Psum` request where the
  reference calls the collective; the value sent back is the
  collective's result on that shard's device. :func:`run_spmd` steps
  every body of this process in shard order, on the calling thread, and
  answers each round of requests with :func:`all_gather` or
  :func:`psum`. On distinct CUDA devices the bodies' launches are
  asynchronous per device, so they overlap there.
- :func:`all_gather` and :func:`psum` move tensors with
  ``Tensor.to(device, non_blocking=True)`` and run the same code for
  virtual shards and for distinct cards. ``psum`` is a gather followed
  by a sum in shard order on every shard, so its float result does not
  depend on a reduction tree; where only shard 0 holds non-zeros the
  zeros still take part (``-0.0 + 0.0`` is ``+0.0``, as in
  ``lax.psum``).
- When a ``torch.distributed`` process group is initialized before the
  mesh is built, the same two functions add a cross-process leg
  (``all_gather_into_tensor`` on NCCL, ``all_gather`` on gloo). Each
  process drives its own shards, and the global shard order is (rank,
  local index); every process must run every sharded solve.

Results of a collective are distinct tensors per shard (a repeated
device gets a copy), so a body may update its own state in place.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Sequence, Tuple, Union

import torch

# The reference's one mesh axis. It names the node axis, its primary
# role; the sharded sparse solve and selection put tasks or classes on it.
NODE_AXIS = "nodes"


def _canonical(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _process_group() -> Tuple[int, int]:
    """(rank, world size) of the initialized default process group, or
    (0, 1) when there is none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A 1-D mesh: this process's shards, in order, as torch devices
    (repeats allowed). ``size`` counts the shards of every process;
    ``shard_ids`` are this process's global shard indexes."""

    axis_names = (NODE_AXIS,)

    def __init__(self, devices: Iterable):
        self.devices = tuple(_canonical(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.rank, self.world = _process_group()
        self.local_size = len(self.devices)
        self.size = self.local_size * self.world
        first = self.rank * self.local_size
        self.shard_ids = tuple(range(first, first + self.local_size))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def _key(self):
        return (self.devices, self.rank, self.world)

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        extra = f", rank {self.rank} of {self.world}" if self.world > 1 else ""
        return f"Mesh([{devs}]{extra})"


class AllGather(NamedTuple):
    """A shard body's request: ``lax.all_gather(value)`` — every
    shard's ``value`` stacked on a new leading axis, in shard order."""

    value: torch.Tensor


class Psum(NamedTuple):
    """A shard body's request: ``lax.psum(value)`` over the mesh, for a
    tensor or a tuple of tensors."""

    value: Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def _per_device(mesh: Mesh, build) -> List[torch.Tensor]:
    """``build(device)`` once per distinct local device; a repeated
    device gets a copy, so no two shards share a result."""
    made = {}
    out = []
    for dev in mesh.devices:
        if dev in made:
            out.append(made[dev].clone())
        else:
            made[dev] = build(dev)
            out.append(made[dev])
    return out


def _gather_processes(local: torch.Tensor) -> torch.Tensor:
    """Concatenate every process's [local_size, ...] stack in rank
    order (the cross-process leg)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    is_bool = local.dtype == torch.bool
    t = (local.to(torch.uint8) if is_bool else local).contiguous()
    if dist.get_backend() == "nccl":
        out = torch.empty((world * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t)
    else:
        home = t.device
        t = t.cpu()
        bufs = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(bufs, t)
        out = torch.cat(bufs).to(home)
    return out.bool() if is_bool else out


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh
               ) -> List[torch.Tensor]:
    """``parts[i]`` is local shard ``i``'s tensor. Returns, per local
    shard and on its device, the [mesh.size, ...] stack of every
    shard's part in global shard order."""
    if len(parts) != mesh.local_size:
        raise ValueError(
            f"{len(parts)} parts for a mesh of {mesh.local_size} local shards"
        )
    if mesh.world > 1:
        home = mesh.devices[0]
        full = _gather_processes(
            torch.stack([p.to(home, non_blocking=True) for p in parts])
        )
        return _per_device(mesh, lambda dev: full.to(dev, non_blocking=True))
    return _per_device(
        mesh,
        lambda dev: torch.stack([p.to(dev, non_blocking=True) for p in parts]),
    )


def psum(parts: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The sum over shards of ``parts``, on every local shard: a gather,
    then ``g[0] + g[1] + ...`` in shard order."""
    out = []
    for g in all_gather(parts, mesh):
        acc = g[0]
        for x in g[1:]:
            acc = acc + x
        out.append(acc)
    return out


def _answer(req, values, mesh: Mesh):
    if isinstance(req, AllGather):
        return all_gather(values, mesh)
    if isinstance(values[0], tuple):
        cols = [psum([v[j] for v in values], mesh)
                for j in range(len(values[0]))]
        return [tuple(c[i] for c in cols) for i in range(len(values))]
    return psum(values, mesh)


def run_spmd(mesh: Mesh, bodies: Sequence) -> list:
    """Step the shard bodies (one generator per local shard, in shard
    order) in lockstep until they return; answer each round of
    collective requests. Returns the bodies' return values. Every body
    must ask for the same collectives in the same order, as under
    ``shard_map``; a body that ends or asks for another collective
    while the others wait is an error."""
    if len(bodies) != mesh.local_size:
        raise ValueError(
            f"{len(bodies)} bodies for a mesh of {mesh.local_size} local "
            f"shards"
        )
    sends = [None] * len(bodies)
    while True:
        reqs, done = [], []
        for body, send in zip(bodies, sends):
            try:
                reqs.append(body.send(send))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            if reqs:
                raise RuntimeError(
                    f"{len(done)} shard bodies returned while {len(reqs)} "
                    f"wait in a collective"
                )
            return done
        kinds = {type(r) for r in reqs}
        if len(kinds) != 1 or not kinds <= {AllGather, Psum}:
            raise RuntimeError(f"shard bodies diverged: {sorted(map(str, kinds))}")
        sends = _answer(reqs[0], [r.value for r in reqs], mesh)
