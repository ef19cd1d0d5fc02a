"""Device-resident snapshot: persistent solver buffers + delta patches.

A port of the reference's ``solver/device_cache.py``. The host side of
the snapshot is incremental (fingerprint-patched columnar arrays in
``snapshot._TensorizeCache``); this module keeps the packed bundle
resident on the device the same way, so a cycle ships only what
changed instead of re-uploading every stacked buffer.

The cache holds, per :class:`~.kernels.PackedInputs` field, one
resident torch buffer AND the exact host copy it was built from.
Packing a new snapshot then becomes, per field:

- **reuse** — bit-identical host array → hand back the resident buffer,
  zero bytes shipped (the steady-state no-churn cycle);
- **patch** — same shape/dtype, few dirty rows → the dirty rows and
  their indices go to the device in ONE host→device copy and are
  written into the resident buffer in place (``index_copy_``): no new
  allocation, no host synchronization;
- **full upload** — cold cache, shape/dtype drift (bucket growth,
  resource-layout change), or bulk dirtiness past the patch break-even
  (the same 25% rule as the host-side ``_refresh_node_arrays``).

Change detection is a host-side diff against the cached host copy,
exact by construction: whichever path ran, the resident buffer equals
the host array bit for bit.

The patched row count is bucketed to a power of two (``_row_bucket``)
exactly as the reference buckets it for its jitted scatter, so
``last_pack_stats`` (bytes shipped included) reads the same on the same
sequence; only the first ``rows`` entries of the bucket are written.

:meth:`DeviceSnapshotCache.pack_partial` places the node stacks and the
group rows ahead of the full pack, for device-resident selection
(``select_device.py``); the full pack reuses them and folds the
partial's traffic into its own stats.

The device is fixed when :func:`device_cache_of` first creates the
cache (``cuda`` unless the caller asks for ``"cpu"``). Residency is keyed
by the solver's layout token (``sharding.packed_sparse_placement``): a
token change drops every resident buffer and the whole snapshot
re-uploads, labeled ``mesh-change``. The placement that comes with the
token is the mesh the sharded sparse solve replicates the bundle over;
the buffers stay on the cache's device, which is every shard's device
on a virtual mesh (a mesh of distinct cards copies them to its other
devices at solve time).

OWNERSHIP: the returned PackedInputs buffers belong to the cache and
are valid until the next :meth:`DeviceSnapshotCache.pack` on the same
scheduler cache — a later patch overwrites them in place. Consume the
inputs within the cycle; copy anything that must outlive it. Patches
are queued on the current stream after the previous cycle's solve, so
stream order alone keeps them from racing it.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from .contracts import contracts_enabled, validate_packed

logger = logging.getLogger(__name__)

# Forensics of the most recent pack(). Single-threaded by construction,
# like snapshot.last_tensorize_stats.
last_pack_stats: dict = {}

# Axis along which cycle-to-cycle deltas are row-shaped, per
# PackedInputs field (stacked buffers carry their stack dim first).
_ROW_AXIS = {
    "task_f32": 1,
    "task_i32": 1,
    "node_f32": 1,
    "node_i32": 1,
    "group_feas": 0,
    "pair_idx": 0,
    "pair_feas": 0,
    "score_idx": 0,
    "score_rows": 0,
    "queue_f32": 1,
    "misc": 0,
    "cand_idx": 0,
    "cand_static": 0,
    "cand_info": 1,
}

# Past this dirty fraction a full upload beats row patching (mirrors
# the host-side bulk-dirty rule in snapshot._refresh_node_arrays).
_BULK_DIRTY_DEN = 4
# Buffers below this size are cheaper to re-ship whole than to patch.
_MIN_PATCH_BYTES = 4096

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def _row_bucket(n: int) -> int:
    """Power-of-two bucket for the patched-row axis (the reference's
    bucket for its jitted scatter, kept so the traffic stats agree)."""
    if n <= 0:
        return 1
    return 1 << (n - 1).bit_length()


class DeviceSnapshotCache:
    """Per-scheduler-cache device residency for the solver's inputs.

    Lives on the SchedulerCache object (``_torch_device_cache``
    attribute), giving it exactly the lifetime of the mirror it
    shadows — same pattern as ``snapshot._TensorizeCache``."""

    __slots__ = ("device", "host", "dev", "drop_reason", "layout_token",
                 "placement", "_deferred")

    def __init__(self, device=None):
        self.device = resolve_device(device)
        # field -> exact host copy of what is resident on device
        self.host: Dict[str, np.ndarray] = {}
        # field -> resident torch buffer on ``self.device``
        self.dev: Dict[str, torch.Tensor] = {}
        # Label of the next pack's uploads after a drop (None: "cold").
        self.drop_reason: Optional[str] = None
        # Stats of a pack_partial() awaiting merge into the next pack()
        # (the two are one logical pack per cycle).
        self._deferred: Optional[dict] = None
        # Solver layout the resident buffers were placed for
        # (sharding.packed_sparse_placement) and its placement (the mesh
        # of the sharded sparse solve, None on one device).
        self.layout_token: Optional[str] = None
        self.placement = None

    def drop(self, reason: Optional[str] = None) -> None:
        """Release every resident buffer (shutdown, tests, and an
        abandoned solve). ``reason`` labels the next pack's uploads in
        ``full_reasons``. A holder of the old buffers (an abandoned solve
        still running rounds) keeps them alive; the next pack writes
        only fresh buffers, so the two never share storage."""
        self.host.clear()
        self.dev.clear()
        self.drop_reason = reason

    # ------------------------------------------------------------------

    def _diff_rows(self, name: str, arr: np.ndarray, cached: np.ndarray):
        axis = _ROW_AXIS[name]
        neq = arr != cached
        if neq.ndim > 1:
            red = tuple(i for i in range(neq.ndim) if i != axis)
            dirty = neq.any(axis=red)
        else:
            dirty = neq
        return np.nonzero(dirty)[0], arr.shape[axis]

    def _upload(self, name: str, arr: np.ndarray, reason: str, stats):
        # copy=True: on the CPU a plain .to() would alias the caller's
        # array, and a later in-place patch would write through to it.
        dev = torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, copy=True
        )
        self.host[name] = arr
        self.dev[name] = dev
        stats["uploads"] += 1
        stats["bytes_shipped"] += arr.nbytes
        stats["full_reasons"][name] = reason
        stats["field_outcomes"][name] = "upload"
        return dev

    def _patch(self, name: str, arr: np.ndarray, rows: np.ndarray, stats):
        axis = _ROW_AXIS[name]
        nrows = arr.shape[axis]
        n = int(rows.size)
        K = _row_bucket(n)
        rows_p = np.full(K, nrows, dtype=np.int32)
        rows_p[:n] = rows
        vals = np.take(arr, rows, axis=axis)
        vshape = list(vals.shape)
        vshape[axis] = K
        vals_p = np.zeros(tuple(vshape), dtype=arr.dtype)
        sl = [slice(None)] * vals.ndim
        sl[axis] = slice(0, n)
        vals_p[tuple(sl)] = vals
        # One staging buffer holds the indices, then the rows (the row
        # block starts at 4*K bytes, aligned for every field dtype), so
        # the delta crosses in a single copy. Pinned on CUDA, so the
        # copy is asynchronous; the caching host allocator keeps the
        # block alive until the copy has run.
        nb_idx = rows_p.nbytes
        staging = torch.empty(
            nb_idx + vals_p.nbytes, dtype=torch.uint8,
            pin_memory=self.device.type == "cuda",
        )
        host = staging.numpy()
        host[:nb_idx] = rows_p.view(np.uint8)
        host[nb_idx:] = vals_p.reshape(-1).view(np.uint8)
        staged = staging.to(self.device, non_blocking=True)
        idx = staged[:nb_idx].view(torch.int32)[:n].long()
        src = (
            staged[nb_idx:].view(_TORCH_DTYPES[arr.dtype])
            .view(vals_p.shape).narrow(axis, 0, n)
        )
        dev = self.dev[name]
        dev.index_copy_(axis, idx, src)
        self.host[name] = arr
        stats["patches"] += 1
        stats["rows_patched"] += n
        stats["bytes_shipped"] += vals_p.nbytes + rows_p.nbytes
        stats["field_outcomes"][name] = "patch"
        return dev

    def _pack_field(self, name: str, arr: np.ndarray, stats: dict):
        """Reuse/patch/upload decision for ONE stacked field."""
        cached = self.host.get(name)
        dev = self.dev.get(name)
        if cached is None or dev is None:
            return self._upload(name, arr, self.drop_reason or "cold", stats)
        if cached.shape != arr.shape or cached.dtype != arr.dtype:
            return self._upload(name, arr, "shape-change", stats)
        rows, nrows = self._diff_rows(name, arr, cached)
        if rows.size == 0:
            stats["reuses"] += 1
            stats["field_outcomes"][name] = "reuse"
            return dev
        if arr.nbytes < _MIN_PATCH_BYTES:
            return self._upload(name, arr, "small-buffer", stats)
        if rows.size * _BULK_DIRTY_DEN > nrows:
            return self._upload(name, arr, "bulk-dirty", stats)
        return self._patch(name, arr, rows, stats)

    @staticmethod
    def _empty_stats() -> dict:
        return {
            "reuses": 0,
            "patches": 0,
            "uploads": 0,
            "rows_patched": 0,
            "bytes_shipped": 0,
            "slab_bytes_shipped": 0,
            "bytes_total": 0,
            "full_reasons": {},
            "field_outcomes": {},
        }

    def _enter_layout(self, placement, layout_token, stats) -> None:
        """A layout token change voids every resident buffer: the next
        uploads are labeled ``mesh-change``."""
        if layout_token != self.layout_token:
            if self.host:
                self.drop("mesh-change")
                stats["layout_change"] = True
            self.layout_token = layout_token
        self.placement = placement

    def pack_partial(self, arrays: Dict[str, np.ndarray],
                     placement=None, layout_token: Optional[str] = None,
                     ) -> Dict[str, torch.Tensor]:
        """Place a SUBSET of the cycle's stacked fields on the device
        ahead of the full :meth:`pack`: device-resident selection
        (``select_device.py``) reads the node stacks and group rows
        BEFORE the candidate slabs it produces exist. The later pack()
        sees bit-identical host arrays and reuses these buffers; the
        traffic stats here are deferred and merged into that pack's
        ledger, so the cycle's accounting stays whole."""
        stats = self._empty_stats()
        self._enter_layout(placement, layout_token, stats)
        out = {
            name: self._pack_field(name, arr, stats)
            for name, arr in arrays.items()
        }
        if self._deferred is None:
            self._deferred = stats
        else:  # two partials before a pack: fold counters forward
            for key in ("patches", "uploads", "rows_patched",
                        "bytes_shipped"):
                self._deferred[key] += stats[key]
            self._deferred["full_reasons"].update(stats["full_reasons"])
            self._deferred["field_outcomes"].update(
                stats["field_outcomes"]
            )
            if stats.get("layout_change"):
                self._deferred["layout_change"] = True
        return out

    def pack(self, arrays: Dict[str, np.ndarray], placement=None,
             layout_token: Optional[str] = None):
        """Build a :class:`~.kernels.PackedInputs` from stacked host
        arrays (``snapshot.stack_inputs``), reusing/patching resident
        buffers per field (see the module docstring). Records per-cycle
        forensics in :data:`last_pack_stats` and exports the aggregate
        counters through ``metrics``.

        ``placement``/``layout_token`` key residency by the solver's
        layout (``sharding.packed_sparse_placement``): a token change
        drops every resident buffer — a buffer placed for one mesh or
        mode is not patched into another — and the snapshot re-uploads,
        labeled ``mesh-change``."""
        from .kernels import PackedInputs

        if contracts_enabled():
            validate_packed(arrays, where="device_cache.pack")

        stats = self._empty_stats()
        self._enter_layout(placement, layout_token, stats)
        fields: Dict[str, torch.Tensor] = {}
        for name, arr in arrays.items():
            stats["bytes_total"] += arr.nbytes
            shipped_before = stats["bytes_shipped"]
            fields[name] = self._pack_field(name, arr, stats)
            if name.startswith("cand"):
                stats["slab_bytes_shipped"] += (
                    stats["bytes_shipped"] - shipped_before
                )

        # Fold in a preceding pack_partial (same cycle, same logical
        # pack): its uploads and patches are real traffic; a field it
        # already placed shows as "reuse" above, so surface the partial
        # outcome instead.
        deferred, self._deferred = self._deferred, None
        if deferred is not None:
            for key in ("patches", "uploads", "rows_patched",
                        "bytes_shipped"):
                stats[key] += deferred[key]
            stats["full_reasons"].update(deferred["full_reasons"])
            for f, outcome in deferred["field_outcomes"].items():
                if outcome != "reuse":
                    if stats["field_outcomes"].get(f) == "reuse":
                        stats["reuses"] -= 1
                    stats["field_outcomes"][f] = outcome
            if deferred.get("layout_change"):
                stats["layout_change"] = True
        self.drop_reason = None
        last_pack_stats.clear()
        last_pack_stats.update(stats)
        try:
            from .. import metrics

            metrics.update_device_cache(stats)
        except Exception:  # pragma: no cover - metrics must never kill
            logger.exception("device-cache metrics export failed")
        return PackedInputs(**fields)


def device_cache_of(cache, device=None) -> Optional[DeviceSnapshotCache]:
    """The scheduler cache's device snapshot cache, created on first use
    for ``device`` (``cuda`` unless ``"cpu"`` is asked for; raises when
    CUDA is absent). A later call naming a different device raises;
    None for slots-only stand-ins (then callers pack uncached)."""
    if cache is None:
        return None
    dc = getattr(cache, "_torch_device_cache", None)
    if dc is None:
        dc = DeviceSnapshotCache(device)
        try:
            cache._torch_device_cache = dc
        except Exception:
            return None
    elif device is not None and torch.device(device) != dc.device:
        raise ValueError(
            f"the device cache lives on {dc.device}, not {device}"
        )
    return dc


def drop_resident(cache, reason: str) -> None:
    """Drop the scheduler cache's resident buffers, if it has any, and
    the selection engine's key matrix with them; the next pack is a full
    upload labelled ``reason`` (see :meth:`DeviceSnapshotCache.drop`)
    and the next device selection rebuilds every row, so nothing an
    abandoned solve may still hold is patched."""
    from .select_device import invalidate_engine

    dc = getattr(cache, "_torch_device_cache", None)
    if dc is not None:
        dc.drop(reason)
    invalidate_engine(cache)
