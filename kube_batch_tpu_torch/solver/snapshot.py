"""Host snapshot → device bundle.

Counterpart of the device pack at the end of
``kube_batch_tpu/solver/snapshot.py::tensorize``: the host bundle (a
``SolverInputs`` of NumPy arrays, such as the JAX package's
``ctx.host_inputs``) is stacked into the few buffers of
:class:`~.kernels.PackedInputs` exactly as tensorize stacks them, then
copied to the device. This is also how a snapshot crosses from the JAX
package to the port: any object with the ``SolverInputs`` field names
holding arrays will do. The way back is ``SolverResult.to_numpy()``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .contracts import validate_packed
from .kernels import PackedInputs


def _field(host, name):
    v = getattr(host, name, None)
    return None if v is None else np.asarray(v)


def _stack_host_inputs(host) -> dict:
    """The stacked NumPy buffers of :class:`PackedInputs`, in
    tensorize's layout and dtypes."""
    f32, i32 = np.float32, np.int32
    T = _field(host, "task_req").shape[0]
    task_cand = _field(host, "task_cand")
    if task_cand is None:
        task_cand = np.zeros(T, i32)
    cand_idx = _field(host, "cand_idx")
    cand_static = _field(host, "cand_static")
    cand_info = _field(host, "cand_info")
    if cand_idx is None:
        cand_idx = np.zeros((0, 1), i32)
        cand_static = np.zeros((0, 1), f32)
        cand_info = np.zeros((3, 0), i32)
    g = lambda name, dt: np.asarray(_field(host, name), dt)  # noqa: E731
    return {
        "task_f32": np.stack([g("task_req", f32), g("task_fit", f32)]),
        "task_i32": np.stack([
            g("task_rank", i32), g("task_queue", i32), g("task_job", i32),
            g("task_group", i32), g("task_valid", bool).astype(i32),
            np.asarray(task_cand, i32),
        ]),
        "node_f32": np.stack([
            g("node_idle", f32), g("node_releasing", f32), g("node_cap", f32),
        ]),
        "node_i32": np.stack([
            g("node_task_count", i32), g("node_max_tasks", i32),
            g("node_feas", bool).astype(i32),
        ]),
        "group_feas": g("group_feas", bool),
        "pair_idx": g("pair_idx", i32),
        "pair_feas": g("pair_feas", bool),
        "score_idx": g("score_idx", i32),
        "score_rows": g("score_rows", f32),
        "queue_f32": np.stack([
            g("queue_deserved", f32), g("queue_allocated", f32),
        ]),
        "misc": np.concatenate([
            g("eps", f32), np.asarray([_field(host, "lr_weight"),
                                       _field(host, "br_weight")], f32),
        ]).astype(f32),
        "cand_idx": np.asarray(cand_idx, i32),
        "cand_static": np.asarray(cand_static, f32),
        "cand_info": np.asarray(cand_info, i32),
    }


def pack_inputs(host_inputs, device=None) -> PackedInputs:
    """Stack a host ``SolverInputs`` bundle and copy it to ``device``
    (``cuda`` unless the caller passes ``"cpu"``; raises when CUDA is
    absent and the CPU was not asked for)."""
    dev = resolve_device(device)
    stacked = _stack_host_inputs(host_inputs)
    validate_packed(stacked, where="pack_inputs")
    return PackedInputs(**{
        k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        for k, v in stacked.items()
    })
