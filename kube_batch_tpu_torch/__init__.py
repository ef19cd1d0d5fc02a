"""PyTorch + CUDA port of the tpu-batch scheduler.

A second package beside ``kube_batch_tpu`` (the JAX reference, which it
never imports). It runs a scheduling cycle up to validated placements:
the cluster mirror (``cache.SchedulerCache``, with the object model in
``api``), sessions with the default plugin tiers
(``framework.open_session``, ``plugins``), the snapshot and its
device-resident pack (``solver.tensorize``), the batched solver with
its two hand-written Hopper bid kernels (``solver.solve_auto``) and
placement validation (``solver.validate_placements``). Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
