"""PyTorch + CUDA port of the tpu-batch scheduler's batched solver.

A second package beside ``kube_batch_tpu`` (the JAX reference, which it
never imports). This slice holds the solver: the host snapshot bundle
(``solver.snapshot.pack_inputs``), the dense, staged and sparse solvers
(``solver.kernels.solve_auto``), their two hand-written Hopper bid
kernels (``solver.bid_kernels``), host candidate selection
(``solver.topk``) and placement validation (``solver.validate``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
