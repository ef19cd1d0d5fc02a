"""The traced run's readings: the program's host spans, a device trace
over a bounded part of the window, and one bid launch of the cell's own
solve timed alone after the window.

- Spans: the program's tracer (``kube_batch_tpu_torch.obs.tracer``) is
  switched on for the window and its spans are read back as
  ``(name, t0, t1, cycle, thread)`` on the host clock.
- Device trace: ``torch.profiler`` with CUDA activity only (no host ops,
  so it adds no work to the loop's thread), over the whole window. Its
  clock is tied to the host's by a marker kernel on a stream of its own
  at each end; it is read once the loop has stopped.
- Kernel capture: the widest launch of the cell's bid kernel in the
  warm-up burst's solves (the cell's own shape) has its inputs copied,
  before the window; after the run it is launched alone (cold L2) under
  ``torch.profiler``, and the kernel's time in that trace is set against
  its roofline.
"""

from __future__ import annotations

import statistics
import time
from typing import List, Optional, Tuple

from . import work

MARKER = "spin_kernel"
# The operations and bytes of each bid kernel a cell reads a roofline of.
WORK = {"bid_sparse": work.sparse_work}


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


class Capture:
    """Keeps a copy of the inputs of the widest launch of ``fn_name``
    (the most task rows) made while armed."""

    def __init__(self, module, fn_name: str):
        self.module = module
        self.fn_name = fn_name
        self.original = getattr(module, fn_name)
        self.args = None

    def arm(self) -> None:
        import torch

        original = self.original

        def captured(*args):
            if self.args is None or args[0].shape[0] > self.args[0].shape[0]:
                self.args = tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args)
            return original(*args)

        captured.launches = original.launches
        setattr(self.module, self.fn_name, captured)

    def disarm(self) -> None:
        setattr(self.module, self.fn_name, self.original)


def kernel_ms(fn, kernel: str, reps: int = 20,
              warm: int = 2) -> Optional[float]:
    """Mean device time of the kernel named ``kernel`` over ``reps``
    calls of ``fn``, each with a cold L2, read from a device trace of
    them: each call behind an L2 flush and a spin of the card, so the
    host has queued it before the card reaches it. ``None`` where the
    trace holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(work.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(work.SPIN_CYCLES)
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    durs = [_ns(ev, "duration") for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == cuda and kernel in ev.name()]
    return statistics.fmean(durs) / 1e6 if durs else None


class Tracing:
    """The traced run: capture one bid launch in set-up, then switch the
    program's tracer on and trace the device over the window."""

    def __init__(self, kernel: Optional[str], device: str = "cuda"):
        self.kernel = kernel
        self.device = device
        self.spans: List[tuple] = []
        self.kernels: List[Tuple[str, float, float]] = []
        self.profiled: Optional[Tuple[float, float]] = None
        self.capture: Optional[Capture] = None
        self.kernel_ms: Optional[float] = None
        self.kernel_work: Optional[Tuple[int, int]] = None
        self.kernel_rows = 0
        self.dropped = 0

    def _marker(self, stream) -> float:
        import torch

        with torch.cuda.stream(stream):
            h = time.perf_counter()
            torch.cuda._sleep(100)
        return h

    def arm(self) -> None:
        """Before the warm-up burst: keep a copy of the widest launch of
        the cell's bid kernel that its solves make."""
        if self.kernel is not None and self.device == "cuda":
            from kube_batch_tpu_torch.solver import bid_kernels

            self.capture = Capture(bid_kernels, self.kernel)
            self.capture.arm()

    def begin(self) -> None:
        """At the end of set-up: stop capturing, switch the program's
        tracer on and start the device trace, so both are running when
        the window opens."""
        if self.capture is not None:
            self.capture.disarm()
        from kube_batch_tpu_torch.obs.tracer import TRACER

        TRACER.reset()
        TRACER.enable()
        self._tracer = TRACER
        if self.device != "cuda":
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._side = torch.cuda.Stream()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._h0 = self._marker(self._side)

    def end(self) -> None:
        """When the window closes: stop the device trace (stopping it
        takes the interpreter for a while, so not inside the window)."""
        if self.device != "cuda":
            return
        import torch

        self._h1 = self._marker(self._side)
        torch.cuda.synchronize(self._side.device)
        self._prof.stop()

    def _read_profile(self, prof, h0: float, h1: float) -> None:
        import torch

        events = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        kern = []
        marks = []
        for ev in events:
            if ev.device_type() != cuda:
                continue
            name = ev.name()
            start = _ns(ev, "start")
            dur = _ns(ev, "duration")
            if MARKER in name:
                marks.append(start)
                continue
            kern.append((name, start, dur))
        if len(marks) < 2:
            return
        marks.sort()
        # Host time = device time + offset, from the two markers.
        offset = statistics.fmean([h0 - marks[0] / 1e9, h1 - marks[-1] / 1e9])
        self.profiled = (h0, h1)
        self.kernels = sorted(
            ((name, s / 1e9 + offset, (s + d) / 1e9 + offset)
             for name, s, d in kern), key=lambda k: k[1])

    def finish(self) -> None:
        """After the window (reading the device trace inside it would take
        the interpreter from the loop): read the device trace and the
        spans, time the captured launch."""
        prof = getattr(self, "_prof", None)
        if prof is not None:
            self._read_profile(prof, self._h0, self._h1)
            self._prof = None
        tracer = getattr(self, "_tracer", None)
        if tracer is not None:
            epoch = tracer._epoch
            for ev in tracer.events():
                t0 = epoch + ev["ts"] / 1e6
                self.spans.append((ev["name"], t0, t0 + ev["dur"] / 1e6,
                                   ev["args"].get("cycle"), ev["tid"]))
            self.dropped = tracer.dropped
            tracer.disable()
            tracer.reset()
        cap = self.capture
        if cap is None:
            return
        cap.disarm()
        if cap.args is None:
            return
        fn, args = cap.original, cap.args
        self.kernel_ms = kernel_ms(lambda: fn(*args), f"{self.kernel}_kernel")
        self.kernel_work = WORK[self.kernel](args)
        self.kernel_rows = int(args[0].shape[0])
