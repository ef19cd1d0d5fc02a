"""Injectable scheduler clocks.

The ``Scheduler`` paces its loop through a clock object (``now()`` /
``wait(event, seconds)``) instead of calling ``time`` directly. The
production default lives in ``scheduler._WallClock`` (re-exported here
as ``RealClock`` — one implementation, not two copies that can drift);
the simulator injects ``VirtualClock``, whose ``wait`` advances the
timeline instantly instead of sleeping. ``real`` tells the scheduler
whether wall-clock-bounded side work (the think-time side-effect
drain) makes sense on this clock.
"""

from __future__ import annotations

from ..scheduler import _WallClock as RealClock

__all__ = ["RealClock", "VirtualClock"]


class VirtualClock:
    """Deterministic simulated timeline: waiting costs nothing and
    advances ``now()`` by exactly the requested amount."""

    real = False

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> float:
        if seconds > 0:
            self._now += seconds
        return self._now

    def wait(self, event, seconds: float) -> bool:
        self.advance(seconds)
        return event.is_set()
