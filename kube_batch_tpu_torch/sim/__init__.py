"""Deterministic cluster simulator.

The long-horizon harness the single-cycle parity tests cannot provide:
an event-driven loop with a virtual clock that drives the REAL
``Scheduler``/``SchedulerCache``/actions stack against a seeded
synthetic cluster (``workload``), injects faults at deterministic seams
(``faults``), asserts the kube-batch contract after every cycle
(``invariants``), and records a bit-replayable JSONL trace (``trace``).
``harness.ClusterSimulator`` wires it together; ``cli`` exposes
``python -m kube_batch_tpu_torch sim``.

Determinism rules (doc/design/simulator.md): no wall-clock reads, no
RNG outside the seeded generators, all async cache work barriered at
cycle end — so the same (seed, spec) or a recorded trace reproduces
identical per-cycle placements, and the same trace can be replayed
under a different solver backend for a long-horizon parity diff.
"""

from .clock import RealClock, VirtualClock
from .faults import FaultInjector, SimBindFailure, parse_fault_spec
from .harness import ClusterSimulator, SimConfig, SimReport
from .invariants import InvariantChecker, Violation
from .soak import DetectorResult, SoakVerdict, run_detectors
from .trace import TraceReader, TraceWriter, placement_counts
from .workload import WorkloadGenerator, WorkloadSpec

__all__ = [
    "ClusterSimulator",
    "DetectorResult",
    "FaultInjector",
    "InvariantChecker",
    "RealClock",
    "SimBindFailure",
    "SimConfig",
    "SimReport",
    "SoakVerdict",
    "run_detectors",
    "TraceReader",
    "TraceWriter",
    "VirtualClock",
    "Violation",
    "WorkloadGenerator",
    "WorkloadSpec",
    "parse_fault_spec",
    "placement_counts",
]
