"""Observability: span tracer, flight recorder, explainability,
telemetry, placement latency and quality.

Copies of the reference's ``obs`` modules:

- ``tracer``: hierarchical spans across the cycle's worker threads
  (NVTX ranges under ``KBT_TRACE_NVTX``, ``gc`` spans for every
  collection);
- ``flightrecorder``: a fixed-size ring of per-cycle records (phase
  timings, solver stats, verdict counts, errors with tracebacks),
  dumped as canonical JSON on cycle error and SIGUSR1;
- ``explain``: per-job "last unschedulable reason" verdicts behind the
  ``tpu_batch_unschedulable_tasks`` metric;
- ``telemetry``: per-cycle time-series with rollup windows, fed from the
  flight record plus resource-watermark probes (CUDA memory in place of
  the reference's JAX device memory);
- ``latency``: the placement-latency ledger and decision audit;
- ``quality``: the placement-quality scorecard and churn counters.
"""

from .flightrecorder import RECORDER, FlightRecorder, install_sigusr1
from .latency import AUDIT, LEDGER, AuditLog, PlacementLedger
from .quality import QUALITY, QualityMonitor
from .sketch import QuantileSketch
from .telemetry import TELEMETRY, Telemetry
from .tracer import TRACER, Tracer, export_trace, span, trace_dir_from_env

__all__ = [
    "AUDIT",
    "AuditLog",
    "LEDGER",
    "FlightRecorder",
    "PlacementLedger",
    "QUALITY",
    "QualityMonitor",
    "QuantileSketch",
    "RECORDER",
    "TELEMETRY",
    "TRACER",
    "Telemetry",
    "Tracer",
    "export_trace",
    "install_sigusr1",
    "span",
    "trace_dir_from_env",
]
