"""Observability, as far as the port's cycle reaches it.

The span tracer (``tracer``), the placement-latency ledger that the
cache stamps on arrival, bind and delete (``latency``), and the churn
counters behind the bind and evict seams (``quality``). The reference's
flight recorder, telemetry and explain modules are not ported yet.
"""

from .latency import AUDIT, LEDGER, AuditLog, PlacementLedger
from .quality import QUALITY, QualityMonitor
from .sketch import QuantileSketch
from .tracer import TRACER, Tracer, export_trace, span, trace_dir_from_env

__all__ = [
    "AUDIT",
    "AuditLog",
    "LEDGER",
    "PlacementLedger",
    "QUALITY",
    "QualityMonitor",
    "QuantileSketch",
    "TRACER",
    "Tracer",
    "export_trace",
    "span",
    "trace_dir_from_env",
]
