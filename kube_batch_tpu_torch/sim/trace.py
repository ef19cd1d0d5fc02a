"""JSONL sim traces: record, replay, diff.

One line per record, canonical JSON (sorted keys, no whitespace) so a
byte-diff of two traces IS a semantic diff. Schema
(doc/design/simulator.md):

- header: ``{"type": "header", "version": 1, "seed": ..., "cycles": ...,
  "faults": "...", "backend": "...", "workload": {...}}``
- cycle:  ``{"type": "cycle", "cycle": i, "events": [...],
  "faults": [...], "post_events": [...], "placements": [[pod, node]...],
  "bind_failures": [...], "stats": {...}, "violations": [...]}``

``events``/``faults``/``post_events`` are the full inputs of the cycle
(workload arrivals/completions, planned fault events, post-cycle
cleanup/recreation events) — enough to re-apply the cycle without the
generators, which is exactly what replay mode does. ``placements`` is
the cycle's OUTPUT (successful binds, sorted), the quantity replay
verifies and backend-parity runs diff.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

TRACE_VERSION = 1


def canon(obj) -> str:
    """Canonical one-line JSON (byte-stable across runs)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class TraceWriter:
    """Append-only JSONL writer; ``None`` path → in-memory only (the
    records list is kept by default, so the harness can hand the run's
    trace to a replay without touching disk).

    ``retain=False`` drops the in-memory copy (streaming to disk when a
    path is given, keeping nothing when not): a 100k-cycle soak
    otherwise accumulates every cycle record in RAM — an unbounded
    O(cycles) growth the soak leak detector itself flags (it shows up
    as a perfectly-linear ``alloc_blocks`` climb), and that holds with
    or without ``--trace``. Soak mode sets it; replays read the file
    back through TraceReader."""

    def __init__(self, path: Optional[str] = None, retain: bool = True):
        self.path = path
        self.retain = retain
        self.records: List[dict] = []
        self.written = 0
        self._fh = open(path, "w") if path else None

    def write(self, record: dict) -> None:
        self.written += 1
        if self.retain:
            self.records.append(record)
        if self._fh is not None:
            self._fh.write(canon(record) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class TraceReader:
    """Parsed trace: ``header`` + ``cycles`` (list indexed by cycle)."""

    def __init__(self, records: Iterable[dict]):
        records = list(records)
        if not records or records[0].get("type") != "header":
            raise ValueError("trace has no header record")
        self.header = records[0]
        version = self.header.get("version")
        if version != TRACE_VERSION:
            raise ValueError(
                f"trace version {version} unsupported "
                f"(expected {TRACE_VERSION})"
            )
        self.cycles = [r for r in records[1:] if r.get("type") == "cycle"]
        for i, rec in enumerate(self.cycles):
            if rec.get("cycle") != i:
                raise ValueError(
                    f"trace cycle records out of order at index {i}"
                )

    @classmethod
    def load(cls, path: str) -> "TraceReader":
        with open(path) as f:
            return cls(json.loads(line) for line in f if line.strip())


def placement_counts(cycles: List[dict]) -> Dict[str, int]:
    """Per-job placement counts over a whole trace (pod names are
    ``<job>-<idx>``, or ``<job>-<idx>r<gen>`` for controller-analog
    rebirths; the job is everything before the final dash segment),
    plus ``__total__``. The unit backend-parity compares when exact
    per-node equality is not expected (native)."""
    counts: Dict[str, int] = {"__total__": 0}
    for rec in cycles:
        for pod, _node in rec.get("placements", []):
            name = pod.rsplit("/", 1)[-1]
            job = name.rsplit("-", 1)[0]
            counts[job] = counts.get(job, 0) + 1
            counts["__total__"] += 1
    return counts


def diff_placements(a: List[dict], b: List[dict]) -> List[int]:
    """Cycle indices whose placement lists differ (exact, order-
    insensitive — placements are recorded sorted, so list equality is
    the comparison)."""
    bad = []
    for i in range(max(len(a), len(b))):
        pa = a[i].get("placements", []) if i < len(a) else None
        pb = b[i].get("placements", []) if i < len(b) else None
        if pa != pb:
            bad.append(i)
    return bad
