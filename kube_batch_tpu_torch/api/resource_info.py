"""Resource vector arithmetic.

Semantics mirror the reference's pkg/scheduler/api/resource_info.go:
- CPU tracked in millicores, memory in bytes, scalar resources in milli-units
  (resource_info.go:73-90 NewResource uses MilliValue for cpu and scalars).
- Epsilon-tolerant comparisons with min thresholds (resource_info.go:68-70:
  minMilliCPU=10, minMilliScalarResources=10, minMemory=10MiB;
  LessEqual resource_info.go:254-277).
- Sub raises when the subtrahend does not fit (resource_info.go:143-160).
- MaxTaskNum is predicate-only and excluded from arithmetic
  (resource_info.go:35-37).
"""

from __future__ import annotations

import re
from types import MappingProxyType
from typing import Dict, List, Optional, Tuple, Union

# Canonical resource names (k8s-compatible spellings).
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_PODS = "pods"
# reference: resource_info.go:41-43
GPU_RESOURCE_NAME = "nvidia.com/gpu"
# TPU-native addition: same scalar-resource treatment as GPUs.
TPU_RESOURCE_NAME = "google.com/tpu"

# Epsilons, reference resource_info.go:68-70.
MIN_MILLI_CPU = 10.0
MIN_MILLI_SCALAR = 10.0
MIN_MEMORY = 10.0 * 1024 * 1024

_QUANTITY_RE = re.compile(r"^([+-]?[0-9.]+(?:[eE][+-]?[0-9]+)?)([a-zA-Z]*)$")

_SUFFIX_MULTIPLIERS = {
    "": 1.0,
    "m": 1e-3,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
    "Ki": 2.0**10,
    "Mi": 2.0**20,
    "Gi": 2.0**30,
    "Ti": 2.0**40,
    "Pi": 2.0**50,
    "Ei": 2.0**60,
}


def parse_quantity(q: Union[str, int, float]) -> float:
    """Parse a k8s-style quantity ('100m', '2Gi', 3) into a float base value."""
    if isinstance(q, (int, float)):
        return float(q)
    m = _QUANTITY_RE.match(q.strip())
    if not m:
        raise ValueError(f"invalid quantity: {q!r}")
    value, suffix = m.groups()
    if suffix not in _SUFFIX_MULTIPLIERS:
        raise ValueError(f"invalid quantity suffix: {q!r}")
    return float(value) * _SUFFIX_MULTIPLIERS[suffix]


ResourceList = Dict[str, Union[str, int, float]]


def build_resource_list(cpu=None, memory=None, pods=None, **scalars) -> ResourceList:
    """Convenience builder for a resource list (mirrors test_utils.go:84-91)."""
    rl: ResourceList = {}
    if cpu is not None:
        rl[RESOURCE_CPU] = cpu
    if memory is not None:
        rl[RESOURCE_MEMORY] = memory
    if pods is not None:
        rl[RESOURCE_PODS] = pods
    rl.update(scalars)
    return rl


class Resource:
    """A resource vector: millicores, bytes of memory, and named scalars."""

    __slots__ = ("milli_cpu", "memory", "scalar_resources", "max_task_num")

    def __init__(
        self,
        milli_cpu: float = 0.0,
        memory: float = 0.0,
        scalar_resources: Optional[Dict[str, float]] = None,
        max_task_num: int = 0,
    ):
        self.milli_cpu = float(milli_cpu)
        self.memory = float(memory)
        self.scalar_resources: Optional[Dict[str, float]] = (
            dict(scalar_resources) if scalar_resources else None
        )
        self.max_task_num = max_task_num

    # -- constructors -------------------------------------------------------

    @classmethod
    def empty(cls) -> "Resource":
        return cls()

    @classmethod
    def from_resource_list(cls, rl: Optional[ResourceList]) -> "Resource":
        """Build from a resource list (reference resource_info.go:72-90).

        CPU and scalar quantities are converted to milli-units; memory to bytes;
        'pods' feeds max_task_num.
        """
        r = cls()
        if not rl:
            return r
        for name, quant in rl.items():
            value = parse_quantity(quant)
            if name == RESOURCE_CPU:
                r.milli_cpu += value * 1000.0
            elif name == RESOURCE_MEMORY:
                r.memory += value
            elif name == RESOURCE_PODS:
                r.max_task_num += int(value)
            else:
                r.add_scalar(name, value * 1000.0)
        return r

    def clone(self) -> "Resource":
        # Snapshot-critical path: ~126k clones per 50k-task cycle (the
        # defensive deep-copy contract the mutation-detector test pins).
        # Bypass __init__'s float()/dict() normalization — fields of an
        # existing Resource are already normalized.
        c = object.__new__(Resource)
        c.milli_cpu = self.milli_cpu
        c.memory = self.memory
        sr = self.scalar_resources
        c.scalar_resources = dict(sr) if sr else None
        c.max_task_num = self.max_task_num
        return c

    # -- predicates ---------------------------------------------------------

    def is_empty(self) -> bool:
        """All dimensions below epsilon (resource_info.go:93-105)."""
        if not (self.milli_cpu < MIN_MILLI_CPU and self.memory < MIN_MEMORY):
            return False
        for quant in (self.scalar_resources or {}).values():
            if quant >= MIN_MILLI_SCALAR:
                return False
        return True

    def is_zero(self, name: str) -> bool:
        """One dimension below epsilon (resource_info.go:107-125)."""
        if name == RESOURCE_CPU:
            return self.milli_cpu < MIN_MILLI_CPU
        if name == RESOURCE_MEMORY:
            return self.memory < MIN_MEMORY
        if self.scalar_resources is None:
            return True
        if name not in self.scalar_resources:
            raise KeyError(f"unknown resource {name!r}")
        return self.scalar_resources[name] < MIN_MILLI_SCALAR

    # -- arithmetic (in place, returning self, like the reference) ----------

    def add(self, rr: "Resource") -> "Resource":
        self.milli_cpu += rr.milli_cpu
        self.memory += rr.memory
        for name, quant in (rr.scalar_resources or {}).items():
            if self.scalar_resources is None:
                self.scalar_resources = {}
            self.scalar_resources[name] = self.scalar_resources.get(name, 0.0) + quant
        return self

    def sub(self, rr: "Resource") -> "Resource":
        """Subtract; raises if rr does not fit (resource_info.go:143-160)."""
        if not rr.less_equal(self):
            raise ValueError(
                f"Resource is not sufficient to do operation: <{self}> sub <{rr}>"
            )
        self.milli_cpu -= rr.milli_cpu
        self.memory -= rr.memory
        if rr.scalar_resources:
            if self.scalar_resources is None:
                return self
            for name, quant in rr.scalar_resources.items():
                self.scalar_resources[name] = (
                    self.scalar_resources.get(name, 0.0) - quant
                )
        return self

    def multi(self, ratio: float) -> "Resource":
        self.milli_cpu *= ratio
        self.memory *= ratio
        for name in self.scalar_resources or {}:
            self.scalar_resources[name] *= ratio
        return self

    def set_max_resource(self, rr: Optional["Resource"]) -> None:
        """Per-dimension max (resource_info.go:162-188)."""
        if rr is None:
            return
        if rr.milli_cpu > self.milli_cpu:
            self.milli_cpu = rr.milli_cpu
        if rr.memory > self.memory:
            self.memory = rr.memory
        if rr.scalar_resources:
            if self.scalar_resources is None:
                self.scalar_resources = dict(rr.scalar_resources)
                return
            for name, quant in rr.scalar_resources.items():
                if quant > self.scalar_resources.get(name, 0.0):
                    self.scalar_resources[name] = quant

    def fit_delta(self, rr: "Resource") -> "Resource":
        """Availability minus request minus epsilon; negative dims mean
        insufficient (resource_info.go:190-214)."""
        if rr.milli_cpu > 0:
            self.milli_cpu -= rr.milli_cpu + MIN_MILLI_CPU
        if rr.memory > 0:
            self.memory -= rr.memory + MIN_MEMORY
        for name, quant in (rr.scalar_resources or {}).items():
            if self.scalar_resources is None:
                self.scalar_resources = {}
            if quant > 0:
                self.scalar_resources[name] = (
                    self.scalar_resources.get(name, 0.0) - quant - MIN_MILLI_SCALAR
                )
        return self

    # -- comparisons --------------------------------------------------------

    def less(self, rr: "Resource") -> bool:
        """Strictly less in every dimension (resource_info.go:226-251)."""
        if not (self.milli_cpu < rr.milli_cpu and self.memory < rr.memory):
            return False
        if self.scalar_resources is None:
            return rr.scalar_resources is not None
        for name, quant in self.scalar_resources.items():
            if rr.scalar_resources is None:
                return False
            if quant >= rr.scalar_resources.get(name, 0.0):
                return False
        return True

    def less_equal(self, rr: "Resource") -> bool:
        """Epsilon-tolerant <= in every dimension (resource_info.go:253-277)."""
        is_less = (
            self.milli_cpu < rr.milli_cpu
            or abs(rr.milli_cpu - self.milli_cpu) < MIN_MILLI_CPU
        ) and (self.memory < rr.memory or abs(rr.memory - self.memory) < MIN_MEMORY)
        if not is_less:
            return False
        if self.scalar_resources is None:
            return True
        for name, quant in self.scalar_resources.items():
            if rr.scalar_resources is None:
                return False
            rr_quant = rr.scalar_resources.get(name, 0.0)
            if not (quant < rr_quant or abs(rr_quant - quant) < MIN_MILLI_SCALAR):
                return False
        return True

    def diff(self, rr: "Resource") -> Tuple["Resource", "Resource"]:
        """Return (increased, decreased) vs rr (resource_info.go:279-312)."""
        increased = Resource.empty()
        decreased = Resource.empty()
        if self.milli_cpu > rr.milli_cpu:
            increased.milli_cpu = self.milli_cpu - rr.milli_cpu
        else:
            decreased.milli_cpu = rr.milli_cpu - self.milli_cpu
        if self.memory > rr.memory:
            increased.memory = self.memory - rr.memory
        else:
            decreased.memory = rr.memory - self.memory
        for name, quant in (self.scalar_resources or {}).items():
            rr_quant = (rr.scalar_resources or {}).get(name, 0.0)
            if quant > rr_quant:
                increased.add_scalar(name, quant - rr_quant)
            else:
                decreased.add_scalar(name, rr_quant - quant)
        return increased, decreased

    # -- accessors ----------------------------------------------------------

    def get(self, name: str) -> float:
        if name == RESOURCE_CPU:
            return self.milli_cpu
        if name == RESOURCE_MEMORY:
            return self.memory
        if self.scalar_resources is None:
            return 0.0
        return self.scalar_resources.get(name, 0.0)

    def resource_names(self) -> List[str]:
        return [RESOURCE_CPU, RESOURCE_MEMORY] + list(self.scalar_resources or {})

    def add_scalar(self, name: str, quantity: float) -> None:
        self.set_scalar(name, (self.scalar_resources or {}).get(name, 0.0) + quantity)

    def set_scalar(self, name: str, quantity: float) -> None:
        if self.scalar_resources is None:
            self.scalar_resources = {}
        self.scalar_resources[name] = quantity

    # -- dunder helpers (not in the reference; used by tests) ----------------

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Resource):
            return NotImplemented
        return (
            self.milli_cpu == other.milli_cpu
            and self.memory == other.memory
            and (self.scalar_resources or {}) == (other.scalar_resources or {})
        )

    def __hash__(self):  # pragma: no cover - Resources are mutable; identity hash
        return id(self)

    def __repr__(self) -> str:
        parts = [f"cpu {self.milli_cpu:.2f}", f"memory {self.memory:.2f}"]
        for name, quant in (self.scalar_resources or {}).items():
            parts.append(f"{name} {quant:.2f}")
        return ", ".join(parts)


class FrozenResource(Resource):
    """Immutable :class:`Resource` view.

    Task request vectors (TaskInfo.resreq / init_resreq) are frozen at
    construction so every clone on the snapshot/bookkeeping hot path can
    SHARE them instead of deep-copying (~150k Resource copies per
    50k-task cycle otherwise). Freezing makes the sharing safe by
    construction: any in-place mutation attempt raises instead of
    silently corrupting every holder. ``clone()`` (inherited) returns a
    regular mutable Resource, so ``resreq.clone().add(...)`` patterns
    keep working."""

    __slots__ = ()

    def _frozen(self, *args, **kwargs):
        raise TypeError(
            "Resource is frozen (task request vectors are shared across "
            "clones); use clone() to get a mutable copy"
        )

    __setattr__ = _frozen
    add = _frozen
    sub = _frozen
    multi = _frozen
    set_max_resource = _frozen
    fit_delta = _frozen
    add_scalar = _frozen
    set_scalar = _frozen


def freeze_resource(r: Resource) -> Resource:
    """Freeze in place (no copy): the scalar dict becomes a read-only
    mapping view and the __class__ switches to the slots-compatible
    immutable subclass, so both attribute rebinding AND in-place dict
    mutation raise."""
    if r.scalar_resources is not None:
        r.scalar_resources = MappingProxyType(r.scalar_resources)
    r.__class__ = FrozenResource
    return r


def min_resource(l: Resource, r: Resource) -> Resource:
    """Per-dimension min (reference api/helpers/helpers.go:28)."""
    out = Resource.empty()
    out.milli_cpu = min(l.milli_cpu, r.milli_cpu)
    out.memory = min(l.memory, r.memory)
    # Sorted so the scalar dict's insertion order is byte-stable across
    # processes (kbtlint replay-determinism: string set order is hash-
    # randomized, and a downstream layout iterating it would drift).
    for name in sorted(
        set(l.scalar_resources or {}) | set(r.scalar_resources or {})
    ):
        out.set_scalar(name, min(l.get(name), r.get(name)))
    return out


def share(l: float, r: float) -> float:
    """Safe ratio l/r (reference api/helpers/helpers.go:43-55)."""
    if r == 0:
        return 1.0 if l > 0 else 0.0
    return l / r
