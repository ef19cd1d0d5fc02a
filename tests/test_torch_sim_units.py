"""The reference's own simulator unit cases, run against both packages.

Each case of ``tests/sim/test_invariants.py``, of the detector cases of
``tests/sim/test_soak.py`` and of ``tests/sim/test_chaos.py``'s fault
spec class runs twice: once from the reference's source as it is, once
from the same source with ``kube_batch_tpu`` read as
``kube_batch_tpu_torch``. The case's own assertions hold in both, and
what the package under test returned on the way (the checker's
violations, ``water_fill``'s shares, each detector's result, each parsed
spec or raised error) is recorded and must be equal between the two.
The port's harness resolves its device to the CPU here, where a case
builds a simulator.

The port's soak policy names the CUDA allocator's probes
(``cuda_memory_allocated_bytes``, ``cuda_memory_reserved_bytes``) where
the reference names ``jax_device_memory_bytes``: an injected leak on
either probe trips exactly as it does on the reference's series, and a
flat one does not.
"""

import inspect
import pathlib
import random
import re
import sys
import types

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKGS = ("kube_batch_tpu", "kube_batch_tpu_torch")

# Source file -> the names whose results each case records.
SOURCES = {
    "test_invariants.py": ("InvariantChecker", "water_fill"),
    "test_soak.py": ("fit_linear", "check_growth", "check_drift",
                     "run_detectors"),
    "test_chaos.py": ("parse_fault_spec",),
}
# Cases that build and run a whole simulator: covered by
# tests/test_torch_sim.py, not repeated here.
SKIP = {"test_soak_smoke_clean_run", "test_replay_limit_clamps_cycles",
        "test_soak_cli_exit_code_on_trip"}
CHAOS_CLASS = "TestFaultSpec"


def normal(value):
    """A recorded result as plain data."""
    if hasattr(value, "to_dict"):
        return value.to_dict()
    if isinstance(value, (list, tuple)):
        return [normal(v) for v in value]
    if isinstance(value, dict):
        return {k: normal(v) for k, v in value.items()}
    if isinstance(value, float):
        return round(value, 9)
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if hasattr(value, "__dict__"):
        return {k: normal(v) for k, v in vars(value).items()}
    return repr(value)  # e.g. a Resource: its repr lists every dimension


def recording(fn, log):
    def wrapper(*args, **kw):
        try:
            out = fn(*args, **kw)
        except Exception as exc:
            log.append(("raised", type(exc).__name__))
            raise
        log.append((fn.__name__, normal(out)))
        return out
    return wrapper


def load(name, pkg, log):
    """The reference case module ``name``, its imports read as ``pkg``,
    with the recorded names wrapped."""
    src = (REPO / "tests" / "sim" / name).read_text()
    if pkg != PKGS[0]:
        src = re.sub(r"\bkube_batch_tpu\b", pkg, src)
    mod = types.ModuleType(f"{pkg}_cases_{name[:-3]}")
    mod.__file__ = str(REPO / "tests" / "sim" / name)
    sys.modules[mod.__name__] = mod
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    for attr in SOURCES[name]:
        obj = mod.__dict__[attr]
        if isinstance(obj, type):
            check = obj.check

            class Recorded(obj):
                def check(self, *args, **kw):
                    out = check(self, *args, **kw)
                    log.append(("check", normal(out)))
                    return out

            mod.__dict__[attr] = Recorded
        else:
            mod.__dict__[attr] = recording(obj, log)
    return mod


def cases():
    out = []
    for name in SOURCES:
        mod = load(name, PKGS[0], [])
        for attr, obj in vars(mod).items():
            if attr.startswith("test_") and callable(obj):
                if attr not in SKIP:
                    out.append(pytest.param(name, None, attr,
                                            id=f"{name[5:-3]}-{attr}"))
            elif attr.startswith("Test") and isinstance(obj, type):
                if name == "test_chaos.py" and attr != CHAOS_CLASS:
                    continue
                for meth in sorted(vars(obj)):
                    if meth.startswith("test_"):
                        out.append(pytest.param(
                            name, attr, meth,
                            id=f"{name[5:-3]}-{attr}-{meth}"))
    return out


def run_case(name, cls, meth, pkg, tmp_path, monkeypatch):
    log = []
    mod = load(name, pkg, log)
    fn = getattr(mod.__dict__[cls](), meth) if cls else mod.__dict__[meth]
    kw = {}
    params = inspect.signature(fn).parameters
    if "tmp_path" in params:
        kw["tmp_path"] = tmp_path / pkg
        kw["tmp_path"].mkdir()
    if "monkeypatch" in params:
        kw["monkeypatch"] = monkeypatch
    fn(**kw)
    return log


@pytest.mark.parametrize("name,cls,meth", cases())
def test_reference_case_on_both_packages(name, cls, meth, tmp_path,
                                         monkeypatch):
    from kube_batch_tpu_torch.sim import harness

    monkeypatch.setattr(harness, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    ref = run_case(name, cls, meth, PKGS[0], tmp_path, monkeypatch)
    got = run_case(name, cls, meth, PKGS[1], tmp_path, monkeypatch)
    assert got == ref


def leak_windows(pkg, key, slope):
    telemetry = __import__(f"{pkg}.obs.telemetry", fromlist=["Telemetry"])
    t = telemetry.Telemetry(window_cycles=4, max_windows=4096,
                            raw_capacity=8)
    rng = random.Random(11)
    for c in range(2000):
        t.observe_values(
            {key: 256e6 + slope * c + rng.uniform(-64e3, 64e3)}, cycle=c)
    t.flush()
    return t.windows()


@pytest.mark.parametrize("slope", [64 * 1024.0, 0.0], ids=["leak", "flat"])
@pytest.mark.parametrize("key", ["cuda_memory_allocated_bytes",
                                 "cuda_memory_reserved_bytes"])
def test_cuda_probe_leak_trips_like_the_jax_series(key, slope):
    from kube_batch_tpu.sim import soak as ref_soak
    from kube_batch_tpu_torch.sim import soak as port_soak

    ref = ref_soak.check_growth(
        leak_windows(PKGS[0], "jax_device_memory_bytes", slope),
        "jax_device_memory_bytes",
        ref_soak.GROWTH_POLICY["jax_device_memory_bytes"])
    got = port_soak.check_growth(
        leak_windows(PKGS[1], key, slope), key,
        port_soak.GROWTH_POLICY[key])
    assert got.tripped is (slope > 0)
    assert dict(got.to_dict(), series=None, message=None) == dict(
        ref.to_dict(), series=None, message=None)
    # run_detectors reads the same policy by the probe's name.
    tripped = [r.series for r in port_soak.run_detectors(
        leak_windows(PKGS[1], key, slope)) if r.tripped]
    assert tripped == ([key] if slope > 0 else [])


def test_every_reference_growth_series_has_a_port_policy():
    from kube_batch_tpu.sim import soak as ref_soak
    from kube_batch_tpu_torch.sim import soak as port_soak

    renamed = {"jax_device_memory_bytes": {"cuda_memory_allocated_bytes",
                                           "cuda_memory_reserved_bytes"}}
    for key, policy in ref_soak.GROWTH_POLICY.items():
        for port_key in renamed.get(key, {key}):
            assert port_soak.GROWTH_POLICY[port_key] == type(
                port_soak.GROWTH_POLICY[port_key])(**vars(policy))
    assert port_soak.DRIFT_POLICY.keys() == ref_soak.DRIFT_POLICY.keys()
