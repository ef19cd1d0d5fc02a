"""The comparison that decides ``correct`` fails what it must: the
control (a placement at random with no gangs) and each fault a
scheduling cell can have, planted under the timed path.
Each drives a whole run on the CPU at a small cluster, skipping only the
look for a card; a sound run of the same size comes out correct."""

import json
import time

import numpy as np
import pytest

from benchmark import harness, run
from conftest import cut_cell

NODES, POPULATION, SECONDS = 60, 600, 8


def _run(capsys, *extra, patch_program=None):
    from kube_batch_tpu_torch.solver import containment

    # Each run is a process of its own when measured: a fault that sent
    # an earlier run in this one down the solver's ladder must not pin
    # this run to the native floor.
    containment.reset_breaker()
    t = time.perf_counter()

    def patch(spec):
        cut_cell(spec, NODES, POPULATION)
        if patch_program is not None:
            patch_program()

    code = run.main(["--workload", "kb5k-storm", "--seed", "2147483659",
                     "--seconds", str(SECONDS), "--trace", "0", *extra],
                    device="cpu", t_start=t, patch=patch)
    assert code == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    return out


def test_a_sound_run_is_correct(capsys):
    out = _run(capsys)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_the_control_is_not_correct(capsys):
    out = _run(capsys, "--control")
    assert not out["correct"]
    checks = out["checks"]
    assert checks["gang_below_min"]["value"] > 0
    assert checks["score_gap"]["value"] > checks["score_gap"]["limit"]


def _solve_returns_nothing(monkeypatch):
    from kube_batch_tpu_torch.actions.allocate_tpu import AllocateTpuAction

    inner = AllocateTpuAction._solve_ladder

    def unchanged(self, *a, **k):
        assigned, handle = inner(self, *a, **k)
        return np.full_like(np.asarray(assigned), -1), handle

    monkeypatch.setattr(AllocateTpuAction, "_solve_ladder", unchanged)


def _half_the_binds_left_out(monkeypatch):
    from kube_batch_tpu_torch.cache.cache import SchedulerCache

    inner = SchedulerCache._bind_side_effect
    calls = [0]

    def half(self, *a, **k):
        calls[0] += 1
        if calls[0] % 2:
            return inner(self, *a, **k)

    monkeypatch.setattr(SchedulerCache, "_bind_side_effect", half)


def _bind_altered(monkeypatch):
    from kube_batch_tpu_torch.cache.cache import SchedulerCache

    inner = SchedulerCache._bind_side_effect

    def altered(self, pod, hostname, *a, **k):
        other = f"n{(int(hostname[1:]) + 1) % NODES}"
        return inner(self, pod, other, *a, **k)

    monkeypatch.setattr(SchedulerCache, "_bind_side_effect", altered)


def _scores_inverted(monkeypatch):
    # The bid pass's node scores with their sign turned, in every
    # module that computes them: each bid goes to the node the policy
    # ranks last.
    from kube_batch_tpu_torch.solver import bid_kernels, kernels, spmd

    inner = kernels._dyn_score_core
    for mod in (kernels, bid_kernels, spmd):
        monkeypatch.setattr(mod, "_dyn_score_core",
                            lambda *a, **k: -inner(*a, **k))


@pytest.mark.parametrize("fault,number", [
    (_solve_returns_nothing, "unbound"),
    (_half_the_binds_left_out, "apply_mismatch"),
    (_bind_altered, "apply_mismatch"),
    (_scores_inverted, "score_gap"),
], ids=["state-unchanged", "half-left-out", "answer-altered",
        "scores-inverted"])
def test_each_fault_is_not_correct(capsys, monkeypatch, fault, number):
    # What a fault leaves unbound would wait out the whole warm-up and
    # grace periods.
    monkeypatch.setattr(harness, "WARMUP_TIMEOUT_S", 10.0)
    monkeypatch.setattr(harness, "GRACE_S", 10.0)
    out = _run(capsys, patch_program=lambda: fault(monkeypatch))
    assert not out["correct"]
    check = out["checks"][number]
    assert check["value"] > check["limit"]
