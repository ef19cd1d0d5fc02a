"""The port's placement validation, snapshot pack and contracts.

``validate_placements`` must catch the same violations as the JAX
package's (the cases of tests/unit/test_validate.py, on the same
tensorized session), ``pack_inputs`` must round-trip ``ctx.host_inputs``
byte for byte, and the contract tables must agree with the JAX
package's.
"""

import numpy as np
import pytest
import torch

from kube_batch_tpu.framework import close_session
from kube_batch_tpu.solver import contracts as JC
from kube_batch_tpu.solver.validate import (
    validate_placements as jax_validate,
)

from kube_batch_tpu_torch.solver import contracts as PC
from kube_batch_tpu_torch.solver.snapshot import pack_inputs
from kube_batch_tpu_torch.solver.validate import validate_placements

from tests.test_torch_solver import snapshot_tensorized
from tests.unit.test_validate import _pending_cluster, _tensorized


@pytest.fixture
def session():
    c = _pending_cluster()
    ssn, _inputs, ctx = _tensorized(c)
    yield ctx
    close_session(ssn)
    c.shutdown()


def _both(ctx, a):
    ref = jax_validate(ctx, a)
    got = validate_placements(ctx.host_inputs, a, n_tasks=len(ctx.tasks),
                              n_nodes=len(ctx.nodes))
    assert got[0].tolist() == ref[0].tolist()
    assert got[1] == ref[1]
    return got


def _spread(ctx):
    T, N = len(ctx.tasks), len(ctx.nodes)
    return (np.arange(T) % N).astype(np.int64)


def test_clean_assignment_passes(session):
    bad, reasons = _both(session, _spread(session))
    assert bad.size == 0 and reasons == {}


def test_bad_index_rejected(session):
    a = _spread(session)
    a[3] = len(session.nodes) + 7
    a[5] = 2 ** 30
    bad, reasons = _both(session, a)
    assert bad.tolist() == [3, 5] and reasons == {"bad-index": 2}


def test_negative_bad_index_rejected(session):
    a = _spread(session)
    a[2] = -7
    a[4] = -1  # the unassigned sentinel is never flagged
    bad, reasons = _both(session, a)
    assert bad.tolist() == [2] and reasons == {"bad-index": 1}


def test_infeasible_rejected(session):
    a = np.full(len(session.tasks), -1, dtype=np.int64)
    a[0] = 0
    # Forge the mask the solve was given: node 0 infeasible in both
    # views of the snapshot.
    session.mask.node_ok[0] = False
    session.host_inputs.node_feas[0] = False
    bad, reasons = _both(session, a)
    assert bad.tolist() == [0] and reasons == {"infeasible": 1}


def test_private_row_infeasible_rejected():
    host = snapshot_tensorized("off")
    a = np.full(host.task_req.shape[0], -1, dtype=np.int64)
    forged = host._replace(
        pair_idx=np.array([1, 10**6], np.int32),
        pair_feas=np.zeros((2, host.node_idle.shape[0]), bool),
    )
    a[1] = 0
    a[2] = 0
    bad, reasons = validate_placements(forged, a)
    assert bad.tolist() == [1] and reasons == {"infeasible": 1}


def test_gross_capacity_rejected(session):
    a = np.zeros(len(session.tasks), dtype=np.int64)
    bad, reasons = _both(session, a)
    assert reasons.get("capacity", 0) == len(session.tasks)
    assert bad.size == len(session.tasks)


def test_unassigned_vector_trivially_clean(session):
    bad, reasons = _both(session, np.full(len(session.tasks), -1))
    assert bad.size == 0 and reasons == {}


def test_takes_tensors(session):
    a = torch.from_numpy(_spread(session))
    a[3] = 2 ** 30
    packed = pack_inputs(session.host_inputs, "cpu").unpack()
    bad, reasons = validate_placements(packed, a, len(session.tasks),
                                       len(session.nodes))
    assert bad.tolist() == [3] and reasons == {"bad-index": 1}


@pytest.mark.parametrize("topk", ["off", "4"])
def test_pack_inputs_round_trips_host_inputs(topk):
    host = snapshot_tensorized(topk)
    back = pack_inputs(host, "cpu").unpack()
    for name in host._fields:
        want = np.asarray(getattr(host, name))
        got = getattr(back, name).numpy()
        assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


def test_contract_tables_match_the_jax_package():
    assert PC.SOLVER_INPUT_CONTRACTS == JC.SOLVER_INPUT_CONTRACTS
    strip = lambda t: {  # noqa: E731
        k: {f: v[f] for f in ("shape", "dtype", "optional") if f in v}
        for k, v in t.items()
    }
    assert strip(PC.PACKED_INPUT_CONTRACTS) == strip(
        JC.PACKED_INPUT_CONTRACTS)


def test_contracts_check_tensors_and_arrays():
    host = snapshot_tensorized("4")
    PC.validate_solver_inputs(host)
    PC.validate_solver_inputs(pack_inputs(host, "cpu").unpack())
    with pytest.raises(PC.ContractViolation, match="task_rank"):
        PC.validate_solver_inputs(
            host._replace(task_rank=host.task_rank.astype(np.int64)))
    with pytest.raises(PC.ContractViolation, match="node_idle"):
        PC.validate_solver_inputs(host._replace(node_idle=host.node_idle[1:]))
