"""Parity of the port's sparse solver and shape dispatch with the JAX
package, in both configurations (see tests/test_torch_solver.py).

Candidate slabs come from the JAX package's host selection (or its
``tensorize``) with K below the classes' eligible counts, so truncated
slabs exhaust and route tasks to the refill stage; ``refills`` and
``stages`` must match too.
"""

import pytest

from tests.test_torch_solver import (
    TAIL_BUCKET,
    assert_same,
    forced_pallas,  # noqa: F401 (fixture)
    jax_result,
    port_result,
    snapshot_bigsum,
    snapshot_mixed,
    snapshot_tensorized,
)

SPARSE = {
    "mixed-k8": lambda: snapshot_mixed(0, 8),
    "bigsum-k16": lambda: snapshot_bigsum(1, 16),
    "tensorized-k4": lambda: snapshot_tensorized("4"),
}


@pytest.mark.parametrize("kernel", [False, True], ids=["chain", "kernel"])
@pytest.mark.parametrize("snap", sorted(SPARSE))
def test_solve_sparse_bit_equal(snap, kernel, request):
    if kernel:
        request.getfixturevalue("forced_pallas")
    host = SPARSE[snap]()
    assert host.cand_idx.shape[0] > 0
    port = port_result("solve_sparse", host, kernel, tail_bucket=TAIL_BUCKET)
    assert_same(port, jax_result("solve_sparse", host, kernel,
                                 tail_bucket=TAIL_BUCKET))


def test_truncated_slabs_refill():
    """The mixed snapshot's K=8 slabs are truncated (K < cand_total),
    so the refill route is exercised."""
    host = snapshot_mixed(0, 8)
    assert (host.cand_info[0] > host.cand_idx.shape[1]).any()
    port = port_result("solve_sparse", host, False, tail_bucket=TAIL_BUCKET)
    assert port["refills"] > 0 and port["stages"] >= 1


@pytest.mark.parametrize("kernel", [False, True], ids=["chain", "kernel"])
@pytest.mark.parametrize("snap", ["mixed-k8", "tensorized-dense"])
def test_solve_auto_bit_equal(snap, kernel, request):
    if kernel:
        request.getfixturevalue("forced_pallas")
    host = (snapshot_tensorized("off") if snap == "tensorized-dense"
            else SPARSE[snap]())
    assert_same(port_result("solve_auto", host, kernel),
                jax_result("solve_auto", host, kernel))

