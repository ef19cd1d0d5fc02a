"""The port's segmented prefix sum: the plain odd/even recursion on the
CPU, the kernel of ``solver/csrc/scan.cu`` on the card.

On CPU tensors ``segmented_cumsum`` runs ``_segmented_cumsum_plain`` and
never loads the kernel library; the kernel's input check raises on what
it does not take. On the card (``-m gpu``) the kernel is bit-equal to the
plain version at lengths around its 4,096-row tile and up to the 1M-task
headline, for [T] and [T, R] inputs and three patterns of segment
starts, and ``_commit_bids`` gives the CPU's bits with two launches. The
values (multiples of 4,097, 8,191 and 0.3 times 997) make the sum's
association visible: a sequential sum gives other bits.
"""

import numpy as np
import pytest
import torch

from kube_batch_tpu_torch.solver import _build
from kube_batch_tpu_torch.solver import kernels as K

torch.set_num_threads(1)

LENGTHS = [1, 2, 3, 7, 255, 256, 257, 1280, 4095, 4096, 4097, 65537,
           1048577]
STARTS = ["first", "every", "random"]


def _case(T, R, starts, seed=0):
    """float32 x ([T] when R is None, else [T, R]) and bool starts."""
    rng = np.random.RandomState(seed + T)
    shape = (T,) if R is None else (T, R)
    x = (rng.choice([4097.0, 8191.0, 0.3], shape) * 997).astype(np.float32)
    if starts == "every":
        st = np.ones(T, bool)
    else:
        st = rng.rand(T) < (0.05 if starts == "random" else 0.0)
    st[0] = True
    return torch.from_numpy(x), torch.from_numpy(st)


def _sequential(x, st):
    """The same segmented sum folded left to right in float32."""
    out = np.empty_like(x)
    acc = None
    for t in range(len(x)):
        acc = x[t].copy() if st[t] else (acc + x[t]).astype(np.float32)
        out[t] = acc
    return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu "
                    "tests/test_torch_scan.py` on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("starts", STARTS)
@pytest.mark.parametrize("R", [None, 2, 4, 8])
def test_cpu_runs_plain_and_never_loads_the_library(monkeypatch, R, starts):
    def no_library():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(_build, "load_library", no_library)
    before = K.segmented_cumsum.launches
    x, st = _case(1280, R, starts)
    got = K.segmented_cumsum(x, st)
    assert torch.equal(got, K._segmented_cumsum_plain(x, st))
    assert K.segmented_cumsum.launches == before


@pytest.mark.parametrize("T", [257, 1280])
def test_values_see_the_association(T):
    """A left-to-right float32 sum of the test values differs from the
    odd/even tree, so bit-equality checks the association."""
    x, st = _case(T, 2, "first")
    plain = K._segmented_cumsum_plain(x, st).numpy()
    assert not np.array_equal(_sequential(x.numpy(), st.numpy()), plain)


def _bad_inputs():
    x = torch.zeros(16, 2)
    st = torch.zeros(16, dtype=torch.bool)
    return {
        "float64": (x.double(), st, TypeError),
        "int32": (x.int(), st, TypeError),
        "3-d": (torch.zeros(16, 2, 1), st, ValueError),
        "R above MAX_R": (torch.zeros(16, K.MAX_R + 1), st, ValueError),
        "no columns": (torch.zeros(16, 0), st, ValueError),
        "starts not bool": (x, st.to(torch.uint8), TypeError),
        "starts length": (x, st[:15], ValueError),
        "starts 2-d": (x, st[:, None], ValueError),
        "x not contiguous": (torch.zeros(2, 16).t(), st, ValueError),
        "starts not contiguous": (
            x, torch.zeros(32, dtype=torch.bool)[::2], ValueError),
    }


@pytest.mark.parametrize("what", list(_bad_inputs()))
def test_kernel_input_check_raises(what):
    x, st, err = _bad_inputs()[what]
    with pytest.raises(err):
        K._check_scan_inputs(x, st)


@pytest.mark.parametrize("R", [None, 1, 2, K.MAX_R])
def test_kernel_input_check_accepts(R):
    x, st = _case(33, R, "random")
    assert K._check_scan_inputs(x, st) == (1 if R is None else R)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [None, 2, 4, 8])
@pytest.mark.parametrize("T", LENGTHS)
def test_kernel_bit_equal_to_plain_on_card(cuda_device, T, R):
    for starts in STARTS:
        x, st = _case(T, R, starts)
        x, st = x.to(cuda_device), st.to(cuda_device)
        before = K.segmented_cumsum.launches
        got = K.segmented_cumsum(x, st)
        assert K.segmented_cumsum.launches == before + 1
        want = K._segmented_cumsum_plain(x, st)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
            f"T={T} R={R} starts={starts}")


def _commit_case(seed=3, T=1280, N=200, R=4, Q=5):
    rng = np.random.RandomState(seed)
    req = (rng.choice([4097.0, 8191.0, 0.3], (T, R)) * 997).astype(
        np.float32)
    bid = rng.randint(0, N + 1, T).astype(np.int32)
    idle = (rng.uniform(0.5, 1.5, (N, R)) * req.sum(0) / N * 4).astype(
        np.float32)
    state = dict(
        bid=bid,
        assigned=np.full(T, -1, np.int32),
        idle=idle,
        ntask=rng.randint(0, 5, N).astype(np.int32),
        qalloc=rng.uniform(0, 1e6, (Q, R)).astype(np.float32),
    )
    kw = dict(
        task_req=req,
        task_fit=(req * np.float32(1.05)).astype(np.float32),
        task_rank=rng.permutation(T).astype(np.int32),
        task_queue=rng.randint(0, Q, T).astype(np.int32),
        node_max_tasks=rng.choice([0, 8, 30], N).astype(np.int32),
        queue_deserved=(np.full((Q, R), req.sum(0) / Q * 0.6)).astype(
            np.float32),
        eps=np.full(R, 10.0, np.float32),
    )
    return state, kw


@pytest.mark.gpu
def test_commit_bids_on_card_equals_cpu_in_two_launches(cuda_device):
    state, kw = _commit_case()

    def run(dev):
        t = {k: torch.from_numpy(v).to(dev) for k, v in state.items()}
        kt = {k: torch.from_numpy(v).to(dev) for k, v in kw.items()}
        return K._commit_bids(t["bid"], t["assigned"], t["idle"],
                              t["ntask"], t["qalloc"], **kt)

    want = run("cpu")
    before = K.segmented_cumsum.launches
    got = run(cuda_device)
    assert K.segmented_cumsum.launches == before + 2
    assert bool(want[4]), "the case accepts no bid"
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
