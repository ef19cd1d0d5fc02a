"""The port's mesh (``solver/collectives.py``), its default and its
process group (``solver/sharding.py``), class-axis device selection and
``sim --host-devices``, on the CPU.

- collectives: ``all_gather`` stacks in shard order with one copy per
  shard; ``psum`` sums in shard order (``-0.0`` from shard 0 plus the
  others' zeros is ``+0.0``, as ``lax.psum`` gives); ``run_spmd`` refuses
  bodies that diverge;
- ``default_mesh``: None on one device, N virtual shards of the
  session's device when the process asks for them;
- ``init_distributed`` as a one-process gloo group in a subprocess (the
  reference's ``test_sharding.py`` join), and two gloo processes with
  two virtual shards each, whose dense and flat solves equal the
  single-device plain chain (each subprocess has its own timeout);
- class-axis device selection on a virtual mesh: the key matrix splits
  into one block per shard, and the slabs equal the JAX package's host
  selection (``KBT_SELECT_DEVICE`` unset there: its host path is taken
  without a device state) over churned cycles;
- ``python -m <pkg> sim --host-devices 4 --backend sparse --topk 8
  --require-sparse-sharded`` with the flat and two-level modes forced:
  the port's trace (CPU, plain chain) equals the JAX package's
  (``KBT_SELECT_DEVICE=0``) record for record.

Tolerance: none.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from kube_batch_tpu.solver import topk as JT
from kube_batch_tpu.solver.masks import CombinedMask as JMask

from kube_batch_tpu_torch import device as PDEV
from kube_batch_tpu_torch.solver import contracts as PC
from kube_batch_tpu_torch.solver import sharding as PSH
from kube_batch_tpu_torch.solver import topk as PT
from kube_batch_tpu_torch.solver.collectives import (
    AllGather,
    Mesh,
    Psum,
    all_gather,
    psum,
    run_spmd,
)
from kube_batch_tpu_torch.solver.masks import CombinedMask as PMask

from tests.test_torch_sim import PKGS, PORT_MAIN, REPO, child_env

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture
def shards():
    saved = PDEV.host_device_count()
    yield PDEV.set_host_device_count
    PDEV.set_host_device_count(saved)


# ---------------------------------------------------------------- collectives


def test_all_gather_stacks_in_shard_order_one_copy_per_shard():
    mesh = Mesh(["cpu"] * 3)
    parts = [torch.full((2,), float(i)) for i in range(3)]
    out = all_gather(parts, mesh)
    assert len(out) == 3
    for g in out:
        assert torch.equal(g, torch.tensor([[0.0, 0.0], [1.0, 1.0],
                                            [2.0, 2.0]]))
    # Distinct tensors: a shard may update its copy in place.
    out[0][0, 0] = 9.0
    assert out[1][0, 0] == 0.0


def test_psum_sums_in_shard_order_on_every_shard():
    mesh = Mesh(["cpu"] * 4)
    neg = torch.tensor([-0.0, 1.5, -2.0])
    zeros = [torch.zeros(3) for _ in range(3)]
    out = psum([neg, *zeros], mesh)
    for s in out:
        # -0.0 + 0.0 is +0.0: the zeros of the other shards take part.
        assert torch.equal(s, torch.tensor([0.0, 1.5, -2.0]))
        assert not torch.signbit(s[0])
    # Shard order, not a tree: (((a + b) + c) + d).
    vals = [torch.tensor([1e8], dtype=torch.float32),
            torch.tensor([1.0]), torch.tensor([-1e8]), torch.tensor([1.0])]
    expect = ((vals[0] + vals[1]) + vals[2]) + vals[3]
    assert torch.equal(psum(vals, mesh)[0], expect)
    ints = psum([torch.tensor([i], dtype=torch.int32) for i in range(4)],
                mesh)
    assert ints[0].dtype == torch.int32 and int(ints[0]) == 6


def test_run_spmd_answers_requests_and_refuses_divergence():
    mesh = Mesh(["cpu"] * 2)

    def body(shard):
        g = yield AllGather(torch.tensor([shard]))
        a, b = yield Psum((torch.tensor([1.0]), torch.tensor([shard])))
        return g.tolist(), float(a), int(b)

    out = run_spmd(mesh, [body(0), body(1)])
    assert out == [([[0], [1]], 2.0, 1), ([[0], [1]], 2.0, 1)]

    def short(shard):
        if shard == 0:
            yield AllGather(torch.tensor([0]))
        return None

    with pytest.raises(RuntimeError, match="returned while"):
        run_spmd(mesh, [short(0), short(1)])

    def mixed(shard):
        yield (AllGather if shard else Psum)(torch.tensor([0]))

    with pytest.raises(RuntimeError, match="diverged"):
        run_spmd(mesh, [mixed(0), mixed(1)])


def test_mesh_identity_and_sizes():
    a, b = Mesh(["cpu", "cpu"]), Mesh([CPU, CPU])
    assert a == b and hash(a) == hash(b)
    assert a.size == 2 and a.shard_ids == (0, 1) and a.world == 1
    assert a != Mesh(["cpu"] * 3)
    with pytest.raises(ValueError):
        Mesh([])


def test_default_mesh_follows_the_virtual_shard_count(shards):
    assert PDEV.host_device_count() == 1
    assert PSH.default_mesh(device="cpu") is None
    assert PSH.default_mesh(["cpu"]) is None
    assert PSH.default_mesh(["cpu", "cpu"]).size == 2
    shards(4)
    mesh = PSH.default_mesh(device="cpu")
    assert mesh.devices == (CPU,) * 4
    assert PSH.rack_digest(mesh) == "c4"
    assert PSH.packed_sparse_placement(1 << 17, "cpu") == (mesh, "4dev:flat:c4")
    assert PSH.packed_sparse_placement(1000, "cpu") == (None,
                                                        "4dev:single:c4")
    shards(1)
    assert PSH.packed_sparse_placement(1 << 17, "cpu") == (None,
                                                           "1dev:single")
    with pytest.raises(ValueError):
        PDEV.set_host_device_count(0)


def test_shard_tables_hold_to_the_input_contracts(monkeypatch):
    PC.check_shard_dims()
    monkeypatch.setitem(PC.DENSE_SPMD_SHARD_DIMS, "group_feas", 2)
    with pytest.raises(PC.ContractViolation, match="group_feas"):
        PC.check_shard_dims()
    monkeypatch.delitem(PC.DENSE_SPMD_SHARD_DIMS, "group_feas")
    monkeypatch.setitem(PC.TWO_LEVEL_RACK_DIMS, "node_color", 0)
    with pytest.raises(PC.ContractViolation, match="node_color"):
        PC.check_shard_dims()


def test_gspmd_has_no_counterpart():
    from tests.test_torch_spmd import synthetic_host, to_port

    inputs = to_port(synthetic_host(16, 8, seed=1))
    with pytest.raises(ValueError, match="no counterpart"):
        PSH.solve_sharded(inputs, ["cpu", "cpu"], impl="gspmd")
    with pytest.raises(ValueError, match="no counterpart"):
        PSH.sharded_step(inputs, Mesh(["cpu"] * 2), impl="gspmd")


# ---------------------------------------------------------------- processes


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# One process of a gloo group: joins, asks for virtual shards, solves a
# seeded dense bundle and a forced-flat slab bundle over the mesh of
# every process's shards, and checks both against the single-device
# plain chain.
DIST_SCRIPT = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from kube_batch_tpu_torch.device import set_host_device_count
from kube_batch_tpu_torch.solver import (
    default_mesh, init_distributed, kernels as K, solve_sharded,
)
from kube_batch_tpu_torch.solver.masks import CombinedMask
from kube_batch_tpu_torch.solver.topk import select_candidates

addr, world, rank, local = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
if addr == "env":
    assert init_distributed(device="cpu")
else:
    assert init_distributed(addr, world, rank, device="cpu")
assert init_distributed(addr if addr != "env" else None, world, rank,
                        device="cpu")      # idempotent
set_host_device_count(local)
mesh = default_mesh(device="cpu")
assert mesh is not None and mesh.size == world * local, mesh
assert mesh.shard_ids == tuple(range(rank * local, rank * local + local))

rng = np.random.RandomState(5)
T, N, R = 96, 40, 2
req = torch.from_numpy(rng.uniform(100, 2000, (T, R)).astype(np.float32))
idle = torch.from_numpy(rng.uniform(3000, 9000, (N, R)).astype(np.float32))
feas = rng.rand(T, N) < 0.8
base = dict(
    task_req=req, task_fit=req.clone(),
    task_rank=torch.arange(T, dtype=torch.int32),
    task_job=torch.from_numpy(np.sort(rng.randint(0, 16, T)).astype(np.int32)),
    task_queue=torch.zeros(T, dtype=torch.int32),
    node_idle=idle, node_releasing=torch.zeros(N, R), node_cap=idle.clone(),
    node_task_count=torch.zeros(N, dtype=torch.int32),
    node_max_tasks=torch.zeros(N, dtype=torch.int32),
    queue_deserved=torch.full((1, R), float("inf")),
    queue_allocated=torch.zeros(1, R),
    eps=torch.full((R,), 10.0), lr_weight=torch.tensor(1.0),
    br_weight=torch.tensor(1.0),
)
dense = K.make_inputs(feas=torch.from_numpy(feas), **base)
res = solve_sharded(dense, mesh, max_rounds=64, staged=False)
ref = K.solve(dense, max_rounds=64, use_kernel=False)
assert torch.equal(res.assigned, ref.assigned)
assert torch.equal(res.node_idle, ref.node_idle)

mask = CombinedMask(node_ok=np.ones(N, bool), task_group=np.arange(T, dtype=np.int32),
                    group_rows=feas, pair_idx=np.zeros(0, np.int32),
                    pair_rows=np.zeros((0, N), bool))
cs = select_candidates(mask, {}, req.numpy(), req.numpy(), idle.numpy(),
                       idle.numpy(), np.zeros((N, R), np.float32),
                       np.zeros(N, np.int32), np.zeros(N, np.int32),
                       np.full(R, 10.0, np.float32), 1.0, 1.0, 6)
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
sparse = dense._replace(task_cand=t(cs.task_cand), cand_idx=t(cs.cand_idx),
                        cand_static=t(cs.cand_static), cand_info=t(cs.cand_info))
os.environ["KBT_SPARSE_SHARD_MODE"] = "flat"
res = solve_sharded(sparse, mesh, max_rounds=64)
ref = K.solve_sparse(sparse, max_rounds=64, use_kernel=False)
assert res.reconcile_rounds >= 1
assert torch.equal(res.assigned, ref.assigned)
assert torch.equal(res.queue_allocated, ref.queue_allocated)
assert (res.refills, res.stages) == (ref.refills, ref.stages)
print("DISTRIBUTED_OK", int((res.assigned >= 0).sum()))
"""


def dist_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KBT_") and k not in (
               "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **extra)
    return env


def test_init_distributed_is_a_noop_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert PSH.init_distributed(device="cpu") is False


def test_init_distributed_single_process_roundtrip():
    port = free_port()
    proc = subprocess.run(
        [sys.executable, "-c", DIST_SCRIPT, f"127.0.0.1:{port}", "1", "0",
         "4"],
        capture_output=True, text=True, timeout=180, cwd=REPO,
        env=dist_env(),
    )
    assert "DISTRIBUTED_OK" in proc.stdout, (proc.stdout, proc.stderr[-3000:])


def test_two_gloo_processes_with_two_virtual_shards_each():
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", DIST_SCRIPT, "env", "2", str(rank), "2"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=dist_env(MASTER_ADDR="127.0.0.1",
                                   MASTER_PORT=str(port), WORLD_SIZE="2",
                                   RANK=str(rank)),
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = [out for out, _ in outs]
    assert all("DISTRIBUTED_OK" in out for out in lines), (
        lines, [err[-2000:] for _, err in outs])
    # Both processes hold the same replicated result.
    assert len({out.split("DISTRIBUTED_OK")[1] for out in lines}) == 1


# ------------------------------------------------- class-axis selection


@pytest.mark.parametrize("size,seed,k", [(2, 3, 64), (4, 12, 16),
                                          (8, 21, 8)])
def test_class_axis_selection_equals_host_selection(shards, size, seed, k):
    from tests.test_torch_select_device import (
        Holder, assert_sets_equal, churn, problem, select, state_of,
    )

    shards(size)
    p = problem(seed)
    n = len(p["node_ok"])
    ids = np.arange(n, dtype=np.int64)
    vers = np.zeros(n, np.int64)
    jax_holder, engine_holder, host_holder = Holder(), Holder(), Holder()
    hits = 0
    for _ in range(4):
        fp = (ids, vers.copy(), None)
        want, _ = select(JT, JMask, p, k, jax_holder, fp)
        mask = PMask(node_ok=p["node_ok"], task_group=p["task_group"],
                     group_rows=p["group_rows"] & p["node_ok"][None, :],
                     pair_idx=p["pair_idx"],
                     pair_rows=p["pair_rows"] & p["node_ok"][None, :])
        got, _ = select(PT, PMask, p, k, Holder(), fp,
                        state_of(p, mask, engine_holder))
        host, _ = select(PT, PMask, p, k, host_holder, fp)
        assert got.stats["select_path"] == "device", got.stats
        assert_sets_equal(want, got)
        assert_sets_equal(host, got)
        assert got.stats["sel_cache_hits"] == want.stats["sel_cache_hits"]
        hits += got.stats["sel_cache_hits"]
        eng = engine_holder._topk_dev_engine
        # One block of class rows per shard.
        assert len(eng.keys) == size
        assert len({b.shape for b in eng.keys}) == 1
        assert eng.keys[0].shape[0] * size == eng.cp
        churn(p, vers)
    assert hits > 0


def test_selection_signatures_carry_the_layout_token(shards, monkeypatch):
    from tests.test_torch_select_device import (
        Holder, problem, select, state_of,
    )

    monkeypatch.setitem(PSH._layout_state, "device", CPU)
    p = problem(3)
    n = len(p["node_ok"])
    fp = (np.arange(n, dtype=np.int64), np.zeros(n, np.int64), None)
    mask = PMask(node_ok=p["node_ok"], task_group=p["task_group"],
                 group_rows=p["group_rows"] & p["node_ok"][None, :],
                 pair_idx=p["pair_idx"],
                 pair_rows=p["pair_rows"] & p["node_ok"][None, :])
    host_holder, engine_holder = Holder(), Holder()
    for _ in range(2):
        host, _ = select(PT, PMask, p, 16, host_holder, fp)
        dev, _ = select(PT, PMask, p, 16, Holder(), fp,
                        state_of(p, mask, engine_holder))
    assert host.stats["sel_cache_hits"] > 0
    assert dev.stats["sel_cache_hits"] > 0
    assert PT._layout_sig_token() == "1dev:auto"
    # A shard-count flip moves the token: both caches rebuild every row.
    shards(2)
    assert PT._layout_sig_token() == "2dev:auto:c2"
    host, _ = select(PT, PMask, p, 16, host_holder, fp)
    dev, _ = select(PT, PMask, p, 16, Holder(), fp,
                    state_of(p, mask, engine_holder))
    assert host.stats["sel_cache_hits"] == 0
    assert dev.stats["sel_cache_hits"] == 0
    assert len(engine_holder._topk_dev_engine.keys) == 2


# ------------------------------------------------- sim --host-devices


def sim_trace(pkg, tmp, mode):
    trace = tmp / f"{pkg}-{mode}.jsonl"
    argv = ["sim", "--host-devices", "4", "--backend", "sparse", "--topk",
            "8", "--cycles", "14", "--seed", "3", "--nodes", "12",
            "--trace", str(trace), "--require-sparse-sharded",
            "--quiet"]
    cmd = ([sys.executable, "-m", pkg, *argv] if pkg == PKGS[0] else
           [sys.executable, "-c", PORT_MAIN, *argv, "--device", "cpu"])
    env = dict(child_env(pkg), KBT_SPARSE_SHARD_MODE=mode)
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return trace


def canon_records(path):
    from kube_batch_tpu_torch.obs.quality import replay_view
    from kube_batch_tpu_torch.sim.trace import canon

    records = [json.loads(line) for line in path.read_text().splitlines()]
    out = []
    for rec in records[1:]:
        if "quality" in rec:
            rec["quality"] = replay_view(rec["quality"])
        out.append(canon(rec))
    return records[0], out


@pytest.mark.parametrize("mode", ["flat", "two-level"])
def test_sim_host_devices_trace_equals_reference(tmp_path, mode):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        paths = list(pool.map(lambda pkg: sim_trace(pkg, tmp_path, mode),
                              PKGS))
    (_, ref), (_, got) = (canon_records(p) for p in paths)
    assert len(got) == len(ref) == 14
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a == b, f"cycle record {i + 1} differs"
