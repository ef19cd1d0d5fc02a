"""The port's device-resident snapshot cache, held to the reference.

The cases mirror ``tests/solver/test_device_cache.py``: both packages'
caches take the same clusters and the same churn, and the port's reuse,
patch and upload decisions and ``last_pack_stats`` must equal the
reference's on every pack. The resident buffers (CPU tensors here) must
equal the host arrays and a cold pack into a fresh cache bit for bit,
and a patched buffer keeps its ``data_ptr()`` because it is written in
place. A ``gpu``-marked case replays the churn on ``cuda``.
"""

import numpy as np
import pytest
import torch

from kube_batch_tpu.solver.device_cache import last_pack_stats as jax_stats

from kube_batch_tpu_torch.solver import PackedInputs, pack_inputs, solve_auto
from kube_batch_tpu_torch.solver.device_cache import (
    DeviceSnapshotCache,
    device_cache_of,
    last_pack_stats as port_stats,
)

from test_torch_snapshot import (  # noqa: F401 (autouse fixture)
    PORT,
    empty_cache,
    host_selection,
    jax_pkg,
    tiers,
)

torch.set_num_threads(1)


def cycle_cluster(pkg, seed=11, groups=6, per_group=8, nodes=6, queues=2):
    """The reference's cycle-pipeline test cluster, in either package."""
    rng = np.random.RandomState(seed)
    a, tu = pkg.api, pkg.tu
    c = empty_cache(pkg)
    for q in range(queues):
        c.add_queue(tu.build_queue(f"q{q}", weight=q + 1))
    for j in range(nodes):
        c.add_node(tu.build_node(
            f"n{j}", a.build_resource_list(cpu="16", memory="64Gi",
                                           pods=110)))
    for g in range(groups):
        c.add_pod_group(tu.build_pod_group(
            f"pg{g}", namespace="ns", min_member=1, queue=f"q{g % queues}"))
        for i in range(per_group):
            c.add_pod(tu.build_pod(
                "ns", f"pg{g}-p{i}", "", a.PodPhase.PENDING,
                a.build_resource_list(
                    cpu=f"{int(rng.choice([250, 500, 1000]))}m",
                    memory=f"{int(rng.choice([256, 512, 1024]))}Mi"),
                group_name=f"pg{g}"))
    return c


def session_pairs(ssn, pkg):
    """Every pending task, round-robin over nodes by stable uid order."""
    nodes = sorted(ssn.nodes)
    pending = pkg.api.TaskStatus.PENDING
    tasks = sorted(
        (t for job in ssn.jobs.values()
         for t in job.task_status_index.get(pending, {}).values()),
        key=lambda t: t.uid,
    )
    return [(t, nodes[k % len(nodes)]) for k, t in enumerate(tasks)]


def add_gang(pkg, cache, group, reqs, **extra):
    a, tu = pkg.api, pkg.tu
    cache.add_pod_group(tu.build_pod_group(
        group, namespace="ns", min_member=1, queue="q0"))
    for i, (cpu, mem) in enumerate(reqs):
        cache.add_pod(tu.build_pod(
            "ns", f"{group}-p{i}", "", a.PodPhase.PENDING,
            a.build_resource_list(cpu=f"{cpu}m", memory=f"{mem}Mi",
                                  **extra),
            group_name=group))


class Pair:
    """The same cluster in both packages, stepped in lockstep; the port
    packs onto ``device``."""

    def __init__(self, build, device="cpu"):
        self.jax = jax_pkg()
        self.jc, self.pc = build(self.jax), build(PORT)
        self.device = device
        device_cache_of(self.pc, device)

    def open(self):
        self.js = self.jax.open_session(self.jc, tiers(self.jax))
        self.ps = PORT.open_session(self.pc, tiers(PORT))

    def close(self):
        self.jax.close_session(self.js)
        PORT.close_session(self.ps)

    def pack(self):
        """Tensorize both; returns (jax inputs, jax ctx, port inputs,
        port ctx), holds the two packs' stats to each other and keeps
        the port's in ``self.stats``."""
        ji, jctx = self.jax.snapshot.tensorize(self.js)
        pi, pctx = PORT.snapshot.tensorize(self.ps)
        assert (ji is None) == (pi is None)
        self.stats = dict(port_stats)
        if pi is not None:
            assert self.stats == dict(jax_stats)
        return ji, jctx, pi, pctx

    def allocate(self, pick):
        for pkg, ssn, c in ((self.jax, self.js, self.jc),
                            (PORT, self.ps, self.pc)):
            pairs = session_pairs(ssn, pkg)
            ssn.allocate_batch([pairs[i] for i in pick(len(pairs))])
            assert c.wait_for_side_effects()
            assert c.wait_for_bookkeeping()

    def step(self, fn):
        fn(self.jax, self.jc)
        fn(PORT, self.pc)

    def shutdown(self):
        self.jc.shutdown()
        self.pc.shutdown()


def host_fields(inputs):
    return {f: getattr(inputs, f).cpu().numpy().copy()
            for f in inputs._fields}


def check_resident(pi, pctx, device):
    """The resident buffers equal the host bundle's stacking and a cold
    pack into a fresh cache, bit for bit."""
    want = pack_inputs(pctx.host_inputs, "cpu")
    fresh = DeviceSnapshotCache(device).pack(
        {f: getattr(want, f).numpy() for f in want._fields})
    for f in PackedInputs._fields:
        got = getattr(pi, f)
        assert got.device.type == torch.device(device).type, f
        assert torch.equal(got.cpu(), getattr(want, f)), f
        assert torch.equal(got, getattr(fresh, f)), f


def test_randomized_churn_parity():
    rng = np.random.RandomState(17)
    pair = Pair(lambda p: cycle_cluster(p, seed=17, groups=8, per_group=6,
                                        nodes=8))
    saw_patch = saw_reuse = False
    extra = 0
    ptrs = {}
    for cycle in range(8):
        pair.open()
        ji, jctx, pi, pctx = pair.pack()
        if pi is not None:
            check_resident(pi, pctx, "cpu")
            saw_patch |= pair.stats["patches"] > 0
            saw_reuse |= pair.stats["reuses"] > 0
            # Reused and patched fields are the previous pack's buffers.
            for f, outcome in pair.stats["field_outcomes"].items():
                if outcome in ("patch", "reuse"):
                    assert getattr(pi, f).data_ptr() == ptrs[f], f
            ptrs = {f: getattr(pi, f).data_ptr() for f in pi._fields}
        pairs = session_pairs(pair.ps, PORT)
        if pairs:
            take = rng.randint(1, min(6, len(pairs)) + 1)
            idx = sorted(rng.choice(len(pairs), size=take, replace=False))
            pair.allocate(lambda n: idx)
        pair.close()
        if cycle % 2 == 0:
            g = f"pgx{extra}"
            extra += 1
            reqs = [(int(rng.choice([250, 500])), 256)
                    for _ in range(int(rng.randint(1, 4)))]
            pair.step(lambda pkg, c: add_gang(pkg, c, g, reqs))
    assert saw_patch and saw_reuse
    pair.shutdown()


def test_solver_results_bit_exact_on_patched_inputs():
    """The solve on patched buffers equals the solve on a fresh pack and
    the solve of the JAX package's own host bundle."""
    pair = Pair(lambda p: cycle_cluster(p, seed=23))
    pair.open()
    pair.pack()
    pair.allocate(lambda n: range(3))
    pair.close()
    pair.open()
    ji, jctx, pi, pctx = pair.pack()
    assert pair.stats["patches"] > 0
    got = solve_auto(pi).to_numpy()
    fresh = solve_auto(pack_inputs(pctx.host_inputs, "cpu")).to_numpy()
    ref = solve_auto(pack_inputs(jctx.host_inputs, "cpu")).to_numpy()
    for want in (fresh, ref):
        for k in ("assigned", "node_idle", "queue_allocated"):
            assert np.array_equal(got[k], want[k]), k
        assert (got["rounds"], got["stages"], got["refills"]) == (
            want["rounds"], want["stages"], want["refills"])
    assert (got["assigned"][:len(pctx.tasks)] >= 0).any()
    pair.close()
    pair.shutdown()


def test_steady_cycle_zero_uploads():
    pair = Pair(lambda p: cycle_cluster(p, seed=29))
    pair.open()
    pair.pack()
    _, _, pi, _ = pair.pack()
    assert pi is not None
    assert pair.stats["uploads"] == 0
    assert pair.stats["patches"] == 0
    assert pair.stats["bytes_shipped"] == 0
    assert pair.stats["reuses"] == len(PackedInputs._fields)
    pair.close()
    pair.shutdown()


def test_bucket_growth_falls_back_to_full_upload():
    pair = Pair(lambda p: cycle_cluster(p, seed=31, groups=6, per_group=8))
    pair.open()
    _, _, pi, _ = pair.pack()
    assert pi.task_f32.shape[1] == 256
    pair.close()
    pair.step(lambda pkg, c: add_gang(pkg, c, "pgrow", [(250, 256)] * 240))
    pair.open()
    _, _, pi, pctx = pair.pack()
    assert pair.stats["full_reasons"].get("task_f32") == "shape-change"
    assert pair.stats["full_reasons"].get("task_i32") == "shape-change"
    check_resident(pi, pctx, "cpu")
    pair.close()
    pair.shutdown()


def test_layout_change_falls_back_to_full_upload():
    pair = Pair(lambda p: cycle_cluster(p, seed=37))
    pair.open()
    pair.pack()
    pair.close()
    pair.step(lambda pkg, c: add_gang(pkg, c, "pgpu", [(500, 256)],
                                      **{"nvidia.com/gpu": 1}))
    pair.open()
    _, _, pi, pctx = pair.pack()
    for f in ("task_f32", "node_f32", "queue_f32", "misc"):
        assert pair.stats["full_reasons"].get(f) == "shape-change", f
    check_resident(pi, pctx, "cpu")
    pair.close()
    pair.shutdown()


def test_pack_ownership_is_cache_scoped():
    """A later pack patches the earlier pack's buffers in place: a
    PackedInputs held across packs on one scheduler cache reads the new
    cycle's values, while the reference deletes its donated buffers."""
    pair = Pair(lambda p: cycle_cluster(p, seed=41))
    pair.open()
    _, _, p0, _ = pair.pack()
    held = {f: getattr(p0, f) for f in p0._fields}
    before = host_fields(p0)
    pair.allocate(lambda n: range(2))
    pair.close()
    pair.open()
    _, _, p1, _ = pair.pack()
    patched = [f for f, o in pair.stats["field_outcomes"].items()
               if o == "patch"]
    assert patched
    for f in patched:
        assert held[f].data_ptr() == getattr(p1, f).data_ptr()
        assert torch.equal(held[f], getattr(p1, f))
        assert not np.array_equal(before[f], held[f].numpy())
    pair.close()
    pair.shutdown()


def test_device_is_fixed_by_the_first_cache_and_cuda_is_the_default():
    c = cycle_cluster(PORT, seed=43)
    assert device_cache_of(c, "cpu").device == torch.device("cpu")
    assert device_cache_of(c) is device_cache_of(c, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            device_cache_of(c, "cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            device_cache_of(cycle_cluster(PORT, seed=43))
    c.shutdown()


@pytest.mark.gpu
def test_churn_on_card_equals_cpu():
    """The randomized churn with one port cache resident on ``cuda`` and
    another on the CPU: the same decisions and stats, equal buffers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu "
                    "tests/test_torch_device_cache.py` on the card")
    rng = np.random.RandomState(17)
    caches = {}
    for dev in ("cuda", "cpu"):
        caches[dev] = cycle_cluster(PORT, seed=17, groups=8, per_group=6,
                                    nodes=8)
        device_cache_of(caches[dev], dev)
    for cycle in range(6):
        ssns = {d: PORT.open_session(c, tiers(PORT))
                for d, c in caches.items()}
        packs, stats = {}, {}
        for d, ssn in ssns.items():
            packs[d] = PORT.snapshot.tensorize(ssn)
            stats[d] = dict(port_stats)
        assert stats["cuda"] == stats["cpu"]
        (pi, pctx), (qi, _) = packs["cuda"], packs["cpu"]
        if pi is not None:
            check_resident(pi, pctx, "cuda")
            for f in pi._fields:
                assert torch.equal(getattr(pi, f).cpu(), getattr(qi, f))
        n = len(session_pairs(ssns["cpu"], PORT))
        idx = (sorted(rng.choice(n, size=min(3, n), replace=False))
               if n else [])
        for d, ssn in ssns.items():
            pairs = session_pairs(ssn, PORT)
            ssn.allocate_batch([pairs[i] for i in idx])
            assert caches[d].wait_for_side_effects()
            assert caches[d].wait_for_bookkeeping()
            PORT.close_session(ssn)
    for c in caches.values():
        c.shutdown()
