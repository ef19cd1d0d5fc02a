"""The port's device-resident candidate selection (``solver/select_device.py``),
held to the JAX package's host selection.

The JAX package's own device selection needs ``jax.experimental.enable_x64``,
which this JAX version lacks, so the reference here is its host
``topk.select_candidates``, which that package makes bit-equal to its
device path; where a jitted JAX piece runs without 64-bit types (the
miss-row rebuild's scoring), the key rows are compared too. On the CPU
the port's selection runs the same torch ops it runs on the card.

- churned cycles: slabs, ``cand_info``, ``cand_static`` and the class
  map equal the reference's, and so do the cache hits (the engine makes
  the host cache's reuse decisions), with the miss-row rebuild split
  into chunks and the churned-column patch engaged;
- the three-level top-K on keys built to tie (equal block maxima, equal
  keys across blocks, fewer eligible nodes than K) against the host
  composite-key argpartition;
- ``tensorize(ssn, device="cpu")`` over five churn cycles: the bundle
  bytes equal the JAX ``tensorize`` with host selection
  (``KBT_SELECT_DEVICE=0``); ``select_path`` reads ``device`` in the
  port and ``host`` in the reference, by design; hits equal;
- the labelled routes: ``KBT_SELECT_DEVICE=0``, Releasing capacity, no
  device state, a failed pre-pack;
- ``device_cache.pack_partial``: decisions and stats equal the
  reference's, and the full pack reuses what it placed;
- ``drop_resident`` drops the engine's key matrix; the census counts
  new shape buckets and stays flat on a repeated cycle;
- the allocate action's slab cycles with the port selecting on the
  device equal the reference's cycles.
"""

import numpy as np
import pytest
import torch

from kube_batch_tpu.solver import topk as JT
from kube_batch_tpu.solver.masks import CombinedMask as JMask

from kube_batch_tpu_torch import metrics as port_metrics
from kube_batch_tpu_torch.solver import device_cache as PD
from kube_batch_tpu_torch.solver import select_device as SD
from kube_batch_tpu_torch.solver import topk as PT
from kube_batch_tpu_torch.solver.masks import CombinedMask as PMask

# Not the snapshot tests' autouse ``host_selection`` fixture: the JAX
# side here selects on the host without it (``tensorize(device=False)``
# and ``select_candidates`` without a device state), and the port must
# see ``KBT_SELECT_DEVICE`` unset.
from test_torch_action import (  # noqa: F401 (the setup fixture)
    CLUSTERS,
    assert_same_cycles,
    run_both,
    setup,
)
from test_torch_snapshot import (
    CHURN_CASES,
    PORT,
    Churn,
    assert_bundles_equal,
    churn_events,
    env,
    jax_pkg,
    tiers,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")


class Holder:
    pass


def problem(seed, n=700, t=300, groups=8, releasing=False):
    """The reference's seeded selection problem (its parity loop's),
    with pair rows, a private score row and capped nodes."""
    rng = np.random.RandomState(seed)
    task_req = np.c_[
        rng.choice([250, 500, 1000, 2000], t),
        rng.choice([256, 1024, 4096], t),
    ].astype(np.float32)
    node_idle = np.c_[
        rng.uniform(4000, 32000, n), rng.uniform(8192, 131072, n)
    ].astype(np.float32)
    return dict(
        rng=rng, task_req=task_req,
        task_group=(np.arange(t) % groups).astype(np.int32),
        group_rows=rng.rand(groups, n) > 0.1,
        pair_idx=np.asarray([5, 17], np.int32),
        pair_rows=rng.rand(2, n) > 0.3,
        score_rows_map={31: (rng.rand(n) * 3.0).astype(np.float32)},
        node_idle=node_idle,
        node_cap=(node_idle * 1.5).astype(np.float32),
        node_task_count=rng.randint(0, 5, n).astype(np.int32),
        node_max_tasks=np.where(rng.rand(n) < 0.2, 4, 0).astype(np.int32),
        node_ok=rng.rand(n) > 0.05,
        releasing=(np.full((n, 2), 100.0, np.float32) if releasing
                   else np.zeros((n, 2), np.float32)),
        eps=np.asarray([10.0, 10.0], np.float32),
    )


def select(pkg_topk, Mask, p, k, holder, fp, device_state=None):
    ok = p["node_ok"]
    mask = Mask(node_ok=ok, task_group=p["task_group"],
                group_rows=p["group_rows"] & ok[None, :],
                pair_idx=p["pair_idx"],
                pair_rows=p["pair_rows"] & ok[None, :])
    kw = {} if device_state is None else {"device_state": device_state}
    return pkg_topk.select_candidates(
        mask, p["score_rows_map"], p["task_req"], p["task_req"],
        p["node_idle"], p["node_cap"], p["releasing"],
        p["node_task_count"], p["node_max_tasks"], p["eps"], 1.0, 0.5, k,
        cache_holder=holder, node_fp=fp, **kw,
    ), mask


def state_of(p, mask, holder, device=CPU, n_padded=None):
    state = SD.standalone_state(
        p["node_idle"], p["node_cap"], p["node_task_count"],
        p["node_max_tasks"], p["node_ok"], mask.group_rows, device,
        n_padded=n_padded,
    )
    state.holder = holder
    return state


def churn(p, vers):
    rng, n = p["rng"], len(p["node_ok"])
    moved = rng.choice(n, size=max(n // 20, 1), replace=False)
    p["node_idle"][moved] = np.c_[
        rng.uniform(4000, 32000, len(moved)),
        rng.uniform(8192, 131072, len(moved)),
    ].astype(np.float32)
    p["node_task_count"][moved] = rng.randint(0, 5, len(moved))
    vers[moved] += 1


def assert_sets_equal(want, got):
    for f in ("task_cand", "cand_idx", "cand_static", "cand_info"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f


def run_cycles(seed, k, n_padded=None, device=CPU, cycles=5):
    """Churned cycles of the reference's host selection beside the
    port's device selection (engine resident across cycles)."""
    p = problem(seed)
    n = len(p["node_ok"])
    ids = np.arange(n, dtype=np.int64)
    vers = np.zeros(n, np.int64)
    jax_holder, engine_holder = Holder(), Holder()
    stats = []
    for _ in range(cycles):
        fp = (ids, vers.copy(), None)
        want, _ = select(JT, JMask, p, k, jax_holder, fp)
        mask = PMask(node_ok=p["node_ok"], task_group=p["task_group"],
                     group_rows=p["group_rows"] & p["node_ok"][None, :],
                     pair_idx=p["pair_idx"],
                     pair_rows=p["pair_rows"] & p["node_ok"][None, :])
        got, _ = select(PT, PMask, p, k, Holder(), fp,
                        state_of(p, mask, engine_holder, device, n_padded))
        assert got.stats["select_path"] == "device", got.stats
        assert_sets_equal(want, got)
        assert got.stats["sel_cache_hits"] == want.stats["sel_cache_hits"]
        stats.append(got.stats)
        churn(p, vers)
    return stats


@pytest.mark.parametrize("seed,k,n_padded", [
    (3, 64, None), (12, 64, 768), (13, 16, 1024), (21, 8, None),
])
def test_churned_cycles_equal_reference_host_selection(seed, k, n_padded):
    stats = run_cycles(seed, k, n_padded)
    assert stats[0]["sel_cache_hits"] == 0
    assert sum(s["sel_cache_hits"] for s in stats[1:]) > 0
    assert sum(s["sel_cols_patched"] for s in stats[1:]) > 0
    assert stats[0]["sel_rows_rebuilt"] > 0


def test_miss_rebuild_in_chunks_equals_one_pass(monkeypatch):
    """A cell cap below one row's width rebuilds one class per chunk;
    the slabs still equal the reference's."""
    monkeypatch.setattr(SD, "_MISS_CHUNK_CELLS", 1)
    stats = run_cycles(seed=5, k=32, cycles=2)
    assert stats[0]["sel_rows_rebuilt"] > 1


def test_miss_rebuild_key_rows_equal_the_jax_rebuild():
    """The port's miss-row rebuild writes the key rows the JAX package's
    jitted rebuild writes (that piece runs without 64-bit types)."""
    import jax.numpy as jnp

    from kube_batch_tpu.solver import select_device as JSD

    p = problem(9, n=640, t=120)
    mask = PMask(node_ok=p["node_ok"], task_group=p["task_group"],
                 group_rows=p["group_rows"], pair_idx=p["pair_idx"],
                 pair_rows=p["pair_rows"])
    state = state_of(p, mask, None, n_padded=768)
    cp, Np, C = 16, 768, 11
    rows = np.arange(C, dtype=np.int32)
    req = p["task_req"][:16].copy()
    groups = p["task_group"][:16].astype(np.int32)
    want = JSD._miss_jit()(
        jnp.full((cp, Np), -1, jnp.int32), jnp.asarray(rows),
        jnp.asarray(req[:C]), jnp.asarray(req[:C]), jnp.asarray(rows),
        jnp.asarray(groups[:C]), jnp.asarray(state.node_f32.numpy()),
        jnp.asarray(state.node_i32.numpy()),
        jnp.asarray(state.group_feas.numpy()), jnp.asarray(p["eps"]),
        jnp.float32(1.0), jnp.float32(0.5),
    )
    keys = torch.full((cp, Np), -1, dtype=torch.int32)
    r = torch.from_numpy(rows.astype(np.int64))
    SD._rebuild_rows(keys, r, torch.from_numpy(req[:C]),
                     torch.from_numpy(req[:C]), r,
                     torch.from_numpy(groups[:C].astype(np.int64)),
                     state.node_f32, state.node_i32, state.group_feas,
                     torch.from_numpy(p["eps"]), 1.0, 0.5)
    assert np.array_equal(keys.numpy(), np.asarray(want))
    assert (keys.numpy()[:C] >= 0).any()


def host_topk(keys, kk, sentinel):
    """The host epilogue of ``topk.select_candidates`` on a key matrix:
    composite-key argpartition, sentinel for ineligible picks, sorted."""
    rows, n = keys.shape
    skey = keys.astype(np.int64)
    tie_lo = (np.int64(1) << PT._TIE_BITS) - 1 - np.arange(n, dtype=np.int64)
    comp = (skey << PT._TIE_BITS) + tie_lo[None, :]
    if kk < n:
        part = np.argpartition(comp, n - kk, axis=1)[:, n - kk:]
    else:
        part = np.broadcast_to(np.arange(n), (rows, n)).copy()
    pkey = np.take_along_axis(skey, part, axis=1)
    part = part.astype(np.int32)
    part[pkey < 0] = sentinel
    part.sort(axis=1)
    return part


def tie_keys(case, rng, cp=8, n=1000):
    """Key matrices built to tie at every level of the extraction."""
    if case == "all-equal":
        return np.full((cp, n), 5 << 10, np.int32)
    if case == "block-max-ties":
        keys = rng.randint(0, 4, (cp, n)).astype(np.int32) << 10
        keys[:, ::97] = 9 << 10          # the same maximum in most blocks
        return keys
    if case == "few-eligible":
        keys = np.full((cp, n), -1, np.int32)
        for r in range(cp):
            cols = rng.choice(n, size=r * 3, replace=False)
            keys[r, cols] = rng.randint(0, 3, len(cols)) << 10
        return keys
    if case == "quantized-plateaus":
        q = rng.randint(0, 6, (cp, n)).astype(np.int32)
        return (q << 10) | rng.randint(0, 2, (cp, n)).astype(np.int32)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["all-equal", "block-max-ties",
                                  "few-eligible", "quantized-plateaus"])
@pytest.mark.parametrize("kk", [8, 64, 300])
def test_topk_ties_equal_the_host_argpartition(case, kk):
    keys = tie_keys(case, np.random.RandomState(kk))
    n = keys.shape[1]
    want = host_topk(keys, kk, sentinel=n)
    cand, count = SD._topk_rows(torch.from_numpy(keys), kk, n)
    assert np.array_equal(cand.numpy(), want)
    assert np.array_equal(count.numpy(), (keys >= 0).sum(axis=1))


@pytest.mark.parametrize("case", sorted(
    c for c, (_, topk) in CHURN_CASES.items() if topk != "off"))
def test_tensorize_churn_equals_reference_host_selection(case):
    """Five churn cycles through ``tensorize``: the port with its device
    cache on the CPU (device selection), the JAX package with host
    selection. Bundles are byte-equal and the cache hits equal; only
    ``select_path`` and the device path's row/column counts differ."""
    build, topk = CHURN_CASES[case]
    rng = np.random.RandomState(23)

    def snap(pkg, cache, device):
        ssn = pkg.open_session(cache, tiers(pkg))
        try:
            _, ctx = pkg.snapshot.tensorize(ssn, device=device)
            stats = dict(pkg.snapshot.last_tensorize_stats)
        finally:
            pkg.close_session(ssn)
        return ctx, stats

    with env(KBT_SOLVER_TOPK=topk):
        sides = [Churn(jax_pkg(), build), Churn(PORT, build)]
        PD.device_cache_of(sides[1].cache, "cpu")
        paths, hits = [], []
        for cycle in range(6):
            if cycle:
                nodes = sorted(sides[1].cache.nodes)
                for e in churn_events(cycle, rng, cp, nodes):
                    for side in sides:
                        side.step(e)
            cj, sj = snap(jax_pkg(), sides[0].cache, False)
            cp, sp = snap(PORT, sides[1].cache, "cpu")
            assert_bundles_equal(cj.host_inputs, cp.host_inputs,
                                 f"cycle {cycle}")
            js, ps = sj.pop("sparse"), sp.pop("sparse")
            assert sj == sp, cycle
            assert js["select_path"] == "host"
            paths.append(ps.pop("select_path"))
            rebuilt = ps.pop("sel_rows_rebuilt")
            ps.pop("sel_cols_patched")
            js.pop("select_path")
            assert ps == js, cycle
            hits.append(ps["sel_cache_hits"])
            assert cycle or rebuilt == ps["classes"]
    assert paths == ["device"] * 6
    assert hits[0] == 0 and sum(hits[1:]) > 0
    for side in sides:
        side.cache.shutdown()


def one_shot(device_state, releasing=False):
    p = problem(0, n=64, t=16, groups=1, releasing=releasing)
    p["node_ok"][:] = True
    p["group_rows"][:] = True
    p["score_rows_map"] = {}
    p["pair_idx"] = np.zeros(0, np.int32)
    p["pair_rows"] = np.zeros((0, 64), bool)
    return select(PT, PMask, p, 8, None, None, device_state)[0], p


def tiny_state():
    _, p = one_shot(None)
    mask = PMask(node_ok=p["node_ok"], task_group=p["task_group"],
                 group_rows=p["group_rows"], pair_idx=p["pair_idx"],
                 pair_rows=p["pair_rows"])
    return state_of(p, mask, None)


def test_routes_are_labelled(monkeypatch):
    before = port_metrics.solver_selection_device.total()
    assert one_shot(tiny_state())[0].stats["select_path"] == "device"
    assert port_metrics.solver_selection_device.total() == before + 1
    assert one_shot(None)[0].stats["select_path"] == "host"
    assert one_shot(tiny_state(), releasing=True)[0].stats[
        "select_path"] == "host:releasing"
    unavailable = SD.SelectionDeviceState(None, None, None, None, 64)
    assert one_shot(unavailable)[0].stats["select_path"] == \
        "host:device-unavailable"
    monkeypatch.setenv("KBT_SELECT_DEVICE", "0")
    cs, _ = one_shot(tiny_state())
    assert cs.stats["select_path"] == "host:env-disabled"
    assert port_metrics.solver_selection_device.total() == before + 1
    assert not SD.device_select_enabled()


def stacks(rng, n=2048, groups=4):
    return {
        "node_f32": rng.rand(3, n, 2).astype(np.float32),
        "node_i32": rng.randint(0, 9, (3, n)).astype(np.int32),
        "group_feas": rng.rand(groups, n) > 0.2,
    }


def full_arrays(rng, part, t=512, r=2, p=3, s=2, q=2, c=8, k=16):
    """Every stacked field of ``PackedInputs``, the node stacks and
    group rows from ``part``."""
    n = part["node_i32"].shape[1]
    arrays = dict(part)
    arrays.update(
        task_f32=rng.rand(2, t, r).astype(np.float32),
        task_i32=rng.randint(0, 9, (6, t)).astype(np.int32),
        pair_idx=rng.randint(0, t, p).astype(np.int32),
        pair_feas=rng.rand(p, n) > 0.5,
        score_idx=rng.randint(0, t, s).astype(np.int32),
        score_rows=rng.rand(s, n).astype(np.float32),
        queue_f32=rng.rand(2, q, r).astype(np.float32),
        misc=rng.rand(r + 2).astype(np.float32),
        cand_idx=rng.randint(0, n, (c, k)).astype(np.int32),
        cand_static=rng.rand(c, k).astype(np.float32),
        cand_info=rng.randint(0, 9, (3, c)).astype(np.int32),
    )
    return arrays


def test_pack_partial_stats_equal_reference():
    """pack_partial then pack, over cold, reuse, patched and bulk-dirty
    cycles, in both packages: equal decisions and ``last_pack_stats``;
    the full pack hands back the buffers the partial placed."""
    from kube_batch_tpu.solver import device_cache as JD

    rng = np.random.RandomState(4)
    jdc, pdc = JD.DeviceSnapshotCache(), PD.DeviceSnapshotCache("cpu")
    part = stacks(rng)
    arrays = full_arrays(rng, part)
    for cycle in range(4):
        if cycle == 2:   # a few dirty node rows: patched
            part["node_f32"][:, 7] += 1.0
            part["node_i32"][:, 11] += 1
        if cycle == 3:   # most rows dirty: bulk upload
            part["node_f32"] += 1.0
            arrays["task_f32"] = arrays["task_f32"] + 1.0
        arrays.update(part)
        jdc.pack_partial({k: v.copy() for k, v in part.items()})
        placed = pdc.pack_partial({k: v.copy() for k, v in part.items()})
        jdc.pack({k: v.copy() for k, v in arrays.items()})
        packed = pdc.pack({k: v.copy() for k, v in arrays.items()})
        assert dict(PD.last_pack_stats) == dict(JD.last_pack_stats), cycle
        for name, buf in placed.items():
            assert getattr(packed, name) is buf
            assert np.array_equal(buf.numpy(), part[name])
    assert PD.last_pack_stats["uploads"] > 0


def test_drop_resident_invalidates_the_engine():
    holder = Holder()
    p = problem(2)
    mask = PMask(node_ok=p["node_ok"], task_group=p["task_group"],
                 group_rows=p["group_rows"], pair_idx=p["pair_idx"],
                 pair_rows=p["pair_rows"])
    state = state_of(p, mask, holder)
    n = len(p["node_ok"])
    fp = (np.arange(n, dtype=np.int64), np.zeros(n, np.int64), None)
    first = select(PT, PMask, p, 64, Holder(), fp, state)[0].stats
    eng = holder._topk_dev_engine
    assert eng.keys is not None and eng.row_digests
    warm = select(PT, PMask, p, 64, Holder(), fp, state)[0].stats
    assert warm["sel_cache_hits"] == first["sel_rows_rebuilt"] > 0
    PD.drop_resident(holder, "solve-abandoned")
    assert eng.keys is None and eng.row_digests == {} and eng.sig is None
    again, _ = select(PT, PMask, p, 64, Holder(), fp, state)
    assert again.stats["sel_cache_hits"] == 0
    assert again.stats["sel_rows_rebuilt"] == first["sel_rows_rebuilt"]


def test_census_counts_new_buckets_and_stays_flat():
    from kube_batch_tpu_torch.solver.kernels import jit_compilation_count

    p = problem(6)
    n = len(p["node_ok"])
    fp = (np.arange(n, dtype=np.int64), np.zeros(n, np.int64), None)
    mask = PMask(node_ok=p["node_ok"], task_group=p["task_group"],
                 group_rows=p["group_rows"], pair_idx=p["pair_idx"],
                 pair_rows=p["pair_rows"])
    holder = Holder()
    first, _ = select(PT, PMask, p, 128, Holder(), fp,
                      state_of(p, mask, holder))
    warm = jit_compilation_count()
    for _ in range(3):   # the same cycle again: all hits, no new bucket
        cs, _ = select(PT, PMask, p, 128, Holder(), fp,
                       state_of(p, mask, holder))
        assert cs.stats["sel_cache_hits"] == first.stats["sel_rows_rebuilt"]
        assert jit_compilation_count() == warm
    select(PT, PMask, p, 256, Holder(), fp, state_of(p, mask, holder))
    assert jit_compilation_count() > warm   # a new top-K variant


@pytest.mark.gpu
def test_device_selection_on_the_card_equals_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m gpu "
                    "tests/test_torch_select_device.py` on the card")
    stats = run_cycles(seed=3, k=64, n_padded=768,
                       device=torch.device("cuda"))
    assert sum(s["sel_cols_patched"] for s in stats[1:]) > 0


def test_action_cycles_with_device_selection_equal_reference(
        setup, monkeypatch):
    """The congested slab cycles of ``tests/test_torch_action.py`` with
    the port selecting on the device (its ``KBT_SELECT_DEVICE`` gate
    forced open; the JAX side keeps host selection): every cycle equals
    the reference's — warm outcomes, ladders, assignments, rounds,
    stages, refills and binds."""
    monkeypatch.setattr(SD, "device_select_enabled", lambda: True)
    setup["port_action"].use_kernel = False
    ref, got = run_both(setup, *CLUSTERS["slabs"])
    assert_same_cycles(ref, got)
    paths = {c["cycle"]: c["stats"].get("select_path") for c in got}
    assert paths["cold"] == "device", paths
    # The reference's snapshot consults the gate before it builds a
    # device state, so its closed gate reads plain "host".
    assert {c["stats"].get("select_path") for c in ref} == {"host"}
