"""Device-resident top-K candidate selection.

A port of the reference's ``solver/select_device.py``. ``solver/topk.py``
runs phase 1 of the sparse solve — per-class scoring plus top-K
extraction over the [C, N] key matrix — in host NumPy. This module runs
the same arithmetic on the device while keeping the HOST path's bits:

- the integer key rows come from a torch transcription of
  ``topk._skey_block`` that is bit-equal to the NumPy original. Every
  product and sum is its own eager op, so each rounds once, as NumPy's
  float32 does (no ``addcmul``, no fused or compiled op). Divisions take
  a device tensor as divisor: CUDA torch turns division by a host scalar
  into multiplication by its reciprocal, which rounds differently. This
  is the opposite of the solver's ``kernels._fma_f32``, which matches
  XLA's contractions; selection matches NumPy, so the two share no code;
- the resident [Cp, Np] int32 key matrix reuses ``_SelectionCache``'s
  content addressing verbatim — per-class blake2b digests over (feas,
  fit, req) plus the node scan's (id, version) fingerprints — so a warm
  steady cycle recomputes only churned columns and missed rows on the
  device, O(C·churn) instead of O(C·N), with the same hit and miss
  decisions the host cache makes;
- node state is never uploaded for selection: the engine reads the
  device-resident ``PackedInputs`` stacks (``node_f32``, ``node_i32``,
  ``group_feas``) that ``device_cache.pack_partial`` placed ahead of the
  selection pass, so a cycle ships only the per-class req/fit rows and
  the churned column indexes;
- top-K extraction narrows in three levels whose selected SET equals
  the host composite-key argpartition exactly (both prefer the smaller
  node id on quantized-score ties). ``torch.topk`` promises no order
  among equal values, so every key it ranks is made unique first.

Under a mesh (``sharding.default_mesh`` of the session's device, when
its size divides the padded class count) the key matrix is split over
the class axis, one block of rows per shard on the shard's device, as
the reference shards it: scoring and top-K are independent per row, so
each block runs the same passes and the results concatenate in shard
order. The solver's layout token rides in the signature, so a mesh or
mode change rebuilds every row.

``KBT_SELECT_DEVICE`` is the off switch (``0``/``off``/``host``):
selection then takes the labelled host path. Releasing capacity also
routes to the host (the releasing column is not cacheable, the host
selection cache's own rule).
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from .kernels import (
    _KEY_BIAS,
    _KEY_HASH_BITS,
    CPU_DIM,
    MAX_PRIORITY,
    MEM_DIM,
    SCORE_QUANTUM,
)

# Per-chunk cell cap for the miss-row rebuild (int32 keys plus float32
# score temporaries stay at hundreds of MB at the largest shapes).
_MISS_CHUNK_CELLS = 1 << 24

SELECT_DEVICE_ENV = "KBT_SELECT_DEVICE"

# Shape buckets minted so far — (kk, sentinel) top-K variants and
# power-of-two row and column buckets — the selection term of the
# compilation census (kernels.jit_compilation_count). The reference
# compiles one program per bucket; eager torch compiles none, and the
# census keeps the count so growth across steady cycles still shows a
# shape drifting per cycle.
_minted_topk: set = set()
_minted_rows: set = set()
_minted_cols: set = set()
_minted_lock = threading.Lock()


def device_select_enabled() -> bool:
    """Resolve the ``KBT_SELECT_DEVICE`` gate (default: enabled — the
    device path is bit-equal to the host path by construction, so the
    switch exists for forensics and fallback, not correctness)."""
    raw = os.environ.get(SELECT_DEVICE_ENV, "").strip().lower()
    return raw not in ("0", "off", "host", "disable", "disabled", "false")


def census() -> int:
    """Distinct selection shape buckets minted in this process."""
    with _minted_lock:
        return len(_minted_topk) + len(_minted_rows) + len(_minted_cols)


def _pow2(n: int) -> int:
    if n <= 0:
        return 1
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# Bit-exact torch transcription of the host scoring/key math.
# ---------------------------------------------------------------------------


def _dyn_score_dev(req, idle, cap, lr_w: float, br_w: float):
    """Torch twin of ``topk._dyn_score_np``: the same per-dimension 2-D
    passes in the same op order, float32 throughout, one rounding per
    op. ``req`` is [B, R]; ``idle`` and ``cap`` are [M, R]."""
    dev = req.device
    f32 = torch.float32
    ten = torch.tensor(MAX_PRIORITY, dtype=f32, device=dev)
    one = torch.tensor(1.0, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
    lr_acc = None
    fracs = []
    over = None
    for d in (CPU_DIM, MEM_DIM):
        req_d = req[:, d:d + 1]                      # [B, 1]
        idle_d = idle[None, :, d]                    # [1, M]
        cap_d = cap[None, :, d]
        pos = cap_d > 0
        safe_cap = torch.where(pos, cap_d, one)
        remaining = idle_d - req_d                   # [B, M]
        lr = torch.where(
            pos, torch.clamp_min(remaining, 0.0) * ten / safe_cap, zero
        )
        lr_acc = lr if lr_acc is None else lr_acc + lr
        frac = torch.where(pos, one - remaining / safe_cap, one)
        fracs.append(frac)
        o = frac >= 1.0
        over = o if over is None else (over | o)
    lr_score = lr_acc * 0.5
    diff = torch.abs(fracs[0] - fracs[1])
    br_score = torch.where(over, zero, ten - diff * ten)
    return lr_score * float(np.float32(lr_w)) + br_score * float(
        np.float32(br_w)
    )


_U32 = 0xFFFFFFFF


def _mul_u32(x, c: int):
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) without leaving
    int64: the constant is split into 16-bit halves."""
    lo = (x * (c & 0xFFFF)) & _U32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _sel_hash_dev(c_ids, n_ids):
    """Torch twin of ``topk._sel_hash`` (uint32 mix, 10-bit output), in
    int64 arithmetic masked to 32 bits."""
    x = _mul_u32(c_ids.long(), 2654435761) ^ _mul_u32(n_ids.long(),
                                                      0x9E3779B9)
    x = x ^ (x >> 13)
    x = _mul_u32(x, 2246822519)
    return (x >> 8) & ((1 << _KEY_HASH_BITS) - 1)


def _skey_cells_dev(req, fit, class_ids, col_ids, feas_cols,
                    idle_c, cap_c, cap_ok_c, eps, lr_w, br_w):
    """Integer selection keys for a row block x column subset — the
    device twin of ``topk._skey_block`` (int32: q <= 2^20-1 shifted by
    10 hash bits tops out below 2^30)."""
    R = req.shape[1]
    fit_ok = feas_cols & cap_ok_c[None, :]
    for d in range(R):
        fit_ok &= (fit[:, d:d + 1] - idle_c[None, :, d]) < eps[d]
    score = _dyn_score_dev(req, idle_c, cap_c, lr_w, br_w)
    quantum = torch.tensor(SCORE_QUANTUM, dtype=torch.float32,
                           device=score.device)
    q = torch.clamp(
        torch.round(score / quantum).long() + _KEY_BIAS, 0, (1 << 20) - 1
    )
    skey = (q << _KEY_HASH_BITS) | _sel_hash_dev(
        class_ids[:, None], col_ids[None, :]
    )
    return torch.where(fit_ok, skey, -1).to(torch.int32)


def _node_views(node_f32, node_i32):
    idle = node_f32[0]
    cap = node_f32[2]
    cnt = node_i32[0]
    maxt = node_i32[1]
    nfeas = node_i32[2].bool()
    cap_ok = (maxt == 0) | (cnt < maxt)
    return idle, cap, nfeas, cap_ok


def _rebuild_rows(keys, rows, req, fit, class_ids, group_ids,
                  node_f32, node_i32, group_feas, eps, lr_w, br_w):
    """Miss-row rebuild: full key rows for ``rows`` against every
    resident node column, written into the key matrix in place."""
    idle, cap, nfeas, cap_ok = _node_views(node_f32, node_i32)
    Np = idle.shape[0]
    feas = group_feas[group_ids] & nfeas[None, :]
    cols = torch.arange(Np, dtype=torch.int64, device=keys.device)
    block = _skey_cells_dev(req, fit, class_ids, cols, feas, idle, cap,
                            cap_ok, eps, lr_w, br_w)
    keys.index_copy_(0, rows, block)


def _patch_cols(keys, cols, req, fit, class_ids, group_ids,
                node_f32, node_i32, group_feas, eps, lr_w, br_w):
    """Churned-column patch: recompute EVERY resident row at ``cols``
    and write along the node axis in place. Miss and private rows get
    values here that the later writes overwrite — the order is column
    patch, miss rebuild, private-row scatter."""
    idle, cap, nfeas, cap_ok = _node_views(node_f32, node_i32)
    # Column-slice the group table BEFORE the per-class gather, so the
    # temporary is [G, M] + [Cp, M], never [Cp, Np].
    feas = group_feas[:, cols][group_ids] & nfeas[cols][None, :]
    block = _skey_cells_dev(req, fit, class_ids, cols, feas, idle[cols],
                            cap[cols], cap_ok[cols], eps, lr_w, br_w)
    keys.index_copy_(1, cols, block)


# Hierarchical-extraction block widths (the reference's, kept so the
# three levels narrow the same way): level 1 ranks blocks of 256
# columns by their maximum, level 2 blocks of 64 within the survivors.
_EXTRACT_BLOCK1 = 256
_EXTRACT_BLOCK2 = 64


def _topk_rows(keys, kk: int, sentinel: int):
    """Exact top-``kk`` extraction over the resident key matrix,
    bit-equal to the host composite-key argpartition. Returns the
    candidate columns int32[Cp, kk] ascending (``sentinel`` for picks
    with no eligible node) and the eligible count int32[Cp].

    Level 1 reduces M1-column blocks to their maxima and keeps the top
    ``kk`` blocks. Its ranking key is ``(block max) * 2^32 + (B1-1-block)``,
    unique per block, so equal maxima rank the lower block first without
    asking ``torch.topk`` to order ties. The kept blocks provably contain
    the exact composite-key top-kk: were an element's block displaced,
    every one of the >= kk displacing blocks would hold an element
    beating it on (skey, smaller column) — a greater maximum, or an equal
    one in a block of smaller columns. Level 2 gathers the survivors,
    switches to the host composite key ``(skey << _TIE_BITS) + (2^31-1 -
    col)`` (unique per cell, so the same argument needs no tie care) and
    repeats with M2-column blocks. Level 3 sorts the narrow remnant,
    keeps the top kk, decodes the columns, maps ineligible picks
    (skey -1, a negative composite) to the sentinel and sorts them
    ascending — the host epilogue."""
    from .topk import _TIE_BITS

    cp, np_ = keys.shape
    dev = keys.device
    count = (keys >= 0).sum(dim=1, dtype=torch.int32)

    m1, m2 = _EXTRACT_BLOCK1, _EXTRACT_BLOCK2
    b1 = -(-np_ // m1)
    kpad = torch.full((cp, b1 * m1), -1, dtype=torch.int32, device=dev)
    kpad[:, :np_] = keys
    kpad = kpad.view(cp, b1, m1)
    p1 = min(kk, b1)
    rank1 = kpad.amax(dim=2).long() * (1 << 32) + (
        b1 - 1 - torch.arange(b1, dtype=torch.int64, device=dev)
    )
    blk1 = torch.topk(rank1, p1, dim=1).indices              # [cp, p1]
    rows = torch.arange(cp, device=dev)[:, None]
    col1 = blk1[:, :, None] * m1 + torch.arange(m1, device=dev)
    tie_lo = (1 << _TIE_BITS) - 1
    comp = (
        kpad[rows, blk1].long() * (1 << _TIE_BITS) + (tie_lo - col1)
    ).reshape(cp, p1 * m1)
    b2 = (p1 * m1) // m2
    p2 = min(kk, b2)
    blk2 = torch.topk(comp.view(cp, b2, m2).amax(dim=2), p2, dim=1).indices
    g2 = comp.view(cp, b2, m2)[rows, blk2].reshape(cp, p2 * m2)
    top = torch.sort(g2, dim=1).values[:, p2 * m2 - kk:]
    col = (tie_lo - (top & tie_lo)).to(torch.int32)
    cand = torch.where(top >= 0, col, sentinel)
    return torch.sort(cand, dim=1).values, count


# ---------------------------------------------------------------------------
# Engine: resident key matrix + content-addressed row reuse.
# ---------------------------------------------------------------------------


class _DeviceTopKEngine:
    """Device-resident selection state, held on the scheduler cache as
    ``_topk_dev_engine`` (mirrors ``topk._SelectionCache`` exactly in
    its bookkeeping; the rows live on the device instead of in a dict)."""

    __slots__ = (
        "sig", "keys", "cp", "row_digests",
        "node_objs", "node_ids", "node_vers",
    )

    def __init__(self):
        self.sig = None
        # Resident int32 keys: [Cp, Np] as one block per shard of the
        # class-axis placement (one block without a mesh), in row order.
        self.keys = None
        self.cp = 0
        self.row_digests: Dict[int, bytes] = {}
        # Node fingerprint pins — same identity-witness rationale as
        # _SelectionCache.node_objs.
        self.node_objs = None
        self.node_ids = None
        self.node_vers = None

    def invalidate(self) -> None:
        self.sig = None
        self.keys = None
        self.row_digests = {}
        self.node_objs = None
        self.node_ids = None
        self.node_vers = None


class SelectionDeviceState:
    """Per-cycle handle the snapshot passes into ``select_candidates``:
    the device-resident node stacks (placed by the early
    ``device_cache.pack_partial``) plus where the engine lives."""

    __slots__ = (
        "holder", "node_f32", "node_i32", "group_feas",
        "n_padded", "layout_token", "_engine",
    )

    def __init__(self, holder, node_f32, node_i32, group_feas,
                 n_padded: int, layout_token: Optional[str] = None):
        self.holder = holder
        self.node_f32 = node_f32
        self.node_i32 = node_i32
        self.group_feas = group_feas
        self.n_padded = int(n_padded)
        # The pack's layout token (sharding.packed_sparse_placement),
        # part of the engine's signature.
        self.layout_token = layout_token
        self._engine = None

    def engine(self) -> _DeviceTopKEngine:
        if self.holder is not None:
            eng = getattr(self.holder, "_topk_dev_engine", None)
            if eng is None:
                eng = _DeviceTopKEngine()
                try:
                    self.holder._topk_dev_engine = eng
                except Exception:
                    self._engine = eng
                    return eng
            return eng
        # Cold standalone mode: engine scoped to this state.
        if self._engine is None:
            self._engine = _DeviceTopKEngine()
        return self._engine


def invalidate_engine(holder) -> None:
    """Drop the scheduler cache's resident key matrix, if it has one
    (with ``device_cache.drop_resident``: the next selection rebuilds
    every row from freshly uploaded node stacks)."""
    eng = getattr(holder, "_topk_dev_engine", None)
    if eng is not None:
        eng.invalidate()


def standalone_state(node_idle: np.ndarray, node_cap: np.ndarray,
                     node_task_count: np.ndarray,
                     node_max_tasks: np.ndarray, node_feas: np.ndarray,
                     group_rows: np.ndarray, device,
                     n_padded: Optional[int] = None,
                     ) -> SelectionDeviceState:
    """Build a :class:`SelectionDeviceState` from raw host arrays — cold
    tool mode: uploads the node stacks to ``device`` itself instead of
    reusing device-cache residency."""
    N = node_idle.shape[0]
    Np = int(n_padded) if n_padded else N

    def padn(a: np.ndarray, fill: int = 0) -> np.ndarray:
        if a.shape[0] == Np:
            return a
        out = np.full((Np,) + a.shape[1:], fill, dtype=a.dtype)
        out[:N] = a
        return out

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    node_f32 = put(np.stack([
        padn(np.ascontiguousarray(node_idle, np.float32)),
        np.zeros((Np,) + node_idle.shape[1:], np.float32),
        padn(np.ascontiguousarray(node_cap, np.float32)),
    ]))
    node_i32 = put(np.stack([
        padn(np.asarray(node_task_count, np.int32)),
        padn(np.asarray(node_max_tasks, np.int32)),
        padn(np.asarray(node_feas, bool)).astype(np.int32),
    ]))
    gf = np.zeros((group_rows.shape[0], Np), bool)
    gf[:, :N] = group_rows
    return SelectionDeviceState(None, node_f32, node_i32, put(gf), Np)


def _keys_placement(cp: int, dev):
    """The mesh whose shards hold the class-axis blocks of the key
    matrix: the session device's mesh when its size divides ``cp`` (the
    per-row work is independent along the class axis), else None (one
    block on ``dev``). A mesh across processes keeps one block here:
    selection is driven by each process's host."""
    from .sharding import default_mesh

    mesh = default_mesh(device=dev)
    if mesh is not None and mesh.world == 1 and cp % mesh.size == 0:
        return mesh
    return None


def select_rows(
    state: SelectionDeviceState,
    mask,                          # masks.CombinedMask (unpadded)
    rep_idx: np.ndarray,           # i64[C] representative task ids
    rep_req: np.ndarray,           # f32[C, R]
    rep_fit: np.ndarray,           # f32[C, R]
    rep_priv: np.ndarray,          # i64[C] private-row id or -1
    score_rows_map: Dict[int, np.ndarray],
    idle32: np.ndarray,            # f32[N, R] (unpadded, host)
    cap32: np.ndarray,
    eps32: np.ndarray,
    cap_ok0: np.ndarray,           # bool[N]
    lr_weight: float,
    br_weight: float,
    k: int,
    N: int,
    node_fp: Optional[tuple] = None,
) -> dict:
    """Run the device-resident selection for one cycle on the device of
    ``state``'s node stacks.

    Returns ``{"cand_idx", "elig_count", "any_feas", "cache_hits",
    "rows_rebuilt", "cols_patched"}`` (``cand_idx`` with the HOST
    sentinel ``N``)."""
    from .sharding import prospective_layout_token
    from .topk import _skey_priv_row

    C = len(rep_idx)
    Np = state.n_padded
    dev = state.node_f32.device
    eng = state.engine()
    cp = max(_pow2(C), 1)
    placement = _keys_placement(cp, dev)
    devs = placement.devices if placement is not None else (dev,)

    # The host selection cache's signature (with the solver's layout
    # token) plus the padded width.
    sig = (N, Np, int(k), rep_req.shape[1], eps32.tobytes(),
           float(lr_weight), float(br_weight),
           state.layout_token or prospective_layout_token())
    if (
        eng.sig != sig
        or eng.keys is None
        or eng.cp != cp
        or tuple(b.device for b in eng.keys) != devs
    ):
        eng.invalidate()
        eng.sig = sig
        eng.cp = cp
        eng.keys = [
            torch.full((cp // len(devs), Np), -1, dtype=torch.int32,
                       device=d)
            for d in devs
        ]
    cb = cp // len(eng.keys)          # class rows per block

    # Node-churn fingerprint -> changed column set (the decision
    # procedure of _SelectionCache's warm path).
    changed_cols = None
    if node_fp is not None:
        ids, vers, node_objs = node_fp
        if eng.node_ids is not None and len(eng.node_ids) == N:
            changed_cols = np.nonzero(
                (ids != eng.node_ids) | (vers != eng.node_vers)
            )[0]
        eng.node_objs = node_objs
        eng.node_ids = ids
        eng.node_vers = vers
    else:
        eng.node_objs = None
        eng.node_ids = None
        eng.node_vers = None
    if changed_cols is None:
        eng.row_digests = {}

    # Per-class content digests -> hit/miss (the host cache's keying,
    # with the row slot as the dict key since (ci, digest) pins ci).
    feas_all = mask.rows_for(rep_idx)                    # bool[C, N]
    any_feas = (feas_all & cap_ok0[None, :]).any(axis=1)
    misses = []
    priv_rows = []
    new_digests: Dict[int, bytes] = {}
    hits = 0
    for ci in range(C):
        p = int(rep_priv[ci])
        if p >= 0:
            priv_rows.append((ci, p))
            continue
        digest = hashlib.blake2b(
            feas_all[ci].tobytes()
            + rep_fit[ci].tobytes()
            + rep_req[ci].tobytes(),
            digest_size=16,
        ).digest()
        new_digests[ci] = digest
        if eng.row_digests.get(ci) == digest:
            hits += 1
        else:
            misses.append(ci)
    eng.row_digests = new_digests

    def put(a, d):
        return torch.from_numpy(np.ascontiguousarray(a)).to(d)

    group_full = np.zeros(cp, np.int64)
    group_full[:C] = mask.task_group[rep_idx]
    req_full = np.zeros((cp, rep_req.shape[1]), np.float32)
    req_full[:C] = rep_req
    fit_full = np.zeros((cp, rep_fit.shape[1]), np.float32)
    fit_full[:C] = rep_fit
    # Per block: its first class row and the node stacks on its device.
    blocks = [
        (blk, i * cb, (
            state.node_f32.to(blk.device), state.node_i32.to(blk.device),
            state.group_feas.to(blk.device), put(eps32, blk.device),
            lr_weight, br_weight,
        ))
        for i, blk in enumerate(eng.keys)
    ]

    # 1) churned-column patch across every resident row.
    cols_patched = 0
    if hits and changed_cols is not None and len(changed_cols):
        with _minted_lock:
            _minted_cols.add(_pow2(len(changed_cols)))
        for blk, r0, common in blocks:
            d = blk.device
            rows = slice(r0, r0 + cb)
            _patch_cols(
                blk, put(changed_cols.astype(np.int64), d),
                put(req_full[rows], d), put(fit_full[rows], d),
                torch.arange(r0, r0 + cb, dtype=torch.int64, device=d),
                put(group_full[rows], d), *common,
            )
        cols_patched = len(changed_cols)

    # 2) full rebuild of missed rows, chunked by the cell cap; each
    # block rebuilds the rows it holds.
    chunk = max(1, min(cp, _MISS_CHUNK_CELLS // max(Np, 1)))
    for m0 in range(0, len(misses), chunk):
        batch = np.asarray(misses[m0:m0 + chunk], np.int64)
        with _minted_lock:
            _minted_rows.add(_pow2(len(batch)))
        for blk, r0, common in blocks:
            sel = batch[(batch >= r0) & (batch < r0 + cb)]
            if not sel.size:
                continue
            d = blk.device
            _rebuild_rows(
                blk, put(sel - r0, d), put(req_full[sel], d),
                put(fit_full[sel], d), put(sel, d),
                put(group_full[sel], d), *common,
            )

    # 3) private rows: host-computed every cycle (their static score
    # addend is never cached — the host cache's rule) and written in.
    if priv_rows:
        vals = np.full((len(priv_rows), Np), -1, np.int32)
        for i, (ci, p) in enumerate(priv_rows):
            srow = np.asarray(score_rows_map.get(p, np.zeros(N)),
                              np.float32)
            vals[i, :N] = _skey_priv_row(
                rep_req[ci:ci + 1], rep_fit[ci:ci + 1], ci,
                idle32, cap32, eps32, cap_ok0,
                feas_all[ci:ci + 1], srow,
                lr_weight, br_weight,
            )
        prow = np.asarray([ci for ci, _ in priv_rows], np.int64)
        for blk, r0, _ in blocks:
            sel = np.nonzero((prow >= r0) & (prow < r0 + cb))[0]
            if sel.size:
                blk.index_copy_(
                    0, put(prow[sel] - r0, blk.device),
                    put(vals[sel], blk.device),
                )

    # 4) top-K extraction and the eligibility gauge, per block (rows are
    # independent), concatenated in row order.
    kk = min(int(k), Np)
    with _minted_lock:
        _minted_topk.add((kk, N))
    tops = [_topk_rows(blk, kk, N) for blk, _, _ in blocks]
    cand_dev = torch.cat([c.cpu() for c, _ in tops])
    count_dev = torch.cat([n.cpu() for _, n in tops])
    cand = np.full((C, int(k)), N, np.int32)
    cand[:, :kk] = cand_dev[:C].numpy()
    elig_count = count_dev[:C].numpy()

    return {
        "cand_idx": cand,
        "elig_count": elig_count,
        "any_feas": any_feas,
        "cache_hits": hits,
        "rows_rebuilt": len(misses),
        "cols_patched": cols_patched,
    }
