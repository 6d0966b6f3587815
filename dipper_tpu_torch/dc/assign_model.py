"""A numpy model of csrc/dc_assign.cu (kernel 10, D&C phase 2's cluster
assignment, and its pack). Used by the tests and chip_smoke.py, never by a
build: change it together with the kernel.

What it models, as the kernels do it:
- the pack (`pack`): the valid slots (belong > e) in ascending slot order,
  each one record of `record_layout`'s bytes (the slot's and its reverse
  slot's five witness ids, uint16 with 0xFFFF for an empty entry where the
  row width is at most 65,535, else int32 with -1; the slot; its length;
  the ten distances; zeros to a multiple of 16 bytes), and the lowest
  invalid slot (NO_SLOT if none), which stands for every invalid slot
  (they all score SENT_DIS);
- the plan (`kernel_plan`): R = 8, 4 or 2 rows a block of 16 consumer
  warps, transposed in shared memory, the largest R whose two row buffers
  and PLAN_STAGES tiles fit 227 KB; else one row a block of 31 consumer
  warps, two buffers where they fit so, else one with at least
  MIN_STAGES; the ring then RING_ROW_BYTES / (R x item) stages as fit, up
  to MAX_STAGES; else GLOBAL_ROWS rows a block read from device memory, a
  ring of GLOBAL_STAGES; blocks in clusters of CLUSTER_CTAS (or 1,
  forced), each with one producer warp more;
- the tiles of records: TILE_RECORDS a tile, each tile's slices of 32
  records taken by the consumer warps (in the kernel, in order from a
  counter, so which warp takes which slice varies from run to run; the
  model takes them round robin or in a given `order`), a record a lane;
  each lane keeps a candidate a row over its records (in the kernel
  (key, slot), the key the score or -1 for NaN: scores are >= 0
  otherwise, so the two orders agree);
- the partial minima: each lane's candidates, then each warp's, then the
  block's, in the order of torch.argmin (NaN first, the lower slot at
  equal scores); with the lowest invalid slot's candidate, the row's slot.

The score of a row and record is edge_score.cuh's, operation by operation
in the state's type (numpy rounds each operation, as the kernel's
round-to-nearest intrinsics do); a side is the maximum of the used
entries' differences with NaN sticking, clamped at 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

K = 5
WARP = 32
CONSUMER_WARPS = 16
ONE_ROW_WARPS = 31
TILE_RECORDS = 64
SLICE_RECORDS = 32
PLAN_STAGES = 8
RING_ROW_BYTES = 128
GLOBAL_STAGES = 4
MAX_STAGES = 16
MIN_STAGES = 2
CLUSTER_CTAS = 2
SMEM_BYTES = 227 * 1024
BARRIER_BYTES = 512
GLOBAL_ROWS = 2
MAX_ID16_WIDTH = 65535
PACK_THREADS = 256
PACK_SLOTS = 4
PACK_TILE = PACK_THREADS * PACK_SLOTS    # slots a pack block takes
SENT_DIS = 2.0
NO_SLOT = 2**31 - 1


class Plan(NamedTuple):
    rows: int           # rows a block
    staged: bool        # rows in shared memory (else read from device memory)
    buffers: int        # row buffers (0: read from device memory)
    threads: int        # threads a block, the producer warp's included
    tile: int           # records a tile (one bulk copy)
    stages: int         # tiles of the ring
    cluster: int        # blocks a cluster
    smem: int           # dynamic shared memory bytes a block
    record_bytes: int
    id_bytes: int


class Layout(NamedTuple):
    slot: int           # byte offsets in a record
    length: int
    dist: int
    bytes: int


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def id_bytes_of(width: int) -> int:
    return 2 if width <= MAX_ID16_WIDTH else 4


def record_layout(id_bytes: int, item: int) -> Layout:
    """dc_assign.cu's record: the 2K ids from byte 0, the slot (int32),
    the length, the 2K distances, zeros to a multiple of 16 bytes."""
    slot = 2 * K * id_bytes
    length = _align(slot + 4, item)
    dist = length + item
    return Layout(slot, length, dist, _align(dist + 2 * K * item, 16))


def _head(warps: int, rows: int, item: int) -> int:
    return _align(BARRIER_BYTES + warps * rows * (item + 4), 128)


def _stages(room: int, stage: int, most: int, stages: int | None) -> int:
    n = min(most, max(room, 0) // stage)
    return n if stages is None else min(n, stages)


def pack_work_words(n_edges: int) -> int:
    """int64 words of dc_assign_pack's workspace: a status word a tile of
    PACK_TILE slots, then two words of counters."""
    return -(-n_edges // PACK_TILE) + 2


def _staged(R: int, width: int, item: int, cluster: int,
            stages: int | None) -> Plan | None:
    warps = ONE_ROW_WARPS if R == 1 else CONSUMER_WARPS
    idb = id_bytes_of(width)
    rec = record_layout(idb, item).bytes
    head, stage, row = _head(warps, R, item), TILE_RECORDS * rec, R * width * item
    least = PLAN_STAGES if stages is None else stages
    buffers = 2
    if head + least * stage + 2 * row > SMEM_BYTES:
        if R != 1:
            return None
        buffers = 1
    most = (MAX_STAGES if stages is not None
            else min(MAX_STAGES, RING_ROW_BYTES // (R * item)))
    n = _stages(SMEM_BYTES - head - buffers * row, stage, most, stages)
    if n < MIN_STAGES or (stages is not None and n != stages):
        return None
    return Plan(R, True, buffers, (warps + 1) * WARP, TILE_RECORDS, n,
                cluster, head + n * stage + buffers * row, rec, idb)


def _global(width: int, item: int, cluster: int,
            stages: int | None) -> Plan | None:
    idb = id_bytes_of(width)
    rec = record_layout(idb, item).bytes
    head, stage = _head(CONSUMER_WARPS, GLOBAL_ROWS, item), TILE_RECORDS * rec
    most = GLOBAL_STAGES if stages is None else MAX_STAGES
    n = _stages(SMEM_BYTES - head, stage, most, stages)
    if n < MIN_STAGES or (stages is not None and n != stages):
        return None
    return Plan(GLOBAL_ROWS, False, 0, (CONSUMER_WARPS + 1) * WARP,
                TILE_RECORDS, n, cluster, head + n * stage, rec, idb)


def kernel_plan(width: int, item: int, rows: int | None = None,
                staged: bool | None = None, cluster: int | None = None,
                stages: int | None = None) -> Plan:
    """dc_assign.cu's plan_for for rows of `width` elements of `item`
    bytes, with its overrides (None: the plan's): rows a block (1, 2, 4 or
    8 staged, GLOBAL_ROWS read from device memory), blocks a cluster (1 or
    CLUSTER_CTAS) and the ring's stages (MIN_STAGES to MAX_STAGES). Raises
    ValueError for an instance that the kernel refuses (none such, or it
    does not fit)."""
    cluster = CLUSTER_CTAS if cluster is None else cluster
    if cluster not in (1, CLUSTER_CTAS):
        raise ValueError(f"no cluster of {cluster} blocks")
    if stages is not None and not MIN_STAGES <= stages <= MAX_STAGES:
        raise ValueError(f"no ring of {stages} stages")
    plan = None
    if staged is False:
        if rows not in (None, GLOBAL_ROWS):
            raise ValueError(f"rows read from device memory are "
                             f"{GLOBAL_ROWS} a block, not {rows}")
        plan = _global(width, item, cluster, stages)
    elif rows is not None:
        if rows not in (1, 2, 4, 8):
            raise ValueError(f"no instance of {rows} staged rows a block")
        plan = _staged(rows, width, item, cluster, stages)
    else:
        for r in (8, 4, 2, 1):
            plan = _staged(r, width, item, cluster, stages)
            if plan is not None:
                break
        if plan is None and staged is None:
            plan = _global(width, item, cluster, stages)
    if plan is None:
        raise ValueError(f"no such instance fits rows of {width} x {item} "
                         f"bytes (rows {rows}, staged {staged}, stages "
                         f"{stages})")
    return plan


def pack(arrays: dict, width: int) -> tuple:
    """What dc_assign_pack writes for the state `arrays` (numpy, the
    reference's field names) and rows of `width`: (records uint8 [n,
    record bytes], the valid slots' records in slot order; the lowest
    invalid slot, NO_SLOT if none)."""
    valid = arrays["belong"] > arrays["e"]
    dt = arrays["length"].dtype
    idb = id_bytes_of(width)
    lay = record_layout(idb, dt.itemsize)
    s = np.flatnonzero(valid)
    r = arrays["rev"][s]
    ids = np.concatenate([arrays["cid"][s], arrays["cid"][r]], axis=1)
    dis = np.concatenate([arrays["cdis"][s], arrays["cdis"][r]], axis=1)
    n = s.size
    rec = np.zeros((n, lay.bytes), np.uint8)
    if idb == 2:
        code = np.where(ids < 0, 0xFFFF, ids).astype("<u2")
    else:
        code = ids.astype("<i4")
    rec[:, :lay.slot] = code.view(np.uint8).reshape(n, lay.slot)
    rec[:, lay.slot:lay.slot + 4] = s.astype("<i4")[:, None].view(np.uint8)
    item = dt.itemsize
    rec[:, lay.length:lay.length + item] = np.ascontiguousarray(
        arrays["length"][s].astype(dt.newbyteorder("<"))[:, None]).view(
            np.uint8)
    rec[:, lay.dist:lay.dist + 2 * K * item] = np.ascontiguousarray(
        dis.astype(dt.newbyteorder("<"))).view(np.uint8).reshape(
            n, 2 * K * item)
    invalid = np.flatnonzero(~valid)
    return rec, int(invalid[0]) if invalid.size else NO_SLOT


def unpack(records: np.ndarray, id_bytes: int, dtype) -> dict:
    """The fields of records [n, record bytes]: ids [n, 2K] (-1 empty),
    dist [n, 2K], length [n], slot [n]."""
    dt = np.dtype(dtype)
    lay = record_layout(id_bytes, dt.itemsize)
    n = records.shape[0]
    raw = np.ascontiguousarray(records)
    if id_bytes == 2:
        ids = raw[:, :lay.slot].copy().view("<u2").astype(np.int64)
        ids[ids == 0xFFFF] = -1
    else:
        ids = raw[:, :lay.slot].copy().view("<i4").astype(np.int64)
    item = dt.itemsize
    le = dt.newbyteorder("<")
    return {"ids": ids.reshape(n, 2 * K),
            "slot": raw[:, lay.slot:lay.slot + 4].copy().view("<i4")[:, 0]
            .astype(np.int64),
            "length": raw[:, lay.length:lay.length + item].copy().view(le)
            [:, 0].astype(dt),
            "dist": raw[:, lay.dist:lay.dist + 2 * K * item].copy().view(le)
            .astype(dt).reshape(n, 2 * K)}


def _clamp0(v):
    return np.where(v != v, v, np.where(v > 0, v, v.dtype.type(0)))


def record_scores(rec: dict, rows: np.ndarray) -> np.ndarray:
    """[n_rows, n_records] scores of the unpacked records for the rows
    [n_rows, W], as score_record computes them."""
    dt = rows.dtype.type
    ids = rec["ids"]
    with np.errstate(invalid="ignore", over="ignore"):
        x = rows[:, np.maximum(ids, 0)] - rec["dist"][None]   # [n, m, 2K]
        x = np.where((ids >= 0)[None], x, dt(-np.inf))
        # np.max keeps a NaN as the kernel's sticking maximum does
        dis1 = _clamp0(x[..., :K].max(axis=-1))
        dis2 = _clamp0(x[..., K:].max(axis=-1))
        L = rec["length"][None]
        addi = _clamp0((dis1 + dis2 - L) * dt(0.5))
        d1 = _clamp0(dis1 - addi)
        d2 = _clamp0(dis2 - addi)
        addi = (addi + _clamp0(d1 - L)) + _clamp0(d2 - L)
    return addi.astype(rows.dtype)


def lex_min(score: np.ndarray, slot: np.ndarray, axis: int):
    """The minimum along `axis` of candidates (score, slot) in the order
    of torch.argmin: a NaN score first, then the lower score, the lower
    slot at equal scores (and among NaNs)."""
    nan = np.isnan(score)
    has_nan = nan.any(axis=axis, keepdims=True)
    low = np.where(nan, np.inf, score).min(axis=axis, keepdims=True)
    at = np.where(has_nan, nan, ~nan & (score == low))
    best_slot = np.where(at, slot, NO_SLOT).min(axis=axis, keepdims=True)
    best_score = np.where(has_nan, np.nan, low).astype(score.dtype)
    return best_score.squeeze(axis), best_slot.squeeze(axis)


def assign_records(records: np.ndarray, first_invalid: int, rows: np.ndarray,
                   plan: Plan | None = None, order=None) -> np.ndarray:
    """What dc_assign computes from packed records, its way: int64 [Q],
    the chosen slot of each row of `rows` [Q, W] (any row stride).
    `order`, if given, names the consumer warp that takes each slice of
    the records (the kernel's run-time order); by default slice q is warp
    q mod warps's."""
    Q, W = rows.shape
    dt = rows.dtype
    plan = plan or kernel_plan(W, dt.itemsize)
    assert plan.id_bytes == id_bytes_of(W)
    assert plan.tile % SLICE_RECORDS == 0
    R, warps = plan.rows, plan.threads // WARP - 1
    rec = unpack(records, plan.id_bytes, dt)
    m = records.shape[0]
    slices = -(-m // plan.tile) * (plan.tile // SLICE_RECORDS)
    pad = slices * SLICE_RECORDS - m
    warp_of = (np.arange(slices) % warps if order is None
               else np.asarray(order)[:slices])
    slot = np.concatenate([rec["slot"], np.full(pad, NO_SLOT)]).reshape(
        slices, SLICE_RECORDS)
    out = np.empty(Q, dtype=np.int64)
    # row groups: block (cluster c, rank k) takes groups (c + rd n) C + k in
    # its rounds rd; each group's answer is its block's alone
    for r0 in range(0, Q, R):
        mine = np.ascontiguousarray(rows[r0:r0 + R])    # staged or read
        n = mine.shape[0]
        score = np.concatenate([record_scores(rec, mine),
                                np.full((n, pad), np.inf, dt)], axis=1)
        score = score.reshape(n, slices, SLICE_RECORDS)
        # each lane's candidate over its slices, each warp's over its lanes
        ws = np.full((n, warps), np.inf, dt)
        wsl = np.full((n, warps), NO_SLOT, np.int64)
        for w in range(warps):
            take = warp_of == w
            if not take.any():
                continue
            ls, lsl = lex_min(score[:, take],
                              np.broadcast_to(slot[take], score[:, take]
                                              .shape), axis=1)    # [n, 32]
            ws[:, w], wsl[:, w] = lex_min(ls, lsl, axis=1)
        bs, bsl = lex_min(ws, wsl, axis=1)
        if first_invalid != NO_SLOT:
            bs, bsl = lex_min(
                np.stack([bs, np.full(n, SENT_DIS, dt)], axis=-1),
                np.stack([bsl, np.full(n, first_invalid)], axis=-1), axis=-1)
        out[r0:r0 + n] = bsl
    return out


def assign(arrays: dict, rows: np.ndarray, plan: Plan | None = None,
           order=None) -> np.ndarray:
    """dc_assign_pack then dc_assign on the state `arrays` (numpy, the
    reference's field names: e, belong, length, rev, cdis, cid) and the
    rows [Q, W]: int64 [Q]. `plan` defaults to kernel_plan's."""
    records, first_invalid = pack(arrays, rows.shape[1])
    return assign_records(records, first_invalid, rows, plan, order)
