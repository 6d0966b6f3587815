"""A numpy model of csrc/dc_assign.cu (kernel 10, D&C phase 2's cluster
assignment). Used by the tests and chip_smoke.py, never by a build:
change it together with the kernel.

What it models, as the kernel does it:
- the plan (`kernel_plan`): R rows a block, staged in shared memory where
  R rows fit 96 KB (R = 8, 4, 2) or one row fits 225 KB, else 8 rows a
  block read from device memory;
- the tiles of rows: block b owns rows bR .. bR + R - 1, the last block
  ragged;
- the tiles of slots: thread t of a block walks slots t, t + threads, ...
  (the last tile ragged where E is not a multiple of the threads), and
  keeps a candidate (score, slot) a row over its valid slots and its
  first invalid slot, which stands for all of its invalid slots (they all
  score SENT_DIS);
- the partial minima: each thread's candidates, then each warp's, then
  the block's, in the order of torch.argmin (NaN first, the lower slot at
  equal scores); the block's is the row's slot.

The score of a row and valid slot is edge_score.cuh's, operation by
operation in the state's type (numpy rounds each operation, as the
kernel's round-to-nearest intrinsics do).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

THREADS = 256
WARP = 32
STAGED_BYTES = 96 * 1024
STAGED_ONE_ROW = 225 * 1024
GLOBAL_ROWS = 8
SENT_DIS = 2.0
NO_SLOT = 2**31 - 1


class Plan(NamedTuple):
    rows: int       # rows a block
    staged: bool    # rows in shared memory (else read from device memory)
    threads: int    # threads a block
    smem: int       # dynamic shared memory bytes a block


def kernel_plan(width: int, item: int) -> Plan:
    """dc_assign.cu's make_plan for rows of `width` elements of `item`
    bytes."""
    row_bytes = width * item
    for r in (8, 4, 2):
        if r * row_bytes <= STAGED_BYTES:
            return Plan(r, True, THREADS, r * row_bytes)
    if row_bytes <= STAGED_ONE_ROW:
        return Plan(1, True, THREADS, row_bytes)
    return Plan(GLOBAL_ROWS, False, THREADS, 0)


def _clamp0(v):
    return np.where(v != v, v, np.where(v > 0, v, v.dtype.type(0)))


def _side(cid, cdis, rows):
    """side_vals over the rows [n, W]: [n, E] (NaN where a difference is
    NaN; 0 for an edge with no witness)."""
    x = rows[:, np.maximum(cid, 0)] - cdis                # [n, E, K]
    used = (cid != -1)[None]
    has_nan = (np.isnan(x) & used).any(axis=-1)
    best = np.where(used, x, -np.inf).max(axis=-1)
    return np.where(has_nan, np.nan, _clamp0(best)).astype(rows.dtype)


def edge_scores(arrays: dict, rows: np.ndarray) -> np.ndarray:
    """[n, E] scores of every slot for the rows [n, W] (edge_score on the
    valid slots, SENT_DIS on the others)."""
    dt = rows.dtype.type
    cid, cdis, rev = arrays["cid"], arrays["cdis"], arrays["rev"]
    valid = arrays["belong"] > arrays["e"]
    with np.errstate(invalid="ignore", over="ignore"):
        side = _side(cid, cdis, rows)
        dis1 = side
        dis2 = side[:, np.maximum(rev, 0)]
        L = arrays["length"][None]
        addi = _clamp0((dis1 + dis2 - L) * dt(0.5))
        d1 = _clamp0(dis1 - addi)
        d2 = _clamp0(dis2 - addi)
        addi = (addi + _clamp0(d1 - L)) + _clamp0(d2 - L)
    return np.where(valid[None], addi, dt(SENT_DIS))


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


def assign(arrays: dict, rows: np.ndarray,
           plan: Plan | None = None) -> np.ndarray:
    """What dc_assign computes, its way: int64 [Q], the chosen slot of
    each row of `rows` [Q, W] (any row stride) on the state `arrays`
    (numpy, the reference's field names: e, belong, length, rev, cdis,
    cid). `plan` defaults to kernel_plan's."""
    Q, W = rows.shape
    dt = rows.dtype
    plan = plan or kernel_plan(W, dt.itemsize)
    R, T = plan.rows, plan.threads
    E = arrays["e"].shape[0]
    valid = arrays["belong"] > arrays["e"]
    tiles = -(-E // T)
    pad = tiles * T - E
    # slot (tile i, thread t) = i T + t; the ragged last tile's missing
    # slots carry no candidate
    slot = np.arange(tiles * T, dtype=np.int64).reshape(tiles, T)
    is_valid = np.concatenate([valid, np.zeros(pad, bool)]).reshape(tiles, T)
    is_invalid = np.concatenate([~valid, np.zeros(pad, bool)]).reshape(
        tiles, T)
    # each thread's first invalid slot (NO_SLOT if it has none)
    first_invalid = np.where(is_invalid, slot, NO_SLOT).min(axis=0)   # [T]
    out = np.empty(Q, dtype=np.int64)
    for r0 in range(0, Q, R):
        mine = np.ascontiguousarray(rows[r0:r0 + R])    # staged or read
        n = mine.shape[0]
        score = np.concatenate([edge_scores(arrays, mine),
                                np.full((n, pad), np.inf, dt)], axis=1)
        score = score.reshape(n, tiles, T)
        # each thread's best valid slot a row, over its tiles in order
        s = np.where(is_valid[None], score, np.inf).astype(dt)
        sl = np.broadcast_to(np.where(is_valid, slot, NO_SLOT), s.shape)
        ts, tsl = lex_min(s, sl, axis=1)                         # [n, T]
        # the thread's first invalid slot stands for its invalid slots
        inv = np.broadcast_to(first_invalid, ts.shape)
        ts, tsl = lex_min(
            np.stack([ts, np.where(inv < NO_SLOT, dt.type(SENT_DIS),
                                   np.inf).astype(dt)], axis=-1),
            np.stack([tsl, inv], axis=-1), axis=-1)
        # the warps' minima, then the block's
        ws, wsl = lex_min(ts.reshape(n, T // WARP, WARP),
                          tsl.reshape(n, T // WARP, WARP), axis=2)
        _, bsl = lex_min(ws, wsl, axis=1)
        out[r0:r0 + n] = bsl
    return out
