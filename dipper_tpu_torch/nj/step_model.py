"""A numpy model of the schedule of NJ's two merge-step kernels
(csrc/nj_q_argmin.cu, csrc/nj_update.cu), held to the plain version
(nj/engine.py::_argmin_plain, _update_plain) on the CPU by
tests/test_torch_nj.py. Change it together with the kernels.

- q_argmin: the tiles of q_plan (kTile columns, one 16-byte load a lane,
  and kTile >> shift rows; the model also takes other heights), in the
  half read the upper triangle's tiles band by band and in the full read
  every tile of the rows scanned; a persistent grid whose block b
  walks the tiles b, b + grid, ...; in a tile each thread's running first
  minima with the kernel's strict compare (from +inf with no index: a
  NaN replaces a number and never another NaN, +inf never enters), one
  over Q[i, j] and, in the half read, one a column over the mirrored
  Q[j, i], merged at the tile's end with `before`; the block's candidates
  reduced in the warp-shuffle tree of nj_step.cuh::block_min, the
  partials in the last block's order.
- update: thread j of a block owns column j (not x or y) and reads,
  then writes, its own elements; blocks and threads run in any order the
  caller gives, one after the other, so an element that one thread read
  and another wrote would show as a difference from the plain step. Each
  block reads the join's scalars before its columns (the model checks
  that every block reads the same), thread `last` leaves newrow[last]
  and U[last] in the slot; then the last block: U[x] summed as the
  kernel sums it, columns x and y, the join and the log row, from the
  scalars its thread 0 read and the slot.

ModelStepper has nj_cuda.Stepper's interface, so that a CPU run can put
the model in the kernels' place and drive the card's route.
"""

from __future__ import annotations

import numpy as np
import torch

THREADS = 256          # nj_step.cuh::kThreads
WARP = 32
MAX_PARTIALS = 2048    # nj_q_argmin.cu::kMaxPartials
NO_ROWS = 1 << 62      # the index of an empty share's pair
SMALL_SUM = 128        # nj_update.cu::kSmallSum (engine._MIN_BUCKET)
XLA_BLOCK = 32
# the grid of the card the tests model: 132 SMs x 4 resident blocks
RESIDENT = 132 * 4
MAX_SHIFT = 3          # nj_q_argmin.cu::kMaxShift

_EMPTY = (0.0, -1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wide(itemsize: int) -> int:
    """Elements of one 16-byte load (nj_q_argmin.cu::Wide<T>::kN)."""
    return 16 // itemsize


def band_start(b: int, chunks: int, shift: int) -> int:
    """The first tile of band b in the half read of tiles with tile_cols
    >> shift rows (nj_q_argmin.cu::band_start): band b' holds the chunks
    from b' >> shift to chunks - 1."""
    m, q, r = 1 << shift, b >> shift, b & ((1 << shift) - 1)
    return b * chunks - (m * q * (q - 1) // 2 + r * q)


def q_plan(n: int, rows: int, half: bool, itemsize: int, *,
           resident: int = RESIDENT, lanes: int = WARP,
           tile_rows: int | None = None) -> dict:
    """The tiles and grid of a launch over `rows` rows (the half read:
    all n) of the active [n, n] block (nj_q_argmin.cu::make_plan: tiles
    of tile_cols >> shift rows, shift the least in 0..MAX_SHIFT that
    gives at least `resident` tiles; `tile_rows` overrides it): the band
    starts, the first chunk of each band, tiles, grid."""
    tile_cols = lanes * wide(itemsize)
    chunks = _cdiv(n, tile_cols)
    for shift in range(MAX_SHIFT + 1):
        tr = max(1, tile_cols >> shift) if tile_rows is None else tile_rows
        if half:
            bands = _cdiv(n, tr)
            first = [(b * tr) // tile_cols for b in range(bands)]
        else:
            bands = _cdiv(rows, tr)
            first = [0] * bands
        starts = np.concatenate([[0], np.cumsum(
            [chunks - f for f in first], dtype=np.int64)]).astype(np.int64)
        tiles = int(starts[-1])
        if tiles >= resident or tile_rows is not None:
            break
    grid = max(1, min(resident, MAX_PARTIALS, tiles))
    return {"tile_cols": tile_cols, "tile_rows": tr, "shift": shift,
            "chunks": chunks, "bands": bands, "first": first,
            "starts": starts, "tiles": tiles, "grid": grid}


def locate(t: int, plan: dict) -> tuple[int, int]:
    """(band, chunk) of tile t (nj_q_argmin.cu::locate)."""
    band = int(np.searchsorted(plan["starts"], t, side="right")) - 1
    return band, plan["first"][band] + t - int(plan["starts"][band])


def before(a: tuple, b: tuple) -> bool:
    """Candidate a (value, flat index) before b in torch.argmin's order;
    index -1 is no candidate (nj_step.cuh::before)."""
    if b[1] < 0:
        return a[1] >= 0
    if a[1] < 0:
        return False
    an, bn = a[0] != a[0], b[0] != b[0]
    if an != bn:
        return an
    if an or a[0] == b[0]:
        return a[1] < b[1]
    return a[0] < b[0]


def _before_v(av, ai, bv, bi) -> np.ndarray:
    """`before` over arrays of candidates."""
    an, bn = np.isnan(av), np.isnan(bv)
    with np.errstate(invalid="ignore"):
        by_value = np.where(an | (av == bv), ai < bi, av < bv)
    inner = np.where(an != bn, an, by_value)
    return np.where(bi < 0, ai >= 0, np.where(ai < 0, False, inner))


def _merge_v(best, cand) -> tuple:
    """Each thread's candidate replaced where the new one comes before."""
    take = _before_v(cand[0], cand[1], best[0], best[1])
    return (np.where(take, cand[0], best[0]),
            np.where(take, cand[1], best[1]))


def _running_first(v: np.ndarray, idx: np.ndarray, ok: np.ndarray) -> tuple:
    """The kernel's running first minimum of each stream (rows of v, in
    visit order along axis 1) from +inf with no index, taking q where
    !(q >= held) and held is not NaN: the first NaN, else the first of
    the least values below +inf, else none (index -1). Elements not `ok`
    are not candidates."""
    v = np.where(ok, v, np.inf)
    nan = np.isnan(v) & ok
    has_nan = nan.any(axis=1)
    vv = np.where(nan, np.inf, v)
    m = vv.min(axis=1, initial=np.inf)
    first = np.argmax(vv == m[:, None], axis=1)
    pos = np.where(has_nan, np.argmax(nan, axis=1), first)
    rows = np.arange(v.shape[0])
    found = has_nan | (m < np.inf)
    return (np.where(found, v[rows, pos], 0.0).astype(v.dtype),
            np.where(found, idx[rows, pos], -1))


def _warp_min_v(cv, ci) -> tuple:
    """Lane 0's candidate of each warp after the shuffle-down tree: cv,
    ci [..., 32] (a lane past the end reads its own value)."""
    off = WARP // 2
    while off:
        ov = np.concatenate([cv[..., off:], cv[..., WARP - off:]], axis=-1)
        oi = np.concatenate([ci[..., off:], ci[..., WARP - off:]], axis=-1)
        lanes = np.arange(WARP) + off < WARP
        take = lanes & _before_v(ov, oi, cv, ci)
        cv, ci = np.where(take, ov, cv), np.where(take, oi, ci)
        off //= 2
    return cv[..., 0], ci[..., 0]


def _pad_to(v, i, width: int) -> tuple:
    """Candidates [..., L] padded with no candidates to [..., width]."""
    pad = [(0, 0)] * (v.ndim - 1) + [(0, width - v.shape[-1])]
    return np.pad(v, pad), np.pad(i, pad, constant_values=-1)


def _block_min_v(cv, ci) -> tuple:
    """nj_step.cuh::block_min over one candidate a thread: cv, ci
    [..., threads] (arrays of blocks)."""
    w = _cdiv(cv.shape[-1], WARP)
    cv, ci = _pad_to(cv, ci, w * WARP)
    wv, wi = _warp_min_v(cv.reshape(*cv.shape[:-1], w, WARP),
                         ci.reshape(*ci.shape[:-1], w, WARP))
    return _warp_min_v(*_pad_to(wv, wi, WARP))


def block_min(cands: list) -> tuple:
    """nj_step.cuh::block_min over one candidate a thread."""
    v, i = _block_min_v(np.array([c[0] for c in cands]),
                        np.array([c[1] for c in cands], dtype=np.int64))
    return (v[()], int(i))


def _min_v(v, i, axis: int) -> tuple:
    """The first candidate in `before`'s order along `axis` (a total order
    on real candidates, so the order in which the kernel merges them does
    not change the result)."""
    v, i = np.moveaxis(v, axis, -1), np.moveaxis(i, axis, -1)
    while v.shape[-1] > 1:
        if v.shape[-1] % 2:
            v = np.concatenate([v, np.zeros(v.shape[:-1] + (1,), v.dtype)],
                               axis=-1)
            i = np.concatenate([i, -np.ones(i.shape[:-1] + (1,), i.dtype)],
                               axis=-1)
        a = (v[..., 0::2], i[..., 0::2])
        v, i = _merge_v(a, (v[..., 1::2], i[..., 1::2]))
    return v[..., 0], i[..., 0]


def _scan_tiles(D, un, big, n, i0, i1, c0, lanes, warps, V, half) -> tuple:
    """Every thread's candidate of each tile (rows i0[t]..i1[t]-1,
    columns c0[t] + lane * V + k; arrays over the tiles t):
    nj_q_argmin.cu::scan's running first minima, one over Q[i, j] in the
    thread's order of visits (its rows, then its columns) and in the half
    read one a column over Q[j, i], merged. Returns [tiles, threads]
    values and flat indices, thread = warp * lanes + lane."""
    dt = D.dtype.type
    T = len(i0)
    per = _cdiv(int(np.max(i1 - i0)), warps)    # rows a warp visits
    rows = (i0[:, None, None] + np.arange(per)[None, :, None] * warps
            + np.arange(warps)[None, None, :])   # [T, per, warps]
    cols = c0[:, None] + np.arange(lanes * V)[None, :]   # [T, lanes * V]
    R, C = rows[..., None], cols[:, None, None, :]
    ok = (R < i1[:, None, None, None]) & (C < n)
    if half:
        ok = ok & (C >= R)
    diag = C == R
    r, c = np.minimum(R, n - 1), np.minimum(C, n - 1)
    v = D[r, c]
    uni, unj = un[r], un[c]
    with np.errstate(invalid="ignore", over="ignore"):
        q_up = np.where(diag, big, (v - uni) - unj).astype(dt)
        q_mi = ((v - unj) - uni).astype(dt)
    flat_up = R.astype(np.int64) * n + C
    flat_mi = C.astype(np.int64) * n + R

    def streams(a):
        # [T, per, warps, lanes * V] -> [T, thread (w, l), its elements in
        # visit order: its rows, then its V columns]
        a = np.broadcast_to(a, ok.shape).reshape(T, per, warps, lanes, V)
        return a.transpose(0, 2, 3, 1, 4).reshape(T * warps * lanes, per * V)

    bv, bi = _running_first(streams(q_up), streams(flat_up), streams(ok))
    cands_v, cands_i = [bv], [bi]
    if half:
        ok_mi = ok & ~diag

        def column(a, k):
            # thread (w, l)'s column c0 + l * V + k over its rows
            a = np.broadcast_to(a, ok.shape).reshape(T, per, warps, lanes, V)
            return a[..., k].transpose(0, 2, 3, 1).reshape(
                T * warps * lanes, per)

        for k in range(V):
            mv, mi = _running_first(column(q_mi, k), column(flat_mi, k),
                                    column(ok_mi, k))
            cands_v.append(mv)
            cands_i.append(mi)
    v, i = _min_v(np.stack(cands_v, -1), np.stack(cands_i, -1), -1)
    return v.reshape(T, warps * lanes), i.reshape(T, warps * lanes)


def q_argmin(D: np.ndarray, U: np.ndarray, n: int, r0: int, r1: int, *,
             half: bool = False, threads: int = THREADS,
             grid: int = RESIDENT, tile_rows: int | None = None) -> tuple:
    """nj_q_argmin's (flat, value) over rows [r0, r1) (the half read: all
    n rows) of the active [n, n] block of D (numpy, any leading
    dimension) with row sums U, on a grid of `grid` resident blocks.
    `threads` < 32 is one warp of that many lanes."""
    if half and (r0, r1) != (0, n):
        raise ValueError("the half read scans every row")
    dt = D.dtype.type
    big = np.finfo(D.dtype).max
    un = (U[:n] / dt(n - 2)).astype(D.dtype)
    lanes = min(threads, WARP)
    warps = threads // lanes
    V = wide(D.dtype.itemsize)
    plan = q_plan(n, r1 - r0, half, D.dtype.itemsize, resident=grid,
                  lanes=lanes, tile_rows=tile_rows)
    tr, tc, G = plan["tile_rows"], plan["tile_cols"], plan["grid"]
    # block b's candidate a thread: its tiles b, b + G, ..., merged
    partials = [_EMPTY] * G
    if plan["tiles"]:
        where = np.array([locate(t, plan) for t in range(plan["tiles"])])
        i0 = r0 + where[:, 0] * tr
        v, i = _scan_tiles(D, un, big, n, i0, np.minimum(r1, i0 + tr),
                           where[:, 1] * tc, lanes, warps, V, half)
        # tile t = b + m * G at [m, b]
        rounds = _cdiv(plan["tiles"], G)
        v, i = _pad_to(v.T, i.T, rounds * G)
        v = v.reshape(threads, rounds, G)
        i = i.reshape(threads, rounds, G)
        bv, bi = _block_min_v(*(a.T for a in _min_v(v, i, 1)))
        partials = list(zip(bv, bi.tolist()))
    # the last block: partial p is thread p % threads's, in order
    held = [_EMPTY] * threads
    for p, c in enumerate(partials):
        if before(c, held[p % threads]):
            held[p % threads] = c
    best = block_min(held)
    if best[1] < 0:
        return NO_ROWS, float("inf")
    return best[1], best[0]


def _tree_sum(vals: list) -> float:
    """nj_step.cuh::block_sum: the lanes' shuffle-down tree, then the
    warps' sums in warp order (doubles)."""
    sums = []
    for w in range(0, len(vals), WARP):
        c = list(vals[w:w + WARP]) + [0.0] * (WARP - len(vals[w:w + WARP]))
        off = WARP // 2
        while off:
            c = [c[l] + c[l + off] if l + off < WARP else c[l]
                 for l in range(WARP)]
            off //= 2
        sums.append(c[0])
    s = sums[0]
    for v in sums[1:]:
        s = s + v
    return s


def _clamp0(v):
    """torch.clamp(v, min=0) on the CPU: NaN and -0.0 stay."""
    return v if v != v or not v < 0 else type(v)(0)


def update(D: np.ndarray, U: np.ndarray, real: np.ndarray, flat: int,
           n: int, new_id: int, *, threads: int = THREADS,
           order=None) -> tuple:
    """nj_update's writes into D, U and real (numpy, in place); returns
    the log row ((real[x], real[y]), (blx, bly)). `order`: the blocks' ids
    in the order to run them (default 0, 1, ...); each block's threads run
    in reverse, so that a later column's writes land before an earlier
    column's reads."""
    dt = D.dtype.type
    half = dt(0.5)
    a, b = divmod(int(flat), n)
    x, y, last = min(a, b), max(a, b), n - 1
    blocks = _cdiv(n, threads)
    part = [0.0] * blocks
    slot = None
    scalars = None
    for blk in (range(blocks) if order is None else order):
        # thread 0's reads before the block's columns: no thread of the
        # launch writes them, so every block reads the same
        read = (D[x, y], D[y, y], U[x], U[y], int(real[x]), int(real[y]),
                int(real[last]))
        if scalars is not None and any(
                not (np.array_equal(p, q, equal_nan=True)
                     and np.signbit(p) == np.signbit(q))
                for p, q in zip(read, scalars)):
            raise AssertionError(f"block {blk} read the join's scalars "
                                 f"{read}, an earlier block {scalars}")
        scalars = read
        d = read[0]
        s = [0.0] * threads
        for t in reversed(range(threads)):
            j = blk * threads + t
            if j >= n or j == x or j == y:
                continue
            rx, ry, rl = D[x, j], D[y, j], D[last, j]
            nr = ((rx + ry) - d) * half
            U[j] = U[j] + ((nr - rx) - ry)
            D[x, j] = nr
            D[j, x] = nr
            D[y, j] = rl
            D[j, y] = rl
            s[t] = float(nr)
            if j == last:
                slot = (nr, U[j])
        part[blk] = _tree_sum(s)
    # the last block, from its thread 0's scalars and the slot
    d, dyy, ux0, uy0, real_x, real_y, real_last = scalars
    if n > SMALL_SUM:
        held = [0.0] * threads
        for p in range(blocks):
            held[p % threads] = held[p % threads] + part[p]
        ux = dt(_tree_sum(held))
    else:
        nb = _cdiv(n, XLA_BLOCK)
        row = [dt(0) if k >= n or k in (x, y) else D[x, k]
               for k in range(nb * XLA_BLOCK)]
        accs = []
        for bi in range(nb):
            acc = row[bi * XLA_BLOCK]
            for t in range(1, XLA_BLOCK):
                acc = acc + row[bi * XLA_BLOCK + t]
            accs.append(acc)
        ux = accs[0]
        for v in accs[1:]:
            ux = ux + v
    if last != y:
        dxl, uy = slot
    else:
        dxl = ((d + dyy) - d) * half
        uy = uy0 + ((dxl - d) - dyy)
    denom = dt(n - 2)
    unx, uny = ux0 / denom, uy0 / denom
    blx = ((d + unx) - uny) * half
    bly = d - blx
    bly = bly + blx if blx < 0 else bly
    blx = _clamp0(blx)
    blx = blx + bly if bly < 0 else blx
    bly = _clamp0(bly)
    D[x, x] = 0
    D[x, y] = dxl
    D[y, x] = dxl
    D[y, y] = 0
    U[x] = ux
    U[y] = uy
    real[x] = new_id
    real[y] = real_last
    return (real_x, real_y), (blx, bly)


class ModelStepper:
    """nj_cuda.Stepper's interface over CPU tensors, by the model (the
    tensors are updated in place through numpy views)."""

    def __init__(self, D, U, real, log_ids, log_bl, *, half=False,
                 threads=THREADS, grid=RESIDENT, tile_rows=None):
        self.D, self.U, self.real = D.numpy(), U.numpy(), real.numpy()
        self.log_ids, self.log_bl = log_ids.numpy(), log_bl.numpy()
        self.N = D.shape[0]
        self.half = half
        self.threads, self.grid, self.tile_rows = threads, grid, tile_rows
        self.flat = torch.zeros(1, dtype=torch.int64)
        self.pair = torch.zeros(2, dtype=torch.float64)
        self.q_launches = self.half_launches = self.update_launches = 0

    def q_argmin(self, n: int, r0: int = 0, r1: int | None = None) -> None:
        half = self.half and r1 is None
        r1 = n if r1 is None else r1
        flat, v = q_argmin(self.D, self.U, n, r0, r1, half=half,
                           threads=self.threads, grid=self.grid,
                           tile_rows=self.tile_rows)
        self.flat[0] = flat
        self.pair[0], self.pair[1] = float(v), float(flat)
        self.q_launches += 1
        self.half_launches += half

    def update(self, step: int, n: int, flat=None) -> None:
        f = int((self.flat if flat is None else flat).reshape(-1)[0])
        ids, bls = update(self.D, self.U, self.real, f, n, self.N + step,
                          threads=self.threads)
        self.log_ids[step] = ids
        self.log_bl[step] = bls
        self.update_launches += 1
