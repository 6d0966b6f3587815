"""A numpy model of the schedule of NJ's two merge-step kernels
(csrc/nj_q_argmin.cu, csrc/nj_update.cu), held to the plain version
(nj/engine.py::_argmin_plain, _update_plain) on the CPU by
tests/test_torch_nj.py. Change it together with the kernels.

- q_argmin: the grid of q_plan (column tiles of `threads` x COLS columns,
  tiles of rows), each thread's first minimum over its columns in
  increasing flat order with a strict compare, the block's candidates
  reduced in the warp-shuffle tree of nj_step.cuh::block_min, the
  partials in the last block's order; the combine rule is `before`.
- update: thread j of a block owns column j (not x or y) and reads,
  then writes, its own elements; blocks and threads run in any order the
  caller gives, one after the other, so an element that one thread read
  and another wrote would show as a difference from the plain step. Then
  the last block: U[x] summed as the kernel sums it, columns x and y, the
  join and the log row.

ModelStepper has nj_cuda.Stepper's interface, so that a CPU run can put
the model in the kernels' place and drive the card's route.
"""

from __future__ import annotations

import numpy as np
import torch

THREADS = 256          # nj_step.cuh::kThreads
WARP = 32
COLS = 4               # nj_q_argmin.cu::kCols
MAX_PARTIALS = 4096    # nj_q_argmin.cu::kMaxPartials
MIN_TILE_ELEMS = 16384  # nj_q_argmin.cu::kMinTileElems
NO_ROWS = 1 << 62      # the index of an empty share's pair
SMALL_SUM = 128        # nj_update.cu::kSmallSum (engine._MIN_BUCKET)
XLA_BLOCK = 32

_EMPTY = (0.0, -1)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def q_plan(n: int, rows: int, threads: int = THREADS,
           min_tile_elems: int = MIN_TILE_ELEMS,
           max_partials: int = MAX_PARTIALS) -> tuple[int, int, int]:
    """(column tiles, row tiles, rows a tile) of a launch over `rows` rows
    (nj_q_argmin.cu::plan)."""
    tile_cols = threads * COLS
    col_tiles = _cdiv(n, tile_cols)
    if col_tiles > max_partials:
        raise ValueError(f"n = {n} needs {col_tiles} column tiles, more "
                         f"than {max_partials} partials")
    if rows == 0:
        return col_tiles, 1, 0
    min_rows = _cdiv(min_tile_elems, min(n, tile_cols))
    tile_rows = max(_cdiv(rows, max_partials // col_tiles), min_rows)
    return col_tiles, _cdiv(rows, tile_rows), tile_rows


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


def _warp_min(c: list) -> tuple:
    """Lane 0's candidate after the shuffle-down tree over 32 lanes (a
    lane past the end reads its own value)."""
    c = list(c) + [_EMPTY] * (WARP - len(c))
    off = WARP // 2
    while off:
        c = [c[l + off] if l + off < WARP and before(c[l + off], c[l])
             else c[l] for l in range(WARP)]
        off //= 2
    return c[0]


def block_min(cands: list) -> tuple:
    """nj_step.cuh::block_min over one candidate a thread."""
    warps = [_warp_min(cands[w:w + WARP]) for w in range(0, len(cands), WARP)]
    return _warp_min(warps)


def _thread_firsts(q: np.ndarray, idx: np.ndarray) -> list:
    """Each thread's candidate: q and idx [elements, threads] in the
    thread's order of visits; the first NaN, else the first minimum (a
    strict compare visiting in increasing flat order)."""
    out = []
    for t in range(q.shape[1]):
        v, i = q[:, t], idx[:, t]
        ok = i >= 0
        v, i = v[ok], i[ok]
        if v.size == 0:
            out.append(_EMPTY)
            continue
        nan = np.isnan(v)
        if nan.any():
            k = int(np.flatnonzero(nan)[0])
        else:
            k = int(np.flatnonzero(v == v.min())[0])
        out.append((v[k], int(i[k])))
    return out


def q_argmin(D: np.ndarray, U: np.ndarray, n: int, r0: int, r1: int, *,
             threads: int = THREADS, min_tile_elems: int = MIN_TILE_ELEMS,
             max_partials: int = MAX_PARTIALS) -> tuple:
    """nj_q_argmin's (flat, value) over rows [r0, r1) of the active [n, n]
    block of D (numpy, any leading dimension) with row sums U."""
    dt = D.dtype.type
    big = np.finfo(D.dtype).max
    un = (U[:n] / dt(n - 2)).astype(D.dtype)
    col_tiles, row_tiles, tile_rows = q_plan(
        n, r1 - r0, threads, min_tile_elems, max_partials)
    partials = []
    for by in range(row_tiles):
        for bx in range(col_tiles):
            i0 = r0 + by * tile_rows
            i1 = min(r1, i0 + tile_rows)
            # cols[k, t]: thread t's k-th column
            cols = (bx * threads * COLS + np.arange(COLS)[:, None] * threads
                    + np.arange(threads)[None, :])
            rows = np.arange(i0, i1)
            ok = cols[None] < n
            cc = np.minimum(cols, n - 1)
            q = (D[rows[:, None, None], cc[None]]
                 - un[rows][:, None, None]) - un[cc][None]
            q = np.where(rows[:, None, None] == cols[None], big, q)
            idx = np.where(ok, rows[:, None, None] * n + cols[None], -1)
            firsts = _thread_firsts(q.reshape(-1, threads),
                                    idx.reshape(-1, threads))
            partials.append(block_min(firsts))
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
    d = D[x, y]
    blocks = _cdiv(n, threads)
    part = [0.0] * blocks
    for blk in (range(blocks) if order is None else order):
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
        part[blk] = _tree_sum(s)
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
        dxl, uy = D[x, last], U[last]
    else:
        dyy = D[y, y]
        dxl = ((d + dyy) - d) * half
        uy = U[y] + ((dxl - d) - dyy)
    denom = dt(n - 2)
    unx, uny = U[x] / denom, U[y] / denom
    blx = ((d + unx) - uny) * half
    bly = d - blx
    bly = bly + blx if blx < 0 else bly
    blx = _clamp0(blx)
    blx = blx + bly if bly < 0 else blx
    bly = _clamp0(bly)
    ids = (int(real[x]), int(real[y]))
    real_last = real[last]
    D[x, x] = 0
    D[x, y] = dxl
    D[y, x] = dxl
    D[y, y] = 0
    U[x] = ux
    U[y] = uy
    real[x] = new_id
    real[y] = real_last
    return ids, (blx, bly)


class ModelStepper:
    """nj_cuda.Stepper's interface over CPU tensors, by the model (the
    tensors are updated in place through numpy views)."""

    def __init__(self, D, U, real, log_ids, log_bl, *, threads=THREADS,
                 min_tile_elems=MIN_TILE_ELEMS):
        self.D, self.U, self.real = D.numpy(), U.numpy(), real.numpy()
        self.log_ids, self.log_bl = log_ids.numpy(), log_bl.numpy()
        self.N = D.shape[0]
        self.threads, self.min_tile_elems = threads, min_tile_elems
        self.flat = torch.zeros(1, dtype=torch.int64)
        self.pair = torch.zeros(2, dtype=torch.float64)
        self.q_launches = self.update_launches = 0

    def q_argmin(self, n: int, r0: int = 0, r1: int | None = None) -> None:
        r1 = n if r1 is None else r1
        flat, v = q_argmin(self.D, self.U, n, r0, r1, threads=self.threads,
                           min_tile_elems=self.min_tile_elems)
        self.flat[0] = flat
        self.pair[0], self.pair[1] = float(v), float(flat)
        self.q_launches += 1

    def update(self, step: int, n: int, flat=None) -> None:
        f = int((self.flat if flat is None else flat).reshape(-1)[0])
        ids, bls = update(self.D, self.U, self.real, f, n, self.N + step,
                          threads=self.threads)
        self.log_ids[step] = ids
        self.log_bl[step] = bls
        self.update_launches += 1
