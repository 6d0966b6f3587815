"""Neighbor joining on PyTorch tensors.

Behavioral spec: src/neighborJoining.cu:94-270, as in the JAX reference
dipper_tpu/nj/engine.py —
- selection criterion: minimize d(i,j) - U(i)/(n-2) - U(j)/(n-2) over
  active pairs i != j (findMinDist :117-148), computed as
  (D - U/(n-2))_i - U/(n-2)_j in that order; ties go to the first
  minimum in row-major order of the active block,
- branch lengths blX = (d + (Ux-Uy)/(n-2))/2, blY = d - blX, negative
  branches clamped with the remainder shifted (:227-232),
- matrix compaction: the new node overwrites row/col x, the last active
  row/col moves into y (updateDisMatrix :161-194),
- final 2-node join at root id 2N-2 with d/2 per side (:245-249).

PyTorch design: the active matrix is the [n, n] prefix of one [N, N]
working copy on the device, and one merge step is eager tensor code on
it: the Q pass (two subtractions into a reused buffer, the diagonal,
torch.argmin, which returns the first minimum), then O(n) index writes
of rows and columns x and y. The JAX package instead rebuilds the whole
padded matrix with masked selects and re-jits at halved shapes; its row
sums U are recomputed where it halves (n = S/2, S/4, ..., 128 with S =
max(128, pow2 >= N)), and so are this one's, since f32 drift depends on
those points. x, y and the join log stay on the device: a merge step
makes no host sync, and the log comes back once at the end.

Sharded (mesh): every rank holds the whole matrix and runs every O(n)
update; only the Q pass is split, each rank taking a contiguous block of
the active rows and its first minimum as (value, flat index). The ranks'
pairs are all-gathered into a [ranks, 2] tensor and torch.argmin over
their values, in rank order, picks the global first minimum (NaN first,
the lowest index at ties), so the join sequence and the branch lengths
are the single-process build's, bit for bit. The JAX package row-shards
D itself under GSPMD and promises the join sequence only
(dipper_tpu/nj/engine.py:134-136); here D stays whole because the
compaction moves row `last` into row y every step, which a row-sharded D
would move across ranks. Over NCCL the merge stays on the card (no host
sync a step); over gloo a step syncs once, to stage its pair.

Sums: Q ties are structural in the last steps (on 4 active nodes, Q of
a pair always equals Q of the complementary pair), so the join sequence
there is decided by the rounding of U. Once n <= 128 (the JAX engine's
last bucket) sums are taken in XLA:CPU's order, 32-element blocks left
to right and then the block sums left to right, as elementwise adds,
which give the same bits on the CPU and the card, and the JAX package's
bits on the CPU. Above 128, sums accumulate in float64 (near-exact for
f32), so the CPU and CUDA builds agree although their reduction orders
differ.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dipper_tpu_torch.utils.device import (resolve_device, synchronize,
                                           torch_dtype)

# the JAX engine's smallest bucket: it stops halving (and recomputing U)
# at this many active rows
_MIN_BUCKET = 128


# XLA:CPU's reduction block (see the module docstring)
_XLA_BLOCK = 32


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, in x's dtype: in XLA:CPU's order up to
    _MIN_BUCKET elements, accumulated in float64 above."""
    L = x.shape[-1]
    if L > _MIN_BUCKET:
        return x.sum(dim=-1, dtype=torch.float64).to(x.dtype)
    nb = -(-L // _XLA_BLOCK)
    # trailing zeros leave every partial sum as it is
    x = torch.nn.functional.pad(x, (0, nb * _XLA_BLOCK - L))
    x = x.reshape(*x.shape[:-1], nb, _XLA_BLOCK)
    acc = x[..., 0]
    for t in range(1, _XLA_BLOCK):
        acc = acc + x[..., t]
    total = acc[..., 0]
    for b in range(1, nb):
        total = total + acc[..., b]
    return total


def _recomputes_u(n: int, N: int) -> bool:
    """Whether the JAX engine recomputes U before the step at n active
    rows: where its bucket halves, i.e. n a power of two in [128, N)."""
    return _MIN_BUCKET <= n < N and n & (n - 1) == 0


def neighbor_joining(D_host, *, dtype_name: str = "float32",
                     device="cuda", mesh=None, log=None):
    """NJ of the [N, N] distance matrix `D_host` (a host array or a
    tensor on any device; not modified) on `device` (the card unless the
    caller asks for the CPU; asking for CUDA without it raises), in
    `dtype_name`. Returns (children, root) like dipper_tpu.nj.
    neighbor_joining_device: children[v] = [(child_id, branch_length),
    ...], leaves 0..N-1, the node of join s is N+s, root 2N-2.

    `mesh` (parallel.sharded.Mesh): the Q pass split over its ranks (see
    the module docstring), on mesh.device; every rank returns the same
    result. `log`, if given, receives a line on the sharded merge steps:
    their count, ms a step and host syncs a step."""
    device = mesh.device if mesh is not None else resolve_device(device)
    N = int(D_host.shape[0])
    if N < 2:
        raise ValueError("need at least 2 taxa")
    children = [[] for _ in range(2 * N)]
    root = 2 * N - 2
    if N == 2:
        d = float(D_host[0, 1])
        children[root] = [(0, d * 0.5), (1, d * 0.5)]
        return children, root

    dtype = torch_dtype(dtype_name)
    if isinstance(D_host, torch.Tensor):
        D = D_host.to(device=device, dtype=dtype, copy=True)
    else:  # cast on the host, as the JAX engine does
        D = torch.from_numpy(np.array(D_host, dtype=dtype_name)).to(device)
    U = _sum_last(D)
    real = torch.arange(N, dtype=torch.int32, device=device)
    new_ids = torch.arange(N, 2 * N - 2, dtype=torch.int32, device=device)
    denom = torch.arange(N + 1, dtype=dtype, device=device) - 2  # [n] = n-2
    log_ids = torch.empty((N - 2, 2), dtype=torch.int32, device=device)
    log_bl = torch.empty((N - 2, 2), dtype=dtype, device=device)
    rows_q = N if mesh is None else -(-N // mesh.size)
    qbuf = torch.empty(rows_q * N, dtype=dtype, device=device)
    big = torch.finfo(dtype).max
    t0 = time.time()

    for step in range(N - 2):
        n = N - step
        last = n - 1
        Dv = D[:n, :n]
        if _recomputes_u(n, N):
            U[:n] = _sum_last(Dv)
        # a 0-d CUDA divisor keeps this a true division (a host scalar
        # would become a multiplication by its reciprocal)
        Un = U[:n] / denom[n]
        if mesh is None:
            flat = torch.argmin(_q_rows(Dv, Un, qbuf, big, 0, n)).view(1)
        else:
            flat = _sharded_argmin(Dv, Un, qbuf, big, mesh)
        a = flat // n
        b = flat - a * n
        x, y = torch.minimum(a, b), torch.maximum(a, b)
        xy = torch.cat([x, y])

        rows = Dv.index_select(0, xy)
        rowx, rowy = rows[0], rows[1]
        d = rowx.index_select(0, y)
        uxy = Un.index_select(0, xy)
        blx = (d + uxy[:1] - uxy[1:]) * 0.5
        bly = d - blx
        # negative-branch clamping, remainder shifted (reference order)
        bly = torch.where(blx < 0, bly + blx, bly)
        blx = blx.clamp(min=0.0)
        blx = torch.where(bly < 0, blx + bly, blx)
        bly = bly.clamp(min=0.0)
        torch.index_select(real, 0, xy, out=log_ids[step])
        torch.cat([blx, bly], out=log_bl[step])

        newrow = (rowx + rowy - d) * 0.5
        # U[x] and U[y] are overwritten below, so they need no mask
        U[:n] += (newrow - rowx) - rowy
        newrow.index_fill_(0, x, 0.0)                 # D[x, x] = 0
        ux = _sum_last(newrow.index_fill(0, y, 0.0))
        d_x_last = newrow[last:last + 1].clone()      # d(new node, last)
        # row y receives row `last` as it is after the x write, with its
        # y entry zeroed; (x, y) and (y, x) become d(new node, last)
        rl = Dv[last].clone()
        rl.index_copy_(0, x, d_x_last)
        rl.index_fill_(0, y, 0.0)
        newrow.index_copy_(0, y, d_x_last)
        new_rows = torch.stack([newrow, rl])
        Dv.index_copy_(0, xy, new_rows)
        Dv.index_copy_(1, xy, new_rows.T)
        U.index_copy_(0, xy, torch.cat([ux.view(1), U[last:last + 1]]))
        real.index_copy_(0, xy, torch.cat([new_ids[step:step + 1],
                                           real[last:last + 1]]))

    if mesh is not None and log is not None:
        synchronize(device)
        syncs = int(mesh.backend == "gloo" and device.type == "cuda")
        log(f"NJ sharded over {mesh.size} ranks ({mesh.backend}): {N - 2} "
            f"merge steps, {(time.time() - t0) * 1000 / (N - 2):.4f} ms a "
            f"step, {syncs} host syncs a step")
    ids = log_ids.cpu().tolist()
    bls = log_bl.double().cpu().tolist()
    r0, r1 = real[:2].cpu().tolist()
    d01 = float(D[0, 1])
    for s in range(N - 2):
        children[N + s].append((ids[s][0], bls[s][0]))
        children[N + s].append((ids[s][1], bls[s][1]))
    children[root].append((r0, d01 * 0.5))
    children[root].append((r1, d01 * 0.5))
    return children, root


def _q_rows(Dv, Un, qbuf, big, r0: int, r1: int) -> torch.Tensor:
    """Rows r0..r1 of Q over the [n, n] active block, in `qbuf`: (D -
    U/(n-2))_i - U/(n-2)_j, the diagonal at `big`."""
    n = Dv.shape[0]
    Q = qbuf[:(r1 - r0) * n].view(r1 - r0, n)
    torch.sub(Dv[r0:r1], Un[r0:r1, None], out=Q)
    Q.sub_(Un[None, :])
    Q.diagonal(offset=r0).fill_(big)
    return Q


def _sharded_argmin(Dv, Un, qbuf, big, mesh) -> torch.Tensor:
    """The flat index [1] int64 of the first minimum of Q over the whole
    [n, n] active block, each rank scanning its block of rows."""
    n = Dv.shape[0]
    r0, r1 = mesh.share(n)
    if r1 > r0:
        Q = _q_rows(Dv, Un, qbuf, big, r0, r1)
        # index_select, not indexing by a tensor: no host sync on the card
        li = torch.argmin(Q).view(1)
        pair = torch.cat([Q.view(-1).index_select(0, li).double(),
                          (li + r0 * n).double()])
    else:  # no rows here: a pair that every real one beats
        pair = torch.tensor([float("inf"), 2.0 ** 62], dtype=torch.float64,
                            device=Dv.device)
    pairs = mesh.all_gather(pair)                      # [ranks, 2]
    # rank order is row order, so argmin's first minimum over the ranks'
    # values (NaN first) is the global one
    w = torch.argmin(pairs[:, 0]).view(1)
    return pairs[:, 1].index_select(0, w).long()


def nj_tree_newick(children, root, names) -> str:
    """Iterative Newick writer for the NJ join tree (reference
    neighborJoining.cu:252-270 recursion, made stack-explicit); a copy of
    dipper_tpu/nj/engine.py::nj_tree_newick."""
    out = []
    stack = [(root, 0)]
    while stack:
        v, i = stack.pop()
        ch = children[v]
        if not ch:
            out.append(names[v])
            continue
        if i == 0:
            out.append("(")
        else:
            out.append(":")
            out.append(f"{ch[i - 1][1]:.6g}")
            out.append(")" if i == len(ch) else ",")
        if i < len(ch):
            stack.append((v, i + 1))
            stack.append((ch[i][0], 0))
    out.append(";")
    return "".join(out)
