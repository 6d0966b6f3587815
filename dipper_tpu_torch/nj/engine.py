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
working copy on the device. On the card a merge step is two hand kernels
(nj_cuda.py): csrc/nj_q_argmin.cu reads the active block once and
returns the first minimum of Q (no Q is written), and csrc/nj_update.cu
reads that index on the card and does the join and the O(n) rewrite of
rows and columns x and y, U and `real`. Where the working copy is
symmetric bit for bit (every matrix of the CLI: mash, MSA, PHYLIP) and
the run is one process, kernel A reads one triangle of it and takes both
of Q's roundings from each element (_read_mode). On the CPU, and as the
yardstick on the card (neighbor_joining_plain), the step is
merge_step_plain: the Q pass into a reused buffer (two subtractions, the
diagonal, torch.argmin, which returns the first minimum), then O(n)
index writes.
The JAX package instead rebuilds the whole padded matrix with masked
selects and re-jits at halved shapes; its row sums U are recomputed
where it halves (n = S/2, S/4, ..., 128 with S = max(128, pow2 >= N)),
and so are this one's (tensor code on both routes), since f32 drift
depends on those points. x, y and the join log stay on the device: a
merge step makes no host sync, and the log comes back once at the end.

Sharded (mesh): every rank holds the whole matrix and runs every O(n)
update; only the Q pass is split, each rank taking a contiguous block of
the active rows and its first minimum as (value, flat index) (on the
card nj_q_argmin over the rank's rows). The ranks' pairs are
all-gathered into a [ranks, 2] tensor and torch.argmin over their
values, in rank order, picks the global first minimum (NaN first,
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

# the working copy's leading dimension is a multiple of this many
# elements (_State)
LD_ALIGN = 32


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

    On the card every merge step is the two kernels of nj_cuda (a build
    or launch failure raises); on the CPU it is merge_step_plain.
    `mesh` (parallel.sharded.Mesh): the Q pass split over its ranks (see
    the module docstring), on mesh.device; every rank returns the same
    result. `log`, if given, receives a line on the sharded merge steps:
    their count, ms a step and host syncs a step."""
    device = mesh.device if mesh is not None else resolve_device(device)
    return _join(D_host, dtype_name, device, mesh, log, plain=False)


def neighbor_joining_plain(D_host, *, dtype_name: str = "float32",
                           device="cpu", mesh=None):
    """neighbor_joining with every merge step by merge_step_plain, on any
    device: the yardstick that the kernels are held to on the card. No
    entry point of the port calls it."""
    device = mesh.device if mesh is not None else resolve_device(device)
    return _join(D_host, dtype_name, device, mesh, None, plain=True)


class _State:
    """One NJ run's device arrays: the working copy D [N, N] (its [n, n]
    prefix is the active block), the row sums U, the node ids `real`,
    the join log (ids and branch lengths, a row a step) and the plain
    version's Q buffer.

    D is the [N, N] view of an [N, ld] buffer whose leading dimension ld
    is N rounded up to LD_ALIGN elements, so that every row starts on a
    128-byte boundary and kernel A reads it with aligned 16-byte loads
    (padding costs under LD_ALIGN elements a row; a scalar head on each
    row would cost the kernel a second code path in every tile instead).
    The plain version indexes the view as it would a contiguous matrix."""

    def __init__(self, D_host, dtype_name: str, device, mesh):
        dtype = torch_dtype(dtype_name)
        N = int(D_host.shape[0])
        self.ld = -(-N // LD_ALIGN) * LD_ALIGN
        self.D = torch.empty((N, self.ld), dtype=dtype,
                             device=device)[:, :N]
        if isinstance(D_host, torch.Tensor):
            self.D.copy_(D_host)
        else:  # cast on the host, as the JAX engine does
            self.D.copy_(torch.from_numpy(np.array(D_host, dtype=dtype_name)))
        self.N = N
        self.U = _sum_last(self.D)
        self.real = torch.arange(N, dtype=torch.int32, device=device)
        self.new_ids = torch.arange(N, 2 * N - 2, dtype=torch.int32,
                                    device=device)
        # [n] = n - 2
        self.denom = torch.arange(N + 1, dtype=dtype, device=device) - 2
        self.log_ids = torch.empty((N - 2, 2), dtype=torch.int32,
                                   device=device)
        self.log_bl = torch.empty((N - 2, 2), dtype=dtype, device=device)
        self.big = torch.finfo(dtype).max
        self.qbuf = None
        self.rows_q = N if mesh is None else -(-N // mesh.size)

    def q_buffer(self) -> torch.Tensor:
        """The plain version's Q buffer, made at its first use."""
        if self.qbuf is None:
            self.qbuf = torch.empty(self.rows_q * self.N, dtype=self.D.dtype,
                                    device=self.D.device)
        return self.qbuf


def _join(D_host, dtype_name: str, device, mesh, log, plain: bool):
    N = int(D_host.shape[0])
    if N < 2:
        raise ValueError("need at least 2 taxa")
    children = [[] for _ in range(2 * N)]
    root = 2 * N - 2
    if N == 2:
        d = float(D_host[0, 1])
        children[root] = [(0, d * 0.5), (1, d * 0.5)]
        return children, root

    st = _State(D_host, dtype_name, device, mesh)
    kernels = None
    if not plain and _on_card(st.D):
        kernels = _stepper(st, _read_mode(st, mesh, log))
    t0 = time.time()
    for step in range(N - 2):
        n = N - step
        if _recomputes_u(n, N):
            st.U[:n] = _sum_last(st.D[:n, :n])
        if kernels is None:
            merge_step_plain(st, step, mesh)
        else:
            _merge_step_kernels(kernels, st, step, mesh)

    if mesh is not None and log is not None:
        synchronize(device)
        syncs = int(mesh.backend == "gloo" and device.type == "cuda")
        log(f"NJ sharded over {mesh.size} ranks ({mesh.backend}): {N - 2} "
            f"merge steps, {(time.time() - t0) * 1000 / (N - 2):.4f} ms a "
            f"step, {syncs} host syncs a step")
    ids = st.log_ids.cpu().tolist()
    bls = st.log_bl.double().cpu().tolist()
    r0, r1 = st.real[:2].cpu().tolist()
    d01 = float(st.D[0, 1])
    for s in range(N - 2):
        children[N + s].append((ids[s][0], bls[s][0]))
        children[N + s].append((ids[s][1], bls[s][1]))
    children[root].append((r0, d01 * 0.5))
    children[root].append((r1, d01 * 0.5))
    return children, root


def _on_card(D: torch.Tensor) -> bool:
    """Whether the run's merge steps are the kernels': D is on the card."""
    return D.device.type == "cuda"


def _read_mode(st: _State, mesh, log=None) -> bool:
    """Kernel A's mode for the run, chosen once: the half read (one
    triangle of D) where the run is a single process and its working copy
    is symmetric bit for bit, else the full read. The check compares the
    bit patterns of D and D.T on the device (so -0.0 against +0.0, and
    NaNs of other payloads, count as asymmetric), one host sync a run;
    kernel B keeps D symmetric from step to step. The sharded route
    reads a rank's rows in full: its merge of the ranks' pairs breaks
    ties by rank order, which is flat order only over whole rows. Logs
    the mode and the check's milliseconds."""
    if mesh is not None:
        if log is not None:
            log("NJ merge steps: full read (sharded: a rank scans its rows)")
        return False
    t0 = time.perf_counter()
    bits = st.D.view(torch.int32 if st.D.element_size() == 4
                     else torch.int64)
    half = torch.equal(bits, bits.T)
    ms = (time.perf_counter() - t0) * 1e3
    if log is not None:
        if half:
            log(f"NJ merge steps: half read (the working copy is symmetric "
                f"bit for bit, checked in {ms:.3f} ms)")
        else:
            i, j = (int(v) for v in torch.nonzero(bits != bits.T)[0])
            log(f"NJ merge steps: full read (the working copy is not "
                f"symmetric bit for bit: D[{i}, {j}] != D[{j}, {i}], "
                f"checked in {ms:.3f} ms)")
    return half


def _stepper(st: _State, half: bool):
    """The kernels' launcher over the run's arrays (nj_cuda.Stepper),
    kernel A in the half read where `half`."""
    from dipper_tpu_torch.nj import nj_cuda

    return nj_cuda.Stepper(st.D, st.U, st.real, st.log_ids, st.log_bl,
                           half=half)


def _merge_step_kernels(k, st: _State, step: int, mesh) -> None:
    """One merge step by the kernels: the first minimum of Q
    (nj_q_argmin, in the stepper's mode; over a rank's rows, the full
    read, its pair merged over the ranks as _sharded_argmin merges them),
    then the join and the update (nj_update), which reads the flat index
    on the card."""
    n = st.N - step
    if mesh is None:
        k.q_argmin(n)
        k.update(step, n)
        return
    r0, r1 = mesh.share(n)
    k.q_argmin(n, r0, r1)
    k.update(step, n, _merge_pairs(mesh.all_gather(k.pair)))


def merge_step_plain(st: _State, step: int, mesh=None) -> None:
    """One merge step as tensor code, on any device: the plain version of
    the two kernels (the Q pass and its first minimum, then the join and
    the row and column update; U's recompute is the caller's)."""
    n = st.N - step
    Dv = st.D[:n, :n]
    # a 0-d divisor on the device keeps this a true division (a host
    # scalar would become a multiplication by its reciprocal)
    Un = st.U[:n] / st.denom[n]
    qbuf = st.q_buffer()
    if mesh is None:
        flat = _argmin_plain(Dv, Un, qbuf, st.big)
    else:
        flat = _sharded_argmin(Dv, Un, qbuf, st.big, mesh)
    _update_plain(st, step, flat)


def _argmin_plain(Dv, Un, qbuf, big) -> torch.Tensor:
    """The flat index [1] int64 of the first minimum of Q over the active
    block (nj_q_argmin's plain version)."""
    return torch.argmin(_q_rows(Dv, Un, qbuf, big, 0, Dv.shape[0])).view(1)


def _update_plain(st: _State, step: int, flat: torch.Tensor) -> None:
    """The join of the pair at `flat` ([1] int64 on the device) and the
    update of D, U and `real` (nj_update's plain version)."""
    n = st.N - step
    last = n - 1
    Dv, U, real = st.D[:n, :n], st.U, st.real
    a = flat // n
    b = flat - a * n
    x, y = torch.minimum(a, b), torch.maximum(a, b)
    xy = torch.cat([x, y])

    rows = Dv.index_select(0, xy)
    rowx, rowy = rows[0], rows[1]
    d = rowx.index_select(0, y)
    uxy = U.index_select(0, xy) / st.denom[n]
    blx = (d + uxy[:1] - uxy[1:]) * 0.5
    bly = d - blx
    # negative-branch clamping, remainder shifted (reference order)
    bly = torch.where(blx < 0, bly + blx, bly)
    blx = blx.clamp(min=0.0)
    blx = torch.where(bly < 0, blx + bly, blx)
    bly = bly.clamp(min=0.0)
    torch.index_select(real, 0, xy, out=st.log_ids[step])
    torch.cat([blx, bly], out=st.log_bl[step])

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
    real.index_copy_(0, xy, torch.cat([st.new_ids[step:step + 1],
                                       real[last:last + 1]]))


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
    return _merge_pairs(mesh.all_gather(pair))


def _merge_pairs(pairs: torch.Tensor) -> torch.Tensor:
    """The flat index [1] int64 of the global first minimum, from the
    ranks' (value, flat index) pairs [ranks, 2] in rank order: rank order
    is row order, so argmin's first minimum over the values (NaN first)
    is the global one."""
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
