"""Work split over the ranks of a torch.distributed group.

The JAX package shards over a device mesh (dipper_tpu/parallel/
sharded.py). The port takes over its decompositions, not its mechanics:
one process per rank, one device per rank, and collectives called by
hand. Each split is chosen so that the sharded build gives the same bytes
as the single-process build:

- sharded_mash_matrix: each rank computes the rows of its block of taxa
  against the whole rank bank (the distance kernel, csrc/
  mash_rows_dist.cu), one all-gather joins the blocks, and the lower
  triangle is mirrored as in the single-process matrix;
- sharded_placement_build: the rank bank is split by rows; for every
  block of kclosest.ROW_BLOCK queries each rank counts the queries
  against its shard (the merge-count kernel, csrc/mash_merge_count.cu)
  and one all-gather makes the [B, N] rows. The tree state is
  replicated; per insertion each rank scores its range of edge slots
  (csrc/score_edges.cu over [lo, hi)), the ranks' choices are
  all-gathered and merged in the kernel's own order, and every rank
  splices and updates the witness lists alike (on the card one launch of
  csrc/insert_step.cu on the winning choice), so the replicas stay
  equal;
- nj/engine.py and dc/pipeline.py take a Mesh and split NJ's Q scan by
  rows and D&C's phases 2 and 3 by rank.

A Mesh's device tensors travel over NCCL when every rank of it has a card
of its own, else over gloo, staged through pinned host memory
(distributed.collective_backend); host arrays always travel over gloo.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from dipper_tpu_torch.parallel.distributed import (TIMEOUT,
                                                   collective_backend,
                                                   rank_device, world)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks 0..size-1 of the default group that share a build, as
    seen from one of them (named after the JAX package's mesh)."""

    group: object          # carries device tensors (NCCL or gloo)
    host_group: object     # gloo, carries host tensors
    rank: int
    size: int
    device: torch.device
    backend: str           # "nccl" or "gloo": the group's backend

    def share(self, n: int) -> tuple[int, int]:
        """This rank's contiguous share [lo, hi) of n items (the last
        ranks' shares may be short or empty)."""
        per = -(-n // self.size)
        lo = min(n, self.rank * per)
        return lo, min(n, lo + per)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's `t` (all of one shape), in rank
        order, on t's device. A CUDA tensor goes over NCCL where the mesh
        has it, else it is staged through pinned host memory (one copy
        each way) and goes over gloo, as a CPU tensor does."""
        t = t.contiguous()
        on_card = t.device.type == "cuda"
        if on_card and self.backend == "nccl":
            out = torch.empty((self.size, *t.shape), dtype=t.dtype,
                              device=t.device)
            dist.all_gather_into_tensor(out, t, group=self.group)
            return out
        src = t.to("cpu") if on_card else t
        out = torch.empty((self.size, *t.shape), dtype=t.dtype,
                          pin_memory=on_card)
        dist.all_gather(list(out.unbind(0)), src, group=self.host_group)
        return out.to(t.device, non_blocking=True) if on_card else out

    def all_gather_host(self, a: np.ndarray) -> np.ndarray:
        """Every rank's host array `a` (equal trailing shapes, any
        length), concatenated along axis 0 in rank order."""
        a = np.ascontiguousarray(a)
        n = torch.tensor([a.shape[0]], dtype=torch.int64)
        ns = torch.empty((self.size, 1), dtype=torch.int64)
        dist.all_gather(list(ns.unbind(0)), n, group=self.host_group)
        ns = ns[:, 0].tolist()
        width = max(ns)
        padded = np.zeros((width, *a.shape[1:]), dtype=a.dtype)
        padded[:a.shape[0]] = a
        t = torch.from_numpy(padded)
        out = torch.empty((self.size, *t.shape), dtype=t.dtype)
        dist.all_gather(list(out.unbind(0)), t, group=self.host_group)
        out = out.numpy()
        return np.concatenate([out[r, :ns[r]] for r in range(self.size)])


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)


def make_mesh(n_devices: int | None = None, device="cuda",
              log=None) -> Mesh | None:
    """The Mesh of ranks 0..n-1 of the default group (n = n_devices,
    at most the group's size; default all), each on its rank_device.
    Every rank of the group calls it (it makes groups); ranks at or above
    n get None and build alone. Logs the collective backend chosen."""
    rank, size = world()
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed group "
                           "(parallel.distributed.init_distributed)")
    n = size if n_devices is None else max(1, min(n_devices, size))
    dev = rank_device(device)
    backend = collective_backend(dev, n)
    ranks = list(range(n))
    host_group = (dist.group.WORLD if n == size
                  else dist.new_group(ranks, backend="gloo",
                                      timeout=TIMEOUT))
    group = (host_group if backend == "gloo"
             else dist.new_group(ranks, backend="nccl", timeout=TIMEOUT))
    if rank >= n:
        return None
    (log or _log)(f"Collectives over {n} ranks: {backend} (rank {rank} on "
                  f"{dev})")
    return Mesh(group=group, host_group=host_group, rank=rank, size=n,
                device=dev, backend=backend)


# ---------------------------------------------------------------------------
# Sharded mash distance matrix
# ---------------------------------------------------------------------------


def _pad_rows(ranks: np.ndarray, nd: int) -> np.ndarray:
    """Rows repeated from the last to a multiple of nd (as the JAX
    package pads); the callers slice the pad off."""
    pad = (-ranks.shape[0]) % nd
    if pad:
        ranks = np.concatenate([ranks, np.tile(ranks[-1:], (pad, 1))])
    return ranks


def sharded_mash_matrix(ranks_pad, k: int, sketch_size: int, mesh: Mesh,
                        dtype="float32") -> torch.Tensor:
    """The [N, N] mash distance matrix of padded rank rows `ranks_pad`
    [N, M] (host array or tensor) on every rank, on mesh.device: the
    bytes of distance/mash.py::mash_distance_matrix (entry (i, j), j < i,
    with row i as the query, mirrored; the diagonal 0). Each rank computes
    its block of query rows against the whole bank; one all-gather joins
    them. dipper_tpu.parallel.sharded_mash_matrix returns the gathered
    block unmirrored (entry (a, q), row q the query), which is the same
    matrix only where the walk is symmetric: on real sketches a few pairs
    count one apart in the two orientations."""
    from dipper_tpu_torch.distance.mash import MATRIX_ROW_BLOCK, mash_pairwise

    host = np.asarray(ranks_pad.cpu() if isinstance(ranks_pad, torch.Tensor)
                      else ranks_pad)
    N = host.shape[0]
    host = _pad_rows(host, mesh.size)
    Np = host.shape[0]
    sh = Np // mesh.size
    bank = torch.from_numpy(host).to(mesh.device)
    local = bank[mesh.rank * sh:(mesh.rank + 1) * sh]
    rows = torch.empty((sh, Np), dtype=getattr(torch, str(dtype)),
                       device=mesh.device)
    for q0 in range(0, sh, MATRIX_ROW_BLOCK):
        q1 = min(sh, q0 + MATRIX_ROW_BLOCK)
        mash_pairwise(bank, local[q0:q1], k=k, sketch_size=sketch_size,
                      dtype_name=str(dtype), out=rows[q0:q1])
    lower = mesh.all_gather(rows).reshape(Np, Np)[:N, :N].tril_(-1)
    return lower + lower.T


# ---------------------------------------------------------------------------
# Sharded k-closest placement
# ---------------------------------------------------------------------------


def _before(a, b) -> bool:
    """Candidate (score, eid) a before b in csrc/score_edges.cu's order,
    which is torch.argmin's: NaN first, then the lower score, then the
    lower slot."""
    a_nan, b_nan = a[0] != a[0], b[0] != b[0]
    if a_nan != b_nan:
        return a_nan
    if a_nan or a[0] == b[0]:
        return a[1] < b[1]
    return a[0] < b[0]


def merge_choices(choices: np.ndarray) -> int:
    """Index of the winning row of `choices` [ranks, >= 2] float64, each
    row a rank's (score, eid, ...), by the scorer's order."""
    best = 0
    for r in range(1, choices.shape[0]):
        if _before(choices[r], choices[best]):
            best = r
    return best


def sharded_placement_build(sketches_u64, k: int, sketch_size: int,
                            mesh: Mesh, dtype="float32"):
    """The k-closest placement tree of the u64 sketch bank
    `sketches_u64` [N, S], built by the mesh's ranks together (see the
    module docstring). Returns host (e, belong, length), as
    dipper_tpu.parallel.sharded_placement_build does, on every rank;
    equal to kclosest.run_placement's arrays on the same bank."""
    from dipper_tpu_torch.distance.mash import (inter_to_dist,
                                                mash_pairwise_inter,
                                                pad_ranks,
                                                rank_compress_host)
    from dipper_tpu_torch.placement import insert_cuda, kclosest

    dtype_name = str(dtype)
    tdtype = getattr(torch, dtype_name)
    dev = mesh.device
    N = int(sketches_u64.shape[0])
    # every rank holds the whole (small) host rank bank: the query rows
    # come from it, the distance rows from the rank's own device shard
    ranks = pad_ranks(rank_compress_host(np.asarray(sketches_u64)))
    padded = _pad_rows(ranks, mesh.size)
    Np = padded.shape[0]
    sh = Np // mesh.size
    bank_local = torch.from_numpy(
        padded[mesh.rank * sh:(mesh.rank + 1) * sh]).to(dev)
    queries = torch.from_numpy(ranks)

    def row_block(lo: int, hi: int) -> torch.Tensor:
        inter = mash_pairwise_inter(bank_local, queries[lo:hi].to(dev),
                                    sketch_size=sketch_size)  # [B, sh]
        inter = mesh.all_gather(inter)                        # [nd, B, sh]
        inter = inter.permute(1, 0, 2).reshape(hi - lo, Np)[:, :N]
        return inter_to_dist(inter.contiguous(), k, sketch_size, dtype_name)

    E = 4 * N
    if E < mesh.size:
        raise ValueError(f"{E} edge slots cannot be split over {mesh.size} "
                         "ranks")
    per = -(-E // mesh.size)
    lo_e = mesh.rank * per
    hi_e = min(E, lo_e + per)

    B = kclosest.ROW_BLOCK
    st = kclosest.init_state(N, tdtype, dev)
    blk = row_block(0, min(N, B))
    kclosest.build_initial_tree(st, blk[1, 0], N)
    kclosest.update_closest_bfs(st, 0, 2 * N)
    kclosest.update_closest_bfs(st, 1, 2 * N)
    for i in range(2, N):
        b0 = (i // B) * B
        if i == b0:
            blk = row_block(b0, min(N, b0 + B))
        eid, x, y, ye, frac, add = kclosest.score_edges(
            st, blk[i - b0], lo=lo_e, hi=hi_e)
        add_h, frac_h = torch.stack((add, frac)).tolist()    # one sync
        mine = torch.tensor([add_h, eid, frac_h, x, y, ye],
                            dtype=torch.float64)
        every = mesh.all_gather(mine).numpy()                 # [nd, 6]
        w = merge_choices(every)
        if w != mesh.rank:
            add_w, eid, frac_w, x, y, ye = every[w]
            eid, x, y, ye = int(eid), int(x), int(y), int(ye)
            frac = torch.tensor(frac_w, dtype=torch.float64).to(tdtype).to(dev)
            add = torch.tensor(add_w, dtype=torch.float64).to(tdtype).to(dev)
        if kclosest.uses_insert_kernel(st):
            # every rank runs the same kernel on the winning choice
            insert_cuda.insert_step(
                st, torch.full((1,), eid, dtype=torch.int32, device=dev),
                frac, add, middle=i + N - 1, outside=i, label=i)
        else:
            kclosest.splice(st, eid, frac, add, i, N, (x, y, ye))
            kclosest.update_closest_bfs(st, i, 2 * N)
    return tuple(getattr(st, f).cpu().numpy()
                 for f in ("e", "belong", "length"))
