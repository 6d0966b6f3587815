"""ctypes wrapper of the Hopper exact-placement kernel (csrc/exact_step.cu),
the port of the body of the JAX package's exact insert loop
(dipper_tpu/placement/exact.py::_exact_insert_loop: `_compute_lims`,
`_score_exact`, `_splice_exact`), built from the repository's sources at
first use (csrc/build.py). Its plain version is
exact.exact_insertion_step; placement/exact_model.py models its plan.

A CUDA ExactState carries a `_Stepper` (made by
`prepare_stepper` where the state is made, and re-made by a launch that
finds its arrays swapped): the seven arrays as checked, the node records
(derived from them, as `adj` is: rebuilt by every cursor write and kept by
the kernel's splices; `node_records` is their plain version), the
level-order scratch, the launch's `out`, the range's cursor, the state's
captured graph and the launch's shape (a cluster of CLUSTER_CTAS blocks of
THREADS threads that splits levels wider than WIDE; prepare_stepper raises
where the card cannot hold such a cluster, and nothing falls back to one
block). A launch reads the insertion, the slots in use and its distance
row from the cursor on the card and advances it, so that a CUDA graph of
GRAPH_INSERTIONS launches, captured once a state (`range_graph`), replays
any stretch of an insert range: exact._replay_exact writes the cursor once
(`set_cursor`), replays (insert_cuda.replay, counted by `count_replays`),
and runs the remainder by direct cursor launches (`exact_step_cursor`).
No entry point synchronizes but `check_done`, which raises if an
insertion since the state's stepper was made failed (`out`'s sticky
error). A capture or a launch that fails raises. `stamped_parts` and
`cluster_sync_us` time the kernel by part (its stamped instance) and one
cluster barrier, for chip_smoke.py and scripts/profile_exact_torch.py.
"""

from __future__ import annotations

import ctypes

import torch

from dipper_tpu_torch.csrc.build import check_launch, load
from dipper_tpu_torch.placement import insert_cuda

# Launches of exact_step made by this process, direct or by a graph's
# replay (chip_smoke.py resets it and reads it to show that a run went
# through the kernel)
EXACT_STEP_LAUNCHES = 0

# insertions one captured graph holds: a replay costs the host one graph
# launch, so 64 keep the host far ahead of the card
GRAPH_INSERTIONS = 64

# the cursor's entries (int64): insertion i, slots in use, the address of
# the range's first distance row, the rows' stride in elements, the range's
# first insertion
CURSOR_LEN = 5
# `out` (int32): the chosen slot, the tree's greatest depth, the positions
# walked, the levels and nodes of the depth shift, the walk's levels wider
# than the stepper's `wide` (-1 before the state's first launch; a launch
# runs on the whole cluster only where the last one found at least
# CLUSTER_LEVELS, else on block 0 alone), the status (0: done, or one of STATUS), and the
# sticky error: the first failed launch's status, after which the tree and
# the cursor stay as they were and every launch does nothing
OUT_FIELDS = ("eid", "maxdep", "positions", "shift_levels", "shift_nodes",
              "wide_levels", "status", "error")
OUT_LEN = len(OUT_FIELDS)
STATUS = {1: "the cursor is out of range",
          2: "the walk found more nodes than M (a cycle in adj)",
          3: "the splice cannot take the chosen slot"}

_NAMES = ("e", "belong", "length", "rev", "parent", "dep", "adj")
# the parts of an insertion that a stamped launch times, in order (thread
# 0 writes clock64() at the launch's start and at each part's end), and
# the stamped instance's buffer: 8 words of parts, then the ends of each
# pass's first STAMP_LEVELS levels (csrc/exact_step.cu::kStampLevels)
PARTS = ("walk", "up_sweep", "down_sweep", "score", "splice_shift")
STAMP_LEVELS = 512
STAMP_WORDS = 8 + 3 * STAMP_LEVELS

# The launch's shape (csrc/exact_step.cu's kMaxCtas and kExactThreads): a
# cluster of CLUSTER_CTAS blocks of THREADS threads; levels wider than WIDE
# positions are split over the cluster, narrower ones are block 0's alone,
# and a tree with fewer than CLUSTER_LEVELS levels wider than WIDE (at the
# last insertion) is block 0's alone (kClusterLevels). On an H100 at the
# 30K CLI's last range, 8 and 16 blocks of 512 tied, 1,024 threads lost at
# every W, and W = 512 beat 256 and 1,024. `prepare_stepper`'s `ctas` (1 to
# CLUSTER_CTAS) and `wide` exist to test the split; the main path takes
# these.
CLUSTER_CTAS = 8
THREADS = 512
WIDE = 512
CLUSTER_LEVELS = 8

# int32 words of a node record (csrc/exact_step.cu::NodeRec): nine slots,
# neighbours and reverse slots, then three lengths (f64: after one pad
# word), 48 or 64 bytes
REC_WORDS = {torch.float32: 12, torch.float64: 16}

_STEP_ARGS = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_CURSOR_SET_ARGS = ([ctypes.c_void_p] + [ctypes.c_longlong] * 5
                    + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])
_PRELOAD_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p]

# (device, cluster blocks) whose kernels this process has loaded and found
# schedulable (exact_step_preload)
_preloaded: set = set()


class _Stepper:
    """What one ExactState's launches share: its seven arrays as checked
    (held so that a swapped array is noticed), the entry points with the
    per-state arguments, the node records, the scratch, `out`, the cursor,
    the launch's shape and the captured graph. Launches through one
    _Stepper must be ordered on one stream."""

    __slots__ = ("arrays", "dtype", "device", "n_edges", "n_nodes",
                 "n_leaves", "lib", "step", "cursor_set", "args", "rec",
                 "scratch_i", "scratch_f", "scratch_p", "scratch_w", "out",
                 "cursor", "graph", "ctas", "wide")

    def owns(self, st) -> bool:
        return all(getattr(st, f) is a for f, a in zip(_NAMES, self.arrays))


def check_arrays(st) -> tuple:
    """The state's seven arrays, checked against what csrc/exact_step.cu
    takes (one device, contiguous, int32 but for length, [E] edge arrays,
    [M] parent and dep, [M, 3] adj, E = 2 M); raises ValueError
    otherwise."""
    dev = st.e.device
    arrays = tuple(getattr(st, f) for f in _NAMES)
    for name, a in zip(_NAMES, arrays):
        if a.device != dev:
            raise ValueError(f"exact_step needs the state's arrays on one "
                             f"device: {name} is on {a.device}, e on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"exact_step needs contiguous arrays: {name} "
                             f"has strides {a.stride()}")
    E, M = st.e.shape[0], st.parent.shape[0]
    dtype = st.length.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"length must be float32 or float64, got {dtype}")
    for name, a in zip(_NAMES, arrays):
        want = dtype if name == "length" else torch.int32
        shape = {"parent": (M,), "dep": (M,), "adj": (M, 3)}.get(name, (E,))
        if a.dtype != want or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {want} {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
    if E != 2 * M or not 6 <= M <= 2**29:
        raise ValueError(f"exact_step takes E = 2 M edge slots and 6 to "
                         f"2**29 nodes, got E = {E} and M = {M}")
    return arrays


def node_records(st) -> torch.Tensor:
    """The plain version of the node records that csrc/exact_step.cu keeps
    ([M, REC_WORDS] int32, on the state's device): each node's adjacency
    row's slots (-1: none), each slot's e and rev (-1 for none), then its
    length's bits (0 for none; f64: after a zero pad word)."""
    adj = st.adj.long()
    ok = (adj >= 0) & (adj < st.e.shape[0])
    k = torch.where(ok, adj, 0)
    ints = torch.cat([torch.where(ok, adj, -1),
                      torch.where(ok, st.e[k].long(), -1),
                      torch.where(ok, st.rev[k].long(), -1)], 1).int()
    lens = torch.where(ok, st.length[k], 0).contiguous().view(torch.int32)
    pad = [] if st.length.dtype == torch.float32 else [
        torch.zeros_like(ints[:, :1])]
    return torch.cat([ints, *pad, lens], 1)


def max_active_clusters(lib, device: int, ctas: int) -> int:
    """Loads the library's kernels on `device` and returns how many
    clusters of `ctas` blocks of THREADS the card can hold at once
    (cudaOccupancyMaxActiveClusters; 0: none)."""
    n = ctypes.c_int(0)
    preload = _entry(lib, "exact_step_preload", _PRELOAD_ARGS)
    check_launch(lib, "exact_step", preload(device, ctas,
                                            ctypes.addressof(n)))
    return n.value


def prepare_stepper(st, ctas: int | None = None, wide: int | None = None):
    """Checks a CUDA state's arrays (check_arrays) and gives the state its
    `_Stepper`, with its node records built, launching clusters of `ctas`
    blocks (1 to CLUSTER_CTAS) of THREADS that split levels wider than
    `wide` (default CLUSTER_CTAS, WIDE: other values only to test the
    split); a state on the CPU is left without one. Raises RuntimeError if
    the card cannot hold such a cluster (nothing falls back to one block).
    Returns `st`."""
    st.stepper = None
    if st.e.device.type != "cuda":
        return st
    arrays = check_arrays(st)
    dev = st.e.device
    E, M = st.e.shape[0], st.parent.shape[0]
    dtype = st.length.dtype
    sp = _Stepper()
    sp.arrays, sp.dtype, sp.device = arrays, dtype, dev
    sp.n_edges, sp.n_nodes, sp.n_leaves = E, M, M // 2
    sp.ctas = CLUSTER_CTAS if ctas is None else ctas
    sp.wide = WIDE if wide is None else wide
    if not (1 <= sp.ctas <= CLUSTER_CTAS and sp.wide >= 1):
        raise ValueError(f"exact_step takes clusters of 1 to {CLUSTER_CTAS} "
                         f"blocks and wide >= 1, got {sp.ctas} and "
                         f"{sp.wide}")
    sp.lib = load("exact_step", _STEP_ARGS)
    sp.step = sp.lib.exact_step
    sp.cursor_set = _entry(sp.lib, "exact_cursor_set", _CURSOR_SET_ARGS)
    key = (dev.index, sp.ctas)
    if key not in _preloaded:
        n = max_active_clusters(sp.lib, dev.index, sp.ctas)
        if n < 1:
            raise RuntimeError(
                f"exact_step: the card cannot schedule a cluster of "
                f"{sp.ctas} blocks of {THREADS} threads "
                f"(cudaOccupancyMaxActiveClusters gave {n})")
        _preloaded.add(key)
    sp.rec = torch.empty((M, REC_WORDS[dtype]), dtype=torch.int32,
                         device=dev)
    sp.scratch_i = torch.empty((4, M + 2), dtype=torch.int32, device=dev)
    sp.scratch_f = torch.empty((5, M), dtype=dtype, device=dev)
    sp.scratch_p = torch.empty((M, 4), dtype=torch.int32, device=dev)
    sp.scratch_w = torch.empty((M, 4), dtype=dtype, device=dev)
    sp.out = torch.full((OUT_LEN,), -1, dtype=torch.int32, device=dev)
    sp.out[-1] = 0
    sp.cursor = torch.zeros((CURSOR_LEN,), dtype=torch.int64, device=dev)
    sp.graph = None
    sp.args = (*(a.data_ptr() for a in arrays), sp.rec.data_ptr(),
               sp.scratch_i.data_ptr(), sp.scratch_f.data_ptr(),
               sp.scratch_p.data_ptr(), sp.scratch_w.data_ptr(),
               sp.out.data_ptr(), sp.cursor.data_ptr())
    st.stepper = sp
    _write_cursor(sp, None, 0, 0, 0, 0, 0, None)   # the records alone
    return st


def _entry(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def stepper(st) -> _Stepper:
    """The state's `_Stepper`, re-made if the state's arrays were swapped
    since it was made; raises for a state the kernel does not take."""
    sp = st.stepper
    if sp is None or not sp.owns(st):
        if st.e.device.type != "cuda":
            raise ValueError(f"exact_step needs a CUDA state, got one on "
                             f"{st.e.device}")
        sp = prepare_stepper(st).stepper
    return sp


def _stream(sp: _Stepper, stream):
    return (torch.cuda.current_stream(sp.device).cuda_stream
            if stream is None else stream)


def _write_cursor(sp: _Stepper, cursor, i: int, used: int, rows: int,
                  stride: int, lo: int, stream) -> None:
    """One launch of exact_cursor_set: the cursor (unless None) and the
    node records rebuilt from the state's arrays."""
    e, _, length, rev, _, _, adj = sp.arrays
    rc = sp.cursor_set(cursor, i, used, rows, stride, lo, e.data_ptr(),
                       rev.data_ptr(), length.data_ptr(), adj.data_ptr(),
                       sp.rec.data_ptr(), sp.n_edges, sp.n_nodes,
                       int(sp.dtype == torch.float64), sp.device.index,
                       _stream(sp, stream))
    check_launch(sp.lib, "exact_step", rc)


def set_cursor(st, i: int, rows: torch.Tensor, lo: int,
               stream: int | None = None) -> None:
    """Launches the write of the state's cursor: insertion i, the slots in
    use (st.idx), and the address and row stride of the range's distance
    rows `rows` (row j: insertion lo + j; the state's float type on its
    card, at least N entries a row with unit stride); the same launch
    rebuilds the node records from the state, so that a range starts from
    the tree as it is, whoever changed it. One launch, no host sync."""
    sp = stepper(st)
    if (rows.device != sp.device or rows.dtype != sp.dtype or rows.dim() != 2
            or rows.shape[1] < sp.n_leaves or rows.stride(1) != 1):
        raise ValueError(f"rows must be a 2-D {sp.dtype} tensor of at least "
                         f"{sp.n_leaves} columns with unit stride along a "
                         f"row on {sp.device}, got {rows.dtype} "
                         f"{tuple(rows.shape)} strides {rows.stride()} on "
                         f"{rows.device}")
    _write_cursor(sp, sp.cursor.data_ptr(), i, st.idx, rows.data_ptr(),
                  rows.stride(0), lo, stream)


def _launch(sp: _Stepper, stamps: int, stream) -> None:
    rc = sp.step(*sp.args, stamps, sp.n_edges, sp.n_nodes, sp.n_leaves,
                 int(sp.dtype == torch.float64), sp.ctas, sp.wide,
                 sp.device.index, _stream(sp, stream))
    if rc != 0:
        check_launch(sp.lib, "exact_step", rc)


def exact_step_cursor(st, stream: int | None = None,
                      count: bool = True) -> None:
    """Launches the insertion that the state's cursor holds; the cursor
    advances by one insertion. st.idx is the caller's to advance.
    `count=False` for a launch being captured (a replay counts its
    launches)."""
    global EXACT_STEP_LAUNCHES
    _launch(stepper(st), 0, stream)
    if count:
        EXACT_STEP_LAUNCHES += 1


def last_out(st) -> dict:
    """What the state's last launch recorded in `out`, read to the host
    (a sync): the chosen slot, greatest depth, positions, depth-shift
    levels and nodes, levels wider than the stepper's `wide`, status and
    the sticky error."""
    return dict(zip(OUT_FIELDS, stepper(st).out.tolist()))


def check_done(st) -> None:
    """Raises RuntimeError if an insertion of the state failed since its
    stepper was made (`out`'s sticky error), naming the insertion that the
    cursor stopped at, after setting st.idx to the cursor's slots in use
    (the state is then the tree before that insertion). Reads one word to
    the host: a sync, made after a range."""
    sp = stepper(st)
    err = int(sp.out[-1])
    if err:
        i, st.idx = (int(v) for v in sp.cursor[:2].tolist())
        raise RuntimeError(f"exact_step failed at insertion {i}: "
                           f"{STATUS.get(err, f'status {err}')}; the tree "
                           f"stays as it was before that insertion")


def range_graph(st) -> insert_cuda._Graph:
    """The state's captured graph of GRAPH_INSERTIONS cursor launches,
    captured at its first use (insert_cuda.new_graph); replayed by
    insert_cuda.replay with `count_replays`."""
    sp = stepper(st)
    if sp.graph is None:
        sp.graph = insert_cuda.new_graph(
            sp.device, lambda s: [exact_step_cursor(st, s, False)
                                  for _ in range(GRAPH_INSERTIONS)])
    return sp.graph


def count_replays(times: int) -> None:
    """Counts the exact_step launches of `times` replays of a range
    graph (insert_cuda.replay's `count`)."""
    global EXACT_STEP_LAUNCHES
    EXACT_STEP_LAUNCHES += GRAPH_INSERTIONS * times


def cluster_sync_us(reps: int = 10000) -> float:
    """One cluster barrier's microseconds in the main path's cluster
    (CLUSTER_CTAS blocks of THREADS) on the current card: a launch of
    `reps` barriers less a launch of none, between CUDA events (the median
    of three). Profiling only."""
    lib = load("exact_step", _STEP_ARGS)
    dev = torch.cuda.current_device()
    if max_active_clusters(lib, dev, CLUSTER_CTAS) < 1:
        raise RuntimeError(f"no cluster of {CLUSTER_CTAS} x {THREADS} fits "
                           f"the card")
    probe = _entry(lib, "exact_cluster_sync_probe",
                   [ctypes.c_int] * 2 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def ms(n: int) -> float:
        check_launch(lib, "exact_step", probe(n, dev, stream))
        torch.cuda.synchronize()
        ev[0].record()
        check_launch(lib, "exact_step", probe(n, dev, stream))
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1])

    per = sorted((ms(reps) - ms(0)) / reps * 1e3 for _ in range(3))
    return per[1]


def _records_stamped(st, rows, lo: int, k: int, **shape) -> tuple:
    """Insertion lo by exact_step.cu, then k insertions from lo + 1 on `st`
    (changed in place) by its stamped instance at the launch shape `shape`
    (prepare_stepper's keywords), each launched alone and synchronized: the
    stamps [k, 6], the level starts after the first stamped launch and its
    cycles by level (rows: k + 1 of them)."""
    sp = prepare_stepper(st, **shape).stepper
    set_cursor(st, lo, rows, lo)
    # one launch first, so that the stamped ones find the tree's wide
    # levels recorded (the state's first launch is block 0's alone)
    _launch(sp, 0, None)
    st.idx += 4
    stamps = torch.zeros((k, STAMP_WORDS), dtype=torch.int64,
                         device=sp.device)
    starts = None
    for j in range(1, k + 1):
        _launch(sp, stamps[j - 1].data_ptr(), None)
        rec = last_out(st)
        if rec["status"] != 0:
            raise RuntimeError(f"exact_step's insertion {lo + j}: {rec}")
        if starts is None:
            starts = sp.scratch_i[3, :rec["maxdep"] + 2].tolist()
            levels = _level_costs(stamps[0].cpu(), starts)
        st.idx += 4
    return stamps[:, :6].cpu(), starts, levels


def _level_costs(stamp: torch.Tensor, starts: list) -> dict:
    """The first stamped launch's cycles by level of each pass (the walk
    from its start, the up-sweep from the walk's end, the down-sweep from
    the up-sweep's end), and by pass the least-squares line cycles =
    a + b x width over its levels: a level's fixed cycles and its cycles
    a position."""
    L = min(len(starts) - 1, STAMP_LEVELS)
    widths = [b - a for a, b in zip(starts, starts[1:])][:L]
    lv = stamp[8:].view(3, STAMP_LEVELS)[:, :L].double()
    res = {}
    for k, name in enumerate(PARTS[:3]):
        ends = lv[k]
        if k == 1:  # the up-sweep runs from the deepest level up
            prev = torch.cat([ends[1:], stamp[1:2].double()])
        else:
            prev = torch.cat([stamp[k:k + 1].double(), ends[:-1]])
        cyc = (ends - prev).tolist()
        if k == 2:  # the down-sweep has no level maxdep
            cyc, w = cyc[:-1], widths[:-1]
        else:
            w = widths
        x = torch.tensor(w, dtype=torch.float64)
        y = torch.tensor(cyc, dtype=torch.float64)
        A = torch.stack([torch.ones_like(x), x], 1)
        a, b = torch.linalg.lstsq(A, y[:, None]).solution[:, 0].tolist()
        res[name] = {"cycles_by_level": cyc, "fixed_cycles": a,
                     "cycles_a_position": b}
    return res


def stamped_parts(st, rows, lo: int, k: int, **shape) -> dict:
    """Insertions lo + 1 .. lo + k (rows[j]: insertion lo + j; rows holds
    k + 1) on a copy of `st` by exact_step.cu's stamped instance at the
    launch shape `shape` (prepare_stepper's ctas and wide), each launched
    alone and synchronized, after an unstamped launch of lo (profiling
    only; the main path never runs the stamped instance). Returns the mean
    clock cycles of each part (PARTS) and of the launch, the SM clock (MHz)
    read after the launches, each part's microseconds at that clock, the
    first insertion's level widths, and its cycles by level of each pass
    with their line against the level's width (`_level_costs`)."""
    import dataclasses

    c = dataclasses.replace(st, **{f: getattr(st, f).clone()
                                   for f in _NAMES})
    c.stepper = None
    stamps, starts, levels = _records_stamped(c, rows, lo, k, **shape)
    cyc = (stamps[:, 1:] - stamps[:, :-1]).double().mean(0).tolist()
    mhz = float(torch.cuda.clock_rate(st.e.device))
    widths = [b - a for a, b in zip(starts, starts[1:])]
    return {**shape, "insertions": k, "lo": lo,
            "cycles": dict(zip(PARTS, cyc)), "cycles_total": sum(cyc),
            "sm_clock_mhz": mhz,
            "us": {p: v / mhz for p, v in zip(PARTS, cyc)},
            "us_total": sum(cyc) / mhz, "level_widths": widths,
            "by_level": levels}
