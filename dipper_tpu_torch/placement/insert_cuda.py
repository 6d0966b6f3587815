"""ctypes wrapper of the Hopper insertion-step kernel (csrc/insert_step.cu),
the port of the body of the JAX package's device-resident insert loop
(dipper_tpu/placement/kclosest.py::_blocked_insert_loop: splice and the
compact witness BFS), built from the repository's sources at first use
(csrc/build.py). Its plain version is kclosest.splice followed by
kclosest._update_closest_bfs_compact; placement/insert_model.py models its
plan.

A CUDA TreeState with an adjacency table carries an `_Inserter` (made by
`prepare_inserter` where the state is made or its arrays are swapped,
and re-made by a launch that finds them swapped): the seven arrays as
checked, the frontier spill, the (xe, ye) output, the range's cursor,
the kernel's per-state arguments and the state's captured graphs. Every
entry point launches on a stream without synchronizing.

Two ways to launch. `insert_step` and `closest_bfs` take the insertion
from the host (the sharded build, a state's two first BFSs). The cursor entry points (`insert_step_cursor`,
`closest_bfs_cursor`) read the insertion or leaf, and the slots in use,
from the state's cursor on the card and advance it, so that a CUDA graph
of them captured once (`range_graph`) replays any stretch of an insert
range or of --add's seeding: kclosest._insert_range writes the cursor
once (`set_cursor`), replays, and runs the remainder by direct cursor
launches. D&C's streamed clusters do the same with their own offsets of
the nodes and label and a blocked slot (dc/cluster.py::build_streamed). A capture, an instantiation or a replay that fails raises.
"""

from __future__ import annotations

import ctypes

import torch

from dipper_tpu_torch.csrc.build import check_launch, load

# Launches made by this process of each kernel, direct or by a graph's
# replay (chip_smoke.py resets them and reads them to show that a run went
# through the kernel): insert_step and insert_step_cursor, closest_bfs and
# closest_bfs_cursor
INSERT_STEP_LAUNCHES = 0
CLOSEST_BFS_LAUNCHES = 0
# CUDA graphs captured and replayed by this process (capture, replay; and
# exact_cuda's graphs of exact placement)
GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0

# nodes a BFS may dequeue without expanding (insert_step.cu's kMaxBlocked)
MAX_BLOCKED = 2

_STATE_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
_STEP_ARGS = _STATE_ARGS + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_BFS_ARGS = _STATE_ARGS + [ctypes.c_int] * 2 + [ctypes.c_void_p,
                                                ctypes.c_int,
                                                ctypes.c_void_p]
_STEP_CURSOR_ARGS = _STATE_ARGS + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_BFS_CURSOR_ARGS = _STATE_ARGS + [ctypes.c_void_p] * 2
_CURSOR_SET_ARGS = ([ctypes.c_void_p] + [ctypes.c_longlong] * 5
                    + [ctypes.c_int, ctypes.c_void_p])

# the cursor's entries (int64): insertion or leaf i, slots in use, the
# address of the range's first distance row, the rows' stride in elements,
# the range's first insertion
CURSOR_LEN = 5

# devices whose kernels this process has loaded (insert_step_preload)
_preloaded: set = set()

_NAMES = ("e", "belong", "length", "rev", "cdis", "cid", "adj")


class _Inserter:
    """What one TreeState's launches share: its seven arrays as checked
    (held so that a swapped array is noticed), the library's two entry
    points with the per-state arguments, the frontier scratch and the
    (xe, ye) output. Launches through one _Inserter must be ordered on one
    stream: they share the scratch and the output."""

    __slots__ = ("arrays", "dtype", "device", "n_edges", "n_nodes", "lib",
                 "step", "bfs", "step_cursor", "bfs_cursor", "cursor_set",
                 "args", "f_ids", "f_frm", "f_dist", "out_xy", "cursor",
                 "graphs")

    def owns(self, st) -> bool:
        return all(getattr(st, f) is a for f, a in zip(_NAMES, self.arrays))


def check_arrays(st) -> tuple:
    """The state's seven arrays, checked against what csrc/insert_step.cu
    takes (one device, contiguous, int32 but for length and cdis of one
    float type, [E], [E, 5] and [M, 3]); raises ValueError otherwise."""
    dev = st.e.device
    arrays = tuple(getattr(st, f) for f in _NAMES)
    for name, a in zip(_NAMES, arrays):
        if a.device != dev:
            raise ValueError(f"insert_step needs the state's arrays on one "
                             f"CUDA device: {name} is on {a.device}, e on "
                             f"{dev}")
        if not a.is_contiguous():
            raise ValueError(f"insert_step needs contiguous arrays: {name} "
                             f"has strides {a.stride()}")
    E, M = st.e.shape[0], st.adj.shape[0]
    dtype = st.length.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"length must be float32 or float64, got {dtype}")
    for name, a in zip(_NAMES, arrays):
        want = dtype if name in ("length", "cdis") else torch.int32
        shape = {"cdis": (E, 5), "cid": (E, 5), "adj": (M, 3)}.get(name, (E,))
        if a.dtype != want or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {want} {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
    if not 4 <= E < 2**30 or not 1 <= M <= 2**29:
        raise ValueError(f"insert_step takes 4 to 2**30 - 1 edge slots and "
                         f"1 to 2**29 nodes, got {E} and {M}")
    return arrays


def check_choice(dtype, device, eid, frac, add) -> None:
    """eid (int32), frac and add (`dtype`): one element each on `device`."""
    for name, t, want in (("eid", eid, torch.int32), ("frac", frac, dtype),
                          ("add", add, dtype)):
        if t.device != device or t.dtype != want or t.numel() != 1:
            raise ValueError(f"{name} must be one {want} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def prepare_inserter(st):
    """Checks a CUDA state's arrays (check_arrays) and gives the state its
    `_Inserter`; a state on the CPU, without an adjacency table or with a
    cluster axis is left without one. Called wherever a state is made or
    its arrays are replaced, so that no check runs per insertion. Returns
    `st`."""
    st.inserter = None
    if st.e.device.type != "cuda" or st.adj is None or st.e.dim() != 1:
        return st
    arrays = check_arrays(st)
    dev = st.e.device
    E, M = st.e.shape[0], st.adj.shape[0]
    dtype = st.length.dtype
    ins = _Inserter()
    ins.arrays, ins.dtype, ins.device = arrays, dtype, dev
    ins.n_edges, ins.n_nodes = E, M
    ins.f_ids = torch.empty((2, M), dtype=torch.int32, device=dev)
    ins.f_frm = torch.empty((2, M), dtype=torch.int32, device=dev)
    ins.f_dist = torch.empty((2, M), dtype=dtype, device=dev)
    ins.out_xy = torch.full((2,), -1, dtype=torch.int32, device=dev)
    ins.cursor = torch.zeros((CURSOR_LEN,), dtype=torch.int64, device=dev)
    ins.graphs = {}
    ins.lib = load("insert_step", _STEP_ARGS)
    ins.step = ins.lib.insert_step
    ins.bfs = _entry(ins.lib, "closest_bfs", _BFS_ARGS)
    ins.step_cursor = _entry(ins.lib, "insert_step_cursor", _STEP_CURSOR_ARGS)
    ins.bfs_cursor = _entry(ins.lib, "closest_bfs_cursor", _BFS_CURSOR_ARGS)
    ins.cursor_set = _entry(ins.lib, "insert_cursor_set", _CURSOR_SET_ARGS)
    if dev.index not in _preloaded:
        preload = _entry(ins.lib, "insert_step_preload", [ctypes.c_int])
        check_launch(ins.lib, "insert_step", preload(dev.index))
        _preloaded.add(dev.index)
    ins.args = (*(a.data_ptr() for a in arrays), ins.f_ids.data_ptr(),
                ins.f_frm.data_ptr(), ins.f_dist.data_ptr(),
                ins.out_xy.data_ptr(), E, M, int(dtype == torch.float64),
                dev.index)
    st.inserter = ins
    return st


def _entry(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def inserter(st) -> _Inserter:
    """The state's `_Inserter`, re-made if the state's arrays were
    swapped since it was made; raises for a state the kernel does not
    take."""
    ins = st.inserter
    if ins is None or not ins.owns(st):
        if st.e.device.type != "cuda":
            raise ValueError(f"insert_step needs a CUDA state, got one on "
                             f"{st.e.device}")
        if st.adj is None:
            raise ValueError("insert_step needs a state with an adjacency "
                             "table")
        ins = prepare_inserter(st).inserter
        if ins is None:
            raise ValueError("insert_step takes one tree, not a cluster axis")
    return ins


def _stream(ins: _Inserter, stream):
    return (torch.cuda.current_stream(ins.device).cuda_stream
            if stream is None else stream)


def insert_step(st, eid: torch.Tensor, frac: torch.Tensor,
                add: torch.Tensor, *, middle: int, outside: int, label: int,
                stream: int | None = None):
    """Launches the splice of the new node `outside` through `middle` onto
    edge eid at fracLen frac with pendant length add, then the witness BFS
    from `outside` recording `label`, on `stream` (a raw CUDA stream
    handle; default: the current one) without synchronizing. eid (int32),
    frac and add (the state's float type) are one-element tensors on the
    state's card, read there by the kernel (the scorer's outputs). The new
    slots are st.idx .. st.idx + 3; st.idx advances by 4. Returns the `[2]` int32 tensor (xe, ye) that the launch fills (the
    state's next launch overwrites it). Bitwise equal to kclosest.splice
    then kclosest._update_closest_bfs_compact."""
    global INSERT_STEP_LAUNCHES
    ins = inserter(st)
    check_choice(ins.dtype, ins.device, eid, frac, add)
    i0 = st.idx
    if i0 + 4 > ins.n_edges:
        raise ValueError(f"no room for four slots at {i0} in {ins.n_edges}")
    if not (0 <= middle < ins.n_nodes and 0 <= outside < ins.n_nodes):
        raise ValueError(f"middle {middle} and outside {outside} must be "
                         f"nodes of [0, {ins.n_nodes})")
    rc = ins.step(*ins.args, eid.data_ptr(), frac.data_ptr(), add.data_ptr(),
                  i0, middle, outside, label, _stream(ins, stream))
    if rc != 0:
        check_launch(ins.lib, "insert_step", rc)
    INSERT_STEP_LAUNCHES += 1
    st.idx = i0 + 4
    return ins.out_xy


def closest_bfs(st, leaf: int, label: int | None = None,
                blocked: torch.Tensor | None = None,
                stream: int | None = None) -> None:
    """Launches the witness BFS from node `leaf` recording `label`
    (default: the leaf) on `stream` without synchronizing; `blocked`, an
    int32 tensor of at most MAX_BLOCKED node ids on the state's card, are
    dequeued but not expanded. Bitwise equal to
    kclosest._update_closest_bfs_compact."""
    global CLOSEST_BFS_LAUNCHES
    ins = inserter(st)
    if not 0 <= leaf < ins.n_nodes:
        raise ValueError(f"leaf {leaf} is not a node of [0, {ins.n_nodes})")
    nb, ptr = 0, None
    if blocked is not None:
        if (blocked.device != ins.device or blocked.dtype != torch.int32
                or blocked.dim() != 1 or not blocked.is_contiguous()
                or blocked.numel() > MAX_BLOCKED):
            raise ValueError(f"blocked must be a contiguous int32 vector of "
                             f"at most {MAX_BLOCKED} nodes on {ins.device}")
        nb, ptr = blocked.numel(), blocked.data_ptr()
    rc = ins.bfs(*ins.args, leaf, leaf if label is None else label, ptr, nb,
                 _stream(ins, stream))
    if rc != 0:
        check_launch(ins.lib, "insert_step", rc)
    CLOSEST_BFS_LAUNCHES += 1


# ---------------------------------------------------------------------------
# The cursor route: an insert range (or --add's seeding) as replays of one
# captured CUDA graph
# ---------------------------------------------------------------------------


def set_cursor(st, i: int, rows: torch.Tensor | None = None, lo: int = 0,
               stream: int | None = None) -> None:
    """Launches the write of the state's cursor: insertion (or leaf) i,
    the slots in use (st.idx), and, for an insert range, the address and
    row stride of its distance rows `rows` (row j: insertion lo + j; the
    state's float type on its card, unit stride along a row). One small
    launch, no host sync."""
    ins = inserter(st)
    base, stride = 0, 0
    if rows is not None:
        if (rows.device != ins.device or rows.dtype != ins.dtype
                or rows.dim() != 2
                or (rows.shape[1] > 1 and rows.stride(1) != 1)):
            raise ValueError(f"rows must be a 2-D {ins.dtype} tensor with "
                             f"unit stride along a row on {ins.device}, got "
                             f"{rows.dtype} {tuple(rows.shape)} strides "
                             f"{rows.stride()} on {rows.device}")
        base, stride = rows.data_ptr(), rows.stride(0)
    rc = ins.cursor_set(ins.cursor.data_ptr(), i, st.idx, base, stride, lo,
                        ins.device.index, _stream(ins, stream))
    check_launch(ins.lib, "insert_step", rc)


def cursor_offsets(num_sequences: int) -> tuple:
    """Placement's offsets of insertion i's outside node, middle node and
    label: taxon i through middle i + num_sequences - 1, labelled i."""
    return (0, num_sequences - 1, 0)


def insert_step_cursor(st, sc, *, offsets: tuple, block_slot: int = -1,
                       stream: int | None = None, count: bool = True):
    """Launches the insertion i that the state's cursor holds: the splice
    of node i + o through middle i + m, labelled i + l, where (o, m, l) =
    `offsets` (placement's: `cursor_offsets(num_sequences)`), onto the edge that the scorer `sc` (out_i holds the edge and its ends,
    out_f frac and add: kclosest._Scorer, or D&C's masked scorer) left on
    the card, at the slots the cursor holds, then the BFS from the outside
    node, not expanding the endpoints of `block_slot` after the splice
    (-1: none); the cursor advances by one insertion. st.idx is the
    caller's to advance. `count=False` for a launch being captured (a
    replay counts its launches)."""
    global INSERT_STEP_LAUNCHES
    ins = inserter(st)
    if block_slot >= ins.n_edges:
        raise ValueError(f"block_slot {block_slot} is not a slot")
    rc = ins.step_cursor(*ins.args, sc.out_i.data_ptr(), sc.out_f.data_ptr(),
                         ins.cursor.data_ptr(), *offsets, block_slot,
                         _stream(ins, stream))
    if rc != 0:
        check_launch(ins.lib, "insert_step", rc)
    if count:
        INSERT_STEP_LAUNCHES += 1


def closest_bfs_cursor(st, stream: int | None = None,
                       count: bool = True) -> None:
    """Launches the BFS from leaf i = the cursor's insertion, recording i;
    the cursor advances by one leaf."""
    global CLOSEST_BFS_LAUNCHES
    ins = inserter(st)
    rc = ins.bfs_cursor(*ins.args, ins.cursor.data_ptr(),
                        _stream(ins, stream))
    if rc != 0:
        check_launch(ins.lib, "insert_step", rc)
    if count:
        CLOSEST_BFS_LAUNCHES += 1


class _Graph:
    """A captured CUDA graph of cursor launches, with the launches of each
    entry point one replay makes and what its pointers point into."""

    __slots__ = ("graph", "steps", "bfs", "keep")


# a side stream per device to capture on (a capture needs a stream other
# than the default one)
_capture_streams: dict = {}


def capture(device: torch.device, launch) -> torch.cuda.CUDAGraph:
    """A CUDA graph of the launches `launch(stream)` makes on the device's
    side stream (they must not count themselves: a replay counts them). A
    failed capture raises."""
    global GRAPH_CAPTURES
    side = _capture_streams.get(device.index)
    if side is None:
        side = _capture_streams[device.index] = torch.cuda.Stream(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            launch(side.cuda_stream)
        finally:
            graph.capture_end()
    GRAPH_CAPTURES += 1
    return graph


def range_graph(st, key, launch, steps: int = 0, bfs: int = 0,
                keep=()) -> _Graph:
    """The state's CUDA graph `key`, captured at its first use: `launch`
    (stream) makes the launches of one replay with count=False, `steps`
    insert_step_cursor and `bfs` closest_bfs_cursor launches. `keep`:
    objects whose memory the launches use (the scorer), held as long as
    the graph. Captured once per state (a state whose arrays were
    replaced has a new _Inserter, and so new graphs) and per key; a failed
    capture raises."""
    ins = inserter(st)
    g = ins.graphs.get(key)
    if g is None:
        g = ins.graphs[key] = new_graph(ins.device, launch, steps, bfs, keep)
    return g


def new_graph(device: torch.device, launch, steps: int = 0, bfs: int = 0,
              keep=()) -> _Graph:
    """A _Graph of the launches `launch(stream)` makes (capture), with
    `steps`, `bfs` and `keep` as range_graph has them."""
    g = _Graph()
    g.graph = capture(device, launch)
    g.steps, g.bfs, g.keep = steps, bfs, tuple(keep)
    return g


def replay(g, times: int, count=None) -> None:
    """Replays the graph `times` times on the current stream, counting its
    launches: its insert_step and closest_bfs launches here, other
    kernels' by `count(times)`."""
    global GRAPH_REPLAYS, INSERT_STEP_LAUNCHES, CLOSEST_BFS_LAUNCHES
    for _ in range(times):
        g.graph.replay()
    GRAPH_REPLAYS += times
    INSERT_STEP_LAUNCHES += g.steps * times
    CLOSEST_BFS_LAUNCHES += g.bfs * times
    if count is not None:
        count(times)
