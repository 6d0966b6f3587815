"""ctypes wrapper of the Hopper exact-placement kernel (csrc/exact_step.cu),
the port of the body of the JAX package's exact insert loop
(dipper_tpu/placement/exact.py::_exact_insert_loop: `_compute_lims`,
`_score_exact`, `_splice_exact`), built from the repository's sources at
first use (csrc/build.py). Its plain version is
exact.exact_insertion_step; placement/exact_model.py models its plan.

A CUDA ExactState carries a `_Stepper` (made by
`prepare_stepper` where the state is made, and re-made by a launch that
finds its arrays swapped): the seven arrays as checked, the level-order
scratch, the launch's `out`, the range's cursor and the state's captured
graph. A launch reads the insertion, the slots in use and its distance
row from the cursor on the card and advances it, so that a CUDA graph of
GRAPH_INSERTIONS launches, captured once a state (`range_graph`), replays
any stretch of an insert range: exact._replay_exact writes the cursor once
(`set_cursor`), replays (insert_cuda.replay, counted by `count_replays`),
and runs the remainder by direct cursor launches (`exact_step_cursor`).
No entry point synchronizes but `check_done`, which raises if an
insertion since the state's stepper was made failed (`out`'s sticky
error). A capture or a launch that fails raises.
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
# walked, the levels and nodes of the depth shift, the status (0: done, or
# one of STATUS), and the sticky error: the first failed launch's status,
# after which the tree and the cursor stay as they were and every launch
# does nothing
OUT_FIELDS = ("eid", "maxdep", "positions", "shift_levels", "shift_nodes",
              "status", "error")
OUT_LEN = len(OUT_FIELDS)
STATUS = {1: "the cursor is out of range",
          2: "the walk found more nodes than M (a cycle in adj)",
          3: "the splice cannot take the chosen slot"}

_NAMES = ("e", "belong", "length", "rev", "parent", "dep", "adj")
_STEP_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_CURSOR_SET_ARGS = ([ctypes.c_void_p] + [ctypes.c_longlong] * 5
                    + [ctypes.c_int, ctypes.c_void_p])

# devices whose kernels this process has loaded (exact_step_preload)
_preloaded: set = set()


class _Stepper:
    """What one ExactState's launches share: its seven arrays as checked
    (held so that a swapped array is noticed), the entry points with the
    per-state arguments, the scratch, `out`, the cursor and the captured
    graph. Launches through one _Stepper must be ordered on one stream."""

    __slots__ = ("arrays", "dtype", "device", "n_edges", "n_nodes",
                 "n_leaves", "lib", "step", "cursor_set", "args", "scratch_i",
                 "scratch_f", "out", "cursor", "graph")

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


def prepare_stepper(st):
    """Checks a CUDA state's arrays (check_arrays) and gives the state its
    `_Stepper`; a state on the CPU is left without one. Returns `st`."""
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
    sp.scratch_i = torch.empty((6, M + 2), dtype=torch.int32, device=dev)
    sp.scratch_f = torch.empty((4, M), dtype=dtype, device=dev)
    sp.out = torch.full((OUT_LEN,), -1, dtype=torch.int32, device=dev)
    sp.out[-1] = 0
    sp.cursor = torch.zeros((CURSOR_LEN,), dtype=torch.int64, device=dev)
    sp.graph = None
    sp.lib = load("exact_step", _STEP_ARGS)
    sp.step = sp.lib.exact_step
    sp.cursor_set = _entry(sp.lib, "exact_cursor_set", _CURSOR_SET_ARGS)
    if dev.index not in _preloaded:
        preload = _entry(sp.lib, "exact_step_preload", [ctypes.c_int])
        check_launch(sp.lib, "exact_step", preload(dev.index))
        _preloaded.add(dev.index)
    sp.args = (*(a.data_ptr() for a in arrays), sp.scratch_i.data_ptr(),
               sp.scratch_f.data_ptr(), sp.out.data_ptr(),
               sp.cursor.data_ptr(), E, M, M // 2,
               int(dtype == torch.float64), dev.index)
    st.stepper = sp
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


def set_cursor(st, i: int, rows: torch.Tensor, lo: int,
               stream: int | None = None) -> None:
    """Launches the write of the state's cursor: insertion i, the slots in
    use (st.idx), and the address and row stride of the range's distance
    rows `rows` (row j: insertion lo + j; the state's float type on its
    card, at least N entries a row with unit stride). One small launch, no
    host sync."""
    sp = stepper(st)
    if (rows.device != sp.device or rows.dtype != sp.dtype or rows.dim() != 2
            or rows.shape[1] < sp.n_leaves or rows.stride(1) != 1):
        raise ValueError(f"rows must be a 2-D {sp.dtype} tensor of at least "
                         f"{sp.n_leaves} columns with unit stride along a "
                         f"row on {sp.device}, got {rows.dtype} "
                         f"{tuple(rows.shape)} strides {rows.stride()} on "
                         f"{rows.device}")
    rc = sp.cursor_set(sp.cursor.data_ptr(), i, st.idx, rows.data_ptr(),
                       rows.stride(0), lo, sp.device.index,
                       _stream(sp, stream))
    check_launch(sp.lib, "exact_step", rc)


def exact_step_cursor(st, stream: int | None = None,
                      count: bool = True) -> None:
    """Launches the insertion that the state's cursor holds; the cursor
    advances by one insertion. st.idx is the caller's to advance.
    `count=False` for a launch being captured (a replay counts its
    launches)."""
    global EXACT_STEP_LAUNCHES
    sp = stepper(st)
    rc = sp.step(*sp.args, _stream(sp, stream))
    if rc != 0:
        check_launch(sp.lib, "exact_step", rc)
    if count:
        EXACT_STEP_LAUNCHES += 1


def last_out(st) -> dict:
    """What the state's last launch recorded in `out`, read to the host
    (a sync): the chosen slot, greatest depth, positions, depth-shift
    levels and nodes, status and the sticky error."""
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
