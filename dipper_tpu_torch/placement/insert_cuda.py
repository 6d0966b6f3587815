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
checked, the frontier scratch, the (xe, ye) output and the kernel's
per-state arguments. Both entry points launch on a stream without
synchronizing, so an insert range of score_edges + insert_step launches
makes no host round trip.
"""

from __future__ import annotations

import ctypes

import torch

from dipper_tpu_torch.csrc.build import check_launch, load

# Launches made by this process of each entry point (chip_smoke.py
# resets them and reads them to show that a run went through the kernel)
INSERT_STEP_LAUNCHES = 0
CLOSEST_BFS_LAUNCHES = 0

# nodes a BFS may dequeue without expanding (insert_step.cu's kMaxBlocked)
MAX_BLOCKED = 2

_STATE_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
_STEP_ARGS = _STATE_ARGS + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]
_BFS_ARGS = _STATE_ARGS + [ctypes.c_int] * 2 + [ctypes.c_void_p,
                                                ctypes.c_int,
                                                ctypes.c_void_p]

_NAMES = ("e", "belong", "length", "rev", "cdis", "cid", "adj")


class _Inserter:
    """What one TreeState's launches share: its seven arrays as checked
    (held so that a swapped array is noticed), the library's two entry
    points with the per-state arguments, the frontier scratch and the
    (xe, ye) output. Launches through one _Inserter must be ordered on one
    stream: they share the scratch and the output."""

    __slots__ = ("arrays", "dtype", "device", "n_edges", "n_nodes", "lib",
                 "step", "bfs", "args", "f_ids", "f_frm", "f_dist", "out_xy")

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
    ins.lib = load("insert_step", _STEP_ARGS)
    ins.step = ins.lib.insert_step
    ins.bfs = ins.lib.closest_bfs
    ins.bfs.restype = ctypes.c_int
    ins.bfs.argtypes = _BFS_ARGS
    ins.args = (*(a.data_ptr() for a in arrays), ins.f_ids.data_ptr(),
                ins.f_frm.data_ptr(), ins.f_dist.data_ptr(),
                ins.out_xy.data_ptr(), E, M, int(dtype == torch.float64),
                dev.index)
    st.inserter = ins
    return st


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
                block_slot: int = -1, stream: int | None = None):
    """Launches the splice of the new node `outside` through `middle` onto
    edge eid at fracLen frac with pendant length add, then the witness BFS
    from `outside` recording `label`, on `stream` (a raw CUDA stream
    handle; default: the current one) without synchronizing. eid (int32),
    frac and add (the state's float type) are one-element tensors on the
    state's card, read there by the kernel (the scorer's outputs). The new
    slots are st.idx .. st.idx + 3; st.idx advances by 4. With block_slot
    >= 0 the endpoints of that slot after the splice are not expanded.
    Returns the `[2]` int32 tensor (xe, ye) that the launch fills (the
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
    if block_slot >= ins.n_edges:
        raise ValueError(f"block_slot {block_slot} is not a slot")
    rc = ins.step(*ins.args, eid.data_ptr(), frac.data_ptr(), add.data_ptr(),
                  i0, middle, outside, label, block_slot,
                  _stream(ins, stream))
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
