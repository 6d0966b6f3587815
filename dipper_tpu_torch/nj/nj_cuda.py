"""ctypes wrapper of the Hopper kernels of NJ's merge step, the port of
the JAX package's merge step (dipper_tpu/nj/engine.py::_one_merge_step,
an XLA program inside _run_bucket's fori_loop):

- csrc/nj_q_argmin.cu: the first minimum of Q over the active block,
  read once, with no Q written, as the flat index (int64); in the half
  read from one triangle of a symmetric D, in the full read from rows
  [r0, r1), and then for a rank's share of a sharded scan also the pair
  (value, flat) as doubles;
- csrc/nj_update.cu: the join at that index, read on the card, and the
  rewrite of D, U and `real`, with the step's log row.

Both are built from the repository's sources at first use (csrc/
build.py). Their plain version is nj/engine.py::merge_step_plain
(_argmin_plain, _update_plain); nj/step_model.py models their schedule.
A CUDA NJ run makes one `Stepper` over its arrays, which checks them
once; its launches go on the stream current when it was made and return
without synchronizing, so a merge step is two launches and no host sync.
"""

from __future__ import annotations

import ctypes

import torch

from dipper_tpu_torch.csrc.build import check_launch, load

# Kernel launches made by this process (chip_smoke.py resets them and
# reads them to show that a run went through the kernels)
Q_ARGMIN_LAUNCHES = 0   # nj_q_argmin, both modes
HALF_READ_LAUNCHES = 0  # nj_q_argmin in the half read
UPDATE_LAUNCHES = 0     # nj_update

# nj_q_argmin.cu's kMaxPartials (the most blocks a launch has) and
# nj_step.cuh's kThreads (nj_update's block: one partial a block)
MAX_PARTIALS = 2048
THREADS = 256

_Q_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p]
_UPDATE_ARGS = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 7 \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, D on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {list(shape)} tensor, "
                         f"got {tuple(t.shape)} strides {t.stride()}")


class Stepper:
    """Launches the two kernels over one NJ run's arrays: D [N, N] (float32
    or float64 on a CUDA device, rows of stride ld >= N with ld a
    multiple of one 16-byte load and D 16-byte aligned, as engine._State
    makes it; its [n, n] prefix the active block), U [N] of D's dtype,
    real int32 [N], and the join log, log_ids int32 [N - 2, 2] and log_bl
    [N - 2, 2] of D's dtype. `half`: kernel A reads one triangle of the
    active block (D must stay symmetric bit for bit; the caller checks
    it, engine._read_mode); a share of the rows is always read in full.
    Both kernels launch with programmatic dependent launch (Hopper): a
    kernel's blocks are placed while the previous kernel of the stream
    ends, and wait for it before their first read. Holds the kernels'
    scratch and outputs: `flat` int64 [1], `pair` float64 [2]. Launches through
    one Stepper must be ordered on its stream."""

    def __init__(self, D: torch.Tensor, U: torch.Tensor, real: torch.Tensor,
                 log_ids: torch.Tensor, log_bl: torch.Tensor, *,
                 half: bool = False):
        dev = D.device
        if dev.type != "cuda":
            raise ValueError(f"the NJ kernels need CUDA tensors, got D on "
                             f"{dev}")
        if D.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"D must be float32 or float64, got {D.dtype}")
        N = D.shape[0]
        if D.dim() != 2 or N < 3 or D.shape[1] != N:
            raise ValueError(f"D must be [N, N] with N >= 3, got "
                             f"{tuple(D.shape)}")
        ld, vec = D.stride(0), 16 // D.element_size()
        if D.stride(1) != 1 or ld < N or ld % vec or D.data_ptr() % 16:
            raise ValueError(f"D's rows must be contiguous, 16-byte aligned "
                             f"and {vec}-element multiples apart, got "
                             f"strides {D.stride()}")
        _check("U", U, dev, D.dtype, (N,))
        _check("real", real, dev, torch.int32, (N,))
        _check("log_ids", log_ids, dev, torch.int32, (N - 2, 2))
        _check("log_bl", log_bl, dev, D.dtype, (N - 2, 2))
        if N >= 2**31 // 4:
            raise ValueError(f"N = {N} too large for the kernels' ids")
        self.N, self.ld, self.half = N, ld, bool(half)
        self.flat = torch.zeros(1, dtype=torch.int64, device=dev)
        self.pair = torch.zeros(2, dtype=torch.float64, device=dev)
        self._part_v = torch.empty(MAX_PARTIALS, dtype=D.dtype, device=dev)
        self._part_i = torch.empty(MAX_PARTIALS, dtype=torch.int64,
                                   device=dev)
        # nj_update's partials, one a block, and the slot of column last
        self._part_u = torch.empty(-(-N // THREADS) + 2, dtype=torch.float64,
                                   device=dev)
        # the two tickets, zero; each launch leaves its own at zero
        self._tickets = torch.zeros(2, dtype=torch.int32, device=dev)
        self._keep = (D, U, real, log_ids, log_bl)
        self._q_lib = load("nj_q_argmin", _Q_ARGS)
        self._u_lib = load("nj_update", _UPDATE_ARGS)
        self._q, self._update = self._q_lib.nj_q_argmin, self._u_lib.nj_update
        # the launches' arguments that stay the same from step to step
        tickets = self._tickets.data_ptr()
        self._flat_ptr = self.flat.data_ptr()
        self._pair_ptr = self.pair.data_ptr()
        self._q_state = (D.data_ptr(), ld, U.data_ptr())
        self._q_scratch = (self._part_v.data_ptr(), self._part_i.data_ptr(),
                           tickets, self._flat_ptr)
        self._u_state = (D.data_ptr(), ld, U.data_ptr(), real.data_ptr())
        self._u_scratch = (self._part_u.data_ptr(), tickets + 4)
        self._ids, self._bl = log_ids.data_ptr(), log_bl.data_ptr()
        self._bl_row = 2 * log_bl.element_size()
        self._tail = (int(D.dtype == torch.float64), dev.index,
                      torch.cuda.current_stream(dev).cuda_stream)

    def q_argmin(self, n: int, r0: int = 0, r1: int | None = None) -> None:
        """nj_q_argmin over the active [n, n] block, its flat index into
        `flat`: the whole block in the stepper's mode, or rows [r0, r1)
        (r1 given: a rank's share) in the full read, with the pair into
        `pair`."""
        global Q_ARGMIN_LAUNCHES, HALF_READ_LAUNCHES
        if n > self.N:
            raise ValueError(f"n = {n} exceeds N = {self.N}")
        share = r1 is not None
        half = self.half and not share
        r1 = n if r1 is None else r1
        rc = self._q(*self._q_state, n, r0, r1, int(half), *self._q_scratch,
                     self._pair_ptr if share else None, *self._tail)
        if rc:
            check_launch(self._q_lib, "nj_q_argmin", rc)
        Q_ARGMIN_LAUNCHES += 1
        HALF_READ_LAUNCHES += half

    def update(self, step: int, n: int, flat: torch.Tensor | None = None
               ) -> None:
        """nj_update for merge step `step` (n = N - step active nodes) at
        the flat index in `flat` (an int64 tensor on the card; default the
        last q_argmin's)."""
        global UPDATE_LAUNCHES
        if not 0 <= step < self.N - 2 or n != self.N - step:
            raise ValueError(f"step {step} with n = {n} active nodes: want "
                             f"0 <= step < {self.N - 2}, n = N - step")
        if flat is None:
            fp = self._flat_ptr
        else:
            if flat.device != self.flat.device or flat.dtype != torch.int64:
                raise ValueError(f"flat must be int64 on {self.flat.device}, "
                                 f"got {flat.dtype} on {flat.device}")
            fp = flat.data_ptr()
        rc = self._update(*self._u_state, fp, self._ids + 8 * step,
                          self._bl + self._bl_row * step, *self._u_scratch,
                          n, self.N + step, *self._tail)
        if rc:
            check_launch(self._u_lib, "nj_update", rc)
        UPDATE_LAUNCHES += 1
