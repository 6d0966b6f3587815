"""Multi-process runs on torch.distributed: one process per rank, one
device per rank.

The JAX package joins processes into one runtime with jax.distributed
(dipper_tpu/parallel/distributed.py) and lets GSPMD and shard_map insert
the collectives. Here every process is a rank of a torch.distributed
group, builds on the device that `rank_device` gives it, and calls its
collectives itself (parallel/sharded.py).

- init_distributed(): joins the default group (gloo, through a TCP store
  at the coordinator's HOST:PORT, or any torch init URL such as
  file://PATH) with the DIPPER_COORDINATOR / DIPPER_NUM_PROCESSES /
  DIPPER_PROCESS_ID fallbacks; does nothing without them. The rendezvous
  and every collective time out after TIMEOUT.
- is_primary(): rank 0, or a process outside any group: the one writer.
- to_host(x, src): rank src's tensors as numpy arrays on every rank.
- rank_device(device): cuda:(rank % device_count), or the CPU when the
  caller asked for it.
- collective_backend(device, n): NCCL only when each of the first n ranks
  has a card of its own (NCCL refuses two ranks on one device), else
  gloo, decided by exchanging the cards' UUIDs over the default group.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from dipper_tpu_torch.utils.device import resolve_device

# rendezvous and collective timeout: a rank that hangs fails the others
# after this long instead of holding them forever
TIMEOUT = datetime.timedelta(seconds=900)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     timeout: datetime.timedelta = TIMEOUT):
    """Joins (or starts) a multi-process group. A no-op when neither the
    arguments nor the DIPPER_* environment variables name one. Returns
    (process_id, num_processes)."""
    coordinator = coordinator or os.environ.get("DIPPER_COORDINATOR")
    if num_processes is None and os.environ.get("DIPPER_NUM_PROCESSES"):
        num_processes = int(os.environ["DIPPER_NUM_PROCESSES"])
    if process_id is None and os.environ.get("DIPPER_PROCESS_ID"):
        process_id = int(os.environ["DIPPER_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        return 0, 1
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs a coordinator, the number of "
            "processes and this process's id (--coordinator, "
            "--num-processes, --process-id or DIPPER_COORDINATOR, "
            "DIPPER_NUM_PROCESSES, DIPPER_PROCESS_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, "
                         f"{num_processes})")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group("gloo", init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def world() -> tuple[int, int]:
    """(rank, size) of this process in the default group; (0, 1)
    outside one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    return world()[0] == 0


def rank_device(device) -> torch.device:
    """The device this rank builds on: the CPU if `device` is the CPU;
    for CUDA without an index, card rank % device_count (made the
    current device), so that ranks on one host spread over its cards and
    ranks beyond the cards share them. Asking for CUDA without it
    raises."""
    dev = resolve_device(device) if isinstance(device, str) else device
    if dev.type != "cuda":
        return dev
    resolve_device("cuda")
    if dev.index is None:
        dev = torch.device("cuda", world()[0] % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def collective_backend(device: torch.device, n: int) -> str:
    """'nccl' when `device` is a card and the first n ranks each hold a
    different one, else 'gloo'. Every rank of the default group calls
    this (it exchanges the cards' UUIDs over that group)."""
    key = (str(torch.cuda.get_device_properties(device).uuid)
           if device.type == "cuda" else "cpu")
    keys = [None] * world()[1]
    dist.all_gather_object(keys, key)
    return backend_for(keys[:n])


def backend_for(keys) -> str:
    """The backend for ranks on the devices named by `keys` (a card's
    UUID, or "cpu"): NCCL only for cards that are all different."""
    if "cpu" in keys or len(set(keys)) < len(keys):
        return "gloo"
    return "nccl"


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    return x


def to_host(x, src: int = 0):
    """Rank src's `x` (a tensor, or a tuple or list of them) as numpy
    arrays on every rank; the other ranks' `x` is not read. Outside a
    group, `x` itself brought to the host."""
    rank, size = world()
    if size == 1:
        return _host(x)
    box = [_host(x) if rank == src else None]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def free_port() -> int:
    """A TCP port that is free on localhost now (for a local group's
    coordinator)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


__all__ = ["TIMEOUT", "init_distributed", "world", "is_primary",
           "rank_device", "collective_backend", "backend_for", "to_host",
           "free_port"]
