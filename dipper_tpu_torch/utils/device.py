"""Explicit device selection."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """'cuda' or 'cpu' (or any torch device string) -> torch.device.
    Asking for CUDA on a machine without it raises: the port never
    carries on on the CPU when the card was asked for."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available "
            "(pass --device cpu to run on the CPU)")
    return dev


def torch_dtype(dtype_name: str) -> torch.dtype:
    """'float32' or 'float64' (the CLI's --precision) -> torch.dtype."""
    if dtype_name not in ("float32", "float64"):
        raise ValueError(f"unsupported precision {dtype_name!r}")
    return getattr(torch, dtype_name)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
