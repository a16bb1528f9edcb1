"""Device selection shared by the port's entry points."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. With no ``device`` and no CUDA card this raises; it never
    carries on quietly on the CPU.

    On a CUDA device it also turns TF32 off for matrix products and cuDNN:
    a float32 product then runs in full float32, as the reference computes
    it, instead of keeping about three decimal digits."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def to_device(array, device: torch.device) -> torch.Tensor:
    """A host (numpy) array as a tensor on ``device``, without a stream
    sync: a plain ``.to("cuda")`` from pageable memory waits for the
    stream to drain, so a CUDA copy goes through pinned memory,
    asynchronously. On the CPU the result is a copy of ``array``."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


def stream_sync(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream (nothing on
    the CPU, whose work is done when a call returns). A traced span calls
    this before stamping its end, so that the span covers the device work
    it launched; an untraced path never calls it."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def device_scope(device: torch.device):
    """A context that makes ``device`` the current CUDA device (nothing off
    CUDA). Work keyed by the current device, such as a kernel's
    shared-memory opt-in and ``kernels.tickets``' buffers, then lands on
    ``device``'s card."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)
