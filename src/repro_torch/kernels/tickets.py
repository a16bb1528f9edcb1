"""Zeroed int32 tickets for the kernels whose last block of a group adds
the group's partial results in a fixed order (K7's decode GEMV, K2, K1) or
finishes the call (K6), and the workspace for those partial results (K1's,
and K6's candidates).

A kernel takes a ticket per block with an atomic add; the block that takes
a group's last one merges the group and sets its ticket back to zero. So a
buffer is zero between calls and is zeroed once. Calls on one stream run
one after another; calls on two streams must not share tickets, so each
(device, stream) keeps its own buffer, replaced by a larger one when a
call needs more.

A call captured in a CUDA graph gets a buffer of its own instead, which is
never freed: the graph holds its address for every replay, so it must not
be handed to another tensor when an eager call outgrows the stream's
buffer, and two graphs replayed on different streams must not share it.
It is allocated (and zeroed) inside the capture; the kernel leaves it at
zero for the next replay.

A workspace is written and read back within one launch, so calls on one
stream can share one too (:func:`scratch`): each (device, stream) keeps
one, grown as tickets are. A captured call takes its workspace from the
graph's memory pool, as any tensor allocated inside the capture.
"""

from __future__ import annotations

import torch

# (device index, stream handle) -> int32 tickets, all zero between calls
_BUFFERS: dict = {}
# (device index, stream handle) -> f32 workspace, its contents undefined
_WORKSPACES: dict = {}
# the buffers of captured calls, held for the life of the process
_CAPTURED: list = []


def tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed tickets for a call on ``stream`` of
    ``device``: the stream's buffer, or a buffer of the call's own while
    the stream is captured into a CUDA graph."""
    with torch.cuda.device(device):
        return scratch(device, stream, n, 0)[0]


def scratch(device: torch.device, stream: int, n_tickets: int,
            n_floats: int) -> tuple:
    """(at least ``n_tickets`` zeroed tickets, a workspace of at least
    ``n_floats`` f32 or None for 0) for a call on ``stream`` of ``device``,
    which must be the current device: the stream's buffers, or buffers of
    the call's own while the stream is captured into a CUDA graph."""
    if torch.cuda.is_current_stream_capturing():
        t = torch.zeros(max(n_tickets, 1), dtype=torch.int32, device=device)
        _CAPTURED.append(t)
        w = torch.empty(n_floats, dtype=torch.float32, device=device) \
            if n_floats else None
        return t, w
    key = (device.index, stream)
    t = _BUFFERS.get(key)
    if t is None or t.numel() < n_tickets:
        t = _BUFFERS[key] = torch.zeros(max(n_tickets, 1024),
                                        dtype=torch.int32, device=device)
    if not n_floats:
        return t, None
    w = _WORKSPACES.get(key)
    if w is None or w.numel() < n_floats:
        w = _WORKSPACES[key] = torch.empty(n_floats, dtype=torch.float32,
                                           device=device)
    return t, w
