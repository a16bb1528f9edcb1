"""Threshold Splitting, paper §2.3.1 Eq. 4, and the Eq. (7) recovery (port
of ``repro/core/ts.py``).

TS partitions the split-layer activation T into

  T_above = T ⊙ M   (|T| ≥ τ: few, accuracy-critical, kept exact)
  T_below = T ⊙ (1-M)

The carrier of T_above is a fixed-capacity (values, indices, count)
triple, as in the reference; the byte accounting uses the paper's CSR
formula. The whole encode (``below``, the carrier's top-``capacity``
selection and the outlier count) is kernel K6 (``kernels.ops.ts_encode``),
one launch a payload. When more than ``capacity`` entries exceed τ, only
the ``capacity`` largest stay in the carrier and the rest stay in
``below``, exactly as in the reference, with ties broken toward the lower
index as ``jax.lax.top_k`` breaks them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops


@dataclasses.dataclass
class SparseAbove:
    """Fixed-capacity sparse carrier for T_above."""

    values: torch.Tensor  # (capacity,) f32
    indices: torch.Tensor  # (capacity,) flat int64 indices; invalid = -1
    count: torch.Tensor  # () int32: every entry with |x| ≥ τ, uncapped
    shape: tuple  # the dense shape

    def csr_bytes(self, rows: int | None = None, value_bytes: int = 4) -> int:
        """Paper's CSR accounting: nnz·(value + colidx) + (rows+1)·rowptr,
        nnz capped at the capacity. Reads ``count`` back to the host."""
        if rows is None:
            rows = self.shape[0] if len(self.shape) > 1 else 1
        nnz = min(int(self.count), self.values.shape[0])
        return nnz * (value_bytes + 4) + (rows + 1) * 4


def split_dense(t: torch.Tensor, tau: float):
    """Eq. (4) in dense form: (T_above, T_below, M)."""
    m = (t.abs() >= tau).to(t.dtype)
    return t * m, t * (1.0 - m), m


def ts_encode(t: torch.Tensor, tau: float, capacity: int):
    """Threshold-split ``t`` (f32, any shape; the last axis is a row):
    returns (t_below f32, :class:`SparseAbove`). Keeps the ``capacity``
    largest-magnitude entries with |x| ≥ τ; on ties the lower flat index
    comes first. One launch of K6 on the card; makes no host sync."""
    below, values, indices, count = ops.ts_encode(
        t.reshape(-1, t.shape[-1]), tau, capacity)
    return below.reshape(t.shape), SparseAbove(values, indices, count,
                                               tuple(t.shape))


def ts_decode(above: SparseAbove) -> torch.Tensor:
    """Densify T_above (Eq. 7 on the cloud side)."""
    flat = torch.zeros(math.prod(above.shape), dtype=above.values.dtype,
                       device=above.values.device)
    ok = above.indices >= 0
    flat.index_add_(0, torch.where(ok, above.indices, 0),
                    torch.where(ok, above.values, 0.0))
    return flat.reshape(above.shape)


def reconstruct(below_dequant: torch.Tensor,
                above: SparseAbove) -> torch.Tensor:
    """Eq. (7): T̃ = dequant(T̂_below) + T_above (above slots overwrite)."""
    dense_above = ts_decode(above)
    return torch.where(dense_above != 0.0, dense_above, below_dequant)
