"""Mamba-2 SSD (state-space duality) layers [arXiv:2405.21060] (port of
``repro/models/ssm.py``).

Prefill runs the chunked SSD at ``spec.chunk``: the intra-chunk quadratic
term, then the inter-chunk recurrence over the chunk summaries (one step a
chunk, not a token). Decode runs the O(1) single-step recurrence. Both
compute in f32, the causal depthwise conv in x's dtype and the softplus of
``dt`` in f32, as the reference does.

The reference's module reaches no Pallas kernel, so this one is plain
PyTorch and launches no kernel of its own: its projections go through
``layers.matmul``, which takes the split edge's integer codes to the
integer-weight kernel K7; the edge's quantized ``conv_w`` is used as its
dequantized values, as the reference fake-quantizes it.

Shapes: x (B, S, H, P); dt (B, S, H); A (H,); B/C (B, S, N) (one group,
broadcast over heads); state (B, H, P, N); conv state (B, W - 1, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QuantizedTensor
from repro_torch.models.layers import matmul, rms_norm


def _depthwise_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    conv_state: torch.Tensor | None):
    """Causal depthwise conv over the sequence, then SiLU. xbc (B, S, C);
    w (W, C); ``conv_state`` (B, W - 1, C) holds the previous inputs (None:
    zeros). Returns (out (B, S, C), new state: the last W - 1 inputs)."""
    width, s = w.shape[0], xbc.shape[1]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[-1]))
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)  # (B, S + W - 1, C)
    # the reference's order: 0 + tap 0 + tap 1 + ..., then the bias
    out = full[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + full[:, i:i + s] * w[i]
    out = out + b
    return F.silu(out), full[:, -(width - 1):]


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int, initial_state=None):
    """Chunked SSD over x (B, S, H, P). Returns (y (B, S, H, P) f32,
    final state (B, H, P, N) f32)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    xc = x.reshape(bsz, nc, q, h, p).float()
    dtc = dt.reshape(bsz, nc, q, h).float()
    bc = b_mat.reshape(bsz, nc, q, n).float()
    cc = c_mat.reshape(bsz, nc, q, n).float()

    da = dtc * a  # (B, nc, q, H): each step's log decay (A < 0)
    cs = torch.cumsum(da, dim=2)  # inclusive, within the chunk

    # intra-chunk: scores[i, j] = (C_i · B_j) exp(cs_i - cs_j) dt_j, i >= j
    cb = torch.einsum("bzin,bzjn->bzij", cc, bc)  # (B, nc, q, q)
    decay = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B, nc, i, j, H)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    mask = mask[None, None, :, :, None]
    # above the diagonal decay > 0 and exp may overflow; the reference's
    # where(mask, exp(decay), 0) then gives 0·inf = NaN in the backward.
    # Masking the exponent first keeps the forward's bits and the grads
    # finite
    l_mat = torch.where(mask, torch.exp(torch.where(mask, decay, 0.0)),
                        decay.new_zeros(()))
    scores = cb[..., None] * l_mat * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bzijh,bzjhp->bzihp", scores, xc)
    del decay, l_mat, scores

    # chunk summaries S_z = sum_j exp(cs_last - cs_j) dt_j B_j (x) x_j,
    # then the recurrence over chunks
    last = cs[:, :, -1:, :]  # (B, nc, 1, H)
    w_j = torch.exp(last - cs) * dtc  # (B, nc, q, H)
    s_chunk = torch.einsum("bzjh,bzjn,bzjhp->bzhpn", w_j, bc, xc)
    chunk_decay = torch.exp(last[:, :, 0, :])  # (B, nc, H)
    if initial_state is None:
        state = x.new_zeros((bsz, h, p, n), dtype=torch.float32)
    else:
        state = initial_state.float()  # bf16 storage is fine
    states_in = []
    for z in range(nc):  # emit the state entering each chunk
        states_in.append(state)
        state = state * chunk_decay[:, z, :, None, None] + s_chunk[:, z]
    states_in = torch.stack(states_in, dim=1)  # (B, nc, H, P, N)

    # y_inter_i = exp(cs_i) C_i · S_in
    y_inter = torch.einsum("bzih,bzin,bzhpn->bzihp", torch.exp(cs), cc,
                           states_in)
    y = (y_intra + y_inter).reshape(bsz, nc * q, h, p)[:, :s]
    return y, state


def ssd_decode_step(x, dt, a, b_vec, c_vec, state):
    """One token: state' = exp(dt·A) state + dt (B (x) x); y = C · state'.
    x (B, H, P); dt (B, H); b_vec/c_vec (B, N); state (B, H, P, N)."""
    dec = torch.exp(dt * a)  # (B, H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, b_vec, x)
    new_state = state * dec[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", c_vec, new_state)
    return y, new_state


def ssm_layer(params, x: torch.Tensor, spec, *, conv_state=None,
              ssm_state=None, decode: bool = False):
    """A Mamba-2 block over x (B, S, D): (out (B, S, D), (new conv state,
    new SSM state f32)). ``decode=True`` takes one token (S = 1) through
    the recurrence."""
    bsz, s, _ = x.shape
    di, n, h = spec.d_inner, spec.d_state, spec.n_heads
    p = di // h
    z = matmul(x, params["w_z"])
    xbc = torch.cat([matmul(x, params["w_x"]), matmul(x, params["w_B"]),
                     matmul(x, params["w_C"])], dim=-1)
    conv_w = params["conv_w"]
    if isinstance(conv_w, QuantizedTensor):  # the split edge's codes
        conv_w = conv_w.dequantize(x.dtype)
    xbc, new_conv = _depthwise_conv(xbc, conv_w, params["conv_b"],
                                    conv_state)
    xs, bs, cs = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(matmul(x, params["w_dt"]).float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])  # (H,)
    xh = xs.reshape(bsz, s, h, p)
    if decode:
        if s != 1:
            raise ValueError(f"an SSM decode step takes one token, got {s}")
        state = ssm_state.float() if ssm_state is not None else x.new_zeros(
            (bsz, h, p, n), dtype=torch.float32)
        y, new_state = ssd_decode_step(xh[:, 0].float(), dt[:, 0], a,
                                       bs[:, 0].float(), cs[:, 0].float(),
                                       state)
        y = y[:, None]  # (B, 1, H, P)
    else:
        y, new_state = ssd_chunked(xh, dt, a, bs, cs, spec.chunk, ssm_state)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    return matmul(y, params["w_out"]), (new_conv, new_state)
