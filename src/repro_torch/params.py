"""Model parameters: a flat ``{path: tensor}`` dict whose keys are the JAX
pytree's paths joined by ``/`` (the keys of the reference's ``arrays.npz``
checkpoints), with every block leaf stacked over ``num_blocks`` on its
leading axis, as in ``repro/models/transformer.py:98-121``:

  embed (V, D), or (K, V, D) for K codebooks (musicgen)
  final_norm (D,)
  lm_head (D, V·K)   unless tied: a config whose ``tie_embeddings`` holds
                     and whose embedding is ``"token"`` reads embed.T
                     (qwen2-vl's ``"vlm"`` embedding keeps its own head)
  w_proj (d_vision, D)                    [the vision stub's projector]
  blocks/p{i}/ln1, ln2                    (nb, D)
  blocks/p{i}/mixer/wq, wk, wv            (nb, D, H·hd | K·hd)
  blocks/p{i}/mixer/wo                    (nb, H·hd, D)
  blocks/p{i}/mixer/q_norm, k_norm        (nb, hd)     [qk_norm]
  an MLP ffn (``MLPSpec``):
  blocks/p{i}/ffn/w_up, w_gate            (nb, D, F)  [w_gate if gated]
  blocks/p{i}/ffn/w_down                  (nb, F, D)
  a mixture-of-experts ffn (``MoESpec``, ``repro/models/moe.py:24-38``):
  blocks/p{i}/ffn/w_router                (nb, D, E)  f32 whatever the dtype
  blocks/p{i}/ffn/w_gate, w_up            (nb, E, D, F)
  blocks/p{i}/ffn/w_down                  (nb, E, F, D)
  blocks/p{i}/ffn/shared/w_gate, w_up     (nb, D, S·F)  [num_shared S > 0]
  blocks/p{i}/ffn/shared/w_down           (nb, S·F, D)
  a Mamba-2 mixer (``SSMSpec``, ``repro/models/ssm.py:22-41``; di =
  d_inner, N = d_state, H = n_heads, W = conv_width, C = di + 2N):
  blocks/p{i}/mixer/w_z, w_x              (nb, D, di)
  blocks/p{i}/mixer/w_B, w_C              (nb, D, N)
  blocks/p{i}/mixer/w_dt                  (nb, D, H)
  blocks/p{i}/mixer/dt_bias, A_log, D     (nb, H)      f32 whatever the dtype
  blocks/p{i}/mixer/conv_w                (nb, W, C)
  blocks/p{i}/mixer/conv_b                (nb, C)
  blocks/p{i}/mixer/norm                  (nb, di)
  blocks/p{i}/mixer/w_out                 (nb, di, D)
  a layer without an ffn (mamba2) has no ln2 and no ffn leaves.

Weights keep the ``x @ W`` layout, W (d_in, d_out), so nothing is
transposed on the way across.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from repro_torch.configs.base import (ArchConfig, AttnSpec, MLPSpec, MoESpec,
                                      SSMSpec)
from repro_torch.training.optimizer import AdamWState

# leaves kept in f32 whatever the model's dtype: the router, whose logits
# the reference computes in f32 (``moe.py:30``), and the SSM's step bias,
# decay and skip, which it initialises in f32 (``ssm.py:34-36``)
F32_LEAVES = ("ffn/w_router", "mixer/dt_bias", "mixer/A_log", "mixer/D")


def _ssm_specs(specs: dict, p: str, nb: int, d: int, m: SSMSpec) -> None:
    """A Mamba-2 mixer's leaves, the reference's shapes and scales."""
    di, n, h = m.d_inner, m.d_state, m.n_heads
    s_in = 1.0 / math.sqrt(d)
    specs[p + "mixer/w_z"] = ((nb, d, di), s_in)
    specs[p + "mixer/w_x"] = ((nb, d, di), s_in)
    specs[p + "mixer/w_B"] = ((nb, d, n), s_in)
    specs[p + "mixer/w_C"] = ((nb, d, n), s_in)
    specs[p + "mixer/w_dt"] = ((nb, d, h), s_in)
    specs[p + "mixer/dt_bias"] = ((nb, h), 0.0)
    specs[p + "mixer/A_log"] = ((nb, h), 0.0)  # A = -exp(A_log) = -1
    specs[p + "mixer/D"] = ((nb, h), None)
    specs[p + "mixer/conv_w"] = ((nb, m.conv_width, di + 2 * n),
                                 1.0 / math.sqrt(m.conv_width))
    specs[p + "mixer/conv_b"] = ((nb, di + 2 * n), 0.0)
    specs[p + "mixer/norm"] = ((nb, di), None)
    specs[p + "mixer/w_out"] = ((nb, di, d), 1.0 / math.sqrt(di))


def param_specs(cfg: ArchConfig) -> dict:
    """``{key: (shape, init scale)}``; a scale of None means ones (norms),
    0.0 zeros (the SSM's biases and ``A_log``). The scales are the
    reference's: embed and head ×0.02, projections ×1/√d_in
    (``layers.py:658-672,775-783``, ``ssm.py:22-41``, ``transformer.py:
    101-113`` for the codebook embedding, the projector and the head)."""
    d, v, nb = cfg.d_model, cfg.vocab_size, cfg.num_blocks
    k = cfg.num_codebooks
    specs = {"embed": ((k, v, d) if cfg.embed == "musicgen" else (v, d),
                       0.02)}
    if cfg.embed == "vlm":
        specs["w_proj"] = ((cfg.d_vision, d), 1.0 / math.sqrt(cfg.d_vision))
    specs["final_norm"] = ((d,), None)
    if not (cfg.tie_embeddings and cfg.embed == "token"):
        specs["lm_head"] = ((d, v * k), 0.02)
    for i, ls in enumerate(cfg.pattern):
        m, f = ls.mixer, ls.ffn
        if not isinstance(m, (AttnSpec, SSMSpec)) or not (
                f is None or isinstance(f, (MLPSpec, MoESpec))):
            raise NotImplementedError(f"{cfg.name}: only attention or "
                                      f"Mamba-2 mixers with an MLP, a "
                                      f"mixture of experts or no ffn are "
                                      f"ported")
        p = f"blocks/p{i}/"
        specs[p + "ln1"] = ((nb, d), None)
        if isinstance(m, SSMSpec):
            _ssm_specs(specs, p, nb, d, m)
        else:
            hq, hk = m.num_heads * m.head_dim, m.num_kv_heads * m.head_dim
            specs[p + "mixer/wq"] = ((nb, d, hq), 1.0 / math.sqrt(d))
            specs[p + "mixer/wk"] = ((nb, d, hk), 1.0 / math.sqrt(d))
            specs[p + "mixer/wv"] = ((nb, d, hk), 1.0 / math.sqrt(d))
            specs[p + "mixer/wo"] = ((nb, hq, d), 1.0 / math.sqrt(hq))
            if m.qk_norm:
                specs[p + "mixer/q_norm"] = ((nb, m.head_dim), None)
                specs[p + "mixer/k_norm"] = ((nb, m.head_dim), None)
        if f is None:
            continue
        specs[p + "ln2"] = ((nb, d), None)
        if isinstance(f, MoESpec):
            e, ff = f.num_experts, f.d_ff
            specs[p + "ffn/w_router"] = ((nb, d, e), 1.0 / math.sqrt(d))
            specs[p + "ffn/w_gate"] = ((nb, e, d, ff), 1.0 / math.sqrt(d))
            specs[p + "ffn/w_up"] = ((nb, e, d, ff), 1.0 / math.sqrt(d))
            specs[p + "ffn/w_down"] = ((nb, e, ff, d), 1.0 / math.sqrt(ff))
            if f.num_shared:
                sf = f.num_shared * ff
                specs[p + "ffn/shared/w_up"] = ((nb, d, sf), 1.0 / math.sqrt(d))
                specs[p + "ffn/shared/w_gate"] = ((nb, d, sf),
                                                  1.0 / math.sqrt(d))
                specs[p + "ffn/shared/w_down"] = ((nb, sf, d),
                                                  1.0 / math.sqrt(sf))
            continue
        specs[p + "ffn/w_up"] = ((nb, d, f.d_ff), 1.0 / math.sqrt(d))
        if f.gated:
            specs[p + "ffn/w_gate"] = ((nb, d, f.d_ff), 1.0 / math.sqrt(d))
        specs[p + "ffn/w_down"] = ((nb, f.d_ff, d), 1.0 / math.sqrt(f.d_ff))
    return specs


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Random parameters drawn on ``device`` from ``generator`` (which must
    live on that device), with the reference's shapes and scales. The draws
    differ from the reference's JAX PRNG: to serve the same weights as the
    reference, carry them across with :func:`from_jax_params`. Draws one
    matrix at a time (a block's, or a block's expert's), so the f32
    temporaries stay one matrix large; ``F32_LEAVES`` stay f32."""
    params = {}
    for key, (shape, scale) in param_specs(cfg).items():
        dt = torch.float32 if key.endswith(F32_LEAVES) else dtype
        if scale is None or scale == 0.0:
            fill = torch.ones if scale is None else torch.zeros
            params[key] = fill(shape, dtype=dt, device=device)
            continue
        t = torch.empty(shape, dtype=dt, device=device)
        parts = t.reshape(-1, *shape[-2:]).unbind(0) if len(shape) >= 3 \
            else (t,)
        for part in parts:
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=device) * scale)
        params[key] = t
    return params


def _flatten(tree, prefix: str = "") -> dict:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _to_tensor(a) -> torch.Tensor:
    """An array as a tensor, bit for bit. bf16 comes as ml_dtypes' numpy
    dtype, or as two-byte ``V2`` items: numpy has no bf16 of its own, so
    ``np.savez`` stores a bf16 array's bits as those
    (``training/checkpoint.py``)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def from_jax_params(tree, device=None) -> dict:
    """The reference's parameter pytree (nested dicts of numpy-convertible
    arrays) → the port's flat dict, bit for bit."""
    return {k: _to_tensor(v).to(device) for k, v in _flatten(tree).items()}


def to_jax_params(params: dict) -> dict:
    """The port's flat dict → the reference's nested layout as numpy
    arrays, bit for bit (bf16 needs numpy's ``bfloat16`` dtype, which the
    ``ml_dtypes`` package registers)."""
    tree: dict = {}
    for key, t in params.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            a = t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
        else:
            a = t.numpy().copy()
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def from_jax_opt_state(state, device=None):
    """The reference's ``AdamWState`` (``mu``, ``nu`` pytrees shaped as the
    parameters, ``count``) → the port's
    :class:`~repro_torch.training.optimizer.AdamWState`, bit for bit."""
    mu, nu, count = state
    return AdamWState(from_jax_params(mu, device), from_jax_params(nu, device),
                      _to_tensor(count).to(device, torch.int32))


def to_jax_opt_state(state) -> tuple:
    """The port's ``AdamWState`` → ``(mu, nu, count)`` as numpy, nested as
    the reference's: ``repro.training.optimizer.AdamWState(*result)`` is
    the reference's state, bit for bit."""
    mu, nu, count = state
    return (to_jax_params(mu), to_jax_params(nu),
            np.asarray(count.detach().cpu().numpy(), np.int32))


def load_npz_checkpoint(path: str, device=None) -> dict:
    """Parameters of a checkpoint of either package
    (``training/checkpoint.py`` format), read from its ``arrays.npz`` with
    numpy alone; ``path`` is the
    checkpoint directory or the ``.npz`` file. ``meta.msgpack`` holds
    nothing the arrays lack and is not read."""
    if os.path.isdir(path):
        path = os.path.join(path, "arrays.npz")
    with np.load(path) as data:
        return {k: _to_tensor(data[k]).to(device) for k in data.files}
