"""Model assembly (port of ``repro/models/transformer.py``): a decoder of
``len(pattern) × num_blocks`` layers whose parameters are stacked per
pattern position; a layer's mixer is attention or a Mamba-2 block
(:mod:`repro_torch.models.ssm`), its ffn a (gated) MLP, the
mixture-of-experts layer of :mod:`repro_torch.models.moe` for an
``MoESpec`` (routed with ``RuntimeOpts.moe_capacity_factor`` and
``moe_groups``; its auxiliary loss reaches :func:`forward_train` and is
dropped by the serving paths, as the reference's drop it), or none
(mamba2). The embedding is a token table, the sum of K codebook tables
(musicgen: tokens (B, S, K), logits (..., K, V)), or a token table whose
first ``num_patches`` rows the vision stub's projected patches replace
(qwen2-vl); positions are RoPE, M-RoPE (qwen2-vl's three-axis ids),
sinusoidal (added to the embedding) or none.
Entry points:

  forward_train(params, cfg, tokens, patches, opts)  → (logits, aux)
  prefill(params, cfg, tokens, cache_len, opts, patches)
                                                     → (last_logits, caches)
  decode_step(params, cfg, tokens, caches, pos, opts)→ (logits, caches)

and, over the paged pool (``serving.kv_pool.PagedKVPool.device_caches``):

  paged_prefill(params, cfg, tokens, caches, positions, opts)
  paged_prefill_shared(params, cfg, tokens, caches, positions, opts)
  paged_decode_step(params, cfg, tokens, caches, pos, opts)
  paged_verify_step(params, cfg, tokens, caches, positions, opts)
  packed_step(params, cfg, tokens, caches, positions, slots, logit_rows,
              opts, quant_rows)

and :func:`sharded_step_fns`, those five over a ``("kv", "model")``
serving mesh (``launch.mesh.make_serving_mesh``).

``caches`` is a list with one entry per layer, in depth order (the
reference stacks them over blocks instead): a ``KVCache`` (or
``PagedKVCache``) for an attention layer, a ``(conv_state, ssm_state)``
pair for a Mamba-2 layer (the paged pool refuses those). Every serving
entry point writes the caches in place; an SSM state is stored back in
its own dtypes (``RuntimeOpts.cache_dtype`` for the conv state,
``ssm_state_dtype`` for the recurrent state). Everything runs on the
device of ``tokens``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, AttnSpec, MoESpec
from repro_torch.core.quant import aiq, aiq_dequant
from repro_torch.kernels.decode_attention import padded_cache_len
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_layer, uncounted
from repro_torch.models.ssm import ssm_layer


@dataclasses.dataclass(frozen=True)
class RuntimeOpts:
    """Per-call knobs (the fields of the reference's ``RuntimeOpts`` that
    the ported path reads)."""

    q_chunk: int = 1024
    kv_chunk: int = 1024
    quantized_kv: bool = False
    cache_dtype: str = "bfloat16"
    moe_capacity_factor: float = 1.25  # <= 0: dropless routing
    # the MoE capacity rule's token groups (1: the whole call is one group)
    moe_groups: int = 1
    # the SSM recurrent state's storage dtype (compute stays f32): bf16
    # halves a Mamba layer's decode state
    ssm_state_dtype: str = "float32"
    # route continuation chunks and forks through kernel K3 and the packed
    # tick through K4; False takes the reference's plain routes instead
    # (the pool gathered dense into chunked_attention, K4's plain version):
    # the baseline the reference's chunked-prefill benchmark measures
    paged_prefill_kernel: bool = True
    # the uniform activation quantization baseline: every layer's output
    # through AIQ at this many bits per token and back (the paper's method
    # quantizes activations only at the split); None disables
    act_bits: int | None = None
    # recompute each block's activations in the backward pass
    # (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` over
    # its block scan); only :func:`forward_train` reads it
    remat: bool = True
    # split the paged attention routes' kv heads over the serving mesh's
    # "model" dim: head_axis is that dim's process group, head_shards its
    # size (which must divide num_kv_heads). Each rank walks the pages with
    # its own head group and an exact tiled all-gather puts the heads back
    # together (no reduction, so greedy argmaxes stay bit-identical).
    # Set by sharded_step_fns, never by callers directly
    head_axis: object = None
    head_shards: int = 1


def layer_params(cfg: ArchConfig, params: dict, blocks=None) -> list:
    """Per-layer ``(LayerSpec, nested param dict)`` in depth order: block
    ``i``'s slice of each stacked leaf (views, no copies), for the blocks
    ``range(*blocks)`` (default: all). A leaf may be a
    ``core.quant.QuantizedTensor``, whose block slice is its codes' and
    scales' slice."""
    out = []
    for i in range(*(blocks or (0, cfg.num_blocks))):
        out += block_layers(cfg, params, lambda key, t: t[i])
    return out


def block_layers(cfg: ArchConfig, params: dict, pick) -> list:
    """One block's ``(LayerSpec, nested param dict)`` per pattern
    position: each ``blocks/`` leaf through ``pick(key, leaf)``, which
    gives that block's tensor."""
    out = []
    for pi, ls in enumerate(cfg.pattern):
        p: dict = {}
        prefix = f"blocks/p{pi}/"
        for key, t in params.items():
            if key.startswith(prefix):
                node = p
                *parents, leaf = key[len(prefix):].split("/")
                for name in parents:
                    node = node.setdefault(name, {})
                node[leaf] = pick(key, t)
        out.append((ls, p))
    return out


# ---------------------------------------------------------------------------
# Caches, positions, embedding and head
# ---------------------------------------------------------------------------


def init_caches(cfg: ArchConfig, batch: int, cache_len: int,
                opts: RuntimeOpts, device=None, num_blocks=None) -> list:
    """One empty cache per layer of ``num_blocks`` blocks (default: all),
    sized per pattern position as the reference sizes them: a
    sliding-window layer's ring holds ``min(cache_len, window)`` slots, a
    full layer ``cache_len``. Quantized caches take the kernel's
    kv-head-major int8 layout with that slot count rounded by
    ``padded_cache_len`` (pad slots keep pos = -1; a ring wraps within its
    window). A Mamba-2 layer gets zeros ``(conv_state (B, W - 1, d_inner +
    2 d_state) in cache_dtype, ssm_state (B, H, P, N) in
    ssm_state_dtype)``, whatever ``cache_len``."""
    caches = []
    for _ in range(cfg.num_blocks if num_blocks is None else num_blocks):
        for ls in cfg.pattern:
            m = ls.mixer
            if not isinstance(m, AttnSpec):
                conv_ch = m.d_inner + 2 * m.d_state
                caches.append((
                    torch.zeros((batch, m.conv_width - 1, conv_ch),
                                dtype=getattr(torch, opts.cache_dtype),
                                device=device),
                    torch.zeros((batch, m.n_heads, m.d_inner // m.n_heads,
                                 m.d_state),
                                dtype=getattr(torch, opts.ssm_state_dtype),
                                device=device)))
                continue
            size = min(cache_len, m.sliding_window or cache_len)
            if opts.quantized_kv:
                size = padded_cache_len(size)
            caches.append(L.init_cache(batch, size, m.num_kv_heads,
                                       m.head_dim,
                                       getattr(torch, opts.cache_dtype),
                                       opts.quantized_kv, device))
    return caches


def make_positions(cfg: ArchConfig, b: int, s: int, device=None):
    """Sequence-order positions (B, S) int32."""
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def make_mrope_positions(cfg: ArchConfig, positions: torch.Tensor):
    """Qwen2-VL's M-RoPE ids (3, B, S) from sequence positions (B, S)
    (the reference's ``make_mrope_positions``). The first ``num_patches``
    positions are the patches of a √P × √P grid: t = 0 and (h, w) their
    grid cell. Text continues past the grid: all three ids are
    ``p - P + √P``. The ids depend only on the absolute position, so
    prefill and decode agree. A pad's position -1 counts as a patch, at
    cell (√P - 1, √P - 1): floor division and a non-negative remainder, as
    jnp's ``//`` and ``%`` give them."""
    p = cfg.num_patches
    grid = max(math.isqrt(max(p, 1)), 1)
    is_patch = positions < p
    text = positions - p + grid
    rows = torch.div(positions, grid, rounding_mode="floor")
    return torch.stack([
        torch.where(is_patch, torch.zeros_like(text), text),
        torch.where(is_patch, torch.remainder(rows, grid), text),
        torch.where(is_patch, torch.remainder(positions, grid), text)])


def rope_tables(cfg: ArchConfig, positions: torch.Tensor):
    """(cos, sin) for the pattern's attention head_dim, or None when the
    config has no attention layer or no rotary positions (``rope="none"``:
    jamba, mamba2; ``"sinusoidal"``: musicgen, whose positions are added
    to the embedding). M-RoPE (qwen2-vl) gives per-row tables (B, S,
    hd/2) from :func:`make_mrope_positions`."""
    attn = [ls.mixer for ls in cfg.pattern if isinstance(ls.mixer, AttnSpec)]
    if not attn or cfg.rope in ("none", "sinusoidal"):
        return None
    hd = attn[0].head_dim
    if cfg.rope == "mrope":
        return L.mrope_tables(make_mrope_positions(cfg, positions), hd,
                              cfg.mrope_sections, cfg.rope_theta)
    return L.rope_table(positions, hd, cfg.rope_theta)


def embed_inputs(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                 patches: torch.Tensor | None = None,
                 positions: torch.Tensor | None = None):
    """The embedded inputs (B, S, D) in the embedding's dtype (the
    reference's ``embed_inputs``). ``tokens`` are (B, S) ids, or (B, S, K)
    on a codebook config (musicgen), whose K embeddings are summed in
    codebook order. On the vision stub (``embed="vlm"``) ``patches``
    (B, P, d_vision) are projected by ``w_proj`` and replace the first
    ``num_patches`` rows. With ``embed_scale`` (gemma) the result is
    multiplied by √d_model, rounded to its dtype first as the reference's
    weakly typed product is; with sinusoidal positions (musicgen) the
    embedding of ``positions`` (B, S), cast to that dtype, is added
    last."""
    emb = params["embed"]
    if cfg.embed == "musicgen":
        x = F.embedding(tokens[..., 0], emb[0])
        for k in range(1, cfg.num_codebooks):
            x = x + F.embedding(tokens[..., k], emb[k])
    else:
        x = F.embedding(tokens, emb)
    if cfg.embed == "vlm" and patches is not None:
        proj = patches.to(x.dtype) @ params["w_proj"]  # (B, P, D)
        x = torch.cat([proj, x[:, cfg.num_patches:]], dim=1)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if cfg.rope == "sinusoidal" and positions is not None:
        x = x + L.sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
    return x


def apply_head(cfg: ArchConfig, params: dict, x: torch.Tensor):
    """Final norm and head (the embedding's transpose when tied); the
    logits are f32, soft-capped by ``final_softcap`` (gemma2), and on a
    codebook config (..., K, V)."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["lm_head"] if "lm_head" in params else params["embed"].T
    logits = L.soft_cap((x @ w).float(), cfg.final_softcap)
    if cfg.num_codebooks > 1:
        logits = logits.reshape(*logits.shape[:-1], cfg.num_codebooks,
                                cfg.vocab_size)
    return logits


# ---------------------------------------------------------------------------
# Layers and entry points
# ---------------------------------------------------------------------------


def _apply_layer(cfg, ls, p, x, *, rope_cs, q_positions, cache, pos,
                 opts: RuntimeOpts, decode: bool, attend_cache: bool = False,
                 packed: L.PackedLayout | None = None, data=None):
    """One layer over x: (x, cache, the MoE layer's auxiliary loss, a 0-d
    f32 tensor, or None without one). ``cache`` may be None (training): an
    attention layer then attends the fresh k/v, a Mamba-2 layer starts
    from zero states and keeps none. ``data``: :func:`forward_train`'s."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    aux = None
    if isinstance(ls.mixer, AttnSpec):
        out, cache = L.attention_layer(
            p["mixer"], h, ls.mixer, rope_cs=rope_cs, cache=cache, pos=pos,
            q_positions=q_positions, q_chunk=opts.q_chunk,
            kv_chunk=opts.kv_chunk, decode=decode, attend_cache=attend_cache,
            packed=packed, prefill_kernel=opts.paged_prefill_kernel,
            head_axis=opts.head_axis, head_shards=opts.head_shards)
    else:
        conv_state, ssm_state = cache if cache is not None else (None, None)
        out, (conv, state) = ssm_layer(p["mixer"], h, ls.mixer,
                                       conv_state=conv_state,
                                       ssm_state=ssm_state, decode=decode)
        if cache is not None:  # stored back in the caches' dtypes
            conv_state.copy_(conv)
            ssm_state.copy_(state)
    x = x + out
    if ls.ffn is not None:  # else a mixer-only layer (mamba2)
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if isinstance(ls.ffn, MoESpec):
            out, aux = moe_layer(p["ffn"], h, ls.ffn, opts.moe_capacity_factor,
                                 opts.moe_groups, data=data)
        else:
            out = L.mlp_layer(p["ffn"], h, ls.ffn.activation)
        x = x + out
    if opts.act_bits is not None:
        x = _fake_quant_tokens(x, opts.act_bits)
    return x, cache, aux


def _fake_quant_tokens(x: torch.Tensor, bits: int) -> torch.Tensor:
    """AIQ per token at ``bits`` and back (``RuntimeOpts.act_bits``), over
    the (tokens, D) f32 view, cast back to x's dtype."""
    flat = x.reshape(-1, x.shape[-1]).float()
    codes, s, z = aiq(flat, bits, dim=-1)
    return aiq_dequant(codes, s, z).reshape(x.shape).to(x.dtype)


def _apply_layers(cfg, params, x, caches, *, q_positions, pos,
                  opts: RuntimeOpts, decode: bool, attend_cache: bool = False,
                  packed: L.PackedLayout | None = None, blocks=None):
    """Run the layers of the blocks ``range(*blocks)`` (default: all) over
    ``x``; ``caches`` holds one cache per layer of those blocks."""
    rope_cs = rope_tables(cfg, q_positions)
    for li, (ls, p) in enumerate(layer_params(cfg, params, blocks)):
        x, caches[li], _ = _apply_layer(
            cfg, ls, p, x, rope_cs=rope_cs, q_positions=q_positions,
            cache=caches[li], pos=pos, opts=opts, decode=decode,
            attend_cache=attend_cache, packed=packed)
    return x


def _train_block(cfg, params, gather, i, x, aux, rope_cs, positions, opts,
                 data):
    """Block i's layers with no cache, its leaves through ``gather``:
    (x, aux plus their MoE aux losses, summed in layer order as the
    reference's scan body sums them)."""
    for ls, p in block_layers(cfg, params, lambda key, t: gather(key, t, i)):
        x, _, a = _apply_layer(cfg, ls, p, x, rope_cs=rope_cs,
                               q_positions=positions, cache=None, pos=None,
                               opts=opts, decode=False, data=data)
        if a is not None:  # the reference adds an exact 0 here
            aux = aux + a
    return x, aux


def _counted_once(fn):
    """``fn`` whose calls after the first (a checkpoint's recompute) run
    under ``moe.uncounted()``."""
    calls = []

    def run(*args):
        calls.append(None)
        if len(calls) == 1:
            return fn(*args)
        with uncounted():
            return fn(*args)

    return run


def _whole(key: str, t: torch.Tensor, block: int | None = None):
    """:func:`forward_train`'s default gather: the leaf, or its block."""
    return t if block is None else t[block]


def forward_train(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                  patches: torch.Tensor | None = None,
                  opts: RuntimeOpts = RuntimeOpts(), gather=None, data=None):
    """The training forward (the reference's ``forward_train``): every
    position of ``tokens`` (B, S), or (B, S, K) on a codebook config,
    through every block with no cache; returns (logits (B, S, V) f32, or
    (B, S, K, V), the summed MoE auxiliary loss, a 0-d f32 tensor).
    ``patches`` feed the vision stub as in :func:`prefill`. With
    ``opts.remat`` each block runs under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward pass, where ``moe.STATS``
    do not count its MoE layers again. Differentiable in ``params``.

    ``gather(key, leaf, block=None)`` turns a leaf of ``params`` into the
    whole tensor, or into block ``block``'s slice of a stacked leaf, at
    its use (default: the leaf itself, or its slice). On a training mesh
    it gathers a rank's block of the leaf (``launch.sharding``): block
    i's leaves inside block i's ``checkpoint`` region, so that under
    remat they are gathered again in the backward pass instead of being
    kept, and ``embed``, ``w_proj``, ``final_norm`` and ``lm_head`` where
    they are read. ``data`` (a tuple of ``launch.collectives.Axis``) says
    that ``tokens`` are this rank's rows of a microbatch split over those
    dims, for the MoE layers (``moe.moe_layer``)."""
    gather = gather or _whole
    b, s = tokens.shape[:2]
    positions = make_positions(cfg, b, s, device=tokens.device)
    used = ("embed", "w_proj") if patches is not None else ("embed",)
    x = embed_inputs(cfg, {k: gather(k, params[k]) for k in used
                           if k in params}, tokens, patches, positions)
    rope_cs = rope_tables(cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(cfg.num_blocks):
        args = (cfg, params, gather, i, x, aux, rope_cs, positions, opts,
                data)
        if opts.remat:
            x, aux = checkpoint(_counted_once(_train_block), *args,
                                use_reentrant=False)
        else:
            x, aux = _train_block(*args)
    head = ("final_norm", "lm_head" if "lm_head" in params else "embed")
    return apply_head(cfg, {k: gather(k, params[k]) for k in head}, x), aux


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            cache_len: int | None = None, opts: RuntimeOpts = RuntimeOpts(),
            patches: torch.Tensor | None = None):
    """Process the prompt (B, S), or (B, S, K) on a codebook config:
    last-position logits (B, V) f32, (B, K, V) with codebooks, and the
    filled caches (``cache_len`` slots, default S). ``patches``
    (B, num_patches, d_vision) feed the vision stub's projector
    (:func:`embed_inputs`)."""
    b, s = tokens.shape[:2]
    positions = make_positions(cfg, b, s, device=tokens.device)
    x = embed_inputs(cfg, params, tokens, patches, positions)
    caches = init_caches(cfg, b, cache_len or s, opts, tokens.device)
    x = _apply_layers(cfg, params, x, caches, q_positions=positions, pos=0,
                      opts=opts, decode=False)
    return apply_head(cfg, params, x[:, -1:])[:, 0], caches


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                caches: list, pos, opts: RuntimeOpts = RuntimeOpts()):
    """One autoregressive step: ``tokens`` (B, 1), or (B, 1, K) on a
    codebook config; ``pos`` the absolute position being written, a 0-d
    int32 tensor on the device (or an int). Writes the caches in place;
    returns (logits (B, V) f32, or (B, K, V), caches)."""
    b = tokens.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    positions = pos.reshape(1, 1).expand(b, 1)
    x = embed_inputs(cfg, params, tokens, None, positions)
    x = _apply_layers(cfg, params, x, caches, q_positions=positions, pos=pos,
                      opts=opts, decode=True)
    return apply_head(cfg, params, x)[:, 0], caches


# ---------------------------------------------------------------------------
# Paged (ragged) entry points
# ---------------------------------------------------------------------------


def _paged_forward(params, cfg, tokens, caches, positions, opts, *,
                   decode: bool, attend_cache: bool = False,
                   every_column: bool = False):
    positions = positions.to(torch.int32)
    x = embed_inputs(cfg, params, tokens, None, positions.clamp(min=0))
    x = _apply_layers(cfg, params, x, caches, q_positions=positions, pos=0,
                      opts=opts, decode=decode, attend_cache=attend_cache)
    if every_column:
        return apply_head(cfg, params, x), caches
    return apply_head(cfg, params, x[:, -1:])[:, 0], caches


def paged_prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                  caches: list, positions: torch.Tensor,
                  opts: RuntimeOpts = RuntimeOpts()):
    """Ragged prefill over the paged pool. ``tokens`` (R, S) are
    RIGHT-ALIGNED: each row's prompt piece fills the trailing columns, and
    left pads carry ``positions = -1`` (R, S), so the last column is every
    row's last token. Attention covers the call's own tokens only; the
    tokens are scattered into the pool pages of the block tables that
    ``caches`` carry. Returns (last-column logits (R, V) f32, caches)."""
    return _paged_forward(params, cfg, tokens, caches, positions, opts,
                          decode=False)


def paged_prefill_shared(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                         caches: list, positions: torch.Tensor,
                         opts: RuntimeOpts = RuntimeOpts()):
    """:func:`paged_prefill` for rows that start past position 0 (a
    continuation chunk, or a fork of a shared prefix): each row also
    attends the tokens already in its pool pages, below its first in-call
    position (``layers.paged_prefill_attention``, kernel K3)."""
    return _paged_forward(params, cfg, tokens, caches, positions, opts,
                          decode=False, attend_cache=True)


def paged_decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                      caches: list, pos: torch.Tensor,
                      opts: RuntimeOpts = RuntimeOpts()):
    """One ragged decode step over the paged pool: ``tokens`` (R, 1),
    ``pos`` (R,) int32 on the device, each row's position being written
    (-1 = a free slot: its write goes to the trash page and its attention
    gives zeros). Attention runs through kernel K2. Returns (logits (R, V)
    f32, caches)."""
    return _paged_forward(params, cfg, tokens, caches, pos[:, None], opts,
                          decode=True)


def paged_verify_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                      caches: list, positions: torch.Tensor,
                      opts: RuntimeOpts = RuntimeOpts()):
    """The speculative verify over the paged pool, :func:`paged_decode_step`
    for S tokens a row: each row carries its last emitted token and its
    draft burst, ``tokens``/``positions`` (R, S) RIGHT-ALIGNED (left pads
    at position -1 go to the trash page). Every layer writes the burst to
    the pool first; attention then reads every key, the burst included,
    back from the pool's int8 codes (kernel K2, one query row per
    column), as S sequential decode steps would: quantization is per
    token, so writing the burst at once stores the same codes. Fresh f32
    keys, as a prefill attends them, would differ from the sequential path
    at quantization scale and flip argmaxes. Returns (logits (R, S, V) f32,
    caches): column j is the target distribution after the row's tokens up
    to j (pad columns are garbage)."""
    return _paged_forward(params, cfg, tokens, caches, positions, opts,
                          decode=True, every_column=True)


def packed_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                caches: list, positions: torch.Tensor, slots: torch.Tensor,
                logit_rows: torch.Tensor, opts: RuntimeOpts = RuntimeOpts(),
                quant_rows: torch.Tensor | None = None):
    """ONE token-packed step over the paged pool: the whole scheduler tick,
    every decoding slot's next token and up to a budget of prefill-chunk
    tokens, as one flat batch.

    ``tokens``/``positions``/``slots`` are (1, T): a fixed ``token_budget``
    buffer laid out slot-major (each active slot one contiguous run, a
    length-1 run for a decode token), tail-padded with ``positions =
    slots = -1`` rows, whose writes go to the trash page and whose
    attention gives exact zeros. Attention runs through kernel K4
    (``layers.varlen_attention_layer``). ``logit_rows`` (R,) names the
    buffer row holding each slot's LAST token (any row for an absent slot:
    the scheduler never samples it); the head runs on those R rows only,
    so the logits are (R, V) f32.

    ``quant_rows`` (D,) int names the rows whose fresh self-keys are
    attended through the int8 round trip (the reference's ``quant_fresh``
    mask, as indices): the scheduler's decode rows, so they read their own
    key as a sequential decode step reads it back from the pool. The
    buffer's layout (each slot's first position and the varlen kernel's
    work list, :func:`layers.packed_layout`) is computed once here for
    every layer. Returns (logits (R, V) f32, caches)."""
    positions = positions.to(torch.int32)
    x = embed_inputs(cfg, params, tokens, None, positions.clamp(min=0))
    packed = L.packed_layout(positions, slots, caches[0].block_table.shape[0],
                             quant_rows)
    x = _apply_layers(cfg, params, x, caches, q_positions=positions, pos=0,
                      opts=opts, decode=False, packed=packed)
    xl = x[0].index_select(0, logit_rows.long())  # (R, D)
    return apply_head(cfg, params, xl), caches


# ---------------------------------------------------------------------------
# The sharded deployment
# ---------------------------------------------------------------------------


def sharded_step_fns(cfg: ArchConfig, opts: RuntimeOpts, mesh) -> dict:
    """The five paged entry points over a ``("kv", "model")`` serving mesh
    (``launch.mesh.make_serving_mesh``; port of the reference's
    ``sharded_step_fns``): ``{"prefill", "prefill_shared", "decode",
    "packed", "verify"}``, each with the signature of
    :func:`paged_prefill`, :func:`paged_prefill_shared`,
    :func:`paged_decode_step`, :func:`packed_step` and
    :func:`paged_verify_step`. Every rank of the mesh calls the same
    function with the same arguments (SPMD); ``caches`` are this rank's
    views of a mesh pool (``PagedKVPool(mesh=)``), whose leaves hold only
    the rank's page shard.

    Each call runs in three parts, all exact (pages and head outputs are
    moved, never reduced):

      1. every pool leaf is all-gathered over ``"kv"`` along its page axis,
         so the rank walks the whole pool with the replicated block tables;
      2. the step runs on the gathered pool, every dense part replicated
         and attention's kv heads split over ``"model"``
         (``RuntimeOpts.head_axis``: each rank's head group walks the
         pages, the groups' outputs are gathered back); the step writes the
         gathered pool in place, as every port step writes its pool;
      3. the rank's own page shard is copied back out of the gathered
         pool into its leaves.

    Sampling stays outside, on the replicated logits. Greedy streams are
    therefore bit-identical to the unsharded step functions'. Over a
    ``kv`` dim of one, parts 1 and 3 are the identity and are skipped.
    Raises ``ValueError`` when the ``model`` dim does not divide the
    kv-head count."""
    from repro_torch.launch.collectives import all_gather_tiled
    from repro_torch.launch.mesh import check_serving_mesh, mesh_coords

    check_serving_mesh(mesh)
    base_opts = opts
    coords = mesh_coords(mesh)
    kv_rank, kv_size, kv_group = coords["kv"]
    _, model_size, model_group = coords["model"]
    heads = {m.num_kv_heads for ls in cfg.pattern
             if isinstance(m := ls.mixer, AttnSpec)}
    if any(kh % model_size for kh in heads):
        raise ValueError(
            f"the mesh's 'model' dim {model_size} must divide num_kv_heads "
            f"{sorted(heads)} (make_serving_mesh only builds such meshes)")
    heads_kw = dict(head_axis=model_group, head_shards=model_size) \
        if model_size > 1 else {}

    def gathered(caches):
        if kv_size == 1:
            return caches
        return [L.PagedKVCache(*(all_gather_tiled(leaf, 0, kv_group)
                                 for leaf in (c.k, c.v, c.k_scale,
                                              c.v_scale, c.pos)),
                               c.block_table) for c in caches]

    def keep_own(caches, full):
        if full is caches:
            return
        for c, f in zip(caches, full):
            n = c.k.shape[0]
            lo = kv_rank * n
            for mine, leaf in ((c.k, f.k), (c.v, f.v),
                               (c.k_scale, f.k_scale),
                               (c.v_scale, f.v_scale), (c.pos, f.pos)):
                mine.copy_(leaf[lo:lo + n])

    def run(step, params, cfg, tokens, caches, args, opts, **kw):
        full = gathered(caches)
        logits, _ = step(params, cfg, tokens, full, *args,
                         dataclasses.replace(opts, **heads_kw), **kw)
        keep_own(caches, full)
        return logits, caches

    def prefill(params, cfg, tokens, caches, positions, opts=base_opts):
        return run(paged_prefill, params, cfg, tokens, caches, (positions,),
                   opts)

    def prefill_shared(params, cfg, tokens, caches, positions,
                       opts=base_opts):
        return run(paged_prefill_shared, params, cfg, tokens, caches,
                   (positions,), opts)

    def decode(params, cfg, tokens, caches, pos, opts=base_opts):
        return run(paged_decode_step, params, cfg, tokens, caches, (pos,),
                   opts)

    def packed(params, cfg, tokens, caches, positions, slots, logit_rows,
               opts=base_opts, quant_rows=None):
        return run(packed_step, params, cfg, tokens, caches,
                   (positions, slots, logit_rows), opts,
                   quant_rows=quant_rows)

    def verify(params, cfg, tokens, caches, positions, opts=base_opts):
        return run(paged_verify_step, params, cfg, tokens, caches,
                   (positions,), opts)

    return {"prefill": prefill, "prefill_shared": prefill_shared,
            "decode": decode, "packed": packed, "verify": verify}
