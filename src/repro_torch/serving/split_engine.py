"""Split-computing serving engine, the paper's system (§2, Fig. 3); port of
``repro/serving/split_engine.py``.

The model is cut at OPSC's split point. The *edge* runs blocks [0, split)
with its weights held as integer codes (int8 up to 8 bits, int16 from 9 to
15) and per-output-channel scales at ``Q_w1`` bits (OPSC's front segment;
every projection goes through the integer-weight kernel K7, and the
dequantized weights never exist). The
*cloud* runs blocks [split, L) at full precision. The split-layer hidden
state crosses as a TS + TAB-Q payload (``core.payload``: kernels K6 and
K5); its measured bit count drives the ε-outage channel model, and
Algorithm 2's ladder escalates (drop the KV cache from the uplink, then
stop generating) when the deadline would be missed.

``I_kv`` (paper §2.2.1, Eq. 2/3): with I_kv = 1 the uplink is accounted at
the Eq. (2) KV-cache size and the cloud decodes incrementally from its
caches (dense, or a paged pool with ``paged_cloud_kv=True``); with I_kv = 0
only hidden states cross, and the cloud re-runs its segment over the whole
received history every step.

Split-boundary speculation (``generate(speculate_k=k)``): the edge drafts
with the model's own head over the split-layer state, ships the burst as
ONE payload, and the cloud verifies it in one multi-token call; a round
costs one uplink round trip in place of one a token.

Unlike the reference, whose front segment is fake-quantized (quantized and
dequantized back to the weights' dtype), the port multiplies by the codes
themselves: in f32 the products agree up to summation order and the
rounding of code × scale, in bf16 also up to the weights' bf16 rounding,
which the reference applies and K7 does not.

With ``telemetry=`` (a ``serving.telemetry.Tracer``): ``edge`` and
``cloud`` spans per segment (prefill, each decode step, each speculative
round's draft and verify), each ended after a sync of the device's current
stream (made only with a tracer), the ``uplink`` event of every payload,
TAB-Q's per-token bit widths and the uplink bits a token as histograms
(from the host copy of the widths each payload's bit count reads anyway),
and each call's ``SplitStats`` mirrored into the registry under
``split.*``.

The ported configs run on the dense clouds: the llama family, the
sliding-window families (gemma2-2b, h2o-danube-3-4b), whose edge and cloud
caches keep a ring per windowed layer, the mixture-of-experts families
(qwen2-moe-a2.7b, qwen3-moe-235b-a22b), the grouped- and multi-query
configs (internlm2-20b, granite-34b), the vision stub qwen2-vl-2b (text
only, as the reference's split serves it: no patches cross), musicgen-medium
(codebook prompts (B, S, 4), greedy, no speculation, as the reference's)
and the state-space ones (mamba2-780m, jamba-v0.1-52b), whose Mamba-2
layers carry a recurrent
state on both sides of the split and whose edge runs their projections
through K7 (``conv_w`` as its dequantized codes). The paged cloud refuses
windows and SSM layers, as the reference's pool does, and so does
speculation: a verify burst written into a ring that has wrapped
overwrites positions its earlier columns still attend, and an SSM layer
takes one token a decode step. On the edge an expert weight (nb, E, d_in,
d_out) is held as (E·d_in, d_out) codes a block with one scale per output
column shared by all experts, and the f32 router (nb, D, E) as codes too,
as the reference fake-quantizes them; ``models.moe`` multiplies expert i
by its rows of the codes. The engine's default ``RuntimeOpts`` keep the reference's
capacity factor of 1.25, which drops pairs at prefill.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.channel import ChannelConfig, LatencyModel, optimal_rate
from repro_torch.core.opsc import OPSCConfig, payload_bytes
from repro_torch.core.payload import decode as payload_decode
from repro_torch.core.payload import encode as payload_encode
from repro_torch.core.quant import QuantizedTensor, quantize_sym
from repro_torch.core.sampling import (SamplingParams, bias_rows,
                                       broadcast_params, sampling_operands,
                                       speculative_verify, token_logprobs)
from repro_torch.device import resolve_device, stream_sync, to_device
from repro_torch.models.transformer import (RuntimeOpts, _apply_layers,
                                            apply_head, embed_inputs,
                                            init_caches)
from repro_torch.serving.engine import make_sampler
from repro_torch.serving.kv_pool import DEFAULT_PAGE_SIZE, PagedKVPool
from repro_torch.serving.page_transport import TabqUplinkTransport


def slice_blocks(params: dict, lo: int, hi: int) -> dict:
    """``params`` with every stacked ``blocks/...`` leaf cut to the blocks
    [lo, hi) (views); the other leaves are shared."""
    return {k: v[lo:hi] if k.startswith("blocks/") else v
            for k, v in params.items()}


def quantize_front_blocks(params: dict, bits: int) -> dict:
    """OPSC front-segment weights: every stacked (nb, ..., d_out) leaf of
    three or more axes of ``params`` becomes a :class:`QuantizedTensor` of
    codes (nb, ∏ middle axes, d_out) with one scale per block and output
    column (``quantize_sym`` over the middle axes, the reference's
    ``_fake_quant_blocks`` without the dequantization: an expert weight's
    scales are shared by its experts); norms and the embedding stay as
    they are. The codes are int8 up to 8 bits and int16 from 9 to 15:
    ``quantize_sym`` gives the reference's int32 carrier there, narrowed
    exactly (|c| ≤ 2^14 - 1). They are computed in the weight's dtype, as
    the reference's are, so a bf16 weight's 12-bit code carries no more
    than bf16's 8 significant bits. ``bits`` ≥ 16 keeps the full
    precision weights (the paper's high-precision segment). Each block is
    quantized on its own into the codes, so the temporaries are one
    block's, not the whole leaf's (granite-34b's eight-block ``w_up`` is
    2.4 GB of bf16)."""
    if bits >= 16:
        return params
    carrier = torch.int8 if bits <= 8 else torch.int16
    out = dict(params)
    for key, x in params.items():
        if key.startswith("blocks/") and x.dim() >= 3:
            flat = x.reshape(x.shape[0], -1, x.shape[-1])
            codes = torch.empty(flat.shape, dtype=carrier,
                                device=x.device)
            scale = torch.empty((flat.shape[0], 1, flat.shape[-1]),
                                dtype=torch.float32, device=x.device)
            for i, block in enumerate(flat):
                q = quantize_sym(block, bits, dim=-2)
                codes[i], scale[i] = q.codes, q.scale
            out[key] = QuantizedTensor(codes, scale, bits, tuple(flat.shape))
    return out


@dataclasses.dataclass
class SplitStats:
    tokens_generated: int = 0
    uplink_bits_measured: float = 0.0  # the real TS + TAB-Q payload bits
    uplink_bits_eq3: float = 0.0  # the paper's analytical accounting
    latency_s: float = 0.0  # modelled deadline-ladder latency
    early_exits: int = 0
    kv_dropped_steps: int = 0
    # paged cloud (paged_cloud_kv=True, I_kv=1): the per-step KV shipment
    # at PAGE granularity under uplink_bits_eq3's convention (the whole
    # written cache every step), and the pool's peak residency including
    # the worst-case reservation; both count a page shared between edge
    # devices once, which is what shared_prefix_len buys
    uplink_bits_paged: float = 0.0
    cloud_pool_bytes_peak: int = 0
    shared_prefix_pages: int = 0  # pool pages pinned by the shared prefix
    # decode-phase payloads (prefill excluded), in both modes: the
    # per-token loop pays one a token, speculation one a verify round
    uplink_round_trips: int = 0
    spec_rounds: int = 0  # speculative verify rounds
    spec_drafted: int = 0  # draft tokens proposed, summed over rows
    spec_accepted: int = 0  # draft tokens the verifier accepted, summed

    @property
    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the cloud accepted."""
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0)


class SplitEngine:
    def __init__(self, cfg: ArchConfig, params: dict, opsc: OPSCConfig,
                 channel: ChannelConfig = ChannelConfig(),
                 deadline_s: float | None = None,
                 compute_per_layer_s: float = 1e-4,
                 opts: RuntimeOpts = RuntimeOpts(),
                 cache_len: int = 4096,
                 paged_cloud_kv: bool = False,
                 cloud_pool_pages: int = 256,
                 cloud_page_size: int | None = None,
                 telemetry=None, device=None):
        """The paper's split system on ``device`` (``cuda`` unless the
        caller names another; raises with no card): edge blocks [0, split)
        as int8 or int16 codes at ``opsc.qw_front`` bits (full precision
        at 16 or more), cloud blocks [split, L) at full precision, a TS + TAB-Q
        payload between them. ``params`` is the flat dict of
        :mod:`repro_torch.params`.

        ``paged_cloud_kv=True`` (I_kv = 1 only) gives the cloud a
        ``PagedKVPool`` of ``cloud_pool_pages`` pages of ``cloud_page_size``
        tokens (None: the pool default) over its own segment's layers in
        place of a dense per-request cache; each ``generate`` call admits
        its rows with worst-case reservation (prompt + max_new tokens).
        ``cache_len`` (tokens) bounds every per-request history buffer.
        ``telemetry`` takes a ``Tracer`` (module docstring)."""
        if opsc.split_layer % len(cfg.pattern):
            raise ValueError("the split point must fall on a pattern "
                             "boundary")
        self.device = resolve_device(device)
        self.cfg, self.opts, self.opsc = cfg, opts, opsc
        self.cache_len = cache_len
        self.paged_cloud_kv = paged_cloud_kv
        self.cloud_pool_pages = cloud_pool_pages
        self.cloud_page_size = cloud_page_size
        self.split_block = opsc.split_layer // len(cfg.pattern)
        # serving.telemetry.Tracer or None: None skips every tracer call
        # and every sync that ends a span
        self.telemetry = telemetry
        # the edge→cloud mover: every payload's wire accounting
        self._uplink = TabqUplinkTransport(telemetry=telemetry)

        # the cloud reads blocks [split, nb) of these; the edge holds its
        # own quantized copy of blocks [0, split)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.edge_params = quantize_front_blocks(
            slice_blocks(self.params, 0, self.split_block), opsc.qw_front)

        self.channel = channel
        self.rate = optimal_rate(channel)
        self.latency = LatencyModel(channel, self.rate, compute_per_layer_s)
        self.deadline_s = deadline_s

    def edge_weight_bytes(self) -> int:
        """Device bytes of the edge segment's block weights: when quantized,
        the codes (one byte a code up to 8 bits, two from 9 to 15; OPSC's
        Eq. 1 counts ``qw_front`` bits) and their f32 scales."""
        total = 0
        for k, v in self.edge_params.items():
            if k.startswith("blocks/"):
                parts = (v.codes, v.scale) if isinstance(v, QuantizedTensor) \
                    else (v,)
                total += sum(t.numel() * t.element_size() for t in parts)
        return total

    # ------------------------------------------------------------- stages

    def _positions(self, b: int, s: int, pos) -> torch.Tensor:
        """(B, S) int32 positions pos .. pos + S - 1 (``pos`` an int or a
        0-d int32 tensor on the device)."""
        ar = torch.arange(s, dtype=torch.int32, device=self.device) + pos
        return ar[None].expand(b, s)

    def _edge_front(self, tokens, caches, pos, decode: bool):
        """Blocks [0, split) over ``tokens`` (B, S), or (B, S, K) on a
        codebook config, written at ``pos``: the split-layer hidden states
        (B, S, D). The embedding takes the positions ``pos ..`` too
        (musicgen adds their sinusoidal embedding); it takes no patches:
        the split serves the vision stub's config on text only, as the
        reference's does."""
        b, s = tokens.shape[:2]
        positions = self._positions(b, s, pos)
        x = embed_inputs(self.cfg, self.edge_params, tokens, None, positions)
        return _apply_layers(self.cfg, self.edge_params, x, caches,
                             q_positions=positions, pos=pos, opts=self.opts,
                             decode=decode, blocks=(0, self.split_block))

    def _cloud_back(self, h, caches, pos, decode: bool, positions=None,
                    attend_cache: bool = False, tail: int | None = None):
        """Blocks [split, L) and the head over ``h`` (B, S, D): last
        position logits (B, V) f32, or with ``tail`` the logits of the
        last ``tail`` columns (B, tail, V): the verify of a k-token burst
        (``decode=True``, S = k: every column reads the cache back, the
        burst included, as k decode steps would) and the stateless I_kv = 0
        re-run over the whole history. ``positions`` (B, S) overrides
        ``pos`` (the shared-prefix prefill, whose rows 1+ mask their
        prefix columns with -1 and, with ``attend_cache``, read the prefix
        that row 0 writes into the shared pool pages in this call; the
        paged verify's positions)."""
        b, s = h.shape[:2]
        if positions is None:
            positions = self._positions(b, s, pos)
        x = _apply_layers(self.cfg, self.params, h, caches,
                          q_positions=positions, pos=pos, opts=self.opts,
                          decode=decode, attend_cache=attend_cache,
                          blocks=(self.split_block, self.cfg.num_blocks))
        if tail is not None:
            return apply_head(self.cfg, self.params, x[:, -tail:])
        return apply_head(self.cfg, self.params, x[:, -1:])[:, 0]

    def _draft_next(self, h):
        """The edge's draft token (B, 1): the argmax of the model's head
        over the split-layer state ``h`` (B, 1, D), from the edge's own
        parameters (the front segment is the draft model; no extra
        weights)."""
        return torch.argmax(apply_head(self.cfg, self.edge_params, h),
                            dim=-1)

    # ------------------------------------------------------------ payload

    def _tspan(self, segment: str, stage: str, t0: float) -> None:
        """Close one edge or cloud segment span (a tracer is attached): the
        sync makes it cover the device work; values are untouched."""
        tel = self.telemetry
        stream_sync(self.device)
        t1 = tel.now()
        tel.add_span(segment, t0, t1, track=f"split:{segment}", stage=stage)
        tel.metrics.observe(f"split.{segment}_s", t1 - t0)

    def _t0(self) -> float:
        return self.telemetry.now() if self.telemetry is not None else 0.0

    def _compress(self, h: torch.Tensor):
        """TS + TAB-Q over ``h`` (B, S, D) as f32 and back (Eq. 7):
        (reconstruction in h's dtype, measured payload bits). Reading the
        bits back syncs the host, as the ladder needs them there; a tracer
        takes TAB-Q's per-token widths from the same host copy."""
        b, s, d = h.shape
        p = payload_encode(h.reshape(b * s, d).float(), tau=self.opsc.tau,
                           delta=self.opsc.delta,
                           max_bits=self.opsc.max_act_bits)
        rec = payload_decode(p).reshape(b, s, d).to(h.dtype)
        widths = p.below.bits.cpu()
        bits = float(p.payload_bits(widths))
        tel = self.telemetry
        if tel is not None:
            # the wire histograms the placement optimizer reads: each
            # token's chosen width (sign bit included) and the payload's
            # bits a token
            for w in widths.tolist():
                tel.metrics.observe("split.tabq_bits", float(w))
            tel.metrics.observe("split.uplink_bits_per_token",
                                bits / max(1, b * s))
        return rec, bits

    def _send(self, w: int, bits: float, i_kv: int, stats: SplitStats,
              **attrs):
        """One decode-phase payload of ``bits`` at history ``w``: Algorithm
        2's ladder on the modelled total latency (drop the KV cache from
        the uplink, then stop), then the uplink accounting (``attrs`` go on
        a tracer's uplink event). Returns the I_kv in force, or None when
        the ladder stops the generation."""
        if self.deadline_s is not None:
            lat = self.latency.total_latency(w, self.opsc.split_layer, bits)
            if lat > self.deadline_s and i_kv == 1:
                i_kv = 0  # drop the KV cache from the uplink
                stats.kv_dropped_steps += 1
                lat = self.latency.total_latency(
                    w, self.opsc.split_layer, self._eq3_bits(w, 0))
            stats.latency_s += lat
            if lat > self.deadline_s:
                stats.early_exits += 1
                return None
        stats.uplink_bits_measured += bits
        stats.uplink_bits_eq3 += self._eq3_bits(w, i_kv)
        stats.uplink_round_trips += 1
        self._uplink.uplink(bits, i_kv=i_kv, **attrs)
        return i_kv

    def _mirror_stats(self, b: int, stats: SplitStats, paged: bool) -> None:
        """One call's ``SplitStats`` into the tracer's registry: one uplink
        account across ``SplitStats``, ``LLMServer.metrics()`` and traces."""
        m = self.telemetry.metrics
        m.count("split.calls")
        m.count("split.requests", b)
        m.count("split.tokens_generated", stats.tokens_generated)
        m.count("split.uplink_bits_measured", stats.uplink_bits_measured)
        m.count("split.uplink_bits_eq3", stats.uplink_bits_eq3)
        m.count("split.uplink_bits_paged", stats.uplink_bits_paged)
        m.count("split.early_exits", stats.early_exits)
        m.count("split.kv_dropped_steps", stats.kv_dropped_steps)
        m.count("split.deadline_latency_s", stats.latency_s)
        m.count("split.uplink_round_trips", stats.uplink_round_trips)
        if stats.spec_rounds:
            m.count("split.spec_rounds", stats.spec_rounds)
            m.count("split.spec_drafted", stats.spec_drafted)
            m.count("split.spec_accepted", stats.spec_accepted)
            m.gauge("split.acceptance_rate", stats.acceptance_rate)
        if paged:
            m.gauge("split.cloud_pool_bytes_peak",
                    stats.cloud_pool_bytes_peak)
            m.gauge("split.shared_prefix_pages", stats.shared_prefix_pages)

    def _eq3_bits(self, w: int, i_kv: int) -> float:
        # Eq. 3 counts one KV width for every layer, the first attention
        # layer's (the ported patterns' attention positions share kv heads
        # and head dim), or d_model on a pattern without attention (mamba2),
        # as the reference counts it
        c = self.cfg
        attn = [ls.mixer for ls in c.pattern if ls.mixer.kind == "attn"]
        hd = attn[0].num_kv_heads * attn[0].head_dim if attn else c.d_model
        return payload_bytes(w, self.opsc.split_layer, c.num_layers, hd,
                             c.d_model, self.opsc.qa_front,
                             self.opsc.qa_back, i_kv) * 8.0

    # ----------------------------------------------------------- generate

    @torch.inference_mode()
    def generate(self, prompts, max_new_tokens: int, compress: bool = True,
                 shared_prefix_len: int = 0, sampling=None,
                 with_logprobs: bool = False, speculate_k: int = 0) -> tuple:
        """Split-computing generation over ``prompts`` (B, S) int, or
        (B, S, K) on a codebook config (musicgen). Returns (tokens
        (B, S + generated[, K]), SplitStats), or with ``with_logprobs=True``
        also (B, generated[, K]) f32 logprobs of each emitted token under
        the raw cloud-head distribution. Codebook prompts take greedy
        sampling only and no ``speculate_k``, as the reference's.

        ``sampling``: one ``SamplingParams`` for every row or a list of B;
        None or all-greedy rows take the exact argmax. The sampler is
        ``Engine``'s, so with a full-precision front (``qw_front`` ≥ 16)
        and ``compress=False`` a stream is bit-identical to ``Engine``'s.

        ``shared_prefix_len`` (tokens; needs ``paged_cloud_kv=True`` and
        I_kv = 1) declares that every row begins with the same prefix: the
        cloud holds it once (rows 1+ fork row 0's pool pages, rounded down
        to whole pages), and rows 1+ neither compress nor ship their prefix
        columns.

        ``speculate_k`` > 0: split-boundary speculation. Each round the
        edge steps its front segment over the pending token and up to k
        drafts (each the argmax of the head over the split-layer state),
        ships the burst as ONE payload (the ladder weighs
        ``w = pos + k_eff``), and the cloud verifies every column in one
        call (dense cache, paged pool, or the I_kv = 0 re-run).
        ``speculative_verify`` accepts a prefix per row (exact match for
        greedy rows, so the stream is the ``speculate_k=0`` stream;
        rejection sampling for the others); the batch advances by its
        SHORTEST accepted run, and a paged cloud truncates the rest. Dense
        caches need no scrub: the next round overwrites the same slots
        before the causal mask could expose them. ``SplitStats`` counts
        ``spec_rounds``, ``spec_drafted``, ``spec_accepted`` and the
        round trips."""
        if speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        if speculate_k and any(ls.mixer.kind == "ssm"
                               for ls in self.cfg.pattern):
            raise NotImplementedError(
                "speculate_k over Mamba-2 layers: the cloud's verify burst "
                "is a k-token decode call, which the SSM's one-token "
                "recurrence cannot take, and a rejected draft would stay "
                "in the recurrent state")
        if speculate_k and any(getattr(ls.mixer, "sliding_window", None)
                               is not None for ls in self.cfg.pattern):
            raise NotImplementedError(
                "speculate_k over sliding-window layers: a verify burst "
                "written into a ring that has wrapped overwrites positions "
                "its earlier columns still attend")
        cfg, opts, dev = self.cfg, self.opts, self.device
        prompts = np.asarray(prompts)
        k = cfg.num_codebooks
        if prompts.ndim != (2 if k == 1 else 3) or (
                k > 1 and prompts.shape[2] != k):
            want = "(B, S)" if k == 1 else f"(B, S, {k}) codebook"
            raise ValueError(f"prompts must be {want} token ids, got shape "
                             f"{prompts.shape}")
        b, s = prompts.shape[:2]
        if s + max_new_tokens > self.cache_len:
            raise ValueError(f"prompt {s} + max_new_tokens {max_new_tokens} "
                             f"exceeds cache_len {self.cache_len}")
        if speculate_k and k > 1:
            raise NotImplementedError(
                "speculate_k needs (B, S) token prompts")
        tokens = torch.as_tensor(prompts, device=dev)
        stats = SplitStats()
        splist = broadcast_params(
            SamplingParams() if sampling is None else sampling, b)
        if k > 1 and not all(p.greedy for p in splist):
            raise NotImplementedError(
                "non-greedy sampling needs (B, S) token prompts")
        sample = make_sampler(splist, cfg.vocab_size, dev)

        nfront = self.split_block
        nback = cfg.num_blocks - nfront
        edge_caches = init_caches(cfg, b, self.cache_len, opts, dev, nfront)
        pool, aligned = None, 0
        if shared_prefix_len and not (self.paged_cloud_kv and self.opsc.i_kv):
            raise ValueError("shared_prefix_len needs paged_cloud_kv=True "
                             "and I_kv=1 (the prefix lives in cloud pages)")
        if self.paged_cloud_kv and self.opsc.i_kv:
            pool = PagedKVPool(
                cfg, num_pages=self.cloud_pool_pages,
                page_size=self.cloud_page_size or DEFAULT_PAGE_SIZE,
                max_requests=b, max_seq_len=self.cache_len,
                num_blocks=nback, device=dev)
            if shared_prefix_len and b > 1:
                declared = min(int(shared_prefix_len), s - 1)
                # validate the declared prefix even when page rounding
                # leaves nothing to share
                if not np.all(prompts[:, :declared] == prompts[:1, :declared]):
                    raise ValueError(
                        f"shared_prefix_len={shared_prefix_len}: rows do "
                        f"not share their first {declared} prompt tokens")
                # whole pages only: no copy-on-write, and rows admitted in
                # the same prefill read the pages row 0 writes
                aligned = declared // pool.page_size * pool.page_size
            reserve = s + max_new_tokens
            if aligned:
                slot0 = pool.admit(s, reserve_tokens=reserve)
                handle = pool.share_prefix(slot0, aligned)
                for _ in range(b - 1):
                    pool.admit(s, reserve_tokens=reserve, prefix=handle)
                pool.release_prefix(handle)  # the rows hold their own refs
                stats.shared_prefix_pages = aligned // pool.page_size
            else:
                for _ in range(b):
                    # worst-case reservation: a decode append never finds
                    # the pool full
                    pool.admit(s, reserve_tokens=reserve)
            cloud_caches = pool.device_caches()
        else:
            cloud_caches = init_caches(cfg, b, self.cache_len, opts, dev,
                                       nback)

        def account_pages():
            if pool is not None:
                # the shipment moves the written pages; residency counts
                # the whole reservation the cloud holds
                stats.uplink_bits_paged += pool.page_bytes_written() * 8
                stats.cloud_pool_bytes_peak = max(stats.cloud_pool_bytes_peak,
                                                  pool.page_bytes_in_use())

        # ---- prefill both segments; the prompt crosses the same uplink
        tel = self.telemetry
        t0 = self._t0()
        h = self._edge_front(tokens, edge_caches, 0, decode=False)
        if tel is not None:
            self._tspan("edge", "prefill", t0)
        if aligned:
            # the shared prefix crosses once, with row 0; rows 1+ ship only
            # their suffix and the cloud takes their prefix from row 0's
            # (causality makes prefix hidden states row-independent)
            if compress:
                rec0, bits0 = self._compress(h[:1])
                recs, bits_s = self._compress(h[1:, aligned:])
            else:
                rec0, bits0 = h[:1], float(h[:1].numel() * 16)
                recs = h[1:, aligned:]
                bits_s = float(recs.numel() * 16)
            pre = rec0[:, :aligned].expand(b - 1, aligned, h.shape[2])
            h = torch.cat([rec0, torch.cat([pre, recs], dim=1)]).to(h.dtype)
            bits = bits0 + bits_s
        elif compress:
            h, bits = self._compress(h)
        else:
            bits = float(h.numel() * 16)  # uncompressed 16-bit uplink
        stats.uplink_bits_measured += bits
        self._uplink.uplink(bits, stage="prefill", tokens=b * s)
        t0 = self._t0()
        if aligned:
            posn = np.tile(np.arange(s, dtype=np.int32), (b, 1))
            posn[1:, :aligned] = -1  # rows 1+ neither write nor re-read it
            logits = self._cloud_back(h, cloud_caches, 0, decode=False,
                                      positions=to_device(posn, dev),
                                      attend_cache=True)
        else:
            logits = self._cloud_back(h, cloud_caches, 0, decode=False)
        if tel is not None:
            self._tspan("cloud", "prefill", t0)
        stats.uplink_bits_eq3 += self._eq3_bits(s, self.opsc.i_kv)
        if pool is not None:
            for r in range(b):
                pool.commit_prefill(r, s)
            account_pages()

        # device buffers: the split-layer history (for the stateless
        # I_kv = 0 cloud), the tokens and their logprobs, read back once
        h_buf = torch.zeros((b, self.cache_len, h.shape[2]), dtype=h.dtype,
                            device=dev)
        h_buf[:, :s] = h
        rest = tuple(tokens.shape[2:])  # (K,) with codebooks
        tok_buf = torch.empty((b, max_new_tokens) + rest, dtype=tokens.dtype,
                              device=dev)
        lp_buf = torch.empty((b, max_new_tokens) + rest, dtype=torch.float32,
                             device=dev)
        t = torch.zeros((), dtype=torch.int32, device=dev)
        n_hist, n_out, i_kv, pos = s, 0, self.opsc.i_kv, s
        if speculate_k:
            n_out = self._speculate(
                speculate_k, max_new_tokens, splist, sample, logits, tokens,
                edge_caches, cloud_caches, pool, h_buf, tok_buf, lp_buf,
                stats, account_pages, compress)
        else:
            for step in range(max_new_tokens):
                nxt = sample(logits, t)
                tok_buf[:, step] = nxt
                if with_logprobs:
                    lp_buf[:, step] = token_logprobs(logits, nxt)
                n_out = step + 1
                if step + 1 == max_new_tokens:
                    break
                pos_t = t + s  # the position the token is written at
                t0 = self._t0()
                h = self._edge_front(tok_buf[:, step:step + 1], edge_caches,
                                     pos_t, decode=True)
                if tel is not None:
                    self._tspan("edge", "decode", t0)
                if compress:
                    h_c, bits = self._compress(h)
                else:
                    h_c, bits = h, float(h.numel() * 16)
                i_kv = self._send(pos + 1, bits, i_kv, stats, stage="decode",
                                  step=step)
                if i_kv is None:
                    break
                h_buf[:, n_hist] = h_c[:, 0]
                n_hist += 1
                t0 = self._t0()
                if i_kv:
                    if pool is not None:  # grow each request by one token
                        for r in range(b):
                            pool.append(r, 1)
                        cloud_caches = pool.device_caches()
                    logits = self._cloud_back(h_c, cloud_caches, pos_t,
                                              decode=True)
                    account_pages()
                else:
                    # stateless cloud: its segment over the whole history,
                    # "losing the benefits of the cache"
                    fresh = init_caches(cfg, b, n_hist, opts, dev, nback)
                    logits = self._cloud_back(h_buf[:, :n_hist], fresh, 0,
                                              decode=False)
                if tel is not None:
                    self._tspan("cloud", "decode", t0)
                pos += 1
                t += 1
                stats.tokens_generated += 1

        if tel is not None:
            self._mirror_stats(b, stats, pool is not None)
        out = tok_buf[:, :n_out].cpu().numpy()
        toks = np.concatenate([prompts, out.astype(prompts.dtype)], axis=1)
        if with_logprobs:
            return toks, stats, lp_buf[:, :n_out].cpu().numpy()
        return toks, stats

    def _speculate(self, k: int, max_new: int, splist: list, sample, logits,
                   tokens, edge_caches, cloud_caches, pool, h_buf, tok_buf,
                   lp_buf, stats: SplitStats, account_pages,
                   compress: bool) -> int:
        """:meth:`generate`'s speculative rounds after the prefill (see its
        docstring): fills ``tok_buf``/``lp_buf`` and ``stats``; returns the
        tokens emitted."""
        cfg, opts, dev, tel = self.cfg, self.opts, self.device, self.telemetry
        b, s = tokens.shape
        nback = cfg.num_blocks - self.split_block
        seeds, temp, top_k, top_p = sampling_operands(splist, dev)
        bias = torch.as_tensor(bias_rows(splist, cfg.vocab_size), device=dev) \
            if any(p.logit_bias for p in splist) else None
        # the first token comes from the prefill logits, drawn as the
        # per-token loop draws it
        t = torch.zeros((), dtype=torch.int32, device=dev)
        cur = sample(logits, t)[:, None]
        tok_buf[:, :1] = cur
        lp_buf[:, 0] = token_logprobs(logits, cur[:, 0])
        n_out, n_hist, pos, i_kv = 1, s, s, self.opsc.i_kv
        while n_out < max_new:
            # the pending token and kd drafts make one k_eff-token payload;
            # a round emits 1 .. k_eff tokens, so never draft past the
            # generation budget
            kd = min(k, max_new - n_out - 1)
            k_eff = kd + 1
            t_draft = self._t0()
            hs, drafts = [], []
            for j in range(k_eff):
                h = self._edge_front(cur, edge_caches, torch.full(
                    (), pos + j, dtype=torch.int32, device=dev), decode=True)
                hs.append(h)
                if j < kd:
                    cur = self._draft_next(h).to(tokens.dtype)
                    drafts.append(cur)
            h = torch.cat(hs, dim=1)
            draft = torch.cat(drafts, dim=1) if drafts else torch.zeros(
                (b, 0), dtype=tokens.dtype, device=dev)
            if tel is not None:
                self._tspan("edge", "draft", t_draft)
            if compress:
                # one payload for the burst; TAB-Q sets bits a row, so it
                # is k_eff one-token payloads' codes in one call
                h_c, bits = self._compress(h)
            else:
                h_c, bits = h, float(h.numel() * 16)
            # the ladder weighs the burst at w = pos + k_eff
            i_kv = self._send(pos + k_eff, bits, i_kv, stats,
                              stage="speculate", tokens=b * k_eff)
            if i_kv is None:
                break
            h_buf[:, n_hist:n_hist + k_eff] = h_c
            t_verify = self._t0()
            if i_kv:
                if pool is not None:
                    for r in range(b):
                        pool.append(r, k_eff)
                    posn = pos + np.tile(np.arange(k_eff, dtype=np.int32),
                                         (b, 1))
                    vlogits = self._cloud_back(
                        h_c, pool.device_caches(), 0, decode=True,
                        positions=to_device(posn, dev), tail=k_eff)
                    account_pages()
                else:
                    vlogits = self._cloud_back(
                        h_c, cloud_caches, torch.full(
                            (), pos, dtype=torch.int32, device=dev),
                        decode=True, tail=k_eff)
            else:
                # stateless cloud: its segment over the whole history,
                # the head over the verify columns only
                fresh = init_caches(cfg, b, n_hist + k_eff, opts, dev, nback)
                vlogits = self._cloud_back(h_buf[:, :n_hist + k_eff], fresh,
                                           0, decode=False, tail=k_eff)
            if tel is not None:
                self._tspan("cloud", "verify", t_verify)
            t0 = torch.full((b,), n_out, dtype=torch.int64, device=dev)
            out, n_acc, lps = speculative_verify(
                draft, torch.full((b,), kd, device=dev), vlogits, seeds, t0,
                temp, top_k, top_p, bias)
            # the rows march in lockstep: advance by the SHORTEST accepted
            # run (every row's accepted prefix is exact, so a longer run's
            # tail is derived again by the next round)
            n_acc = n_acc.cpu()
            n = int(n_acc.min())
            stats.spec_rounds += 1
            stats.spec_drafted += b * kd
            stats.spec_accepted += int(n_acc.sum()) - b
            if tel is not None:
                tel.metrics.observe("split.accepted_tokens", float(n))
            tok_buf[:, n_out:n_out + n] = out[:, :n]
            lp_buf[:, n_out:n_out + n] = lps[:, :n]
            if pool is not None and i_kv and n < k_eff:
                # scrub the rejected tail: no later round's history mask or
                # page accounting may see it
                for r in range(b):
                    pool.truncate(r, pos + n)
            cur = out[:, n - 1:n].to(tokens.dtype)
            pos += n
            n_hist += n
            n_out += n
            stats.tokens_generated += n
        return n_out
