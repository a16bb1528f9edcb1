"""Architecture configuration system (the port's own copy of
``repro/configs/base.py``, kept verbatim apart from the registry import so
that the port never imports the JAX package).

An ``ArchConfig`` describes a decoder stack as a repeated *pattern* of
``LayerSpec``s (mixer + ffn); the full depth is ``len(pattern) × num_blocks``.
Homogeneous stacks have a 1-layer pattern; gemma2's local/global alternation
is a 2-layer pattern; jamba's 1:7 attention:mamba interleave with alternating
MoE is an 8-layer pattern. Parameters for each pattern position are stacked
across blocks (the leading axis of every block leaf).

Every assigned config cites its source in ``source``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    sliding_window: Optional[int] = None
    attn_softcap: Optional[float] = None
    qk_norm: bool = False
    kind: str = "attn"


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_inner: int
    d_state: int = 128
    head_dim: int = 64  # P
    conv_width: int = 4
    chunk: int = 128
    kind: str = "ssm"

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    d_ff: int
    activation: str = "silu"
    gated: bool = True
    kind: str = "mlp"


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert
    num_shared: int = 0  # shared-expert multiplier (shared ffn = num_shared·d_ff)
    renormalize: bool = True
    shard: str = "expert"  # 'expert' | 'ffn' — mesh mapping of expert weights
    kind: str = "moe"


MixerSpec = Union[AttnSpec, SSMSpec]
FFNSpec = Union[MLPSpec, MoESpec]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: MixerSpec
    ffn: Optional[FFNSpec]  # None → mixer-only layer (mamba2)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    vocab_size: int
    pattern: Tuple[LayerSpec, ...]
    num_blocks: int
    rope: str = "rope"  # rope | mrope | sinusoidal | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    embed: str = "token"  # token | musicgen | vlm
    num_codebooks: int = 1
    num_patches: int = 0  # VLM stub frontend: patch count in the sequence
    d_vision: int = 0  # VLM stub frontend: pre-projector patch width
    tie_embeddings: bool = True
    final_softcap: Optional[float] = None
    embed_scale: bool = False  # gemma: multiply embedding by sqrt(d_model)
    norm_eps: float = 1e-6
    source: str = ""
    # long_500k support: True only for sub-quadratic stacks (see DESIGN.md)
    supports_long_context: bool = False

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.num_blocks

    # ---------------------------------------------------------------- sizes

    def mixer_params(self, m: MixerSpec) -> int:
        d = self.d_model
        if isinstance(m, AttnSpec):
            n = d * m.num_heads * m.head_dim * 2  # wq, wo
            n += d * m.num_kv_heads * m.head_dim * 2  # wk, wv
            if m.qk_norm:
                n += 2 * m.head_dim
            return n
        di, ns, h = m.d_inner, m.d_state, m.n_heads
        n = d * (2 * di + 2 * ns + h)  # w_z, w_x, w_B, w_C, w_dt
        n += m.conv_width * (di + 2 * ns) + (di + 2 * ns)  # conv
        n += 3 * h + di  # dt_bias, A_log, D, norm
        n += di * d  # w_out
        return n

    def ffn_params(self, f: Optional[FFNSpec], active: bool = False) -> int:
        if f is None:
            return 0
        d = self.d_model
        if isinstance(f, MLPSpec):
            return d * f.d_ff * (3 if f.gated else 2)
        e = f.top_k if active else f.num_experts
        n = d * f.num_experts  # router (always resident)
        n += e * 3 * d * f.d_ff  # gate/up/down per (active) expert
        if f.num_shared:
            n += 3 * d * f.num_shared * f.d_ff
        return n

    def layer_param_counts(self, active: bool = False) -> list:
        """Per-layer parameter counts, length num_layers (2 norms included)."""
        per_pattern = [
            self.mixer_params(ls.mixer) + self.ffn_params(ls.ffn, active) + 2 * self.d_model
            for ls in self.pattern
        ]
        return per_pattern * self.num_blocks

    def embed_params(self) -> int:
        n = self.num_codebooks * self.vocab_size * self.d_model
        if self.embed == "vlm":
            n += self.d_vision * self.d_model  # projector
        return n

    def head_params(self) -> int:
        if self.tie_embeddings and self.embed == "token":
            return 0
        return self.d_model * self.vocab_size * self.num_codebooks

    def total_params(self, active: bool = False) -> int:
        return (sum(self.layer_param_counts(active)) + self.embed_params()
                + self.head_params() + self.d_model)  # + final norm

    # ----------------------------------------------------------- reductions

    def tiny(self) -> "ArchConfig":
        """Reduced same-family variant for CPU smoke tests:
        ≤ 2 layers, d_model ≤ 512, ≤ 4 experts."""
        d = 128

        def shrink_mixer(m: MixerSpec) -> MixerSpec:
            if isinstance(m, AttnSpec):
                return dataclasses.replace(
                    m, num_heads=4, num_kv_heads=min(m.num_kv_heads, 2) or 1,
                    head_dim=32,
                    sliding_window=16 if m.sliding_window else None)
            return dataclasses.replace(m, d_inner=256, d_state=16, head_dim=32,
                                       chunk=8)

        def shrink_ffn(f: Optional[FFNSpec]) -> Optional[FFNSpec]:
            if f is None:
                return None
            if isinstance(f, MLPSpec):
                return dataclasses.replace(f, d_ff=256)
            return dataclasses.replace(f, num_experts=4, top_k=min(f.top_k, 2),
                                       d_ff=64, num_shared=min(f.num_shared, 1))

        # keep pattern diversity but cap total depth at 2 layers
        pat = self.pattern
        if len(pat) > 2:  # pick one of each distinct (mixer-kind, ffn-kind)
            seen, keep = set(), []
            for ls in pat:
                sig = (ls.mixer.kind, None if ls.ffn is None else ls.ffn.kind)
                if sig not in seen:
                    seen.add(sig)
                    keep.append(ls)
            pat = tuple(keep[:2])
        pat = tuple(LayerSpec(shrink_mixer(ls.mixer), shrink_ffn(ls.ffn)) for ls in pat)
        nb = 1 if len(pat) == 2 else 2
        sections = (4, 6, 6) if self.rope == "mrope" else ()
        return dataclasses.replace(
            self, name=self.name + "-tiny", d_model=d, vocab_size=256,
            pattern=pat, num_blocks=nb, mrope_sections=sections,
            num_patches=min(self.num_patches, 8) if self.embed == "vlm" else 0,
            d_vision=64 if self.embed == "vlm" else 0)


# ---------------------------------------------------------------- registry

_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401 — populate registry

    if name.endswith("-tiny"):
        return get_config(name[: -len("-tiny")]).tiny()
    return _REGISTRY[name]


def list_configs() -> list:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
