"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284]. 48L, d_model 1536, 24H (kv=24, head_dim 64), d_ff 6144
(non-gated GELU), vocab 2048 × 4 codebooks, sinusoidal positions.

The EnCodec tokenizer/conv frontend is a stub: inputs are the 4 parallel
codebook token streams (B, S, 4). A copy of
``repro/configs/musicgen_medium.py``."""

from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,
                                      MLPSpec, register)

_attn = AttnSpec(num_heads=24, num_kv_heads=24, head_dim=64)
_mlp = MLPSpec(d_ff=6144, activation="gelu", gated=False)

CONFIG = register(ArchConfig(
    name="musicgen-medium",
    arch_type="audio",
    d_model=1536,
    vocab_size=2048,
    pattern=(LayerSpec(_attn, _mlp),),
    num_blocks=48,
    rope="sinusoidal",
    embed="musicgen",
    num_codebooks=4,
    tie_embeddings=False,
    source="arXiv:2306.05284 (MusicGen)",
))
