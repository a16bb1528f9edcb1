"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887]. 32L, d_model 4096, 32H (GQA kv=8, head_dim 128),
d_ff 14336, MoE 16 experts top-2 on every other layer.

Pattern (period 8, matching the paper's 'Jamba block'): attention at
position 3 of 8 (1:7), MoE at odd positions (every other layer)."""

from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,
                                      MLPSpec, MoESpec, SSMSpec, register)

_attn = AttnSpec(num_heads=32, num_kv_heads=8, head_dim=128)
_ssm = SSMSpec(d_inner=8192, d_state=16, head_dim=64, conv_width=4, chunk=256)
_mlp = MLPSpec(d_ff=14336, activation="silu", gated=True)
_moe = MoESpec(num_experts=16, top_k=2, d_ff=14336, renormalize=True,
               shard="expert")

_pattern = tuple(
    LayerSpec(_attn if i == 3 else _ssm, _moe if i % 2 == 1 else _mlp)
    for i in range(8)
)

CONFIG = register(ArchConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    d_model=4096,
    vocab_size=65536,
    pattern=_pattern,
    num_blocks=4,  # 32 layers
    rope="none",  # Jamba uses no positional encoding (Mamba provides order)
    tie_embeddings=False,
    source="arXiv:2403.19887 (Jamba)",
    supports_long_context=True,  # only 4 attention layers carry 500k KV
))
