"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]. 24L, d_model 2048, 16H (kv=16, head_dim 128),
per-expert d_ff 1408, vocab 151936.

60 experts do not divide the 16-way model axis → expert weights shard on the
per-expert ffn dim instead (``shard='ffn'``); see DESIGN.md §5."""

from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,
                                      MoESpec, register)

_attn = AttnSpec(num_heads=16, num_kv_heads=16, head_dim=128)
_moe = MoESpec(num_experts=60, top_k=4, d_ff=1408, num_shared=4,
               renormalize=False, shard="ffn")

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    d_model=2048,
    vocab_size=151936,
    pattern=(LayerSpec(_attn, _moe),),
    num_blocks=24,
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
))
