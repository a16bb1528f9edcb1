"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B
family scaled per assignment]. 94L, d_model 4096, 64H (GQA kv=4,
head_dim 128, QK-norm), per-expert d_ff 1536, vocab 151936."""

from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,
                                      MoESpec, register)

_attn = AttnSpec(num_heads=64, num_kv_heads=4, head_dim=128, qk_norm=True)
_moe = MoESpec(num_experts=128, top_k=8, d_ff=1536, num_shared=0,
               renormalize=True, shard="expert")  # 128 / 16 mesh shards

CONFIG = register(ArchConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    d_model=4096,
    vocab_size=151936,
    pattern=(LayerSpec(_attn, _moe),),
    num_blocks=94,
    rope_theta=1e6,
    tie_embeddings=False,
    source="hf:Qwen/Qwen3-30B-A3B (scaled to 235B-A22B per assignment)",
))
