"""internlm2-20b [dense] — GQA [arXiv:2403.17297]. 48L, d_model 6144,
48H (GQA kv=8, head_dim 128), d_ff 16384, vocab 92544."""

from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,
                                      MLPSpec, register)

_attn = AttnSpec(num_heads=48, num_kv_heads=8, head_dim=128)
_mlp = MLPSpec(d_ff=16384, activation="silu", gated=True)

CONFIG = register(ArchConfig(
    name="internlm2-20b",
    arch_type="dense",
    d_model=6144,
    vocab_size=92544,
    pattern=(LayerSpec(_attn, _mlp),),
    num_blocks=48,
    rope_theta=1e6,
    tie_embeddings=False,
    source="arXiv:2403.17297 (InternLM2)",
))
