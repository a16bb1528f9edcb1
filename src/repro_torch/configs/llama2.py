"""Llama-2 7B/13B [arXiv:2307.09288] — the paper's own evaluation models
(§3.1: 32 and 40 decoder layers; split point ℓ ranges over the full stack)."""

from repro_torch.configs.base import ArchConfig, AttnSpec, LayerSpec, MLPSpec, register

CONFIG_7B = register(ArchConfig(
    name="llama2-7b",
    arch_type="dense",
    d_model=4096,
    vocab_size=32000,
    pattern=(LayerSpec(AttnSpec(num_heads=32, num_kv_heads=32, head_dim=128),
                       MLPSpec(d_ff=11008)),),
    num_blocks=32,
    tie_embeddings=False,
    source="arXiv:2307.09288 (Llama 2, paper's §3.1 7B-hf)",
))

CONFIG_13B = register(ArchConfig(
    name="llama2-13b",
    arch_type="dense",
    d_model=5120,
    vocab_size=32000,
    pattern=(LayerSpec(AttnSpec(num_heads=40, num_kv_heads=40, head_dim=128),
                       MLPSpec(d_ff=13824)),),
    num_blocks=40,
    tie_embeddings=False,
    source="arXiv:2307.09288 (Llama 2, paper's §3.1 13B-hf)",
))
