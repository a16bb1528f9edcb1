"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].
28L, d_model 1536, 12H (GQA kv=2, head_dim 128), d_ff 8960, vocab 151936.
The vision frontend (ViT) is a stub: callers pass pre-projector patch
embeddings (B, num_patches, d_vision); the config carries only the
projector. A copy of ``repro/configs/qwen2_vl_2b.py``."""

from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,
                                      MLPSpec, register)

_attn = AttnSpec(num_heads=12, num_kv_heads=2, head_dim=128)
_mlp = MLPSpec(d_ff=8960, activation="silu", gated=True)

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    d_model=1536,
    vocab_size=151936,
    pattern=(LayerSpec(_attn, _mlp),),
    num_blocks=28,
    rope="mrope",
    mrope_sections=(16, 24, 24),  # temporal/height/width bands of head_dim/2
    rope_theta=1e6,
    embed="vlm",
    num_patches=1024,  # stub frontend: patches occupy the sequence head
    d_vision=1280,
    tie_embeddings=True,
    source="arXiv:2409.12191 (Qwen2-VL)",
))
