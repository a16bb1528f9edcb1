"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]. 24L, d_model 3840, 32H (GQA kv=8, head_dim 120),
d_ff 10240, vocab 32000."""

from repro_torch.configs.base import ArchConfig, AttnSpec, LayerSpec, MLPSpec, register

_attn = AttnSpec(num_heads=32, num_kv_heads=8, head_dim=120, sliding_window=4096)
_mlp = MLPSpec(d_ff=10240, activation="silu", gated=True)

CONFIG = register(ArchConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    d_model=3840,
    vocab_size=32000,
    pattern=(LayerSpec(_attn, _mlp),),
    num_blocks=24,
    tie_embeddings=False,
    source="arXiv:2401.16818 (H2O-Danube)",
    supports_long_context=True,  # native SWA → windowed ring cache at 500k
))
