"""granite-34b [dense] — llama-arch code model with MQA [arXiv:2405.04324].
88L, d_model 6144, 48H (MQA kv=1, head_dim 128), d_ff 24576, vocab 49152."""

from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,
                                      MLPSpec, register)

_attn = AttnSpec(num_heads=48, num_kv_heads=1, head_dim=128)
_mlp = MLPSpec(d_ff=24576, activation="gelu", gated=False)

CONFIG = register(ArchConfig(
    name="granite-34b",
    arch_type="dense",
    d_model=6144,
    vocab_size=49152,
    pattern=(LayerSpec(_attn, _mlp),),
    num_blocks=88,
    tie_embeddings=True,
    source="arXiv:2405.04324 (Granite Code 34B)",
))
