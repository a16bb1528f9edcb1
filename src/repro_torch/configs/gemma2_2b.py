"""gemma2-2b [dense] — local+global alternating attention, logit softcaps
[arXiv:2408.00118]. 26L, d_model 2304, 8H (GQA kv=4, head_dim 256),
d_ff 9216 (gated GELU), vocab 256000."""

from repro_torch.configs.base import ArchConfig, AttnSpec, LayerSpec, MLPSpec, register

_local = AttnSpec(num_heads=8, num_kv_heads=4, head_dim=256,
                  sliding_window=4096, attn_softcap=50.0)
_global = AttnSpec(num_heads=8, num_kv_heads=4, head_dim=256,
                   attn_softcap=50.0)
_mlp = MLPSpec(d_ff=9216, activation="gelu", gated=True)

CONFIG = register(ArchConfig(
    name="gemma2-2b",
    arch_type="dense",
    d_model=2304,
    vocab_size=256000,
    pattern=(LayerSpec(_local, _mlp), LayerSpec(_global, _mlp)),
    num_blocks=13,  # 26 layers
    tie_embeddings=True,
    final_softcap=30.0,
    embed_scale=True,
    source="arXiv:2408.00118 (Gemma 2)",
    # long_500k: local layers keep a 4096-window ring cache; the 13 global
    # layers carry the full 500k cache (sub-quadratic in the windowed half)
    supports_long_context=True,
))
