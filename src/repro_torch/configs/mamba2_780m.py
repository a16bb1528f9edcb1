"""mamba2-780m [ssm] — SSD state-space duality, attention-free
[arXiv:2405.21060]. 48L, d_model 1536, d_inner 3072 (48 heads × P=64),
ssm_state 128, vocab 50280. Mamba blocks have no separate FFN (ffn=None)."""

from repro_torch.configs.base import ArchConfig, LayerSpec, SSMSpec, register

_ssm = SSMSpec(d_inner=3072, d_state=128, head_dim=64, conv_width=4, chunk=256)

CONFIG = register(ArchConfig(
    name="mamba2-780m",
    arch_type="ssm",
    d_model=1536,
    vocab_size=50280,
    pattern=(LayerSpec(_ssm, None),),
    num_blocks=48,
    rope="none",
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba-2)",
    supports_long_context=True,  # O(1) recurrent state
))
