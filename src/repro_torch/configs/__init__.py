"""Architecture registry: importing this package registers every config the
port serves: the llama family, gemma2-2b (alternating windowed and global
attention, logit soft caps, gated GELU, tied embeddings),
h2o-danube-3-4b (a sliding window on every layer, head dim 120), the
mixture-of-experts configs qwen2-moe-a2.7b (60 routed experts top-4 and a
shared expert, tied embeddings) and qwen3-moe-235b-a22b (128 experts
top-8, QK-norm, 64 heads on 4 kv heads), the grouped- and multi-query
configs internlm2-20b (48 heads on 8 kv heads) and granite-34b (48 heads
on one kv head, an ungated GELU MLP, tied embeddings), and the
state-space configs mamba2-780m (Mamba-2 mixers only, no ffn) and
jamba-v0.1-52b (Mamba-2 and rope-free attention 7:1, MoE on every other
layer), the vision-language stub qwen2-vl-2b (M-RoPE, patch embeddings
projected into the sequence head) and musicgen-medium (four codebook
token streams, sinusoidal positions): every config of ``repro/configs``."""

from repro_torch.configs import (gemma2_2b, granite_34b,  # noqa: F401
                                 h2o_danube3_4b, internlm2_20b, jamba_52b,
                                 llama2, mamba2_780m, musicgen_medium,
                                 qwen2_moe_a27b, qwen2_vl_2b, qwen3_moe_235b)
from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,  # noqa: F401
                                      MLPSpec, MoESpec, SSMSpec, get_config,
                                      list_configs)
