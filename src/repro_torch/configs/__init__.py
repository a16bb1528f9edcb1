"""Architecture registry: importing this package registers every config the
port serves: the llama family, gemma2-2b (alternating windowed and global
attention, logit soft caps, gated GELU, tied embeddings),
h2o-danube-3-4b (a sliding window on every layer, head dim 120), and the
mixture-of-experts configs qwen2-moe-a2.7b (60 routed experts top-4 and a
shared expert, tied embeddings) and qwen3-moe-235b-a22b (128 experts
top-8, QK-norm, 64 heads on 4 kv heads). The other configs of
``repro/configs`` follow with their model code (ROADMAP queue 1, item 9:
the state-space mixers, M-RoPE, the codebook embedding)."""

from repro_torch.configs import (gemma2_2b, h2o_danube3_4b, llama2,  # noqa: F401
                                 qwen2_moe_a27b, qwen3_moe_235b)
from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,  # noqa: F401
                                      MLPSpec, MoESpec, get_config,
                                      list_configs)
