"""Architecture registry: importing this package registers every config the
port serves: the llama family, gemma2-2b (alternating windowed and global
attention, logit soft caps, gated GELU, tied embeddings) and
h2o-danube-3-4b (a sliding window on every layer, head dim 120). The
other configs of ``repro/configs`` follow with their model code (ROADMAP
queue 1, item 9)."""

from repro_torch.configs import gemma2_2b, h2o_danube3_4b, llama2  # noqa: F401
from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,  # noqa: F401
                                      MLPSpec, get_config, list_configs)
