"""Architecture registry: importing this package registers every config the
port serves. Only the llama family is ported so far; the other configs of
``repro/configs`` follow with their model code."""

from repro_torch.configs import llama2  # noqa: F401
from repro_torch.configs.base import (ArchConfig, AttnSpec, LayerSpec,  # noqa: F401
                                      MLPSpec, get_config, list_configs)
