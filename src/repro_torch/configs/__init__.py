"""Architecture configs.  Importing this package populates the registry."""

from repro_torch.configs.base import (ModelConfig, get_config,  # noqa: F401
                                      register)
from repro_torch.configs import qwen2_7b, qwen3_rl  # noqa: F401
from repro_torch.configs.qwen2_7b import tiny_math_config  # noqa: F401
