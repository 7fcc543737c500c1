"""Architecture configs.  Importing this package populates the registry."""

from repro_torch.configs.base import (ModelConfig, get_config,  # noqa: F401
                                      register)
from repro_torch.configs import (hymba_1_5b, mamba2_130m,  # noqa: F401
                                 qwen2_7b, qwen3_rl)
from repro_torch.configs.qwen2_7b import tiny_math_config  # noqa: F401
