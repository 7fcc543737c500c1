"""Architecture configs.  Importing this package populates the registry."""

from repro_torch.configs.base import (ModelConfig, get_config,  # noqa: F401
                                      register)
from repro_torch.configs import (deepseek_moe_16b,  # noqa: F401
                                 gemma2_27b, gemma3_4b, gemma3_12b,
                                 hubert_xlarge, hymba_1_5b,
                                 llava_next_34b, mamba2_130m, qwen2_7b,
                                 qwen2_moe_a2_7b, qwen3_rl)
from repro_torch.configs.qwen2_7b import tiny_math_config  # noqa: F401
