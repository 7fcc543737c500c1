"""Architecture configs.  Importing this package populates the registry."""

from repro_torch.configs.base import (ModelConfig, get_config,  # noqa: F401
                                      list_archs, padded_variant, register)
from repro_torch.configs.shapes import (SHAPES, ShapeSpec,  # noqa: F401
                                        cell_status, valid_cells)
from repro_torch.configs import (deepseek_moe_16b,  # noqa: F401
                                 gemma2_27b, gemma3_4b, gemma3_12b,
                                 hubert_xlarge, hymba_1_5b,
                                 llava_next_34b, mamba2_130m, qwen2_7b,
                                 qwen2_moe_a2_7b, qwen3_rl)
from repro_torch.configs.qwen2_7b import tiny_math_config  # noqa: F401

# the (arch x shape) cells' architectures and the paper's, as the
# reference lists them
ASSIGNED_ARCHS = (
    "mamba2-130m",
    "qwen2-7b",
    "gemma3-12b",
    "gemma2-27b",
    "gemma3-4b",
    "hubert-xlarge",
    "hymba-1.5b",
    "llava-next-34b",
    "qwen2-moe-a2.7b",
    "deepseek-moe-16b",
)

PAPER_ARCHS = ("qwen3-8b", "qwen3-14b", "qwen3-32b")
