"""hymba-1.5b — hybrid-head: parallel attention + mamba heads per layer.

[hybrid] 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16
[arXiv:2411.13676].  head_dim=64 (25*64=1600).  The attention half uses
sliding-window attention (hymba uses SWA in all but 3 layers; we use SWA
everywhere and note the simplification in DESIGN.md), which together with the
SSM state keeps decode memory O(window) => long_500k supported.
Meta-tokens from the paper are out of scope (noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, register


@register("hymba-1.5b")
def hymba_1_5b() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        pattern=("hybrid",),
        window=1024,
        ssm_state=16,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_groups=1,
        tie_embeddings=True,
    )
