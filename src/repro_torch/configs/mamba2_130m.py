"""mamba2-130m — SSD (state-space duality), attention-free.

[ssm] 24L d_model=768 d_ff=0 vocab=50280, ssm_state=128  [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, register


@register("mamba2-130m")
def mamba2_130m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        pattern=("mamba",),
        mlp_kind="none",
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_conv=4,
        ssm_groups=1,
        tie_embeddings=True,
    )
