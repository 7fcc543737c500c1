"""gemma3-12b — 5:1 local:global attention, 128k context, QK-norm.

[dense] 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
[hf:google/gemma-3 family]. head_dim=256 per the gemma3 family; local window
1024; local layers use rope_theta=1e4, global layers 1e6.
"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma3-12b")
def gemma3_12b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262144,
        pattern=("local", "local", "local", "local", "local", "global"),
        window=1024,
        qk_norm=True,
        rope_theta=1.0e6,
        rope_theta_local=1.0e4,
        embed_scale=True,
        tie_embeddings=True,
    )
