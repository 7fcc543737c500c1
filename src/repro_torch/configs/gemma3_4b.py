"""gemma3-4b — 5:1 local:global attention, 128k context, QK-norm.

[dense] 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
[hf:google/gemma-3 family]. 34 layers = 5 full (5 local + 1 global) groups
+ 4 trailing local layers (suffix_pattern, unrolled after the scan).
"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma3-4b")
def gemma3_4b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        pattern=("local", "local", "local", "local", "local", "global"),
        suffix_pattern=("local", "local", "local", "local"),
        window=1024,
        qk_norm=True,
        rope_theta=1.0e6,
        rope_theta_local=1.0e4,
        embed_scale=True,
        tie_embeddings=True,
    )
