"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6, first layer dense.

[moe] 28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6
[arXiv:2401.06066].  Layer 0 is a dense FFN (d_ff=10944 per the HF config);
the remaining 27 layers are MoE.
"""
from repro_torch.configs.base import ModelConfig, register


@register("deepseek-moe-16b")
def deepseek_moe_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102400,
        pattern=("global",),
        mlp_kind="moe",
        first_k_dense=1,
        d_ff_dense_prefix=10944,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        d_ff_expert=1408,
        tie_embeddings=False,
    )
