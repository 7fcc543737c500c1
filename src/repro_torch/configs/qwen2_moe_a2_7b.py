"""qwen2-moe-a2.7b — fine-grained MoE, 4 shared + 60 routed top-4.

[moe] 24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B].  Shared experts are gated by a sigmoid
(shared_expert_gate).  QKV bias per the qwen family.
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-moe-a2.7b")
def qwen2_moe_a2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=151936,
        pattern=("global",),
        qkv_bias=True,
        rope_theta=1.0e6,
        mlp_kind="moe",
        n_experts=60,
        n_shared_experts=4,
        top_k=4,
        d_ff_expert=1408,
        shared_expert_gate=True,
        tie_embeddings=False,
    )
