"""gemma2-27b — alternating local:global attention, logit softcaps.

[dense] 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
[arXiv:2408.00118]. head_dim=128 per the gemma2 family; window 4096;
attention logit softcap 50, final logit softcap 30; pre+post RMSNorms.
"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma2-27b")
def gemma2_27b() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        family="dense",
        n_layers=46,
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab_size=256000,
        pattern=("local", "global"),
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norms=True,
        embed_scale=True,
        tie_embeddings=True,
    )
