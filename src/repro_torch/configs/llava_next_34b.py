"""llava-next-34b — VLM decoder backbone (Yi-34B-style), anyres tiling
frontend stubbed.

[vlm] 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf family].  The vision frontend (anyres tiling + projector) is a
stub: train and prefill take precomputed patch + text embeddings of shape
(B, S, d_model); decode consumes text tokens through the embedding table.
A copy of ``repro.configs.llava_next_34b``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("llava-next-34b")
def llava_next_34b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        pattern=("global",),
        rope_theta=5.0e6,
        input_mode="embeds",
        tie_embeddings=False,
    )
