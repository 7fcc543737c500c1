"""hubert-xlarge — encoder-only audio backbone (wav2vec2 arch).

[audio] 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504  [arXiv:2106.07447]
Encoder-only (bidirectional attention, no decode step).  The conv feature
frontend is a stub: the model takes precomputed frame embeddings of shape
(B, S, d_model).  vocab=504 is the masked-prediction codebook size.
A copy of ``repro.configs.hubert_xlarge``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("hubert-xlarge")
def hubert_xlarge() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        pattern=("global",),
        causal=False,
        input_mode="embeds",
        tie_embeddings=False,
    )
