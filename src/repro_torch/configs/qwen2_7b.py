"""qwen2-7b — dense GQA transformer with QKV bias, and ``tiny-math``, the
reduced qwen2-7b the RL harness and the tests run.

[dense] 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064
[arXiv:2407.10671]
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.data import tokenizer as tok


@register("qwen2-7b")
def qwen2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        family="dense",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        pattern=("global",),
        qkv_bias=True,
        rope_theta=1.0e6,
        tie_embeddings=False,
    )


def tiny_math_config(vocab=tok.VOCAB_SIZE) -> ModelConfig:
    return qwen2_7b().reduced(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=vocab, name="tiny-math")
