"""The paper's own workload models: Qwen3 8B/14B/32B (RLBoost Table 4).

| model     | layers | Q heads | K/V heads | hidden |
|-----------|--------|---------|-----------|--------|
| Qwen3-8B  | 32     | 32      | 8         | 4096   |
| Qwen3-14B | 48     | 48      | 8         | 5120   |
| Qwen3-32B | 64     | 40      | 8         | 5120   |

d_ff/vocab from the Qwen3 technical report [arXiv:2505.09388]; qk_norm per the
qwen3 family, no QKV bias.  Kept identical to the reference's configs (the
reference's ``qwen3-8b`` has 32 layers and tied embeddings, where the
published checkpoint has 36 layers and separate embeddings).
"""
from repro_torch.configs.base import ModelConfig, register


def _qwen3(name, n_layers, n_heads, d_model, d_ff, tie):
    return ModelConfig(
        name=name,
        family="dense",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=8,
        head_dim=128,
        d_ff=d_ff,
        vocab_size=151936,
        pattern=("global",),
        qk_norm=True,
        rope_theta=1.0e6,
        tie_embeddings=tie,
    )


@register("qwen3-8b")
def qwen3_8b() -> ModelConfig:
    return _qwen3("qwen3-8b", 32, 32, 4096, 12288, True)


@register("qwen3-14b")
def qwen3_14b() -> ModelConfig:
    return _qwen3("qwen3-14b", 48, 48, 5120, 17408, False)


@register("qwen3-32b")
def qwen3_32b() -> ModelConfig:
    return _qwen3("qwen3-32b", 64, 40, 5120, 25600, False)
