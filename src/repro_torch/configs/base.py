"""Model configuration for the port: the dense, all-global-attention
decoder family that the serving engine runs.

A copy of ``repro.configs.base`` trimmed to the fields this family reads.
Parameter trees keep the reference's scan-stacked layout (one
``groups/sub0`` entry whose leaves carry a leading layer axis), so a
config here and its counterpart in the reference describe the same
weights.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    pattern: Tuple[str, ...] = ("global",)
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 1.0e4
    embed_scale: bool = False
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.family != "dense" or self.pattern != ("global",):
            raise ValueError(
                f"{self.name}: the port serves the dense all-global family "
                f"only (family={self.family!r}, pattern={self.pattern!r})")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads must be a multiple of "
                             f"n_kv_heads")

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's
        ``reduced`` for the dense family)."""
        small: Dict = dict(n_layers=2, d_model=64, n_heads=4,
                           n_kv_heads=max(1, min(self.n_kv_heads, 2)),
                           head_dim=16, d_ff=128, vocab_size=128,
                           dtype="float32")
        small.update(overrides)
        small.setdefault("name", self.name + "-smoke")
        return dataclasses.replace(self, **small)


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()

