"""Model configuration for the port: the decoder families whose every
layer has the same mixer, which the serving engine runs: dense all-global
attention (Qwen), hybrid sliding-window attention beside a Mamba-2 mixer
(Hymba) and pure Mamba-2 (SSD).

A copy of ``repro.configs.base`` trimmed to the fields these families
read.  Parameter trees keep the reference's scan-stacked layout (one
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
    family: str  # dense | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    pattern: Tuple[str, ...] = ("global",)
    window: int = 0                 # sliding window of the hybrid mixer
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 1.0e4
    rope_theta_local: float = 1.0e4
    embed_scale: bool = False
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    mlp_kind: str = "dense"         # dense | none

    # --- ssm (mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1

    def __post_init__(self):
        if self.pattern not in FAMILIES.get(self.family, ()):
            raise ValueError(
                f"{self.name}: the port serves {sorted(FAMILIES)} with one "
                f"mixer in every layer (family={self.family!r}, "
                f"pattern={self.pattern!r})")
        if self.mlp_kind not in ("dense", "none"):
            raise ValueError(f"{self.name}: mlp_kind {self.mlp_kind!r} is "
                             f"not ported")
        if self.has_attention and (self.n_kv_heads <= 0
                                   or self.n_heads % self.n_kv_heads):
            raise ValueError(f"{self.name}: n_heads must be a multiple of "
                             f"n_kv_heads")
        if self.has_ssm and self.ssm_state <= 0:
            raise ValueError(f"{self.name}: an SSM mixer needs ssm_state")
        if self.pattern == ("hybrid",) and self.window <= 0:
            raise ValueError(f"{self.name}: the hybrid mixer's attention "
                             f"is a sliding window (window > 0)")

    # --- derived ---
    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        # the conv runs over the concatenated [x, B, C] channels
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def has_attention(self) -> bool:
        return any(m in ("global", "hybrid") for m in self.pattern)

    @property
    def has_ssm(self) -> bool:
        return any(m in ("mamba", "hybrid") for m in self.pattern)

    def layer_mixers(self) -> Tuple[str, ...]:
        """Mixer kind for every layer, in order."""
        return self.pattern * (self.n_layers // len(self.pattern))

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's
        ``reduced`` for these families)."""
        small: Dict = dict(n_layers=2 * len(self.pattern), d_model=64,
                           n_heads=4,
                           n_kv_heads=max(1, min(self.n_kv_heads, 2)),
                           head_dim=16, d_ff=128 if self.d_ff else 0,
                           vocab_size=128,
                           window=min(self.window, 16) if self.window else 0,
                           dtype="float32")
        if self.has_ssm:
            small.update(ssm_state=16, ssm_headdim=16, ssm_expand=2,
                         ssm_groups=1)
        small.update(overrides)
        small.setdefault("name", self.name + "-smoke")
        return dataclasses.replace(self, **small)


# family -> the layer patterns the port runs for it
FAMILIES = {"dense": (("global",),), "hybrid": (("hybrid",),),
            "ssm": (("mamba",),)}

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


def list_archs():
    return sorted(_REGISTRY)
