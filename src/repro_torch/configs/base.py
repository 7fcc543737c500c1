"""Model configuration for the port: dense all-global attention (Qwen),
dense mixed sliding-window ("local") and global attention (Gemma 2 /
Gemma 3), mixture-of-experts all-global attention (Qwen1.5-MoE,
DeepSeekMoE), hybrid sliding-window attention beside a Mamba-2 mixer
(Hymba), pure Mamba-2 (SSD), and the two backbones whose frontend is a
stub: the encoder-only audio family (HuBERT: bidirectional attention, no
decode step) and the vision-language decoder (LLaVA-NeXT).

A copy of ``repro.configs.base`` trimmed to the fields these families
read.  ``input_mode`` is ``"tokens"`` for the language models and
``"embeds"`` for the stubbed backbones, which take precomputed
``(B, S, d_model)`` frame or patch embeddings in train and prefill.
``pattern`` is the repeating group of mixers and ``suffix_pattern`` the
trailing layers that do not fill a group (gemma3-4b: 5 groups of 5
local + 1 global, then 4 local).  Parameter trees keep the reference's
layout: ``first_k_dense`` prefix layers (DeepSeekMoE's dense first layer)
under ``prefix/{i}``, then one scan-stacked ``groups/sub{j}`` entry per
pattern position j whose leaves carry a leading group axis, then
``suffix/{i}``, so a config here and its counterpart in the reference
describe the same weights.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    pattern: Tuple[str, ...] = ("global",)
    # logical head padding: q-heads padded to pad_heads (0 = none) at the
    # tail of each GQA group, with zero output rows, so the model computes
    # what the unpadded one does while the heads divide a 16-wide axis
    pad_heads: int = 0
    window: int = 0                 # sliding window of local / hybrid mixers
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    post_norms: bool = False        # gemma2 post-attention / post-MLP norms
    rope_theta: float = 1.0e4
    rope_theta_local: float = 1.0e4
    causal: bool = True             # False: encoder-only (hubert)
    embed_scale: bool = False
    tie_embeddings: bool = True
    # trailing layers that do not fill a whole pattern group
    suffix_pattern: Tuple[str, ...] = ()
    dtype: str = "bfloat16"
    mlp_kind: str = "dense"         # dense | moe | none
    # prefix layers (moe family only) keep a dense MLP of their own width
    first_k_dense: int = 0
    d_ff_dense_prefix: int = 0

    # --- moe ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 1.0e-2
    shared_expert_gate: bool = False  # qwen2-moe sigmoid gate on shared

    # --- ssm (mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1

    input_mode: str = "tokens"      # tokens | embeds

    def __post_init__(self):
        if self.pattern not in FAMILIES.get(self.family, ()):
            raise ValueError(
                f"{self.name}: the port serves {sorted(FAMILIES)} with the "
                f"layer patterns {FAMILIES} (family={self.family!r}, "
                f"pattern={self.pattern!r})")
        if any(m not in ("local", "global") for m in self.suffix_pattern) \
                or (self.suffix_pattern and not self.mixed):
            raise ValueError(f"{self.name}: suffix layers are ported for the "
                             f"mixed local / global patterns only")
        if self.mlp_kind not in ("dense", "moe", "none"):
            raise ValueError(f"{self.name}: mlp_kind {self.mlp_kind!r} is "
                             f"not ported")
        if (self.mlp_kind == "moe") != (self.family == "moe"):
            raise ValueError(f"{self.name}: mlp_kind 'moe' is the moe "
                             f"family's, and only its")
        if self.mlp_kind == "moe" and not (self.n_experts > 0
                                           and 0 < self.top_k
                                           <= self.n_experts
                                           and self.d_ff_expert > 0):
            raise ValueError(f"{self.name}: a MoE MLP needs n_experts, "
                             f"top_k <= n_experts and d_ff_expert")
        if self.first_k_dense and self.family != "moe":
            raise ValueError(f"{self.name}: dense prefix layers are ported "
                             f"for the moe family only")
        scanned = (self.n_layers - self.first_k_dense
                   - len(self.suffix_pattern))
        if scanned < 0 or scanned % len(self.pattern):
            raise ValueError(f"{self.name}: {self.n_layers} layers less "
                             f"{self.first_k_dense} prefix and "
                             f"{len(self.suffix_pattern)} suffix layers do "
                             f"not fill whole pattern groups")
        if self.has_attention and (self.n_kv_heads <= 0
                                   or self.n_heads % self.n_kv_heads):
            raise ValueError(f"{self.name}: n_heads must be a multiple of "
                             f"n_kv_heads")
        if self.pad_heads and (self.pad_heads < self.n_heads
                               or self.pad_heads % max(self.n_kv_heads, 1)):
            raise ValueError(f"{self.name}: pad_heads must be at least "
                             f"n_heads and a multiple of n_kv_heads")
        if self.has_ssm and self.ssm_state <= 0:
            raise ValueError(f"{self.name}: an SSM mixer needs ssm_state")
        if self.input_mode not in ("tokens", "embeds"):
            raise ValueError(f"{self.name}: input_mode {self.input_mode!r} "
                             f"is not tokens or embeds")
        if any(m in ("hybrid", "local") for m in self.pattern) \
                and self.window <= 0:
            raise ValueError(f"{self.name}: the hybrid and local mixers' "
                             f"attention is a sliding window (window > 0)")

    # --- derived ---
    @property
    def n_heads_eff(self) -> int:
        """Head count actually materialized (>= n_heads when pad_heads is
        set); the padded heads sit at the tail of each GQA group."""
        return self.pad_heads or self.n_heads

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
        return any(m in ("global", "local", "hybrid") for m in self.pattern)

    @property
    def mixed(self) -> bool:
        """Local and global attention layers in one model (the gemma
        family's patterns)."""
        return "local" in self.pattern

    @property
    def has_ssm(self) -> bool:
        return any(m in ("mamba", "hybrid") for m in self.pattern)

    @property
    def is_decoder(self) -> bool:
        """Whether the arch has an autoregressive decode step."""
        return self.causal

    @property
    def sub_quadratic(self) -> bool:
        """Decode memory O(1) / O(window) per token (long_500k runs)."""
        return all(m in ("mamba", "local", "hybrid")
                   for m in self.pattern + self.suffix_pattern)

    @property
    def n_groups(self) -> int:
        return ((self.n_layers - self.first_k_dense - len(self.suffix_pattern))
                // len(self.pattern))

    @property
    def group_size(self) -> int:
        return len(self.pattern)

    @property
    def n_experts_padded(self) -> int:
        """Experts padded to a multiple of 16, as the reference stores them
        (padded experts get no router column and are never selected)."""
        if self.n_experts == 0:
            return 0
        return ((self.n_experts + 15) // 16) * 16

    def layer_mixers(self) -> Tuple[str, ...]:
        """Mixer kind for every layer, in order: prefix layers, the groups,
        then the suffix."""
        base = "global" if self.has_attention else self.pattern[0]
        return ((base,) * self.first_k_dense + self.pattern * self.n_groups
                + self.suffix_pattern)

    def mlp_kind_for_layer(self, layer_idx: int) -> str:
        if layer_idx < self.first_k_dense:
            return "dense"
        return self.mlp_kind

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included once if tied),
        by the reference's formula for these families."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        total = V * D  # embeddings
        if not self.tie_embeddings:
            total += V * D
        for li, mix in enumerate(self.layer_mixers()):
            if mix in ("global", "local", "hybrid"):
                H, K, dh = self.n_heads, self.n_kv_heads, self.head_dim
                total += D * (H + 2 * K) * dh + H * dh * D
            if mix in ("mamba", "hybrid"):
                din = self.d_inner
                d_in_proj = (2 * din + 2 * self.ssm_groups * self.ssm_state
                             + self.ssm_nheads)
                total += D * d_in_proj + din * D
                total += self.ssm_conv * self.conv_dim + self.conv_dim
                total += 3 * self.ssm_nheads + din
            kind = self.mlp_kind_for_layer(li)
            if kind == "dense":
                f = self.d_ff_dense_prefix if li < self.first_k_dense else F
                total += 3 * D * f
            elif kind == "moe":
                total += self.n_experts * 3 * D * self.d_ff_expert
                total += self.n_shared_experts * 3 * D * self.d_ff_expert
                total += D * self.n_experts
            total += 2 * D  # norms
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE counts top_k + shared experts
        only)."""
        if self.mlp_kind != "moe":
            return self.param_count()
        n_moe_layers = self.n_layers - self.first_k_dense
        inactive = ((self.n_experts - self.top_k) * 3 * self.d_model
                    * self.d_ff_expert)
        return self.param_count() - n_moe_layers * inactive

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's
        ``reduced`` for these families)."""
        small: Dict = dict(n_layers=(self.first_k_dense
                                     + 2 * self.group_size
                                     + len(self.suffix_pattern)),
                           d_model=64, n_heads=4,
                           n_kv_heads=max(1, min(self.n_kv_heads, 2)),
                           head_dim=16, d_ff=128 if self.d_ff else 0,
                           vocab_size=128,
                           window=min(self.window, 16) if self.window else 0,
                           d_ff_dense_prefix=128 if self.first_k_dense
                           else 0,
                           dtype="float32")
        if self.mlp_kind == "moe":
            small.update(n_experts=8, top_k=min(self.top_k, 2),
                         d_ff_expert=32,
                         n_shared_experts=min(self.n_shared_experts, 1))
        if self.has_ssm:
            small.update(ssm_state=16, ssm_headdim=16, ssm_expand=2,
                         ssm_groups=1)
        small.update(overrides)
        small.setdefault("name", self.name + "-smoke")
        return dataclasses.replace(self, **small)


# family -> the layer patterns the port runs for it: the dense family's
# mixed ones are gemma2's (1 local : 1 global) and gemma3's (5 : 1)
FAMILIES = {"dense": (("global",), ("local", "global"),
                      ("local",) * 5 + ("global",)),
            "moe": (("global",),), "hybrid": (("hybrid",),),
            "ssm": (("mamba",),), "audio": (("global",),),
            "vlm": (("global",),)}

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def padded_variant(cfg: ModelConfig, axis: int = 16) -> ModelConfig:
    """Smallest logical head padding making n_heads divisible by ``axis``
    while keeping the GQA grouping; ``cfg`` unchanged if already divisible
    or if padding would pass 2x the head count (the reference's rule)."""
    H, K = cfg.n_heads, max(cfg.n_kv_heads, 1)
    if H == 0 or H % axis == 0:
        return cfg
    for Hp in range(H + 1, 2 * H + 1):
        if Hp % K == 0 and Hp % axis == 0:
            return dataclasses.replace(cfg, pad_heads=Hp)
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    return sorted(_REGISTRY)
