"""Carry a parameter tree of numpy arrays (the reference's
``init_params`` output, or a checkpoint read into numpy) into the port."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                         # a writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: same 16 bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Dict, cfg: ModelConfig, device=None) -> Dict:
    """Same nested dict and key strings, leaves as tensors on ``device``
    (``None`` means CUDA).  The stacked ``groups/sub{j}`` leaves keep their
    leading group axis; ``prefix/{i}`` and ``suffix/{i}`` layers have none.
    Raises ``ValueError`` when a checked leaf's shape does not fit the
    config.  An encoder on embeddings (hubert) has no ``embed``; an
    untied config has ``lm_head``."""
    dev = resolve_device(device)

    def conv(t):
        return {k: conv(v) if isinstance(v, dict) else _tensor(v, dev)
                for k, v in t.items()}

    params = conv(tree)
    D, G = cfg.d_model, cfg.n_groups

    def shape(*path):
        t = params
        for k in path:
            if not isinstance(t, dict) or k not in t:
                return None
            t = t[k]
        return tuple(t.shape)

    layer = ("groups", "sub0")
    got = {"embed": shape("embed"),
           "prefix layers": len(params.get("prefix") or {}),
           "pattern positions": sorted(params.get("groups") or {}),
           "suffix layers": len(params.get("suffix") or {})}
    want = {"embed": ((cfg.vocab_size, D) if cfg.input_mode == "tokens"
                      or cfg.is_decoder else None),
            "prefix layers": cfg.first_k_dense,
            "pattern positions": sorted(f"sub{j}"
                                        for j in range(cfg.group_size)),
            "suffix layers": len(cfg.suffix_pattern)}
    if not cfg.tie_embeddings:
        got["lm_head"] = shape("lm_head")
        want["lm_head"] = (D, cfg.vocab_size)
    if cfg.post_norms:
        got["post_ln2"] = shape(*layer, "post_ln2", "scale")
        want["post_ln2"] = (G, D)
    for i in range(len(cfg.suffix_pattern)):
        got[f"suffix.{i}.attn.wq"] = shape("suffix", str(i), "attn", "wq")
        want[f"suffix.{i}.attn.wq"] = (D, cfg.n_heads_eff, cfg.head_dim)
    if cfg.has_attention:
        got["attn.wq"] = shape(*layer, "attn", "wq")
        want["attn.wq"] = (G, D, cfg.n_heads_eff, cfg.head_dim)
    if cfg.has_ssm:
        got["mamba.in_proj"] = shape(*layer, "mamba", "in_proj")
        want["mamba.in_proj"] = (G, D, 2 * cfg.d_inner + 2 * cfg.ssm_groups
                                 * cfg.ssm_state + cfg.ssm_nheads)
    if cfg.mlp_kind == "moe":
        Fe, Fs = cfg.d_ff_expert, cfg.n_shared_experts * cfg.d_ff_expert
        got.update({k: shape(*layer, "mlp", *k.split(".")) for k in (
            "router", "experts.wo", "shared.wi", "shared_gate")})
        want.update({"router": (G, D, cfg.n_experts),
                     "experts.wo": (G, cfg.n_experts_padded, Fe, D),
                     "shared.wi": (G, D, Fs) if Fs else None,
                     "shared_gate": (G, D, 1) if Fs and
                     cfg.shared_expert_gate else None})
    for i in range(cfg.first_k_dense):
        got[f"prefix.{i}.mlp.wi"] = shape("prefix", str(i), "mlp", "wi")
        want[f"prefix.{i}.mlp.wi"] = (D, cfg.d_ff_dense_prefix)
    if got != want:
        raise ValueError(f"{cfg.name}: tree does not match the config "
                         f"(got {got}, want {want})")
    return params
