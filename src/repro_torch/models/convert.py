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
    (``None`` means CUDA).  The stacked ``groups/sub0`` leaves keep their
    leading layer axis."""
    dev = resolve_device(device)

    def conv(t):
        return {k: conv(v) if isinstance(v, dict) else _tensor(v, dev)
                for k, v in t.items()}

    params = conv(tree)
    layer = params["groups"]["sub0"]
    got = {"embed": tuple(params["embed"].shape)}
    want = {"embed": (cfg.vocab_size, cfg.d_model)}
    if cfg.has_attention:
        got["attn.wq"] = tuple(layer["attn"]["wq"].shape)
        want["attn.wq"] = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.head_dim)
    if cfg.has_ssm:
        got["mamba.in_proj"] = tuple(layer["mamba"]["in_proj"].shape)
        want["mamba.in_proj"] = (cfg.n_layers, cfg.d_model,
                                 2 * cfg.d_inner + 2 * cfg.ssm_groups
                                 * cfg.ssm_state + cfg.ssm_nheads)
    if got != want:
        raise ValueError(f"{cfg.name}: tree does not match the config "
                         f"(got {got}, want {want})")
    return params
