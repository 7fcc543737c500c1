"""Shape-and-dtype stand-ins for every model input of an (arch x shape)
cell (port of ``repro.launch.specs``): tensors on ``torch.device("meta")``,
the counterpart of the reference's ``jax.ShapeDtypeStruct``, so nothing
is allocated.

``input_specs(cfg, shape)`` returns the abstract inputs for the cell's step
function (``launch.steps``):

  train   -> {"state": ..., "batch": {...}}                (GRPO / supervised)
  prefill -> {"params": ..., "batch": {tokens|embeds}}
  decode  -> {"params": ..., "cache": ..., "tokens": ...}

Shapes and dtypes equal the reference's leaf for leaf.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import kv_cache as kvc
from repro_torch.models.transformer import init_params
from repro_torch.optim import adamw

SLAB_MARGIN = 128  # decode slab headroom beyond the nominal context length
META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def abstract_params(cfg: ModelConfig) -> Dict:
    return init_params(cfg, None, META)


def abstract_state(cfg: ModelConfig) -> Dict:
    params = abstract_params(cfg)
    return {"params": params, "opt": adamw.init(params)}


def train_batch_spec(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    if not cfg.is_decoder:  # encoder: supervised masked prediction
        return {"embeds": _meta((B, S, cfg.d_model), torch.bfloat16),
                "labels": _meta((B, S), torch.int32),
                "mask": _meta((B, S), torch.float32)}
    batch = {"response_mask": _meta((B, S), torch.float32),
             "advantages": _meta((B,), torch.float32),
             "behavior_logprobs": _meta((B, S), torch.float32)}
    if cfg.input_mode == "embeds":  # vlm backbone: projected patch+text embeds
        batch["embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
    batch["tokens"] = _meta((B, S), torch.int32)
    return batch


def prefill_batch_spec(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.input_mode == "embeds":
        return {"embeds": _meta((B, S, cfg.d_model), torch.bfloat16)}
    return {"tokens": _meta((B, S), torch.int32)}


def decode_cache_spec(cfg: ModelConfig, shape: ShapeSpec,
                      cache_dtype=torch.bfloat16) -> Dict:
    B, S = shape.global_batch, shape.seq_len
    return kvc.init_cache(cfg, B, S + SLAB_MARGIN, cache_dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    if shape.kind == "train":
        return {"state": abstract_state(cfg),
                "batch": train_batch_spec(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": abstract_params(cfg),
                "batch": prefill_batch_spec(cfg, shape)}
    return {"params": abstract_params(cfg),
            "cache": decode_cache_spec(cfg, shape),
            "tokens": _meta((shape.global_batch,), torch.int32)}
