"""Assigned input-shape sets and their (arch x shape) cell validity (a copy
of ``repro.configs.shapes``).

Shapes (LM transformer family):
  train_4k     seq_len=4096   global_batch=256  (training     -> train_step)
  prefill_32k  seq_len=32768  global_batch=32   (inference    -> prefill_step)
  decode_32k   seq_len=32768  global_batch=128  (inference    -> serve_step,
               one new token against a KV cache of seq_len)
  long_500k    seq_len=524288 global_batch=1    (long-context -> serve_step)

Cell-skip rules:
  * long_500k needs sub-quadratic decode memory -> only SSM/hybrid archs.
  * encoder-only archs (hubert) have no decode step -> skip decode/long.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_status(cfg: ModelConfig, shape: ShapeSpec
                ) -> Tuple[bool, Optional[str]]:
    """(runnable, skip_reason) for an (arch x shape) cell."""
    if shape.kind == "decode":
        if not cfg.is_decoder:
            return False, "encoder-only arch has no decode step"
        if shape.name == "long_500k" and not cfg.sub_quadratic:
            return False, ("full-attention layers hold O(seq) KV at 524k with "
                           "unshardable batch=1; long_500k runs only for "
                           "SSM/hybrid archs (DESIGN.md)")
    return True, None


def valid_cells(cfg: ModelConfig):
    return [s for s in SHAPES.values() if cell_status(cfg, s)[0]]
