"""The model: layers, attention over paged pools, rings and slabs, KV
caches, weights."""

from repro_torch.models.transformer import (decode_step,  # noqa: F401
                                            forward, init_params, prefill)
