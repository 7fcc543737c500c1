"""Synthetic verifiable math tasks (the repo's stand-in for OpenR1-Math).

Deterministic by (seed, index): the same dataset is reproducible across the
trainer, the rollout instances, and restarts after failures.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.data import tokenizer as tok


@dataclass(frozen=True)
class MathSample:
    index: int
    prompt: str
    answer: str

    @property
    def prompt_ids(self) -> List[int]:
        return tok.encode(self.prompt)


def make_sample(seed: int, index: int, *, digits: int = 2) -> MathSample:
    rng = np.random.RandomState((seed * 1000003 + index) % (2 ** 31 - 1))
    a = int(rng.randint(0, 10 ** digits))
    b = int(rng.randint(0, 10 ** digits))
    op = rng.choice(["+", "-", "*"])
    if op == "+":
        ans = a + b
    elif op == "-":
        ans = a - b
    else:
        ans = a * b
    return MathSample(index=index, prompt=f"{a}{op}{b}=", answer=str(ans))


class MathTaskDataset:
    """Infinite deterministic stream of verifiable prompts."""

    def __init__(self, seed: int = 0, digits: int = 2):
        self.seed = seed
        self.digits = digits

    def sample(self, index: int) -> MathSample:
        return make_sample(self.seed, index, digits=self.digits)

    def batch(self, start: int, n: int) -> List[MathSample]:
        return [self.sample(start + i) for i in range(n)]
