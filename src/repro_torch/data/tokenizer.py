"""Tiny deterministic character tokenizer for the verifiable math task.

Offline-friendly substitute for a BPE tokenizer: digits, operators and
lowercase letters map to fixed ids.  PAD=0, BOS=1, EOS=2.
"""

from __future__ import annotations

from typing import List

PAD, BOS, EOS = 0, 1, 2
_CHARS = "0123456789+-*/=() abcdefghijklmnopqrstuvwxyz?.,:"
_C2I = {c: i + 3 for i, c in enumerate(_CHARS)}
_I2C = {i + 3: c for i, c in enumerate(_CHARS)}

VOCAB_SIZE = len(_CHARS) + 3


def encode(text: str, *, bos: bool = True) -> List[int]:
    ids = [BOS] if bos else []
    ids += [_C2I[c] for c in text if c in _C2I]
    return ids


def decode(ids) -> str:
    return "".join(_I2C.get(int(i), "") for i in ids)


def strip_special(ids) -> List[int]:
    return [int(i) for i in ids if int(i) not in (PAD, BOS, EOS)]
