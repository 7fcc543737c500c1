"""Rule-based verifiable rewards (binary exact-match, as in the paper's
math workload)."""

from __future__ import annotations

from typing import List, Sequence

from repro_torch.data import tokenizer as tok


def verify_math(response_ids: Sequence[int], answer: str) -> float:
    """1.0 iff the decoded response (up to EOS) equals the expected answer."""
    out = []
    for i in response_ids:
        if int(i) == tok.EOS:
            break
        out.append(int(i))
    text = tok.decode(tok.strip_special(out)).strip()
    return 1.0 if text == answer.strip() else 0.0


def partial_credit(response_ids: Sequence[int], answer: str) -> float:
    """Shaped reward for tiny-model demos: 0.5 * matching-prefix ratio
    + 0.5 * exact match.  Verifiable and monotone in correctness."""
    out = []
    for i in response_ids:
        if int(i) == tok.EOS:
            break
        out.append(int(i))
    text = tok.decode(tok.strip_special(out)).strip()
    ans = answer.strip()
    n = 0
    for a, b in zip(text, ans):
        if a != b:
            break
        n += 1
    prefix = n / max(len(ans), 1)
    return 0.5 * prefix + 0.5 * (1.0 if text == ans else 0.0)


def batch_rewards(responses: List[Sequence[int]], answers: List[str]):
    return [verify_math(r, a) for r, a in zip(responses, answers)]
