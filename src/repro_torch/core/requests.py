"""Rollout request state shared by the sim and real backends."""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional


class Status(Enum):
    QUEUED = "queued"          # held centrally (delayed dispatch)
    PENDING = "pending"        # assigned to an instance, not yet executing
    EXECUTING = "executing"
    DONE = "done"


@dataclass
class Request:
    id: int
    group: int                        # GRPO group id
    prompt_len: int
    max_total: int                    # prompt + response cap
    prompt_ids: Optional[List[int]] = None     # real backend
    target_total: Optional[int] = None         # sim backend: true final len
    seed: int = 0

    status: Status = Status.QUEUED
    instance_id: Optional[int] = None
    tokens: List[int] = field(default_factory=list)      # generated tokens
    logprobs: List[float] = field(default_factory=list)
    # run-length [weight_version, n_tokens] spans over the generated tokens
    # (staleness accounting across mid-stream weight swaps / migrations)
    version_spans: List[List[int]] = field(default_factory=list)
    n_generated: int = 0
    n_migrations: int = 0           # moves that preserved partial tokens
    n_restarts: int = 0             # recompute-mode restarts (tokens lost)
    created_at: float = 0.0
    completed_at: Optional[float] = None
    # zero-recompute migration: the source's published KV export (a
    # ``core.kv_migration.KVExport``) rides with the request while it is
    # queued; the destination pulls it over the chunk plane instead of
    # re-prefilling prompt+partial.  None => token-history migration.
    kv: Optional[object] = None

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.n_generated

    @property
    def done(self) -> bool:
        return self.status == Status.DONE

    def context_ids(self) -> List[int]:
        """prompt + already-generated tokens (migration continuation)."""
        return list(self.prompt_ids or []) + self.tokens

    def stamp_version(self, version: int):
        """Record one generated token under ``version`` (span run-length)."""
        if self.version_spans and self.version_spans[-1][0] == version:
            self.version_spans[-1][1] += 1
        else:
            self.version_spans.append([version, 1])

    @property
    def min_weight_version(self) -> int:
        return min((v for v, _ in self.version_spans), default=-1)
