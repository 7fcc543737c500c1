"""Algorithm 1: adaptive partial-response seeding.

Feedback-tunes the training cluster's seeding window T_seed and the upper
bound N_prem on preemptible instances:

  T_seed  <- T_seed + (t_train_wait - t_remote_wait) / eta
  N_prem  <- (t_remote * n_prem_avg + T_seed * N_resv) / t_train

with a *scheduler memory* M[n_hat] -> T_seed that warm-starts the window
after instance-availability changes (paper lines 11-14).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class StepStats:
    t_train_wait: float      # cluster idle, waiting for microbatches
    t_remote_wait: float     # remote instances idle, waiting for step end
    t_train: float           # effective training compute time
    t_remote: float          # effective remote rollout compute time
    n_prem_avg: float        # instances averaged over the step
    n_prem_end: int          # active instances before the next step


@dataclass
class SeedingScheduler:
    n_resv: int                       # local rollout engines during seeding
    eta: float = 4.0                  # adaptation rate (1/eta applied)
    t_init: float = 10.0              # initial seeding window (s)
    t_min: float = 0.0
    t_max: float = 600.0
    use_memory: bool = True           # ablation: scheduler memory on/off
    enabled: bool = True              # ablation: seeding on/off

    t_seed: float = field(init=False)
    n_prem: float = field(init=False)
    memory: Dict[int, float] = field(default_factory=dict)
    _last_n: Optional[int] = None

    def __post_init__(self):
        self.t_seed = self.t_init if self.enabled else 0.0
        self.n_prem = float(self.n_resv)

    # ------------------------------------------------------------------ #
    # recovery plane (converged checkpointable-component protocol): the
    # scheduler's feedback memory is part of the run checkpoint — resume
    # must warm-start T_seed / N_prem exactly where the crashed timeline
    # left them, or the two runs diverge in timing.
    def state_dict(self) -> Dict:
        return dict(t_seed=self.t_seed, n_prem=self.n_prem,
                    memory={str(k): v for k, v in self.memory.items()},
                    last_n=self._last_n)

    def load_state_dict(self, state: Dict):
        self.t_seed = float(state["t_seed"])
        self.n_prem = float(state["n_prem"])
        self.memory = {int(k): float(v)
                       for k, v in state["memory"].items()}
        self._last_n = state["last_n"]

    # ------------------------------------------------------------------ #
    def max_instances(self) -> int:
        return max(int(round(self.n_prem)), 1)

    def update(self, s: StepStats):
        """End-of-step feedback (Algorithm 1 lines 6-14)."""
        if self.enabled:
            self.t_seed += (s.t_train_wait - s.t_remote_wait) / self.eta
            self.t_seed = min(max(self.t_seed, self.t_min), self.t_max)
        if s.t_train > 0:
            self.n_prem = (s.t_remote * s.n_prem_avg
                           + self.t_seed * self.n_resv) / s.t_train
            self.n_prem = max(self.n_prem, 1.0)
        if self.use_memory and self.enabled:
            stable = abs(s.n_prem_avg - s.n_prem_end) < 0.5
            if stable:
                self.memory[s.n_prem_end] = self.t_seed        # line 12
            if (self._last_n is not None
                    and s.n_prem_end != self._last_n
                    and s.n_prem_end in self.memory):
                self.t_seed = self.memory[s.n_prem_end]        # line 14
        self._last_n = s.n_prem_end
