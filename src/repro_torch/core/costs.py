"""Cloud cost model (paper Tables 2 & 3).

The paper averages on-demand 8-GPU and spot 2-GPU H100 pricing across
AWS/GCP; we keep those dollar figures so cost-efficiency results are
directly comparable.
"""

ON_DEMAND_NODE_PER_H = 83.79     # reserved 8-accelerator training node
SPOT_INSTANCE_PER_H = 5.32       # preemptible 2-accelerator rollout instance


def run_cost(reserved_nodes: int, spot_instance_seconds: float,
             duration_s: float) -> float:
    """Total $ for a run: reserved nodes for the whole duration + spot
    instance-seconds actually held."""
    return (reserved_nodes * ON_DEMAND_NODE_PER_H * duration_s / 3600.0
            + SPOT_INSTANCE_PER_H * spot_instance_seconds / 3600.0)


def cost_efficiency(tokens: float, cost: float) -> float:
    """Tokens trained per dollar (the paper's cost-efficiency metric)."""
    return tokens / max(cost, 1e-9)
