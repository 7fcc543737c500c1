"""Control-plane pieces of the port: the event clock (``events``), the
rollout request record (``requests``), the fault plane (``faults``), the
availability traces (``spot_trace``), the scheduling algorithms
(``load_balancer``, ``seeding``, ``stragglers``, ``microbatch``), the
weight-version registry (``weight_transfer``) and the KV-migration handle
(``kv_migration``)."""
