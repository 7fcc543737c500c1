"""Flight recorder: one telemetry plane for every subsystem (port of
``repro.obs``).

  * :mod:`repro_torch.obs.tracer` — structured spans on the clock each
    plane already runs on (event clock in sim, wall clock in the real
    engine);
  * :mod:`repro_torch.obs.metrics` — the one registry of dotted-name
    counters/gauges/histograms every ad-hoc counter now lives under;
  * :mod:`repro_torch.obs.perfetto` — Chrome-trace-event export (open a
    run at https://ui.perfetto.dev);
  * :mod:`repro_torch.obs.accounting` — the per-instance stall-accounting
    identity that proves the telemetry complete.
"""

from repro_torch.obs.accounting import (AccountingError, BUCKETS,  # noqa: F401
                                        LaneAccount, aggregate,
                                        check_accounting)
from repro_torch.obs.metrics import (Histogram, MetricsRegistry,  # noqa: F401
                                     RegistryCounter, summarize)
from repro_torch.obs.perfetto import export_chrome_trace  # noqa: F401
from repro_torch.obs.tracer import NULL_TRACER, Span, Tracer  # noqa: F401
