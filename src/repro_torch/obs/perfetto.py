"""Chrome-trace-event export: a run becomes a picture.

Converts a :class:`repro_torch.obs.tracer.Tracer`'s span buffer into the
Chrome trace event JSON format (the subset Perfetto renders): one
*thread* lane per span lane (``inst:N``, ``nic:A``, ``trainer``,
``engine``...), complete ("X") events for closed spans, instant ("i")
events for zero-duration marks, and metadata ("M") events naming and
ordering the lanes.  Load the file at https://ui.perfetto.dev (or
chrome://tracing) — a chaos run shows, per instance, exactly where its
clock went: prefill/decode blocks, pull and migration stalls, grace
notices, death.

Timestamps: Chrome wants microseconds.  Both tracer clocks (event-loop
seconds, ``time.perf_counter`` seconds) scale by 1e6; the sim's virtual
seconds simply *read* as microseconds-scaled wall time in the UI, which
is exactly the deterministic timeline we want to look at.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

_US = 1e6

# lane ordering in the UI: trainer on top, then instances, NICs, engines
_LANE_ORDER = ("trainer", "inst:", "engine", "nic:")


def _lane_sort_key(lane: str):
    for i, prefix in enumerate(_LANE_ORDER):
        if lane.startswith(prefix):
            # numeric suffix sorts inst:2 before inst:10
            tail = lane[len(prefix):]
            return (i, int(tail) if tail.isdigit() else 0, lane)
    return (len(_LANE_ORDER), 0, lane)


def export_chrome_trace(tracer, path: Optional[str] = None,
                        *, process_name: str = "rlboost") -> Dict:
    """Render ``tracer``'s spans as a Chrome trace event dict; write it
    as JSON when ``path`` is given.  Returns the dict either way."""
    spans = tracer.spans()
    lanes = sorted({s.lane for s in spans}, key=_lane_sort_key)
    tid = {lane: i + 1 for i, lane in enumerate(lanes)}
    events: List[Dict] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": process_name},
    }]
    for lane in lanes:
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid[lane], "args": {"name": lane}})
        events.append({"name": "thread_sort_index", "ph": "M", "pid": 1,
                       "tid": tid[lane],
                       "args": {"sort_index": tid[lane]}})
    for s in spans:
        if not s.closed:
            continue            # open spans are the checker's problem
        args = dict(s.attrs)
        if s.parent_id is not None:
            args["parent_span"] = s.parent_id
        base = {"name": s.name, "pid": 1, "tid": tid[s.lane],
                "ts": s.t0 * _US, "args": args}
        if s.t1 > s.t0:
            events.append({**base, "ph": "X",
                           "dur": (s.t1 - s.t0) * _US})
        else:
            events.append({**base, "ph": "i", "s": "t"})
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(out, f)
    return out
