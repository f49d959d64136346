"""repro_torch.obs — host-side flight recorder (DESIGN.md §9), the port's
copy of ``repro.obs``.

Spans + counters/gauges/events + Chrome-trace export. Off by default;
``REPRO_TRACE=<path>`` enables recording and dumps a Perfetto-loadable
trace at exit (one file a rank on a world of several, the rank in its
name), ``REPRO_OBS=1`` enables recording without a dump.
"""
from .export import trace_events, write_trace
from .recorder import (capture, counter_add, counters, coverage, disable,
                       enable, enabled, event, events, gauge_set, recording,
                       reset, snapshot, span, sync, timed, tracing)

__all__ = [
    "capture", "counter_add", "counters", "coverage", "disable", "enable",
    "enabled", "event", "events", "gauge_set", "recording", "reset",
    "snapshot", "span", "sync", "timed", "tracing", "trace_events",
    "write_trace",
]
