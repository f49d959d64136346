"""Chrome-trace (chrome://tracing / Perfetto) JSON export.

The port's copy of ``repro.obs.export``. One file per process:
``REPRO_TRACE=<path>`` registers a dump at exit, and ``write_trace(path)``
can be called explicitly. On a world of several ranks the ranks share one
environment, so each rank's dump at exit goes to its own file, the rank in
its name (``recorder.trace_path``: ``trace.json`` -> ``trace.rank1.json``).
We emit

  * ``ph:"X"`` complete events for spans (``ts``/``dur`` in µs),
  * ``ph:"C"`` counter events, one track per counter name,
  * ``ph:"i"`` instant events for planner decisions / ladder rungs,
  * ``ph:"M"`` metadata naming the process and threads.

Timestamps are relative to the recorder's enable-time epoch; the absolute
wall-clock epoch is stored in ``otherData.epoch_unix_s`` so the ranks'
traces can be aligned offline.
"""
from __future__ import annotations

import json
import os

from . import recorder


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


def trace_events() -> list[dict]:
    """The traceEvents list (split out for tests and for merging)."""
    spans, events, series, _epoch = recorder._raw_records()
    pid = os.getpid()
    tid_map: dict[int, int] = {}

    def tid_of(t):
        return tid_map.setdefault(t, len(tid_map))

    out: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": f"repro_torch[{pid}]"},
    }]
    for name, tid, t0, dur, _depth, attrs in spans:
        out.append({
            "name": name, "cat": "span", "ph": "X",
            "ts": round(t0 * 1e6, 3), "dur": round(dur * 1e6, 3),
            "pid": pid, "tid": tid_of(tid),
            "args": {k: _jsonable(v) for k, v in attrs.items()},
        })
    for name, tid, t, attrs in events:
        out.append({
            "name": name, "cat": "event", "ph": "i", "s": "t",
            "ts": round(t * 1e6, 3), "pid": pid, "tid": tid_of(tid),
            "args": {k: _jsonable(v) for k, v in attrs.items()},
        })
    for name, t, total in series:
        out.append({
            "name": name, "cat": "counter", "ph": "C",
            "ts": round(t * 1e6, 3), "pid": pid, "tid": 0,
            "args": {"value": _jsonable(total)},
        })
    for raw, small in tid_map.items():
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": small, "args": {"name": f"thread-{raw}"}})
    return out


def write_trace(path: str):
    """Dump everything recorded so far as a Chrome-trace JSON file."""
    _spans, _events, _series, epoch = recorder._raw_records()
    doc = {
        "traceEvents": trace_events(),
        "displayTimeUnit": "ms",
        "otherData": {"epoch_unix_s": epoch, "pid": os.getpid()},
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path
