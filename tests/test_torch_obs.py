"""The port's flight recorder (``repro_torch.obs``) held to the JAX
package's ``tests/test_obs.py`` contract.

- ``repro_torch.obs`` exports the JAX package's ``__all__``;
- disabled hooks record nothing, and ``disable`` stops recording;
- ``coverage`` gives the JAX recorder's value on the same spans;
- ``write_trace``'s Chrome-trace schema, non-JSON attributes stringified,
  the counter tracks and the wall-clock epoch;
- ``snapshot()`` has the ``gauges`` and ``deadline`` sections;
- ``REPRO_TRACE`` in a subprocess writes the trace at exit (one file a
  rank on a world of several, the rank in its name); ``REPRO_OBS=1``
  records without a file;
- ``tests/obs_scenario.py``'s seeded 2x2 planned SpGEMM (plain and int8)
  on four gloo ranks, run twice: identical counters on every rank, and
  the port's span and event names a subset of JAX's names for the same run
  on its 2x2 mesh (the JAX side jitted, its names recorded as it traces).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from torch_dist_parity import JaxReference, run_ranks

from repro import obs as j_obs
from repro.obs import recorder as j_recorder
from repro_torch import obs
from repro_torch.obs import recorder
from repro_torch.robust import deadline

ROOT = Path(__file__).resolve().parents[1]
GRID = (2, 2)


def test_exports_match_jax():
    assert obs.__all__ == j_obs.__all__
    for name in obs.__all__:
        assert callable(getattr(obs, name)), name


# --------------------------------------------------------------------------
# disabled mode
# --------------------------------------------------------------------------

def test_disabled_records_nothing():
    with obs.capture() as rec:
        rec.disable()
        assert not rec.enabled() and not rec.recording()
        assert rec.span("s") is recorder._NOOP
        with rec.span("s", k=1):
            rec.counter_add("c", 5)
            rec.gauge_set("g", 1.0)
            rec.event("e", x=1)
        assert rec.timed("t")(lambda x: x + 1)(1) == 2
        assert rec.sync("cuda") is None
        snap = rec.snapshot()
        assert recorder._raw_records()[:3] == ([], [], [])
    assert (snap["spans"], snap["counters"], snap["gauges"],
            snap["events"]) == ({}, {}, {}, {})


def test_disable_stops_recording_and_keeps_records():
    with obs.capture() as rec:
        with rec.span("kept"):
            pass
        rec.disable()
        with rec.span("dropped"):
            pass
        assert set(rec.snapshot()["spans"]) == {"kept"}
        rec.enable()
        rec.event("again")
        assert rec.snapshot()["events"] == {"again": 1}


def test_tracing_is_false_in_the_eager_port():
    assert obs.tracing() is False
    with obs.capture() as rec:
        assert rec.recording() and rec.enabled()


# --------------------------------------------------------------------------
# coverage: the JAX definition on the same spans
# --------------------------------------------------------------------------

# (name, tid, t0, dur, depth, attrs): parents, direct children (one
# overrunning its parent), a grandchild, another thread's span, a sibling
SPAN_SETS = {
    "nested": [("parent", 1, 0.0, 1.0, 0, {}), ("a", 1, 0.1, 0.3, 1, {}),
               ("b", 1, 0.5, 0.25, 1, {}), ("deep", 1, 0.15, 0.1, 2, {})],
    "two_parents": [("parent", 1, 0.0, 0.5, 0, {}),
                    ("parent", 1, 1.0, 0.5, 0, {}),
                    ("a", 1, 0.1, 0.2, 1, {}), ("a", 1, 1.1, 0.4, 1, {}),
                    ("late", 1, 1.4, 0.3, 1, {})],
    "threads": [("parent", 1, 0.0, 1.0, 0, {}), ("a", 2, 0.1, 0.5, 1, {}),
                ("b", 1, 0.2, 0.5, 1, {}), ("parent", 2, 2.0, 1.0, 1, {})],
    "none": [("other", 1, 0.0, 1.0, 0, {})],
}


@pytest.mark.parametrize("name", sorted(SPAN_SETS))
def test_coverage_matches_jax(name):
    spans = SPAN_SETS[name]
    with obs.capture() as rec, j_obs.capture() as jrec:
        recorder._spans[:] = spans
        j_recorder._spans[:] = spans
        got, want = rec.coverage("parent"), jrec.coverage("parent")
    assert got == want
    if name != "none":
        assert 0 < got <= 1


def test_coverage_of_live_spans():
    with obs.capture() as rec:
        with obs.span("parent"):
            with obs.span("child"):
                time.sleep(0.005)
        cov = rec.coverage("parent")
    assert 0.5 < cov <= 1.0


# --------------------------------------------------------------------------
# Chrome-trace schema
# --------------------------------------------------------------------------

def test_trace_file_schema(tmp_path):
    path = str(tmp_path / "trace.json")
    with obs.capture() as rec:
        with obs.span("s", k="v"):
            obs.counter_add("bytes", 128)
        obs.gauge_set("level", 3.5)
        obs.event("decision", rung="serial-schedule")
        rec.write_trace(path)
        epoch = recorder._raw_records()[3]
    doc = json.load(open(path))
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}
    assert doc["displayTimeUnit"] == "ms"
    assert {"epoch_unix_s", "pid"} <= set(doc["otherData"])
    assert doc["otherData"]["epoch_unix_s"] == epoch
    assert abs(epoch - time.time()) < 600
    evs = doc["traceEvents"]
    assert {"X", "C", "i", "M"} <= {e["ph"] for e in evs}
    for e in evs:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0 and e["cat"] == "span"
        if e["ph"] == "i":
            assert e["s"] == "t" and e["cat"] == "event"
        if e["ph"] == "C":
            assert "value" in e["args"]
    (inst,) = [e for e in evs if e["ph"] == "i"]
    assert inst["args"]["rung"] == "serial-schedule"
    tracks = {e["name"]: e["args"]["value"] for e in evs if e["ph"] == "C"}
    assert tracks == {"bytes": 128, "level": 3.5}


def test_nonjson_attrs_stringified():
    with obs.capture() as rec:
        with obs.span("s", obj=np.int64(3), tup=("a", "b")):
            pass
        evs = rec.trace_events()
    (e,) = [x for x in evs if x.get("cat") == "span"]
    json.dumps(e)
    assert e["args"]["tup"] == "('a', 'b')"


def test_snapshot_has_gauges_and_deadline_sections():
    with deadline.configure(startup_deadline=1.0):
        with obs.capture() as rec:
            rec.gauge_set("queue", 7)
            with deadline.watch("site.e"):
                pass
            snap = rec.snapshot()
    assert snap["gauges"] == {"queue": 7}
    assert snap["deadline"]["site.e"]["n"] == 1
    assert set(snap) == {"spans", "counters", "gauges", "events",
                         "deadline"}


# --------------------------------------------------------------------------
# start-up from the environment
# --------------------------------------------------------------------------

CHILD = """
from repro_torch import obs
from repro_torch.obs import recorder
import sys
if len(sys.argv) > 1:
    recorder.set_rank(int(sys.argv[1]), 4)
with obs.span("child.work", k=1):
    obs.counter_add("child.bytes", 64)
obs.event("child.done")
print(obs.enabled())
"""


@pytest.mark.parametrize("env,rank", [("REPRO_TRACE", None),
                                      ("REPRO_TRACE", 2), ("REPRO_OBS", None)])
def test_env_start_up(tmp_path, env, rank):
    path = tmp_path / "trace.json"
    e = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    e.pop("REPRO_TRACE", None)
    e.pop("REPRO_OBS", None)
    e[env] = str(path) if env == "REPRO_TRACE" else "1"
    argv = [] if rank is None else [str(rank)]
    proc = subprocess.run([sys.executable, "-c", CHILD] + argv, env=e,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "True"
    files = sorted(p.name for p in tmp_path.iterdir())
    if env == "REPRO_OBS":
        assert files == []
        return
    want = "trace.json" if rank is None else f"trace.rank{rank}.json"
    assert files == [want]
    doc = json.load(open(tmp_path / want))
    names = {ev["name"] for ev in doc["traceEvents"]}
    assert {"child.work", "child.bytes", "child.done"} <= names


# --------------------------------------------------------------------------
# tests/obs_scenario.py on 2x2: determinism and the names against JAX's
# --------------------------------------------------------------------------

def _scenario(F):
    """``tests/obs_scenario.py``'s workload: a seeded 128 x 128 matrix on
    2x2, its planned square, plain and int8-compressed."""
    rng = np.random.default_rng(7)
    n, nnz = 128, 900
    r = rng.integers(0, n, nnz).astype(np.int64)
    c = rng.integers(0, n, nnz).astype(np.int64)
    v = rng.random(nnz).astype(np.float32)
    a = F.dist.DistSpMat.from_global_coo((n, n), r, c, v, GRID, mesh=F.mesh)
    F.plan.spgemm(a, a, F.semiring.ARITHMETIC, mesh=F.mesh)
    F.plan.spgemm(a, a, F.semiring.ARITHMETIC, mesh=F.mesh, compress="int8")


def _names(snap):
    return sorted(set(snap["spans"]) | set(snap["events"]))


def obs_cases(F):
    """The scenario twice under the recorder: each run's counters and the
    names of its spans and events."""
    import importlib
    rec_mod = importlib.import_module(f"{F.package}.obs")
    out = []
    for _ in range(2):
        with rec_mod.capture() as rec:
            _scenario(F)
            snap = rec.snapshot()
        out.append({"counters": snap["counters"], "names": _names(snap),
                    "events": snap["events"]})
    return out


def jax_obs_names(F):
    """JAX's names for the same run on its 2x2 mesh. The reference's
    multiply runs jitted (``torch_parity.jax_reference``: eagerly its
    ``shard_map`` takes minutes), where the recorder's tracing guard would
    skip every hook inside it; the guard is lifted for spans and events
    alone, so they are recorded as the multiply traces (their names are
    those of an eager run; their times are not read)."""
    real = j_recorder.tracing
    mp = pytest.MonkeyPatch()
    mp.setattr(j_recorder, "tracing", lambda: False)
    mp.setattr(j_recorder, "recording",
               lambda: j_recorder._enabled and not real())
    mp.setattr(j_recorder, "sync", lambda x: x)
    try:
        with j_obs.capture() as rec:
            _scenario(F)
            return _names(rec.snapshot())
    finally:
        mp.undo()


def port_obs(rank, module, grid):
    import importlib
    from torch_dist_parity import Frame
    return importlib.import_module(module).obs_cases(
        Frame("repro_torch", grid))


@pytest.fixture(scope="module")
def scenario_runs():
    jax = JaxReference(__name__, "jax_obs_names", [GRID])
    port = run_ranks(port_obs, 4, __name__, GRID)
    return port, jax.result()[GRID]


def test_counters_deterministic_across_runs(scenario_runs):
    port, _ = scenario_runs
    for rk, (first, second) in enumerate(port):
        assert first["counters"] == second["counters"], rk
        assert first["events"] == second["events"], rk
        assert any(k.startswith("comm.bytes.") for k in first["counters"])
        assert first["counters"]["dist.compress.bytes_out"] \
            < first["counters"]["dist.compress.bytes_in"]


def test_names_are_jax_names(scenario_runs):
    port, jax = scenario_runs
    assert {"spgemm2d", "spgemm2d.execute", "spgemm2d.compress",
            "plan.spgemm"} <= set(jax)
    for rk, runs in enumerate(port):
        for run in runs:
            assert set(run["names"]) <= set(jax), (rk, run["names"], jax)
            assert {"spgemm2d", "spgemm2d.execute", "plan.spgemm"} \
                <= set(run["names"])
