"""Read torch.profiler traces without TensorBoard.

The port's counterpart of ``diffsci_tpu/profiling.py``, which reads the
XSpace protobufs of ``jax.profiler``. torch.profiler writes Chrome trace
JSON (``prof.export_chrome_trace(path)``, or the ``*.pt.trace.json`` of
``torch.profiler.tensorboard_trace_handler``): a list of events, each
with a category (``cat``), a name, a start (``ts``) and a duration
(``dur``) in microseconds. This module reads the complete events
(``"ph": "X"``) and summarises them with the JAX module's functions and
row fields:

- the ``cuda`` plane is the device: kernels (``cat == "kernel"``) and the
  device's copies and fills (``gpu_memcpy``, ``gpu_memset``);
- the ``cpu`` plane is the host's operators (``cpu_op``, e.g.
  ``aten::mm``), its CUDA runtime calls (``cuda_runtime``,
  ``cuda_driver``) and Python functions;
- a line is an event category.

``device_busy_fraction`` is the union of the kernels' intervals over the
traced window (the first event's start to the last one's end, host
events included), so one minus it is the device's idle share.

Usage:
    from diffsci_tpu_torch import profiling
    trace = profiling.parse_trace(profiling.find_trace(logdir))
    print(profiling.format_summary(profiling.op_summary(trace, "cuda")))
or: ``python -m diffsci_tpu_torch profile <logdir or trace.json>``.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os

PLANES = {"cuda": ("kernel", "gpu_memcpy", "gpu_memset"),
          "cpu": ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
                  "user_annotation")}
KERNEL = "kernel"


@dataclasses.dataclass
class Event:
    name: str
    cat: str
    ts_us: float
    dur_us: float


@dataclasses.dataclass
class Trace:
    path: str
    events: list


def find_trace(logdir: str) -> str:
    """The newest trace under a profiler logdir (``*.pt.trace.json``,
    ``*.json`` or ``*.json.gz``), or ``logdir`` itself when it is a
    file."""
    if os.path.isfile(logdir):
        return logdir
    hits = []
    for root, _dirs, files in os.walk(logdir):
        for fn in files:
            if fn.endswith((".json", ".json.gz")):
                p = os.path.join(root, fn)
                hits.append((os.path.getmtime(p), p))
    if not hits:
        raise FileNotFoundError(f"no trace .json under {logdir}")
    return max(hits)[1]


def parse_trace(path: str) -> Trace:
    """The complete events of a Chrome trace JSON file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        raw = json.load(f)
    items = raw["traceEvents"] if isinstance(raw, dict) else raw
    events = [Event(str(e.get("name", "")), str(e.get("cat", "")),
                    float(e["ts"]), float(e.get("dur", 0.0)))
              for e in items
              if e.get("ph") == "X" and "ts" in e]
    return Trace(path, events)


def _selected(trace: Trace, plane: str, line: str | None = None):
    cats = PLANES.get(plane)
    if cats is None:
        raise ValueError(f"plane must be one of {sorted(PLANES)}, got "
                         f"{plane!r}")
    return [e for e in trace.events if e.cat in cats
            and (line is None or line.lower() in e.cat.lower())]


def op_summary(trace: Trace, plane: str = "cuda",
               line: str | None = None) -> list[dict]:
    """Durations summed by event name on ``plane`` ("cuda" or "cpu"),
    ``line`` a substring filter on the category (e.g. "kernel"). Rows
    sorted by total time: {name, total_us, count, avg_us, pct}, pct of
    the plane's summed time."""
    totals: dict[str, list] = {}
    for e in _selected(trace, plane, line):
        t = totals.setdefault(e.name, [0.0, 0])
        t[0] += e.dur_us
        t[1] += 1
    grand = sum(t[0] for t in totals.values()) or 1.0
    rows = [{"name": k, "total_us": v[0], "count": v[1],
             "avg_us": v[0] / max(v[1], 1), "pct": 100.0 * v[0] / grand}
            for k, v in totals.items()]
    rows.sort(key=lambda r: -r["total_us"])
    return rows


def plane_overview(trace: Trace) -> list[dict]:
    """One row per (plane, line): its event count and summed time."""
    rows = []
    for plane, cats in PLANES.items():
        for cat in cats:
            evs = [e for e in trace.events if e.cat == cat]
            if evs:
                rows.append({"plane": plane, "line": cat,
                             "events": len(evs),
                             "busy_ms": sum(e.dur_us for e in evs) / 1e3})
    rows.sort(key=lambda r: -r["busy_ms"])
    return rows


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        busy += stop - max(start, end)
        end = stop
    return busy


def device_busy_fraction(trace: Trace, plane: str = "cuda") -> float:
    """The union of the plane's events' intervals (kernels only on the
    "cuda" plane) over the traced window, from the first event's start to
    the last one's end."""
    evs = [e for e in _selected(trace, plane)
           if plane != "cuda" or e.cat == KERNEL]
    if not evs or not trace.events:
        return 0.0
    start = min(e.ts_us for e in trace.events)
    stop = max(e.ts_us + e.dur_us for e in trace.events)
    if stop <= start:
        return 0.0
    return _union_us((e.ts_us, e.ts_us + e.dur_us) for e in evs) / (
        stop - start)


def format_summary(rows: list[dict], top: int = 25) -> str:
    out = [f"{'total_us':>12} {'count':>7} {'avg_us':>10} {'pct':>6}  name"]
    for r in rows[:top]:
        out.append(f"{r['total_us']:12.1f} {r['count']:7d} "
                   f"{r['avg_us']:10.2f} {r['pct']:6.2f}  {r['name']}")
    return "\n".join(out)
