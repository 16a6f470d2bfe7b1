"""The profiler over a window, and what is read from its device records.

``profiling`` is ``chip_smoke.py:profiling``: the profiler keeps only the
device records whose times, put on the host's clock, fall between its start
and its stop, and on the H100 machines the two clocks drift apart (by up to
18 ms within one profile), so a pad of idle card lies at both ends, and a
long sleep kernel marks each edge of the body. The engine is idle at both
marks (the window starts before the first request and ends after the last
one has finished), so every step of the window lies between them.

The records are read raw from kineto (kernels, copies, sets; no host
records), so that a window of a million kernels stays cheap to read. Where
the profiler did not keep both edge marks, the window is unknown and
``body`` raises ``MarksLost``: nothing is read over another window.

A kernel's time is its exclusive time: its record less what it overlaps
of the records before it on its stream. A kernel launched early by
programmatic dependent launch starts its record at the kernel before it and
waits at its grid wait while that one runs; that wait belongs to the kernel
before, so a change that only moves how launches overlap moves no kernel's
time. On one stream the exclusive times add up to the busy time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time

import torch

PAD_S = 0.5                  # the card idle before and after a profiled body
EDGE_MARK_CYCLES = 200_000   # the sleep kernels at a profiled body's edges
EDGE_MARK_NS = 20_000        # a sleep kernel longer than this is an edge mark
MARK = "spin_kernel"         # torch.cuda._sleep's kernel; nothing else launches it


@contextlib.contextmanager
def profiling():
    """torch.profiler over the body, device records only, with a pad of
    PAD_S and an edge mark at both ends."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    try:
        x = torch.zeros(1024, device="cuda")
        for _ in range(4):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        torch.cuda._sleep(EDGE_MARK_CYCLES)
        yield prof
        torch.cuda.synchronize()
        torch.cuda._sleep(EDGE_MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    finally:
        prof.stop()


class MarksLost(RuntimeError):
    """The profiler did not keep both edge marks of the traced window."""


@dataclasses.dataclass(frozen=True)
class Record:
    name: str
    start: int      # ns
    end: int        # ns
    stream: int = 0


def _annotation(e) -> bool:
    """Whether a device record is a user annotation (a host range drawn on
    the device's timeline), by what this torch's kineto event offers."""
    if getattr(e, "is_user_annotation", lambda: False)():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and kind() == "gpu_user_annotation"


def device_records(prof) -> list:
    """The device records of a profile, by start."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        if _annotation(e):
            continue
        name = e.name()
        start = e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us()
        dur = (e.duration_ns() if hasattr(e, "duration_ns")
               else 1000 * e.duration_us())
        stream = e.device_resource_id() if hasattr(e, "device_resource_id") else 0
        out.append(Record(name, start, start + dur, stream))
    out.sort(key=lambda r: r.start)
    return out


@dataclasses.dataclass
class Body:
    """The device records between the edge marks, and the window's length."""
    records: list
    window_s: float

    @functools.cached_property
    def exclusive_ns(self) -> list:
        """Each record's exclusive time: from the later of its start and
        the end of the records before it on its stream, to its end."""
        reached: dict = {}
        out = []
        for r in self.records:
            begin = max(r.start, reached.get(r.stream, r.start))
            out.append(max(0, r.end - begin))
            reached[r.stream] = max(begin, r.end)
        return out

    def busy_intervals(self) -> list:
        """The union of the records' intervals, merged, in order."""
        merged = []
        for r in self.records:
            if merged and r.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], r.end)
            else:
                merged.append([r.start, r.end])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def seconds(self, names: tuple) -> float:
        """Exclusive seconds of the records whose name holds any of
        ``names``."""
        return sum(x for r, x in zip(self.records, self.exclusive_ns)
                   if any(n in r.name for n in names)) / 1e9

    def top_ops(self, n: int = 10) -> list:
        """The n device operations that took most exclusive time,
        [short name, s]."""
        by = {}
        for r, x in zip(self.records, self.exclusive_ns):
            k = short(r.name)
            by[k] = by.get(k, 0) + x
        return [[k, v / 1e9] for k, v in sorted(by.items(),
                                                key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest gaps with nothing on the device, each named by the
        records either side of it: a gap before a batch's upload is the
        host scheduling, building and dispatching the next step."""
        by_end, by_start, gaps = {}, {}, []
        for r in self.records:
            by_end[r.end] = r
            by_start.setdefault(r.start, r)
        merged = self.busy_intervals()
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            prev, nxt = by_end.get(e0), by_start.get(s1)
            what = ("host dispatching the next step"
                    if nxt is not None and "HtoD" in nxt.name else "inside a step")
            gaps.append([f"{what}: {short(prev.name) if prev else '?'} -> "
                         f"{short(nxt.name) if nxt else '?'}", (s1 - e0) / 1e9])
        return sorted(gaps, key=lambda g: -g[1])[:n]


def short(name: str, width: int = 80) -> str:
    """A kernel's name without its return type, parameters and the tail of
    its template arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    if "(" in name:
        name = name[:name.index("(")]
    return name.strip()[:width]


def body(records: list) -> Body:
    """The records between the two edge marks; ``MarksLost`` where the
    profiler did not keep both."""
    edges = [i for i, r in enumerate(records)
             if MARK in r.name and r.end - r.start > EDGE_MARK_NS]
    if len(edges) != 2:
        raise MarksLost(f"the profiler kept {len(edges)} of the 2 edge marks "
                        "of the traced window")
    a, b = records[edges[0]], records[edges[1]]
    return Body(records[edges[0] + 1:edges[1]], (b.start - a.end) / 1e9)
