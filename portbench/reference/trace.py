"""The device trace of a run's traced window, and its arithmetic.

Frozen from ``chip_smoke.py::traced``: the profiler drops a window's first
device records, whatever their time, so each window opens with
``SACRIFICE`` short spins for it to drop, then a spin as long as the
attempt's pad and a marker spin; a marker spin closes it. The device
records between the two markers are the body's. An attempt that lost
either marker is made again with a longer pad; where none is kept the
trace is None and every metric read from it is left out.

``summary`` reduces the records to what the metric readers take: the
window's length and the seconds in which some device operation ran (the
union of their intervals), device seconds and launches by name, the
device operations that took most time, the idle gaps by what the host
was doing (the innermost host operation running at each gap's middle),
and the device seconds of the harness's own work: the launches that the
host made inside a ``HARNESS`` range (``torch.profiler.record_function``),
matched to their device records by the runtime call's correlation id.
"""
from __future__ import annotations

import heapq
import time
from typing import Callable, Dict, List, Optional, Tuple

MARKER_KERNEL, MARKER_CYCLES, SPIN_HZ = "spin_kernel", 10_000, 1.98e9
PADS_S = (0.05, 0.25, 1.0)
SACRIFICE, SACRIFICE_CYCLES = 256, 1_000
TOP = 10
HARNESS = "portbench.harness"  # the host range around the harness's own launches
RUNTIME = ("cuda", "cu")  # host records of the CUDA runtime and driver calls


def _records(prof) -> Tuple[list, list]:
    """(device, host) records of a finished window as (start_s, end_s,
    name, correlation id)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for r in prof.profiler.kineto_results.events():
        rec = (r.start_ns() / 1e9, r.end_ns() / 1e9, r.name(), r.correlation_id())
        (dev if r.device_type() == DeviceType.CUDA else host).append(rec)
    return dev, host


def harness_s(dev: list, host: list) -> float:
    """Device seconds of the records launched by a runtime call that the
    host made inside a ``HARNESS`` range."""
    ranges = [(s, e) for s, e, n, _ in host if n == HARNESS]
    ids = {c for s, _, n, c in host
           if n.startswith(RUNTIME) and any(a <= s <= b for a, b in ranges)}
    return sum(e - s for s, e, _, c in dev if c in ids)


def union_s(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length of the union of the intervals, its segments in order)."""
    segs: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if segs and a <= segs[-1][1]:
            if b > segs[-1][1]:
                segs[-1] = (segs[-1][0], b)
        else:
            segs.append((a, b))
    return sum(b - a for a, b in segs), segs


def _host_at(points: List[float], host: list) -> List[str]:
    """The innermost host operation running at each of the sorted
    ``points`` (the one that started last), or "host idle"."""
    order = sorted(host)
    heap: list = []  # (-start, end, name) of started operations
    out, k = [], 0
    for p in points:
        while k < len(order) and order[k][0] <= p:
            s, e, n = order[k][:3]
            heapq.heappush(heap, (-s, e, n))
            k += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "host idle")
    return out


def summary(dev: list, host: list) -> Optional[dict]:
    """The traced window's figures, or None where a marker or the body was
    lost."""
    least = MARKER_CYCLES / SPIN_HZ / 2
    marks = sorted((s, e) for s, e, n, _ in dev if MARKER_KERNEL in n and e - s >= least)
    if len(marks) < 2:
        return None
    opened, closed = marks[-2][1], marks[-1][0]
    # a host range (``record_function``) also leaves a device record of its
    # name spanning what it launched: no device work, so left out
    ranges = {n for _, _, n, _ in host}
    body = [r for r in dev if MARKER_KERNEL not in r[2] and r[2] not in ranges
            and r[0] >= opened and r[1] <= closed]
    if not body:
        return None
    busy, segs = union_s([(s, e) for s, e, _, _ in body])
    by_name: Dict[str, List[float]] = {}
    for s, e, n, _ in body:
        t = by_name.setdefault(n, [0.0, 0])
        t[0] += e - s
        t[1] += 1
    edges = [opened] + [x for seg in segs for x in seg] + [closed]
    gaps = [(b - a, (a + b) / 2) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps.sort(key=lambda g: g[1])
    names = _host_at([m for _, m in gaps], host)
    by_host: Dict[str, float] = {}
    for (length, _), n in zip(gaps, names):
        by_host[n] = by_host.get(n, 0.0) + length
    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    top_gap = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": closed - opened, "busy_s": busy, "launches": len(body),
            "kernels": by_name, "harness_s": harness_s(body, host),
            "device_ops": [[n[:120], t] for n, (t, _) in top_dev],
            "idle_gaps": [[n[:120], t] for n, t in top_gap]}


def traced(torch, body: Callable[[], object]):
    """(body's result, the window's ``summary`` or None, the body's host
    seconds). ``body`` runs once an attempt."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA, ProfilerActivity.CPU]
    out, wall = None, 0.0
    for pad_s in PADS_S:
        kept: dict = {}

        def ready(p):
            kept["records"] = _records(p)

        torch.cuda.synchronize()
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            prof.step()
            for _ in range(SACRIFICE):
                torch.cuda._sleep(SACRIFICE_CYCLES)
            torch.cuda.synchronize()
            torch.cuda._sleep(int(pad_s * SPIN_HZ))
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = body()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            time.sleep(pad_s)
            prof.step()
        dev, hst = kept.get("records", ([], []))
        s = summary(dev, hst)
        if s is not None:
            return out, s, wall
    return out, None, wall
