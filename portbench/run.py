#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration and a traffic mix in ``BENCHMARK.json``;
``portbench/configs/<config>.json`` holds the configuration's sizes and
the driver it runs under (``portbench/drivers/<driver>.py``),
``portbench/mixes/<traffic>.json`` the traffic's parameters and
``portbench/limits/<cell>.json`` the limits of the numbers that decide
``correct``. Each metric is read from the run's record by
``portbench/metrics/<metric>.py``: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (from a
traced window that follows the timed one). A metric whose reader finds
nothing to read is left out of the line.

The run loads, warms up, measures for ``--seconds``, checks what the timed
path produced against the plain reference, and prints one JSON line last
on standard output; the numbers compared go to standard error as its last
lines, and last into the line under ``checks``. It exits non-zero and
prints no result where the card is missing or too few, or where a module
of JAX or of the JAX package ``repro`` was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache of a run stays in its checkout, at a fixed path
CACHE = os.path.join(ROOT, ".portbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PRE: Dict[str, float] = {}  # seconds from the process's start to each step before the driver


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: str
    chips: int
    t0: float
    root: str = ROOT


def _json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: str = ROOT):
    """``portbench/<kind>/<name>.py`` under ``root``, by its file (a name
    may hold dots)."""
    path = os.path.join(root, "portbench", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: str = ROOT) -> Dict[str, Any]:
    return _json(root, "BENCHMARK.json")


def metrics_of(bench: Dict[str, Any], cell: str, trace: bool) -> list:
    """The metric entries a cell reports in a run: the end-to-end ones
    whose ``workloads`` name the cell (``setup_s``, without the key, is
    reported everywhere), or with ``trace`` the per-layer ones whose
    ``workloads`` name it."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def make_cell(bench: Dict[str, Any], name: str, seed: int, seconds: float, trace: bool,
              device: str, root: str = ROOT) -> Cell:
    wl = next(w for w in bench["workloads"] if w["name"] == name)
    here = os.path.join(root, "portbench")
    return Cell(name=name, config=_json(here, "configs", f"{wl['config']}.json"),
                mix=_json(here, "mixes", f"{wl['traffic']}.json"),
                limits=_json(here, "limits", f"{name}.json")["limits"], seed=seed,
                seconds=seconds, trace=trace, device=device, chips=wl["chips"], t0=T0,
                root=root)


def execute(bench: Dict[str, Any], cell: Cell) -> Dict[str, Any]:
    """Runs the cell's driver and reads its metrics: the result line, with
    ``checks`` last."""
    import torch

    rec = load_module("drivers", cell.config["driver"], cell.root).run(cell)
    metrics = {}
    for m in metrics_of(bench, cell.name, cell.trace):
        value = load_module("metrics", m["name"], cell.root).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = torch.device(cell.device).type == "cuda"
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell.chips, "memory_peak_bytes": rec["memory_peak_bytes"]}
    if on_card:
        device["power_limit_w"] = power_limit()
    out = {"correct": all(c["value"] <= c["limit"] for c in rec["checks"].values()),
           "attempted": rec["attempted"], "failed": rec["failed"], "metrics": metrics,
           "device": device}
    summ = rec.get("trace")
    if cell.trace and summ is not None:
        device["busy_s"], device["window_s"] = summ["busy_s"], summ["window_s"]
        out["breakdown"] = {"device_ops": summ["device_ops"], "idle_gaps": summ["idle_gaps"]}
    out["phases_s"] = {**rec["phases_s"], "pre": PRE}
    xs = rec.get("iter_s") or []
    if len(xs) >= 4:  # the window's halves and its iterations, for the spread's cause
        h = len(xs) // 2
        out["phases_s"]["iter_ms"] = {
            "first_half_mean": 1e3 * sum(xs[:h]) / h,
            "second_half_mean": 1e3 * sum(xs[h:]) / (len(xs) - h),
            "median": 1e3 * sorted(xs)[len(xs) // 2], "max": 1e3 * max(xs)}
    out["phases_s"]["host_probe_ms"] = host_probe_ms()
    out["worst"] = rec["worst"]
    out["checks"] = rec["checks"]
    return out


def host_probe_ms(n: int = 2_000_000) -> float:
    """Milliseconds of a fixed pure-Python loop, run after the window: the
    host's speed in this run, to set beside the spread of host-paced
    numbers (imports, dispatch)."""
    t, x = time.perf_counter(), 0
    for i in range(n):
        x += i & 7
    return 1e3 * (time.perf_counter() - t)


def power_limit() -> Optional[float]:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(res.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    bench = manifest()
    if not any(w["name"] == args.workload for w in bench["workloads"]):
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    import torch

    PRE["torch"] = time.perf_counter() - T0
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = make_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    out = execute(bench, cell)
    found = loaded_forbidden()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    print("phases " + json.dumps(out.pop("phases_s")), file=sys.stderr)
    for name, at in out.pop("worst").items():
        print(f"worst {name} at {at}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
