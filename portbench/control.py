#!/usr/bin/env python3
"""The readings that a cell's limits are set from, besides the program's
own: the plain reference put in the program's place, computed in the
control's precision (``tf32`` for an f32 cell, ``fp8`` for a bf16 one) or
with one of the faults a training cell can have planted (``half_batch``:
the loss a mean over half of each batch; ``no_sync``: the EASGD exchange
left out), each compared with the reference as the program is. A step
that returns its state unchanged reads 1 in ``change_gap`` and needs no
run.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --variants fp8,half_batch

Prints one JSON line a seed and variant: the numbers and the cell's
limits. The benchmark's runs never run this; the tests run it at a small
size on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

from portbench import run as harness  # noqa: E402
from portbench.reference import compare, data, dlrm_ref, lm_ref  # noqa: E402


def readings(cell, variant: str, ref: dict = None):
    """((the variant's numbers against the reference, where each reads),
    the reference's own result, which a later call may take back as
    ``ref``)."""
    import torch

    dev = torch.device(cell.device)
    cfg, mix, seed = cell.config, cell.mix, cell.seed
    precision = variant if variant in ("tf32", "fp8") else "float32"
    fault = None if variant in ("tf32", "fp8") else variant
    if cfg["driver"] == "dlrm_sim":
        def go(**kw):
            return dlrm_ref.run(cfg, mix, seed, dev, **kw)
        grad_of = (lambda n: n)
    else:
        R, B, S = mix["replicas"], mix["batch_per_replica"], mix["seq_len"]
        bank = [t.reshape(R, B, S) for t in data.markov_tokens(
            seed, 3, R * B, S, mix["stream_vocab"], dev)]

        def go(**kw):
            return lm_ref.run(cfg, mix, seed, bank, dev, **kw)
        grad_of = lm_ref.grad_of
    if ref is None:
        ref = go()
    alt = go(precision=precision, fault=fault)
    return (compare.checks(alt, ref, cell.limits, grad_of=grad_of),
            compare.where(alt, ref, grad_of=grad_of)), ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(1, os.path.join(os.path.dirname(HERE), "src"))
    bench = harness.manifest()
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.make_cell(bench, args.workload, seed, 0.0, False, args.device)
        ref = None
        for variant in args.variants.split(","):
            t0 = time.perf_counter()
            (checked, at), ref = readings(cell, variant, ref)
            print(json.dumps({"workload": args.workload, "seed": seed, "variant": variant,
                              "fails": not compare.passed(checked), "checks": checked,
                              "where": at, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
