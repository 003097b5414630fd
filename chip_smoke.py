#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which asserts (any failure exits non-zero):
  1. the card's name and power limit, the torch and CUDA versions; TF32 off;
  2. build the hand-written kernels from the sources in the checkout;
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes, and time it beside its bound, the plain version and
     (for the embedding bag) the one PyTorch call computing the same function;
  4. the main path: DLRM at the full width of configs/dlrm_ctr.py::CONFIG,
     shadow EASGD on the flat engine, R=4 trainers x M=4 Hogwild threads x
     B=128, through ``HogwildSim``; then evaluation, a short fixed_rate run
     (every replica fires at once), and a tiny-config run on the card held
     against the same run on the CPU;
  5. the kernel table as one JSON line, then the result line.
"""
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("embedding_bag", "sparse_adagrad", "easgd_update")
# Device-memory rate by card (NVIDIA data sheets); the bound of every kernel
# here is bytes over this rate.
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12, "H200": 4.8e12}
FP32_RATE = 67e12  # H100 SXM, non-tensor fp32 (data sheet)
R, M, B = 4, 4, 128
TIMED_ITERS, WARM_ITERS = 20, 3

# the hand-written kernels' __global__ names, as the profiler reports them
DEVICE_NAMES = {"embedding_bag": "embedding_bag_kernel",
                "sparse_adagrad": "sparse_adagrad_rows_kernel",
                "easgd_round": "easgd_round_kernel"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=20, warm=3):
    """Mean time of one call of ``fn`` over ``reps`` back-to-back calls (CUDA
    events): device time, or the host's time to issue the call where that is
    longer."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(prof):
    """{kernel or copy name: (total device ms, count)} from a torch.profiler trace."""
    from torch.autograd import DeviceType

    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            tot, cnt = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.time_range.elapsed_us() / 1e3, cnt + 1)
    return by_name


def device_ms(torch, fn, reps=20):
    """Device time of everything one call of ``fn`` launches (torch.profiler,
    CUPTI), as {kernel name: ms per call}. Raises if the trace is empty."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {n: t / reps for n, (t, _) in device_kernels(prof).items()}
    assert by_name, "the profiler recorded no device activity"
    return by_name


def timings(torch, kernel_fn, plain_fn, dev_name, library_fn=None):
    """The kernel's device time alone (``ms``) and with its wrapper's other
    launches (``op_ms``), the plain version's and the library call's device
    time, and event-timed calls of the wrapper and the plain version."""
    op = device_ms(torch, kernel_fn)
    ms = sum(t for n, t in op.items() if dev_name in n)
    assert ms > 0, (dev_name, list(op))
    return dict(ms=ms, op_ms=sum(op.values()), call_ms=time_ms(torch, kernel_fn),
                plain_ms=sum(device_ms(torch, plain_fn).values()),
                plain_call_ms=time_ms(torch, plain_fn),
                library_ms=sum(device_ms(torch, library_fn).values()) if library_fn else None)


def bound(nbytes, flops, mem_rate):
    t_bytes, t_ops = nbytes / mem_rate * 1e3, flops / FP32_RATE * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, sim, st, mem_rate):
    """Phase 3. Returns {name: row} for the kernel table (launches filled later)."""
    from repro_torch.embeddings import table as emb
    from repro_torch.kernels.easgd_update.ops import easgd_round_op
    from repro_torch.kernels.easgd_update.ref import easgd_round_ref
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.sparse_adagrad.ops import sparse_adagrad_op
    from repro_torch.kernels.sparse_adagrad.ref import sparse_adagrad_ref

    cfg = sim.cfg
    F, m, d = cfg.n_sparse_features, cfg.multi_hot, cfg.embedding_dim
    batch = sim.make_batch(0)
    ids = emb.global_row_ids(sim.spec, batch["sparse"].reshape(-1, F, m)).reshape(-1, m)
    ids = ids.contiguous()
    n_bags, n_items = ids.shape[0], ids.numel()
    table, acc = st.emb_state["table"], st.emb_state["acc"]
    rows = {}

    # K1 · embedding bag, on the sim's own table and iteration 0's ids
    got, want = embedding_bag_op(table, ids), embedding_bag_ref(table, ids)
    err = (got - want).abs().max().item()
    tol = 1e-5  # same fp32 adds in the same order; the plain reduction may pair them differently
    assert got.shape == (n_bags, d) and err <= tol, ("embedding_bag", err)
    ids_long = ids.long()
    touched = torch.unique(ids)
    n_unique = touched.numel()  # this batch's distinct rows: each is read once
    nbytes = (n_unique * d + n_items + n_bags * d) * 4
    b_ms, b_by = bound(nbytes, n_bags * (m - 1) * d, mem_rate)
    rows["embedding_bag"] = dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag/embedding_bag.py:52",
        max_abs_err=err, tol=tol, bound_ms=b_ms, bound_by=b_by,
        **timings(torch, lambda: embedding_bag_op(table, ids),
                  lambda: embedding_bag_ref(table, ids), DEVICE_NAMES["embedding_bag"],
                  lambda: torch.nn.functional.embedding_bag(ids_long, table, mode="sum")))
    emit({"phase": "kernel", **rows["embedding_bag"], "n_bags": n_bags, "m": m, "d": d,
          "unique_rows": n_unique})

    # K2 · sparse Adagrad, on clones of the sim's tables (4.5 GB each set)
    gen = torch.Generator().manual_seed(1)
    g = (torch.randn((n_bags, d), generator=gen) * 0.01).to("cuda")
    ka, kb = (table.clone(), acc.clone()), (table.clone(), acc.clone())
    sparse_adagrad_op(*ka, ids, g, lr=sim.emb_lr)
    sparse_adagrad_op(*kb, ids, g, lr=sim.emb_lr)
    assert torch.equal(ka[0], kb[0]) and torch.equal(ka[1], kb[1]), "sparse_adagrad not repeatable"
    del kb
    untouched = torch.ones(table.shape[0], dtype=torch.bool, device="cuda")
    untouched[touched.long()] = False
    assert torch.equal(ka[0][untouched], table[untouched]), "untouched table rows changed"
    assert torch.equal(ka[1][untouched], acc[untouched]), "untouched acc rows changed"
    del untouched
    pa = sparse_adagrad_ref(table.clone(), acc.clone(), ids, g, sim.emb_lr)
    err = max((ka[0] - pa[0]).abs().max().item(), (ka[1] - pa[1]).abs().max().item())
    # one running sum per row against index_add_'s atomics, in another order,
    # over runs of up to ~10^3 occurrences of a hot row
    tol = 1e-5
    for k, p in zip(ka, pa):
        torch.testing.assert_close(k, p, rtol=tol, atol=tol)
    nbytes = (n_bags * d + n_items + n_unique * 4 * d) * 4
    b_ms, b_by = bound(nbytes, n_items * 4 * d, mem_rate)
    rows["sparse_adagrad"] = dict(
        name="sparse_adagrad", route="cuda",
        source="src/repro_torch/kernels/sparse_adagrad/csrc/sparse_adagrad.cu",
        replaces="src/repro/kernels/sparse_adagrad/sparse_adagrad.py:89",
        max_abs_err=err, tol=tol, bound_ms=b_ms, bound_by=b_by,
        **timings(torch, lambda: sparse_adagrad_op(*ka, ids, g, lr=sim.emb_lr),
                  lambda: sparse_adagrad_ref(*pa, ids, g, sim.emb_lr),
                  DEVICE_NAMES["sparse_adagrad"]))
    emit({"phase": "kernel", **rows["sparse_adagrad"], "n_items": n_items, "unique_rows": n_unique})
    del ka, pa
    torch.cuda.empty_cache()

    # K3 · EASGD round on the flat (4, 4096, 128) buffer, replicas made to differ
    noise = torch.randn(tuple(st.w_stack.shape), generator=gen).to("cuda") * 0.01
    stack0, ps0 = st.w_stack + noise, st.algo_state.clone()
    plane = stack0.shape[1] * stack0.shape[2] * 4
    for fired_ids in ([2], [3, 0, 2, 1]):  # the shadow landing (F=1); fixed_rate (F=R)
        fired = torch.tensor(fired_ids, dtype=torch.int32, device="cuda")
        snap = stack0.index_select(0, fired.long()) * 1.01
        ks, kp = stack0.clone(), ps0.clone()
        easgd_round_op(ks, kp, snap, fired, 0.5)
        rs, rp = easgd_round_ref(stack0.clone(), ps0.clone(), snap, fired, 0.5)
        err = max((ks - rs).abs().max().item(), (kp - rp).abs().max().item())
        tol = 1e-6  # the same lerps; nvcc may contract a multiply-add into one FMA
        assert err <= tol, ("easgd_round", fired_ids, err)
        for i in set(range(R)) - set(fired_ids):
            assert torch.equal(ks[i], stack0[i]), "an un-fired replica changed"
        nf = len(fired_ids)
        b_ms, b_by = bound((3 * nf + 2) * plane + nf * 4, 6 * nf * plane // 4, mem_rate)
        row = dict(
            name="easgd_round", route="cuda",
            source="src/repro_torch/kernels/easgd_update/csrc/easgd_update.cu",
            replaces="src/repro/kernels/easgd_update/easgd_update.py:130",
            max_abs_err=err, tol=tol, bound_ms=b_ms, bound_by=b_by,
            **timings(torch, lambda: easgd_round_op(ks, kp, snap, fired, 0.5),
                      lambda: easgd_round_ref(rs, rp, snap, fired, 0.5),
                      DEVICE_NAMES["easgd_round"]))
        emit({"phase": "kernel", **row, "fired": nf})
        if nf == 1:
            rows["easgd_round"] = row
    return rows


def profile_window(torch, sim, state, iters):
    """Device time by kernel over ``iters`` main-path iterations. Returns
    (summary, next state)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = sim.run(iters, state=state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_kernels(prof)
    assert by_name, "the profiler recorded no device activity"
    busy = sum(t for t, _ in by_name.values())
    per_kernel = {}
    for k, dev_name in DEVICE_NAMES.items():
        hits = [(t, c) for n, (t, c) in by_name.items() if dev_name in n]
        per_kernel[k] = sum(h[0] for h in hits) / max(sum(h[1] for h in hits), 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
    return {"iters": iters, "wall_ms": wall_ms, "device_ms": busy, "idle_share": 1 - busy / wall_ms,
            "device_launches": sum(c for _, c in by_name.values()),
            "kernel_device_ms_main_path": per_kernel,
            "top_device": [[n[:80], t, c] for n, (t, c) in top],
            "top_host_self": [[e.key[:60], e.self_cpu_time_total / 1e3, e.count] for e in host]}, \
        out["state"]


def reset_counts(ops):
    for op in ops:
        op.launches = 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import optim
    from repro_torch.configs import dlrm_ctr
    from repro_torch.core.runners import HogwildSim
    from repro_torch.core.sync import SyncConfig
    from repro_torch.kernels import backend
    from repro_torch.kernels.easgd_update.ops import easgd_round_op
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
    from repro_torch.kernels.sparse_adagrad.ops import sparse_adagrad_op

    t_start = time.perf_counter()
    # 1 · the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mem_rate = next((v for k, v in MEM_RATE.items() if k in kind), MEM_RATE["H100"])
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "mem_rate_Bps": mem_rate})

    # 2 · build every kernel at once, one nvcc each
    t0 = time.perf_counter()
    built = backend.build(KERNELS)
    for name in KERNELS:
        with open(backend.library_path(name) + ".log") as f:
            ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "kernel": name, "ptxas": ptxas})
    emit({"phase": "build", "built": built, "seconds": time.perf_counter() - t0})

    # 4a · the main path's sim and state (its tables feed phase 3 too)
    cfg = dlrm_ctr.CONFIG
    t0 = time.perf_counter()
    sim = HogwildSim(cfg, SyncConfig(), n_trainers=R, n_threads=M, batch_size=B,
                     optimizer=optim.adagrad(0.02), device="cuda")
    st = sim.init_state()
    torch.cuda.synchronize()
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "rows": cfg.n_embedding_rows, "flat_rows": sim.flat.n_rows, "params": sim.flat.total})

    # 3 · each kernel against its plain version
    rows = check_kernels(torch, sim, st, mem_rate)

    # 4 · the main path
    ops = {"embedding_bag": embedding_bag_op, "sparse_adagrad": sparse_adagrad_op,
           "easgd_round": easgd_round_op}
    warm = sim.run(WARM_ITERS, state=st)
    torch.cuda.synchronize()
    reset_counts(ops.values())
    t0 = time.perf_counter()
    out = sim.run(TIMED_ITERS, state=warm["state"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ev = sim.evaluate(out["state"], n_batches=4, batch_size=4096)
    launches = {k: op.launches for k, op in ops.items()}
    losses = warm["train_loss"] + out["train_loss"]
    assert all(math.isfinite(x) for x in losses) and math.isfinite(ev), (losses, ev)
    assert out["sync_count"] > 0, out["sync_count"]
    assert launches["embedding_bag"] >= TIMED_ITERS, launches
    assert launches["sparse_adagrad"] >= TIMED_ITERS, launches
    assert launches["easgd_round"] > 0, launches
    emit({"phase": "main_path", "mode": "shadow", "iters": TIMED_ITERS,
          "ms_per_iter": wall / TIMED_ITERS * 1e3, "examples_per_s": out["examples"] / wall,
          "loss_first": losses[0], "loss_last": losses[-1], "eval": ev,
          "sync_count": out["sync_count"], "avg_sync_gap": out["avg_sync_gap"],
          "launches": launches, "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    for k, row in rows.items():
        row["launches"] = launches[k]
    t0 = time.perf_counter()
    for t in range(TIMED_ITERS):
        sim.make_batch(t)
    torch.cuda.synchronize()
    emit({"phase": "host", "make_batch_ms": (time.perf_counter() - t0) / TIMED_ITERS * 1e3})
    prof, state = profile_window(torch, sim, out["state"], 5)
    emit({"phase": "profile", **prof})

    # fixed_rate from the same state: every replica lands in one launch (F=R)
    fr = HogwildSim(cfg, SyncConfig(mode="fixed_rate"), n_trainers=R, n_threads=M, batch_size=B,
                    optimizer=optim.adagrad(0.02), device="cuda")
    reset_counts(ops.values())
    out_fr = fr.run(5, state=state)
    assert all(math.isfinite(x) for x in out_fr["train_loss"]), out_fr["train_loss"]
    assert out_fr["sync_count"] == R and easgd_round_op.launches == 1, out_fr["sync_count"]
    emit({"phase": "main_path", "mode": "fixed_rate", "iters": 5,
          "loss_last": out_fr["train_loss"][-1], "sync_count": out_fr["sync_count"]})
    del sim, fr, st, warm, out, out_fr, state
    torch.cuda.empty_cache()

    # the same tiny run on the card and on the CPU (plain versions) agree
    tiny = {}
    for dev in ("cuda", "cpu"):
        s = HogwildSim(dlrm_ctr.tiny(), SyncConfig(gap=4), n_trainers=3, n_threads=2,
                       batch_size=32, optimizer=optim.adagrad(0.02), device=dev)
        o = s.run(12)
        tiny[dev] = (o["train_loss"], o["sync_count"], s.evaluate(o["state"], 2, 256))
    diff = max(abs(a - b) for a, b in zip(tiny["cuda"][0], tiny["cpu"][0]))
    assert tiny["cuda"][1] == tiny["cpu"][1] > 0
    for a, b in zip(tiny["cuda"][0] + [tiny["cuda"][2]], tiny["cpu"][0] + [tiny["cpu"][2]]):
        assert abs(a - b) <= 1e-5 + 1e-4 * abs(b), ("tiny cuda vs cpu", a, b)  # trajectory tol
    emit({"phase": "reference", "max_loss_diff_cuda_vs_cpu": diff, "eval": tiny["cuda"][2]})

    # 5 · the kernel table, the card, the result
    emit({"kernels": [{k: v for k, v in row.items() if k != "tol"} for row in rows.values()]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
