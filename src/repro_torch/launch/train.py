"""Training launcher for the port. ``lm`` trains R replicas of a reduced LM
(``core/spmd.py``) on the Markov token stream, with the shadow sync every
``--sync-gap`` iterations; ``dlrm`` runs the deterministic
``HogwildSim`` (n trainers x m Hogwild threads on synthetic CTR, shadow or
fixed-rate sync), or with ``--threaded`` the real-thread
``ThreadedShadowRunner`` (the paper's Algorithm 1: trainer threads on
plan-sharded embedding PSs, a background shadow thread, supervision and the
fault-injection harness), on the CUDA card unless ``--device cpu`` is given.

  python -m repro_torch.launch.train dlrm --full --iters 50
  python -m repro_torch.launch.train dlrm --full --algo gossip --iters 50
  python -m repro_torch.launch.train dlrm --threaded --full --algo bmuf --iters 50
  python -m repro_torch.launch.train dlrm --device cpu --tiny --algo ma \
      --membership-schedule "fail@20:1,join@40:1" --iters 60
  python -m repro_torch.launch.train dlrm --threaded --device cpu --tiny \
      --trainers 2 --iters 25 --batch-size 32 --crash-at 1:10 --ps-fail-at 0:5
  python -m repro_torch.launch.train dlrm --device cpu --tiny --cache-rows 256 --lookahead 2
  python -m repro_torch.launch.train dlrm --device cpu --tiny --iters 10 --save ck
  python -m repro_torch.launch.train dlrm --device cpu --tiny --iters 10 --trainers 6 \
      --restore ck
  python -m repro_torch.launch.train dlrm --device cpu --tiny --pipeline-depth 2
  python -m repro_torch.launch.train dlrm --threaded --device cpu --tiny --trainers 3 \
      --auto-demote --straggler 2:0.05 --straggler-until 2:20
  python -m repro_torch.launch.train dlrm --threaded --device cpu --tiny --auto-mode
  python -m repro_torch.launch.train lm --device cpu --iters 20 --algo bmuf

The flags are the JAX launcher's (``repro/launch/train.py dlrm`` and
``lm``), plus ``--device``;
``--algo`` takes every registered sync algorithm (easgd, ma, bmuf,
gossip). ``--membership-schedule`` drives the sim's elastic membership and,
as in the JAX launcher, is ignored with ``--threaded``, as are ``--save``
and ``--restore`` (checkpoints of the sim's state, in the JAX package's
format; a restore at another ``--trainers`` is elastic). ``--cache-rows N``
keeps N rows of each embedding store on the device (the tiered cache, both
runners) and ``--lookahead K`` peeks K queued batches. ``--pipeline-depth D``
(both runners) stages the embedding lookups of D - 1 batches ahead on a
stager stream, bitwise the serial trajectory. With ``--threaded``,
``--auto-demote`` lets the straggler policy demote and re-admit slots from
their measured pace (``--eps-floor``, ``--probation``), and ``--auto-mode``
starts in fixed_rate and lets the mode controller move the cohort between
fixed_rate and shadow (``--skew-high``, ``--skew-low``, ``--mode-dwell``,
``--mode-window``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np

import torch

from repro_torch import optim
from repro_torch import tree as T
from repro_torch.configs import dlrm_ctr
from repro_torch.configs.base import ARCH_IDS, get_config, reduced
from repro_torch.core import algorithms, spmd
from repro_torch.core.elp import elp
from repro_torch.core.membership import FaultSpec
from repro_torch.core.modeswitch import ModeConfig, ModeController
from repro_torch.core.pipeline import PipelineConfig
from repro_torch.core.runners import HogwildSim, ThreadedShadowRunner
from repro_torch.core.scheduler import PolicyConfig, StragglerPolicy
from repro_torch.core.sync import SyncConfig
from repro_torch.data import tokens as tok
from repro_torch.embeddings.cache import CacheConfig
from repro_torch.kernels.backend import resolve_device


def _parse_slot_map(spec, cast):
    """ "slot:value,slot:value" -> {int: cast}."""
    out = {}
    if spec:
        for part in spec.split(","):
            slot, val = part.split(":")
            out[int(slot)] = cast(val)
    return out


def _parse_schedule(spec):
    """ "kind@iter:slot,..." -> [(iter, kind, slot)] (e.g. "fail@60:2")."""
    events = []
    if spec:
        for part in spec.split(","):
            kind, rest = part.split("@")
            it, slot = rest.split(":")
            events.append((int(it), kind, int(slot)))
    return events or None


def _check_flags(args) -> None:
    """Contradictory or misplaced flags fail loudly, as in the JAX launcher."""
    if args.auto_mode and args.mode is not None:
        raise SystemExit(
            "--auto-mode and --mode contradict: --auto-mode hands the "
            f"shadow/fixed_rate choice to the ModeController, but --mode "
            f"{args.mode} pins it. Drop --mode or drop --auto-mode.")
    if args.straggler_until and not args.straggler:
        raise SystemExit(
            "--straggler-until without --straggler does nothing: "
            "--straggler-until bounds the injected sleep that --straggler "
            'declares, and no slot has one. Add --straggler "slot:seconds" or '
            "drop --straggler-until.")
    if args.pipeline_depth < 1:
        raise SystemExit(f"--pipeline-depth must be >= 1, got {args.pipeline_depth}")
    if args.auto_demote and not args.threaded:
        raise SystemExit(
            "--auto-demote requires --threaded: the deterministic sim has no real pace to "
            "measure; script one with core.scheduler.StragglerSchedule instead")
    if args.auto_mode and not args.threaded:
        raise SystemExit(
            "--auto-mode requires --threaded: the deterministic sim has no real dispersion "
            "to measure; script one with core.modeswitch.ControllerModeSchedule instead")
    chaos = (args.sync_crash_at is not None or args.sync_stall_at is not None
             or args.ps_fail_at or args.raise_at)
    if chaos and not args.threaded:
        raise SystemExit(
            "--sync-crash-at/--sync-stall-at/--ps-fail-at/--raise-at are "
            "chaos injections into the REAL threads; they require --threaded")


def _print_cache(cs: dict) -> None:
    hits = cs["hit_rows"] / max(cs["hit_rows"] + cs["miss_rows"], 1)
    print(f"cache: hit_rate={hits:.3f} stalls={cs['stall_lookups']}/{cs['lookups']} "
          f"prefetched={cs['prefetch_rows']} "
          f"migrated={(cs['bytes_h2d'] + cs['bytes_d2h']) / 1e6:.2f}MB")


def _print_pipeline(ps: dict) -> None:
    # a stager error degrades the run to serial: always shown, never silent
    print(f"pipeline: overlap_rate={ps['overlap_rate']:.3f} overlapped={ps['overlapped']} "
          f"hazard_serialized={ps['hazard_serialized']} drains={ps['drains']} "
          f"worker_errors={ps['worker_errors']}")


def run_threaded(args, cfg, sync_cfg, cache, pipeline) -> dict:
    fault = FaultSpec(
        straggler_sleep_s=_parse_slot_map(args.straggler, float),
        straggler_until=_parse_slot_map(args.straggler_until, int),
        crash_at=_parse_slot_map(args.crash_at, int),
        join_at=_parse_slot_map(args.join_at, int),
        raise_at=_parse_slot_map(args.raise_at, int),
        sync_crash_at=args.sync_crash_at,
        sync_stall_at=args.sync_stall_at,
        sync_stall_s=args.sync_stall_s,
        ps_fail_at=_parse_slot_map(args.ps_fail_at, int),
        ps_recover_after_s=args.ps_recover_after,
    )
    policy = None
    if args.auto_demote:
        # hysteresis: re-admission demands more than marginal health
        # (readmit_frac > eps_floor_frac; above 1.0 means "beat the median")
        policy = StragglerPolicy(
            PolicyConfig(eps_floor_frac=args.eps_floor,
                         readmit_frac=max(args.eps_floor * 1.5, 0.75),
                         probation_s=args.probation),
            n_slots=args.trainers)
    mode_ctl = None
    if args.auto_mode:
        # hysteresis bands and a min-dwell keep the cohort from flapping
        mode_ctl = ModeController(ModeConfig(
            skew_high=args.skew_high, skew_low=args.skew_low, min_dwell_s=args.mode_dwell,
            window_s=args.mode_window, start_mode=sync_cfg.mode))
    runner = ThreadedShadowRunner(
        cfg, sync_cfg, n_trainers=args.trainers, batch_size=args.batch_size,
        optimizer=optim.make(args.optimizer, args.lr), seed=args.seed,
        sync_sleep_s=args.sync_sleep, fault_spec=fault, straggler_policy=policy, cache=cache,
        pipeline=pipeline, mode_controller=mode_ctl, device=args.device)
    print(f"DLRM {'tiny' if args.tiny else 'full'} threaded on {runner.device}: "
          f"{cfg.n_sparse_features} sparse features, {cfg.n_embedding_rows:,} embedding rows "
          f"on {runner.n_emb_shards} PSs {list(runner.plan.shard_rows)}; "
          f"ELP = {elp(args.batch_size, 1, args.trainers):,}"
          + (f"; pipeline depth={args.pipeline_depth}" if pipeline else ""))
    runner.warmup()
    out = runner.run(args.iters)
    if args.auto_mode:
        print(f"mode: final={out['mode']} switches="
              + str([(round(t - out["t_start"], 3), f"{frm}->{to}")
                     for t, frm, to, _ in out["mode_transitions"]]))
    if out["cache_stats"]:
        _print_cache(out["cache_stats"])
    if out["pipeline_stats"]:
        _print_pipeline(out["pipeline_stats"])
    print(f"EPS={out['eps']:.0f} (window {out['eps_window']:.0f})  "
          f"avg_sync_gap={out['avg_sync_gap']:.2f} sync_count={out['sync_count']} "
          f"rounds={out['sync_rounds']} iters/trainer={out['iter_count']} "
          f"final train loss per trainer={[round(l, 4) for l in out['train_loss']]}")
    if out["membership_events"]:
        print("membership:", [(e.kind, e.slot) + ((e.reason,) if e.reason else ())
                              for e in out["membership_events"]])
    if out["supervision_events"]:
        print("supervision:", [(e.kind, e.name, e.reason) for e in out["supervision_events"]])
        print(f"  sync_restarts={out['sync_restarts']} degraded={out['sync_degraded']} "
              f"final_foreground_sync={out['final_foreground_sync']}")
    if out["shard_events"]:
        print("embedding PS:", [(e.kind, e.shard) + ((e.reason,) if e.reason else ())
                                for e in out["shard_events"]])
        print(f"  dropped_updates={out['dropped_updates']} "
              f"stale_lookups={out['stale_lookups']}")
    return {k: v for k, v in out.items()
            if k not in ("w", "emb_state", "membership_events", "supervision_events",
                         "shard_events")}


def run_dlrm(args) -> dict:
    _check_flags(args)
    cfg = dlrm_ctr.tiny(embedding_dim=args.embedding_dim) if args.tiny else dlrm_ctr.CONFIG
    # an auto-mode run starts in fixed_rate (the homogeneous cohort's choice)
    # and lets the controller earn shadow from the measured dispersion
    mode = "fixed_rate" if args.auto_mode else (args.mode or "shadow")
    sync_cfg = SyncConfig(algo=args.algo, mode=mode, gap=args.sync_gap, alpha=args.alpha,
                          delay=args.sync_delay)
    # the tiered cache: N rows of each store on the device, K batches peeked
    cache = (CacheConfig(hot_rows=args.cache_rows, lookahead=args.lookahead)
             if args.cache_rows is not None else None)
    # step pipelining: D - 1 lookups staged ahead behind the hazard check
    pipeline = PipelineConfig(depth=args.pipeline_depth) if args.pipeline_depth > 1 else None
    if args.threaded:
        return run_threaded(args, cfg, sync_cfg, cache, pipeline)
    sim = HogwildSim(cfg, sync_cfg, n_trainers=args.trainers, n_threads=args.threads,
                     batch_size=args.batch_size, optimizer=optim.make(args.optimizer, args.lr),
                     seed=args.seed, schedule=_parse_schedule(args.membership_schedule),
                     cache=cache, pipeline=pipeline, device=args.device)
    print(f"DLRM {'tiny' if args.tiny else 'full'} on {sim.device}: "
          f"{cfg.n_sparse_features} sparse features, {cfg.n_embedding_rows:,} embedding rows; "
          f"ELP = {elp(args.batch_size, args.threads, args.trainers):,}"
          + (f"; cache hot_rows={args.cache_rows} lookahead={args.lookahead}" if cache else "")
          + (f"; pipeline depth={args.pipeline_depth}" if pipeline else ""))
    if args.restore:
        st0 = sim.load_state(args.restore)
        print(f"elastic restore <- {args.restore} (step {st0.step}, now R={sim.R})")
    else:
        st0 = sim.init_state()
    t0 = time.perf_counter()
    out = sim.run(args.iters, log_every=args.log_every, state=st0)
    wall = time.perf_counter() - t0
    ev = sim.evaluate(out["state"], n_batches=args.eval_batches)
    print(f"train loss {np.mean(out['train_loss'][:10]):.5f} -> "
          f"{np.mean(out['train_loss'][-10:]):.5f}; eval {ev:.5f}; "
          f"avg_sync_gap {out['avg_sync_gap']:.2f}; EPS(sim wall) {out['examples'] / wall:.0f}")
    if "cache_stats" in out:
        _print_cache(out["cache_stats"])
    if "pipeline_stats" in out:
        _print_pipeline(out["pipeline_stats"])
    if out.get("membership_events"):
        print("membership:", [(e.kind, e.slot) + ((e.reason,) if e.reason else ())
                              for e in out["membership_events"]])
    if args.save:
        # the engine-independent elastic checkpoint: the dense replicas as
        # the named tree stack, not the flat buffer
        sim.save_state(args.save, out["state"])
        print(f"checkpoint -> {args.save}")
    return {"final_train": float(np.mean(out["train_loss"][-10:])), "eval": ev,
            "avg_sync_gap": out["avg_sync_gap"]}


def run_lm(args) -> dict:
    """The reference's ``run_lm``: R replicas of ``reduced(arch)`` train on
    the stream's batches (R x batch-size sequences an iteration), the sync
    step lands every ``--sync-gap`` iterations. Returns the mean loss of the
    first and last five iterations, and every iteration's mean loss. A vlm
    trains on the stream's tokens alone, as the reference's does; the
    stream carries no audio frames, so the audio family is refused (the
    reference's ``run_lm`` fails on the missing key inside its loss)."""
    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    if cfg.family == "audio":
        raise SystemExit(f"{args.arch}: the lm launcher's token stream carries no audio "
                         "frames, which the audio family's loss needs; train it through "
                         "core/spmd.py with a batch of {'tokens', 'frames'} "
                         "(examples/torch_lm_shadowsync.py)")
    opt = optim.make(args.optimizer, args.lr)
    R = args.replicas
    sync_cfg = SyncConfig(algo=args.algo, alpha=args.alpha).validate()
    params = spmd.init_params(cfg, torch.Generator().manual_seed(args.seed), device=device)
    stack = spmd.stack_replicas(params, R)
    opt_stack = spmd.stack_replicas(opt.init(params), R)
    train_step = spmd.make_train_step(cfg, opt, "shadow")
    sync_step = spmd.make_sync_step(cfg, sync_cfg)
    # opaque per-algorithm state (sync-PS copy, momentum, counter, or None)
    algo_state = algorithms.get(args.algo).init_state(params, sync_cfg)
    del params

    trans = tok.make_transition(cfg.vocab_size, seed=args.seed)
    losses = []
    t0 = time.perf_counter()
    for it in range(args.iters):
        b = tok.gen_batch(trans, args.seed, it, args.batch_size * R, args.seq_len)
        batch = T.map(lambda x: x.reshape(R, args.batch_size, *x.shape[1:]).to(device), b)
        stack, opt_stack, loss = train_step(stack, opt_stack, batch)
        losses.append(float(loss.mean()))
        # the background cadence (the host loop's quantisation of the shadow thread)
        if (it + 1) % args.sync_gap == 0:
            stack, algo_state = sync_step(stack, algo_state)
    wall = time.perf_counter() - t0
    print(f"{args.arch} x{R} replicas [{args.algo}]: loss "
          f"{np.mean(losses[:5]):.4f} -> {np.mean(losses[-5:]):.4f} "
          f"({args.iters} iters, {wall:.1f}s, EPS {args.iters * args.batch_size * R / wall:.1f})")
    return {"loss_start": float(np.mean(losses[:5])), "loss_end": float(np.mean(losses[-5:])),
            "losses": losses}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dlrm")
    d.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    d.add_argument("--algo", choices=list(algorithms.names()), default="easgd")
    d.add_argument("--mode", choices=["shadow", "fixed_rate"], default=None,
                   help="pin the sync mode (default shadow)")
    d.add_argument("--trainers", type=int, default=4)
    d.add_argument("--threads", type=int, default=4)
    d.add_argument("--batch-size", type=int, default=128)
    d.add_argument("--iters", type=int, default=200)
    d.add_argument("--sync-gap", type=int, default=5)
    d.add_argument("--sync-delay", type=int, default=1)
    d.add_argument("--sync-sleep", type=float, default=0.0)
    d.add_argument("--alpha", type=float, default=0.5)
    d.add_argument("--lr", type=float, default=0.02)
    d.add_argument("--optimizer", default="adagrad", choices=sorted(optim.REGISTRY))
    d.add_argument("--embedding-dim", type=int, default=16)
    d.add_argument("--tiny", action="store_true", default=True)
    d.add_argument("--full", dest="tiny", action="store_false")
    d.add_argument("--eval-batches", type=int, default=10)
    d.add_argument("--log-every", type=int, default=50)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--threaded", action="store_true",
                   help="the real-thread runner (ThreadedShadowRunner)")
    d.add_argument("--membership-schedule", default=None,
                   help='the sim\'s elastic membership, "kind@iter:slot,..." '
                        '(kind: fail, leave, join); ignored with --threaded')
    d.add_argument("--save", default=None, help="checkpoint the sim's final state here")
    d.add_argument("--restore", default=None,
                   help="resume the sim from this checkpoint (elastic in --trainers)")
    # The threaded runner's fault-injection harness.
    for flag in ("--crash-at", "--join-at", "--straggler", "--straggler-until", "--raise-at",
                 "--ps-fail-at"):
        d.add_argument(flag, default=None)
    d.add_argument("--sync-crash-at", type=int, default=None)
    d.add_argument("--sync-stall-at", type=int, default=None)
    d.add_argument("--sync-stall-s", type=float, default=10.0)
    d.add_argument("--ps-recover-after", type=float, default=0.25)
    d.add_argument("--auto-demote", action="store_true")
    d.add_argument("--eps-floor", type=float, default=0.5)
    d.add_argument("--probation", type=float, default=1.0)
    d.add_argument("--auto-mode", action="store_true")
    d.add_argument("--skew-high", type=float, default=2.0)
    d.add_argument("--skew-low", type=float, default=1.3)
    d.add_argument("--mode-dwell", type=float, default=2.0)
    d.add_argument("--mode-window", type=float, default=0.5)
    d.add_argument("--cache-rows", type=int, default=None)
    d.add_argument("--lookahead", type=int, default=2)
    d.add_argument("--pipeline-depth", type=int, default=1)

    lm = sub.add_parser("lm")
    lm.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    lm.add_argument("--arch", choices=list(ARCH_IDS), default="minicpm-2b")
    lm.add_argument("--algo", choices=list(algorithms.names()), default="easgd")
    lm.add_argument("--replicas", type=int, default=2)
    lm.add_argument("--batch-size", type=int, default=8)
    lm.add_argument("--seq-len", type=int, default=128)
    lm.add_argument("--iters", type=int, default=60)
    lm.add_argument("--sync-gap", type=int, default=5)
    lm.add_argument("--alpha", type=float, default=0.5)
    lm.add_argument("--lr", type=float, default=1e-3)
    lm.add_argument("--optimizer", default="adam", choices=sorted(optim.REGISTRY))
    lm.add_argument("--seed", type=int, default=0)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the subcommand and prints its result as JSON (for ``lm``, the
    reference's keys; the returned dict adds every iteration's loss)."""
    args = build_parser().parse_args(argv)
    if args.cmd == "lm":
        out = run_lm(args)
        print(json.dumps({k: out[k] for k in ("loss_start", "loss_end")}))
    else:
        out = run_dlrm(args)
        print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
