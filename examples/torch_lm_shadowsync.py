"""ShadowSync beyond the paper, on the PyTorch port: replica-parallel LM
training with a background sync program, on the CUDA card unless
``--device cpu`` is given.

    PYTHONPATH=src python examples/torch_lm_shadowsync.py --arch mamba2-780m [--device cpu]

Two replicas of a reduced LM train on disjoint Markov streams with NO
gradient exchange; a separate sync_step (Shadow-MA by default) reconciles
them periodically (``examples/lm_shadowsync.py``'s run; see
``src/repro_torch/core/spmd.py``). As there, an audio arch (whisper) gets
stubbed conv-frontend frames and a vlm arch (llava) stubbed vision-tower
patch embeddings beside its tokens, Normal * 0.1 drawn anew each iteration
(from numpy, seeded by the iteration).
"""
import argparse

import numpy as np
import torch

from repro_torch import optim
from repro_torch import tree as T
from repro_torch.configs.base import ARCH_IDS, get_config, reduced
from repro_torch.core import algorithms, spmd
from repro_torch.core.sync import SyncConfig
from repro_torch.data import tokens as tok
from repro_torch.kernels.backend import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="mamba2-780m")
    ap.add_argument("--algo", choices=list(algorithms.names()), default="ma")
    ap.add_argument("--iters", type=int, default=80)
    ap.add_argument("--gap", type=int, default=5)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    R = 2
    opt = optim.adam(2e-3)
    params = spmd.init_params(cfg, torch.Generator().manual_seed(0), device=device)
    stack = spmd.stack_replicas(params, R)
    opt_stack = spmd.stack_replicas(opt.init(params), R)

    train_step = spmd.make_train_step(cfg, opt, "shadow")
    sync_cfg = SyncConfig(algo=args.algo, alpha=0.5).validate()
    sync_step = spmd.make_sync_step(cfg, sync_cfg)
    algo_state = algorithms.get(args.algo).init_state(params, sync_cfg)
    del params

    trans = tok.make_transition(cfg.vocab_size, 0)
    losses = []
    for it in range(args.iters):
        b = tok.gen_batch(trans, 0, it, 8 * R, 64)
        rng = np.random.default_rng(it)
        if cfg.family == "audio":  # stubbed conv-frontend embeddings
            b["frames"] = torch.from_numpy(
                rng.standard_normal((8 * R, cfg.encoder.n_ctx, cfg.d_model), np.float32) * 0.1)
        if cfg.family == "vlm":  # stubbed vision-tower patch embeddings
            b["prefix_embeds"] = torch.from_numpy(
                rng.standard_normal((8 * R, cfg.frontend.n_tokens, cfg.d_model), np.float32) * 0.1)
        batch = T.map(lambda x: x.reshape(R, 8, *x.shape[1:]).to(device), b)
        stack, opt_stack, loss = train_step(stack, opt_stack, batch)
        losses.append(float(loss.mean()))
        if (it + 1) % args.gap == 0:
            stack, algo_state = sync_step(stack, algo_state)  # the background program
        if (it + 1) % 20 == 0:
            print(f"iter {it+1}: loss {np.mean(losses[-20:]):.4f}")
    print(f"\n{args.arch}: {np.mean(losses[:5]):.4f} -> {np.mean(losses[-5:]):.4f} "
          f"(2 replicas, Shadow-{args.algo.upper()}, "
          f"zero cross-replica traffic in train_step)")
    return losses


if __name__ == "__main__":
    main()
