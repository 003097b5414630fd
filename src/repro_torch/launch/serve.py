"""Batched serving launcher: prefill a batch of prompts, then decode greedily,
on the CUDA card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --full --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch jamba-1.5-large-398b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-medium-14b --full \
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base --full \
      --batch 32 --prompt-len 4 --gen 64

The flags are the JAX launcher's (``repro/launch/serve.py``), with the same
default arch, mamba2-780m; ``--device`` and ``--full`` (the arch's own
``CONFIG`` at full width instead of ``reduced(...)``) are the port's. After a
warm-up at the timed shape the prefill is timed ``TIMED_PREFILLS`` times and
the median printed. Weights are random, drawn from ``--seed``: at ``--full``
on the card's own generator, leaf by leaf in the config's dtype. Prefill and
decode go through ``core/spmd.py``'s steps, as the reference's launcher's
do. Every family is served; every unwindowed prefill self-attention layer
runs the flash-attention kernel (K9) on the card, whisper's non-causal
encoder layers included. The stubbed frontends' inputs are drawn as the
reference draws them, x 0.1 from a stream of their own: llava's
``prefix_embeds`` (B, 2,880, d), prepended to the prompt (decoding goes on
after them), and whisper's ``frames`` (B, 1,500, d). At ``--full`` they are
drawn in the config's dtype, as the reference's production input specs give
them (``repro/launch/specs.py``), so on the card whisper's encoder runs K9's
bf16 tensor-core kernel; reduced (f32 weights), they are f32, as the
reference's launcher draws them. At full width jamba-1.5-large (398 B
parameters), kimi-k2 and phi3.5-moe do not fit one card.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, get_config, reduced
from repro_torch.core import spmd
from repro_torch.kernels import backend
from repro_torch.models import transformer
from repro_torch.models.layers import dtype_of

# the kernels of the serving path, built before anything is timed
SERVE_KERNELS = ("flash_attention",)
TIMED_PREFILLS = 3


def make_prompts(cfg, batch: int, prompt_len: int, seed: int) -> torch.Tensor:
    """(batch, prompt_len) int64 token ids, from a stream of their own (not the
    weights')."""
    rng = np.random.default_rng([seed, 1])
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(batch, prompt_len)))


def make_frontend(cfg, batch: int, seed: int, dtype=torch.float32,
                  device=None) -> Dict[str, torch.Tensor]:
    """The stubbed frontend's embeddings, Normal * 0.1 from a numpy stream of
    their own (not the prompts' or the weights'), in ``dtype`` on
    ``device``: {"prefix_embeds": (batch, n_tokens, d)} for vlm,
    {"frames": (batch, n_ctx, d)} for audio, {} otherwise."""
    if cfg.family == "vlm":
        key, n = "prefix_embeds", cfg.frontend.n_tokens
    elif cfg.family == "audio":
        key, n = "frames", cfg.encoder.n_ctx
    else:
        return {}
    rng = np.random.default_rng([seed, 2])
    x = rng.standard_normal((batch, n, cfg.d_model), dtype=np.float32) * np.float32(0.1)
    return {key: torch.from_numpy(x).to(device=device, dtype=dtype)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg, prompts: torch.Tensor, n_gen: int, prefill_reps: int = 1,
             frontend: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """Prefill ``prompts`` (B, S) on their device ``prefill_reps`` times, then
    ``n_gen - 1`` greedy decode steps from the last prefill's cache, both
    through ``spmd``'s steps. ``frontend``: ``make_frontend``'s inputs; a
    prefix of P positions goes before the prompt, so the cache holds P + S
    + n_gen positions and decoding starts at P + S. Returns the tokens (B,
    n_gen), the prefill's and the last step's logits, the median prefill
    time and each one (``prefill_s_all``), and the decode time, each closed
    by a device synchronise."""
    dev = prompts.device
    B, S = prompts.shape
    batch = {"tokens": prompts, **(frontend or {})}
    n_prefix = batch["prefix_embeds"].shape[1] if "prefix_embeds" in batch else 0
    prefill_step = spmd.make_prefill_step(cfg, n_prefix + S + n_gen)
    decode_step = spmd.make_decode_step(cfg)
    prefill_s = []
    for _ in range(prefill_reps):
        logits = cache = None  # the last prefill's cache goes before the next is made
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, batch)
        _sync(dev)
        prefill_s.append(time.perf_counter() - t0)
    prefill_logits = logits
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(n_gen - 1):
        logits, cache = decode_step(params, cache, tok, n_prefix + S + i)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.stack(out, dim=1), "prefill_logits": prefill_logits,
            "last_logits": logits, "prefill_s": float(np.median(prefill_s)),
            "prefill_s_all": prefill_s, "decode_s": t_decode}


def warmup(params, cfg, prompts: torch.Tensor,
           frontend: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Build the path's kernels and run one prefill of ``prompts`` and one
    decode step, untimed: no timed call then pays for the build, a first
    library use or the allocator's first growth at the timed shape."""
    if prompts.is_cuda:
        backend.build(SERVE_KERNELS)
    generate(params, cfg, prompts, 2, frontend=frontend)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="mamba2-780m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the arch's own CONFIG at full width (default: reduced)")
    args = ap.parse_args(argv)
    if args.gen < 1:
        raise SystemExit("--gen must be >= 1")

    dev = backend.resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced(get_config(args.arch))
    # at full width the weights are drawn where they live, leaf by leaf
    gen = torch.Generator(device=dev if args.full else "cpu").manual_seed(args.seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = spmd.init_params(cfg, gen, device=dev)
    prompts = make_prompts(cfg, args.batch, args.prompt_len, args.seed).to(dev)
    front_dtype = dtype_of(cfg.dtype) if args.full else torch.float32
    frontend = make_frontend(cfg, args.batch, args.seed, front_dtype, dev)
    warmup(params, cfg, prompts, frontend)
    res = generate(params, cfg, prompts, args.gen, prefill_reps=TIMED_PREFILLS,
                   frontend=frontend)

    B = args.batch
    n_steps = args.gen - 1
    tok_s = n_steps * B / res["decode_s"] if n_steps else float("nan")
    width = "full" if args.full else "reduced"
    print(f"{args.arch} ({width}, {cfg.dtype}, {transformer.n_params(params):,} params) on {dev}: "
          f"prefill {B}x{args.prompt_len} in {res['prefill_s'] * 1e3:.1f}ms "
          f"(median of {TIMED_PREFILLS}: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in res['prefill_s_all'])}); "
          f"decoded {n_steps} steps in {res['decode_s'] * 1e3:.1f}ms "
          f"({tok_s:.1f} tok/s batched)")
    if dev.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    gen_tokens = res["tokens"].cpu().numpy()
    print("first sequence:", gen_tokens[0][:16], "...")
    return {"tokens": gen_tokens, "prefill_ms": res["prefill_s"] * 1e3,
            "decode_tok_s": tok_s,
            "logits_finite": bool(torch.isfinite(res["prefill_logits"]).all()
                                  and torch.isfinite(res["last_logits"]).all())}


if __name__ == "__main__":
    main()
