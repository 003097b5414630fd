#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which asserts (any failure exits non-zero):
  1. the card's name and power limit, the torch and CUDA versions; TF32 off;
  2. build the hand-written kernels from the sources in the checkout; each
     K9 kernel's registers, shared memory and spills (the f32 K9's must be
     0), and the SASS checked: the bf16 K9's for wgmma (HGMMA) and TMA
     loads (UTMALDG), the f32 K9's for TF32 tensor-core products (HMMA);
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes, and time it beside its bound, the plain version and
     (where there is one) the one PyTorch call computing the same function;
     the sparse Adagrad also at the threaded runner's shape and at a hot
     shape (a quarter of the occurrences on one row), with its runs and
     tiles, and K5's out-of-place pull-back in turns with torch.lerp;
  4. the main path: DLRM at the full width of configs/dlrm_ctr.py::CONFIG,
     shadow EASGD on the flat engine, R=4 trainers x M=4 Hogwild threads x
     B=128, through ``HogwildSim``; then evaluation, a short fixed_rate run
     (every replica fires at once), and a tiny-config run on the card held
     against the same run on the CPU;
     then the same path under MA, BMUF and Gossip (launch counts exact
     against the run's own shadow schedule), and each of them with elastic
     membership (a slot fails and rejoins, a spare slot joins: the *_rows
     kernels run and the dead slot stays bitwise frozen);
  5. the threaded path: ``ThreadedShadowRunner`` at the same width, R=4
     trainer threads x B=128 on 4 plan-sharded embedding PSs, shadow EASGD
     on the flat engine, the supervisor on, each thread on its own stream;
     exact launch counts, the device idle share of a profiled run, the cost
     of one PS snapshot; then a threaded fixed_rate run, and a tiny
     one-trainer threaded run on the card held against the CPU's; then the
     threaded path under MA, BMUF and Gossip, and an MA run in which a
     trainer joins (its bootstrap is the live mean, K5);
  6. the tiny elastic runs of MA, BMUF and Gossip on the card held against
     the CPU's; then the tiered embedding cache and checkpoints at full
     width: the sim cached (a 1,048,576-row hot tier, lookahead 2) and
     uncached from one seed, bitwise equal in losses, tables and
     accumulators, with the cache's counters and a profiled window (and K2
     on hot slots, bitwise the full table's only when sorted by row id);
     the threaded runner cached (262,144 hot rows a PS) with four trainers,
     and one fixed_rate trainer bitwise its uncached run; the sim's state
     saved and restored bitwise (two more iterations agree), and restored
     elastically at R+1 (the joined slot is EASGD's PS plane, its optimizer
     state fresh);
     then step pipelining, the straggler policy and mode switching: the
     full-width sim pipelined (depth 2) bitwise its serial run (nothing
     stages there: the small tables share rows between batches); a wide
     configuration (four 4,000,000-row tables, multi-hot 1, R=4 x M=1 x
     B=32) where the stager does stage, at depths 2 and 3, uncached and
     cached, each bitwise its serial run; the threaded runner pipelined at
     full width, and one wide fixed_rate trainer pipelined bitwise its
     serial run; no pipelined run may report a stager error. Then slot 3
     slowed by an injected sleep (set from the pace of the mode, measured
     in phase 5):
     the straggler policy demotes and re-admits it in shadow and in
     fixed_rate, the mode controller moves a fixed_rate cohort to shadow,
     and the full-width sim under a scripted shadow -> fixed_rate ->
     shadow schedule matches its host replay (mode events, syncs, K3);
     then the threaded runner at full width under the port's lockdep
     (``repro_torch.analysis.lockdep``: every lock the run builds, the
     kernel backend's launch locks, and the host's waits on the card and on
     a subprocess checked): fixed_rate EASGD cached and pipelined, beside
     the same run uninstrumented, and the shadow policy run that demotes and
     re-admits slot 3; each without a finding, a lock-order cycle or a
     stall left behind;
  7. the serving path: the DLRM state released (device memory before and
     after), phi3-medium-14b at the full width of its CONFIG (bf16, 14.7 B
     parameters drawn on the card), K9 held against its plain version on
     layer 0's q/k/v at B=4 x 2048 and at the reference tests' shapes and
     granite-20b's MQA layout (f32 on the 3xTF32 kernel, bf16 on the wgmma
     one; f32 also timed at whisper's encoder layout), and
     timed there back to back, after an L2 flush and after a GEMM; then
     ``launch/serve.py``'s warm-up at the timed shape, 5 timed prefills
     (median and spread) + 31 greedy decode steps (exactly 40 K9 launches a
     prefill, all by the tensor-core kernel; finite logits), a profiled
     prefill (with the SM clock sampled) and decode, and a reduced phi3 on
     the card held against the same weights on the CPU;
  8. the LM trainer (``launch/train.py lm``, ``core/spmd.py``), once the
     serving weights are released (device memory before and after): the
     launcher's reduced minicpm-2b run under EASGD, MA, BMUF and Gossip on
     the card (f32, TF32 off), each held against the same run on the CPU;
     then K9's training form (``attention_train_op``) at cell 9's shape
     (4 x 2,048, 36 heads of 64, causal), at the benchmark's s512 (16 x
     512) and at whisper-base's encoder (8 x 1,500 frames, every key): its
     output and gradients within 1e-2 of the plain path in f32 (relative
     norm), its forward and backward kernels timed beside their bounds;
     then minicpm-2b at the full width of its CONFIG with its depth cut to
     24 layers (bf16, R=2 replicas, Adam, shadow EASGD every 5 iterations,
     B=4 x S=2048 a replica): 2 warm-up and 6 timed iterations (median and
     spread, tokens/s, sync ms, peak memory, model FLOP utilisation), a
     profiled iteration's device idle share, a falling finite loss, no
     K1-K9 prefill launch in the training window and K9's training form
     launched 2 x 24 x R times forward and 24 x R backward an iteration
     of the warm-up and timed ones; after its timed iterations, 3
     more under full remat on its stacks, 3 under remat_policy="save_comm"
     (a selective checkpoint keeping each unit's attention and FFN outputs)
     and 3 with parallel_block (PaLM's block on the same weights), each
     with its ms an iteration, peak memory and a finite loss; one counted
     iteration each of full remat and save_comm (the policy keeps 2 products
     a layer and replica, and the recompute runs R x layers fewer wo
     products); before the full-width cell, reduced granite-20b's
     save_comm gradients held against full remat's (rtol 1e-5, atol 1e-6,
     bitwise or not reported); then one step and a sync of a
     reduced minicpm-2b on the card against the CPU, its weights and Adam
     state carried in as numpy (``interop.lm_train_state_from_numpy``);
     (phase 7 ends with cell 12: the same phi3 weights under CONFIG_SWA,
     window 4,096, one 6,144-token prompt through the windowed prefill's
     query-chunked plain path, no K9 launch, then 16 greedy tokens);
  9. the ssm, MoE and hybrid families: mamba2-780m at full width served as
     phase 7 serves (cell 10: 5 timed prefills of B=4 x 2048, 31 decode
     steps, profiled, no K1-K9 launch); one of its layers at B=1 x 512 in
     f32, the chunked scan against 512 decode steps and its gradients
     finite; R=2 replicas of it trained as phase 8 trains minicpm-2b (every
     leaf finite after every step, a falling loss); phi3.5-moe's widths at
     16 of its 32 layers served (cell 11: K9 once a layer, the assignments
     dropped per layer at capacity 1.25, two prefills bitwise equal), and
     the same weights served as the parallel block (``serve_parallel``:
     5 timed prefills, 31 decode steps, K9 16 times a prefill); then
     reduced mamba2, jamba, phi3.5-moe, kimi-k2 and a windowed phi3 on the
     card against the CPU (greedy tokens, logits within 2e-4, one shadow
     step and a sync at the trajectory tolerance);
 10. the vlm and audio families: whisper-base at full width (cell 13), K9
     held against its plain version and timed at its encoder's shape (B=32
     x 1,500 frames, 8 heads of 64, every key), served to 32 clips of bf16
     frames (5 timed prefills, 63 decode steps, exactly 12 K9 launches a
     prefill, profiled) and trained as phase 8 trains minicpm-2b (R=2 x B=8
     clips of 1,500 frames and 448 tokens; no K1-K9 prefill launch, the
     self-attention on K9's training form); then, the
     weights released (device memory before and after), llava-next-34b at
     full width, all 60 layers (cell 14: 68.88 GB of bf16 weights drawn on
     the card), K9 timed at its prefill's shape (B=4 x 3,136, 56 heads on 8
     KV heads of 128, causal) and held against its plain version on layer
     0's own q/k/v, served to 4 prompts of 2,880 image-prefix positions and
     256 tokens (5 timed prefills, 31 decode steps, exactly 60 K9 launches a
     prefill, profiled); then reduced llava and whisper on the card against
     the CPU as phase 9 holds the other families. A ``model_flops`` line for
     each trained cell (9, 10, 13) gives ``roofline.analysis``'s count with
     ``param_count`` beside it, asserted equal to the parameters drawn, as
     every cell's set-up line asserts;
 11. the dry run's roofline (``launch/dryrun.py``, traced on the host at
     each cell's shape, K9 and its training form counted as the card runs
     them) beside the measured
     times of cell 4's and cell 14's prefills and cell 9's shadow step and
     EASGD sync step, with the predicted and measured peak memory; no
     bound may exceed 1.05 times its measured time;
 12. the mesh program (``torch.distributed``'s DeviceMesh and DTensor): a
     one-rank ``nccl`` group and a (1, 1, 1) pod x data x model mesh on the
     card; reduced granite-20b's shadow step (R=1 on "pod") with the MA
     sync, a syncdp step and a prefill (K9 on each rank's local heads; its
     launch counter must rise) on DTensors, each held against the one-card
     step on the card; then the collective table of cell 9's configuration
     (minicpm-2b's widths at 24 layers, B=4 x 2,048 a data rank), traced on
     a fake 2x16x16 and 16x16 process group: the shadow step (no
     collective may cross the pods), the syncdp step and the EASGD sync
     step (both must, on 2x16x16), their cross-pod bytes and t_collective
     at NVLink's 450 GB/s;
 13. the kernel table as one JSON line (K9's f32 kernel a row of its own,
     timed at granite-20b's MQA layout and at whisper's encoder layout,
     with the bounds of both f32 routes), then the result line.
"""
import cProfile
import dataclasses
import gc
import json
import math
import os
import pstats
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# Device-memory rate by card (NVIDIA data sheets); a kernel's bound is the
# larger of its bytes over this rate and its operations over the peak rate
# for their type (FP32_RATE, BF16_RATE).
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12, "H200": 4.8e12}
FP32_RATE = 67e12  # H100 SXM, non-tensor fp32 (data sheet)
TF32_RATE = 495e12  # H100 SXM, dense tf32 tensor cores (data sheet)
BF16_RATE = 989e12  # H100 SXM, dense bf16 tensor cores (data sheet)
R, M, B = 4, 4, 128
TIMED_ITERS, WARM_ITERS = 20, 3
THREADED_ITERS, PROFILED_ITERS = 40, 10  # per trainer thread
N_SHARDS = 4
ALGOS = ("ma", "bmuf", "gossip")
ALGO_ITERS, ALGO_THREADED_ITERS = 20, 20
# the elastic full-width runs: slot 1 fails and rejoins, a spare slot 4 joins
ELASTIC_SCHED = ((3, "fail", 1), (6, "join", 1), (8, "join", 4))
ELASTIC_ITERS = 12
# the reference's schedule (tests/test_membership.py:242), for the tiny runs
TINY_SCHED = ((5, "fail", 1), (9, "join", 1), (11, "join", 3))
SYNC_TOL = 1e-6  # the same lerps; nvcc may contract a multiply-add into one FMA
# the serving path: phi3-medium-14b at full width, B prompts of PROMPT tokens
SERVE_ARCH, SERVE_B, SERVE_PROMPT, SERVE_GEN = "phi3-medium-14b", 4, 2048, 32
PREFILL_REPS = 5  # timed prefills after the warm-up at the same shape; the median is reported
# cell 12: phi3-medium-14b's CONFIG_SWA (window 4,096) on the serving
# weights, one prompt of 6,144 tokens (six query chunks, the window binding
# in the last two), 16 greedy tokens, 3 timed prefills
SWA_PROMPT, SWA_GEN, SWA_REPS = 6144, 16, 3
# K9 tolerances (atol = rtol): f32 the reference's own (tests/test_kernels.py)
ATTN_TOL = {"float32": 2e-4}
# bf16 on phi3's prefill shape: outputs there are ~0.04, so the reference's
# 3e-2 (set for S <= 384) would admit errors as large as the values; the
# output is rounded to bf16 once (half an ulp, 2^-9 relative), so
# atol 6e-3, rtol 1e-2 elementwise and 1e-2 in the relative norm
ATTN_BF16_ATOL, ATTN_BF16_RTOL, ATTN_BF16_REL_NORM = 6e-3, 1e-2, 1e-2
# K9 against its plain version: (B, S, H, KV heads, d, causal), f32 and bf16;
# the last is granite-20b's MQA layout (48 query heads on 1 KV head, d=128)
ATTN_CASES = ((1, 128, 2, 2, 64, True), (1, 128, 2, 2, 64, False), (1, 100, 2, 2, 64, True),
              (1, 100, 2, 2, 64, False), (2, 256, 8, 1, 128, True), (1, 1024, 48, 1, 128, True))
# the f32 kernel's second timed shape: whisper-base's encoder layout (32
# clips of 1,500 frames, 8/8 heads of 64, every key)
ATTN_F32_WHISPER = (32, 1500, 8, 8, 64, False)
# K9's training form against the plain path in f32 on the same bf16 inputs,
# (B, S, H, KV heads, d, causal): cell 9's shape (minicpm-2b, 4 x 2,048, 36
# heads of 64, causal), the benchmark's s512 traffic (16 x 512) and
# whisper-base's encoder as cell 13 trains it (8 clips of 1,500 frames,
# every key); within 1e-2 of it in the relative norm, as the card tests hold
ATTN_TRAIN_CASES = {"cell9_s2048": (4, 2048, 36, 36, 64, True),
                    "s512": (16, 512, 36, 36, 64, True),
                    "whisper_encoder": (8, 1500, 8, 8, 64, False)}
ATTN_TRAIN_REL_NORM = 1e-2
# the tiered cache at full width: the sim's hot tier (1,048,576 rows, 537 MB
# of table + acc, 11.8% of the rows) holds a horizon of three batches (one
# names ~131,000 rows); the threaded runner's, a PS each
CACHE_HOT_ROWS, CACHE_LOOKAHEAD, CACHE_ITERS, CACHE_PROFILED = 1 << 20, 2, 6, 3
THREADED_HOT_ROWS, THREADED_CACHE_ITERS, ONE_TRAINER_ITERS = 1 << 18, 16, 8
CKPT_NEXT_ITERS = 2  # iterations run from the saved and the restored state
# the step pipeline: the full-width sim (nothing stages there: the small
# tables put a shared row in every pair of consecutive batches), and a wide
# configuration where staging happens: four tables of 4,000,000 rows,
# multi-hot 1, R=4 x M=1 x B=32 (512 ids a step), d=64, 8.19 GB of table and
# accumulator; its hot tier holds about three batches, lookahead 2
PIPE_FULL_ITERS, PIPE_WIDE_ROWS, PIPE_WIDE_B, PIPE_WIDE_ITERS = 8, 4_000_000, 32, 12
PIPE_WIDE_HOT, PIPE_THREADED_ITERS, PIPE_ONE_ITERS = 1536, 16, 10
# the straggler (slot 3) sleeps two iterations' worth of the measured
# per-trainer pace in its mode (its busy pace falls to a third of the
# others') for its first STRAGGLE_UNTIL iterations; the busy-clock meters'
# window, the policy's window and probation, and the controller's window
# and dwell are set in such iterations too, so the phase holds at any pace
# of the card (re-admission came at about 18 of them on the H100). The run
# is 64 iterations: the pace is measured over 10 iterations on a shared
# host, and one measured at 0.63 of the run's own pace stretched those
# windows past the end of a 32-iteration run
STRAGGLE_SLEEP, STRAGGLE_METER, STRAGGLE_WINDOW = 2.0, 8.0, 2.0
STRAGGLE_UNTIL, STRAGGLE_ITERS = 4, 64
MODE_ITERS, MODE_SIM_ITERS = 16, 14
MODE_SCRIPT = ((3, "fixed_rate"), (9, "shadow"))  # the sim's scripted handoffs
# lockdep_path: the cached, pipelined fixed_rate run's iterations a trainer
# (gap 4: two barrier rounds), the stall the harness may not leave behind,
# and the graph sites of the kernel backend's launch locks
LOCKDEP_ITERS, LOCKDEP_STALL_S = 8, 0.1
LAUNCH_LOCK_SITES = ("backend._BUILD_LOCK", "backend._COUNT_LOCK")

# the LM trainer: the launcher's reduced run (10 iterations, R=2 x B=4 x
# S=64) per algorithm, card against CPU; then minicpm-2b's CONFIG widths
# (d_model 2304, 36 MHA heads of 64, d_ff 5760, vocab 122,753 padded to
# 122,880, tied, bf16) with its depth cut from 40 to 24 layers: 1.748 B
# parameters, whose bf16 stack (R=2), Adam's f32 m and v, the EASGD PS copy
# and one replica's gradients come to 42 GB, with the out-of-place sync's
# transient on top (all 40 layers: 65 GB steady, no room for it); R=2,
# Adam 1e-3, shadow EASGD alpha 0.5 every 5 iterations, B=4 a replica x
# S=2048 (two query chunks of 1024)
LM_ALGOS = ("easgd", "ma", "bmuf", "gossip")
LM_LAUNCH = ["--iters", "10", "--batch-size", "4", "--seq-len", "64"]
LM_ARCH, LM_LAYERS, LM_R, LM_B, LM_S = "minicpm-2b", 24, 2, 4, 2048
LM_WARM, LM_ITERS, LM_GAP, LM_LR = 2, 6, 5, 1e-3
# the Markov stream's transition is (V, V) f32: over the full vocabulary it
# would be 122,753^2 x 4 B = 60 GB, so the chain runs over the first 4,096
# ids (64 MiB), valid ids of the full model
LM_STREAM_VOCAB = 4096

# the ssm, MoE and hybrid families. Cell 10: mamba2-780m at full width, no
# cut (48 layers, d_model 1,536, 48 SSD heads of 64, d_state 128, chunk 256,
# vocab 50,280 padded to 50,432, tied, bf16): served as phase 7 serves, and
# trained as cell 9 is (LM_R x LM_B x LM_S, Adam, shadow EASGD). One of its
# layers at B=1 x SCAN_L (f32) holds the chunked scan against decode steps.
# Cell 11: phi3.5-moe's widths (d_model 4,096, 32/8 heads of 128, 16
# experts top-2 of d_ff 6,400, vocab 32,064 padded to 32,256, untied,
# bf16) with its depth cut from 32 to 16 layers (42.1 GB; all 32 are 84
# GB), served. Then each family reduced on the card against the CPU.
FAM_SSM_ARCH, FAM_MOE_ARCH, FAM_MOE_LAYERS = "mamba2-780m", "phi3.5-moe-42b-a6.6b", 16
SCAN_L, SCAN_TOL = 512, 2e-3  # the reference test's chunked-vs-sequential bound
FAM_REFERENCE = ("mamba2-780m", "jamba-1.5-large-398b", "phi3.5-moe-42b-a6.6b",
                 "kimi-k2-1t-a32b", "phi3-medium-14b CONFIG_SWA")

# the vlm and audio families. Cell 13: whisper-base at full width, no cut
# (6 encoder + 6 decoder layers, d_model 512, 8 heads of 64, d_ff 2,048,
# 1,500 frames, vocab 51,865 padded to 51,968, tied, bf16: 70.7 M
# parameters), served to B=32 clips of 1,500 bf16 frames with a 4-token
# prompt and 64 greedy tokens (K9 12 times a prefill: 6 encoder, 6 decoder
# self-attention layers), and trained (R=2 x B=8 clips of 1,500 frames and
# 448 tokens, as cell 9: Adam, shadow EASGD). Cell 14: llava-next-34b at
# full width, all 60 layers (d_model 7,168, 56/8 heads of 128, d_ff 20,480,
# vocab 64,000, untied, bf16: 34.44 B parameters, 68.88 GB), served to B=4
# prompts of 2,880 image-prefix positions and 256 tokens, 32 greedy tokens
# (K9 60 times a prefill). Then both reduced on the card against the CPU.
AUD_ARCH, AUD_B, AUD_PROMPT, AUD_GEN, AUD_TRAIN_B, AUD_TRAIN_S = "whisper-base", 32, 4, 64, 8, 448
VLM_ARCH, VLM_B, VLM_PROMPT, VLM_GEN = "llava-next-34b", 4, 256, 32

# the variants of this slice: parallel_block served on cell 11's weights
# (its widths at FAM_MOE_LAYERS layers, B=4 x 2,048, 5 timed prefills, 31
# decode steps), and VARIANT_ITERS iterations of cell 9's stacks under
# full remat, remat_policy="save_comm" and parallel_block, the first two
# then one more iteration with their products counted; reduced granite-20b's
# save_comm gradients against full remat's first, at the reference test's
# tolerance and shape (B=2 x 32 tokens)
VARIANT_ITERS, SAVE_COMM_TOL = 3, dict(rtol=1e-5, atol=1e-6)
# the roofline check: no bound of the dry run's count above this share of
# the measured time (a bound above it means the count is wrong)
ROOFLINE_SLACK = 1.05

# torch.profiler traces: the marker kernel (torch.cuda._sleep's) that opens
# and closes the recorded run, its length, the card's clock for the pad
# spins, and the pad before the run in each attempt (a trace that lost
# device events is made again with the next). The profiler drops the first
# device records of a window, whatever their time: the pad and the opening
# marker of the LM training traces among them, however long the pad. So each
# window opens with TRACE_SACRIFICE spins of SACRIFICE_CYCLES, shorter than
# a marker, for it to drop instead.
MARKER_KERNEL, MARKER_CYCLES, SPIN_HZ = "spin_kernel", 10_000, 1.98e9
TRACE_PADS_S = (0.05, 0.25, 1.0)
TRACE_SACRIFICE, SACRIFICE_CYCLES = 256, 1_000

# the hand-written kernels' __global__ names, as the profiler reports them,
# by the source (kernels/<source>/csrc/<source>.cu) that must build each; a
# tuple names the kernels that one wrapper call launches, once each
DEVICE_NAMES_BY_SOURCE = {
    "embedding_bag": {"embedding_bag": "embedding_bag_kernel"},
    "sparse_adagrad": {"sparse_adagrad": ("sparse_adagrad_tile_kernel",
                                          "sparse_adagrad_combine_kernel")},
    "easgd_update": {"easgd_round": "easgd_round_kernel", "easgd_pair": "easgd_pair_kernel"},
    "ma_update": {"replica_mean": "replica_mean_rows_kernel",
                  "replica_mean_rows": "replica_mean_rows_kernel",
                  "ma_update": "ma_pullback_all_kernel",
                  "ma_update_rows": "ma_pullback_rows_kernel"},
    "bmuf_update": {"bmuf_update": "bmuf_rows_kernel", "bmuf_update_rows": "bmuf_rows_kernel"},
    "gossip_update": {"gossip_pair": "gossip_pair_kernel", "gossip_round": "gossip_round_kernel"},
    "interaction": {"interaction": "interaction_kernel"},
    # both on the tensor cores: bf16 (the serving path) by wgmma, f32 by
    # mma.sync in 3xTF32
    "flash_attention": {"flash_attention": "flash_attention_wgmma_kernel",
                        "flash_attention_f32": "flash_attention_tf32x3_kernel"},
}
# the training form's backward kernels (K9's source, head dims 64 and 128);
# its forward is the bf16 kernel above, with the log-sum-exp written
K9_BWD_KERNELS = ("flash_attention_bwd_delta_kernel", "flash_attention_bwd_dkdv_kernel",
                  "flash_attention_bwd_dq_kernel")
# what the K9 kernels' SASS must hold (patterns): the bf16 kernel's (and the
# backward's two product kernels') tensor-core products and TMA loads, the
# f32 kernel's TF32 products
K9_SASS_OPS = ("HGMMA", "UTMALDG")
K9_F32_SASS_OPS = (r"HMMA\S*\.TF32",)
KERNELS = tuple(DEVICE_NAMES_BY_SOURCE)
K1 = DEVICE_NAMES_BY_SOURCE["embedding_bag"]["embedding_bag"]
DEVICE_NAMES = {k: g for names in DEVICE_NAMES_BY_SOURCE.values() for k, g in names.items()}


def globals_of(dev_name):
    """The __global__ names one wrapper call launches (a name or a tuple)."""
    return (dev_name,) if isinstance(dev_name, str) else dev_name


def hits(dev_name, event_name):
    return any(g in event_name for g in globals_of(dev_name))


STARTED = time.perf_counter()
ROWS = {}  # the last row emitted for each phase (the roofline check reads measured cells')


def emit(obj):
    if "phase" in obj:  # seconds since the script started: where its time goes
        obj = {**obj, "at_s": time.perf_counter() - STARTED}
        ROWS[obj["phase"]] = obj
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


class DeviceEvent:
    """A device record of a trace, as the profiler's raw results give it,
    with the attributes of a parsed event that the phases read (``name``,
    ``device_type``, ``time_range`` in µs). Parsing every record of a
    training iteration into events takes seconds; reading the device
    records raw, a small part of that."""

    __slots__ = ("name", "device_type", "time_range")

    def __init__(self, record):
        from torch.autograd.profiler_util import Interval

        self.name, self.device_type = record.name(), record.device_type()
        self.time_range = Interval(record.start_ns() / 1e3, record.end_ns() / 1e3)


def device_events(prof):
    """The device records of a finished profiler window."""
    from torch.autograd import DeviceType

    return [DeviceEvent(r) for r in prof.profiler.kineto_results.events()
            if r.device_type() == DeviceType.CUDA]


def marker_spans(dev):
    """The time ranges of a trace's pad and marker spins, in order: the
    sacrificial spins are shorter than half a marker."""
    least_us = MARKER_CYCLES / SPIN_HZ * 1e6 / 2
    return sorted((ev.time_range for ev in dev if MARKER_KERNEL in ev.name
                   and ev.time_range.elapsed_us() >= least_us), key=lambda r: r.start)


def device_kernels(events):
    """{kernel or copy name: (total device ms, count)} from torch.profiler events."""
    from torch.autograd import DeviceType

    by_name = {}
    for ev in events:
        if ev.device_type == DeviceType.CUDA:
            tot, cnt = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.time_range.elapsed_us() / 1e3, cnt + 1)
    return by_name


def body_events(events):
    """The device events between the opening and the closing marker spin of
    a trace (the last two marker-long spins), or None where either marker or
    every event between them is missing. The profiler drops a window's first
    records, so a kept opening marker (or the pad before it) means that no
    record of the run was dropped. Device events outside the markers (the
    profiler's own) are left out."""
    from torch.autograd import DeviceType

    dev = [ev for ev in events if ev.device_type == DeviceType.CUDA]
    marks = marker_spans(dev)
    if len(marks) < 2:
        return None
    opened, closed = marks[-2].end, marks[-1].start
    body = [ev for ev in dev if MARKER_KERNEL not in ev.name
            and ev.time_range.start >= opened and ev.time_range.end <= closed]
    return body or None


def lost_summary(events):
    """What a trace that was not kept held: its device events, its pad and
    marker spins, its sacrificial spins, whether the closing marker is the
    one lost (more of the other device events start after the last marker
    kept than end before it) and the names of the device events that are
    not spins."""
    from torch.autograd import DeviceType

    dev = [ev for ev in events if ev.device_type == DeviceType.CUDA]
    names = sorted({ev.name[:60] for ev in dev if MARKER_KERNEL not in ev.name})
    marks = marker_spans(dev)
    work = [ev.time_range for ev in dev if MARKER_KERNEL not in ev.name]
    after = sum(r.start >= marks[-1].end for r in work) if marks else 0
    return {"device_events": len(dev), "marker_spins": len(marks),
            "sacrificial_spins": sum(MARKER_KERNEL in ev.name for ev in dev) - len(marks),
            "closing_marker_lost": after > len(work) - after,
            "names": names[:8]}


def traced(torch, body, warm=True, host=False, check=None):
    """(body's last result, its wall ms, the device events of its recorded
    run, and, if ``host``, the host's key averages), from a torch.profiler
    trace. ``body`` runs in the profiler's warm-up cycle (if ``warm``; its
    events are thrown away), then in the recorded one between two marker
    spins, after TRACE_SACRIFICE short spins and a spin of the card as long
    as the attempt's pad. An attempt whose trace lost device events
    (``body_events``, or ``check(events)`` false) is made again with a
    longer pad, unless it lost its closing marker, which no pad before the
    run brings back; where no attempt was kept, the events are None and the
    caller times with CUDA events or reports the figure as not measured."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    for attempt, pad_s in enumerate(TRACE_PADS_S):
        kept, out = {}, None  # a lost attempt's result goes before the next run

        def ready(p):
            kept["events"] = device_events(p)
            kept["host"] = list(p.key_averages()) if host else None

        torch.cuda.synchronize()
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            if warm:
                body()
                torch.cuda.synchronize()
            prof.step()
            for _ in range(TRACE_SACRIFICE):
                torch.cuda._sleep(SACRIFICE_CYCLES)
            torch.cuda.synchronize()
            torch.cuda._sleep(int(pad_s * SPIN_HZ))
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()  # the body may run on other streams
            t0 = time.perf_counter()
            out = body()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            time.sleep(pad_s)
            prof.step()
        events = body_events(kept.get("events", []))
        if events is not None and (check is None or check(events)):
            return out, wall_ms, events, kept.get("host")
        lost = lost_summary(kept.get("events", []))
        emit({"phase": "trace_lost_events", "attempt": attempt, "pad_s": pad_s, **lost})
        if lost["closing_marker_lost"]:
            break  # no pad before the run brings back its end
    return out, wall_ms, None, None


def event_ms(torch, fn, reps=20, warm=3):
    """Mean device time of one call of ``fn``, from CUDA events recorded
    around each of ``reps`` calls queued behind a spin, so that the card
    never waits on the host: the stand-in where the profiler lost events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(int(0.05 * SPIN_HZ))
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def launched(dev_name, n):
    """A trace check: the kernel(s) ``dev_name`` of ``n`` wrapper calls
    launched, each kernel once a call."""
    return lambda events: sum(c for k, (_, c) in device_kernels(events).items()
                              if hits(dev_name, k)) == n * len(globals_of(dev_name))


def device_ms(torch, fn, reps=20, check=None):
    """Device time of everything ``reps`` calls of ``fn`` launch
    (torch.profiler, CUPTI), as {kernel name: (total ms, launches)}, or None
    where every trace lost events."""

    def body():
        for _ in range(reps):
            fn()

    events = traced(torch, body, check=check)[2]
    return None if events is None else device_kernels(events)


def timings(torch, kernel_fn, plain_fn, dev_name, library_fn=None, reps=20):
    """The kernel's device time a call (``ms``; each wrapper call launches
    it, or each of its kernels, once) and with its wrapper's other launches
    (``op_ms``), the plain
    version's and the library call's device time a call, and event-timed
    calls of the wrapper and the plain version. A figure whose traces all
    lost events is timed with ``event_ms`` instead and named in
    ``event_timed``."""
    event_timed = []
    op = device_ms(torch, kernel_fn, reps, check=launched(dev_name, reps))
    if op is None:
        event_timed += ["ms", "op_ms"]
        ms = op_ms = event_ms(torch, kernel_fn, reps)
        n_traced = 0
    else:
        n_traced = reps
        ms = sum(t for n, (t, _) in op.items() if hits(dev_name, n)) / reps
        op_ms = sum(t for t, _ in op.values()) / reps

    def per_call(key, fn):
        by_name = device_ms(torch, fn, reps)
        if by_name is None:
            event_timed.append(key)
            return event_ms(torch, fn, reps)
        return sum(t for t, _ in by_name.values()) / reps

    out = dict(ms=ms, op_ms=op_ms, traced_launches=n_traced, traced_calls=reps,
               call_ms=time_ms(torch, kernel_fn, reps),
               plain_ms=per_call("plain_ms", plain_fn),
               plain_call_ms=time_ms(torch, plain_fn, reps),
               library_ms=per_call("library_ms", library_fn) if library_fn else None)
    if event_timed:
        out["event_timed"] = event_timed
    return out


def bound(nbytes, flops, mem_rate, op_rate=FP32_RATE):
    t_bytes, t_ops = nbytes / mem_rate * 1e3, flops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_stats(torch, ids, tile):
    """The sorted occurrence list's runs as K2's tiles see them: distinct
    rows, the longest run, runs longer than a tile, tiles, and the runs that
    cross a tile boundary (each leaves partials for the combine kernel)."""
    rows = torch.sort(ids.reshape(-1))[0]
    n = rows.numel()
    counts = torch.unique_consecutive(rows, return_counts=True)[1]
    cut = torch.arange(tile, n, tile, device=rows.device)
    crossing = rows[cut][rows[cut] == rows[cut - 1]]
    return {"n_items": n, "unique_rows": counts.numel(), "longest_run": int(counts.max()),
            "runs_longer_than_tile": int((counts > tile).sum()), "tile": tile,
            "tiles": -(-n // tile), "crossing_runs": torch.unique(crossing).numel()}


def adagrad_f64(torch, table, acc, ids, g, lr, eps=1e-8):
    """The plain version's formula in float64 over the rows ``ids`` names:
    (those rows, their table rows, their acc rows)."""
    rows, slot = torch.unique(ids.reshape(-1).long(), return_inverse=True)
    g64 = g.double().repeat_interleave(ids.shape[1], dim=0)
    a = acc[rows].double().index_add_(0, slot, g64 * g64)
    s = torch.zeros_like(a).index_add_(0, slot, g64)
    return rows, table[rows].double() - lr * torch.rsqrt(a + eps) * s, a


def check_sparse_adagrad(torch, name, shape, table, acc, ids, g, lr, mem_rate, hot=False):
    """K2 on clones of ``table``/``acc`` with (n_bags, m) ``ids``: repeatable
    bit for bit, rows not named untouched, within 1e-5 of its formula in
    float64 and of the plain version; timed beside its bound. At the hot
    shape the plain version itself is off its formula by more than 1e-5 (its
    index_add_ adds ~5e4 steps onto one row, each rounded), so there the
    kernel is held to the float64 formula alone and both errors are kept.
    Returns the table row (launches filled later)."""
    from repro_torch.kernels.sparse_adagrad.ops import sparse_adagrad_op
    from repro_torch.kernels.sparse_adagrad.ref import sparse_adagrad_ref
    from repro_torch.kernels.sparse_adagrad.sparse_adagrad import tile_size

    ka, kb = (table.clone(), acc.clone()), (table.clone(), acc.clone())
    one_launch(sparse_adagrad_op, lambda: sparse_adagrad_op(*ka, ids, g, lr=lr))
    sparse_adagrad_op(*kb, ids, g, lr=lr)
    assert torch.equal(ka[0], kb[0]) and torch.equal(ka[1], kb[1]), (name, "not repeatable")
    del kb
    touched = torch.unique(ids)
    untouched = torch.ones(table.shape[0], dtype=torch.bool, device="cuda")
    untouched[touched.long()] = False
    assert torch.equal(ka[0][untouched], table[untouched]), (name, "untouched table rows changed")
    assert torch.equal(ka[1][untouched], acc[untouched]), (name, "untouched acc rows changed")
    del untouched
    pa = sparse_adagrad_ref(table.clone(), acc.clone(), ids, g, lr)
    err = max((ka[0] - pa[0]).abs().max().item(), (ka[1] - pa[1]).abs().max().item())
    # per-tile sums and their combine in tile order against index_add_'s
    # atomics, in another order, over runs of up to ~10^3 occurrences (5e4 hot)
    tol = 1e-5
    named, t64, a64 = adagrad_f64(torch, table, acc, ids, g, lr)
    exact = {}
    for who, (t, a) in (("kernel", ka), ("plain", pa)):
        exact[who] = max((t[named].double() - t64).abs().max().item(),
                         (a[named].double() - a64).abs().max().item())
    for k, want in zip(ka, (t64, a64)):
        torch.testing.assert_close(k[named], want.float(), rtol=tol, atol=tol)
    if not hot:
        for k, p in zip(ka, pa):
            torch.testing.assert_close(k, p, rtol=tol, atol=tol)
    del named, t64, a64
    n_bags, m = ids.shape
    d = table.shape[1]
    stats = run_stats(torch, ids, tile_size())
    n_items, n_unique = stats["n_items"], stats["unique_rows"]
    # g read once, the sorted ids and the bags once, each distinct row's
    # table and acc read and written once
    nbytes = (n_bags * d + 2 * n_items + n_unique * 4 * d) * 4
    b_ms, b_by = bound(nbytes, n_items * 4 * d, mem_rate)
    row = dict(name=name, route="cuda",
               source="src/repro_torch/kernels/sparse_adagrad/csrc/sparse_adagrad.cu",
               replaces="src/repro/kernels/sparse_adagrad/sparse_adagrad.py:89",
               max_abs_err=err, err_vs_f64=exact["kernel"], plain_err_vs_f64=exact["plain"],
               tol=tol, bound_ms=b_ms, bound_by=b_by, shape=shape,
               **timings(torch, lambda: sparse_adagrad_op(*ka, ids, g, lr=lr),
                         lambda: sparse_adagrad_ref(*pa, ids, g, lr),
                         DEVICE_NAMES["sparse_adagrad"]))
    emit({"phase": "kernel", **row, **stats, "d": d})
    del ka, pa
    torch.cuda.empty_cache()
    return row


def check_kernels(torch, sim, st, mem_rate):
    """Phase 3. Returns {name: row} for the kernel table (launches filled later)."""
    from repro_torch.embeddings import shards
    from repro_torch.embeddings import table as emb
    from repro_torch.kernels.easgd_update.ops import easgd_round_op
    from repro_torch.kernels.easgd_update.ref import easgd_round_ref
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

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

    # K2 · sparse Adagrad: at the sim's shape (iteration 0's ids), at the
    # threaded runner's (one trainer's batch on its heaviest PS), and at a hot
    # shape (a quarter of the sim's occurrences on one row)
    gen = torch.Generator().manual_seed(1)
    g = (torch.randn((n_bags, d), generator=gen) * 0.01).to("cuda")
    rows["sparse_adagrad"] = check_sparse_adagrad(
        torch, "sparse_adagrad", "sim: iteration 0 of the ELP batch", table, acc, ids, g,
        sim.emb_lr, mem_rate)
    plan = shards.plan_shards(sim.spec, N_SHARDS, B)
    local = batch["sparse"].reshape(-1, F, m)[:B]  # one trainer's batch, per-feature ids
    heaviest = max(range(plan.n_shards),
                   key=lambda s_: (len(plan.bins[s_]),
                                   torch.unique(shards._route(plan, s_, local)).numel()))
    ps = shards.shard_states(plan, st.emb_state)[heaviest]
    loc = shards._route(plan, heaviest, local).reshape(-1, m).contiguous()
    g_ps = (torch.randn((loc.shape[0], d), generator=gen) * 0.01).to("cuda")
    rows["sparse_adagrad_threaded_shape"] = check_sparse_adagrad(
        torch, "sparse_adagrad_threaded_shape",
        f"threaded: B={B} on PS {heaviest} of {plan.n_shards} ({len(plan.bins[heaviest])} "
        f"features, {plan.shard_rows[heaviest]} rows)", ps["table"], ps["acc"], loc, g_ps,
        sim.emb_lr, mem_rate)
    del ps
    hot = ids.clone().reshape(-1)
    pick = torch.randperm(n_items, generator=gen)[:n_items // 4].to("cuda")
    hot[pick] = 0  # row 0 of table 0
    rows["sparse_adagrad_hot_shape"] = check_sparse_adagrad(
        torch, "sparse_adagrad_hot_shape", "hot: the sim's ids, a quarter of them on row 0",
        table, acc, hot.reshape(n_bags, m), g, sim.emb_lr, mem_rate, hot=True)
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

    # K4 · EASGD pair exchange on two (4096, 128) planes that differ
    from repro_torch.kernels.easgd_update.ops import easgd_pair_flat_op
    from repro_torch.kernels.easgd_update.ref import easgd_update_ref

    ps, w = st.algo_state.clone(), stack0[1].clone()
    ps_in, w_in = ps.clone(), w.clone()
    kp, kw = easgd_pair_flat_op(ps, w, 0.5)
    rp, rw = easgd_update_ref(ps, w, 0.5)
    err = max((kp - rp).abs().max().item(), (kw - rw).abs().max().item())
    tol = 1e-6  # the same two lerps; nvcc may contract a multiply-add into one FMA
    assert err <= tol, ("easgd_pair", err)
    assert torch.equal(ps, ps_in) and torch.equal(w, w_in), "easgd_pair wrote its inputs"
    assert {kp.data_ptr(), kw.data_ptr()}.isdisjoint({ps.data_ptr(), w.data_ptr()})
    b_ms, b_by = bound(4 * plane, 6 * plane // 4, mem_rate)
    rows["easgd_pair"] = dict(
        name="easgd_pair", route="cuda",
        source="src/repro_torch/kernels/easgd_update/csrc/easgd_update.cu",
        replaces="src/repro/kernels/easgd_update/easgd_update.py:63",
        max_abs_err=err, tol=tol, bound_ms=b_ms, bound_by=b_by,
        **timings(torch, lambda: easgd_pair_flat_op(ps, w, 0.5),
                  lambda: easgd_update_ref(ps, w, 0.5), DEVICE_NAMES["easgd_pair"]))
    emit({"phase": "kernel", **rows["easgd_pair"], "shape": list(ps.shape)})
    return rows


def sync_row(name, source, replaces, err, b, **times):
    return dict(name=name, route="cuda", source=f"src/repro_torch/kernels/{source}",
                replaces=f"src/repro/kernels/{replaces}", max_abs_err=err, tol=SYNC_TOL,
                bound_ms=b[0], bound_by=b[1], **times)


def max_err(got, want):
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def one_launch(op, fn):
    """Run ``fn`` (one call of the wrapper ``op``) and check that it launched
    its kernel exactly once."""
    before = op.launches
    out = fn()
    assert op.launches == before + 1, (op.__name__, op.launches - before)
    return out


def check_sync_kernels(torch, st, mem_rate):
    """Phase 3, K5-K7: every entry point against its plain version on the
    main path's (4, 4096, 128) flat buffer, with replicas that differ. Returns
    {name: row} for the kernel table (launches filled later)."""
    from repro_torch.kernels import backend
    from repro_torch.kernels.bmuf_update.ops import bmuf_sync_op, bmuf_sync_rows_op
    from repro_torch.kernels.bmuf_update.ref import bmuf_update_ref, bmuf_update_rows_ref
    from repro_torch.kernels.gossip_update.ops import gossip_pair_flat_op, gossip_round_op
    from repro_torch.kernels.gossip_update.ref import gossip_pair_ref, gossip_round_ref
    from repro_torch.kernels.ma_update import ops as ma_ops
    from repro_torch.kernels.ma_update import ref as ma_ref

    gen = torch.Generator().manual_seed(2)
    stack0 = st.w_stack + torch.randn(tuple(st.w_stack.shape), generator=gen).to("cuda") * 0.01
    keep = stack0.clone()
    R_, n, lanes = stack0.shape
    plane = n * lanes * 4
    elems = n * lanes

    def i32(ids):
        return torch.tensor(ids, dtype=torch.int32, device="cuda")

    def emit_row(row, **extra):
        emit({"phase": "kernel", **row, **extra})

    rows = {}
    # K5 · replica_mean (rows = all ids) and replica_mean_rows (live ids)
    got = one_launch(ma_ops.replica_mean_op, lambda: ma_ops.replica_mean_op(stack0))
    err = max_err([got], [ma_ref.replica_mean_ref(stack0)])
    assert err <= SYNC_TOL and torch.equal(stack0, keep), ("replica_mean", err)
    rows["replica_mean"] = sync_row(
        "replica_mean", "ma_update/csrc/ma_update.cu", "ma_update/ma_update.py:60", err,
        bound((R_ + 1) * plane + R_ * 4, R_ * elems, mem_rate),
        **timings(torch, lambda: ma_ops.replica_mean_op(stack0),
                  lambda: ma_ref.replica_mean_ref(stack0), DEVICE_NAMES["replica_mean"],
                  lambda: torch.mean(stack0, 0)))
    emit_row(rows["replica_mean"], rows=R_)
    live = backend.index_tensor([0, 2, 3], stack0.device)  # as core/algorithms.py makes them
    A = live.shape[0]
    got = one_launch(ma_ops.replica_mean_rows_op, lambda: ma_ops.replica_mean_rows_op(stack0, live))
    err = max_err([got], [ma_ref.replica_mean_rows_ref(stack0, live)])
    assert err <= SYNC_TOL and torch.equal(stack0, keep), ("replica_mean_rows", err)
    rows["replica_mean_rows"] = sync_row(
        "replica_mean_rows", "ma_update/csrc/ma_update.cu", "ma_update/ma_update.py:108", err,
        bound((A + 1) * plane + A * 4, A * elems, mem_rate),
        **timings(torch, lambda: ma_ops.replica_mean_rows_op(stack0, live),
                  lambda: ma_ref.replica_mean_rows_ref(stack0, live),
                  DEVICE_NAMES["replica_mean_rows"]))
    emit_row(rows["replica_mean_rows"], rows=[0, 2, 3])

    # K5 · ma_update (every row, in place), ma_update_rows (live rows), and
    # the out-of-place pull-back of the threaded round
    mean = ma_ref.replica_mean_ref(stack0) * 1.01
    ks = stack0.clone()
    one_launch(ma_ops.ma_sync_op, lambda: ma_ops.ma_sync_op(ks, mean, 0.5))
    err = max_err([ks], [ma_ref.ma_update_ref(stack0.clone(), mean, 0.5)])
    assert err <= SYNC_TOL, ("ma_update", err)
    rows["ma_update"] = sync_row(
        "ma_update", "ma_update/csrc/ma_update.cu", "ma_update/ma_update.py:168", err,
        bound((2 * R_ + 1) * plane + R_ * 4, 3 * R_ * elems, mem_rate),
        **timings(torch, lambda: ma_ops.ma_sync_op(ks, mean, 0.5),
                  lambda: ma_ref.ma_update_ref(ks, mean, 0.5), DEVICE_NAMES["ma_update"],
                  lambda: ks.lerp_(mean, 0.5)))
    emit_row(rows["ma_update"], in_place=True)
    src, out = stack0[1:2].clone(), torch.empty_like(stack0[1:2])
    one_launch(ma_ops.ma_sync_op, lambda: ma_ops.ma_sync_op(src, mean, 0.5, out=out))
    err = max_err([out], [ma_ref.ma_update_ref(stack0[1:2].clone(), mean, 0.5)])
    assert err <= SYNC_TOL and torch.equal(src, keep[1:2]), ("ma_update out of place", err)
    pull = lambda: ma_ops.ma_sync_op(src, mean, 0.5, out=out)  # noqa: E731
    lerp = lambda: torch.lerp(src, mean, 0.5, out=out)  # noqa: E731
    row = sync_row("ma_update", "ma_update/csrc/ma_update.cu", "ma_update/ma_update.py:168",
                   err, bound(3 * plane + 4, 3 * elems, mem_rate),
                   **timings(torch, pull, lambda: ma_ref.ma_update_ref(src, mean, 0.5, out=out),
                             DEVICE_NAMES["ma_update"], lerp))
    # the kernel and torch.lerp(out=) in turns: kernel, lerp, lerp, kernel, twice
    turns = {"kernel": [], "lerp": []}
    for order in (("kernel", "lerp"), ("lerp", "kernel")) * 2:
        for who in order:
            by_name = device_ms(torch, pull if who == "kernel" else lerp)
            turns[who].append(None if by_name is None
                              else sum(t for t, _ in by_name.values()) / 20)
    emit_row(row, in_place=False, in_turns_ms=turns)
    ks = stack0.clone()
    one_launch(ma_ops.ma_sync_rows_op, lambda: ma_ops.ma_sync_rows_op(ks, mean, live, 0.5))
    err = max_err([ks], [ma_ref.ma_update_rows_ref(stack0.clone(), mean, live, 0.5)])
    assert err <= SYNC_TOL, ("ma_update_rows", err)
    assert torch.equal(ks[1], stack0[1]), "ma_update_rows wrote a row outside rows"
    rows["ma_update_rows"] = sync_row(
        "ma_update_rows", "ma_update/csrc/ma_update.cu", "ma_update/ma_update.py:145", err,
        bound((2 * A + 1) * plane + A * 4, 3 * A * elems, mem_rate),
        **timings(torch, lambda: ma_ops.ma_sync_rows_op(ks, mean, live, 0.5),
                  lambda: ma_ref.ma_update_rows_ref(ks, mean, live, 0.5),
                  DEVICE_NAMES["ma_update_rows"]))
    emit_row(rows["ma_update_rows"], rows=[0, 2, 3])

    # K6 · bmuf_update (Nesterov off and on) and bmuf_update_rows
    wg0 = ma_ref.replica_mean_ref(keep)
    vel0 = torch.randn((n, lanes), generator=gen).to("cuda") * 1e-3
    for nesterov in (False, True):
        kw = dict(eta=0.9, block_momentum=0.5, nesterov=nesterov)
        k = [stack0.clone(), wg0.clone(), vel0.clone()]
        one_launch(bmuf_sync_op, lambda: bmuf_sync_op(k[0], mean, k[1], k[2], 0.5, **kw))
        err = max_err(k, bmuf_update_ref(stack0.clone(), mean, wg0.clone(), vel0.clone(), 0.5,
                                         **kw))
        assert err <= SYNC_TOL, ("bmuf_update", nesterov, err)
        row = sync_row("bmuf_update", "bmuf_update/csrc/bmuf_update.cu",
                       "bmuf_update/bmuf_update.py:82", err,
                       bound((2 * R_ + 5) * plane + R_ * 4, (3 * R_ + 8) * elems, mem_rate),
                       **timings(torch, lambda: bmuf_sync_op(k[0], mean, k[1], k[2], 0.5, **kw),
                                 lambda: bmuf_update_ref(k[0], mean, k[1], k[2], 0.5, **kw),
                                 DEVICE_NAMES["bmuf_update"]))
        emit_row(row, nesterov=nesterov)
        if not nesterov:
            rows["bmuf_update"] = row
    kw = dict(eta=0.9, block_momentum=0.5, nesterov=False)
    k = [stack0.clone(), wg0.clone(), vel0.clone()]
    one_launch(bmuf_sync_rows_op,
               lambda: bmuf_sync_rows_op(k[0], mean, k[1], k[2], live, 0.5, **kw))
    err = max_err(k, bmuf_update_rows_ref(stack0.clone(), mean, wg0.clone(), vel0.clone(), live,
                                          0.5, **kw))
    assert err <= SYNC_TOL, ("bmuf_update_rows", err)
    assert torch.equal(k[0][1], stack0[1]), "bmuf_update_rows wrote a row outside rows"
    rows["bmuf_update_rows"] = sync_row(
        "bmuf_update_rows", "bmuf_update/csrc/bmuf_update.cu", "bmuf_update/bmuf_update.py:157",
        err, bound((2 * A + 5) * plane + A * 4, (3 * A + 8) * elems, mem_rate),
        **timings(torch, lambda: bmuf_sync_rows_op(k[0], mean, k[1], k[2], live, 0.5, **kw),
                  lambda: bmuf_update_rows_ref(k[0], mean, k[1], k[2], live, 0.5, **kw),
                  DEVICE_NAMES["bmuf_update_rows"]))
    emit_row(rows["bmuf_update_rows"], rows=[0, 2, 3])

    # K7 · gossip_pair (out of place) and gossip_round at P=4 and P=2
    a, b = stack0[0].clone(), stack0[1].clone()
    got = one_launch(gossip_pair_flat_op, lambda: gossip_pair_flat_op(a, b, 0.5))
    err = max_err(got, gossip_pair_ref(a, b, 0.5))
    assert err <= SYNC_TOL, ("gossip_pair", err)
    assert torch.equal(a, keep[0]) and torch.equal(b, keep[1]), "gossip_pair wrote its inputs"
    assert {got[0].data_ptr(), got[1].data_ptr()}.isdisjoint({a.data_ptr(), b.data_ptr()})
    rows["gossip_pair"] = sync_row(
        "gossip_pair", "gossip_update/csrc/gossip_update.cu", "gossip_update/gossip_update.py:66",
        err, bound(4 * plane, 6 * elems, mem_rate),
        **timings(torch, lambda: gossip_pair_flat_op(a, b, 0.5),
                  lambda: gossip_pair_ref(a, b, 0.5), DEVICE_NAMES["gossip_pair"]))
    emit_row(rows["gossip_pair"])
    for land, self_pos, partner_pos in (([0, 1, 2, 3], [0, 1, 2, 3], [1, 0, 3, 2]),
                                        ([1, 3], [0, 1], [1, 0])):
        P = len(land)
        args = (i32(land), i32(self_pos), i32(partner_pos))
        snap = stack0.index_select(0, args[0].long()) * 1.01  # a separate launch gather
        ks = stack0.clone()
        one_launch(gossip_round_op, lambda: gossip_round_op(ks, snap, *args, 0.5))
        err = max_err([ks], [gossip_round_ref(stack0.clone(), snap, *args, 0.5)])
        assert err <= SYNC_TOL, ("gossip_round", P, err)
        for i in set(range(R_)) - set(land):
            assert torch.equal(ks[i], stack0[i]), "gossip_round wrote a row outside land"
        row = sync_row("gossip_round", "gossip_update/csrc/gossip_update.cu",
                       "gossip_update/gossip_update.py:127", err,
                       bound(3 * P * plane + 3 * P * 4, 5 * P * elems, mem_rate),
                       **timings(torch, lambda: gossip_round_op(ks, snap, *args, 0.5),
                                 lambda: gossip_round_ref(ks, snap, *args, 0.5),
                                 DEVICE_NAMES["gossip_round"]))
        emit_row(row, participants=P)
        if P == R_:
            rows["gossip_round"] = row
    return rows


def check_interaction(torch, mem_rate):
    """Phase 3, K8: the interaction kernel at DLRM CONFIG's shape, z of the
    ELP's R*M*B samples x (1 + 26) features x d = 64, against its plain
    version. Its wrapper is its only path, as in the reference (whose DLRM
    computes the same dots with einsum). Returns the table row."""
    from repro_torch.configs import dlrm_ctr
    from repro_torch.kernels.interaction.ops import interaction_op
    from repro_torch.kernels.interaction.ref import interaction_ref

    cfg = dlrm_ctr.CONFIG
    n, F, d = R * M * B, cfg.n_sparse_features + 1, cfg.embedding_dim
    z = torch.randn((n, F, d), generator=torch.Generator().manual_seed(3)).to("cuda")
    got = one_launch(interaction_op, lambda: interaction_op(z))
    want = interaction_ref(z)
    err = max_err([got], [want])
    tol = 1e-5  # the reference's (tests/test_kernels.py); f32 dots summed in another order
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    P = F * (F - 1) // 2
    iu, ju = torch.triu_indices(F, F, offset=1, device="cuda")
    row = dict(name="interaction", route="cuda",
               source="src/repro_torch/kernels/interaction/csrc/interaction.cu",
               replaces="src/repro/kernels/interaction/interaction.py:35",
               max_abs_err=err, tol=tol,
               **dict(zip(("bound_ms", "bound_by"),
                          bound(z.numel() * 4 + n * P * 4, 2 * n * P * d, mem_rate))),
               # library: two calls, the Gram matrix then its triangle
               **timings(torch, lambda: interaction_op(z), lambda: interaction_ref(z),
                         DEVICE_NAMES["interaction"],
                         lambda: torch.bmm(z, z.transpose(1, 2))[:, iu, ju]))
    emit({"phase": "kernel", **row, "shape": [n, F, d], "library": "bmm + triangle gather"})
    return row


def attention_bound(q, k, causal, mem_rate):
    """Bytes of q, k, v read and out written once; flops of the scores and
    the products over the (causal) pairs, at the dtype's dense peak: bf16's
    tensor-core rate, and for f32 the smaller of two routes' bounds, the
    CUDA cores' f32 rate and the tensor cores' in 3xTF32 (three TF32
    products for each f32 one). Returns (ms, bound_by, {route: (ms, by)})."""
    Bq, S, H, d = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4 * d * Bq * H * pairs
    if q.element_size() == 2:
        routes = {"bf16": bound(nbytes, flops, mem_rate, BF16_RATE)}
    else:
        routes = {"cuda_cores": bound(nbytes, flops, mem_rate, FP32_RATE),
                  "tf32x3": bound(nbytes, flops, mem_rate, TF32_RATE / 3)}
    return (*min(routes.values()), routes)


def check_attention(torch, q, k, v, causal, mem_rate, timed=False, by_row=False):
    """K9 against its plain version on (B, S, H, d) q and (B, S, KV, d) k, v.
    Returns the check (and, if ``timed``, the table row's times). ``by_row``
    computes the plain version one batch row at a time (its f32 score
    tiles beside a full-width model's weights)."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.flash_attention.ops import gqa_attention_op
    from repro_torch.kernels.flash_attention.ref import gqa_attention_ref

    got = one_launch(gqa_attention_op, lambda: gqa_attention_op(q, k, v, causal=causal))
    if by_row:
        want = torch.cat([gqa_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal)
                          for i in range(q.shape[0])])
    else:
        want = gqa_attention_ref(q, k, v, causal=causal)
    got, want = got.float(), want.float()
    err = max_err([got], [want])
    rel_norm = ((got - want).norm() / want.norm()).item()
    dtype = str(q.dtype).split(".")[-1]
    if dtype == "bfloat16":
        tol = {"atol": ATTN_BF16_ATOL, "rtol": ATTN_BF16_RTOL, "rel_norm": ATTN_BF16_REL_NORM}
        assert rel_norm <= ATTN_BF16_REL_NORM, ("flash_attention rel norm", rel_norm)
    else:
        tol = {"atol": ATTN_TOL[dtype], "rtol": ATTN_TOL[dtype]}
    torch.testing.assert_close(got, want, rtol=tol["rtol"], atol=tol["atol"])
    del got, want
    b_ms, b_by, routes = attention_bound(q, k, causal, mem_rate)
    out = dict(shape=list(q.shape), kv_heads=k.shape[2], dtype=dtype, causal=causal,
               max_abs_err=err, rel_norm_err=rel_norm, tol=tol, bound_ms=b_ms, bound_by=b_by)
    if len(routes) > 1:
        out["bound_ms_by_route"] = {r: ms for r, (ms, _) in routes.items()}
    if timed:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # SDPA's (B, H, S, d)
        out.update(timings(
            torch, lambda: gqa_attention_op(q, k, v, causal=causal),
            lambda: gqa_attention_ref(q, k, v, causal=causal),
            DEVICE_NAMES["flash_attention" if dtype == "bfloat16" else "flash_attention_f32"],
            lambda: Fn.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                    enable_gqa=True)))
    torch.cuda.empty_cache()
    return out


def kernel_split(torch, fn, reps=10):
    """(device ms a call of ``fn``, {kernel: device ms a call}) from the
    profiler; event-timed, with no split (None), where every trace lost
    events."""
    by_name = device_ms(torch, fn, reps)
    if by_name is None:
        return event_ms(torch, fn, reps), None
    return (sum(t for t, _ in by_name.values()) / reps,
            {n[:60]: t / reps for n, (t, _) in by_name.items()})


def check_attention_train(torch, mem_rate):
    """Phase 3, K9's training form (``attention_train_op``): at each of
    ATTN_TRAIN_CASES' shapes, one call forward and backward (one launch of
    each) and its output and the gradients of q, k and v held against the
    plain path (``layers._sdpa_block``, KV heads repeated) in f32 on the
    same bf16 inputs, a batch row at a time, within ATTN_TRAIN_REL_NORM in
    the relative norm; then the forward kernel and the backward's kernels
    (delta, dK/dV, dQ) timed on the device beside their bounds
    (``ops._train_work``, as the dry run counts them: the forward's two
    products over the (causal) pairs and the backward's five at bf16's
    rate, or their operands' bytes), and the Function's forward and
    backward and the plain path's (``layers._attend``, the training form
    they replace) event-timed. Returns the forward's and the backward's
    table rows, cell 9's shape their headline."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ops import (_train_work, attention_train_bwd,
                                                          attention_train_op)
    from repro_torch.models import layers

    cfg = get_config(LM_ARCH)  # no window
    gen = torch.Generator().manual_seed(30)
    source = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
    rows = {"flash_attention_train_fwd": dict(name="flash_attention_train_fwd", route="cuda",
                                              source=source, replaces=None, by_case={}),
            "flash_attention_train_bwd": dict(name="flash_attention_train_bwd", route="cuda",
                                              source=source, replaces=None, by_case={})}
    for case, (b, s, h, kv, d, causal) in ATTN_TRAIN_CASES.items():
        q = torch.randn((b, s, h, d), generator=gen).to("cuda", torch.bfloat16)
        k, v = (torch.randn((b, s, kv, d), generator=gen).to("cuda", torch.bfloat16)
                for _ in range(2))
        dout = torch.randn((b, s, h, d), generator=gen).to("cuda", torch.bfloat16)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        before = (attention_train_op.launches, attention_train_bwd.launches)
        out = attention_train_op(qg, kg, vg, causal=causal)
        out.backward(dout)
        assert (attention_train_op.launches - before[0],
                attention_train_bwd.launches - before[1]) == (1, 1), case
        got = (out.detach(), qg.grad, kg.grad, vg.grad)
        pos = torch.arange(s, device="cuda")
        mask = pos[:, None] >= pos[None, :] if causal else None
        num, den = [0.0] * 4, [0.0] * 4
        for i in range(b):
            x = [t[i:i + 1].float().requires_grad_() for t in (q, k, v)]
            want = layers._sdpa_block(x[0], layers._repeat_kv(x[1], h // kv),
                                      layers._repeat_kv(x[2], h // kv), mask, d ** -0.5)
            want.backward(dout[i:i + 1].float())
            for j, w in enumerate((want.detach(), *(t.grad for t in x))):
                num[j] += (got[j][i:i + 1].float() - w).norm().item() ** 2
                den[j] += w.norm().item() ** 2
            del x, want
        rel = {n: (num[j] / den[j]) ** 0.5 for j, n in enumerate(("out", "dq", "dk", "dv"))}
        assert all(math.isfinite(e) and e <= ATTN_TRAIN_REL_NORM for e in rel.values()), \
            (case, rel)
        del out, got
        o, lse = fa.flash_attention_train_fwd(q, k, v, causal=causal)
        fwd_ms, _ = kernel_split(torch, lambda: fa.flash_attention_train_fwd(q, k, v,
                                                                            causal=causal))
        bwd_ms, bwd_split = kernel_split(
            torch, lambda: fa.flash_attention_train_bwd(q, k, v, o, lse, dout, causal=causal))
        fwd_bound, fwd_by = bound(*reversed(_train_work(q, k, causal, False)), mem_rate,
                                  BF16_RATE)
        bwd_bound, bwd_by = bound(*reversed(_train_work(q, k, causal, True)), mem_rate,
                                  BF16_RATE)

        def fused():
            attention_train_op(qg, kg, vg, causal=causal).backward(dout)

        def plain():
            n_rep = h // kv
            layers._attend(qg, layers._repeat_kv(kg, n_rep), layers._repeat_kv(vg, n_rep),
                           pos, cfg, causal).backward(dout)

        function_ms = time_ms(torch, fused, reps=5, warm=1)
        plain_ms = time_ms(torch, plain, reps=3, warm=1)
        shape = dict(shape=[b, s, h, d], kv_heads=kv, causal=causal)
        emit({"phase": "kernel_check", "name": "attention_train", "cell": case, **shape,
              "rel_norm_err": rel, "tol_rel_norm": ATTN_TRAIN_REL_NORM,
              "fwd_ms": fwd_ms, "fwd_bound_ms": fwd_bound, "fwd_bound_by": fwd_by,
              "bwd_ms": bwd_ms, "bwd_kernels_ms": bwd_split, "bwd_bound_ms": bwd_bound,
              "bwd_bound_by": bwd_by, "function_fwd_bwd_ms": function_ms,
              "plain_fwd_bwd_ms": plain_ms})
        rows["flash_attention_train_fwd"]["by_case"][case] = dict(
            **shape, rel_norm_err=rel["out"], ms=fwd_ms, bound_ms=fwd_bound, bound_by=fwd_by,
            function_fwd_bwd_ms=function_ms, plain_fwd_bwd_ms=plain_ms)
        rows["flash_attention_train_bwd"]["by_case"][case] = dict(
            **shape, rel_norm_err={n: rel[n] for n in ("dq", "dk", "dv")}, ms=bwd_ms,
            kernels_ms=bwd_split, bound_ms=bwd_bound, bound_by=bwd_by)
        del q, k, v, dout, qg, kg, vg, o, lse
        torch.cuda.empty_cache()
    for row in rows.values():  # cell 9's shape heads the row
        row.update({kk: row["by_case"]["cell9_s2048"][kk] for kk in ("ms", "bound_ms", "bound_by")})
    return rows


def profiled(torch, fn, check=None, warm=True):
    """(fn's result, device time by kernel, wall time and device idle share
    of one call of ``fn``), from a torch.profiler trace of the device alone
    (``fn`` runs twice, or once without ``warm``: see ``traced``). Where
    every trace lost events, the device figures are None (not measured) and
    the kernels an empty dict."""
    out, wall_ms, events, _ = traced(torch, fn, warm=warm, check=check)
    if events is None:
        return out, {}, {"wall_ms": wall_ms, "device_ms": None, "idle_share": None,
                         "device_launches": None, "top_device": None}
    by_name = device_kernels(events)
    busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return out, by_name, {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1 - busy / wall_ms,
                          "device_launches": sum(c for _, c in by_name.values()),
                          "top_device": [[n[:80], t, c] for n, (t, c) in top]}


class ClockSampler:
    """The card's SM clock (MHz) and power draw (W), sampled by ``nvidia-smi``
    every 20 ms while the block runs; ``summary()`` gives their medians and
    the lowest clock (None where nothing was sampled)."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
             "-lms", "20"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        time.sleep(0.2)  # its first sample
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.samples = []
        for line in out.splitlines():
            try:
                mhz, watts = (float(x) for x in line.split(",")[:2])
            except ValueError:
                continue
            self.samples.append((mhz, watts))
        return False

    def summary(self):
        if not self.samples:
            return {"sm_clock_MHz_median": None, "sm_clock_MHz_min": None, "power_W_median": None}
        mhz = sorted(m for m, _ in self.samples)
        watts = sorted(w for _, w in self.samples)
        return {"sm_clock_MHz_median": mhz[len(mhz) // 2], "sm_clock_MHz_min": mhz[0],
                "power_W_median": watts[len(watts) // 2], "samples": len(mhz)}


def k9_in_context(torch, q, k, v, before, reps=50):
    """K9's device ms a launch (torch.profiler) when each launch follows
    ``before()``, with the SM clock sampled meanwhile."""
    from repro_torch.kernels.flash_attention.ops import gqa_attention_op

    def body():
        for _ in range(reps):
            before()
            gqa_attention_op(q, k, v, causal=True)

    with ClockSampler() as clocks:
        events = traced(torch, body, check=launched(DEVICE_NAMES["flash_attention"], reps))[2]
    k9_ms = None  # not measured: every trace lost events
    if events is not None:
        k9_ms = sum(t for n, (t, _) in device_kernels(events).items()
                    if DEVICE_NAMES["flash_attention"] in n) / reps
    return {"k9_ms": k9_ms, "calls": reps, **clocks.summary()}


def layer0_qkv(torch, cfg, params, prompts, prefix_embeds=None):
    """Layer 0's normed input and the roped q, k, v that its prefill hands
    K9 for ``prompts`` (after the projected ``prefix_embeds``, where given),
    computed as ``layers.attention_apply`` does."""
    from repro_torch.models import layers, transformer

    lp = transformer._layer(params["unit"][0], 0)
    x = layers.rmsnorm(lp["norm1"], transformer.embed_inputs(params, prompts, prefix_embeds),
                       cfg.norm_eps)
    (Bs, S), hd, mp = x.shape[:2], cfg.resolved_head_dim, lp["mixer"]
    pos = torch.arange(S, device=prompts.device)
    q = layers.apply_rope((x @ mp["wq"]).reshape(Bs, S, cfg.n_heads, hd), pos, cfg.rope_theta)
    k = layers.apply_rope((x @ mp["wk"]).reshape(Bs, S, cfg.n_kv_heads, hd), pos, cfg.rope_theta)
    v = (x @ mp["wv"]).reshape(Bs, S, cfg.n_kv_heads, hd)
    return x, q, k, v


F32_ROW_KEYS = ("shape", "kv_heads", "causal", "max_abs_err", "tol", "bound_ms", "bound_by",
                "bound_ms_by_route", "ms", "op_ms", "traced_launches", "call_ms", "plain_ms",
                "plain_call_ms", "library_ms")


def serving_phase(torch, mem_rate, all_ops, path_counts):
    """Phase 7. Returns the K9 table row (launches filled from the path)."""
    from repro_torch import tree as T
    from repro_torch.configs import phi3_medium_14b
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    # K9 at the reference tests' shapes, f32 and bf16; the f32 kernel (3xTF32
    # on the tensor cores) timed at the last, granite-20b's MQA layout, and
    # at whisper's encoder layout
    gen = torch.Generator().manual_seed(4)
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, h, kv, d, causal in ATTN_CASES:
            q = torch.randn((b, s, h, d), generator=gen).to("cuda", dtype)
            k, v = (torch.randn((b, s, kv, d), generator=gen).to("cuda", dtype) for _ in range(2))
            timed = dtype == torch.float32 and (b, s, h, kv, d, causal) == ATTN_CASES[-1]
            chk = check_attention(torch, q, k, v, causal, mem_rate, timed=timed)
            emit({"phase": "kernel_check", "name": "flash_attention", **chk})
            if timed:
                f32_row = dict(name="flash_attention_f32", route="cuda",
                               source="src/repro_torch/kernels/flash_attention/csrc/"
                                      "flash_attention.cu",
                               replaces="src/repro/kernels/flash_attention/flash_attention.py:81",
                               **{kk: chk[kk] for kk in F32_ROW_KEYS})
    b, s, h, kv, d, causal = ATTN_F32_WHISPER
    q = torch.randn((b, s, h, d), generator=gen).to("cuda")
    k, v = (torch.randn((b, s, kv, d), generator=gen).to("cuda") for _ in range(2))
    chk = check_attention(torch, q, k, v, causal, mem_rate, timed=True)
    emit({"phase": "kernel_check", "name": "flash_attention", "cell": "f32_whisper_encoder",
          **chk})
    f32_row["whisper_encoder"] = {kk: chk[kk] for kk in F32_ROW_KEYS}
    del q, k, v, chk
    torch.cuda.empty_cache()

    # phi3-medium-14b at full width, its weights drawn on the card
    cfg = get_config(SERVE_ARCH)
    params, weight_bytes = draw_weights(torch, cfg, "serve")
    prompts = serve.make_prompts(cfg, SERVE_B, SERVE_PROMPT, seed=0).cuda()

    # K9 on layer 0's own roped q/k/v (bf16), timed beside SDPA and the plain version
    x, q, k, v = layer0_qkv(torch, cfg, params, prompts)
    chk = check_attention(torch, q, k, v, True, mem_rate, timed=True)
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention/flash_attention.py:81",
               **{kk: chk[kk] for kk in ("max_abs_err", "rel_norm_err", "tol", "bound_ms",
                                         "bound_by", "ms", "op_ms", "traced_launches",
                                         "call_ms", "plain_ms", "plain_call_ms",
                                         "library_ms")})
    emit({"phase": "kernel", **chk, "name": "flash_attention", "source": row["source"],
          "library": "scaled_dot_product_attention(is_causal=True, enable_gqa=True)"})
    # the same launch back to back, after an L2 flush, and after the layer's
    # gate projection (as in the prefill, where K9 follows cuBLAS work)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MiB > L2
    x2 = x.reshape(-1, cfg.d_model)
    w_gate = transformer._layer(params["unit"][0], 0)["ffn"]["w_gate"]
    contexts = {"back_to_back": lambda: None, "after_l2_flush": flush.zero_,
                "after_gate_gemm": lambda: x2 @ w_gate}
    context_ms = {name: k9_in_context(torch, q, k, v, fn) for name, fn in contexts.items()}
    emit({"phase": "k9_context", "shape": list(q.shape), **context_ms})
    row["context_ms"] = {name: c["k9_ms"] for name, c in context_ms.items()}
    del q, k, v, x, x2, chk, flush
    torch.cuda.empty_cache()

    # the main path (cell 4), profiled
    del prompts
    served, _ = serve_cell(torch, cfg, params, weight_bytes, "serve_phi3", all_ops, path_counts,
                           cfg.n_layers, mem_rate)
    emit(served)
    row["path_ms"] = served["prefill_profile"]["k9_ms_per_launch"]  # a launch in the prefill
    del served
    torch.cuda.empty_cache()

    # cell 12: the same weights under CONFIG_SWA (window 4,096), one prompt
    # longer than the window: the windowed prefill's query-chunked plain path
    swa_cfg = phi3_medium_14b.CONFIG_SWA
    swa_prompts = serve.make_prompts(swa_cfg, 1, SWA_PROMPT, seed=0).cuda()
    serve.generate(params, swa_cfg, swa_prompts, 2)  # warm-up at the timed shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(all_ops.values())
    res = serve.generate(params, swa_cfg, swa_prompts, SWA_GEN, prefill_reps=SWA_REPS)
    counts = path_counts["serve_swa"] = {kk: op.launches for kk, op in all_ops.items()}
    assert not any(counts.values()), counts  # K9 has no window: the plain path
    assert bool(torch.isfinite(res["prefill_logits"]).all()
                and torch.isfinite(res["last_logits"]).all()), "non-finite logits"
    emit({"phase": "serve_swa", "arch": f"{cfg.name} CONFIG_SWA",
          "window": swa_cfg.sliding_window, "batch": 1, "prompt_len": SWA_PROMPT,
          "gen": SWA_GEN, "prefill_ms": res["prefill_s"] * 1e3,
          "prefill_ms_all": [t * 1e3 for t in res["prefill_s_all"]],
          "prefill_tokens_per_s": SWA_PROMPT / res["prefill_s"],
          "decode_ms_per_step": res["decode_s"] / (SWA_GEN - 1) * 1e3,
          "decode_tokens_per_s": (SWA_GEN - 1) / res["decode_s"], "k9_launches": 0,
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
          "first_tokens": res["tokens"][0].tolist()})
    del params, res, swa_prompts
    torch.cuda.empty_cache()

    # a reduced phi3 (2 layers, GQA, f32) on the card against the same weights on the CPU
    small = dataclasses.replace(reduced(cfg), n_kv_heads=2)
    p_cpu = transformer.init_params(small, torch.Generator().manual_seed(0), device="cpu")
    pr = serve.make_prompts(small, 2, 100, seed=0)
    cpu = serve.generate(p_cpu, small, pr, 8)
    card = serve.generate(T.map(lambda t: t.cuda(), p_cpu), small, pr.cuda(), 8)
    assert torch.equal(card["tokens"].cpu(), cpu["tokens"]), (card["tokens"], cpu["tokens"])
    diff = 0.0
    for kk in ("prefill_logits", "last_logits"):
        torch.testing.assert_close(card[kk].cpu(), cpu[kk], rtol=2e-4, atol=2e-4)
        diff = max(diff, (card[kk].cpu() - cpu[kk]).abs().max().item())
    emit({"phase": "serve_reference", "arch": "phi3-medium-14b reduced, n_kv_heads=2, f32",
          "tokens_equal": True, "max_logit_diff_cuda_vs_cpu": diff})
    return row, f32_row


def lm_train_phase(torch, all_ops, path_counts):
    """Phase 8: the LM trainer, reduced and at full width. Returns nothing;
    every kernel's launches in its windows land in ``path_counts``."""
    import contextlib
    import dataclasses
    import io

    import numpy as np

    from repro_torch import interop, optim
    from repro_torch import tree as T
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core import spmd
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import tokens as tok
    from repro_torch.launch import train

    def none_launched(path):
        counts = path_counts[path] = {k: op.launches for k, op in all_ops.items()}
        assert not any(counts.values()), (path, counts)

    emit({"phase": "lm_memory", "when": "before",
          "allocated_GB": torch.cuda.memory_allocated() / 1e9,
          "reserved_GB": torch.cuda.memory_reserved() / 1e9})

    # a · the launcher's reduced run, card against CPU (the launcher's
    # printed lines are kept out of the smoke's output)
    for algo in LM_ALGOS:
        runs = {}
        for dev in ("cuda", "cpu"):
            reset_counts(all_ops.values())
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                out = train.main(["lm", "--device", dev, "--algo", algo] + LM_LAUNCH)
            runs[dev] = (out, time.perf_counter() - t0)
            if dev == "cuda":
                none_launched(f"lm_launcher_{algo}")
        card, cpu = runs["cuda"][0]["losses"], runs["cpu"][0]["losses"]
        assert all(math.isfinite(x) for x in card), card
        for a, b in zip(card, cpu):
            assert abs(a - b) <= 1e-5 + 1e-4 * abs(b), ("lm launcher cuda vs cpu", algo, a, b)
        assert runs["cuda"][0]["loss_end"] < runs["cuda"][0]["loss_start"], runs["cuda"][0]
        emit({"phase": "lm_launcher", "algo": algo, "flags": LM_LAUNCH,
              "loss_start": runs["cuda"][0]["loss_start"],
              "loss_end": runs["cuda"][0]["loss_end"],
              "max_loss_diff_cuda_vs_cpu": max(abs(a - b) for a, b in zip(card, cpu)),
              "wall_s_cuda": runs["cuda"][1], "wall_s_cpu": runs["cpu"][1], "launches": 0})

    # a2 · reduced granite-20b's save_comm gradients against full remat's,
    # on the card (f32, TF32 off; the reference's test)
    save_comm_check(torch, all_ops, path_counts)

    # b · minicpm-2b at full width, its depth cut to LM_LAYERS; then its
    # stacks trained on under the two variants
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    attn = (3 * 4 * LM_R * LM_B * cfg.n_heads * LM_S * LM_S * cfg.resolved_head_dim
            * cfg.n_layers)
    lm_train_cell(torch, cfg, "lm_train", all_ops, path_counts,
                  lambda n_par, tokens: 4 / 3 * (6 * n_par * tokens + attn),
                  "4/3 * (6 * params * tokens + 3 * 4 * R * B * heads * S^2 * head_dim"
                  " * layers) / (median s * BF16_RATE)", cut=f"depth 40 -> {LM_LAYERS}",
                  attn_layers=cfg.n_layers,
                  after=lambda state, batches, opt: lm_variants(torch, cfg, state, batches, opt,
                                                                all_ops, path_counts))

    # c · one step and a sync of a reduced minicpm-2b, card against CPU:
    # weights, Adam's m, v, t (t=3, v well above the gradients' rounding,
    # so no weight's step hangs on it) and the PS copy carried in as numpy
    small = reduced(get_config(LM_ARCH))
    rng = np.random.default_rng(1)
    p0 = interop.tree_to_numpy(spmd.init_params(small, torch.Generator().manual_seed(1),
                                                device="cpu"))
    stack_np = T.map(lambda x: np.stack([x, x + np.float32(0.01) * rng.standard_normal(
        x.shape, np.float32)]), p0)
    opt_np = {"m": T.map(lambda x: 1e-3 * rng.standard_normal(x.shape, np.float32), stack_np),
              "v": T.map(lambda x: 1e-4 + 1e-4 * rng.random(x.shape, np.float32), stack_np),
              "t": np.full((2,), 3, np.int32)}
    toks = tok.gen_batch(tok.make_transition(small.vocab_size, seed=1), 1, 0, 2 * 4,
                         256)["tokens"].reshape(2, 4, 256)
    step = spmd.make_train_step(small, optim.adam(LM_LR), "shadow")
    sync = spmd.make_sync_step(small, SyncConfig(algo="easgd", alpha=0.5))
    res = {}
    for dev in ("cuda", "cpu"):
        reset_counts(all_ops.values())
        stack, ost, ps = interop.lm_train_state_from_numpy(stack_np, opt_np, "easgd", p0,
                                                           device=dev)
        stack, ost, loss = step(stack, ost, {"tokens": toks.to(dev)})
        stack, ps = sync(stack, ps)
        res[dev] = T.map(lambda x: x.cpu(), (loss, stack, ost, ps))
        if dev == "cuda":
            none_launched("lm_step_reference")
    diff = 0.0
    for a, b in zip(T.leaves(res["cuda"]), T.leaves(res["cpu"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)  # trajectory tol
        diff = max(diff, (a.double() - b.double()).abs().max().item())
    emit({"phase": "lm_step_reference", "arch": "minicpm-2b reduced, f32, R=2, B=4 x S=256",
          "optimizer": "adam", "sync": "easgd", "max_abs_diff_cuda_vs_cpu": diff,
          "leaves": len(T.leaves(res["cuda"]))})
    del res
    release(torch)
    emit({"phase": "lm_memory", "when": "after",
          "allocated_GB": torch.cuda.memory_allocated() / 1e9,
          "reserved_GB": torch.cuda.memory_reserved() / 1e9})


def save_comm_check(torch, all_ops, path_counts):
    """Reduced granite-20b (f32, TF32 off) on the card: the loss and every
    gradient under remat_policy="save_comm" against full remat's, within
    SAVE_COMM_TOL; emits whether they are bitwise equal."""
    from repro_torch import tree as T
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = reduced(get_config("granite-20b"))
    params = T.map(lambda x: x.cuda(), transformer.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    batch = {"tokens": serve.make_prompts(cfg, 2, 32, seed=0).cuda()}
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts(all_ops.values())
    out = {}
    try:
        for policy in ("full", "save_comm"):
            p = T.map(lambda a: a.detach().clone().requires_grad_(), params)
            loss = transformer.loss_fn(p, cfg, batch, remat=True, remat_policy=policy)
            out[policy] = [loss.detach()] + list(torch.autograd.grad(loss, T.leaves(p)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    counts = path_counts["save_comm_check"] = {k: op.launches for k, op in all_ops.items()}
    assert not any(counts.values()), counts
    for a, b in zip(out["save_comm"], out["full"]):
        torch.testing.assert_close(a, b, **SAVE_COMM_TOL)
    emit({"phase": "save_comm_check", "arch": "granite-20b reduced, f32, B=2 x 32",
          "tol": SAVE_COMM_TOL, "tensors": len(out["full"]),
          "bitwise_equal": all(torch.equal(a, b) for a, b in zip(out["save_comm"], out["full"])),
          "max_abs_diff": max((a - b).abs().max().item()
                              for a, b in zip(out["save_comm"], out["full"]))})


def counted_iteration(torch, step, state, batch):
    """One more iteration of ``step`` on ``state``, untimed, under a
    dispatch mode that counts every ``aten.mm`` by its operands' shapes,
    with every op a selective checkpoint's policy marks MUST_SAVE in a
    forward pass counted too (tests/test_torch_perf_variants.py counts
    both so on the CPU). Returns (products, kept, loss)."""
    import collections

    import torch.utils.checkpoint as C
    from torch.utils._python_dispatch import TorchDispatchMode

    kept, real = collections.Counter(), C.create_selective_checkpoint_contexts

    def watched(policy, *a, **kw):
        def pol(ctx, op, *args, **kwargs):
            out = policy(ctx, op, *args, **kwargs)
            if out == C.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                kept[str(op)] += 1
            return out

        return real(pol, *a, **kw)

    class Products(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                self.shapes[tuple(tuple(a.shape) for a in args)] += 1
            return func(*args, **(kwargs or {}))

    C.create_selective_checkpoint_contexts = watched
    try:
        with Products() as m:
            state["stack"], state["opt"], loss = step(state["stack"], state["opt"], batch)
        torch.cuda.synchronize()
    finally:
        C.create_selective_checkpoint_contexts = real
    return m.shapes, kept, loss


def lm_variants(torch, cfg, state, batches, opt, all_ops, path_counts):
    """Cell 9's trained stacks on under the variants: VARIANT_ITERS timed
    iterations each under full remat, remat_policy="save_comm" and
    parallel_block (the same weights, PaLM's block), no sync between; each
    run's ms an iteration, its peak memory (reset before it) and its
    losses, every leaf finite, no K1-K9 prefill launch. Full remat and save_comm
    then take one more, counted iteration (``counted_iteration``): the
    policy must keep each layer's wo and w_down products, one a mixer and
    one an FFN, in every replica's forward pass, and the backward pass's
    recompute must run R * n_layers fewer products of wo's shape under
    save_comm than under full remat, and no other product more."""
    from repro_torch import tree as T
    from repro_torch.core import spmd

    base, counted = None, {}
    for path, vcfg, policy in (
            ("lm_train_full_remat", cfg, "full"),
            ("lm_train_save_comm", cfg, "save_comm"),
            ("lm_train_parallel", dataclasses.replace(cfg, parallel_block=True), "full")):
        step = spmd.make_train_step(vcfg, opt, "shadow", remat_policy=policy)
        reset_counts(all_ops.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        for it in range(VARIANT_ITERS):
            t0 = time.perf_counter()
            state["stack"], state["opt"], loss = step(state["stack"], state["opt"], batches[it])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss.mean()))
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not vcfg.parallel_block:
            counted[policy] = counted_iteration(torch, step, state, batches[VARIANT_ITERS])
            losses.append(float(counted[policy][2].mean()))
        counts = path_counts[path] = {k: op.launches for k, op in all_ops.items()}
        assert not any(counts.values()), (path, counts)
        finite = bool(torch.stack([torch.isfinite(t).all()
                                   for t in T.leaves((state["stack"], state["opt"]))]).all())
        assert finite and all(math.isfinite(x) for x in losses), (path, losses)
        row = {"phase": path, "arch": cfg.name, "n_layers": cfg.n_layers,
               "remat_policy": policy, "parallel_block": vcfg.parallel_block,
               "iters": VARIANT_ITERS, "ms_per_iter_median": sorted(ms)[len(ms) // 2],
               "ms_per_iter": ms, "peak_mem_GB": peak, "losses": losses,
               "all_leaves_finite": finite, "launches": 0}
        if base is None:
            base = row
        else:
            row.update({"full_remat_ms_per_iter": base["ms_per_iter_median"],
                        "full_remat_peak_mem_GB": base["peak_mem_GB"],
                        "cell9_timed_peak_mem_GB": ROWS["lm_train"]["peak_mem_GB"]})
        if policy == "save_comm":
            (full_mm, full_kept, _), (comm_mm, comm_kept, _) = counted["full"], counted["save_comm"]
            hd = cfg.n_heads * cfg.resolved_head_dim
            wo = ((LM_B * LM_S, hd), (hd, cfg.d_model))
            row.update({"kept_by_policy": dict(comm_kept),
                        "mm_per_iter": sum(comm_mm.values()),
                        "full_remat_mm_per_iter": sum(full_mm.values()),
                        "wo_products_skipped": (full_mm - comm_mm)[wo]})
            assert not full_kept, full_kept
            assert comm_kept == {"aten.mm.default": 2 * LM_R * cfg.n_layers}, comm_kept
            assert full_mm - comm_mm == {wo: LM_R * cfg.n_layers}, full_mm - comm_mm
            assert not comm_mm - full_mm, comm_mm - full_mm
        emit(row)
        del step
        release(torch)


def roofline_phase(torch):
    """Phase 11: the dry run's count at the measured cells' shapes
    (``launch/dryrun.py``: the step built on fake structures and traced on
    their meta twins, on the host; K9 counted as the card runs it: a
    prefill's launch a layer, the training form's forward twice a layer and
    replica, the unit's recompute among them, and its backward once), its
    roofline on the H100's data-sheet constants beside the measured time
    and peak memory of this run. Fails where a bound exceeds
    ROOFLINE_SLACK times the measured time: the count would be wrong."""
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis as RA

    one = dryrun.ONE_CARD
    cell9 = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    vlm = get_config(VLM_ARCH)
    lm = ROWS["lm_train"]
    sync_ms = sorted(lm["sync_ms"])[len(lm["sync_ms"]) // 2]
    cells = (
        ("cell 4 prefill", "serve_phi3", ROWS["serve_phi3"]["prefill_ms"],
         ROWS["serve_phi3"]["peak_mem_GB"], get_config(SERVE_ARCH).n_layers,
         lambda: dryrun.build(get_config(SERVE_ARCH), "cell4", one, shape_override=InputShape(
             "cell4", SERVE_PROMPT, SERVE_B, "prefill"))),
        ("cell 9 shadow step", "lm_train", lm["ms_per_iter_median"],
         ROWS["lm_train_full_remat"]["peak_mem_GB"], 3 * LM_LAYERS * LM_R,
         lambda: dryrun.build(cell9, "cell9", one, mode="shadow", optimizer="adam",
                              n_replicas=LM_R, n_microbatches=1, shape_override=InputShape(
                                  "cell9", LM_S, LM_R * LM_B, "train"))),
        ("cell 9 EASGD sync step", "lm_train", sync_ms, lm["peak_mem_GB"], 0,
         lambda: dryrun.build_sync_step(LM_ARCH, one, algo="easgd", n_replicas=LM_R, cfg=cell9)),
        ("cell 14 prefill", "serve_llava", ROWS["serve_llava"]["prefill_ms"],
         ROWS["serve_llava"]["peak_mem_GB"], vlm.n_layers,
         lambda: dryrun.build(vlm, "cell14", one, shape_override=InputShape(
             "cell14", vlm.frontend.n_tokens + VLM_PROMPT, VLM_B, "prefill"))))
    for name, path, measured, measured_peak, k9_calls, build in cells:
        t0 = time.perf_counter()
        cost = dryrun._trace_cost(build())
        r = RA.analyze(cost, arch=name, shape=path, mode="one card")
        bound = max(r.t_compute, r.t_memory) * 1e3
        emit({"phase": "roofline_check", "cell": name, "measured_in": path,
              "t_compute_ms": r.t_compute * 1e3, "t_memory_ms": r.t_memory * 1e3,
              "bottleneck": r.bottleneck, "bound_ms": bound, "measured_ms": measured,
              "measured_over_bound": measured / bound, "flops": r.flops_per_chip,
              "bytes": r.bytes_per_chip, "k9_calls": cost.kernel_calls,
              "arg_GB": r.arg_bytes / 1e9, "peak_GB": r.peak_bytes / 1e9,
              "arg_plus_peak_GB": (r.arg_bytes + r.peak_bytes) / 1e9,
              "measured_peak_GB": measured_peak, "trace_s": time.perf_counter() - t0})
        assert cost.kernel_calls == k9_calls, (name, cost.kernel_calls)
        assert bound <= ROOFLINE_SLACK * measured, (name, bound, measured)


MESH_ARCH = "granite-20b"  # reduced (f32): the reference mesh test's model
MESH_LAYOUT = (("pod", "data", "model"), (1, 1, 1))  # one card as a 3-axis mesh
# cell 9's configuration on the reference's meshes: minicpm-2b's widths at
# 24 layers, B=4 x 2,048 on each data rank (a (pod, data) rank in syncdp),
# R=2 replicas on "pod" in shadow mode; the fake trace of one rank
CELL9_PER_RANK = 4


def mesh_step_diff(torch, a, b, rtol=1e-4, atol=1e-5):
    """The largest |a - b| over two trees (a DTensor read whole), each pair
    held within ``rtol``, ``atol`` (the trajectory tolerance by default)."""
    from repro_torch import tree as T

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    diff = 0.0
    for x, y in zip(T.leaves(a), T.leaves(b), strict=True):
        x, y = whole(x), whole(y)
        torch.testing.assert_close(x, y, rtol=rtol, atol=atol)
        diff = max(diff, (x.double() - y.double()).abs().max().item())
    return diff


def mesh_phase(torch, all_ops, path_counts, backend_name="nccl", device="cuda"):
    """Phase 12: the mesh program on the card. A one-rank ``nccl`` group and
    a (1, 1, 1) pod x data x model ``DeviceMesh`` on the card; reduced
    granite-20b's shadow step (R=1 on "pod") and MA sync, a syncdp step and
    a prefill (K9 on each rank's local heads: its launch counter must rise)
    on DTensors, each held against the one-card step on the same card at
    the trajectory tolerance (the prefill's logits at K9's f32 one); then
    the group destroyed and the collective table of cell 9's configuration
    traced on a fake 2x16x16 (and 16x16) process group: shadow, syncdp and
    the EASGD sync step, with cross-pod bytes and t_collective."""
    import torch.distributed as dist

    from repro_torch import optim
    from repro_torch import tree as T
    from repro_torch.configs.base import InputShape, get_config, reduced
    from repro_torch.core import spmd
    from repro_torch.core.sync import SyncConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as SP
    from repro_torch.roofline import analysis as RA
    from repro_torch.sharding import ctx as shctx
    from repro_torch.sharding import rules

    t0 = time.perf_counter()
    dist.init_process_group(backend_name, rank=0, world_size=1, store=dist.HashStore())
    try:
        dm = M.device_mesh(M.Mesh(*MESH_LAYOUT), device)
        cfg = reduced(get_config(MESH_ARCH))
        params = spmd.init_params(cfg, torch.Generator().manual_seed(0), device=device)
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (1, 4, 64), generator=gen).to(device)
        opt = optim.adagrad(1e-2)
        sync = spmd.make_sync_step(cfg, SyncConfig(algo="ma").validate())
        diffs = {}

        def placed(tree, replica_axis=None):
            specs = rules.build_param_specs(tree, dm, fsdp_axis="data",
                                            replica_axis=replica_axis)
            return SP.place(T.map(torch.clone, tree), specs, dm)

        # the shadow step (R=1 on "pod") and the MA sync
        one = spmd.stack_replicas(params, 1)
        one_st = opt.init(one)
        one, one_st, one_loss = spmd.make_train_step(cfg, opt, "shadow")(
            one, one_st, {"tokens": tokens})
        one, _ = sync(one, None)
        mesh = placed(spmd.stack_replicas(params, 1), "pod")
        mesh_st = placed(opt.init(spmd.stack_replicas(params, 1)), "pod")
        batch = {"tokens": SP.place(tokens, ("pod", "data", None), dm)}
        with shctx.activation_mesh(dm, batch_axes=("data",)):
            mesh, mesh_st, mesh_loss = spmd.make_train_step(cfg, opt, "shadow")(
                mesh, mesh_st, batch)
            mesh, _ = sync(mesh, None)
        diffs["shadow_step_and_ma_sync"] = mesh_step_diff(torch, (mesh, mesh_st, mesh_loss),
                                                          (one, one_st, one_loss))
        # a syncdp step
        flat = {"tokens": tokens.reshape(4, 64)}
        one = T.map(torch.clone, params)
        one_st = opt.init(one)
        one, one_st, one_loss = spmd.make_train_step(cfg, opt, "syncdp")(one, one_st, flat)
        mesh, mesh_st = placed(params), placed(opt.init(params))
        with shctx.activation_mesh(dm, batch_axes=("pod", "data")):
            mesh, mesh_st, mesh_loss = spmd.make_train_step(cfg, opt, "syncdp")(
                mesh, mesh_st, {"tokens": SP.place(flat["tokens"], (("pod", "data"), None),
                                                    dm)})
        diffs["syncdp_step"] = mesh_step_diff(torch, (mesh, mesh_st, mesh_loss),
                                              (one, one_st, one_loss))
        # a prefill: K9 on the local heads
        prefill = spmd.make_prefill_step(cfg, 64)
        one_logits, one_cache = prefill(params, flat)
        mesh_params = placed(params)
        reset_counts(all_ops.values())
        with shctx.activation_mesh(dm, batch_axes=("pod", "data")):
            mesh_logits, mesh_cache = prefill(
                mesh_params, {"tokens": SP.place(flat["tokens"], (("pod", "data"), None), dm)})
        counts = path_counts["mesh_path"] = {k: op.launches for k, op in all_ops.items()}
        assert counts["flash_attention"] == cfg.n_layers, counts
        tol = ATTN_TOL["float32"]  # K9's f32 tolerance
        diffs["prefill_logits"] = mesh_step_diff(torch, mesh_logits, one_logits, tol, tol)
        diffs["prefill_cache"] = mesh_step_diff(torch, mesh_cache, one_cache, tol, tol)
        emit({"phase": "mesh_path", "arch": f"{MESH_ARCH} reduced, f32",
              "mesh": dict(zip(*MESH_LAYOUT)), "backend": backend_name,
              "max_abs_diff_mesh_vs_one_card": diffs, "k9_launches": counts["flash_attention"],
              "seconds": time.perf_counter() - t0})
    finally:
        dist.destroy_process_group()

    # cell 9's collectives on the reference's meshes (fake process groups)
    cell9 = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    table = {}
    for multi_pod in (True, False):
        t1 = time.perf_counter()
        dm, name, chips = dryrun.mesh_for(multi_pod)
        ranks = chips // 16  # (pod x) data ranks
        shape = InputShape("cell9", LM_S, ranks * CELL9_PER_RANK, "train")
        programs = {
            "shadow": dryrun.build(cell9, "cell9", dm, mode="shadow", optimizer="adam",
                                   n_replicas=LM_R, n_microbatches=1, shape_override=shape),
            "syncdp": dryrun.build(cell9, "cell9", dm, mode="syncdp", optimizer="adam",
                                   n_microbatches=1, shape_override=shape),
            "sync:easgd": dryrun.build_sync_step(LM_ARCH, dm, algo="easgd", n_replicas=LM_R,
                                                 cfg=cell9)}
        for mode, program in programs.items():
            cost = dryrun._trace_cost(program)
            r = RA.analyze(cost, arch=LM_ARCH, shape="cell9", mesh_name=name, mode=mode,
                           chips=chips)
            table[f"{name} {mode}"] = row = {
                "chips": chips, "global_batch": shape.global_batch,
                "collective_bytes_per_chip": r.collective_bytes_per_chip,
                "cross_pod_collectives": r.cross_pod_collectives,
                "cross_pod_bytes_per_chip": r.cross_pod_bytes_per_chip,
                "t_collective_ms": r.t_collective * 1e3, "t_compute_ms": r.t_compute * 1e3,
                "t_memory_ms": r.t_memory * 1e3, "by_kind_and_span": r.collective_table}
            if mode == "shadow":
                assert row["cross_pod_collectives"] == 0, row
            elif multi_pod:
                assert row["cross_pod_collectives"] > 0, row
        emit({"phase": "mesh_collectives", "mesh": name, "cell": "cell 9 configuration",
              "per_rank_batch": CELL9_PER_RANK, "seq": LM_S, "layers": LM_LAYERS,
              "rows": {k: v for k, v in table.items() if k.startswith(name + " ")},
              "link_GBps": M.LINK_BW / 1e9, "seconds": time.perf_counter() - t1})
    dist.destroy_process_group()
    return table


def draw_weights(torch, cfg, path):
    """``cfg``'s weights drawn on the card's generator from seed 0, leaf by
    leaf in its dtype (``spmd.init_params``: whisper's tree for audio);
    emits ``{path}_setup``. Returns them and their bytes. Their element
    count must be ``roofline.params.param_count(cfg)``'s."""
    from repro_torch import tree as T
    from repro_torch.core import spmd
    from repro_torch.models import transformer
    from repro_torch.roofline.params import param_count

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = spmd.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in T.leaves(params))
    n_par = transformer.n_params(params)
    assert n_par == param_count(cfg), (n_par, param_count(cfg))
    emit({"phase": f"{path}_setup", "arch": cfg.name, "n_layers": cfg.n_layers,
          "dtype": cfg.dtype, "params": n_par, "param_count": param_count(cfg),
          "weights_GB": weight_bytes / 1e9, "init_s": time.perf_counter() - t0,
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    return params, weight_bytes


def serve_cell(torch, cfg, params, weight_bytes, path, all_ops, path_counts, k9_per_prefill,
               mem_rate, batch=SERVE_B, prompt=SERVE_PROMPT, gen=SERVE_GEN, frontend=None):
    """A served cell (4, 10, 11, 13, 14): ``launch/serve.py``'s warm-up at
    the timed shape, PREFILL_REPS timed prefills (median, spread) and ``gen`` -
    1 greedy decode steps from the last one's cache, through ``spmd``'s
    steps, every K1-K9 counter read (K9 once a prefill for each
    self-attention layer, ``k9_per_prefill``, and never the f32 K9), a
    profiled prefill (the SM clock sampled) and 8 profiled decode steps.
    ``frontend``: ``serve.make_frontend``'s inputs (a prefix of P positions
    goes before the prompt). Returns the row, for the caller to add to and
    emit, and the prompts."""
    from repro_torch.core import spmd
    from repro_torch.launch import serve

    k9, k9_f32 = DEVICE_NAMES["flash_attention"], DEVICE_NAMES["flash_attention_f32"]
    prompts = serve.make_prompts(cfg, batch, prompt, seed=0).cuda()
    frontend = frontend or {}
    n_prefix = frontend["prefix_embeds"].shape[1] if "prefix_embeds" in frontend else 0
    serve.warmup(params, cfg, prompts, frontend)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(all_ops.values())
    res = serve.generate(params, cfg, prompts, gen, prefill_reps=PREFILL_REPS,
                         frontend=frontend)
    counts = path_counts[path] = {kk: op.launches for kk, op in all_ops.items()}
    assert counts["flash_attention"] == PREFILL_REPS * k9_per_prefill, counts
    assert all(c == 0 for kk, c in counts.items() if kk != "flash_attention"), counts
    finite = bool(torch.isfinite(res["prefill_logits"]).all()
                  and torch.isfinite(res["last_logits"]).all())
    assert finite, "non-finite logits"
    tokens = res["tokens"].cpu()
    # the prefill's head is the padded one, unmasked (the reference's): its
    # token may be a padded column; every decoded one is a real id
    assert tokens.shape == (batch, gen) and int(tokens.max()) < -(-cfg.vocab_size // 256) * 256
    assert gen == 1 or int(tokens[:, 1:].max()) < cfg.vocab_size
    n_steps = gen - 1
    row = {"phase": path, "arch": cfg.name, "n_layers": cfg.n_layers, "batch": batch,
           "prefix_len": n_prefix, "prompt_len": prompt, "gen": gen,
           "prefill_ms": res["prefill_s"] * 1e3,
           "prefill_ms_all": [t * 1e3 for t in res["prefill_s_all"]],
           "prefill_spread": (max(res["prefill_s_all"]) - min(res["prefill_s_all"]))
           / res["prefill_s"],
           "prefill_tokens_per_s": batch * (n_prefix + prompt) / res["prefill_s"],
           "decode_ms_per_step": res["decode_s"] / n_steps * 1e3,
           "decode_tokens_per_s": n_steps * batch / res["decode_s"],
           "k9_launches_per_prefill": counts["flash_attention"] // PREFILL_REPS,
           "logits_finite": finite, "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9,
           "first_tokens": tokens[0, :16].tolist()}
    del res

    s_max = n_prefix + prompt + gen
    prefill_step, decode_step = spmd.make_prefill_step(cfg, s_max), spmd.make_decode_step(cfg)
    step_batch = {"tokens": prompts, **frontend}
    with ClockSampler() as clocks:
        (_, cache), by_name, prof = profiled(
            torch, lambda: prefill_step(params, step_batch),
            check=launched(k9, k9_per_prefill) if k9_per_prefill else None)
    k9_ms = sum(t for n, (t, _) in by_name.items() if k9 in n)
    f32_n = sum(c for n, (_, c) in by_name.items() if k9_f32 in n)
    assert f32_n == 0, f"the prefill ran the f32 K9 {f32_n} times"
    row["prefill_profile"] = {
        **prof, **clocks.summary(), "k9_device_ms": k9_ms if by_name else None,
        "k9_ms_per_launch": k9_ms / k9_per_prefill if by_name and k9_per_prefill else None,
        "k9_share_of_device": k9_ms / prof["device_ms"] if by_name else None}
    tok = tokens[:, 0].cuda()

    def steps():
        for i in range(8):
            decode_step(params, cache, tok, n_prefix + prompt + i)

    _, _, prof = profiled(torch, steps)
    row["decode_profile"] = {**prof, "launches_per_step": prof["device_launches"] / 8
                             if prof["device_launches"] is not None else None,
                             "weight_read_bound_ms_per_step": weight_bytes / mem_rate * 1e3}
    del cache
    torch.cuda.empty_cache()
    return row, prompts


def lm_families_phase(torch, mem_rate, all_ops, path_counts):
    """Phase 9: the ssm, MoE and hybrid families. Returns K9's mean device
    ms a launch in the MoE prefill (None where its trace lost events)."""
    from repro_torch import tree as T
    from repro_torch.configs import phi3_medium_14b
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import mamba2, moe, transformer

    def read(path):
        counts = path_counts[path] = {k: op.launches for k, op in all_ops.items()}
        return counts

    # a · cell 10 served: mamba2-780m at full width (no attention: no K9)
    cfg = get_config(FAM_SSM_ARCH)
    params, weight_bytes = draw_weights(torch, cfg, "serve_mamba2")
    row, _ = serve_cell(torch, cfg, params, weight_bytes, "serve_mamba2", all_ops, path_counts,
                        0, mem_rate)
    emit(row)
    del params
    release(torch)

    # b · one full-width mamba2 layer in f32 at B=1, L=512 (two chunks of
    # 256): the chunked scan against L decode steps, and finite gradients
    g = torch.Generator(device="cuda").manual_seed(1)
    p = mamba2.mamba2_init(g, cfg, torch.float32, device="cuda")
    x = torch.randn((1, SCAN_L, cfg.d_model), generator=g, device="cuda")
    reset_counts(all_ops.values())
    with torch.no_grad():
        y = mamba2.mamba2_apply(p, x, cfg)
        cache = mamba2.init_mamba_cache(cfg, 1, torch.float32, device="cuda")
        ys = []
        for t in range(SCAN_L):
            yt, cache = mamba2.mamba2_decode(p, x[:, t:t + 1], cfg, cache)
            ys.append(yt)
        y_seq = torch.cat(ys, dim=1)
    err = (y - y_seq).abs().max().item()
    torch.testing.assert_close(y, y_seq, rtol=SCAN_TOL, atol=SCAN_TOL)
    p = T.map(lambda a: a.requires_grad_(), p)
    grads = torch.autograd.grad(mamba2.mamba2_apply(p, x, cfg).square().mean(), T.leaves(p))
    finite = {k: bool(torch.isfinite(gr).all()) for k, gr in zip(sorted(p), grads)}
    assert all(finite.values()), finite
    assert not any(read("mamba2_scan_full").values())
    emit({"phase": "mamba2_scan_full", "arch": cfg.name, "dtype": "float32", "batch": 1,
          "L": SCAN_L, "chunk": mamba2.effective_chunk(SCAN_L, cfg.ssm.chunk),
          "max_abs_err_chunked_vs_decode": err, "tol": SCAN_TOL, "grads_finite": finite,
          "max_abs_y": y.abs().max().item()})
    del p, x, y, y_seq, ys, cache, grads
    release(torch)

    # c · cell 10 trained: R=2 replicas of mamba2-780m at full width. Model
    # FLOPs: 8 N a token (forward, the unit's recompute, backward), plus the
    # SSD products a replica runs four times (the same three passes, the
    # backward counted twice): per layer and chunk C·B once a group, the
    # decay-weighted sum over s, the carried state's read and its update
    s, (_, H, _) = cfg.ssm, mamba2._dims(cfg)
    q = mamba2.effective_chunk(LM_S, s.chunk)
    ssd = cfg.n_layers * (LM_S // q) * 2 * LM_B * (
        s.n_groups * q * q * s.d_state + H * q * q * s.headdim + 2 * H * q * s.d_state * s.headdim)
    lm_train_cell(torch, cfg, "lm_train_mamba2", all_ops, path_counts,
                  lambda n_par, tokens: 8 * n_par * tokens + 4 * LM_R * ssd,
                  f"(8 * params * tokens + 4 * R * SSD product FLOPs, {4 * LM_R * ssd:.4g}) / "
                  "(median s * BF16_RATE)")

    # d · cell 11 served: phi3.5-moe's widths at 16 of its 32 layers; first
    # K9 against its plain version on layer 0's roped q/k/v at the cell's shape
    moe_cfg = dataclasses.replace(get_config(FAM_MOE_ARCH), n_layers=FAM_MOE_LAYERS)
    params, weight_bytes = draw_weights(torch, moe_cfg, "serve_moe")
    _, q, k, v = layer0_qkv(torch, moe_cfg, params,
                            serve.make_prompts(moe_cfg, SERVE_B, SERVE_PROMPT, seed=0).cuda())
    emit({"phase": "kernel_check", "name": "flash_attention", "cell": "serve_moe",
          **check_attention(torch, q, k, v, True, mem_rate)})
    del q, k, v
    torch.cuda.empty_cache()
    row, prompts = serve_cell(torch, moe_cfg, params, weight_bytes, "serve_moe", all_ops,
                              path_counts, moe_cfg.n_layers, mem_rate)
    k9_ms = row["prefill_profile"]["k9_ms_per_launch"]
    # the share of token-expert assignments each layer drops at capacity
    # 1.25, from one more prefill with the dispatch watched; then two
    # identical prefills, bitwise
    real, keeps = moe._dispatch_indices, []

    def watched(expert_idx, n_experts, cap):
        order, dest, keep = real(expert_idx, n_experts, cap)
        keeps.append(keep)
        return order, dest, keep

    moe._dispatch_indices = watched
    try:
        with torch.no_grad():
            la, ca = transformer.prefill(params, moe_cfg, prompts, SERVE_PROMPT + 1)
    finally:
        moe._dispatch_indices = real
    with torch.no_grad():
        lb, cb = transformer.prefill(params, moe_cfg, prompts, SERVE_PROMPT + 1)
    same = torch.equal(la, lb) and all(torch.equal(a, b) for a, b in zip(T.leaves(ca),
                                                                        T.leaves(cb)))
    assert same, "two identical MoE prefills differ"
    assert len(keeps) == moe_cfg.n_layers, len(keeps)
    drops = [1.0 - k.float().mean().item() for k in keeps]
    row.update({"cut": f"depth {get_config(FAM_MOE_ARCH).n_layers} -> {FAM_MOE_LAYERS}",
                "capacity_factor": moe_cfg.moe.capacity_factor,
                "capacity_prefill": moe.capacity(moe_cfg, SERVE_B * SERVE_PROMPT),
                "capacity_decode": moe.capacity(moe_cfg, SERVE_B),
                "dropped_share_per_layer": drops, "prefill_bitwise_repeatable": same})
    emit(row)
    del prompts, la, lb, ca, cb, keeps
    release(torch)

    # d2 · the same weights served as PaLM's parallel block (one shared
    # pre-norm, attention and MoE added together): K9 once a layer
    par_cfg = dataclasses.replace(moe_cfg, parallel_block=True)
    par, _ = serve_cell(torch, par_cfg, params, weight_bytes, "serve_parallel", all_ops,
                        path_counts, par_cfg.n_layers, mem_rate)
    par.update({"variant": "parallel_block", "cut": row["cut"],
                "sequential_prefill_ms": row["prefill_ms"],
                "sequential_decode_ms_per_step": row["decode_ms_per_step"]})
    emit(par)
    del params, par, row
    release(torch)

    # e · each family reduced (f32) on the card against the CPU, and a
    # windowed reduced phi3
    for name in FAM_REFERENCE:
        small = (reduced(phi3_medium_14b.CONFIG_SWA) if name == "phi3-medium-14b CONFIG_SWA"
                 else reduced(get_config(name)))
        family_reference(torch, small, name, all_ops, path_counts)
    release(torch)
    return k9_ms


def n_self_attention(cfg):
    """K9's launches a prefill of ``cfg``: every unwindowed self-attention
    layer (whisper's encoder and decoder layers both)."""
    if cfg.family == "audio":
        return cfg.encoder.n_layers + cfg.n_layers
    return 0 if cfg.sliding_window else cfg.layer_kinds().count("A")


def family_reference(torch, small, name, all_ops, path_counts):
    """A reduced config (f32) on the card against the CPU, the same weights
    and inputs (the frontend's, where the family has one): the same greedy
    tokens, logits within 2e-4, K9 once a prefill for each self-attention
    layer, and one shadow step (SGD) and an EASGD sync at the trajectory
    tolerance."""
    from repro_torch import optim
    from repro_torch import tree as T
    from repro_torch.core import algorithms, spmd
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import tokens as tok
    from repro_torch.launch import serve

    p_cpu = spmd.init_params(small, torch.Generator().manual_seed(0), device="cpu")
    pr = serve.make_prompts(small, 2, 100, seed=0)
    front = serve.make_frontend(small, 2, 0)
    cpu = serve.generate(p_cpu, small, pr, 8, frontend=front)
    reset_counts(all_ops.values())
    card = serve.generate(T.map(lambda t: t.cuda(), p_cpu), small, pr.cuda(), 8,
                          frontend=T.map(lambda t: t.cuda(), front))
    path = f"families_reference_{small.name}{'_swa' if small.sliding_window else ''}"
    counts = path_counts[path] = {k: op.launches for k, op in all_ops.items()}
    assert counts["flash_attention"] == n_self_attention(small), (name, counts)
    assert all(c == 0 for kk, c in counts.items() if kk != "flash_attention"), counts
    assert torch.equal(card["tokens"].cpu(), cpu["tokens"]), (name, card["tokens"])
    diff = 0.0
    for kk in ("prefill_logits", "last_logits"):
        torch.testing.assert_close(card[kk].cpu(), cpu[kk], rtol=2e-4, atol=2e-4)
        diff = max(diff, (card[kk].cpu() - cpu[kk]).abs().max().item())
    toks = tok.gen_batch(tok.make_transition(small.vocab_size, seed=1), 1, 0, 2 * 2,
                         64)["tokens"].reshape(2, 2, 64)
    batch = {"tokens": toks, **{k: v.reshape(2, 2, *v.shape[1:])
                                for k, v in serve.make_frontend(small, 4, 1).items()}}
    sc = SyncConfig(algo="easgd", alpha=0.5).validate()
    res = {}
    for dev in ("cuda", "cpu"):
        stack = spmd.stack_replicas(T.map(lambda t: t.to(dev), p_cpu), 2)
        ps = algorithms.get("easgd").init_state(T.map(lambda t: t[0], stack), sc)
        stack, _, loss = spmd.make_train_step(small, optim.sgd(0.1), "shadow")(
            stack, (), T.map(lambda t: t.to(dev), batch))
        stack, ps = spmd.make_sync_step(small, sc)(stack, ps)
        res[dev] = T.map(lambda t: t.cpu(), (loss, stack, ps))
    step_diff = 0.0
    for a, b in zip(T.leaves(res["cuda"]), T.leaves(res["cpu"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)  # trajectory tol
        step_diff = max(step_diff, (a.double() - b.double()).abs().max().item())
    emit({"phase": "families_reference", "arch": f"{name} reduced, f32",
          "family": small.family, "layer_pattern": small.layer_pattern,
          "tokens_equal": True, "max_logit_diff_cuda_vs_cpu": diff,
          "max_step_diff_cuda_vs_cpu": step_diff, "loss": res["cuda"][0].tolist(),
          "k9_launches_per_prefill": counts["flash_attention"]})


def whisper_train_flops(cfg, n_clips):
    """Model FLOPs of a whisper training iteration over ``n_clips`` clips of
    ``n_ctx`` frames and AUD_TRAIN_S tokens: forward and backward (3x) of
    every weight product (the encoder's layers per frame; the decoder's
    layers, its cross-attention's K/V projections per frame, and the tied
    head per token) and of the attention products (encoder over every key,
    decoder causal, cross over every frame), plus the encoder's attention
    once more (its query chunks are recomputed in the backward pass)."""
    d, ff, F, S = cfg.d_model, cfg.d_ff, cfg.encoder.n_ctx, AUD_TRAIN_S
    n_enc, n_dec = cfg.encoder.n_layers, cfg.n_layers
    v_pad = -(-cfg.vocab_size // 256) * 256
    weights = 2 * (F * n_enc * (4 * d * d + 2 * d * ff)
                   + S * n_dec * (6 * d * d + 2 * d * ff) + F * n_dec * 2 * d * d + S * d * v_pad)
    enc_attn = 4 * F * F * d * n_enc
    attn = enc_attn + 4 * S * (S + 1) // 2 * d * n_dec + 4 * S * F * d * n_dec
    return n_clips * (3 * (weights + attn) + enc_attn)


def vlm_audio_phase(torch, mem_rate, all_ops, path_counts):
    """Phase 10: the audio (cell 13) and vlm (cell 14) families at full
    width, then both reduced on the card against the CPU. Returns K9's
    checks and times at the two cells' shapes, for the kernel table."""
    from repro_torch import tree as T
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import layers, whisper
    from repro_torch.models.layers import dtype_of

    keys = ("shape", "kv_heads", "dtype", "causal", "max_abs_err", "rel_norm_err", "ms",
            "op_ms", "call_ms", "plain_ms", "plain_call_ms", "library_ms", "bound_ms",
            "bound_by")
    k9 = {}

    # a · cell 13 served: whisper-base at full width, bf16 frames; first K9
    # against its plain version on encoder layer 0's q/k/v (every key),
    # timed beside SDPA and the plain version
    cfg = get_config(AUD_ARCH)
    params, weight_bytes = draw_weights(torch, cfg, "serve_whisper")
    front = serve.make_frontend(cfg, AUD_B, 0, dtype_of(cfg.dtype), "cuda")
    with torch.no_grad():
        lp = T.map(lambda a: a[0], params["enc"])
        fr = front["frames"]
        S, hd = fr.shape[1], cfg.resolved_head_dim
        x = fr + whisper.sinusoids(S, cfg.d_model, fr.device).to(fr.dtype)
        h = layers.layernorm(lp["norm1"], x, cfg.norm_eps)
        q = (h @ lp["attn"]["wq"]).reshape(AUD_B, S, cfg.n_heads, hd)
        k = (h @ lp["attn"]["wk"]).reshape(AUD_B, S, cfg.n_kv_heads, hd)
        v = (h @ lp["attn"]["wv"]).reshape(AUD_B, S, cfg.n_kv_heads, hd)
    chk = check_attention(torch, q, k, v, False, mem_rate, timed=True)
    emit({"phase": "kernel", **chk, "name": "flash_attention", "cell": "serve_whisper",
          "library": "scaled_dot_product_attention(is_causal=False)"})
    k9["whisper_encoder"] = {kk: chk[kk] for kk in keys if kk in chk}
    del q, k, v, x, h, lp, chk
    row, _ = serve_cell(torch, cfg, params, weight_bytes, "serve_whisper", all_ops, path_counts,
                        n_self_attention(cfg), mem_rate, batch=AUD_B, prompt=AUD_PROMPT,
                        gen=AUD_GEN, frontend=front)
    emit(row)
    k9["whisper_path_ms"] = row["prefill_profile"]["k9_ms_per_launch"]
    del params, front, row
    release(torch)

    # b · cell 13 trained: R=2 x B=8 clips, frames from their own numpy stream
    def frames_of(it):
        f = serve.make_frontend(cfg, LM_R * AUD_TRAIN_B, it + 1, dtype_of(cfg.dtype),
                                "cuda")["frames"]
        return {"frames": f.reshape(LM_R, AUD_TRAIN_B, *f.shape[1:])}

    lm_train_cell(torch, cfg, "lm_train_whisper", all_ops, path_counts,
                  lambda n_par, tokens: whisper_train_flops(cfg, LM_R * AUD_TRAIN_B),
                  "chip_smoke.whisper_train_flops (3 x weight and attention products, the "
                  "encoder's attention once more) / (median s * BF16_RATE)",
                  batch=AUD_TRAIN_B, seq=AUD_TRAIN_S, extra=frames_of)

    # c · cell 14: llava-next-34b at full width, every earlier phase's
    # weights released first; K9 timed at the cell's shape on random q/k/v
    # while the card is empty (the plain version's f32 score tiles take
    # 27 GB), then held against its plain version on layer 0's own
    mem = {"allocated_GB_before": torch.cuda.memory_allocated() / 1e9,
           "reserved_GB_before": torch.cuda.memory_reserved() / 1e9}
    release(torch)
    emit({"phase": "vlm_memory", **mem,
          "allocated_GB_after": torch.cuda.memory_allocated() / 1e9,
          "reserved_GB_after": torch.cuda.memory_reserved() / 1e9})
    cfg = get_config(VLM_ARCH)
    n_prefix, hd = cfg.frontend.n_tokens, cfg.resolved_head_dim
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((VLM_B, n_prefix + VLM_PROMPT, cfg.n_heads, hd), generator=g,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((VLM_B, n_prefix + VLM_PROMPT, cfg.n_kv_heads, hd), generator=g,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    chk = check_attention(torch, q, k, v, True, mem_rate, timed=True)
    emit({"phase": "kernel", **chk, "name": "flash_attention", "cell": "serve_llava",
          "inputs": "random normal", "library": "scaled_dot_product_attention(is_causal=True, "
                                                 "enable_gqa=True)"})
    k9["llava_prefill"] = {kk: chk[kk] for kk in keys if kk in chk}
    del q, k, v, chk
    release(torch)
    params, weight_bytes = draw_weights(torch, cfg, "serve_llava")
    front = serve.make_frontend(cfg, VLM_B, 0, dtype_of(cfg.dtype), "cuda")
    prompts = serve.make_prompts(cfg, VLM_B, VLM_PROMPT, seed=0).cuda()
    with torch.no_grad():
        _, q, k, v = layer0_qkv(torch, cfg, params, prompts, front["prefix_embeds"])
    chk = check_attention(torch, q, k, v, True, mem_rate, by_row=True)
    emit({"phase": "kernel_check", "name": "flash_attention", "cell": "serve_llava", **chk})
    k9["llava_layer0"] = {kk: chk[kk] for kk in keys if kk in chk}
    del q, k, v, prompts, chk
    release(torch)
    row, _ = serve_cell(torch, cfg, params, weight_bytes, "serve_llava", all_ops, path_counts,
                        cfg.n_layers, mem_rate, batch=VLM_B, prompt=VLM_PROMPT, gen=VLM_GEN,
                        frontend=front)
    emit(row)
    k9["llava_path_ms"] = row["prefill_profile"]["k9_ms_per_launch"]
    del params, front, row
    release(torch)

    # d · both reduced (f32) on the card against the CPU
    for name in (VLM_ARCH, AUD_ARCH):
        family_reference(torch, reduced(get_config(name)), name, all_ops, path_counts)
    release(torch)
    return k9


def lm_train_cell(torch, cfg, path, all_ops, path_counts, flops_of, flops_formula,
                  batch=LM_B, seq=LM_S, extra=None, after=None, attn_layers=None, **setup):
    """Cells 9, 10 and 13 trained: LM_R replicas of ``cfg`` at full width,
    Adam, shadow EASGD every LM_GAP iterations, ``batch`` x ``seq`` tokens a
    replica on the Markov stream over the first LM_STREAM_VOCAB ids (and
    ``extra(it)``'s inputs, (LM_R, batch, ...) each: whisper's frames);
    LM_WARM warm-up and LM_ITERS timed iterations, every leaf checked
    finite after each, and one profiled iteration, with no K1-K9 prefill
    launch. The training attention's kernels' launches are counted: with
    ``attn_layers`` (self-attention layers that take them, every unit
    recomputed) asserted 2 x layers x LM_R forward and layers x LM_R backward
    an iteration.
    ``flops_of(params, tokens)`` gives the model FLOPs an iteration
    (``flops_formula`` says how); ``setup`` goes into the set-up line. A
    ``model_flops`` line gives ``roofline.analysis.model_flops_estimate``'s
    count for the same shape, with ``param_count`` (asserted equal to the
    parameters drawn) beside it. ``after(state, batches, opt)`` runs last,
    on the trained state."""
    from repro_torch import optim
    from repro_torch import tree as T
    from repro_torch.core import algorithms, spmd
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import tokens as tok
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels.flash_attention.ops import attention_train_bwd, attention_train_op
    from repro_torch.models import transformer
    from repro_torch.roofline.analysis import model_flops_estimate
    from repro_torch.roofline.params import param_count

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = spmd.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_par = transformer.n_params(params)
    opt = optim.adam(LM_LR)
    state = {"stack": spmd.stack_replicas(params, LM_R),
             "opt": spmd.stack_replicas(opt.init(params), LM_R)}
    sync_cfg = SyncConfig(algo="easgd", alpha=0.5).validate()
    state["algo"] = algorithms.get("easgd").init_state(params, sync_cfg)
    dtypes = sorted({str(t.dtype) for t in T.leaves(params)})
    del params
    train_step = spmd.make_train_step(cfg, opt, "shadow")
    sync_step = spmd.make_sync_step(cfg, sync_cfg)
    trans = tok.make_transition(LM_STREAM_VOCAB, seed=0)
    batches = [{"tokens": tok.gen_batch(trans, 0, it, LM_R * batch, seq)["tokens"]
                .reshape(LM_R, batch, seq).cuda(), **(extra(it) if extra else {})}
               for it in range(LM_WARM + LM_ITERS + 1)]
    torch.cuda.synchronize()
    emit({"phase": f"{path}_setup", "arch": cfg.name, "n_layers": cfg.n_layers, **setup,
          "dtype": cfg.dtype, "leaf_dtypes": dtypes, "params": n_par, "replicas": LM_R,
          "batch_per_replica": batch, "seq_len": seq, "stream_vocab": LM_STREAM_VOCAB,
          "setup_s": time.perf_counter() - t0,
          "allocated_GB": torch.cuda.memory_allocated() / 1e9,
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    sync_ms = []

    def iteration(it):
        state["stack"], state["opt"], loss = train_step(state["stack"], state["opt"],
                                                        batches[it])
        if (it + 1) % LM_GAP == 0:
            torch.cuda.synchronize()
            t_s = time.perf_counter()
            state["stack"], state["algo"] = sync_step(state["stack"], state["algo"])
            torch.cuda.synchronize()
            sync_ms.append((time.perf_counter() - t_s) * 1e3)
        return loss

    def all_finite():
        leaves = T.leaves((state["stack"], state["opt"], state["algo"]))
        return bool(torch.stack([torch.isfinite(t).all() for t in leaves]).all())

    reset_counts(all_ops.values())
    reset_counts((attention_train_op, attention_train_bwd))
    losses, iter_ms = [], []
    for it in range(LM_WARM + LM_ITERS):
        torch.cuda.synchronize()
        if it == LM_WARM:
            torch.cuda.reset_peak_memory_stats()
            sync_ms.clear()
        t_i = time.perf_counter()
        loss = iteration(it)
        torch.cuda.synchronize()
        if it >= LM_WARM:
            iter_ms.append((time.perf_counter() - t_i) * 1e3)
        losses.append(float(loss.mean()))
        assert all_finite(), f"a non-finite leaf after iteration {it}"
    peak = torch.cuda.max_memory_allocated()
    # the training kernels' launches in the warm-up and timed iterations (a
    # profiled run may be run again where its trace lost events)
    trained = {"forward": attention_train_op.launches, "backward": attention_train_bwd.launches}
    if attn_layers is not None:
        n = attn_layers * LM_R * (LM_WARM + LM_ITERS)
        assert trained == {"forward": 2 * n, "backward": n}, (trained, n)
    _, _, prof = profiled(torch, lambda: iteration(LM_WARM + LM_ITERS), warm=False)
    counts = path_counts[path] = {k: op.launches for k, op in all_ops.items()}
    assert not any(counts.values()), counts
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
    assert len(sync_ms) == LM_ITERS // LM_GAP, sync_ms
    med = sorted(iter_ms)[len(iter_ms) // 2]
    tokens = LM_R * batch * seq
    flops = flops_of(n_par, tokens)
    emit({"phase": path, "arch": cfg.name, "n_layers": cfg.n_layers, "iters": LM_ITERS,
          "ms_per_iter_median": med, "ms_per_iter": iter_ms,
          "spread": (max(iter_ms) - min(iter_ms)) / med,
          "tokens_per_s": tokens * LM_ITERS / (sum(iter_ms) / 1e3),
          "sync_ms": sync_ms, "loss_first": losses[0], "loss_last": losses[-1],
          "losses": losses, "all_leaves_finite_every_step": True, "peak_mem_GB": peak / 1e9,
          "model_flops_per_iter": flops, "mfu_formula": flops_formula,
          "mfu": flops / (med / 1e3) / BF16_RATE, "launches": 0,
          "attention_train_launches": trained, "profile": prof})
    counted = param_count(cfg)
    assert counted == n_par, (counted, n_par)
    shape = InputShape(path, seq, LM_R * batch, "train")
    emit({"phase": "model_flops", "path": path, "arch": cfg.name, "n_layers": cfg.n_layers,
          "param_count": counted, "params_drawn": n_par, "shape": dataclasses.asdict(shape),
          "model_flops_per_iter": model_flops_estimate(cfg, shape),
          "formula": "roofline.analysis.model_flops_estimate: 6 * active params * global_batch"
                     " * seq_len", "smoke_flops_per_iter": flops})
    if after is not None:
        after(state, batches, opt)
    del state, batches
    release(torch)


def shadow_plan(sim, state, n_iters, n_live, sched=()):
    """(launches, landings, joins) of the shadow syncs of ``n_iters``
    iterations from ``state`` (before the run, which moves it), replayed
    from the run's own ``_shadow_schedule`` and membership schedule as
    ``HogwildSim.run`` applies them (delay >= 1). A landing counts when it
    runs a kernel: under Gossip, when a pair member it drew at launch (from
    the round counter) is still live."""
    import numpy as np

    from repro_torch.core import algorithms

    gossip = sim.algo.name == "gossip"
    counter = state.algo_state if gossip else 0
    active = np.arange(sim.R) < n_live
    pending, launches, landings, joins = None, 0, 0, 0
    for t in range(state.step, state.step + n_iters):
        for it, kind, slot in sched:
            if it == t:
                active[slot] = kind == "join"
                joins += kind == "join"
        if pending is not None and t + 1 >= pending[0]:
            if active.any():
                landings += not gossip or bool(active[pending[1]].any())
                counter += 1
            pending = None
        mask = sim._shadow_schedule(t + 1) & active
        if pending is None and mask.any():
            launches += 1
            rows = (algorithms._gossip_participants_np(mask, sim.R, counter, active)[0]
                    if gossip else [])
            pending = (t + 1 + sim.sync_cfg.delay, np.asarray(rows, dtype=np.int64))
    return launches, landings, joins


def expected_sync_counts(algo, launches, landings, joins):
    """Launches of each sync wrapper that a run with these launches,
    landings and joins makes: elastic runs (``joins`` not None) go through
    the *_rows kernels only."""
    if joins is None:
        return {"ma": {"replica_mean": launches, "ma_update": landings},
                "bmuf": {"replica_mean": launches, "bmuf_update": landings},
                "gossip": {"gossip_round": landings}}[algo]
    return {"ma": {"replica_mean_rows": launches + joins, "ma_update_rows": landings},
            "bmuf": {"replica_mean_rows": launches + joins, "bmuf_update_rows": landings},
            "gossip": {"replica_mean_rows": joins, "gossip_round": landings}}[algo]


def profile_window(torch, sim, state, iters):
    """Device time by kernel over ``iters`` main-path iterations (a trace
    that lost events is made again over the next ``iters``). Returns
    (summary, next state); the device figures are None (not measured) where
    every trace lost events."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_op

    cur = {"state": state}

    def body():
        before = embedding_bag_op.launches
        out = sim.run(iters, state=cur["state"])
        cur["state"], cur["k1"] = out["state"], embedding_bag_op.launches - before
        return out

    _, wall_ms, events, host = traced(torch, body, warm=False, host=True,
                                      check=lambda evs: launched(K1, cur["k1"])(evs))
    if events is None:
        return {"iters": iters, "wall_ms": wall_ms, "device_ms": None, "idle_share": None}, \
            cur["state"]
    by_name = device_kernels(events)
    busy = sum(t for t, _ in by_name.values())
    per_kernel = {}
    for k, dev_name in DEVICE_NAMES.items():  # device ms a wrapper call
        found = [(t, c) for n, (t, c) in by_name.items() if hits(dev_name, n)]
        calls = sum(c for _, c in found) / len(globals_of(dev_name))
        per_kernel[k] = sum(t for t, _ in found) / max(calls, 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]
    return {"iters": iters, "wall_ms": wall_ms, "device_ms": busy, "idle_share": 1 - busy / wall_ms,
            "device_launches": sum(c for _, c in by_name.values()),
            "kernel_device_ms_main_path": per_kernel,
            "top_device": [[n[:80], t, c] for n, (t, c) in top],
            "top_host_self": [[e.key[:60], e.self_cpu_time_total / 1e3, e.count] for e in host]}, \
        cur["state"]


def busy_union_ms(intervals):
    """Total length of the union of (start, end) intervals, in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def threaded_profile(torch, runner, iters):
    """Device idle share of a threaded run, from a torch.profiler trace of
    every stream: the window runs from the trainers' first embedding-bag
    launch to the last device activity; busy is the union of device
    intervals in it (the streams overlap, so their times do not add). A
    trace that lost events is made again over the next ``iters``; where every
    one lost some, the device figures are None (not measured)."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_op

    cur = {}

    def body():
        before = embedding_bag_op.launches
        out = runner.run(iters)
        cur["k1"] = embedding_bag_op.launches - before
        return out

    out, _, evs, _ = traced(torch, body, warm=False,
                            check=lambda evs: launched(K1, cur["k1"])(evs))
    if evs is None:
        return {"iters": iters, "window_ms": None, "device_busy_ms": None, "idle_share": None,
                "sync_rounds": out["sync_rounds"]}
    first = min(ev.time_range.start for ev in evs if DEVICE_NAMES["embedding_bag"] in ev.name)
    spans = [(max(ev.time_range.start, first), ev.time_range.end) for ev in evs
             if ev.time_range.end > first]
    window_ms = (max(e for _, e in spans) - first) / 1e3
    busy_ms = busy_union_ms(spans)
    by_name = {}
    for ev in evs:
        if ev.time_range.end > first:
            tot, cnt = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.time_range.elapsed_us() / 1e3, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"iters": iters, "window_ms": window_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / window_ms, "sync_rounds": out["sync_rounds"],
            "device_launches": sum(c for _, c in by_name.values()),
            "top_device": [[n[:80], t, c] for n, (t, c) in top]}


def snapshot_ms(torch, emb):
    """Event-timed ``snapshot_all`` of every healthy shard, on its own stream."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        emb.snapshot_all()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        emb.snapshot_all()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def reset_counts(ops):
    for op in ops:
        op.launches = 0


def release(torch):
    """Free the device memory of the objects just dropped: collect any
    reference cycles, then return the cached blocks."""
    gc.collect()
    torch.cuda.empty_cache()


def ptxas_report(log):
    """{mangled __global__: {registers, static_smem_bytes, spill_stores,
    spill_loads}} from an ``nvcc -Xptxas -v`` log."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
        elif cur is not None and "spill" in ln:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln).groups()
            cur.update(spill_stores=int(st), spill_loads=int(ld))
        elif cur is not None and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def sass_ops(sass, ops):
    """{function: {op: count}} of a ``cuobjdump -sass`` listing (each op a
    regular expression)."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        out[name.strip()] = {op: len(re.findall(op, body)) for op in ops}
    return out


def k9_instance(mangled):
    """(K9 __global__ name, head dim) of a mangled name."""
    m = re.search(r"(flash_attention_(?:wgmma|tf32x3|bwd_delta|bwd_dkdv|bwd_dq)_kernel)ILi(\d+)E",
                  mangled)
    assert m and (m.group(1) in DEVICE_NAMES_BY_SOURCE["flash_attention"].values()
                  or m.group(1) in K9_BWD_KERNELS), mangled
    return m.group(1), int(m.group(2))


def k9_build_report(backend):
    """Phase 2, K9: each __global__'s registers, shared memory (static from
    the build log, dynamic from the library for the two forward kernels)
    and spills, and the SASS of every kernel; fails unless each head dim of
    the bf16 kernel (and of the training backward's dK/dV and dQ kernels, at
    64 and 128) holds wgmma and TMA loads (K9_SASS_OPS), and each of the f32
    kernel TF32 tensor-core products (K9_F32_SASS_OPS) and no spill."""
    import ctypes

    lib = backend.library_path("flash_attention")
    with open(lib + ".log") as f:
        report = ptxas_report(f.read())
    smem_fn = backend.c_function("flash_attention", "flash_attention_smem_bytes",
                                 [ctypes.c_int, ctypes.c_int])
    f32_spills = {}
    for mangled, info in sorted(report.items()):
        name, d = k9_instance(mangled)
        forward = name in DEVICE_NAMES_BY_SOURCE["flash_attention"].values()
        emit({"phase": "build_k9", "kernel": name, "head_dim": d, **info,
              "dynamic_smem_bytes": smem_fn(d, int(name == DEVICE_NAMES["flash_attention"]))
              if forward else None})
        if name == DEVICE_NAMES["flash_attention_f32"]:
            f32_spills[d] = info["spill_stores"] + info["spill_loads"]
    assert f32_spills == {32: 0, 64: 0, 128: 0}, f"f32 K9 spill bytes by head dim: {f32_spills}"
    sass = subprocess.run([backend.cuda_tool("cuobjdump"), "-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    found = {DEVICE_NAMES["flash_attention"]: {}, DEVICE_NAMES["flash_attention_f32"]: {}}
    for fn, counts in sass_ops(sass, K9_SASS_OPS + ("UTMASTG",) + K9_F32_SASS_OPS).items():
        name, d = k9_instance(fn)
        found.setdefault(name, {})[d] = counts
    for name, ops, dims in ((DEVICE_NAMES["flash_attention"], K9_SASS_OPS, [32, 64, 128]),
                            (DEVICE_NAMES["flash_attention_f32"], K9_F32_SASS_OPS, [32, 64, 128]),
                            (K9_BWD_KERNELS[1], K9_SASS_OPS, [64, 128]),
                            (K9_BWD_KERNELS[2], K9_SASS_OPS, [64, 128])):
        emit({"phase": "build_k9_sass", "kernel": name, "by_head_dim": found[name]})
        assert sorted(found[name]) == dims, f"{name} instances: {sorted(found[name])}"
        for d, counts in found[name].items():
            assert all(counts[op] > 0 for op in ops), f"{name} d={d} SASS: {counts}"


def window_profile(torch, body, first, last):
    """Device idle share of one ``body()`` in the window from the first launch
    of kernel ``first`` to the end of the last of ``last`` (a trace that lost
    events is made again): busy is the union of device intervals in it. Also
    the whole traced call's wall and device ms and its idle share (as
    ``profile_window`` takes it), and the top device entries (kernels and
    copies) of the window. None where every trace lost events."""
    out, wall_ms, evs, _ = traced(torch, body, warm=False)
    if evs is None:
        return out, {"window_ms": None, "device_busy_ms": None, "idle_share": None,
                     "wall_ms": wall_ms}
    start = min(ev.time_range.start for ev in evs if first in ev.name)
    end = max(ev.time_range.end for ev in evs if last in ev.name)
    spans = [(max(ev.time_range.start, start), min(ev.time_range.end, end)) for ev in evs
             if ev.time_range.end > start and ev.time_range.start < end]
    busy_ms = busy_union_ms(spans)
    window_ms = (end - start) / 1e3
    by_name = {}
    for ev in evs:
        if ev.time_range.end > start and ev.time_range.start < end:
            tot, cnt = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + ev.time_range.elapsed_us() / 1e3, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    whole_ms = sum(ev.time_range.elapsed_us() for ev in evs) / 1e3
    return out, {"window_ms": window_ms, "device_busy_ms": busy_ms,
                 "idle_share": 1 - busy_ms / window_ms, "wall_ms": wall_ms,
                 "device_ms_whole_call": whole_ms, "idle_share_whole_call": 1 - whole_ms / wall_ms,
                 "top_device": [[n[:80], t, c] for n, (t, c) in top]}


def cache_phase(torch, cfg, all_ops, path_counts):
    """``cache_path``: the full-width sim cached and uncached from one seed,
    bitwise equal; K2 on hot slots at the sim shape; a profiled cached
    window. Returns the uncached sim and its final state (the checkpoint
    phase's), and the K1/K2 launches of the cached run."""
    import numpy as np

    from repro_torch import optim
    from repro_torch import tree as T
    from repro_torch.core.runners import HogwildSim, SimState
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import ctr
    from repro_torch.embeddings.cache import CacheConfig
    from repro_torch.kernels.sparse_adagrad.ops import sparse_adagrad_op

    def make(cache):
        return HogwildSim(cfg, SyncConfig(), n_trainers=R, n_threads=M, batch_size=B,
                          optimizer=optim.adagrad(0.02), seed=11, cache=cache, device="cuda")

    cache = CacheConfig(hot_rows=CACHE_HOT_ROWS, lookahead=CACHE_LOOKAHEAD)
    sims = {"uncached": make(None), "cached": make(cache)}
    st = sims["uncached"].init_state()
    states = {"uncached": st,
              "cached": SimState(st.w_stack.clone(), T.map(torch.clone, st.opt_stack),
                                 T.map(torch.clone, st.emb_state), st.algo_state.clone(), 0)}
    runs = {}
    for name, sim in sims.items():
        stamps = []
        torch.cuda.synchronize()
        reset_counts(all_ops.values())
        t0 = time.perf_counter()
        out = sim.run(CACHE_ITERS, state=states[name],
                      on_iter=lambda t, loss: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = path_counts[f"sim_{name}"] = {k: op.launches for k, op in all_ops.items()}
        assert counts["embedding_bag"] == counts["sparse_adagrad"] == CACHE_ITERS, (name, counts)
        runs[name] = {"out": out, "wall_s": wall, "counts": counts,
                      "ms_per_iter": (stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3}
    u, c = runs["uncached"]["out"], runs["cached"]["out"]
    assert all(math.isfinite(x) for x in u["train_loss"]), u["train_loss"]
    assert u["train_loss"] == c["train_loss"], (u["train_loss"], c["train_loss"])
    for k in ("table", "acc"):
        assert c["state"].emb_state[k].is_cuda
        assert torch.equal(u["state"].emb_state[k], c["state"].emb_state[k]), k
    assert torch.equal(u["state"].w_stack, c["state"].w_stack)
    cs = c["cache_stats"]
    assert cs["prefetch_rows"] > 0 and cs["evict_rows"] > 0, cs
    assert cs["lookups"] == CACHE_ITERS and cs["dropped_updates"] == 0, cs
    hot_mb = CACHE_HOT_ROWS * cfg.embedding_dim * 4 * 2 / 1e6
    emit({"phase": "cache_path", "iters": CACHE_ITERS, "hot_rows": CACHE_HOT_ROWS,
          "hot_MB": hot_mb, "hot_share_of_rows": CACHE_HOT_ROWS / cfg.n_embedding_rows,
          "lookahead": CACHE_LOOKAHEAD, "bitwise_losses": True, "bitwise_tables": True,
          "ms_per_iter_uncached": runs["uncached"]["ms_per_iter"],
          "ms_per_iter_cached": runs["cached"]["ms_per_iter"],
          "run_s_uncached": runs["uncached"]["wall_s"], "run_s_cached": runs["cached"]["wall_s"],
          "hit_rate": cs["hit_rows"] / max(cs["hit_rows"] + cs["miss_rows"], 1),
          "stall_lookups": cs["stall_lookups"], "prefetch_rows": cs["prefetch_rows"],
          "evict_rows": cs["evict_rows"], "MB_migrated": (cs["bytes_h2d"] + cs["bytes_d2h"]) / 1e6,
          "MB_h2d": cs["bytes_h2d"] / 1e6, "MB_d2h": cs["bytes_d2h"] / 1e6, "cache_stats": cs,
          "launches_cached": {k: runs["cached"]["counts"][k]
                              for k in ("embedding_bag", "sparse_adagrad")},
          "loss_last": c["train_loss"][-1]})

    # K2 on hot slots at the sim shape (iteration 0's ids, a random slot
    # permutation): bitwise the full table's with the rows as the sort key,
    # and not without it (the runs then meet the tiles elsewhere)
    spec = sims["cached"].spec
    rows = (ctr.sparse_ids(cfg, 0, 0, R * M * B) + spec.offsets[None, :, None]).reshape(
        -1, cfg.multi_hot)
    uniq = np.unique(rows)
    slot_of = np.full(spec.total_rows, -1, np.int64)
    slot_of[uniq] = np.random.default_rng(0).permutation(len(uniq))
    hot_of = torch.from_numpy(uniq[np.argsort(slot_of[uniq])]).cuda()
    full = {k: v.clone() for k, v in u["state"].emb_state.items()}
    g = torch.randn((rows.shape[0], cfg.embedding_dim),
                    generator=torch.Generator().manual_seed(5)).cuda()
    rows_t, slots_t = torch.from_numpy(rows).cuda(), torch.from_numpy(slot_of[rows]).cuda()
    ht, ha = full["table"][hot_of], full["acc"][hot_of]
    nt, na = ht.clone(), ha.clone()
    sparse_adagrad_op(full["table"], full["acc"], rows_t, g, lr=0.05)
    sparse_adagrad_op(ht, ha, slots_t, g, lr=0.05, order_ids=rows_t)
    sparse_adagrad_op(nt, na, slots_t, g, lr=0.05)
    by_row = torch.equal(ht, full["table"][hot_of]) and torch.equal(ha, full["acc"][hot_of])
    by_slot = torch.equal(nt, full["table"][hot_of]) and torch.equal(na, full["acc"][hot_of])
    assert by_row and not by_slot, (by_row, by_slot)
    emit({"phase": "kernel_check", "name": "sparse_adagrad_hot_slots", "occurrences": rows.size,
          "distinct_rows": len(uniq), "bitwise_sorted_by_row": by_row,
          "bitwise_sorted_by_slot": by_slot})
    del full, ht, ha, nt, na, g, rows_t, slots_t, hot_of

    # where the cached iteration's time goes: K1's first launch to K2's last
    state = c["state"]
    _, prof = window_profile(torch, lambda: sims["cached"].run(CACHE_PROFILED, state=state),
                             DEVICE_NAMES["embedding_bag"], DEVICE_NAMES["sparse_adagrad"][-1])
    emit({"phase": "cache_profile", "iters": CACHE_PROFILED, **prof})
    # the host's side of it: cProfile over as many cached iterations (the
    # store's build and merge included), by function
    host = cProfile.Profile()
    host.enable()
    state = sims["cached"].run(CACHE_PROFILED, state=state)["state"]
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host).stats  # {(file, line, name): (cc, nc, tottime, cumtime, callers)}
    by_fn = sorted(((v[2], v[3], v[1], f"{os.path.basename(k[0])}:{k[2]}")
                    for k, v in stats.items()), reverse=True)
    mine = {f"cache.py:{name}": next((round(cum * 1e3, 3) for _, cum, _, fn in by_fn
                                      if fn == f"cache.py:{name}"), None)
            for name in ("prefetch", "lookup", "update", "merged", "__init__")}
    emit({"phase": "cache_host_profile", "iters": CACHE_PROFILED,
          "cumulative_ms": mine,
          "top_self_ms": [[fn, round(tot * 1e3, 3), n] for tot, _, n, fn in by_fn[:10]]})
    launches = runs["cached"]["counts"]
    del sims["cached"], states, runs, c, state
    return sims["uncached"], u["state"], launches


def threaded_cache_phase(torch, cfg, all_ops, path_counts):
    """``threaded_cache_path``: four cached trainer threads at full width, and
    one fixed_rate trainer cached against uncached, bitwise."""
    from repro_torch import optim
    from repro_torch import tree as T
    from repro_torch.core.runners import ThreadedShadowRunner
    from repro_torch.core.sync import SyncConfig
    from repro_torch.embeddings.cache import CacheConfig

    cache = CacheConfig(hot_rows=THREADED_HOT_ROWS, lookahead=CACHE_LOOKAHEAD)
    rc = ThreadedShadowRunner(cfg, SyncConfig(), n_trainers=R, batch_size=B,
                              optimizer=optim.adagrad(0.02), n_emb_shards=N_SHARDS, cache=cache,
                              device="cuda")
    rc.warmup()
    reset_counts(all_ops.values())
    out = rc.run(THREADED_CACHE_ITERS)
    counts = path_counts["threaded_cached"] = {k: op.launches for k, op in all_ops.items()}
    n_calls = R * N_SHARDS * THREADED_CACHE_ITERS
    assert all(math.isfinite(x) for x in out["train_loss"]), out["train_loss"]
    assert out["iter_count"] == [THREADED_CACHE_ITERS] * R, out["iter_count"]
    assert counts["embedding_bag"] == counts["sparse_adagrad"] == n_calls, counts
    cs = out["cache_stats"]
    assert cs["lookups"] == n_calls and cs["prefetch_rows"] > 0, cs
    assert out["dropped_updates"] == [0] * N_SHARDS, out["dropped_updates"]
    packed = out["emb_state"]
    assert packed["table"].shape == (cfg.n_embedding_rows, cfg.embedding_dim)
    assert bool(torch.isfinite(packed["table"]).all())
    emit({"phase": "threaded_cache_path", "trainers": R, "iters_per_trainer": THREADED_CACHE_ITERS,
          "hot_rows_per_ps": THREADED_HOT_ROWS, "shard_rows": list(rc.plan.shard_rows),
          "eps": out["eps"], "wall_s": out["wall_s"], "sync_rounds": out["sync_rounds"],
          "sync_count": out["sync_count"], "train_loss": out["train_loss"],
          "hit_rate": cs["hit_rows"] / max(cs["hit_rows"] + cs["miss_rows"], 1),
          "MB_migrated": (cs["bytes_h2d"] + cs["bytes_d2h"]) / 1e6, "cache_stats": cs,
          "launches": {k: counts[k] for k in ("embedding_bag", "sparse_adagrad")}})
    del rc, out, packed
    release(torch)

    one = {}
    for name, c in (("uncached", None), ("cached", cache)):
        r1 = ThreadedShadowRunner(cfg, SyncConfig(mode="fixed_rate", gap=4), n_trainers=1,
                                  batch_size=B, optimizer=optim.adagrad(0.02),
                                  n_emb_shards=N_SHARDS, supervise=False, cache=c, device="cuda")
        o = r1.run(ONE_TRAINER_ITERS)
        one[name] = (o["train_loss"], o["emb_state"], o["w"][0], o["cache_stats"])
        del r1, o
    (lu, eu, wu, _), (lc, ec, wc, cs1) = one["uncached"], one["cached"]
    assert lu == lc, (lu, lc)
    for k in ("table", "acc"):
        assert torch.equal(eu[k], ec[k]), k
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(wu), T.leaves(wc)))
    emit({"phase": "threaded_cache_path", "trainers": 1, "mode": "fixed_rate",
          "iters": ONE_TRAINER_ITERS, "bitwise_to_packed": True, "bitwise_replica": True,
          "cache_stats": cs1})
    del one, eu, ec, wu, wc
    release(torch)


def checkpoint_phase(torch, cfg, sim, st):
    """``checkpoint``: the full-width sim state saved and restored bitwise,
    two more iterations from each agreeing; then restored at R+1, the joined
    slot EASGD's PS plane with a fresh optimizer state. The temporary
    directory is removed at the end."""
    from repro_torch import optim
    from repro_torch import tree as T
    from repro_torch.core import sync as S
    from repro_torch.core.runners import HogwildSim
    from repro_torch.core.sync import SyncConfig

    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.save_state(d, st)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(root, f))
                     for root, _, files in os.walk(d) for f in files)
        t0 = time.perf_counter()
        st2 = sim.load_state(d)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        saved, loaded = T.leaves_with_path(sim._state_tree(st)), \
            T.leaves_with_path(sim._state_tree(st2))
        assert [k for k, _ in saved] == [k for k, _ in loaded]
        for (k, a), (_, b) in zip(saved, loaded):
            assert b.is_cuda and a.dtype == b.dtype and torch.equal(a, b), k
        assert st2.step == st.step
        w_saved = st.w_stack.clone()
        la = sim.run(CKPT_NEXT_ITERS, state=st)["train_loss"]
        lb = sim.run(CKPT_NEXT_ITERS, state=st2)["train_loss"]
        assert la == lb and all(math.isfinite(x) for x in la), (la, lb)
        del st2
        grown = HogwildSim(cfg, SyncConfig(), n_trainers=R + 1, n_threads=M, batch_size=B,
                           optimizer=optim.adagrad(0.02), seed=11, device="cuda")
        t0 = time.perf_counter()
        st5 = grown.load_state(d)
        torch.cuda.synchronize()
        elastic_s = time.perf_counter() - t0
        assert torch.equal(st5.w_stack[R], st5.algo_state), "the joined slot is not the PS plane"
        assert torch.equal(st5.w_stack[:R], w_saved)
        assert all(not bool(x.any()) for x in T.leaves(S.tree_slice(st5.opt_stack, R)))
        l5 = grown.run(1, state=st5)["train_loss"]
        assert all(math.isfinite(x) for x in l5), l5
        emit({"phase": "checkpoint", "leaves": len(saved), "GB": nbytes / 1e9, "save_s": save_s,
              "restore_s": load_s, "save_GB_per_s": nbytes / 1e9 / save_s,
              "restore_GB_per_s": nbytes / 1e9 / load_s, "bitwise_leaves": True,
              "next_iters_bitwise": True, "next_losses": la, "elastic_R": [R, R + 1],
              "elastic_restore_s": elastic_s, "joined_slot_is_ps_plane": True,
              "joined_opt_fresh": True})
        del st5, grown, w_saved
    finally:
        shutil.rmtree(d)
    assert not os.path.exists(d)


def mode_plan(sim, n_iters, switches):
    """(mode_events, sync_count, K3 launches) of an EASGD flat sim run of
    ``n_iters`` from step 0 under the scripted ``switches`` [(iteration,
    mode)], replayed on the host from the sim's own ``_shadow_schedule``:
    a switch to fixed_rate drops the in-flight launch and lands one catch-up
    sync of every replica, fixed_rate lands every ``gap`` iterations from
    that anchor, a switch back to shadow restarts the staggered clocks from
    the last global sync; each landing is one K3 launch (delay >= 1)."""
    sc, R = sim.sync_cfg, sim.R
    cur, events, syncs, k3 = sc.mode, [], 0, 0
    pending, last_global, anchor, base = None, 0, 0, 0
    for t in range(n_iters):
        mode = sc.mode
        for tt, m in sorted(switches):
            if tt <= t:
                mode = m
        if mode != cur:
            if mode == "fixed_rate":
                pending, syncs, k3 = None, syncs + R, k3 + 1
                last_global = anchor = t
            else:
                base = last_global
            events.append((t, cur, mode))
            cur = mode
        if cur == "fixed_rate":
            if (t + 1 - anchor) % sc.gap == 0:
                syncs, k3, last_global = syncs + R, k3 + 1, t + 1
            continue
        if pending is not None and t + 1 >= pending[0]:
            syncs, k3, pending = syncs + pending[1], k3 + 1, None
        mask = sim._shadow_schedule(t + 1 - base)
        if pending is None and mask.any():
            pending = (t + 1 + sc.delay, int(mask.sum()))
    return events, syncs, k3


class StagerClock:
    """Host seconds of the step pipeline's two sides in a run: the stager's
    jobs (peek, hazard check, staged lookup) and the owner's ``consume``
    (mostly waiting for the job of its step). Installed on
    ``StepPipeline`` for the ``with`` block only."""

    def __init__(self):
        from repro_torch.core.pipeline import StepPipeline

        self.cls, self.job_s, self.consume_s, self.jobs = StepPipeline, 0.0, 0.0, 0

    def _wrap(self, fn, field):
        def timed(pipe, *a):
            t0 = time.perf_counter()
            try:
                return fn(pipe, *a)
            finally:
                setattr(self, field, getattr(self, field) + time.perf_counter() - t0)
                self.jobs += field == "job_s"
        return timed

    def __enter__(self):
        self.saved = self.cls._run_job, self.cls.consume
        self.cls._run_job = self._wrap(self.saved[0], "job_s")
        self.cls.consume = self._wrap(self.saved[1], "consume_s")
        return self

    def __exit__(self, *exc):
        self.cls._run_job, self.cls.consume = self.saved

    def row(self, iters):
        return {"stager_job_ms": self.job_s / max(self.jobs, 1) * 1e3,
                "consume_ms_per_iter": self.consume_s / iters * 1e3}


class TablesFrom:
    """Within the block, every threaded runner's ``run`` splits ``tables``
    (the same seed's draw of the same configuration, made once) instead of
    drawing its own on the host: the values are those it would draw."""

    def __init__(self, tables):
        from repro_torch.embeddings import shards

        self.shards, self.tables = shards, tables

    def __enter__(self):
        self.drawn = self.shards.init_tables
        self.shards.init_tables = lambda spec, gen, device=None: self.tables
        return self

    def __exit__(self, *exc):
        self.shards.init_tables = self.drawn


def run_timed(torch, sim, iters, state, all_ops):
    """One sim run from ``state``, its counts set to 0 just before:
    (output, ms an iteration, {kernel: launches})."""
    stamps = []
    torch.cuda.synchronize()
    reset_counts(all_ops.values())
    out = sim.run(iters, state=state, on_iter=lambda t, loss: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    counts = {k: op.launches for k, op in all_ops.items()}
    return out, (stamps[-1] - stamps[0]) / (len(stamps) - 1) * 1e3, counts


def assert_bitwise(torch, a, b, what):
    assert a["train_loss"] == b["train_loss"], (what, a["train_loss"], b["train_loss"])
    for k in ("table", "acc"):
        assert torch.equal(a["state"].emb_state[k], b["state"].emb_state[k]), (what, k)
    assert torch.equal(a["state"].w_stack, b["state"].w_stack), what


def pipeline_phase(torch, cfg, all_ops, path_counts):
    """``pipeline_path``, the step pipeline: the full-width sim pipelined
    (depth 2) against serial from one state, bitwise; the wide configuration
    (four 4,000,000-row tables, multi-hot 1), where consecutive batches share
    no row and the stager really stages, at depths 2 and 3, uncached and
    cached, each bitwise its serial run with ``overlapped`` > 0; the threaded
    runner pipelined at cell 2's width, and one fixed_rate trainer on the wide
    configuration pipelined against serial. Every pipelined run must report
    no stager error. Returns the full-width tables of seed 0 as drawn, for
    the threaded runners of the next phase."""
    import dataclasses

    from repro_torch import optim
    from repro_torch import tree as T
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.core.runners import HogwildSim, SimState, ThreadedShadowRunner
    from repro_torch.core.sync import SyncConfig
    from repro_torch.embeddings.cache import CacheConfig

    def clone(st):
        return SimState(st.w_stack.clone(), T.map(torch.clone, st.opt_stack),
                        T.map(torch.clone, st.emb_state), st.algo_state.clone(), st.step)

    def sim_of(c, r, m, b, pipe=None, cache=None):
        return HogwildSim(c, SyncConfig(), n_trainers=r, n_threads=m, batch_size=b,
                          optimizer=optim.adagrad(0.02), seed=0, cache=cache, pipeline=pipe,
                          device="cuda")

    def pipe_ok(ps, what, shards=1):
        assert ps["worker_errors"] == 0, (what, ps)
        assert ps["shard_steps"] == shards * ps["steps"] > 0, (what, ps)

    # 1 · full width: every staged job collides on the small tables
    base_sim = sim_of(cfg, R, M, B)
    st0 = base_sim.init_state()
    # the threaded runners draw these tables from the same seed
    full_tables = T.map(torch.clone, st0.emb_state)
    serial, ms_s, c_s = run_timed(torch, base_sim, PIPE_FULL_ITERS, clone(st0), all_ops)
    with StagerClock() as clock:
        piped, ms_p, c_p = run_timed(torch, sim_of(cfg, R, M, B, PipelineConfig(2)),
                                     PIPE_FULL_ITERS, st0, all_ops)
    path_counts["pipeline_full"] = c_p
    assert_bitwise(torch, serial, piped, "full width")
    ps = piped["pipeline_stats"]
    pipe_ok(ps, "full width")
    for counts in (c_s, c_p):
        assert counts["embedding_bag"] == counts["sparse_adagrad"] == PIPE_FULL_ITERS, counts
    emit({"phase": "pipeline_path", "config": "full", "depth": 2, "iters": PIPE_FULL_ITERS,
          "bitwise": True, "pipeline_stats": ps, "ms_per_iter_serial": ms_s,
          "ms_per_iter_pipelined": ms_p, **clock.row(PIPE_FULL_ITERS),
          "launches": {k: c_p[k] for k in ("embedding_bag",
                                                                         "sparse_adagrad",
                                                                         "easgd_round")}})
    del base_sim, st0, serial, piped
    release(torch)

    # 2 · the wide configuration: staging happens
    wide = dataclasses.replace(cfg, table_sizes=(PIPE_WIDE_ROWS,) * 4, n_sparse_features=4,
                               multi_hot=1)
    t0 = time.perf_counter()
    base_sim = sim_of(wide, R, 1, PIPE_WIDE_B)
    st0 = base_sim.init_state()
    torch.cuda.synchronize()
    table_gb = sum(v.numel() * v.element_size() for v in st0.emb_state.values()) / 1e9
    emit({"phase": "pipeline_setup", "config": "wide", "rows": wide.n_embedding_rows,
          "table_and_acc_GB": table_gb, "ids_per_iter": R * PIPE_WIDE_B * 4,
          "seconds": time.perf_counter() - t0})
    for cached in (False, True):
        cache = (CacheConfig(hot_rows=PIPE_WIDE_HOT, lookahead=2) if cached else None)
        serial, ms_s, c_s = run_timed(torch, sim_of(wide, R, 1, PIPE_WIDE_B, cache=cache),
                                      PIPE_WIDE_ITERS, clone(st0), all_ops)
        for depth in (2, 3):
            name = f"pipeline_wide_{'cached' if cached else 'uncached'}_d{depth}"
            with StagerClock() as clock:
                piped, ms_p, c_p = run_timed(
                    torch, sim_of(wide, R, 1, PIPE_WIDE_B, PipelineConfig(depth), cache),
                    PIPE_WIDE_ITERS, clone(st0), all_ops)
            path_counts[name] = c_p
            assert_bitwise(torch, serial, piped, name)
            ps = piped["pipeline_stats"]
            pipe_ok(ps, name)
            assert ps["overlapped"] > 0, (name, ps)
            assert c_p["embedding_bag"] == c_p["sparse_adagrad"] == PIPE_WIDE_ITERS, c_p
            row = {"phase": "pipeline_path", "config": "wide", "cached": cached, "depth": depth,
                   "iters": PIPE_WIDE_ITERS, "bitwise": True, "pipeline_stats": ps,
                   "ms_per_iter_serial": ms_s, "ms_per_iter_pipelined": ms_p,
                   **clock.row(PIPE_WIDE_ITERS),
                   "launches": {k: c_p[k] for k in ("embedding_bag", "sparse_adagrad",
                                                    "easgd_round")}}
            if cached:
                cs = piped["cache_stats"]
                assert cs["staged_lookups"] == ps["overlapped"], (cs, ps)
                row.update(hot_rows=PIPE_WIDE_HOT, cache_stats=cs)
            emit(row)
            del piped
        del serial
        release(torch)
    wide_tables = st0.emb_state  # as drawn: the threaded wide runs take them
    del base_sim, st0
    release(torch)

    # 3 · threaded: cell 2's runner pipelined; one wide fixed_rate trainer
    runner = ThreadedShadowRunner(cfg, SyncConfig(), n_trainers=R, batch_size=B,
                                  optimizer=optim.adagrad(0.02), n_emb_shards=N_SHARDS,
                                  pipeline=PipelineConfig(2), device="cuda")
    runner.warmup()
    reset_counts(all_ops.values())
    with TablesFrom(full_tables):
        out = runner.run(PIPE_THREADED_ITERS)
    counts = path_counts["pipeline_threaded"] = {k: op.launches for k, op in all_ops.items()}
    ps = out["pipeline_stats"]
    pipe_ok(ps, "threaded", N_SHARDS)
    n_calls = R * N_SHARDS * PIPE_THREADED_ITERS
    assert all(math.isfinite(x) for x in out["train_loss"]), out["train_loss"]
    assert out["iter_count"] == [PIPE_THREADED_ITERS] * R, out["iter_count"]
    assert counts["embedding_bag"] == counts["sparse_adagrad"] == n_calls, counts
    assert ps["shard_steps"] == n_calls, ps
    emit({"phase": "pipeline_path", "config": "full", "runner": "threaded", "depth": 2,
          "trainers": R, "iters_per_trainer": PIPE_THREADED_ITERS, "eps": out["eps"],
          "wall_s": out["wall_s"], "train_loss": out["train_loss"], "pipeline_stats": ps,
          "launches": {k: counts[k] for k in ("embedding_bag", "sparse_adagrad", "easgd_pair")}})
    del runner, out
    release(torch)
    one = {}
    with TablesFrom(wide_tables):
        for pipe in (None, PipelineConfig(2)):
            r1 = ThreadedShadowRunner(wide, SyncConfig(mode="fixed_rate", gap=4), n_trainers=1,
                                      batch_size=B, optimizer=optim.adagrad(0.02),
                                      n_emb_shards=N_SHARDS, supervise=False, pipeline=pipe,
                                      device="cuda")
            reset_counts(all_ops.values())
            o = r1.run(PIPE_ONE_ITERS)
            one[pipe is not None] = (o, {k: op.launches for k, op in all_ops.items()})
            del r1
    del wide_tables
    (s1, _), (p1, c1) = one[False], one[True]
    path_counts["pipeline_threaded_wide"] = c1
    assert s1["train_loss"] == p1["train_loss"], (s1["train_loss"], p1["train_loss"])
    for k in ("table", "acc"):
        assert torch.equal(s1["emb_state"][k], p1["emb_state"][k]), k
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(s1["w"][0]), T.leaves(p1["w"][0])))
    ps = p1["pipeline_stats"]
    pipe_ok(ps, "threaded wide", N_SHARDS)
    assert ps["overlapped"] > 0, ps
    assert c1["embedding_bag"] == c1["sparse_adagrad"] == N_SHARDS * PIPE_ONE_ITERS, c1
    emit({"phase": "pipeline_path", "config": "wide", "runner": "threaded", "trainers": 1,
          "mode": "fixed_rate", "depth": 2, "iters": PIPE_ONE_ITERS, "bitwise": True,
          "pipeline_stats": ps})
    del one, s1, p1
    release(torch)
    return full_tables


def straggler_runner(cfg, mode, unit, **kw):
    """Four full-width EASGD trainers; slot 3 sleeps STRAGGLE_SLEEP ``unit``s
    (one iteration at the measured pace) an iteration for its first
    STRAGGLE_UNTIL iterations (the injected straggler)."""
    from repro_torch import optim
    from repro_torch.core.membership import FaultSpec
    from repro_torch.core.runners import ThreadedShadowRunner
    from repro_torch.core.sync import SyncConfig

    r = ThreadedShadowRunner(cfg, SyncConfig(mode=mode), n_trainers=R, batch_size=B,
                             optimizer=optim.adagrad(0.02), n_emb_shards=N_SHARDS,
                             eps_window_s=STRAGGLE_METER * unit,
                             fault_spec=FaultSpec(straggler_sleep_s={R - 1: STRAGGLE_SLEEP * unit},
                                                  straggler_until={R - 1: STRAGGLE_UNTIL}),
                             device="cuda", **kw)
    r.warmup()
    return r


def policy_mode_phase(torch, cfg, all_ops, path_counts, paces, full_tables):
    """``policy_path`` and ``mode_path``: the straggler policy demotes slot 3
    (an injected sleep of two iterations at this card's measured pace in
    the mode, ``paces[mode]`` examples/s a trainer, so
    its busy pace falls to a third of the others', under the 0.5 floor) and
    re-admits it after probation, in shadow and in fixed_rate (the monitor
    thread);
    the mode controller moves a fixed_rate run with that straggler to shadow;
    the full-width sim under a scripted shadow -> fixed_rate -> shadow
    schedule, its mode events, syncs and K3 launches equal to the host's
    replay. Returns each policy run's examples/s by mode."""
    from repro_torch import optim
    from repro_torch.core.modeswitch import ModeConfig, ModeController
    from repro_torch.core.runners import HogwildSim
    from repro_torch.core.scheduler import PolicyConfig, StragglerPolicy
    from repro_torch.core.sync import SyncConfig

    policy_eps = {}
    for mode in ("shadow", "fixed_rate"):
        unit = B / paces[mode]  # one iteration of one trainer in the mode, in s
        window = STRAGGLE_WINDOW * unit
        policy = StragglerPolicy(PolicyConfig(window_s=window, probation_s=window), n_slots=R)
        runner = straggler_runner(cfg, mode, unit, straggler_policy=policy)
        reset_counts(all_ops.values())
        with TablesFrom(full_tables):
            out = runner.run(STRAGGLE_ITERS)
        counts = path_counts[f"policy_{mode}"] = {k: op.launches for k, op in all_ops.items()}
        events = [(e.kind, e.slot, e.reason) for e in out["membership_events"]]
        kinds = [(k, s) for k, s, _ in events]
        assert kinds[:3] == [("leave", R - 1), ("join", R - 1), ("activate", R - 1)], events
        assert events[0][2].startswith("straggler") and events[1][2].startswith("probation")
        assert out["iter_count"] == [STRAGGLE_ITERS] * R, out["iter_count"]
        assert all(math.isfinite(x) for x in out["train_loss"]), out["train_loss"]
        assert counts["embedding_bag"] == R * N_SHARDS * STRAGGLE_ITERS, counts
        if mode == "fixed_rate":
            assert out["sync_rounds"] == 0 and counts["easgd_pair"] > 0, (out["sync_rounds"],
                                                                          counts)
        policy_eps[mode] = out["eps"]
        emit({"phase": "policy_path", "mode": mode, "iteration_s": unit,
              "sleep_s": STRAGGLE_SLEEP * unit, "window_s": window,
              "straggler_until": STRAGGLE_UNTIL, "iters_per_trainer": STRAGGLE_ITERS,
              "membership_events": events,
              "policy_transitions": [[round(t - out["t_start"], 3), s, a, b]
                                     for t, s, a, b in out["policy_transitions"]],
              "per_trainer_eps_busy": out["per_trainer_eps_busy"], "eps": out["eps"],
              "sync_count": out["sync_count"], "wall_s": out["wall_s"],
              "launches": {k: counts[k] for k in ("embedding_bag", "sparse_adagrad",
                                                  "easgd_pair")}})
        del runner, out
        release(torch)

    # the mode controller: a fixed_rate cohort with the straggler goes to
    # shadow (its clocks in shadow iterations: the pace it moves to)
    unit = B / paces["shadow"]
    window = STRAGGLE_WINDOW * unit
    ctl = ModeController(ModeConfig(skew_high=2.0, skew_low=1.3, window_s=window,
                                    min_dwell_s=1.5 * window, start_mode="fixed_rate"))
    runner = straggler_runner(cfg, "fixed_rate", unit, mode_controller=ctl)
    reset_counts(all_ops.values())
    with TablesFrom(full_tables):
        out = runner.run(MODE_ITERS)
    counts = path_counts["mode_threaded"] = {k: op.launches for k, op in all_ops.items()}
    trans = [(round(t - out["t_start"], 3), a, b) for t, a, b, _ in out["mode_transitions"]]
    assert trans and trans[0][1:] == ("fixed_rate", "shadow"), trans
    assert any(e.kind == "mode_switch" for e in out["membership_events"])
    assert out["iter_count"] == [MODE_ITERS] * R and counts["easgd_pair"] > 0, counts
    emit({"phase": "mode_path", "runner": "threaded", "sleep_s": STRAGGLE_SLEEP * unit,
          "iters_per_trainer": MODE_ITERS, "mode_transitions": trans, "final_mode": out["mode"],
          "sync_count": out["sync_count"], "sync_rounds": out["sync_rounds"], "eps": out["eps"],
          "per_trainer_eps_busy": out["per_trainer_eps_busy"],
          "launches": {k: counts[k] for k in ("embedding_bag", "sparse_adagrad", "easgd_pair")}})
    del runner, out
    release(torch)

    # the full-width sim under a scripted schedule, against the host replay
    sim = HogwildSim(cfg, SyncConfig(), n_trainers=R, n_threads=M, batch_size=B,
                     optimizer=optim.adagrad(0.02), mode_schedule=list(MODE_SCRIPT),
                     device="cuda")
    want_events, want_syncs, want_k3 = mode_plan(sim, MODE_SIM_ITERS, MODE_SCRIPT)
    st = sim.init_state()
    out, ms, counts = run_timed(torch, sim, MODE_SIM_ITERS, st, all_ops)
    path_counts["mode_sim"] = counts
    assert out["mode_events"] == want_events, (out["mode_events"], want_events)
    assert out["sync_count"] == want_syncs, (out["sync_count"], want_syncs)
    assert counts["easgd_round"] == want_k3, (counts["easgd_round"], want_k3)
    assert counts["embedding_bag"] == counts["sparse_adagrad"] == MODE_SIM_ITERS, counts
    assert all(math.isfinite(x) for x in out["train_loss"]), out["train_loss"]
    emit({"phase": "mode_path", "runner": "sim", "schedule": [list(x) for x in MODE_SCRIPT],
          "iters": MODE_SIM_ITERS, "mode_events": [list(x) for x in out["mode_events"]],
          "sync_count": out["sync_count"], "easgd_round_launches": counts["easgd_round"],
          "host_replay": {"sync_count": want_syncs, "easgd_round": want_k3},
          "ms_per_iter": ms, "loss_last": out["train_loss"][-1]})
    del sim, st, out
    release(torch)
    return policy_eps


def lockdep_phase(torch, cfg, all_ops, paces, full_tables, policy_eps):
    """``lockdep_path``: the threaded runner at full width, built and run
    under the port's lockdep with the blocking calls patched (sleep, join,
    the host's waits on the card, subprocess waits) and the kernel
    backend's locks instrumented. Run 1: fixed_rate EASGD, cached (a
    262,144-row hot tier a PS) and pipelined (depth 2), beside the same run
    uninstrumented (the barrier, the cache's gate and migrations, the
    stager streams). Run 2: shadow, slot 3 demoted and re-admitted by the
    policy on its trainer's stream (the re-admission hand-off), beside the
    ``policy_path`` shadow run, which is the same run uninstrumented. Each
    instrumented run: no finding (held-lock wait or order cycle), an acyclic
    graph, no stall of ``LOCKDEP_STALL_S`` left, and the launch locks among
    the graph's sites (the launches were seen)."""
    from repro_torch import optim
    from repro_torch.analysis import lockdep
    from repro_torch.core.pipeline import PipelineConfig
    from repro_torch.core.runners import ThreadedShadowRunner
    from repro_torch.core.scheduler import PolicyConfig, StragglerPolicy
    from repro_torch.core.sync import SyncConfig
    from repro_torch.embeddings.cache import CacheConfig

    card = card_line()
    t_phase = time.perf_counter()

    def cached_pipelined():
        r = ThreadedShadowRunner(
            cfg, SyncConfig(mode="fixed_rate", gap=4), n_trainers=R, batch_size=B,
            optimizer=optim.adagrad(0.02), n_emb_shards=N_SHARDS,
            cache=CacheConfig(hot_rows=THREADED_HOT_ROWS, lookahead=CACHE_LOOKAHEAD),
            pipeline=PipelineConfig(2), device="cuda")
        r.warmup()
        return r, LOCKDEP_ITERS

    def shadow_policy():  # policy_path's shadow run
        unit = B / paces["shadow"]
        window = STRAGGLE_WINDOW * unit
        policy = StragglerPolicy(PolicyConfig(window_s=window, probation_s=window), n_slots=R)
        return straggler_runner(cfg, "shadow", unit, straggler_policy=policy), STRAGGLE_ITERS

    def drive(make):
        """Build and run; the launch counts set to 0 just before the run."""
        runner, iters = make()
        reset_counts(all_ops.values())
        with TablesFrom(full_tables):
            out = runner.run(iters)
        counts = {k: op.launches for k, op in all_ops.items()}
        n_calls = R * N_SHARDS * iters
        assert out["iter_count"] == [iters] * R, out["iter_count"]
        assert all(math.isfinite(x) for x in out["train_loss"]), out["train_loss"]
        assert counts["embedding_bag"] == n_calls and counts["sparse_adagrad"] > 0, counts
        del runner
        return out, counts

    def instrumented(make):
        with lockdep.instrument() as g:
            out, counts = drive(make)
        g.assert_clean()
        g.assert_acyclic()
        stalls = g.stalled(LOCKDEP_STALL_S)
        assert stalls == [], stalls
        assert set(LAUNCH_LOCK_SITES) <= g.sites, sorted(g.sites)
        waits = sum("called while holding" in v for v in g.violations)
        return out, counts, g, waits

    def row(run, iters, g, waits, out, counts, eps_plain, **extra):
        return {"phase": "lockdep_path", "run": run, "card": card, "trainers": R,
                "iters_per_trainer": iters, "sites": len(g.sites), "edges": len(g.edges),
                "held_lock_waits": waits, "stalls": 0, "eps": out["eps"],
                "eps_uninstrumented": eps_plain, "wall_s": out["wall_s"],
                "lock_sites": sorted(g.sites), "lock_edges": sorted(g.edges),
                "launches": {k: counts[k] for k in ("embedding_bag", "sparse_adagrad",
                                                    "easgd_pair")}, **extra}

    plain, _ = drive(cached_pipelined)
    release(torch)
    out, counts, g, waits = instrumented(cached_pipelined)
    assert out["sync_count"] == R * (LOCKDEP_ITERS // 4) and out["sync_rounds"] == 0, out
    assert out["pipeline_stats"]["worker_errors"] == 0, out["pipeline_stats"]
    assert out["cache_stats"]["lookups"] == R * N_SHARDS * LOCKDEP_ITERS, out["cache_stats"]
    emit(row("fixed_rate cached pipelined", LOCKDEP_ITERS, g, waits, out, counts, plain["eps"],
             cache_stats=out["cache_stats"], pipeline_stats=out["pipeline_stats"]))
    del plain, out, g
    release(torch)

    out, counts, g, waits = instrumented(shadow_policy)
    events = [(e.kind, e.slot, e.reason) for e in out["membership_events"]]
    assert [(k, s) for k, s, _ in events[:3]] == [("leave", R - 1), ("join", R - 1),
                                                  ("activate", R - 1)], events
    emit(row("shadow policy", STRAGGLE_ITERS, g, waits, out, counts, policy_eps["shadow"],
             membership_events=events))
    del out, g
    release(torch)
    emit({"phase": "lockdep_path", "card": card, "seconds": time.perf_counter() - t_phase})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import optim
    from repro_torch import tree as T
    from repro_torch.configs import dlrm_ctr
    from repro_torch.core.membership import FaultSpec
    from repro_torch.core.runners import HogwildSim, SimState, ThreadedShadowRunner
    from repro_torch.core.sync import SyncConfig
    from repro_torch.kernels import backend
    from repro_torch.kernels.bmuf_update.ops import bmuf_sync_op, bmuf_sync_rows_op
    from repro_torch.kernels.easgd_update.ops import easgd_pair_flat_op, easgd_round_op
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
    from repro_torch.kernels.flash_attention.ops import gqa_attention_op
    from repro_torch.kernels.gossip_update.ops import gossip_pair_flat_op, gossip_round_op
    from repro_torch.kernels.interaction.ops import interaction_op
    from repro_torch.kernels.ma_update import ops as ma_ops
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
    assert set(KERNELS) == set(backend.sources()), (KERNELS, backend.sources())
    built = backend.build(KERNELS)
    for name in KERNELS:
        with open(backend.library_path(name) + ".log") as f:
            ptxas = [ln.strip() for ln in f
                     if "registers" in ln or "spill" in ln or "entry function" in ln]
        emit({"phase": "build", "kernel": name, "ptxas": ptxas})
        for fn in {g for v in DEVICE_NAMES_BY_SOURCE[name].values() for g in globals_of(v)}:
            assert any(fn in ln for ln in ptxas), f"no {fn} built"
    emit({"phase": "build", "built": built, "seconds": time.perf_counter() - t0})
    k9_build_report(backend)
    lm_ops = {"interaction": interaction_op, "flash_attention": gqa_attention_op}
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
    sync_rows = check_sync_kernels(torch, st, mem_rate)
    k8_row = check_interaction(torch, mem_rate)
    torch.cuda.empty_cache()

    # 4 · the main path
    ops = {"embedding_bag": embedding_bag_op, "sparse_adagrad": sparse_adagrad_op,
           "easgd_round": easgd_round_op, "easgd_pair": easgd_pair_flat_op}
    sync_ops = {"replica_mean": ma_ops.replica_mean_op,
                "replica_mean_rows": ma_ops.replica_mean_rows_op,
                "ma_update": ma_ops.ma_sync_op, "ma_update_rows": ma_ops.ma_sync_rows_op,
                "bmuf_update": bmuf_sync_op, "bmuf_update_rows": bmuf_sync_rows_op,
                "gossip_pair": gossip_pair_flat_op, "gossip_round": gossip_round_op}
    all_ops = {**ops, **sync_ops, **lm_ops}
    path_counts = {}  # {path: {kernel: launches in that path's run}}

    def read_counts(path):
        counts = path_counts[path] = {k: op.launches for k, op in all_ops.items()}
        return counts

    def check_sync_counts(path, counts, want):
        """Each sync wrapper launched exactly as ``want`` says (0 if absent)."""
        for k in sync_ops:
            assert counts[k] == want.get(k, 0), (path, k, counts[k], want.get(k, 0), counts)
    warm = sim.run(WARM_ITERS, state=st)
    torch.cuda.synchronize()
    reset_counts(all_ops.values())
    t0 = time.perf_counter()
    out = sim.run(TIMED_ITERS, state=warm["state"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts("sim_easgd")
    ev = sim.evaluate(out["state"], n_batches=4, batch_size=4096)
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
    assert launches["easgd_pair"] == 0, launches  # HogwildSim lands with the round kernel
    check_sync_counts("sim_easgd", launches, {})
    for k in ops:
        rows[k]["launches"] = launches[k]
    # the hot shape stresses the sim path's kernel: its launches are the sim's
    rows["sparse_adagrad_hot_shape"]["launches"] = launches["sparse_adagrad"]
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
    base = out_fr["state"]
    del sim, fr, st, warm, out, state
    torch.cuda.empty_cache()

    # the same path under MA, BMUF and Gossip, each from a copy of the
    # trained replicas and tables on a stream of its own (seed), so no run
    # sees another's batches; every sync launch is predicted from the run's
    # shadow schedule
    for k, algo in enumerate(ALGOS):
        sa = HogwildSim(cfg, SyncConfig(algo=algo), n_trainers=R, n_threads=M, batch_size=B,
                        optimizer=optim.adagrad(0.02), seed=1 + k, device="cuda")
        st_a = SimState(base.w_stack.clone(), T.map(torch.clone, base.opt_stack),
                        T.map(torch.clone, base.emb_state),
                        sa.algo.init_state_flat(base.w_stack[0].clone(), sa.sync_cfg, sa.flat), 0)
        warm_a = sa.run(WARM_ITERS, state=st_a)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n_launch, n_land, _ = shadow_plan(sa, warm_a["state"], ALGO_ITERS, R)
        reset_counts(all_ops.values())
        t0 = time.perf_counter()
        out_a = sa.run(ALGO_ITERS, state=warm_a["state"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(f"sim_{algo}")
        check_sync_counts(f"sim_{algo}", counts, expected_sync_counts(algo, n_launch, n_land, None))
        assert n_land > 0 and out_a["sync_count"] > 0, out_a["sync_count"]
        assert counts["embedding_bag"] == counts["sparse_adagrad"] == ALGO_ITERS, counts
        assert counts["easgd_round"] == counts["easgd_pair"] == 0, counts
        losses = warm_a["train_loss"] + out_a["train_loss"]
        assert all(math.isfinite(x) for x in losses), losses
        emit({"phase": "main_path", "algo": algo, "mode": "shadow", "iters": ALGO_ITERS,
              "ms_per_iter": wall / ALGO_ITERS * 1e3, "examples_per_s": out_a["examples"] / wall,
              "loss_first": losses[0], "loss_last": losses[-1],
              "sync_count": out_a["sync_count"], "avg_sync_gap": out_a["avg_sync_gap"],
              "sync_launches": n_launch, "sync_landings": n_land, "launches": counts,
              "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
        del sa, st_a, warm_a, out_a
        release(torch)

    # elastic membership at full width: slot 1 fails at 3 and rejoins at 6, a
    # spare slot 4 joins at 8 (capacity 5); only the *_rows kernels sync
    for k, algo in enumerate(ALGOS):
        se = HogwildSim(cfg, SyncConfig(algo=algo), n_trainers=R, n_threads=M, batch_size=B,
                        optimizer=optim.adagrad(0.02), seed=1 + len(ALGOS) + k,
                        schedule=list(ELASTIC_SCHED), device="cuda")
        cap = se.R
        pick = torch.tensor([i % R for i in range(cap)], device="cuda")
        st_e = SimState(base.w_stack.index_select(0, pick),
                        T.map(lambda x: x.index_select(0, pick), base.opt_stack),
                        T.map(torch.clone, base.emb_state),
                        se.algo.init_state_flat(base.w_stack[0].clone(), se.sync_cfg, se.flat), 0)
        spare0 = st_e.w_stack[cap - 1].clone()
        seen = {}

        def watch(t, _loss):
            if t in (3, 5):  # slot 1 is dead from the start of 3 to its join at 6
                seen[t] = st_e.w_stack[1].clone()
            if t == 7:  # the spare slot has never been live
                seen["spare"] = st_e.w_stack[cap - 1].clone()

        n_launch, n_land, n_join = shadow_plan(se, st_e, ELASTIC_ITERS, R, ELASTIC_SCHED)
        torch.cuda.synchronize()
        reset_counts(all_ops.values())
        t0 = time.perf_counter()
        out_e = se.run(ELASTIC_ITERS, state=st_e, on_iter=watch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(f"elastic_{algo}")
        # a Gossip landing whose fired replica was left unpaired by the live
        # ring (three live slots) has no participant and launches nothing
        check_sync_counts(f"elastic_{algo}", counts,
                          expected_sync_counts(algo, n_launch, n_land, n_join))
        assert counts["replica_mean_rows"] > 0, counts
        assert torch.equal(seen[3], seen[5]), "the dead slot moved while dead"
        assert torch.equal(seen["spare"], spare0), "the spare slot moved before it joined"
        events = [(e.kind, e.slot) for e in out_e["membership_events"]]
        assert events == [("fail", 1), ("join", 1), ("activate", 1), ("join", 4),
                          ("activate", 4)], events
        assert all(math.isfinite(x) for x in out_e["train_loss"]), out_e["train_loss"]
        assert out_e["replica_losses"].shape == (ELASTIC_ITERS, cap) and out_e["sync_count"] > 0
        emit({"phase": "elastic_path", "algo": algo, "iters": ELASTIC_ITERS, "capacity": cap,
              "ms_per_iter": wall / ELASTIC_ITERS * 1e3, "examples": out_e["examples"],
              "loss_first": out_e["train_loss"][0], "loss_last": out_e["train_loss"][-1],
              "sync_count": out_e["sync_count"], "avg_sync_gap": out_e["avg_sync_gap"],
              "sync_launches": n_launch, "sync_landings": n_land, "joins": n_join,
              "membership_events": events, "dead_slot_frozen": True, "launches": counts})
        del se, st_e, out_e, seen
        release(torch)
    del base, out_fr
    release(torch)

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

    # 5 · the threaded path at full width: R=4 trainer threads x B=128, 4 PSs
    runner = ThreadedShadowRunner(cfg, SyncConfig(), n_trainers=R, batch_size=B,
                                  optimizer=optim.adagrad(0.02), n_emb_shards=N_SHARDS,
                                  device="cuda")
    assert runner.supervise and runner.plan.n_shards == N_SHARDS
    t0 = time.perf_counter()
    runner.warmup()
    emit({"phase": "threaded_setup", "warmup_s": time.perf_counter() - t0,
          "shard_rows": list(runner.plan.shard_rows)})
    torch.cuda.reset_peak_memory_stats()
    reset_counts(all_ops.values())
    out = runner.run(THREADED_ITERS)
    launches = read_counts("threaded_easgd")
    per_kernel_call = R * N_SHARDS * THREADED_ITERS
    assert all(math.isfinite(x) for x in out["train_loss"]), out["train_loss"]
    assert out["iter_count"] == [THREADED_ITERS] * R, out["iter_count"]
    assert out["sync_count"] > 0 and out["sync_rounds"] >= 10, out["sync_rounds"]
    bad = [e for e in out["supervision_events"] if e.kind in ("restart", "degraded")]
    assert not bad and not out["sync_degraded"], bad
    assert launches["embedding_bag"] == launches["sparse_adagrad"] == per_kernel_call, launches
    assert launches["easgd_pair"] > 0 and launches["easgd_round"] == 0, launches
    check_sync_counts("threaded_easgd", launches, {"gossip_pair": 0})
    emit({"phase": "threaded_main_path", "mode": "shadow", "iters_per_trainer": THREADED_ITERS,
          "eps": out["eps"], "eps_window": out["eps_window"], "wall_s": out["wall_s"],
          "per_trainer_eps": out["per_trainer_eps"], "sync_rounds": out["sync_rounds"],
          "rounds_per_s": out["sync_rounds"] / out["wall_s"], "sync_count": out["sync_count"],
          "avg_sync_gap": out["avg_sync_gap"], "train_loss": out["train_loss"],
          "launches": launches, "supervision_events": len(out["supervision_events"]),
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    rows["easgd_pair"]["launches"] = launches["easgd_pair"]
    # this card's busy pace of one trainer in each mode: the straggler
    # phase's sleep is set from it
    paces = {"shadow": sum(out["per_trainer_eps_busy"]) / R}
    for k in ("embedding_bag", "sparse_adagrad"):
        rows[k]["launches_threaded"] = launches[k]
    rows["sparse_adagrad_threaded_shape"]["launches"] = launches["sparse_adagrad"]
    snap_ms = snapshot_ms(torch, runner.emb)
    snap_bytes = 2 * sum(t.numel() * 4 for st in runner.emb.states for t in st.values())
    emit({"phase": "threaded_snapshot", "snapshot_all_ms": snap_ms, "bytes": snap_bytes,
          "bound_ms": snap_bytes / mem_rate * 1e3})
    prof = threaded_profile(torch, runner, PROFILED_ITERS)
    emit({"phase": "threaded_profile", **prof})
    del runner, out
    release(torch)

    # threaded fixed_rate: every round is run by the barrier's elected leader
    fr = ThreadedShadowRunner(cfg, SyncConfig(mode="fixed_rate", gap=5), n_trainers=R,
                              batch_size=B, optimizer=optim.adagrad(0.02),
                              n_emb_shards=N_SHARDS, device="cuda")
    fr.warmup()
    reset_counts(ops.values())
    out_fr = fr.run(10)
    paces["fixed_rate"] = sum(out_fr["per_trainer_eps_busy"]) / R
    assert all(math.isfinite(x) for x in out_fr["train_loss"]), out_fr["train_loss"]
    assert out_fr["sync_count"] == R * (10 // 5), out_fr["sync_count"]
    assert easgd_pair_flat_op.launches == R * (10 // 5), easgd_pair_flat_op.launches
    emit({"phase": "threaded_main_path", "mode": "fixed_rate", "iters_per_trainer": 10,
          "sync_count": out_fr["sync_count"], "eps": out_fr["eps"],
          "per_trainer_eps_busy": out_fr["per_trainer_eps_busy"],
          "train_loss": out_fr["train_loss"], "easgd_pair_launches": easgd_pair_flat_op.launches})
    del fr, out_fr
    release(torch)

    # the same tiny one-trainer threaded run (deterministic) on the card and the CPU
    tiny = {}
    for dev in ("cuda", "cpu"):
        r1 = ThreadedShadowRunner(dlrm_ctr.tiny(), SyncConfig(mode="fixed_rate", gap=4),
                                  n_trainers=1, batch_size=32, optimizer=optim.adagrad(0.02),
                                  supervise=False, device=dev)
        o = r1.run(12)
        tiny[dev] = (o["w"][0], o["emb_state"], o["sync_count"])
    assert tiny["cuda"][2] == tiny["cpu"][2] == 12 // 4
    diff = 0.0
    pairs = list(zip(T.leaves(tiny["cuda"][0]), T.leaves(tiny["cpu"][0])))
    pairs += [(tiny["cuda"][1][k], tiny["cpu"][1][k]) for k in ("table", "acc")]
    for a, b in pairs:
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)  # trajectory tol
        diff = max(diff, (a.cpu() - b).abs().max().item())
    emit({"phase": "threaded_reference", "max_abs_diff_cuda_vs_cpu": diff})

    # the threaded path under MA, BMUF and Gossip: a round is one mean and R
    # out-of-place pull-backs (MA, BMUF), or R/2 pair exchanges (Gossip)
    per_round = {"ma": {"replica_mean": 1, "ma_update": R},
                 "bmuf": {"replica_mean": 1, "ma_update": R},
                 "gossip": {"gossip_pair": R // 2}}
    for algo in ALGOS:
        ra = ThreadedShadowRunner(cfg, SyncConfig(algo=algo), n_trainers=R, batch_size=B,
                                  optimizer=optim.adagrad(0.02), n_emb_shards=N_SHARDS,
                                  device="cuda")
        ra.warmup()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(all_ops.values())
        out = ra.run(ALGO_THREADED_ITERS)
        counts = read_counts(f"threaded_{algo}")
        assert all(math.isfinite(x) for x in out["train_loss"]), out["train_loss"]
        assert out["iter_count"] == [ALGO_THREADED_ITERS] * R, out["iter_count"]
        bad = [e for e in out["supervision_events"] if e.kind in ("restart", "degraded")]
        assert not bad and not out["sync_degraded"] and out["sync_restarts"] == 0, bad
        assert out["sync_count"] > 0, out["sync_count"]
        n_calls = R * N_SHARDS * ALGO_THREADED_ITERS
        assert counts["embedding_bag"] == counts["sparse_adagrad"] == n_calls, counts
        # MA, BMUF and Gossip count one sync per round that landed
        check_sync_counts(f"threaded_{algo}", counts,
                          {k: v * out["sync_count"] for k, v in per_round[algo].items()})
        emit({"phase": "threaded_main_path", "algo": algo, "mode": "shadow",
              "iters_per_trainer": ALGO_THREADED_ITERS, "eps": out["eps"],
              "eps_window": out["eps_window"], "wall_s": out["wall_s"],
              "per_trainer_eps": out["per_trainer_eps"], "sync_rounds": out["sync_rounds"],
              "rounds_per_s": out["sync_rounds"] / out["wall_s"],
              "sync_count": out["sync_count"], "avg_sync_gap": out["avg_sync_gap"],
              "train_loss": out["train_loss"], "launches": counts,
              "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
        del ra, out
        release(torch)

    # MA with a trainer that joins: its bootstrap is the live mean (K5 rows)
    alloc_before = torch.cuda.memory_allocated()
    rj = ThreadedShadowRunner(cfg, SyncConfig(algo="ma"), n_trainers=R, batch_size=B,
                              optimizer=optim.adagrad(0.02), n_emb_shards=N_SHARDS,
                              fault_spec=FaultSpec(join_at={R - 1: 5}), device="cuda")
    rj.warmup()
    reset_counts(all_ops.values())
    out = rj.run(10)
    counts = read_counts("threaded_ma_join")
    events = [(e.kind, e.slot) for e in out["membership_events"]]
    assert ("join", R - 1) in events and ("activate", R - 1) in events, events
    assert counts["replica_mean_rows"] == 1, counts
    assert out["iter_count"][R - 1] == 10 - 5 and all(math.isfinite(x) for x in out["train_loss"])
    emit({"phase": "threaded_join", "algo": "ma", "membership_events": events,
          "iter_count": out["iter_count"], "sync_count": out["sync_count"], "launches": counts})
    alloc_run = torch.cuda.memory_allocated()
    del rj, out
    torch.cuda.synchronize()
    # a finished runner holds no reference cycle: dropping it frees its
    # tables, accumulators and snapshots without the cyclic collector
    emit({"phase": "threaded_release", "allocated_GB_before_runner": alloc_before / 1e9,
          "allocated_GB_after_run": alloc_run / 1e9,
          "allocated_GB_after_del_without_gc": torch.cuda.memory_allocated() / 1e9})
    release(torch)

    # 6 · the tiny elastic runs (the reference's schedule), card against CPU
    for algo in ALGOS:
        tiny = {}
        for dev in ("cuda", "cpu"):
            s_ = HogwildSim(dlrm_ctr.tiny(), SyncConfig(algo=algo, gap=4, delay=1), n_trainers=3,
                            n_threads=2, batch_size=32, optimizer=optim.adagrad(0.02),
                            schedule=list(TINY_SCHED), device=dev)
            o = s_.run(16)
            tiny[dev] = (o["train_loss"], o["sync_count"], o["state"].w_stack.cpu())
        assert tiny["cuda"][1] == tiny["cpu"][1] > 0, (algo, tiny["cuda"][1], tiny["cpu"][1])
        for a, b in zip(tiny["cuda"][0], tiny["cpu"][0]):
            assert abs(a - b) <= 1e-5 + 1e-4 * abs(b), ("tiny elastic cuda vs cpu", algo, a, b)
        torch.testing.assert_close(tiny["cuda"][2], tiny["cpu"][2], rtol=1e-4, atol=1e-5)
        emit({"phase": "elastic_reference", "algo": algo,
              "max_loss_diff_cuda_vs_cpu": max(abs(a - b) for a, b in zip(tiny["cuda"][0],
                                                                         tiny["cpu"][0])),
              "max_plane_diff_cuda_vs_cpu": (tiny["cuda"][2] - tiny["cpu"][2]).abs().max().item(),
              "sync_count": tiny["cuda"][1]})

    # 6b · the tiered cache and checkpoints at full width
    torch.cuda.reset_peak_memory_stats()
    sim_u, st_u, cached_launches = cache_phase(torch, cfg, all_ops, path_counts)
    release(torch)
    for k in ("embedding_bag", "sparse_adagrad"):
        rows[k]["launches_cache_path"] = cached_launches[k]
    threaded_cache_phase(torch, cfg, all_ops, path_counts)
    checkpoint_phase(torch, cfg, sim_u, st_u)
    emit({"phase": "cache_checkpoint_memory",
          "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9})
    del sim_u, st_u
    release(torch)

    # 6c · step pipelining, the straggler policy and mode switching
    full_tables = pipeline_phase(torch, cfg, all_ops, path_counts)
    policy_eps = policy_mode_phase(torch, cfg, all_ops, path_counts, paces, full_tables)
    lockdep_phase(torch, cfg, all_ops, paces, full_tables, policy_eps)
    del full_tables
    for k in ops:  # K1-K4's launches on this slice's paths
        rows[k]["launches_pipeline_path"] = {p: c[k] for p, c in path_counts.items()
                                             if p.startswith(("pipeline", "policy", "mode"))}

    # 7 · the serving path, with the DLRM state released first
    alloc, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    release(torch)
    emit({"phase": "release", "allocated_GB_before": alloc / 1e9, "peak_GB_before": peak / 1e9,
          "allocated_GB_after": torch.cuda.memory_allocated() / 1e9,
          "reserved_GB_after": torch.cuda.memory_reserved() / 1e9})
    k9_row, k9_f32_row = serving_phase(torch, mem_rate, all_ops, path_counts)
    k9_row["launches"] = path_counts["serve_phi3"]["flash_attention"]

    # 8 · K9's training form at the trainers' shapes, then the LM trainer
    release(torch)
    train_rows = check_attention_train(torch, mem_rate)
    lm_train_phase(torch, all_ops, path_counts)

    # 9 · the ssm, MoE and hybrid families
    k9_row["moe_path_ms"] = lm_families_phase(torch, mem_rate, all_ops, path_counts)
    k9_row["launches_serve_moe"] = path_counts["serve_moe"]["flash_attention"]
    k9_row["launches_serve_swa"] = path_counts["serve_swa"]["flash_attention"]
    # 10 · the vlm and audio families
    k9_row.update(vlm_audio_phase(torch, mem_rate, all_ops, path_counts))
    k9_row["launches_serve_whisper"] = path_counts["serve_whisper"]["flash_attention"]
    k9_row["launches_serve_llava"] = path_counts["serve_llava"]["flash_attention"]
    k9_row["launches_serve_parallel"] = path_counts["serve_parallel"]["flash_attention"]
    # 11 · the dry run's roofline against the measured cells
    roofline_phase(torch)
    # 12 · the mesh program: one card as a (1, 1, 1) mesh, cell 9 on fake meshes
    mesh_phase(torch, all_ops, path_counts)
    # the reduced configs of the mesh path and the families' references are
    # f32: their K9 launches are the f32 kernel's, and the bf16 row has none
    k9_f32_row["launches"] = path_counts["mesh_path"]["flash_attention"]
    k9_f32_row["launches_families_reference"] = {
        p[len("families_reference_"):]: c["flash_attention"] for p, c in path_counts.items()
        if p.startswith("families_reference_")}
    k8_row["launches"] = sum(c["interaction"] for c in path_counts.values())  # no path runs K8

    # 13 · the kernel table, the card, the result
    main_path_of = {"replica_mean": "sim_ma", "ma_update": "sim_ma",
                    "replica_mean_rows": "elastic_ma", "ma_update_rows": "elastic_ma",
                    "bmuf_update": "sim_bmuf", "bmuf_update_rows": "elastic_bmuf",
                    "gossip_round": "sim_gossip", "gossip_pair": "threaded_gossip"}
    for k, row in sync_rows.items():
        row["launches"] = path_counts[main_path_of[k]][k]
        row["launches_by_path"] = {p: c[k] for p, c in path_counts.items() if c[k]}
        assert row["launches"] > 0, (k, row["launches_by_path"])
    rows.update(sync_rows)
    rows["interaction"], rows["flash_attention"] = k8_row, k9_row
    rows["flash_attention_f32"] = k9_f32_row
    for k, row in rows.items():  # the LM trainers' full-width windows: none
        op = k if k in all_ops else "flash_attention" if k.startswith("flash_attention") \
            else k.rsplit("_", 2)[0]
        row["launches_lm_train"] = path_counts["lm_train"][op]
        row["launches_lm_train_save_comm"] = path_counts["lm_train_save_comm"][op]
        row["launches_lm_train_parallel"] = path_counts["lm_train_parallel"][op]
        row["launches_lm_train_mamba2"] = path_counts["lm_train_mamba2"][op]
        row["launches_lm_train_whisper"] = path_counts["lm_train_whisper"][op]
        row["launches_serve_mamba2"] = path_counts["serve_mamba2"][op]
    # the training form's launches: cell 9's and cell 13's warm-up and timed
    # iterations (the profiled one not counted)
    for k, side in (("flash_attention_train_fwd", "forward"),
                    ("flash_attention_train_bwd", "backward")):
        train_rows[k]["launches_lm_train"] = ROWS["lm_train"]["attention_train_launches"][side]
        train_rows[k]["launches_lm_train_whisper"] = \
            ROWS["lm_train_whisper"]["attention_train_launches"][side]
    rows.update(train_rows)
    emit({"kernels": [{k: v for k, v in row.items() if k != "tol"} for row in rows.values()]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
