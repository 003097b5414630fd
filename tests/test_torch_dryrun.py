"""The port's one-card dry run (``launch/dryrun.py``): what ``_trace_cost``
counts, the depth fit, ``run_one`` and ``main``, against analytic counts,
real tensors and the JAX package's skip list.

The trace runs the port's step on ``meta`` twins of ``launch/specs.py``'s
fake structures: shapes only, so full-width kimi-k2 (1.04 T parameters)
traces without a byte of weights. Its FLOPs are the products'
(``FlopCounterMode``), its bytes each op's inputs and outputs, and K9's
work where the card launches it (a prefill's self-attention, and the
training form's bf16 self-attention at head dim 64 or 128).
"""
import dataclasses
import functools
import os
import resource

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
pytest.importorskip("jax")
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

# importing the JAX package's dry run sets XLA_FLAGS (512 forced host
# devices) for the whole process; put it back, so that the JAX tests that
# run after this file is collected see the environment they always do
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402

if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS
from repro.roofline import analysis as jRA  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, InputShape,  # noqa: E402
                                      get_config, reduced)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import transformer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _no_world_left():
    """The mesh rows start a fake process group; none outlives this file."""
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _fake(*shapes, dtype=torch.float32):
    with FakeTensorMode():
        return tuple(torch.empty(s, dtype=dtype) for s in shapes)


def _cost(step, *args):
    return D._trace_cost(D.Program(step, args, ()))


# ---------------------------------------------------------------------------
# what one op counts
# ---------------------------------------------------------------------------

def test_elementwise_op_counts_its_input_and_output():
    (x,) = _fake((1000,))
    c = _cost(lambda x: x * 2, x)
    assert c.bytes_accessed == 4000 + 4000 and c.flops == 0
    (y,) = _fake((1000,), dtype=torch.bfloat16)
    assert _cost(lambda x, y: x + y, x, y).bytes_accessed == 4000 + 2000 + 4000


@pytest.mark.parametrize("view", [lambda x: x.view(100, 10), lambda x: x.t(),
                                  lambda x: x.reshape(10, 100), lambda x: x.detach(),
                                  lambda x: x[3], lambda x: x.expand(4, 10, 100)],
                         ids=["view", "t", "reshape", "detach", "select", "expand"])
def test_a_view_counts_nothing(view):
    (x,) = _fake((10, 100))
    c = _cost(view, x)
    assert c.bytes_accessed == 0 and c.peak_bytes == 0 and c.out_bytes == 0


def test_in_place_and_broadcast_operands_count_once():
    x, y, z = _fake((1000,), (1000,), (1000, 1))
    assert _cost(lambda x: x.add_(1.0), x).bytes_accessed == 4000
    assert _cost(lambda x, y: x.add_(y), x, y).bytes_accessed == 8000
    # a (1000, 1) + (1000,) broadcast: each input's own elements, then the
    # (1000, 1000) output
    assert _cost(lambda z, y: z + y, z, y).bytes_accessed == 4000 + 4000 + 4_000_000
    # an expanded (stride 0) input counts its distinct elements
    assert _cost(lambda y: y.expand(5, 1000).clone(), y).bytes_accessed == 4000 + 20_000


def test_peak_counts_the_live_allocations():
    """a and b live at once, then b and the output: a peak of two
    buffers, the output one; the argument is neither."""
    (x,) = _fake((1000,))

    def step(x):
        a = x * 2
        b = a * 3
        del a
        return b * 4

    c = _cost(step, x)
    assert (c.peak_bytes, c.out_bytes, c.arg_bytes) == (8000, 4000, 4000)


def test_products_count_their_flops():
    a, b = _fake((64, 32), (32, 16))
    assert _cost(lambda a, b: a @ b, a, b).flops == 2 * 64 * 32 * 16
    q, k = _fake((3, 8, 64, 16), (3, 8, 64, 16))
    assert _cost(lambda q, k: torch.einsum("bhqd,bhkd->bhqk", q, k), q, k).flops == \
        2 * 3 * 8 * 64 * 64 * 16


@pytest.mark.parametrize("train", [False, True], ids=["prefill_form", "training_form"])
@pytest.mark.parametrize("arch", ["granite-20b", "phi3-medium-14b", "minicpm-2b"])
def test_dense_forward_flops_are_the_analytic_count(arch, train):
    """2 x the matmul parameters x tokens, plus the attention's products a
    layer: 4·B·H·S²·hd in the training form (the plain attention, S x S
    in full), 4·B·H·hd·S(S+1)/2 in the prefill form, counted as K9 runs it
    on the card (its causal pairs; one kernel call a layer)."""
    cfg = reduced(get_config(arch))
    B, S = 2, 96
    params, _ = specs.param_structs(cfg, D.ONE_CARD)
    (tokens,) = _fake((B, S), dtype=torch.int32)
    c = _cost(lambda p, t: transformer.forward(p, cfg, t, train=train), params, tokens)
    hd, H, kv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    per_layer = cfg.d_model * (H + 2 * kv) * hd + H * hd * cfg.d_model + 3 * cfg.d_model * cfg.d_ff
    head = cfg.d_model * transformer.padded_vocab(cfg)
    pairs = S * S if train else S * (S + 1) // 2
    want = 2 * B * S * (cfg.n_layers * per_layer + head) + cfg.n_layers * 4 * B * H * hd * pairs
    assert c.flops == want
    assert c.kernel_calls == (0 if train else cfg.n_layers)


def test_k9_counts_its_operands_once():
    """K9 in a trace: the output's shape, its FLOPs, q, k, v read and the
    output written once; outside a trace a meta tensor raises."""
    from repro_torch.kernels.flash_attention.ops import gqa_attention_op

    q, k = _fake((2, 256, 8, 64), (2, 256, 2, 64), dtype=torch.bfloat16)
    c = _cost(lambda q, k: gqa_attention_op(q, k, k, causal=True), q, k)
    assert c.flops == 4 * 64 * 2 * 8 * (256 * 257 // 2) and c.kernel_calls == 1
    assert c.bytes_accessed == (2 * q.numel() + 2 * k.numel()) * 2
    c = _cost(lambda q, k: gqa_attention_op(q, k, k, causal=False), q, k)
    assert c.flops == 4 * 64 * 2 * 8 * 256 * 256 and c.out_bytes == q.numel() * 2
    with pytest.raises(RuntimeError, match="outside a dry run"):
        gqa_attention_op(*(torch.empty((1, 4, 2, 8), device="meta") for _ in range(3)))



@pytest.mark.parametrize("arch", ["granite-20b", "minicpm-2b"])
def test_bf16_training_forward_counts_the_training_kernels(arch):
    """The training form in bf16 at head dim 64 (granite's MQA, minicpm's
    MHA): the attention counted as the training kernels run it on the card,
    4·B·H·hd·S(S+1)/2 a layer (the causal pairs) and one call a layer, not
    the plain path's S x S products."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="bfloat16")
    B, S = 2, 96
    params, _ = specs.param_structs(cfg, D.ONE_CARD)
    (tokens,) = _fake((B, S), dtype=torch.int32)
    c = _cost(lambda p, t: transformer.forward(p, cfg, t, train=True), params, tokens)
    hd, H, kv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    per_layer = cfg.d_model * (H + 2 * kv) * hd + H * hd * cfg.d_model + 3 * cfg.d_model * cfg.d_ff
    head = cfg.d_model * transformer.padded_vocab(cfg)
    pairs = S * (S + 1) // 2
    want = 2 * B * S * (cfg.n_layers * per_layer + head) + cfg.n_layers * 4 * B * H * hd * pairs
    assert c.flops == want and c.kernel_calls == cfg.n_layers


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "every_key"])
def test_the_training_kernels_count_their_work(causal):
    """``attention_train_op`` on meta tensors, forward and backward: the
    forward the prefill kernel's work and its log-sum-exp written; the
    backward five products of that size, twice the forward's operands,
    the log-sum-exp read and the row sums written and read. Outside a
    trace a meta tensor raises."""
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention.ops import attention_train_op

    B, S, H, kv, d = 2, 200, 8, 2, 64
    q = torch.empty((B, S, H, d), dtype=torch.bfloat16, device="meta", requires_grad=True)
    k, v = (torch.empty((B, S, kv, d), dtype=torch.bfloat16, device="meta", requires_grad=True)
            for _ in range(2))
    with backend.tracing() as t:
        out = attention_train_op(q, k, v, causal=causal)
        assert out.shape == q.shape and out.dtype == q.dtype
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    pairs = S * (S + 1) // 2 if causal else S * S
    operands = (2 * q.numel() + 2 * k.numel()) * 2
    plane = 4 * B * H * 256  # S rounded up to whole 128-row query tiles
    assert t.work == {
        "flash_attention_train_fwd": [1, 4 * d * B * H * pairs, operands + plane],
        "flash_attention_train_bwd": [1, 10 * d * B * H * pairs, 2 * operands + 3 * plane]}
    with pytest.raises(RuntimeError, match="outside a dry run"):
        attention_train_op(q, k, v)


def test_a_bf16_training_step_counts_each_kernel_pass():
    """A bf16 shadow training step of reduced minicpm-2b (remat on, two
    microbatches): the training kernels' forward twice a layer and
    microbatch (the forward and the unit's recompute) and their backward
    once; the same step in f32 counts no kernel and the plain path's
    products instead (16·B·H·hd·S² a layer and microbatch: two forwards
    of two products, the backward's four) where the kernels count
    18·B·H·hd·S(S+1)/2."""
    base = reduced(get_config("minicpm-2b"))
    shape = InputShape("x", 64, 4, "train")
    costs = {dt: D._trace_cost(D.build(dataclasses.replace(base, dtype=dt), "x", D.ONE_CARD,
                                       mode="shadow", n_replicas=1, n_microbatches=2,
                                       optimizer="adam", shape_override=shape))
             for dt in ("float32", "bfloat16")}
    L, B, S, H, hd = base.n_layers, 2, 64, base.n_heads, base.resolved_head_dim
    assert costs["float32"].kernel_calls == 0
    assert costs["bfloat16"].kernel_calls == 2 * 3 * L
    plain, fused = 16 * S * S, 18 * (S * (S + 1) // 2)
    assert costs["float32"].flops - costs["bfloat16"].flops == 2 * L * B * H * hd * (plain - fused)


# ---------------------------------------------------------------------------
# the meta twins against real tensors, and the depth fit against full traces
# ---------------------------------------------------------------------------

def _real_run(program):
    """``program.step`` on real zero tensors under the same counters."""
    args = T.map(lambda x: torch.zeros(x.shape, dtype=x.dtype)
                 if isinstance(x, torch.Tensor) else x, program.args)
    counter = D._ByteCounter(D._storage_bytes(D._tensors(args)))
    with FlopCounterMode(display=False) as fl, counter:
        program.step(*args)
    return fl.get_total_flops(), counter.bytes, counter.peak


@pytest.mark.parametrize("arch, kind", [("granite-20b", "train"), ("minicpm-2b", "decode"),
                                        ("phi3-medium-14b CONFIG_SWA", "prefill"),
                                        ("mamba2-780m", "train"), ("whisper-base", "decode"),
                                        ("phi3.5-moe-42b-a6.6b", "train")])
def test_meta_trace_counts_what_real_tensors_run(arch, kind):
    """Programs that launch no K9 (training, decode, a windowed prefill) on
    meta twins and on real CPU tensors: equal FLOPs and peak; bytes equal
    up to a few ops that decompose otherwise without data
    (``F.one_hot``'s range check reads its input on real tensors; a scalar
    fill), within 1e-3 of the total."""
    from repro_torch.configs import phi3_medium_14b

    cfg = reduced(phi3_medium_14b.CONFIG_SWA if arch.endswith("SWA") else get_config(arch))
    program = D.build(cfg, "x", D.ONE_CARD, n_microbatches=2, optimizer="adam",
                      shape_override=InputShape("x", 64, 4, kind))
    c = D._trace_cost(program)
    flops, nbytes, peak = _real_run(program)
    assert c.kernel_calls == 0 and c.flops == flops and c.peak_bytes == peak
    assert abs(c.bytes_accessed - nbytes) <= 1e-3 * nbytes, (c.bytes_accessed, nbytes)


FIT_CASES = ["granite-20b", "mamba2-780m", "phi3.5-moe-42b-a6.6b", "whisper-base",
             "jamba-1.5-large-398b"]


def _fit_and_full(cfg, shape, **kw):
    kw = dict(n_microbatches=2, shape_override=shape, **kw)
    return (D.extrapolate_cost(cfg, "x", D.ONE_CARD, **kw),
            D._trace_cost(D.build(cfg, "x", D.ONE_CARD, **kw)))


@pytest.mark.parametrize("arch", FIT_CASES)
def test_depth_fit_equals_the_full_trace(arch):
    """A training step fitted from 2- and 3-unit traces against a full
    6-unit trace (full widths, a small batch, Adam; jamba reduced, its
    unit "MA"): FLOPs, bytes, ops and outputs equal; the peak at most the
    full trace's, since here a phase of Adam's update overtakes the
    activations as the depth grows."""
    base = reduced(get_config(arch)) if arch.startswith("jamba") else get_config(arch)
    fit, full = _fit_and_full(D._depth_variant(base, 6), InputShape("x", 128, 2, "train"),
                              optimizer="adam")
    assert dataclasses.replace(fit, peak_bytes=0) == dataclasses.replace(full, peak_bytes=0)
    assert fit.peak_bytes <= full.peak_bytes


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
def test_depth_fit_of_the_peak_at_a_training_shape(optimizer):
    """At train_4k's sequence the activations and gradients hold the peak
    at every depth: the fit equals the full trace, peak included."""
    fit, full = _fit_and_full(D._depth_variant(get_config("granite-20b"), 6),
                              InputShape("x", 4096, 16, "train"), optimizer=optimizer)
    assert fit == full


# ---------------------------------------------------------------------------
# run_one, main, should_skip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_should_skip_matches_jax(arch, shape_name):
    assert D.should_skip(arch, shape_name) == jdryrun.should_skip(arch, shape_name)
    assert D.resolve_config(arch, shape_name).name == jdryrun.resolve_config(arch, shape_name).name
    assert D.resolve_config(arch, shape_name).sliding_window == \
        jdryrun.resolve_config(arch, shape_name).sliding_window
    assert D.LONG_CONTEXT_OK == jdryrun.LONG_CONTEXT_OK


def test_run_one_traces_kimi_k2_without_its_weights(capsys):
    """Full-width kimi-k2 at decode_32k (1.04 T parameters: a trace that
    allocated could not run): an ``OK`` row whose arguments do not fit one
    card, with the process's peak resident memory grown by under 1 GB."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KiB on Linux
    row = D.run_one("kimi-k2-1t-a32b", "decode_32k", one_card=True)
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert row["status"] == "ok" and not row["fits_one_card"], row
    assert row["arg_bytes"] > 2e12 and grown < 2 ** 20, (row["arg_bytes"], grown)
    assert row["chips"] == 1 and row["mesh"] == "1" and row["collectives"] == {}
    assert row["bottleneck"] == "memory" and row["flops_per_chip"] > 0
    out = capsys.readouterr().out
    assert out.startswith("OK    kimi-k2-1t-a32b x decode_32k x 1 [syncdp]")


def test_row_is_the_reference_row_plus_the_card_fields():
    row = D.run_one("granite-20b", "decode_32k", verbose=False, one_card=True)
    ref = set(jRA.Roofline("a", "s", "m", "syncdp", 1, 0.0, 0.0, 0.0, {}, 0, 0, 0).row())
    ref |= {"status", "compile_s"}
    assert set(row) - ref == {"peak_bytes", "fits_one_card", "trace_s", "placed_param_bytes",
                              "collective_table", "cross_pod_collectives",
                              "cross_pod_bytes_per_chip"}
    assert ref - set(row) == {"compile_s"}


def test_importing_the_jax_dry_run_leaves_xla_flags_as_they_were():
    assert os.environ.get("XLA_FLAGS") == _XLA_FLAGS


def test_no_fsdp_changes_the_placed_parameter_bytes(capsys):
    """``placed_param_bytes``: every byte on a 1 x 1 mesh; on the
    reference's 16 x 16 mesh the model axis splits the matrices, and FSDP
    splits them again over the data axis; ``--no-fsdp`` changes the row's
    number and its printed line, nothing else."""
    cfg = get_config("granite-20b")
    total = sum(t.numel() * t.element_size() for t in T.leaves(specs.param_structs(
        cfg, make_host_mesh())[0]))
    assert D.placed_param_bytes(cfg, mesh=make_host_mesh()) == total
    tp, fsdp = (D.placed_param_bytes(cfg, fsdp=f) for f in (False, True))
    assert total / 16 < tp < total / 8 and tp / 16 < fsdp < tp / 8, (total, tp, fsdp)
    rows = [D.run_one("granite-20b", "decode_32k", fsdp=f, one_card=True) for f in (True, False)]
    assert [r["placed_param_bytes"] for r in rows] == [fsdp, tp]
    assert ({k: v for k, v in rows[0].items() if k not in ("placed_param_bytes", "trace_s")}
            == {k: v for k, v in rows[1].items() if k not in ("placed_param_bytes", "trace_s")})
    out = capsys.readouterr().out
    assert "mesh (fsdp): " in out and "mesh (no fsdp): " in out


def test_build_gives_the_structures_with_their_specs():
    """A shadow training step's program: fake structures (nothing
    allocated) beside ``sharding/rules.py``'s specs, the replica dim on the
    pod axis, the batch's replica and batch dims placed."""
    cfg = reduced(get_config("granite-20b"))
    p = D.build(cfg, "x", D.ONE_CARD, mode="shadow", optimizer="adam",
                shape_override=InputShape("x", 64, 4, "train"))
    params, opt_state, batch = p.args
    pspec, ospec, bspec = p.specs
    wq = params["unit"][0]["mixer"]["wq"]
    assert tuple(wq.shape) == (2, cfg.n_layers, cfg.d_model, cfg.n_heads * 64)
    assert pspec["unit"][0]["mixer"]["wq"] == ("pod", None, "data", "model")
    assert ospec["m"]["unit"][0]["mixer"]["wq"] == ("pod", None, "data", "model")
    assert tuple(batch["tokens"].shape) == (2, 2, 64) and bspec["tokens"] == ("pod", "data", None)


def test_run_one_reports_a_skip_and_a_sync_step():
    assert D.run_one("granite-20b", "long_500k", verbose=False)["status"] == "skipped"
    row = D.run_one("minicpm-2b", "train_4k", sync_algo="easgd", verbose=False, one_card=True)
    assert row["status"] == "ok" and row["mode"] == "sync:easgd" and row["flops_per_chip"] == 0
    # EASGD over the R=2 stack: every weight read and written a few times
    assert row["bytes_per_chip"] > 4 * row["arg_bytes"] / 3


@functools.lru_cache(maxsize=None)
def _variant_rows():
    kw = dict(verbose=False, one_card=True)
    return (D.run_one("granite-20b", "train_4k", **kw),
            D.run_one("granite-20b", "train_4k", remat_policy="save_comm", **kw),
            D.run_one("granite-20b", "train_4k", parallel_block=True, **kw))


def test_the_variants_trace():
    """``--remat-policy save_comm`` keeps two activations a layer more and
    recomputes no output product; ``--parallel-block`` runs the same
    products."""
    full, comm, par = _variant_rows()
    assert all(r["status"] == "ok" for r in (full, comm, par))
    assert comm["peak_bytes"] > full["peak_bytes"]
    assert comm["flops_per_chip"] < full["flops_per_chip"]
    assert par["flops_per_chip"] == full["flops_per_chip"]


def test_main_prints_rows_and_a_summary(capsys):
    assert D.main(["--arch", "minicpm-2b", "--shape", "decode_32k", "--one-card"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("OK    minicpm-2b x decode_32k x 1 [syncdp]  trace=")
    assert any(line.strip().startswith("roofline: t_comp=") for line in out)
    assert out[-1] == "Summary: 1 ok, 0 skipped, 0 failed / 1"


@pytest.mark.parametrize("flag", ["--multi-pod", "--both-meshes"])
def test_multi_pod_exits_naming_one_card(flag, capsys):
    """``--multi-pod`` and ``--both-meshes`` trace the reference's meshes on
    a fake process group (they were refused while the port ran one card
    only): an ``OK`` row with 512 chips (and one with 256 first for both
    meshes), here for MA's sync step, whose means cross the pods; one
    card still says it has no collective, and ``--one-card`` with a mesh
    flag is refused."""
    assert D.main(["--arch", "minicpm-2b", "--shape", "train_4k", "--sync-algo", "ma",
                   flag]) == 0
    out = capsys.readouterr().out.splitlines()
    ok = [line for line in out if line.startswith("OK    ")]
    want = ["16x16", "2x16x16"] if flag == "--both-meshes" else ["2x16x16"]
    assert [line.split(" x ")[2].split()[0] for line in ok] == want
    assert all(f"chips={ {'16x16': 256, '2x16x16': 512}[m]}" in line for m, line in zip(want, ok))
    assert any(line.strip().startswith("cross-pod: ") and not line.strip().startswith(
        "cross-pod: 0 ") for line in out)
    row = D.run_one("minicpm-2b", "train_4k", sync_algo="ma", multi_pod=True, verbose=False)
    assert row["status"] == "ok" and row["chips"] == 512 and row["mesh"] == "2x16x16"
    assert row["cross_pod_collectives"] > 0 and row["t_collective"] > 0
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "granite-20b", "--shape", "train_4k", "--one-card", flag])
    assert e.value.code == 2 and "one-card" in capsys.readouterr().err
