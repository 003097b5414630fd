"""Rules of the port: it imports no JAX and nothing of the JAX package, its
entry points run on the card unless the CPU is asked for, and every option
of the DLRM runners and launcher is ported (accepted, and it trains)."""
import ast
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores

from repro_torch import optim  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.core import algorithms, runners, sync  # noqa: E402
from repro_torch.core.membership import Membership  # noqa: E402
from repro_torch.core.pipeline import PipelineConfig  # noqa: E402
from repro_torch.embeddings.cache import CacheConfig  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
# the card's machine has no ml_dtypes: the port carries bf16 bits as int16
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    examples = os.path.join(ROOT, "examples")
    files += [os.path.join(examples, n) for n in sorted(os.listdir(examples))
              if n.startswith("torch_") and n.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_repro():
    files = _port_files()
    assert len(files) > 20 and os.path.exists(files[0])
    for name in ("ma_update", "bmuf_update", "gossip_update"):  # the sync kernels' modules
        for mod in (f"{name}.py", "ops.py", "ref.py"):
            assert os.path.join(PORT, "kernels", name, mod) in files
    for mod in ("pipeline", "scheduler", "modeswitch"):  # host-only copies of JAX-free modules
        assert os.path.join(PORT, "core", f"{mod}.py") in files
    for mod in ("mamba2", "moe"):
        assert os.path.join(PORT, "models", f"{mod}.py") in files
    for ex in ("quickstart", "compare_sync_algorithms", "train_dlrm_shadowsync",
               "serve_batched", "lm_shadowsync"):  # the port's examples
        assert os.path.join(ROOT, "examples", f"torch_{ex}.py") in files
    bad = [(os.path.relpath(p, ROOT), m) for p in files for m in _imported_roots(p)
           if m in FORBIDDEN]
    assert not bad, f"forbidden imports in the port: {bad}"


def test_every_reference_module_has_its_counterpart():
    """The ``comm`` of the two packages' modules is empty: every ``*.py``
    under ``src/repro`` has a file of the same path under ``src/repro_torch``
    (the launcher's mesh, specs and dry run, and the sharding rules and
    context, were the last)."""
    ref = os.path.join(ROOT, "src", "repro")
    mods = sorted(os.path.relpath(os.path.join(d, n), ref) for d, _, names in os.walk(ref)
                  for n in names if n.endswith(".py"))
    assert len(mods) > 60
    missing = [m for m in mods if not os.path.exists(os.path.join(PORT, m))]
    assert not missing, missing


def test_import_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom repro.core import sync\nimport jax.numpy as jnp\n"
                 "import ml_dtypes\n")
    assert sorted(m for m in _imported_roots(str(p)) if m in FORBIDDEN) == \
        ["jax", "ml_dtypes", "repro"]


def _sim(**kw):
    return runners.HogwildSim(dlrm_ctr.tiny(), sync.SyncConfig(), n_trainers=2, n_threads=1,
                              batch_size=8, optimizer=optim.adagrad(0.02), **kw)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_sim_without_device_needs_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _sim()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runners.HogwildSim(dlrm_ctr.tiny(), sync.SyncConfig(algo="ma"), n_trainers=2,
                           n_threads=1, batch_size=8, optimizer=optim.adagrad(0.02), device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _sim(device="cuda")
    assert _sim(device="cpu").device == torch.device("cpu")


def test_cli_without_device_needs_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["dlrm", "--tiny", "--iters", "1"])


def test_resolve_device():
    assert backend.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        backend.resolve_device("meta")


@pytest.mark.parametrize("option", ["membership", "schedule", "cache", "pipeline",
                                    "mode_schedule"])
def test_sim_refuses_unported_options(option):
    """Every option of the sim is ported now: each is accepted and trains
    (none raises ``NotImplementedError`` any more)."""
    ported = {"membership": Membership(2, R_max=3), "schedule": [(1, "fail", 1)],
              "cache": CacheConfig(hot_frac=0.5), "pipeline": PipelineConfig(depth=2),
              "mode_schedule": [(1, "fixed_rate")]}
    out = _sim(device="cpu", **{option: ported[option]}).run(2)
    assert len(out["train_loss"]) == 2 and all(v == v for v in out["train_loss"])
    if option == "cache":
        assert out["cache_stats"]["lookups"] == 2
    elif option == "pipeline":
        assert out["pipeline_stats"]["steps"] == 2 and out["pipeline_stats"]["worker_errors"] == 0
    elif option == "mode_schedule":
        assert out["mode_events"] == [(1, "shadow", "fixed_rate")]
    else:
        assert out["replica_losses"].shape[0] == 2


@pytest.mark.parametrize("flags", [
    ["--threaded", "--cache-rows", "800"], ["--cache-rows", "800"], ["--pipeline-depth", "2"],
    ["--membership-schedule", "fail@2:1"], ["--save", "ck"], ["--restore", "ck"],
    ["--auto-demote"], ["--auto-mode"], ["--threaded", "--auto-demote"],
])
def test_cli_refuses_unported_flags(flags, tmp_path):
    """Every flag is ported now: each trains (``--restore`` from a checkpoint
    saved first), except ``--auto-demote`` and ``--auto-mode`` without
    ``--threaded``, which exit with the JAX launcher's message (the sim has
    no measured pace to act on)."""
    if flags in (["--auto-demote"], ["--auto-mode"]):
        with pytest.raises(SystemExit, match=f"{flags[0]} requires --threaded"):
            train.main(["dlrm", "--device", "cpu", "--iters", "1", *flags])
        return
    if flags[-1] == "ck":
        flags = flags[:-1] + [str(tmp_path / "ck")]
        if flags[0] == "--restore":
            train.main(["dlrm", "--device", "cpu", "--tiny", "--iters", "1", "--eval-batches",
                        "1", "--save", flags[1]])
    small = ["--batch-size", "8", "--trainers", "2", "--threads", "2"]
    out = train.main(["dlrm", "--device", "cpu", "--tiny", "--iters", "2",
                      "--eval-batches", "1", *small, *flags])
    assert all(v == v for v in out.values() if isinstance(v, float))
    if flags == ["--pipeline-depth", "2"]:
        assert set(out) == {"final_train", "eval", "avg_sync_gap"}
    if "--auto-demote" in flags:
        assert out["iter_count"] == [2, 2]  # two slots at the quorum of two: none demoted
        assert all(to != "demoted" for *_, to in out["policy_transitions"])


def test_threaded_cli_without_device_needs_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["dlrm", "--threaded", "--tiny", "--iters", "1"])


def test_chaos_flags_need_threaded():
    with pytest.raises(SystemExit, match="require --threaded"):
        train.main(["dlrm", "--device", "cpu", "--iters", "1", "--ps-fail-at", "0:1"])


def test_threaded_cli_runs_end_to_end_on_cpu(capsys):
    out = train.main(["dlrm", "--threaded", "--device", "cpu", "--tiny", "--trainers", "2",
                      "--iters", "4", "--batch-size", "16", "--crash-at", "1:2"])
    assert out["iter_count"] == [4, 2] and out["sync_count"] > 0
    assert all(v == v for v in out["train_loss"])
    text = capsys.readouterr().out
    assert "DLRM tiny threaded on cpu" in text and "membership: [('fail', 1)]" in text


def test_cli_runs_end_to_end_on_cpu(capsys):
    out = train.main(["dlrm", "--device", "cpu", "--tiny", "--iters", "3", "--eval-batches", "1"])
    assert set(out) == {"final_train", "eval", "avg_sync_gap"}
    assert all(v == v and v > 0 for v in out.values())  # finite, positive
    assert "DLRM tiny on cpu" in capsys.readouterr().out


def test_registry():
    assert algorithms.names() == ("bmuf", "easgd", "gossip", "ma")
    with pytest.raises(KeyError, match="unknown sync algorithm"):
        algorithms.get("nope")
    with pytest.raises(ValueError, match="unknown sync algo"):
        sync.SyncConfig(algo="nope").validate()
    with pytest.raises(ValueError, match="already registered"):
        algorithms.register(algorithms.EASGD)


def test_generic_flat_fallback_matches_easgd_kernel_path():
    """An algorithm that only writes the tree oracle runs on the flat engine
    through the base class's unpack -> land -> pack fallback, and gives what
    EASGD's kernel path gives."""
    class OracleOnly(algorithms.SyncAlgorithm):
        name = "easgd-oracle-only"
        centralized = True
        init_state = algorithms.EASGD.init_state
        land = algorithms.EASGD.land

    algorithms.register(OracleOnly)
    try:
        outs = []
        for algo in ("easgd", "easgd-oracle-only"):
            sim = runners.HogwildSim(dlrm_ctr.tiny(), sync.SyncConfig(algo=algo, gap=2),
                                     n_trainers=3, n_threads=1, batch_size=8,
                                     optimizer=optim.adagrad(0.02), device="cpu")
            outs.append(sim.run(6))
        assert outs[0]["sync_count"] == outs[1]["sync_count"] > 0
        torch.testing.assert_close(outs[0]["state"].w_stack, outs[1]["state"].w_stack,
                                   rtol=1e-6, atol=1e-7)
    finally:
        algorithms.unregister("easgd-oracle-only")


@pytest.mark.parametrize("algo", ["ma", "bmuf", "gossip"])
def test_cli_runs_every_algorithm_on_cpu(capsys, algo):
    out = train.main(["dlrm", "--device", "cpu", "--tiny", "--algo", algo, "--iters", "3",
                      "--eval-batches", "1"])
    assert all(v == v and v > 0 for v in out.values())


def test_cli_membership_schedule_runs_end_to_end(capsys):
    out = train.main(["dlrm", "--device", "cpu", "--tiny", "--algo", "ma", "--iters", "8",
                      "--eval-batches", "1", "--membership-schedule", "fail@3:1,join@6:1"])
    assert all(v == v for v in out.values())
    assert "membership: [('fail', 1), ('join', 1), ('activate', 1)]" in capsys.readouterr().out


def test_threaded_cli_ignores_the_membership_schedule(capsys):
    out = train.main(["dlrm", "--threaded", "--device", "cpu", "--tiny", "--algo", "gossip",
                      "--trainers", "2", "--iters", "3", "--batch-size", "16",
                      "--sync-sleep", "0.005", "--membership-schedule", "fail@1:1"])
    assert out["iter_count"] == [3, 3] and out["sync_count"] > 0
    assert "membership:" not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The serving slice: configs, transformer, serve, K8 and K9
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer, whisper  # noqa: E402


def test_port_scan_sees_the_serving_slice():
    files = set(_port_files())
    for rel in ("configs/base.py", "configs/phi3_medium_14b.py", "configs/minicpm_2b.py",
                "models/transformer.py", "models/layers.py", "launch/serve.py",
                "kernels/flash_attention/flash_attention.py", "kernels/flash_attention/ops.py",
                "kernels/flash_attention/ref.py", "kernels/interaction/interaction.py",
                "kernels/interaction/ops.py", "kernels/interaction/ref.py"):
        assert os.path.join(PORT, *rel.split("/")) in files, rel
    for name in ("flash_attention", "interaction"):
        assert os.path.exists(backend.source_path(name)) and name in backend.sources()


def test_every_kernel_source_is_listed_once():
    """``backend.sources()`` is the directory scan, and the smoke's table of
    kernels to build and check names each source once."""
    import chip_smoke

    on_disk = sorted(d for d in os.listdir(os.path.join(PORT, "kernels"))
                     if os.path.exists(backend.source_path(d)))
    assert backend.sources() == on_disk and len(on_disk) == 8
    assert sorted(chip_smoke.KERNELS) == on_disk


@pytest.mark.parametrize("marks, kept", [
    ((0, 90), True),  # a marker on each side: the whole body is in the trace
    ((0, 10, 90), True),  # the pad spin kept too
    ((90,), False),  # the opening marker lost: so may the body's first launches be
    ((0,), False),  # the closing marker lost
    ((0, 30), False),  # nothing whole between the markers
])
def test_smoke_keeps_a_trace_only_with_its_body_bracketed(marks, kept):
    """The smoke's profiler traces: a trace is kept only where the opening
    and the closing marker spins (the last two) are in it with device events
    between them; the markers, the host's events and device events outside
    the markers are left out."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    import chip_smoke

    def ev(name, start, end, device=DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start, end=end,
                                                          elapsed_us=lambda: end - start))

    body = [ev("embedding_bag_kernel", 20, 40), ev("vectorized_elementwise_kernel", 50, 60)]
    events = [ev("cudaLaunchKernel", 5, 6, DeviceType.CPU), ev("Activity Buffer Request", 96, 97),
              *body,
              *(ev(f"at::cuda::{chip_smoke.MARKER_KERNEL}(long)", t, t + 5) for t in marks)]
    got = chip_smoke.body_events(events)
    assert (got == body) if kept else got is None
    assert chip_smoke.body_events([ev(chip_smoke.MARKER_KERNEL, t, t + 5) for t in (0, 90)]) is None
    if kept:
        assert chip_smoke.launched("embedding_bag_kernel", 1)(got)
        assert not chip_smoke.launched("embedding_bag_kernel", 2)(got)


@pytest.mark.parametrize("dropped", range(8))
def test_smoke_trace_loses_its_first_records_to_the_sacrifice(dropped):
    """The profiler drops a window's first device records. A trace opens
    with short sacrificial spins, then the pad and the opening marker: it is
    kept while what was dropped lies before the opening marker, and never
    on a sacrificial spin's word."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    import chip_smoke

    def ev(name, start, end):
        return SimpleNamespace(name=name, device_type=DeviceType.CUDA,
                               time_range=SimpleNamespace(start=start, end=end,
                                                          elapsed_us=lambda: end - start))

    spin = f"at::cuda::{chip_smoke.MARKER_KERNEL}(long)"
    sacrifice = [ev(spin, t, t + 0.5) for t in (0.0, 1.0, 2.0, 3.0)]
    body = [ev("embedding_bag_kernel", 25, 40), ev("vectorized_elementwise_kernel", 45, 55)]
    trace = (sacrifice + [ev(spin, 5, 15), ev(spin, 16, 21)] + body
             + [ev(spin, 60, 65), ev("Activity Buffer", 70, 71)])
    got = chip_smoke.body_events(trace[dropped:])
    if dropped <= len(sacrifice) + 1:  # the sacrifice and the pad
        assert got == body
    else:
        assert got is None
        lost = chip_smoke.lost_summary(trace[dropped:])
        assert lost["marker_spins"] == 1 and lost["sacrificial_spins"] == 0
        assert not lost["closing_marker_lost"]  # a retry may keep the opening
    lost = chip_smoke.lost_summary(trace[dropped:-2])  # the closing marker lost too
    assert chip_smoke.body_events(trace[dropped:-2]) is None
    assert lost["closing_marker_lost"] == (dropped <= len(sacrifice) + 1)  # a marker left


K9_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__x_18_flash_attention_cu_y2wg28flash_attention_wgmma_kernelILi128EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__x_18_flash_attention_cu_y2wg28flash_attention_wgmma_kernelILi128EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__x_18_flash_attention_cu_y2tf29flash_attention_tf32x3_kernelILi64EEEvPKfS3_' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__x_18_flash_attention_cu_y2tf29flash_attention_tf32x3_kernelILi64EEEvPKfS3_
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers, 16 bytes smem, 464 bytes cmem[0]
"""


def test_smoke_reads_the_k9_build_log_and_sass():
    """The smoke's K9 build report: registers, static shared memory and
    spills of each __global__ from the ptxas log, the (kernel, head dim) of
    a mangled name, and per-function instruction counts from cuobjdump."""
    import chip_smoke

    report = chip_smoke.ptxas_report(K9_PTXAS_LOG)
    by_kernel = {chip_smoke.k9_instance(name): info for name, info in report.items()}
    assert by_kernel == {
        ("flash_attention_wgmma_kernel", 128): dict(registers=168, static_smem_bytes=0,
                                                     spill_stores=0, spill_loads=0),
        ("flash_attention_tf32x3_kernel", 64): dict(registers=122, static_smem_bytes=16,
                                                    spill_stores=4, spill_loads=12)}
    with pytest.raises(AssertionError):
        chip_smoke.k9_instance("_ZN2wg12other_kernelILi64EEEv")
    sass = ("\n\tcode for sm_90a\n\t\tFunction : fa_wgmma\n"
            "        /*0010*/  UTMALDG.4D [UR8], [UR16] ;\n"
            "        /*0020*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ ;\n"
            "        /*0030*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24 ;\n"
            "\n\t\tFunction : fa_f32\n        /*0010*/  FFMA R1, R2, R3, R1 ;\n"
            "        /*0020*/  HMMA.1688.F32.TF32 R4, R8, R12, R4 ;\n"
            "        /*0030*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n")
    ops = chip_smoke.K9_SASS_OPS + chip_smoke.K9_F32_SASS_OPS
    tf32 = chip_smoke.K9_F32_SASS_OPS[0]
    assert chip_smoke.sass_ops(sass, ops) == {
        "fa_wgmma": {"HGMMA": 2, "UTMALDG": 1, tf32: 0},
        "fa_f32": {"HGMMA": 0, "UTMALDG": 0, tf32: 1}}


def test_serve_without_device_needs_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "phi3-medium-14b", "--prompt-len", "8", "--gen", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "phi3-medium-14b", "--device", "cuda", "--full"])


def test_unported_families_are_refused_before_any_weight():
    """The name is kept from when this test held the port's refusals, so
    that its history reads as one test; what it checks now is that nothing
    is refused any more: ``parallel_block``, the last variant that raised,
    draws the reference's tree (its unused ``norm2`` too) and serves a
    prompt on the CPU."""
    cfg = dataclasses.replace(reduced(get_config("granite-20b")), parallel_block=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    plain = transformer.init_params(dataclasses.replace(cfg, parallel_block=False),
                                    torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params), T.leaves(plain)))
    assert "norm2" in params["unit"][0]
    assert not hasattr(transformer, "check_ported")
    logits, cache = transformer.prefill(params, cfg, torch.zeros((1, 4), dtype=torch.long), 6)
    assert logits.shape == (1, transformer.padded_vocab(cfg)) and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-base"])
def test_vlm_and_audio_models_draw_and_serve(arch):
    """The vision frontend and the audio family, refused until they were
    ported, now draw their weights and caches and serve a prompt on the CPU
    through their model module (``transformer`` for llava, ``whisper``)."""
    cfg = reduced(get_config(arch))
    model = whisper if cfg.family == "audio" else transformer
    params = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert ("projector" in params) == (cfg.family == "vlm")
    toks = torch.zeros((1, 4), dtype=torch.long)
    front = serve.make_frontend(cfg, 1, 0)
    n_prefix = front["prefix_embeds"].shape[1] if "prefix_embeds" in front else 0
    if cfg.family == "audio":
        enc = whisper.encode(params, cfg, front["frames"])
        cache = model.init_cache(cfg, 1, 8, device="cpu")
        cache["cross"] = whisper.build_cross_cache(params, cfg, enc)
    else:
        _, cache = transformer.prefill(params, cfg, toks, n_prefix + 8,
                                       prefix_embeds=front["prefix_embeds"])
    logits, _ = model.decode_step(params, cfg, cache, toks[:, 0], n_prefix + 4)
    assert tuple(logits.shape) == (1, cfg.vocab_size) and torch.isfinite(logits).all()
