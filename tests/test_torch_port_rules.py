"""Rules of the port: it imports no JAX and nothing of the JAX package, its
entry points run on the card unless the CPU is asked for, and options of
parts not yet ported are refused rather than ignored."""
import ast
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch import optim  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.core import algorithms, runners, sync  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
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
    bad = [(os.path.relpath(p, ROOT), m) for p in files for m in _imported_roots(p)
           if m in FORBIDDEN]
    assert not bad, f"forbidden imports in the port: {bad}"


def test_import_scan_catches_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom repro.core import sync\nimport jax.numpy as jnp\n")
    assert sorted(m for m in _imported_roots(str(p)) if m in FORBIDDEN) == ["jax", "repro"]


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
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _sim(device="cpu", **{option: object()})


@pytest.mark.parametrize("flags", [
    ["--threaded"], ["--cache-rows", "100"], ["--pipeline-depth", "2"],
    ["--membership-schedule", "fail@2:1"], ["--save", "ck"], ["--restore", "ck"],
    ["--auto-demote"], ["--auto-mode"], ["--crash-at", "1:2"],
])
def test_cli_refuses_unported_flags(flags):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train.main(["dlrm", "--device", "cpu", "--iters", "1", *flags])


def test_cli_runs_end_to_end_on_cpu(capsys):
    out = train.main(["dlrm", "--device", "cpu", "--tiny", "--iters", "3", "--eval-batches", "1"])
    assert set(out) == {"final_train", "eval", "avg_sync_gap"}
    assert all(v == v and v > 0 for v in out.values())  # finite, positive
    assert "DLRM tiny on cpu" in capsys.readouterr().out


def test_registry():
    assert algorithms.names() == ("easgd",)
    with pytest.raises(KeyError, match="unknown sync algorithm"):
        algorithms.get("nope")
    with pytest.raises(ValueError, match="unknown sync algo"):
        sync.SyncConfig(algo="ma").validate()
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
