"""Rules of the port: it imports no JAX and nothing of the JAX package, its
entry points run on the card unless the CPU is asked for, and options of
parts not yet ported are refused rather than ignored."""
import ast
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores

from repro_torch import optim  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.core import algorithms, runners, sync  # noqa: E402
from repro_torch.core.membership import Membership  # noqa: E402
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
    for name in ("ma_update", "bmuf_update", "gossip_update"):  # the sync kernels' modules
        for mod in (f"{name}.py", "ops.py", "ref.py"):
            assert os.path.join(PORT, "kernels", name, mod) in files
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
    """Options of parts not yet ported are refused. ``membership`` and
    ``schedule`` are ported now: each is accepted and trains."""
    ported = {"membership": Membership(2, R_max=3), "schedule": [(1, "fail", 1)]}
    if option in ported:
        out = _sim(device="cpu", **{option: ported[option]}).run(2)
        assert len(out["train_loss"]) == 2 and all(v == v for v in out["train_loss"])
        assert out["replica_losses"].shape[0] == 2
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _sim(device="cpu", **{option: object()})


@pytest.mark.parametrize("flags", [
    ["--threaded", "--cache-rows", "100"], ["--cache-rows", "100"], ["--pipeline-depth", "2"],
    ["--membership-schedule", "fail@2:1"], ["--save", "ck"], ["--restore", "ck"],
    ["--auto-demote"], ["--auto-mode"], ["--threaded", "--auto-demote"],
])
def test_cli_refuses_unported_flags(flags):
    """Flags of parts not yet ported are refused; ``--membership-schedule``
    is ported now: it is accepted and trains."""
    if flags[0] == "--membership-schedule":
        out = train.main(["dlrm", "--device", "cpu", "--tiny", "--iters", "2",
                          "--eval-batches", "1", *flags])
        assert all(v == v for v in out.values())
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train.main(["dlrm", "--device", "cpu", "--iters", "1", *flags])


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
