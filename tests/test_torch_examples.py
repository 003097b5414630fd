"""The port's examples (``examples/torch_*.py``) run on the CPU for a few
iterations each, with the reference examples' defaults otherwise (the LM
example's arch is mamba2-780m, the serving example's jamba-1.5-large); and
without ``--device cpu`` and without a card they raise, as the launchers do.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    out, ev = _example("quickstart").main(["--device", "cpu", "--iters", "12"])
    assert len(out["train_loss"]) == 12 and np.isfinite(ev) and out["sync_count"] > 0
    assert "background syncs:" in capsys.readouterr().out


def test_compare_sync_algorithms(capsys):
    res = _example("compare_sync_algorithms").main(["--device", "cpu", "--iters", "10"])
    assert len(res) == 2 * 4 + 1 and all(np.isfinite(v).all() for v in res.values())
    text = capsys.readouterr().out
    assert "S-EASGD" in text and "FR-GOSSIP" in text and "S-BMUF(a=0.9)" in text


@pytest.mark.parametrize("threaded", [False, True], ids=["sim", "threaded"])
def test_train_dlrm_shadowsync(threaded, tmp_path, monkeypatch):
    from repro_torch.configs import dlrm_ctr

    example = _example("train_dlrm_shadowsync")
    monkeypatch.setattr(example, "CFG_100M", dlrm_ctr.tiny())  # a few iterations on the CPU
    argv = ["--device", "cpu", "--iters", "6"]
    argv += ["--threaded"] if threaded else ["--save", str(tmp_path / "ck")]
    out = example.main(argv)
    assert all(np.isfinite(out["train_loss"]))
    if not threaded:
        assert os.listdir(tmp_path / "ck")


def test_serve_batched_serves_jamba_by_default(capsys):
    out = _example("serve_batched").main(["--device", "cpu", "--batch", "2", "--prompt-len",
                                          "16", "--gen", "4"])
    assert out["tokens"].shape == (2, 4) and out["logits_finite"]
    assert capsys.readouterr().out.startswith("jamba-1.5-large-398b (reduced, float32")


def test_lm_shadowsync_trains_mamba2_by_default(capsys):
    losses = _example("lm_shadowsync").main(["--device", "cpu", "--iters", "10"])
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert "mamba2-780m:" in capsys.readouterr().out


@pytest.mark.parametrize("name,argv", [("quickstart", ["--iters", "1"]),
                                       ("lm_shadowsync", ["--iters", "1"]),
                                       ("serve_batched", ["--gen", "2"])])
def test_examples_without_device_need_the_card(monkeypatch, name, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(argv)
