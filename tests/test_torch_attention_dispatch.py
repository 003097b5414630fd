"""Which path the training form of attention takes (``models/layers.py``):
the hand-written kernels (``attention_train_op``) for bf16 self-attention on
the card (or a dry run's meta twins of it) at head dim 64 or 128 without a
window, the plain query-chunked path for everything else. On the CPU, where
no kernel runs.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores

from repro_torch import optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    attention_train_bwd, attention_train_op, gqa_attention_op)
from repro_torch.kernels.flash_attention.ref import gqa_attention_ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

CFG = reduced(get_config("minicpm-2b"))  # no window, 4 heads of 64


def _card(s=8, heads=2, d=64, dtype=torch.bfloat16):
    """What the predicate reads of a CUDA tensor (B, s, heads, d), without a card."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype, shape=(1, s, heads, d))


def test_bf16_self_attention_on_the_card_takes_the_kernels():
    for d in (64, 128):
        assert layers.fused_attention_applies(_card(d=d), _card(d=d), CFG)
    assert layers.fused_attention_applies(_card(heads=8), _card(heads=2), CFG)  # GQA
    # a dry run's meta twins stand for the card: the trace counts the kernels
    meta = torch.empty((1, 8, 2, 64), dtype=torch.bfloat16, device="meta")
    assert layers.fused_attention_applies(meta, meta, CFG)


@pytest.mark.parametrize("case", ["cpu", "meta_f32", "f32", "window", "cross", "d32", "d96",
                                  "d256"])
def test_everything_else_takes_the_plain_path(case):
    cfg = dataclasses.replace(CFG, sliding_window=16) if case == "window" else CFG
    q = k = _card()
    if case == "cpu":
        q = k = torch.empty((1, 8, 2, 64), dtype=torch.bfloat16)
    elif case == "meta_f32":
        q = k = torch.empty((1, 8, 2, 64), dtype=torch.float32, device="meta")
    elif case == "f32":
        q = k = _card(dtype=torch.float32)
    elif case == "cross":
        k = _card(s=12)
    elif case.startswith("d"):
        q = k = _card(d=int(case[1:]))
    assert not layers.fused_attention_applies(q, k, cfg)


def test_a_cpu_training_step_launches_no_kernel():
    """A bf16 shadow step of reduced minicpm-2b on the CPU runs the plain
    path: neither training kernel counts a launch, and the loss is finite."""
    from repro_torch.core import spmd
    from repro_torch.data import tokens

    cfg = dataclasses.replace(CFG, n_layers=1, dtype="bfloat16")
    params = spmd.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    stack = spmd.stack_replicas(params, 2)
    trans = tokens.make_transition(cfg.vocab_size, seed=0)
    toks = tokens.gen_batch(trans, 0, 0, 2, 32)["tokens"].reshape(2, 1, 32)
    before = (attention_train_op.launches, attention_train_bwd.launches)
    step = spmd.make_train_step(cfg, optim.sgd(0.1), "shadow")
    _, _, loss = step(stack, (), {"tokens": toks})
    assert (attention_train_op.launches, attention_train_bwd.launches) == before
    assert torch.isfinite(loss.float()).all()


def test_the_training_op_runs_on_the_card_only():
    """``attention_train_op`` has no CPU form: the CPU trains through the
    plain path, so a CPU tensor is refused before anything runs."""
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="no training kernel on cpu"):
        attention_train_op(q, q, q, causal=True)


def test_the_prefill_op_still_refuses_a_card_input_that_needs_a_gradient():
    """``gqa_attention_op`` has no backward: a CUDA input that requires grad
    is refused before anything is launched (read from a stand-in for a
    card tensor); training goes through ``attention_train_op``."""
    q = types.SimpleNamespace(is_cuda=True, requires_grad=True)
    k = v = types.SimpleNamespace(is_cuda=True, requires_grad=False)
    with pytest.raises(RuntimeError, match="no backward"):
        gqa_attention_op(q, k, v)


def test_the_cpu_training_form_is_the_query_chunked_path():
    """The plain path the CPU keeps: the layer's training form equals the
    query-chunked attention it had before the kernels (same operations)."""
    gen = torch.Generator().manual_seed(1)
    cfg = dataclasses.replace(CFG, n_kv_heads=2)
    q = torch.randn((1, 16, 4, 64), generator=gen)
    k, v = (torch.randn((1, 16, 2, 64), generator=gen) for _ in range(2))
    pos = torch.arange(16)
    got = layers._chunked_attention(q, k, v, pos, cfg, causal=True)
    want = layers._attend(q, layers._repeat_kv(k, 2), layers._repeat_kv(v, 2), pos, cfg, True)
    assert torch.equal(got, want)


def _plain_kernels(monkeypatch):
    """The training Function's plumbing on the CPU: its two kernel calls
    stood in for by the plain version (the forward's output, a log-sum-exp
    of the right shape, and autograd's gradients of the same), and the
    layer dispatching every attention to the Function."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops

    def fwd(q, k, v, *, causal=True):
        lse = torch.zeros((q.shape[0], q.shape[2], fa.padded_rows(q.shape[1])))
        return gqa_attention_ref(q, k, v, causal=causal), lse

    def bwd(q, k, v, out, lse, dout, *, causal=True):
        with torch.enable_grad():
            x = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(gqa_attention_ref(*x, causal=causal), x, dout)

    monkeypatch.setattr(ops, "flash_attention_train_fwd", fwd)
    monkeypatch.setattr(ops, "flash_attention_train_bwd", bwd)
    monkeypatch.setattr(layers, "fused_attention_applies", lambda q, k, cfg: True)
    monkeypatch.setattr(layers, "attention_train_op",
                        lambda q, k, v, causal=True: ops._TrainingAttention.apply(q, k, v, causal))


@pytest.mark.parametrize("policy", ["full", "save_comm"])
def test_the_training_function_under_unit_remat(monkeypatch, policy):
    """Under each remat policy the Function runs its forward twice a layer
    (the forward and the unit's recompute) and its backward once, and the
    loss and gradients are the plain path's (GQA: k and v's gradients
    summed over their query heads by autograd in both)."""
    from repro_torch.models import transformer

    cfg = dataclasses.replace(CFG, n_kv_heads=2)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(1))

    def grads():
        leaves = [p.detach().requires_grad_() for p in T.leaves(params)]
        loss = transformer.loss_fn(T.unflatten(params, leaves), cfg, {"tokens": toks},
                                   remat=True, remat_policy=policy)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    want = grads()
    _plain_kernels(monkeypatch)
    before = (attention_train_op.launches, attention_train_bwd.launches)
    got = grads()
    after = (attention_train_op.launches, attention_train_bwd.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (2 * cfg.n_layers, cfg.n_layers)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
