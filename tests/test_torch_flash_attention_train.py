"""K9's training form on the card: the bf16 forward with its log-sum-exp and
the hand-written backward (``attention_train_op``), held against the plain
path of ``models/layers.py`` in f32 on the same bf16 inputs.

These need a CUDA card and nvcc, and skip elsewhere. Run them on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_flash_attention_train.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores

from repro_torch import optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    attention_train_bwd, attention_train_op, gqa_attention_op)
from repro_torch.models import layers  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator().manual_seed(0)


def _inputs(gen, b, s, h, kv, d):
    q = torch.randn((b, s, h, d), generator=gen).to("cuda", torch.bfloat16)
    k, v = (torch.randn((b, s, kv, d), generator=gen).to("cuda", torch.bfloat16)
            for _ in range(2))
    dout = torch.randn((b, s, h, d), generator=gen).to("cuda", torch.bfloat16)
    return q, k, v, dout


def _plain(q, k, v, dout, causal):
    """Output and (dq, dk, dv) of the plain path (``_sdpa_block``, KV heads
    repeated) in ``q``'s dtype, by autograd; k and v's gradients summed back
    over their query heads."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    n_rep = q.shape[2] // k.shape[2]
    s = q.shape[1]
    pos = torch.arange(s, device=q.device)
    mask = pos[:, None] >= pos[None, :] if causal else None
    out = layers._sdpa_block(q, layers._repeat_kv(k, n_rep), layers._repeat_kv(v, n_rep),
                             mask, q.shape[-1] ** -0.5)
    out.backward(dout.to(out.dtype))
    return out.detach(), q.grad, k.grad, v.grad


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


# minicpm-2b's training shape; d = 128 with GQA; whisper's 1,500 frames over
# every key (not a multiple of a tile); the benchmark's s512 traffic
CASES = {"minicpm_s2048": (4, 2048, 36, 36, 64, True),
         "d128_gqa": (2, 1024, 32, 8, 128, True),
         "s1500_every_key": (2, 1500, 8, 8, 64, False),
         "s512_b16": (16, 512, 36, 36, 64, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_training_attention_follows_the_plain_path_in_f32(gen, case):
    """Output and the gradients of q, k and v within 1e-2 of the f32 plain
    path in the relative norm, and each no further from it than the plain
    path run in bf16 (the port's training form before the kernels) is, with
    a third of room: the kernels round p and ds to bf16 where the plain
    path's autograd does, and keep s, dp and every sum in f32."""
    b, s, h, kv, d, causal = CASES[case]
    q, k, v, dout = _inputs(gen, b, s, h, kv, d)
    fwd, bwd = attention_train_op.launches, attention_train_bwd.launches
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = attention_train_op(qg, kg, vg, causal=causal)
    out.backward(dout)
    assert (attention_train_op.launches, attention_train_bwd.launches) == (fwd + 1, bwd + 1)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    got = (out.detach(), qg.grad, kg.grad, vg.grad)
    want = _plain(q.float(), k.float(), v.float(), dout.float(), causal)
    low = _plain(q, k, v, dout, causal)
    torch.cuda.synchronize()
    for name, g, w, lo in zip(("out", "dq", "dk", "dv"), got, want, low):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        err, err_low = _rel(g, w), _rel(lo, w)
        assert err <= 1e-2, (name, err, err_low)
        assert err <= 1.33 * err_low + 1e-4, (name, err, err_low)


@pytest.mark.parametrize("s", [33, 64, 127, 129, 300])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_training_attention_edges(gen, s, n_rep, d, causal):
    """The kernels' edges: S about their 64- and 128-row tiles (rows and
    keys past S are TMA's zero fill, masked; the log-sum-exp and delta of
    padded rows), GQA, both head dims, causal or not: within 1e-2 of the
    f32 plain path in the relative norm (a masking fault reads O(1))."""
    q, k, v, dout = _inputs(gen, 2, s, 2 * n_rep, 2, d)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = attention_train_op(qg, kg, vg, causal=causal)
    out.backward(dout)
    got = (out.detach(), qg.grad, kg.grad, vg.grad)
    want = _plain(q.float(), k.float(), v.float(), dout.float(), causal)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= 1e-2, (name, _rel(g, w))


def test_training_attention_gradients_repeat_bitwise(gen):
    """No atomics: the same backward twice gives the same bits."""
    q, k, v, dout = _inputs(gen, 2, 700, 16, 4, 64)
    grads = []
    for _ in range(2):
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        attention_train_op(qg, kg, vg, causal=True).backward(dout)
        grads.append((qg.grad, kg.grad, vg.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_one_lm_training_step_launches_the_kernels(gen):
    """One shadow training step of a reduced minicpm-2b in bf16 (L layers,
    R replicas, each unit rematerialised): 2 L R forward launches (the
    forward and the unit's recompute) and L R backward launches; the
    prefill kernel never; a finite loss."""
    from repro_torch.core import spmd
    from repro_torch.data import tokens

    cfg = dataclasses.replace(reduced(get_config("minicpm-2b")), dtype="bfloat16")
    L, R = cfg.n_layers, 2
    params = spmd.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    stack = spmd.stack_replicas(T.map(lambda x: x.cuda(), params), R)
    trans = tokens.make_transition(cfg.vocab_size, seed=0)
    toks = tokens.gen_batch(trans, 0, 0, R * 2, 256)["tokens"].reshape(R, 2, 256).cuda()
    opt = optim.sgd(0.1)
    step = spmd.make_train_step(cfg, opt, "shadow")
    before = (attention_train_op.launches, attention_train_bwd.launches,
              gqa_attention_op.launches)
    stack, _, loss = step(stack, (), {"tokens": toks})
    torch.cuda.synchronize()
    after = (attention_train_op.launches, attention_train_bwd.launches,
             gqa_attention_op.launches)
    assert [a - b for a, b in zip(after, before)] == [2 * L * R, L * R, 0]
    assert torch.isfinite(loss.float()).all()
