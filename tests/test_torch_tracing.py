"""The port's spans (``repro_torch/tracing.py``) on the CPU.

Off (the default) no span is made: the sim and the LM steps run with the
profiler's ranges and CUDA events made to raise. On, a tiny ``HogwildSim``
reports one ``sim.iter`` an iteration with its phases inside it in host
time, and a tiny LM step under the unit remat and the chunk remat reports
``attn.fwd`` twice and ``attn.bwd`` once a layer and replica; collection
leaves every loss and parameter bitwise as it was. Under
``torch.profiler`` the spans are host ranges among the aten operations,
and under lockdep the collection's lock is clean.
"""
import dataclasses
import weakref

import pytest

torch = pytest.importorskip("torch")

from repro_torch import optim, tracing  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.analysis import lockdep  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core import spmd  # noqa: E402
from repro_torch.core.runners import HogwildSim  # noqa: E402
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.models import layers  # noqa: E402

SIM_SPANS = ("sim.iter", "sim.lookup", "sim.dense", "sim.update", "sim.loss_wait",
             "sim.launch", "sim.land")
LM_SPANS = ("train.step", "train.fwd_bwd", "train.optim", "attn.fwd", "attn.bwd")
R, B, S = 2, 2, 64


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One thread: the CPU's embedding backward sums rows in the order its
    threads finish, so two plain steps differ in the last bit on more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(**kw):
    return HogwildSim(dlrm_ctr.tiny(), SyncConfig(algo="easgd", gap=3, delay=1), n_trainers=2,
                      n_threads=2, batch_size=8, optimizer=optim.adagrad(0.02), device="cpu",
                      **kw)


def _lm():
    """A reduced minicpm-2b (2 layers, f32) stacked R times, Adam, its
    shadow train step, an EASGD sync step and one batch."""
    cfg = dataclasses.replace(reduced(get_config("minicpm-2b")), dtype="float32")
    opt = optim.make("adam", 1e-3)
    params = spmd.init_params(cfg, torch.Generator().manual_seed(0))
    sc = SyncConfig(algo="easgd", alpha=0.5).validate()
    from repro_torch.core import algorithms

    state = {"stack": spmd.stack_replicas(params, R),
             "opt": spmd.stack_replicas(opt.init(params), R),
             "algo": algorithms.get("easgd").init_state(params, sc)}
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (R, B, S), generator=gen)
    return cfg, state, spmd.make_train_step(cfg, opt, "shadow"), spmd.make_sync_step(cfg, sc), {
        "tokens": tokens}


def _lm_steps(n_steps=1, sync=True):
    cfg, state, step, sync_step, batch = _lm()
    losses = []
    for _ in range(n_steps):
        state["stack"], state["opt"], loss = step(state["stack"], state["opt"], batch)
        losses.append(loss)
    if sync:
        state["stack"], state["algo"] = sync_step(state["stack"], state["algo"])
    return cfg, state, losses


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(T.leaves(a), T.leaves(b)))


def test_off_makes_no_span(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("a span was made outside a collection")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(tracing._Span, "__init__", boom)
    out = _sim().run(7)
    assert len(out["train_loss"]) == 7 and out["sync_count"] > 0
    _, _, losses = _lm_steps()
    assert torch.isfinite(losses[0]).all()
    assert tracing.span("sim.iter") is tracing.span("attn.fwd")  # the one shared no-op


def test_sim_spans_count_nest_and_leave_the_losses_bitwise():
    n = 9
    plain = _sim().run(n)
    with tracing.collect() as spans:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            got = _sim().run(n)
    rep = spans.report()
    assert got["train_loss"] == plain["train_loss"]
    assert _equal_trees(got["state"].w_stack, plain["state"].w_stack)
    assert torch.equal(got["state"].emb_state["table"], plain["state"].emb_state["table"])
    assert set(rep) == set(SIM_SPANS)
    for name in ("sim.iter", "sim.lookup", "sim.dense", "sim.update", "sim.loss_wait"):
        assert rep[name]["count"] == n, name
    assert rep["sim.land"]["count"] == rep["sim.launch"]["count"] - 1  # the last in flight
    assert all(r["stream_s"] is None and r["host_s"] >= 0 for r in rep.values())
    # every phase inside an iteration, in host time
    ranges = {}
    for e in prof.events():
        if e.name in SIM_SPANS:
            ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    iters = ranges["sim.iter"]
    assert len(iters) == n
    for name in SIM_SPANS[1:]:
        assert len(ranges[name]) == rep[name]["count"]
        for a, b in ranges[name]:
            assert any(s <= a and b <= e for s, e in iters), name
    assert sum(rep[k]["host_s"] for k in SIM_SPANS[1:]) <= rep["sim.iter"]["host_s"]


def test_lm_spans_under_unit_and_chunk_remat_and_params_bitwise(monkeypatch):
    monkeypatch.setattr(layers, "Q_CHUNK", S // 4)  # four recomputed query chunks
    cfg, plain, plain_losses = _lm_steps(n_steps=2)
    with tracing.collect() as spans:
        _, got, losses = _lm_steps(n_steps=2)
    rep = spans.report()
    assert all(torch.equal(a, b) for a, b in zip(losses, plain_losses))
    assert _equal_trees(got["stack"], plain["stack"]) and _equal_trees(got["opt"], plain["opt"])
    assert _equal_trees(got["algo"], plain["algo"])
    L, steps = cfg.n_layers, 2
    assert rep["train.step"]["count"] == steps
    assert rep["train.fwd_bwd"]["count"] == rep["train.optim"]["count"] == R * steps
    assert rep["attn.fwd"]["count"] == 2 * L * R * steps  # the forward and the unit's recompute
    assert rep["attn.bwd"]["count"] == L * R * steps
    assert rep["train.sync"]["count"] == 1
    assert rep["attn.bwd"]["host_s"] < rep["train.fwd_bwd"]["host_s"]


def test_attn_bwd_opens_and_closes_once_a_layer_and_replica(monkeypatch):
    """Each backward bracket closes before the next opens: the hooks of
    one attention's backward pass fire in between, the chunk recompute
    among them."""
    monkeypatch.setattr(layers, "Q_CHUNK", S // 2)
    log = []
    enter, exit_ = tracing._Span.__enter__, tracing._Span.__exit__

    def logged_enter(self):
        log.append(("open", self._name))
        return enter(self)

    def logged_exit(self, *exc):
        log.append(("close", self._name))
        return exit_(self, *exc)

    monkeypatch.setattr(tracing._Span, "__enter__", logged_enter)
    monkeypatch.setattr(tracing._Span, "__exit__", logged_exit)
    with tracing.collect():
        cfg, _, _ = _lm_steps(n_steps=1, sync=False)
    bwd = [kind for kind, name in log if name == "attn.bwd"]
    assert bwd == ["open", "close"] * (cfg.n_layers * R)


def test_spans_are_host_ranges_in_the_profile():
    with tracing.collect():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _lm_steps(n_steps=1)
    names = {e.name for e in prof.events()}
    assert set(LM_SPANS) | {"train.sync"} <= names
    assert any(n.startswith("aten::") for n in names)


def test_collection_is_clean_under_lockdep():
    with lockdep.instrument() as graph:
        with tracing.collect() as spans:
            _lm_steps(n_steps=1, sync=False)
            _sim().run(4)
        spans.report()
    graph.assert_clean()


def test_collections_do_not_nest_and_backward_span_needs_a_gradient():
    with tracing.collect():
        with pytest.raises(RuntimeError, match="already on"):
            with tracing.collect():
                pass
        x = torch.ones(3)
        tracing.backward_span("b", x * 2, (x,))  # nothing needs a gradient: no hook
    with tracing.collect() as spans:
        with tracing.span("a"):
            pass
    assert tracing._collector is None
    assert spans.report() == {"a": {"count": 1, "host_s": pytest.approx(0.0, abs=1.0),
                                    "stream_s": None}}


def test_backward_span_keeps_no_tensor_alive():
    """A rematerialised block frees its inputs after the forward; the
    hooks must not hold them (at full size, q, k and v of every layer)."""
    x = torch.ones(4, requires_grad=True)
    with tracing.collect() as spans:
        t = x * 2.0
        out = t + 1.0  # saves nothing of t
        tracing.backward_span("b", out, (t,))
        gone = weakref.ref(t)
        del t
        assert gone() is None
        out.sum().backward()
    assert spans.report()["b"]["count"] == 1
    assert torch.equal(x.grad, torch.full((4,), 2.0))


class _FakeEvent:
    def __init__(self, done, t):
        self.done, self.t = done, t

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def test_pending_pairs_are_swept_without_waiting(monkeypatch):
    """Past ``PENDING_MAX`` unresolved pairs, the finished ones are resolved
    by ``query()``; the unfinished stay for ``report``."""
    monkeypatch.setattr(tracing, "PENDING_MAX", 3)
    c = tracing.Collector(events=True)
    c._add("x", 0.1, _FakeEvent(True, 0.0), _FakeEvent(True, 0.5))
    c._add("x", 0.1, _FakeEvent(True, 1.0), _FakeEvent(False, 3.0))
    assert len(c._pending) == 2 and c._agg["x"][2] == 0.0
    c._add("y", 0.2, _FakeEvent(True, 0.0), _FakeEvent(True, 0.25))
    assert len(c._pending) == 1
    assert c._agg["x"] == [2, pytest.approx(0.2), pytest.approx(0.5)]
    assert c._agg["y"] == [1, pytest.approx(0.2), pytest.approx(0.25)]
    c._resolve(wait=True)
    assert c._pending == [] and c._agg["x"][2] == pytest.approx(2.5)
