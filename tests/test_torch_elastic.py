"""Elastic membership in the port's HogwildSim, against the JAX package's.

Under the reference's schedule (``tests/test_membership.py:242``: slot 1
fails, rejoins, then a spare slot 3 joins) every algorithm trains in the
port as in the JAX package, on both engines and in both modes, and the
port's flat engine agrees with its own tree oracle. The contracts of the
reference's elastic tests (``tests/test_membership.py:271-341``) hold too: a
dead slot is bitwise frozen, an all-dead cohort survives, ``avg_sync_gap``
counts live iterations only, and the capacity is allocated once.

As in ``tests/test_torch_sim.py``, the port starts from the JAX sim's
``init_state()`` and sees the JAX batches; the JAX run goes through its
Pallas kernels in interpret mode.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")

from repro import optim as joptim  # noqa: E402
from repro.configs import dlrm_ctr as jcfg  # noqa: E402
from repro.core import runners as jrunners  # noqa: E402
from repro.core import sync as jsync  # noqa: E402
from repro.data import ctr as jctr  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.core import runners, sync  # noqa: E402
from repro_torch.data import ctr  # noqa: E402

TRAJ = dict(rtol=1e-4, atol=1e-5)  # the reference's trajectory tolerance
SCHED = ((5, "fail", 1), (9, "join", 1), (11, "join", 3))
ITERS = 16
SIM = dict(n_trainers=3, n_threads=2, batch_size=32, seed=0)
ALGOS = ("bmuf", "easgd", "gossip", "ma")


def _sync_kw(algo, mode, engine):
    return dict(algo=algo, mode=mode, gap=4, alpha=0.5, delay=1, engine=engine)


def _np(tree):
    return jax.tree.map(np.array, tree)


@functools.lru_cache(maxsize=None)
def _jax_run(algo, mode, engine):
    sim = jrunners.HogwildSim(jcfg.tiny(), jsync.SyncConfig(**_sync_kw(algo, mode, engine)),
                              optimizer=joptim.adagrad(0.02), schedule=list(SCHED), **SIM)
    st0 = sim.init_state()
    init = (_np(st0.w_stack), _np(st0.opt_stack), _np(st0.emb_state), _np(st0.algo_state))
    out = sim.run(ITERS, state=st0)
    st = out["state"]
    final = (_np(st.w_stack), _np(st.emb_state), _np(st.algo_state))
    events = [(e.kind, e.slot) for e in out["membership_events"]]
    return (init, out["train_loss"], out["replica_losses"], out["sync_count"],
            out["avg_sync_gap"], final, events)


@pytest.fixture
def jax_stream(monkeypatch):
    """Point the port's data stream at the JAX package's batches."""
    monkeypatch.setattr(ctr, "make_teacher",
                        lambda cfg, seed=0, k=8, device=None: jctr.make_teacher(cfg, seed=seed, k=k))
    monkeypatch.setattr(ctr, "gen_batch", lambda cfg, teacher, seed, i, n: {
        k: torch.from_numpy(np.array(v)) for k, v in jctr.gen_batch(cfg, teacher, seed, i, n).items()})


def _port_sim(algo, mode, engine, **kw):
    kw = {**SIM, **kw}
    return runners.HogwildSim(dlrm_ctr.tiny(), sync.SyncConfig(**_sync_kw(algo, mode, engine)),
                              optimizer=optim.adagrad(0.02), device="cpu", **kw)


def _close(port_tree, jax_tree, **tol):
    a_leaves = [x for x in T.leaves(port_tree) if x is not None]  # MA's state is None
    b_leaves = jax.tree.leaves(jax_tree)
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        np.testing.assert_allclose(np.asarray(a), b, **tol)


@pytest.mark.parametrize("engine", ["flat", "pytree"])
@pytest.mark.parametrize("mode", ["shadow", "fixed_rate"])
@pytest.mark.parametrize("algo", ALGOS)
def test_elastic_sim_matches_jax(jax_stream, algo, mode, engine):
    init, j_loss, j_rl, j_syncs, j_gap, (j_w, j_emb, j_state), j_events = _jax_run(
        algo, mode, engine)
    sim = _port_sim(algo, mode, engine, schedule=list(SCHED))
    assert sim.R == 4  # capacity includes the spare slot 3
    st0 = interop.sim_state_from_numpy(*init, step=0, device="cpu", algo=algo)
    out = sim.run(ITERS, state=st0)
    np.testing.assert_allclose(out["train_loss"], j_loss, **TRAJ)
    np.testing.assert_allclose(out["replica_losses"], j_rl, **TRAJ)
    assert out["replica_losses"].shape == (ITERS, 4)
    assert out["sync_count"] == j_syncs > 0
    assert out["avg_sync_gap"] == j_gap
    assert [(e.kind, e.slot) for e in out["membership_events"]] == j_events
    st = out["state"]
    _close(st.w_stack, j_w, **TRAJ)
    _close(st.emb_state, j_emb, **TRAJ)
    _close(st.algo_state, j_state, **TRAJ)


@functools.lru_cache(maxsize=None)
def _port_elastic(algo, engine, mode):
    sim = _port_sim(algo, mode, engine, schedule=list(SCHED))
    out = sim.run(ITERS)
    return out, sim


@pytest.mark.parametrize("mode", ["shadow", "fixed_rate"])
@pytest.mark.parametrize("algo", ALGOS)
def test_elastic_flat_matches_pytree(algo, mode):
    """The reference's contract (tests/test_membership.py:257-268) inside the
    port: under SCHED the flat engine's kernel path trains what the tree
    oracle trains."""
    of, sf = _port_elastic(algo, "flat", mode)
    op, sp = _port_elastic(algo, "pytree", mode)
    assert of["sync_count"] == op["sync_count"] > 0
    np.testing.assert_allclose(of["train_loss"], op["train_loss"], **TRAJ)
    for i in range(4):
        for a, b in zip(T.leaves(sf.replica_params(of["state"], i)),
                        T.leaves(sp.replica_params(op["state"], i))):
            torch.testing.assert_close(a, b, **TRAJ)


@pytest.mark.parametrize("algo", ALGOS)
def test_dead_slot_frozen_while_dead(algo):
    """After fail(1)@5 the dead slot's replica and optimizer state are
    bitwise frozen: no training update, no sync landing."""
    sim = _port_sim(algo, "shadow", "flat", schedule=[(5, "fail", 1)])
    st = sim.init_state()
    seen = {}

    def watch(t, _loss):
        if t in (5, 7):  # the fail applies at the start of iteration 5
            seen[t] = (sim.membership.active_mask().copy(), st.w_stack[1].clone(),
                       T.map(lambda x: x[1].clone(), st.opt_stack))

    out = sim.run(8, state=st, on_iter=watch)
    (m5, w5, o5), (m7, w7, o7) = seen[5], seen[7]
    assert not m5[1] and not m7[1]
    assert torch.equal(w5, w7)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(o5), T.leaves(o7)))
    assert out["sync_count"] > 0
    assert not torch.equal(st.w_stack[0], w5)  # the live slots kept training


@pytest.mark.parametrize("mode", ["shadow", "fixed_rate"])
def test_all_dead_cohort_survives(mode):
    """Killing every slot mid-run reaches no kernel with an empty row set:
    training becomes a no-op, losses go nan, syncs stop."""
    sim = _port_sim("ma", mode, "flat", n_trainers=2, schedule=[(3, "fail", 0), (3, "fail", 1)])
    sim.sync_cfg = sync.SyncConfig(**{**_sync_kw("ma", mode, "flat"), "gap": 2})
    out = sim.run(7)
    assert np.isfinite(out["train_loss"][:3]).all()
    assert np.isnan(out["train_loss"][3:]).all()
    assert out["examples"] == 3 * 2 * 2 * 32  # dead-window iterations train nothing


def test_avg_sync_gap_counts_live_iterations_only():
    sim = runners.HogwildSim(dlrm_ctr.tiny(), sync.SyncConfig(algo="ma", mode="fixed_rate", gap=2),
                             n_trainers=2, n_threads=1, batch_size=32,
                             optimizer=optim.adagrad(0.02), seed=0, schedule=[(2, "fail", 1)],
                             device="cpu")
    out = sim.run(10)
    live_iters = out["examples"] // 32  # M=1, B=32
    assert live_iters == 2 * 2 + 8 * 1
    assert out["avg_sync_gap"] == pytest.approx(live_iters / out["sync_count"])


def test_capacity_padding_no_reallocation():
    """Capacity R_max is allocated once: the join of a spare slot keeps every
    buffer's replica dim."""
    sim = _port_sim("ma", "shadow", "flat", n_trainers=2, schedule=[(3, "join", 2)])
    assert sim.R == 3
    st = sim.init_state()
    assert st.w_stack.shape[0] == 3
    out = sim.run(6, state=st)
    assert out["state"].w_stack.shape[0] == 3
    assert all(x.shape[0] == 3 for x in T.leaves(out["state"].opt_stack))
    assert sim.membership.n_active == 3


@pytest.mark.parametrize("engine", ["flat", "pytree"])
def test_join_bootstraps_from_the_live_mean(engine):
    """A join under MA bootstraps the joiner from the live replicas' mean
    (the base ``on_join``), with a fresh optimizer slot."""
    sim = _port_sim("ma", "shadow", engine, schedule=[(4, "join", 3)])
    st = sim.init_state()
    seen = {}
    orig = sim._apply_membership_event

    def spy(st_, kind, slot):
        before = [sim.replica_params(st_, i) for i in range(3)]
        st_ = orig(st_, kind, slot)
        seen["before"], seen["after"] = before, sim.replica_params(st_, slot)
        seen["opt"] = T.map(lambda x: x[slot], st_.opt_stack)
        return st_

    sim._apply_membership_event = spy
    sim.run(6, state=st)
    for k, leaf in enumerate(T.leaves(seen["after"])):
        want = torch.stack([T.leaves(b)[k] for b in seen["before"]]).float().mean(0)
        torch.testing.assert_close(leaf, want, rtol=1e-6, atol=1e-7)
    assert all(torch.equal(x, torch.zeros_like(x)) for x in T.leaves(seen["opt"]))


def test_membership_options_accepted():
    m = runners.Membership(2, R_max=3)
    sim = _port_sim("gossip", "shadow", "flat", n_trainers=2, membership=m)
    assert sim.R == 3 and sim.membership is m
    out = sim.run(2)
    assert out["replica_losses"].shape == (2, 3) and np.isfinite(out["train_loss"]).all()
    with pytest.raises(ValueError, match="capacity"):
        _port_sim("ma", "shadow", "flat", n_trainers=3, membership=runners.Membership(2, R_max=2))


def test_no_schedule_runs_are_not_elastic():
    out = _port_sim("easgd", "shadow", "flat").run(3)
    assert "replica_losses" not in out and "membership_events" not in out
