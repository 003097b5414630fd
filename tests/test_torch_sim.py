"""The port's HogwildSim against the JAX package's, iteration by iteration.

Both start from the JAX sim's ``init_state()`` (carried across with
``repro_torch.interop``) and see the same batches: the port's
``data.ctr.gen_batch`` / ``make_teacher`` are monkeypatched to call the JAX
stream and convert it. The JAX run goes through its Pallas kernels in
interpret mode, as the JAX package's own tests run it on the CPU.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
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

# The reference's own trajectory tolerance (tests/test_flatspace.py:233):
# two fp32 programs that sum in different orders drift by ~1e-6 over 12 steps.
TRAJ = dict(rtol=1e-4, atol=1e-5)
ITERS = 12
SIM = dict(n_trainers=3, n_threads=2, batch_size=32, seed=0)


def _sync_kw(mode, engine):
    return dict(algo="easgd", mode=mode, gap=4, alpha=0.5, delay=1, engine=engine)


def _np(tree):
    return jax.tree.map(np.array, tree)


@functools.lru_cache(maxsize=None)
def _jax_run(mode, engine):
    sim = jrunners.HogwildSim(jcfg.tiny(), jsync.SyncConfig(**_sync_kw(mode, engine)),
                              optimizer=joptim.adagrad(0.02), **SIM)
    st0 = sim.init_state()
    init = (_np(st0.w_stack), _np(st0.opt_stack), _np(st0.emb_state), _np(st0.algo_state))
    out = sim.run(ITERS, state=st0)
    st = out["state"]
    final = (_np(st.w_stack), _np(st.emb_state), _np(st.algo_state))
    ev = sim.evaluate(st, n_batches=2, batch_size=256)
    return init, out["train_loss"], out["sync_count"], out["avg_sync_gap"], final, ev


@pytest.fixture
def jax_stream(monkeypatch):
    """Point the port's data stream at the JAX package's batches."""
    monkeypatch.setattr(ctr, "make_teacher",
                        lambda cfg, seed=0, k=8, device=None: jctr.make_teacher(cfg, seed=seed, k=k))
    monkeypatch.setattr(ctr, "gen_batch", lambda cfg, teacher, seed, i, n: {
        k: torch.from_numpy(np.array(v)) for k, v in jctr.gen_batch(cfg, teacher, seed, i, n).items()})


def _port_run(mode, engine, init):
    sim = runners.HogwildSim(dlrm_ctr.tiny(), sync.SyncConfig(**_sync_kw(mode, engine)),
                             optimizer=optim.adagrad(0.02), device="cpu", **SIM)
    st0 = interop.sim_state_from_numpy(*init, step=0, device="cpu")
    out = sim.run(ITERS, state=st0)
    ev = sim.evaluate(out["state"], n_batches=2, batch_size=256)
    return out, ev


def _close(port_tree, jax_tree, **tol):
    for a, b in zip(T.leaves(port_tree), jax.tree.leaves(jax_tree)):
        np.testing.assert_allclose(a.numpy(), b, **tol)


@pytest.mark.parametrize("engine", ["flat", "pytree"])
@pytest.mark.parametrize("mode", ["shadow", "fixed_rate"])
def test_sim_matches_jax(jax_stream, mode, engine):
    init, j_loss, j_syncs, j_gap, (j_w, j_emb, j_ps), j_ev = _jax_run(mode, engine)
    out, ev = _port_run(mode, engine, init)
    np.testing.assert_allclose(out["train_loss"], j_loss, **TRAJ)
    assert out["sync_count"] == j_syncs > 0
    assert out["avg_sync_gap"] == j_gap
    st = out["state"]
    _close(st.w_stack, j_w, **TRAJ)
    _close(st.emb_state, j_emb, **TRAJ)
    _close(st.algo_state, j_ps, **TRAJ)
    np.testing.assert_allclose(ev, j_ev, **TRAJ)


@pytest.mark.parametrize("mode", ["shadow", "fixed_rate"])
def test_sim_flat_matches_pytree(mode):
    """The port's own engines agree: the flat buffer + round kernel path and
    the tree oracle path train the same replicas."""
    runs = {}
    for engine in ("flat", "pytree"):
        sim = runners.HogwildSim(dlrm_ctr.tiny(), sync.SyncConfig(**_sync_kw(mode, engine)),
                                 optimizer=optim.adagrad(0.02), device="cpu", **SIM)
        out = sim.run(ITERS)
        runs[engine] = (out, sim.replica_params(out["state"], 1))
    (of, wf), (op, wp) = runs["flat"], runs["pytree"]
    np.testing.assert_allclose(of["train_loss"], op["train_loss"], **TRAJ)
    assert of["sync_count"] == op["sync_count"]
    for a, b in zip(T.leaves(wf), T.leaves(wp)):
        torch.testing.assert_close(a, b, **TRAJ)
