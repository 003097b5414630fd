"""The port's sync math (``core/sync.py``) and algorithm hooks
(``core/algorithms.py``) against the JAX package's, on the same inputs.

Every hook a runner calls is held here for EASGD, MA, BMUF and Gossip, on
both engines: the tree oracle ``land``, the membership-aware
``land_elastic``, the flat engine's ``launch_snapshot_flat`` / ``land_flat``
with and without a live mask (a slot dies while the sync is in flight), the
join bootstrap and the threaded runner's ``make_shadow_round``. Inputs are
made from a seed with numpy; the JAX side runs its Pallas kernels in
interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import algorithms as jalg  # noqa: E402
from repro.core import flatspace as jflat  # noqa: E402
from repro.core import sync as jsync  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.core import algorithms as talg  # noqa: E402
from repro_torch.core import flatspace as tflat  # noqa: E402
from repro_torch.core import sync as tsync  # noqa: E402
from repro_torch.kernels.ma_update import ops as ma_ops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)  # the reference's kernel tolerance
ALGOS = ["bmuf", "easgd", "gossip", "ma"]
R = 4
BLOCK = 8
# launch-time live set, landing-time live set (slot 2 died in flight)
LAUNCH_ACTIVE = np.array([True, False, True, True])
ACTIVE = np.array([True, False, False, True])
MASKS = {"all": None, "some": np.array([False, True, True, False]),
         "one": np.array([False, False, False, True])}


def _tree(rng, lead=()):
    return {"w": rng.standard_normal(lead + (3, 5)).astype(np.float32),
            "b": (rng.standard_normal(lead + (7,)).astype(np.float32),)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return T.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _spaces(rng):
    tree = _tree(rng)
    return jflat.FlatSpace.from_tree(_j(tree), block=BLOCK), \
        tflat.FlatSpace.from_tree(_t(tree), block=BLOCK)


def _close(port, ref, **tol):
    a = [x for x in T.leaves(port) if x is not None]  # MA's state is None
    b = jax.tree.leaves(ref)
    assert len(a) == len(b), (len(a), len(b))
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **(tol or TOL))


def _cfg(algo, **kw):
    kw = {"algo": algo, "alpha": 0.4, "block_momentum": 0.6, "nesterov": True, "eta": 0.9, **kw}
    return jsync.SyncConfig(**kw), tsync.SyncConfig(**kw)


def _states(algo, rng, like):
    """(jax state, port state) of ``algo`` shaped as ``like`` (a plane or a
    tree), made from numpy draws."""
    if algo == "easgd":
        s = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), like)
        return _j(s), interop.algo_state_from_numpy("easgd", s)
    if algo == "bmuf":
        wg = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), like)
        vel = jax.tree.map(lambda x: 0.1 * rng.standard_normal(x.shape).astype(np.float32), like)
        return jsync.BMUFState(w_global=_j(wg), velocity=_j(vel)), \
            interop.algo_state_from_numpy("bmuf", {"w_global": wg, "velocity": vel})
    if algo == "gossip":
        return jnp.asarray(3, jnp.int32), interop.algo_state_from_numpy("gossip", np.int32(3))
    return None, None


# ---------------------------------------------------------------------------
# core/sync.py
# ---------------------------------------------------------------------------

def test_tree_map_over_bmuf_state_gives_bmuf_state():
    st = tsync.BMUFState(w_global={"a": torch.ones(2), "b": (torch.zeros(3),)},
                         velocity={"a": torch.ones(2), "b": (torch.ones(3),)})
    out = T.map(lambda x: x * 2, st)
    assert isinstance(out, tsync.BMUFState)
    assert len(T.leaves(st)) == 4 and T.leaves(st)[0] is st.w_global["a"]
    assert torch.equal(out.velocity["b"][0], torch.full((3,), 2.0))
    assert T.unflatten(st, T.leaves(out)).w_global["a"].tolist() == [2.0, 2.0]


ELASTIC_CASES = {"plain": (None, None), "active": (LAUNCH_ACTIVE, None),
                 "active+land": (LAUNCH_ACTIVE, ACTIVE)}


@pytest.mark.parametrize("case", list(ELASTIC_CASES))
def test_ma_round_matches_jax(case):
    active, land_active = ELASTIC_CASES[case]
    rng = np.random.default_rng(1)
    stack, snap = _tree(rng, (R,)), _tree(rng, (R,))
    ja = None if active is None else jnp.asarray(active)
    jl = None if land_active is None else jnp.asarray(land_active)
    want = jsync.ma_round(_j(stack), 0.3, snapshot=_j(snap), active=ja, land_active=jl)
    got = tsync.ma_round(_t(stack), 0.3, snapshot=_t(snap), active=active,
                         land_active=land_active)
    _close(got, want)
    if active is not None:  # rows dead at landing are untouched
        dead = np.flatnonzero(~(active if land_active is None else land_active))
        for x, y in zip(T.leaves(got), T.leaves(_t(stack))):
            assert torch.equal(x[dead], y[dead])


@pytest.mark.parametrize("case", list(ELASTIC_CASES))
@pytest.mark.parametrize("bm,nesterov,scale_n", [(0.0, False, False), (0.8, True, False),
                                                 (0.5, False, True)])
def test_bmuf_round_matches_jax(case, bm, nesterov, scale_n):
    active, land_active = ELASTIC_CASES[case]
    rng = np.random.default_rng(2)
    stack, snap, wg, vel = _tree(rng, (R,)), _tree(rng, (R,)), _tree(rng), _tree(rng)
    kw = dict(eta=0.9, block_momentum=bm, nesterov=nesterov, step_scale_n=scale_n)
    want = jsync.bmuf_round(
        _j(stack), jsync.BMUFState(w_global=_j(wg), velocity=_j(vel)), 0.5, snapshot=_j(snap),
        active=None if active is None else jnp.asarray(active),
        land_active=None if land_active is None else jnp.asarray(land_active), **kw)
    got = tsync.bmuf_round(_t(stack), tsync.BMUFState(w_global=_t(wg), velocity=_t(vel)), 0.5,
                           snapshot=_t(snap), active=active, land_active=land_active, **kw)
    assert isinstance(got[1], tsync.BMUFState)
    _close(got, want)


def test_masked_replica_mean_matches_jax():
    rng = np.random.default_rng(3)
    stack = _tree(rng, (R,))
    want = jsync.masked_replica_mean(_j(stack), jnp.asarray(LAUNCH_ACTIVE))
    _close(tsync.masked_replica_mean(_t(stack), LAUNCH_ACTIVE), want)


# ---------------------------------------------------------------------------
# core/algorithms.py: tree engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("algo", ALGOS)
def test_land_matches_jax(algo, mask):
    rng = np.random.default_rng(10)
    stack, snap = _tree(rng, (R,)), _tree(rng, (R,))
    js, ts = _states(algo, rng, _tree(rng))
    jc, tc = _cfg(algo)
    m = MASKS[mask]
    want = jalg.get(algo).land(_j(stack), js, _j(snap), None if m is None else jnp.asarray(m), jc)
    got = talg.get(algo).land(_t(stack), ts, _t(snap), m, tc)
    _close(got, want)


@pytest.mark.parametrize("launch", ["same", "died_in_flight"])
@pytest.mark.parametrize("algo", ALGOS)
def test_land_elastic_matches_jax(algo, launch):
    rng = np.random.default_rng(11)
    stack, snap = _tree(rng, (R,)), _tree(rng, (R,))
    js, ts = _states(algo, rng, _tree(rng))
    jc, tc = _cfg(algo)
    mask = np.array([True, False, True, False])
    la = None if launch == "same" else LAUNCH_ACTIVE
    want = jalg.get(algo).land_elastic(_j(stack), js, _j(snap), mask, ACTIVE, jc,
                                       launch_active=la)
    got = talg.get(algo).land_elastic(_t(stack), ts, _t(snap), mask, ACTIVE, tc,
                                      launch_active=la)
    _close(got, want)
    for x, y in zip(T.leaves(got[0]), T.leaves(_t(stack))):  # dead rows untouched
        assert torch.equal(x[[1, 2]], y[[1, 2]])


@pytest.mark.parametrize("algo", ALGOS)
def test_on_join_matches_jax(algo):
    rng = np.random.default_rng(12)
    stack = _tree(rng, (R,))
    js, ts = _states(algo, rng, _tree(rng))
    jc, tc = _cfg(algo)
    active = np.array([True, False, True, False])
    want = jalg.get(algo).on_join(_j(stack), 3, js, jnp.asarray(active), jc)
    got = talg.get(algo).on_join(_t(stack), 3, ts, active, tc)
    _close(got, want)


# ---------------------------------------------------------------------------
# core/algorithms.py: flat engine
# ---------------------------------------------------------------------------

def _flat_inputs(seed, algo):
    rng = np.random.default_rng(seed)
    jfs, tfs = _spaces(rng)
    buf = rng.standard_normal((R, tfs.n_rows, 128)).astype(np.float32)
    moved = buf + 0.1 * rng.standard_normal(buf.shape).astype(np.float32)
    js, ts = _states(algo, rng, np.zeros((tfs.n_rows, 128), np.float32))
    return jfs, tfs, buf, moved, js, ts


@pytest.mark.parametrize("elastic", [False, True])
@pytest.mark.parametrize("mask", ["all", "some"])
@pytest.mark.parametrize("algo", ALGOS)
def test_flat_launch_and_land_match_jax(algo, mask, elastic):
    """Launch on one buffer, land on a moved one; elastic: slot 1 dead at
    launch, slot 2 dies in flight."""
    jfs, tfs, buf, moved, js, ts = _flat_inputs(20, algo)
    jc, tc = _cfg(algo)
    m = MASKS[mask]
    la, a = (LAUNCH_ACTIVE, ACTIVE) if elastic else (None, None)
    m_eff = m if not elastic else (LAUNCH_ACTIVE if m is None else m & LAUNCH_ACTIVE)
    jalgo, talgo = jalg.get(algo), talg.get(algo)
    j_snap = jalgo.launch_snapshot_flat(jnp.asarray(buf), m_eff, jc, jfs, js, active=la)
    t_snap = talgo.launch_snapshot_flat(torch.from_numpy(buf.copy()), m_eff, tc, tfs, ts,
                                        active=la)
    _close(t_snap, j_snap)
    want = jalgo.land_flat(jnp.asarray(moved), js, j_snap, m_eff, jc, jfs, active=a)
    t_in = torch.from_numpy(moved.copy())
    got = talgo.land_flat(t_in, ts, t_snap, m_eff, tc, tfs, active=a)
    _close(got, want)
    if elastic:
        assert torch.equal(got[0][1], t_in[1]) and np.array_equal(got[0][1].numpy(), moved[1])
        assert np.array_equal(got[0][2].numpy(), moved[2])


@pytest.mark.parametrize("elastic", [False, True])
@pytest.mark.parametrize("algo", ALGOS)
def test_flat_fixed_rate_land_matches_jax(algo, elastic):
    """``snap=None``: the fixed-rate landing syncs against the current buffer."""
    jfs, tfs, buf, _, js, ts = _flat_inputs(21, algo)
    jc, tc = _cfg(algo)
    a = ACTIVE if elastic else None
    want = jalg.get(algo).land_flat(jnp.asarray(buf), js, None, None, jc, jfs, active=a)
    got = talg.get(algo).land_flat(torch.from_numpy(buf.copy()), ts, None, None, tc, tfs,
                                   active=a)
    _close(got, want)


@pytest.mark.parametrize("algo", ALGOS)
def test_on_join_flat_matches_jax(algo):
    """MA, BMUF and Gossip bootstrap a joiner from the live mean (K5
    ``replica_mean_rows``), EASGD from its PS plane; out of place."""
    jfs, tfs, buf, _, js, ts = _flat_inputs(22, algo)
    jc, tc = _cfg(algo)
    active = np.array([True, False, True, False])
    want = jalg.get(algo).on_join_flat(jnp.asarray(buf), 3, js, active, jc, jfs)
    t_in = torch.from_numpy(buf.copy())
    got = talg.get(algo).on_join_flat(t_in, 3, ts, active, tc, tfs)
    _close(got, want)
    assert np.array_equal(t_in.numpy(), buf)
    if algo != "easgd":
        want_mean = ma_ops.replica_mean_rows_op(t_in, torch.tensor([0, 2], dtype=torch.int32))
        assert torch.equal(got[0][3], want_mean)


@pytest.mark.parametrize("algo", ALGOS)
def test_join_plane_flat_is_the_joiners_plane(algo):
    """The threaded runner's join hook gives the plane ``on_join_flat``
    writes into the joiner's slot, bitwise, as a fresh tensor: it reads
    only the live rows and aliases neither the stack nor the state."""
    _, tfs, buf, _, _, ts = _flat_inputs(23, algo)
    _, tc = _cfg(algo)
    active = np.array([True, False, True, False])
    t_in = torch.from_numpy(buf.copy())
    want, _ = talg.get(algo).on_join_flat(t_in, 3, ts, active, tc, tfs)
    plane, state = talg.get(algo).join_plane_flat(t_in, ts, active, tc, tfs)
    assert torch.equal(plane, want[3]) and state is ts
    assert np.array_equal(t_in.numpy(), buf)
    # the dead rows are never read: changing them leaves the plane as it was
    t_in[1] += 1.0
    t_in[3] += 1.0
    assert torch.equal(talg.get(algo).join_plane_flat(t_in, ts, active, tc, tfs)[0], plane)
    held = [t_in] + [x for x in T.leaves(ts) if isinstance(x, torch.Tensor)]
    assert all(plane.data_ptr() != x.data_ptr() for x in held)


@pytest.mark.parametrize("n_rep", [1, 2, 3, 4])
@pytest.mark.parametrize("engine", ["flat", "pytree"])
@pytest.mark.parametrize("algo", ["bmuf", "gossip", "ma"])
def test_make_shadow_round_matches_jax(algo, engine, n_rep):
    """The threaded runner's round on the same planes (or trees): new
    planes out, the inputs never written, the state where JAX's is."""
    rng = np.random.default_rng(30 + n_rep)
    jfs, tfs = _spaces(rng)
    if engine == "flat":
        ws = [rng.standard_normal((tfs.n_rows, 128)).astype(np.float32) for _ in range(n_rep)]
        like = np.zeros((tfs.n_rows, 128), np.float32)
    else:
        ws = [_tree(rng) for _ in range(n_rep)]
        like = ws[0]
    js, ts = _states(algo, rng, like)
    jc, tc = _cfg(algo, engine=engine)
    j_ws = [_j(w) for w in ws]
    t_ws = [_t(w) for w in ws]
    t_in = list(t_ws)
    j_state, jn = jalg.get(algo).make_shadow_round(jc, jfs if engine == "flat" else None)(
        j_ws, js)
    t_state, tn = talg.get(algo).make_shadow_round(tc, tfs if engine == "flat" else None)(
        t_ws, ts)
    assert tn == jn
    _close(t_state, j_state)
    _close(t_ws, j_ws)
    for a, b in zip(t_in, ws):  # the old planes are only read
        _close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Gossip's ring helpers, on the reference's cases (tests/test_membership.py:217-232,
# tests/test_algorithms.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R_,shift", [(4, 0), (4, 1), (5, 0), (5, 3), (6, 2), (1, 0), (2, 5)])
def test_ring_partner_matches_jax(R_, shift):
    want = np.asarray(jalg._ring_partner(R_, jnp.int32(shift)))
    assert talg._ring_partner(R_, shift).tolist() == want.tolist()
    assert talg._ring_partner_np(R_, shift) == jalg._ring_partner_np(R_, shift)


@pytest.mark.parametrize("shift", [0, 1, 2])
def test_ring_partner_active_matches_jax(shift):
    active = np.asarray([True, False, True, True, False, True])
    partner = talg._ring_partner_active_np(active, shift)
    assert partner == jalg._ring_partner_active_np(active, shift)
    for i in range(6):  # dead slots are their own partner; live partners are live
        assert partner[i] == i if not active[i] else active[partner[i]]
    for i in np.flatnonzero(active):
        assert partner[partner[i]] == i


@pytest.mark.parametrize("mask", [None, [False, False, True, False, False, False],
                                  [True, True, False, False, True, False]])
@pytest.mark.parametrize("active", [None, [True, False, True, True, False, True]])
@pytest.mark.parametrize("shift", [0, 1])
def test_gossip_participants_match_jax(mask, active, shift):
    m = None if mask is None else np.asarray(mask)
    a = None if active is None else np.asarray(active)
    got = talg._gossip_participants_np(m, 6, shift, active=a)
    assert got == tuple(jalg._gossip_participants_np(m, 6, shift, active=a))
    if a is not None:
        assert all(a[r] for r in got[0])
