"""The port's checkpoint (``repro_torch/checkpoint``) and the sim's
``save_state``/``load_state``: round trips, the error contract, elastic
restore, crash safety (generations, CRC fallback, the legacy layout), a
resume that continues the batch stream, and the on-disk format shared with
the JAX package: a checkpoint either package writes restores in the other
leaf for leaf, bitwise, for every algorithm and engine, and the two
continue from it at the trajectory tolerance.

The cross-package runs feed the port the JAX package's batches
(``ctr.gen_batch`` monkeypatched, as in ``tests/test_torch_sim.py``); the
JAX run goes through its Pallas kernels in interpret mode.
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")

from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import dlrm_ctr as jcfg  # noqa: E402
from repro.core import runners as jrunners  # noqa: E402
from repro.core import sync as jsync  # noqa: E402
from repro.data import ctr as jctr  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.core import runners, sync  # noqa: E402
from repro_torch.data import ctr  # noqa: E402

TRAJ = dict(rtol=1e-4, atol=1e-5)  # the reference's trajectory tolerance
CFG = dlrm_ctr.tiny()
SIM = dict(n_trainers=3, n_threads=2, batch_size=32, seed=0)
ALGOS = ("easgd", "ma", "bmuf", "gossip")
ENGINES = ("flat", "pytree")


def _sim(algo="easgd", engine="flat", **kw):
    kw = {**SIM, **kw}
    return runners.HogwildSim(CFG, sync.SyncConfig(algo=algo, gap=3, alpha=0.5, engine=engine),
                              optimizer=optim.adagrad(0.02), device="cpu", **kw)


def _bitwise(a, b, key=""):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype)
        assert torch.equal(a, b), key
    else:
        assert type(a) is type(b) and a == b, (key, a, b)


def _trees_bitwise(a, b):
    pa, pb = T.leaves_with_path(a), T.leaves_with_path(b)
    assert [k for k, _ in pa] == [k for k, _ in pb]
    for (k, x), (_, y) in zip(pa, pb):
        _bitwise(x, y, k)


# ---------------------------------------------------------------------------
# Round trips
# ---------------------------------------------------------------------------

def test_mixed_tree_with_bf16_bmuf_state_and_counter(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"dense": torch.randn((5, 7), generator=g).to(torch.bfloat16),
            "opt": [{"acc": torch.ones(3)}, {"acc": torch.zeros((2, 2))}],
            "bmuf": sync.BMUFState(w_global={"w": torch.arange(6, dtype=torch.float32)},
                                   velocity={"w": torch.full((6,), 0.25)}),
            "counter": 11, "none": None}
    path = str(tmp_path / "ck")
    ckpt.save(path, tree, metadata={"step": 3, "note": "hi"})
    out, meta = ckpt.restore(path, tree)
    _trees_bitwise(out, tree)
    assert out["none"] is None and isinstance(out["bmuf"], sync.BMUFState)
    assert meta == {"step": 3, "note": "hi"}
    names = json.load(open(os.path.join(ckpt.generations(path)[0], "manifest.json")))["dtypes"]
    assert names == {"bmuf/.velocity/w": "float32", "bmuf/.w_global/w": "float32",
                     "counter": "int32", "dense": "bfloat16", "opt/0/acc": "float32",
                     "opt/1/acc": "float32"}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algo", ALGOS)
def test_full_sim_state_round_trip(tmp_path, algo, engine):
    """The whole SimState (replicas, optimizer stacks, tables, the
    algorithm's state) comes back bitwise, and training continues the same."""
    sim = _sim(algo, engine)
    st = sim.run(5)["state"]
    path = str(tmp_path / "ck")
    sim.save_state(path, st)
    st2 = sim.load_state(path)
    _trees_bitwise(sim._state_tree(st2), sim._state_tree(st))
    assert st2.step == st.step == 5
    assert sim.run(3, state=st)["train_loss"] == sim.run(3, state=st2)["train_loss"]


# ---------------------------------------------------------------------------
# Error contract
# ---------------------------------------------------------------------------

def _save_simple(tmp_path):
    path = str(tmp_path / "ck")
    ckpt.save(path, {"a": torch.ones((4, 2)), "b": torch.zeros(3)})
    return path


@pytest.mark.parametrize("case", ["missing_leaf", "shape_mismatch", "non_leading_elastic"])
def test_error_contract(tmp_path, case):
    path = _save_simple(tmp_path)
    if case == "missing_leaf":
        with pytest.raises(ValueError, match=r"no leaf 'c'"):
            ckpt.restore(path, {"a": torch.ones((4, 2)), "b": torch.zeros(3),
                                "c": torch.zeros(1)})
    elif case == "shape_mismatch":
        with pytest.raises(ValueError) as ei:
            ckpt.restore(path, {"a": torch.ones((5, 2)), "b": torch.zeros(3)})
        msg = str(ei.value)
        assert "'a'" in msg and "(4, 2)" in msg and "(5, 2)" in msg
        assert not isinstance(ei.value, ckpt.CheckpointCorruptError)
    else:
        with pytest.raises(ValueError, match="only the leading"):
            ckpt.restore_elastic(path, {"a": torch.ones((4, 3)), "b": torch.zeros(3)})


def test_sim_refuses_an_engine_or_algo_mismatch(tmp_path):
    sim = _sim("easgd", "flat")
    path = str(tmp_path / "ck")
    sim.save_state(path, sim.init_state())
    for other in (_sim("easgd", "pytree"), _sim("ma", "flat")):
        with pytest.raises(ValueError, match="was saved with"):
            other.load_state(path)


# ---------------------------------------------------------------------------
# Elastic restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["grow", "shrink", "bf16_grow", "exact"])
def test_elastic_resize(tmp_path, case):
    path = str(tmp_path / "ck")
    if case == "grow":
        w = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        ckpt.save(path, {"w": w})
        out, _, resized = ckpt.restore_elastic(path, {"w": torch.zeros((4, 2))})
        assert torch.equal(out["w"][:2], w)
        assert torch.equal(out["w"][2:], torch.tensor([[2.0, 3.0], [2.0, 3.0]]))
        assert resized == {"w": ((2, 2), (4, 2))}
    elif case == "shrink":
        ckpt.save(path, {"w": torch.arange(12, dtype=torch.float32).reshape(4, 3)})
        out, _, resized = ckpt.restore_elastic(path, {"w": torch.zeros((2, 3))})
        assert torch.equal(out["w"], torch.tensor([[0.0, 1, 2], [3, 4, 5]]))
        assert "w" in resized
    elif case == "bf16_grow":
        w = torch.tensor([[1.0, 2.0], [3.0, 4.0]], dtype=torch.bfloat16)
        ckpt.save(path, {"w": w})
        out, _, _ = ckpt.restore_elastic(path, {"w": torch.zeros((3, 2), dtype=torch.bfloat16)})
        assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"][:2], w)
        assert out["w"][2].float().tolist() == [2.0, 3.0]
    else:
        t = {"w": torch.ones((3, 2)), "s": 7}
        ckpt.save(path, t)
        out, _, resized = ckpt.restore_elastic(path, t)
        _trees_bitwise(out, t)
        assert resized == {}


def test_may_resize_guards_non_replica_leaves(tmp_path):
    path = str(tmp_path / "ck")
    ckpt.save(path, {"w": torch.ones((2, 5)), "emb": torch.ones((4, 3))})
    with pytest.raises(ValueError, match="'emb'"):
        ckpt.restore_elastic(path, {"w": torch.zeros((3, 5)), "emb": torch.zeros((6, 3))},
                             may_resize=lambda k: k.startswith("w"))
    _, _, resized = ckpt.restore_elastic(path, {"w": torch.zeros((3, 5)),
                                                "emb": torch.ones((4, 3))},
                                         may_resize=lambda k: k.startswith("w"))
    assert set(resized) == {"w"}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("grow", [True, False])
def test_sim_elastic_restore_bootstraps_the_new_slot(tmp_path, engine, grow):
    """R=3 saved, restored at R=4 (EASGD): the grown slot is the sync-PS
    plane bitwise, with a fresh optimizer state; restored at R=2 the first
    two replicas come back as they were."""
    sim = _sim("easgd", engine)
    st = sim.run(4)["state"]
    path = str(tmp_path / "ck")
    sim.save_state(path, st)
    other = _sim("easgd", engine, n_trainers=4 if grow else 2)
    st2 = other.load_state(path)
    assert st2.step == 4
    if grow:
        ps = other.flat.unpack(st2.algo_state) if engine == "flat" else st2.algo_state
        _trees_bitwise(other.replica_params(st2, 3), ps)
        for x in T.leaves(sync.tree_slice(st2.opt_stack, 3)):
            assert not x.any()  # adagrad's fresh state
        k = 3
    else:
        k = 2
    for i in range(k):
        _trees_bitwise(other.replica_params(st2, i), sim.replica_params(st, i))
    assert len(other.run(2, state=st2)["train_loss"]) == 2


# ---------------------------------------------------------------------------
# Crash safety
# ---------------------------------------------------------------------------

def _tree(salt=0.0):
    return {"a": torch.full((4, 2), 1.0 + salt), "b": torch.arange(3, dtype=torch.float32) + salt}


def _corrupt_crc(path):
    mf = os.path.join(ckpt.generations(path)[0], "manifest.json")
    with open(mf) as f:
        manifest = json.load(f)
    manifest["crc32"]["a"] ^= 0xFFFF
    with open(mf, "w") as f:
        json.dump(manifest, f)


def _truncate(path):
    npz = os.path.join(ckpt.generations(path)[0], "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)


def _garbage_zip(path):
    with open(os.path.join(ckpt.generations(path)[0], "arrays.npz"), "wb") as f:
        f.write(b"PK\x03\x04" + b"\x00" * 12)


@pytest.mark.parametrize("damage,match", [(_corrupt_crc, r"'a'.*falling back"),
                                          (_truncate, "falling back"),
                                          (_garbage_zip, "falling back")])
def test_corrupt_newest_generation_falls_back(tmp_path, damage, match):
    path = str(tmp_path / "ck")
    ckpt.save(path, _tree(1.0), metadata={"i": 1})
    ckpt.save(path, _tree(2.0), metadata={"i": 2})
    damage(path)
    with pytest.warns(RuntimeWarning, match=match):
        out, meta = ckpt.restore(path, _tree())
    _trees_bitwise(out, _tree(1.0))
    assert meta == {"i": 1}


def test_generations_are_pruned_to_keep(tmp_path):
    path = str(tmp_path / "ck")
    for i in range(4):
        ckpt.save(path, _tree(float(i)), metadata={"i": i}, keep=2)
    assert [os.path.basename(g) for g in ckpt.generations(path)] == ["gen-000003", "gen-000002"]
    out, meta = ckpt.restore(path, _tree())
    _trees_bitwise(out, _tree(3.0))
    assert meta == {"i": 3}
    with pytest.raises(ValueError, match="keep"):
        ckpt.save(path, _tree(), keep=0)


def test_tmp_debris_of_a_crashed_save_is_invisible(tmp_path):
    path = str(tmp_path / "ck")
    ckpt.save(path, _tree(1.0))
    debris = os.path.join(path, ".tmp-gen-000001")
    os.makedirs(debris)
    with open(os.path.join(debris, "manifest.json"), "w") as f:
        f.write("{ torn mid-write")
    _trees_bitwise(ckpt.restore(path, _tree())[0], _tree(1.0))
    ckpt.save(path, _tree(2.0))  # reclaims the slot
    assert not os.path.exists(debris)
    _trees_bitwise(ckpt.restore(path, _tree())[0], _tree(2.0))


def test_every_generation_corrupt_raises(tmp_path):
    path = str(tmp_path / "ck")
    ckpt.save(path, _tree(1.0))
    ckpt.save(path, _tree(2.0))
    for g in ckpt.generations(path):
        with open(os.path.join(g, "manifest.json"), "w") as f:
            f.write("not json")
    with pytest.raises(ckpt.CheckpointCorruptError, match="every generation"):
        with pytest.warns(RuntimeWarning):
            ckpt.restore(path, _tree())
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ckpt.restore(str(tmp_path / "nope"), _tree())


def test_shape_mismatch_never_falls_back(tmp_path):
    path = str(tmp_path / "ck")
    ckpt.save(path, {"w": torch.ones((2, 3))})
    ckpt.save(path, {"w": torch.ones((5, 3))})
    with pytest.raises(ValueError, match="shape mismatch") as ei:
        ckpt.restore(path, {"w": torch.zeros((2, 3))})
    assert not isinstance(ei.value, ckpt.CheckpointCorruptError)


def test_legacy_flat_layout_still_restores(tmp_path):
    path = str(tmp_path / "ck")
    ckpt.save(path, _tree(7.0), metadata={"legacy": True})
    gen = ckpt.generations(path)[0]
    for name in os.listdir(gen):
        shutil.move(os.path.join(gen, name), os.path.join(path, name))
    os.rmdir(gen)
    assert ckpt.generations(path) == []
    out, meta = ckpt.restore(path, _tree())
    _trees_bitwise(out, _tree(7.0))
    assert meta == {"legacy": True} and ckpt.read_metadata(path) == {"legacy": True}


def test_resume_continues_the_batch_stream(tmp_path):
    """2N iterations straight equal N, save, load, N: the stream is not
    replayed from 0 and the step counter keeps counting."""
    def mk():
        return runners.HogwildSim(CFG, sync.SyncConfig(algo="ma", mode="fixed_rate", gap=2),
                                  optimizer=optim.adagrad(0.02), device="cpu", **SIM)

    full = mk().run(6)
    sim_a = mk()
    out_a = sim_a.run(3)
    path = str(tmp_path / "ck")
    sim_a.save_state(path, out_a["state"])
    sim_b = mk()
    out_b = sim_b.run(3, state=sim_b.load_state(path))
    assert out_b["state"].step == 6
    assert out_a["train_loss"] + out_b["train_loss"] == full["train_loss"]


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_stream(monkeypatch):
    """Point the port's data stream at the JAX package's batches."""
    monkeypatch.setattr(ctr, "make_teacher",
                        lambda cfg, seed=0, k=8, device=None: jctr.make_teacher(cfg, seed=seed, k=k))
    monkeypatch.setattr(ctr, "gen_batch", lambda cfg, teacher, seed, i, n: {
        k: torch.from_numpy(np.array(v)) for k, v in jctr.gen_batch(cfg, teacher, seed, i, n).items()})


def _jsim(algo, engine):
    return jrunners.HogwildSim(jcfg.tiny(), jsync.SyncConfig(algo=algo, gap=3, alpha=0.5,
                                                             engine=engine),
                               optimizer=joptim.adagrad(0.02), **SIM)


def _npz(path):
    gen = jckpt.generations(path)[0]
    with np.load(os.path.join(gen, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(gen, "manifest.json")) as f:
        return arrays, json.load(f)


def _port_leaves(sim, st):
    out = {}
    for k, v in T.leaves_with_path(sim._state_tree(st)):
        out[k] = np.asarray(v, np.int32) if isinstance(v, int) else v.numpy()
    return out


def test_bf16_counter_and_dataclass_leaves_cross_between_the_packages(tmp_path):
    """bf16 leaves (the JAX package's ml_dtypes bits, the port's int16
    views), a 0-d int32 counter and a dataclass's fields, both ways."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    j_tree = {"w": jnp.asarray(w, jnp.bfloat16), "n": jnp.int32(7),
              "s": jsync.BMUFState(w_global={"a": jnp.asarray(w[0])},
                                   velocity={"a": jnp.asarray(w[1])})}
    p_tree = {"w": torch.from_numpy(w).to(torch.bfloat16), "n": 7,
              "s": sync.BMUFState(w_global={"a": torch.from_numpy(w[0])},
                                  velocity={"a": torch.from_numpy(w[1])})}
    path_j, path_p = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(path_j, j_tree, metadata={"from": "jax"})
    out, meta = ckpt.restore(path_j, p_tree)
    _trees_bitwise(out, p_tree)
    assert meta == {"from": "jax"}
    ckpt.save(path_p, p_tree)
    back, _ = jckpt.restore(path_p, j_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(j_tree)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))
    grown, _, _ = ckpt.restore_elastic(path_j, {**p_tree, "w": torch.zeros((4, 5),
                                                                           dtype=torch.bfloat16)})
    j_grown, _, _ = jckpt.restore_elastic(path_j, {**j_tree, "w": jnp.zeros((4, 5), jnp.bfloat16)})
    assert np.array_equal(grown["w"].view(torch.int16).numpy(),
                          np.asarray(j_grown["w"]).view(np.int16))  # the mean-fill, bitwise


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("algo", ALGOS)
def test_checkpoints_cross_between_the_packages(tmp_path, jax_stream, algo, engine):
    """JAX saves at step 4; the port restores it leaf for leaf (bitwise) and
    both continue 4 iterations at the trajectory tolerance; the port saves
    its continuation, which the JAX package restores leaf for leaf; both
    files hold the same names, dtypes and shapes."""
    jsim = _jsim(algo, engine)
    jout = jsim.run(4)
    path_j, path_p = str(tmp_path / "jax"), str(tmp_path / "port")
    jsim.save_state(path_j, jout["state"])
    saved, jman = _npz(path_j)

    sim = _sim(algo, engine)
    st = sim.load_state(path_j)
    got = _port_leaves(sim, st)
    assert sorted(got) == sorted(saved)
    for k, v in saved.items():
        v = v if jman["dtypes"][k] != "bfloat16" else v.view(np.uint16)
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    if algo == "bmuf":
        assert {"algo/.w_global", "algo/.velocity"} <= set(saved) or engine == "pytree"
    if algo == "gossip":
        assert jman["dtypes"]["algo"] == "int32" and isinstance(st.algo_state, int)
    if algo == "ma":
        assert not any(k.startswith("algo") for k in saved)

    j_cont = _jsim(algo, engine)
    j_next = j_cont.run(4, state=j_cont.load_state(path_j))
    p_next = sim.run(4, state=st)
    np.testing.assert_allclose(p_next["train_loss"], j_next["train_loss"], **TRAJ)

    sim.save_state(path_p, p_next["state"])
    written, pman = _npz(path_p)
    assert {k: (v.dtype, v.shape) for k, v in written.items()} == \
        {k: (v.dtype, v.shape) for k, v in saved.items()}
    assert pman["dtypes"] == jman["dtypes"] and pman["metadata"]["step"] == 8
    j_back = _jsim(algo, engine)
    jst = j_back.load_state(path_p)
    flat, _ = jax.tree_util.tree_flatten_with_path(j_back._state_tree(jst))
    back = {"/".join(jckpt._key_str(p) for p in path): np.asarray(x) for path, x in flat}
    mine = _port_leaves(sim, p_next["state"])
    assert sorted(back) == sorted(mine)
    for k, v in back.items():
        assert np.array_equal(v, mine[k]), k
    j_final = jax.tree.map(np.asarray, j_next["state"].emb_state)
    for k in ("table", "acc"):
        np.testing.assert_allclose(mine[f"emb/{k}"], j_final[k], **TRAJ)
