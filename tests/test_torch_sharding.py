"""The port's partition rules, activation context and input structures
(``sharding/rules.py``, ``sharding/ctx.py``, ``launch/specs.py``) against
the JAX package's, for every arch at its full config.

Nothing is allocated on either side: the JAX trees come from
``jax.eval_shape``, the port's from ``FakeTensorMode``. The specs are plain
data, so they are held equal, leaf by leaf: the port's tuple against the
reference's ``PartitionSpec``. The reference's ``specs`` functions attach a
``NamedSharding`` and so need a JAX mesh; one CPU device makes a mesh whose
axes have size 1, enough for their shapes and dtypes.
"""
import functools
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs.base import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import spmd as jspmd  # noqa: E402
from repro.core.sync import SyncConfig as JSyncConfig  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.sharding import ctx as jctx  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.core import spmd  # noqa: E402
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.sharding import ctx, rules  # noqa: E402

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
DECODE_SHAPES = [n for n, s in INPUT_SHAPES.items() if s.kind == "decode"]


def _spec(p):
    """A ``PartitionSpec`` (or a tuple) as a plain tuple."""
    return tuple(p)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    sds = jax.eval_shape(lambda: jspmd.init_params(jget_config(arch), jax.random.PRNGKey(0)))
    return jax.tree_util.tree_flatten_with_path(sds)[0]


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    with FakeTensorMode():
        params = spmd.init_params(get_config(arch), torch.Generator(), device="cpu")
    out = []
    rules.tree_map_with_path(lambda path, leaf: out.append((path, leaf)), params)
    return out


def _paired(jflat, pflat):
    """(reference path, reference leaf, port path, port leaf), matched by
    their names, in the two packages' (equal) leaf order."""
    assert len(jflat) == len(pflat)
    for (jp, jl), (pp, pl) in zip(jflat, pflat):
        assert jrules._path_names(jp) == rules._path_names(pp)
        assert tuple(jl.shape) == tuple(pl.shape), rules._path_names(pp)
        yield jp, jl, pp, pl


@pytest.mark.parametrize("replica", [None, "pod"], ids=["no_replica", "replica_pod"])
@pytest.mark.parametrize("fsdp", [None, "data"], ids=["no_fsdp", "fsdp_data"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_matches_jax(arch, mesh, fsdp, replica):
    """Every leaf of the full config's tree, under both production meshes,
    with and without FSDP and a replica axis."""
    mesh_shape = MESHES[mesh]
    n = 0
    for jp, jl, pp, pl in _paired(_jax_params(arch), _port_params(arch)):
        kw = dict(fsdp_axis=fsdp, mesh_shape=mesh_shape, replica_axis=replica)
        want = _spec(jrules.param_spec(jp, jl, **kw))
        assert rules.param_spec(pp, pl, **kw) == want, (rules._path_names(pp), want)
        n += 1
    assert n > 0


def test_moe_expert_leaves_take_the_moe_rule():
    """The MoE test is rank >= 4 under ``ffn``: the port's stacked expert
    leaves have the reference's rank, so experts shard over ``model``."""
    hits = [(rules._path_names(p), rules.param_spec(p, leaf, fsdp_axis="data"))
            for p, leaf in _port_params("kimi-k2-1t-a32b")
            if rules._path_names(p)[-1] == "w_gate" and len(leaf.shape) == 4]
    assert hits and all(spec[1] == "model" for _, spec in hits), hits


def test_build_param_specs_on_a_mesh_description():
    """``build_param_specs`` gives a tree of the params' structure; the mesh
    is ``launch/mesh.py``'s description, with the reference's axes."""
    assert M.make_production_mesh().shape == {"data": 16, "model": 16}
    assert M.make_production_mesh(multi_pod=True).shape == MESHES["2x16x16"]
    assert M.make_host_mesh(2, 4).shape == {"data": 2, "model": 4}
    with FakeTensorMode():
        params = spmd.init_params(get_config("granite-20b"), torch.Generator(), device="cpu")
    sp = rules.build_param_specs(params, M.make_production_mesh(), fsdp_axis="data")
    assert [len(s) for _, s in _pairs(params, sp)] == [t.dim() for t in T.leaves(params)]
    wq = sp["unit"][0]["mixer"]["wq"]
    assert wq == (None, "data", "model")


@functools.lru_cache(maxsize=None)
def _caches(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    sds = jax.eval_shape(lambda: jspmd.init_cache(jget_config(arch), shape.global_batch,
                                                  shape.seq_len))
    with FakeTensorMode():
        cache = spmd.init_cache(get_config(arch), shape.global_batch, shape.seq_len,
                                device="cpu")
    out = []
    rules.tree_map_with_path(lambda path, leaf: out.append((path, leaf)), cache)
    return jax.tree_util.tree_flatten_with_path(sds)[0], out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape_name", DECODE_SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax(arch, shape_name, mesh):
    """``_cache_sharding`` and ``kv_cache_spec`` on every leaf of the
    arch's serving cache at each decode shape."""
    mesh_shape = MESHES[mesh]
    for jp, jl, pp, pl in _paired(*_caches(arch, shape_name)):
        assert specs._cache_sharding(pp, pl, mesh_shape) == \
            _spec(jspecs._cache_sharding(jp, jl, mesh_shape))
        assert rules.kv_cache_spec(tuple(pl.shape), mesh_shape) == \
            _spec(jrules.kv_cache_spec(jl.shape, mesh_shape))


@pytest.mark.parametrize("batch_axes", [("data",), ("pod", "data")])
@pytest.mark.parametrize("replica", [None, "pod"])
def test_batch_spec_matches_jax(replica, batch_axes):
    for kind in ("train", "prefill", "decode"):
        assert rules.batch_spec(kind, replica_axis=replica, batch_axes=batch_axes) == \
            _spec(jrules.batch_spec(kind, replica_axis=replica, batch_axes=batch_axes))


def _jax_resolution(mesh_shape, batch_axes, shape, spec, monkeypatch):
    """The spec the reference's ``constrain`` builds, caught at its
    ``with_sharding_constraint`` (a mesh of as many devices would need them)."""
    mesh = types.SimpleNamespace(axis_names=tuple(mesh_shape),
                                 devices=np.empty(tuple(mesh_shape.values()), np.int8))
    monkeypatch.setattr(jctx, "NamedSharding", lambda m, p: p)
    monkeypatch.setattr(jctx.jax.lax, "with_sharding_constraint", lambda x, s: s)
    with jctx.activation_mesh(mesh, batch_axes=batch_axes):
        return _spec(jctx.constrain(jax.ShapeDtypeStruct(shape, jnp.float32), spec))


ACTIVATIONS = [((256, 4096, 6144), ("batch", None, None)),
               ((8, 4096, 6144), ("batch", None, None)),
               ((32, 32768, 48, 128), ("batch", None, "model", None)),
               ((1, 524288, 4096), ("batch", None, "model")),
               ((128, 1, 7168), ("batch", None, "model")),
               ((40, 100, 40), (None, "batch", "model"))]


@pytest.mark.parametrize("mesh, batch_axes", [("16x16", ("data",)), ("2x16x16", ("data",)),
                                              ("2x16x16", ("pod", "data"))])
def test_ctx_resolves_as_the_reference(mesh, batch_axes, monkeypatch):
    """``ctx.resolve`` drops non-divisible axes as the reference does;
    ``constrain`` returns its input, with or without a context."""
    mesh_shape = MESHES[mesh]
    desc = M.Mesh(tuple(mesh_shape), tuple(mesh_shape.values()))
    x = torch.zeros(2, 3)
    assert ctx.constrain(x, ("batch", None)) is x and ctx.resolve((2, 3), ("batch", None)) is None
    for shape, spec in ACTIVATIONS:
        want = _jax_resolution(mesh_shape, batch_axes, shape, spec, monkeypatch)
        with ctx.activation_mesh(desc, batch_axes=batch_axes):
            assert ctx.active() is not None
            assert ctx.resolve(shape, spec) == want, (shape, spec, want)
            assert ctx.constrain(x, ("batch", None)) is x
        assert ctx.active() is None


# ---------------------------------------------------------------------------
# launch/specs.py: shapes and dtypes against the reference's functions
# ---------------------------------------------------------------------------

def _jmesh(pod: bool):
    if pod:
        return jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    return jax.make_mesh((1, 1), ("data", "model"))


def _pmesh(pod: bool):
    return M.Mesh(("pod", "data", "model"), (1, 1, 1)) if pod else M.make_host_mesh()


def _pairs(structs, sp):
    """(struct, spec) leaf pairs of two matching trees, in ``T.leaves``
    order (a spec is a tuple, so the walk follows ``structs``)."""
    pairs = []
    rules.tree_map_with_path(lambda path, leaf: pairs.append((path, leaf)), structs)

    def at(tree, path):
        for p in path:
            tree = getattr(tree, p.name) if isinstance(p, rules.Attr) else tree[p]
        return tree

    return [(leaf, at(sp, path)) for path, leaf in pairs]


def _held(pair, jtree):
    """The port's (structs, specs) against the reference's annotated
    ShapeDtypeStructs: equal shapes, dtypes and specs, leaf by leaf."""
    got, want = _pairs(*pair), jax.tree.leaves(jtree)
    assert len(got) == len(want)
    for (g, spec), w in zip(got, want):
        if isinstance(g, int):  # the port's decode position is a host int
            assert w.shape == () and w.dtype == jnp.int32 and spec == ()
            continue
        assert isinstance(g, FakeTensor)  # shapes only, no storage
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert spec == _spec(w.sharding.spec), (spec, w.sharding.spec)


@pytest.mark.parametrize("mode", ["syncdp", "shadow"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_structs_match_jax(arch, mode):
    pod = mode == "shadow"
    jm, pm = _jmesh(pod), _pmesh(pod)
    jp = jspecs.param_structs(jget_config(arch), jm, mode=mode)
    pp = specs.param_structs(get_config(arch), pm, mode=mode)
    _held(pp, jp)
    replica = "pod" if pod else None
    jo = jspecs.opt_structs(joptim.adagrad(1e-3), jp, jm, replica_axis=replica)
    po = specs.opt_structs(optim.adagrad(1e-3), pp[0], pm, replica_axis=replica)
    _held(po, jo)


@pytest.mark.parametrize("algo", ["easgd", "ma", "bmuf"])
def test_sync_state_structs_match_jax(algo):
    jm, pm = _jmesh(False), _pmesh(False)
    arch = "minicpm-2b"
    jp = jspecs.param_structs(jget_config(arch), jm)
    pp = specs.param_structs(get_config(arch), pm)
    js = jspecs.sync_state_structs(JSyncConfig(algo=algo).validate(), jp, jm)
    ps = specs.sync_state_structs(SyncConfig(algo=algo).validate(), pp[0], pm)
    if js is None:
        assert ps == (None, None)
    else:
        _held(ps, js)


@pytest.mark.parametrize("mode", ["syncdp", "shadow"])
@pytest.mark.parametrize("arch", ["granite-20b", "llava-next-34b", "whisper-base"])
def test_train_batch_structs_match_jax(arch, mode):
    """Dense, vlm (the image prefix out of the sequence) and audio (frames)."""
    pod = mode == "shadow"
    for name in ("train_4k", "prefill_32k"):
        jb = jspecs.train_batch_structs(jget_config(arch), J_SHAPES[name], _jmesh(pod), mode=mode)
        pb = specs.train_batch_structs(get_config(arch), INPUT_SHAPES[name], _pmesh(pod),
                                       mode=mode)
        assert sorted(pb[0]) == sorted(jb)
        _held(pb, jb)


@pytest.mark.parametrize("shape_name", DECODE_SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_decode_structs_match_jax(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    jm, pm = _jmesh(False), _pmesh(False)
    jc = jspecs.cache_structs(jget_config(arch), shape.global_batch, shape.seq_len, jm)
    pc = specs.cache_structs(get_config(arch), shape.global_batch, shape.seq_len, pm)
    _held(pc, jc)
    jd = jspecs.decode_batch_structs(jget_config(arch), J_SHAPES[shape_name], jm)
    pd = specs.decode_batch_structs(get_config(arch), shape, pm)
    _held(pd, jd)
    assert pd[0]["pos"] == shape.seq_len - 1


def test_batch_axes_match_jax():
    for pod, mode in itertools.product((False, True), ("syncdp", "shadow")):
        assert specs.batch_axes(_pmesh(pod), mode) == jspecs.batch_axes(_jmesh(pod), mode)
