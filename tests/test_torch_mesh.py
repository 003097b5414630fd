"""The port's mesh program: DTensor placements, counted collectives and
ShadowSync's zero-cross-pod train step (``launch/mesh.py``,
``sharding/{rules,ctx}.py``, ``launch/specs.py``, ``models/moe.py``,
``core/spmd.py``, ``roofline/analysis.py``).

Most cases trace one rank of a fake process group (``launch/mesh.py::
fake_world``: collectives move no data, so one process stands for every
rank, as the reference's tests force host devices); the numbers run real
``gloo`` ranks, each a subprocess on a free port, under a timeout. The
JAX reference's own mesh tests (``tests/test_sharding.py:65-140``) do not
lower under this jax; the port's twins of them are the property tests
here. The tolerance of the numbers is the trajectory one, ``rtol=1e-4,
atol=1e-5`` (``tests/test_flatspace.py:233``).
"""
import os
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.core import spmd as jspmd  # noqa: E402
from repro.core import sync as jsync  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.base import InputShape, get_config, reduced  # noqa: E402
from repro_torch.core import spmd  # noqa: E402
from repro_torch.core.sync import SyncConfig  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402
from repro_torch.sharding import ctx as shctx  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

TRAJ = dict(rtol=1e-4, atol=1e-5)
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
POD = M.Mesh(("pod", "data", "model"), (2, 2, 2))  # the reference test's (2, 2, 2) mesh
RANK_TIMEOUT = 420  # seconds for a multi-process run (no pytest-timeout here)
# a rank yields the cores to the other test workers' timed threads
RANK_NICE = 10


@pytest.fixture(autouse=True, scope="module")
def _no_world_left():
    """No process group outlives this file (the next file in the worker
    may start its own)."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(mesh: M.Mesh):
    M.fake_world(mesh.size)
    return M.device_mesh(mesh)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-20b", "kimi-k2-1t-a32b", "minicpm-2b"])
def test_params_are_placed_by_the_rules(arch):
    """Reduced configs on a fake 16 x 16 mesh: every parameter is a DTensor
    whose placements are ``to_placements`` of the rules' spec, and whose
    local shard is the global shape over the axis sizes (the DTensor twins
    of ``tests/test_sharding.py::TestParamRules``)."""
    dm = _mesh(M.make_production_mesh())
    cfg = reduced(get_config(arch))
    structs, specs = SP.param_structs(cfg, dm)
    # the placements tree the rules build directly (build_param_specs' twin)
    placements = rules.build_param_placements(structs, dm, fsdp_axis="data")
    seen = []

    def check(path, t):
        spec = SP._at(specs, path)
        assert isinstance(t, DTensor), path
        assert tuple(t.placements) == rules.to_placements(spec, dm), (path, spec)
        assert tuple(t.placements) == SP._at(placements, path), path
        want = [n // (16 ** len(ax if isinstance(ax, tuple) else (ax,)) if ax else 1)
                for n, ax in zip(t.shape, spec)]
        assert list(t.to_local().shape) == want, (path, spec, t.shape)
        seen.append(path)

    rules.tree_map_with_path(check, structs)
    assert len(seen) == len(T.leaves(structs))
    # a matrix of each kind is sharded as the reference's rules say
    wq = structs["unit"][0]["mixer"]["wq"]
    assert wq.placements == (Shard(1), Shard(2))  # (repeats, d over data, out over model)
    assert structs["final_norm"]["scale"].placements == (Replicate(), Replicate())


def test_to_placements_shards_a_dim_over_an_axis_tuple():
    dm = _mesh(POD)
    assert rules.to_placements((("pod", "data"), None), dm) == (Shard(0), Shard(0), Replicate())
    assert rules.to_placements(("pod", None, "model"), dm) == (Shard(0), Replicate(), Shard(2))
    with pytest.raises(ValueError):
        rules.to_placements((("data", "pod"), None), dm)  # out of mesh order


# ---------------------------------------------------------------------------
# ShadowSync's property on the reference test's mesh
# ---------------------------------------------------------------------------

def _programs(arch):
    """The reference test's setup (``tests/test_sharding.py:65-90``): a
    fake (2, 2, 2) pod x data x model mesh, reduced ``arch``, tokens
    (2, 4, 64) (R=2 replicas of 4 sequences), Adagrad 1e-2."""
    dm = _mesh(POD)
    cfg = reduced(get_config(arch))
    shape = InputShape("x", 64, 8, "train")
    shadow = D.build(cfg, "x", dm, mode="shadow", optimizer="adagrad", n_microbatches=1,
                     shape_override=shape)
    syncdp = D.build(cfg, "x", dm, mode="syncdp", optimizer="adagrad", n_microbatches=1,
                     shape_override=shape)
    ma = D.build_sync_step(arch, dm, algo="ma", cfg=cfg)
    assert tuple(shadow.args[2]["tokens"].shape) == (2, 4, 64)
    return shadow, syncdp, ma


def _collectives(program):
    return D._trace_cost(program).collectives


def test_shadow_train_step_has_no_cross_pod_collective():
    """THE defining property: the shadow step's collectives all stay within
    a pod (and there are some, over data and model, so the zero is not
    vacuous); the MA sync step and the syncdp step cross the pods."""
    shadow, syncdp, ma = _programs("granite-20b")
    recs = _collectives(shadow)
    assert RA.cross_pod(recs) == (0, 0), RA.collective_table(recs)
    assert len(recs) > 0 and {a for c in recs for a in c.axes} == {"data", "model"}
    for program in (ma, syncdp):
        n, b = RA.cross_pod(_collectives(program))
        assert n > 0 and b > 0


def test_reduced_moe_traces_with_two_dispatch_groups(monkeypatch):
    """Reduced phi3.5-moe on the same mesh (the twin of
    ``test_reduced_mesh_dryrun_moe``): the shadow step routes in G=2 groups
    (a replica's sub-mesh has data 2) and stays within its pod."""
    groups = []
    n_groups = moe._n_groups
    monkeypatch.setattr(moe, "_n_groups", lambda T: groups.append(n_groups(T)) or groups[-1])
    shadow, syncdp, _ = _programs("phi3.5-moe-42b-a6.6b")
    assert RA.cross_pod(_collectives(shadow)) == (0, 0)
    assert groups and set(groups) == {2}
    groups.clear()
    assert RA.cross_pod(_collectives(syncdp))[0] > 0
    assert groups and set(groups) == {4}  # (pod, data) batch axes: 2 x 2


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def test_a_hand_count_of_an_all_reduce_and_an_all_gather():
    """On a fake 16 x 16 mesh: a row-parallel product's pending sum reduced
    over "model" is one all-reduce of the (64, 256) f32 result, counted
    twice its bytes; gathering a (64, 256) tensor sharded over "data" is
    one all-gather whose result is the whole tensor (the twin of
    ``tests/test_roofline.py``'s HLO sample)."""
    dm = _mesh(M.make_production_mesh())
    x = SP.place(torch.empty((64, 512), device="meta"), (None, "model"), dm)
    w = SP.place(torch.empty((512, 256), device="meta"), ("model", None), dm)
    y = SP.place(torch.empty((64, 256), device="meta"), ("data", None), dm)
    cc = RA.CollectiveCounter(dm)
    with cc:
        (x @ w).redistribute(dm, [Replicate(), Replicate()])
        y.redistribute(dm, [Replicate(), Replicate()])
    assert cc.records == [RA.Collective("all-reduce", ("model",), 2 * 64 * 256 * 4),
                          RA.Collective("all-gather", ("data",), 64 * 256 * 4)]
    assert RA.collective_bytes(cc.records)["all-reduce"] == 2 * 64 * 256 * 4
    r = RA.analyze(RA.TraceCost(0, 0, 0, 0, 0, collectives=cc.records), arch="a", shape="s",
                   mode="m", chips=256)
    assert r.collective_bytes_per_chip == 3 * 64 * 256 * 4
    assert r.t_collective == pytest.approx(3 * 64 * 256 * 4 / M.LINK_BW)
    assert "no collective" not in r.notes and r.cross_pod_collectives == 0


def test_a_regroup_counts_one_all_to_all_of_the_local_shard():
    """A Shard(0) -> Shard(1) redistribute over "model" on a fake 16 x 16
    mesh is one all-to-all whose bytes are the local result's (the
    reference's expert-parallel exchange), not a gather of the whole
    tensor; in a dry-run trace too."""
    dm = _mesh(M.make_production_mesh())
    x = SP.place(torch.empty((256, 512), device="meta"), (None, "model"), dm)
    x = x.redistribute(dm, [Replicate(), Shard(0)])
    local = 256 * 512 // 16 * 4
    cc = RA.CollectiveCounter(dm)
    with cc:
        y = x.redistribute(dm, [Replicate(), Shard(1)])
    assert tuple(y.to_local().shape) == (256, 512 // 16)
    assert cc.records == [RA.Collective("all-to-all", ("model",), local)]
    cost = D._trace_cost(D.Program(lambda x: x.redistribute(dm, [Replicate(), Shard(1)]) * 2,
                                   (x,), ()))
    assert cost.collectives == [RA.Collective("all-to-all", ("model",), local)]
    assert RA.collective_bytes(cost.collectives)["all-gather"] == 0


def test_a_column_sharded_product_counts_its_local_flops():
    """A trace on the mesh counts one chip's work: a (128, 1024) @ (1024,
    4096) product with the weight's columns sharded 16 ways counts 1/16 of
    the product's FLOPs, and its local bytes."""
    dm = _mesh(M.make_production_mesh())
    x = SP.place(torch.empty((128, 1024), device="meta"), (None, None), dm)
    w = SP.place(torch.empty((1024, 4096), device="meta"), (None, "model"), dm)
    cost = D._trace_cost(D.Program(lambda x, w: x @ w, (x, w), ()))
    assert cost.flops == 2 * 128 * 1024 * 4096 / 16
    assert cost.bytes_accessed == 4 * (128 * 1024 + 1024 * 4096 / 16 + 128 * 4096 / 16)
    assert cost.collectives == [] and cost.arg_bytes == 4 * (128 * 1024 + 1024 * 4096 / 16)


def test_constrain_is_the_identity_without_a_device_mesh():
    x = torch.randn(4, 8, 16)
    assert shctx.constrain(x, ("batch", None, "model")) is x
    with shctx.activation_mesh(M.make_host_mesh(2, 2)):
        assert shctx.constrain(x, ("batch", None, "model")) is x
        assert shctx.resolve(x.shape, ("batch", None, "model")) == ("data", None, "model")


def test_constrain_redistributes_a_dtensor_on_a_device_mesh():
    dm = _mesh(M.make_production_mesh())
    x = SP.place(torch.empty((32, 8, 64), device="meta"), (None, None, "model"), dm)
    with shctx.activation_mesh(dm):
        y = shctx.constrain(x, ("batch", None, None))
        assert y.placements == (Shard(0), Replicate())
        assert shctx.constrain(y, ("batch", None, None)) is y
        # 8 does not split 16 ways: the axis is dropped, as the reference drops it
        assert shctx.constrain(x, (None, "batch", None)).placements == (Replicate(), Replicate())


def test_no_process_group_raises():
    if dist.is_initialized():
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        M.device_mesh(POD)


# ---------------------------------------------------------------------------
# numbers: 8 gloo ranks against the one-process port and the JAX package
# ---------------------------------------------------------------------------

RANK_SCRIPT = """
import os, pickle, sys
os.nice({nice})
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, n, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}", rank=rank,
                        world_size=n)
sys.path.insert(0, {src!r})
from repro_torch import tree as T
from repro_torch.launch import mesh as M
from repro_torch.sharding import ctx as shctx
with open(work + "/in.pkl", "rb") as f:
    job = pickle.load(f)
dm = M.device_mesh(M.Mesh(*job["mesh"]))
{body}
dist.barrier()
dist.destroy_process_group()
"""

SHADOW_BODY = """
    from repro_torch import interop, optim
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core import spmd
    from repro_torch.core.sync import SyncConfig
    from repro_torch.launch import specs as SP
    from repro_torch.sharding import rules
    cfg = reduced(get_config("granite-20b"))
    opt = optim.adagrad(1e-2)
    stack = spmd.stack_replicas(interop.lm_params_from_numpy(job["params"]), 2)
    ost = opt.init(stack)
    tokens = torch.tensor(job["tokens"]).long()
    pspec = rules.build_param_specs(stack, dm, fsdp_axis="data", replica_axis="pod")
    stack, ost = SP.place(stack, pspec, dm), SP.place(ost, pspec, dm)
    batch = {"tokens": SP.place(tokens, ("pod", "data", None), dm)}
    with shctx.activation_mesh(dm, batch_axes=("data",)):
        stack, ost, loss = spmd.make_train_step(cfg, opt, "shadow")(stack, ost, batch)
        stack, _ = spmd.make_sync_step(cfg, SyncConfig(algo="ma").validate())(stack, None)
    # syncdp: one model, the batch over (pod, data), two microbatches a rank
    single = interop.lm_params_from_numpy(job["params"])
    sost = opt.init(single)
    sspec = rules.build_param_specs(single, dm, fsdp_axis="data")
    single, sost = SP.place(single, sspec, dm), SP.place(sost, sspec, dm)
    sbatch = {"tokens": SP.place(tokens.reshape(-1, tokens.shape[-1]), (("pod", "data"), None),
                                 dm)}
    with shctx.activation_mesh(dm, batch_axes=("pod", "data")):
        single, sost, sloss = spmd.make_train_step(cfg, opt, "syncdp", n_microbatches=2)(
            single, sost, sbatch)
    out = T.map(lambda x: x.full_tensor().numpy(), ((stack, ost, loss), (single, sost, sloss)))
    if rank == 0:
        with open(work + "/out.pkl", "wb") as f:
            pickle.dump(out, f)
"""

MOE_BODY = """
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import specs as SP
    from repro_torch.models import moe
    cfg = reduced(get_config("phi3.5-moe-42b-a6.6b"))
    p = {k: SP.place(torch.tensor(v), (None,) * v.ndim, dm) for k, v in job["params"].items()}
    x = SP.place(torch.tensor(job["x"]), ("data", None, None), dm)
    with shctx.activation_mesh(dm, batch_axes=("data",)):
        groups = moe._n_groups(x.shape[0] * x.shape[1])
        y, aux = moe.moe_apply(p, x, cfg)
    out = (y.full_tensor().numpy(), aux.full_tensor().numpy(), groups)
    if rank == 0:
        with open(work + "/out.pkl", "wb") as f:
            pickle.dump(out, f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(tmp_path, body: str, mesh: M.Mesh, job: dict):
    """Run ``body`` on ``mesh.size`` gloo ranks (a subprocess each); rank
    0's pickled output."""
    job = dict(job, mesh=(mesh.axis_names, mesh.axis_sizes))
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump(job, f)
    script = RANK_SCRIPT.format(src=SRC, body=textwrap.dedent(body), nice=RANK_NICE)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=SRC)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(mesh.size), port,
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(mesh.size)]
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs[0][-3000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        return pickle.load(f)


def _close(got, want):
    got, want = T.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **TRAJ)


@pytest.fixture(scope="module")
def gloo_granite(tmp_path_factory):
    """8 gloo ranks on (2, 2, 2), reduced granite-20b, the same numpy
    weights and (2, 4, 64) tokens: the shadow step then the MA sync, and a
    syncdp step of two microbatches on the tokens as one batch of 8 over
    (pod, data). Rank 0's gathered (``full_tensor``) results."""
    jcfg = jreduced(jget_config("granite-20b"))
    params = jax.tree.map(np.asarray, jspmd.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 4, 64)).astype(np.int32)
    got = _ranks(tmp_path_factory.mktemp("gloo"), SHADOW_BODY, POD,
                 {"params": params, "tokens": tokens})
    return params, tokens, got


def test_gloo_shadow_step_and_ma_sync_match_one_process_and_jax(gloo_granite):
    """The shadow step, then the MA sync, on 8 gloo ranks: the gathered
    parameters, Adagrad state and losses against the port's one-process
    steps and the JAX package's (unsharded), on the same numpy weights and
    tokens."""
    params, tokens, (got, _) = gloo_granite
    jcfg = jreduced(jget_config("granite-20b"))
    cfg = reduced(get_config("granite-20b"))

    # the port, one process
    opt = optim.adagrad(1e-2)
    stack = spmd.stack_replicas(interop.lm_params_from_numpy(params), 2)
    ost = opt.init(stack)
    stack, ost, loss = spmd.make_train_step(cfg, opt, "shadow")(
        stack, ost, {"tokens": torch.tensor(tokens).long()})
    stack, _ = spmd.make_sync_step(cfg, SyncConfig(algo="ma").validate())(stack, None)
    for a, b in zip(T.leaves(got), T.leaves((stack, ost, loss))):
        np.testing.assert_allclose(a, b.detach().numpy(), **TRAJ)

    # the JAX package, unsharded
    jopt = joptim.adagrad(1e-2)
    jstack = jax.tree.map(jnp.copy, jspmd.stack_replicas(params, 2))
    jost = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (2,) + x.shape).copy(),
                        jopt.init(params))
    jstack, jost, jloss = jax.jit(jspmd.make_train_step(jcfg, jopt, "shadow"))(
        jstack, jost, {"tokens": jnp.asarray(tokens)})
    jstack, _ = jax.jit(jspmd.make_sync_step(jcfg, jsync.SyncConfig(algo="ma").validate()))(
        jstack, None)
    _close([torch.tensor(a) for a in T.leaves(got)], (jstack, jost, jloss))


def test_gloo_syncdp_step_of_two_microbatches_matches_one_process_and_jax(gloo_granite):
    """The syncdp step on 8 gloo ranks, two microbatches a rank (their
    gradients' sums pending across "pod" and "data" until the update): the
    gathered parameters, Adagrad state and loss against the port's
    one-process step and the JAX package's, two microbatches each."""
    params, tokens, (_, got) = gloo_granite
    jcfg = jreduced(jget_config("granite-20b"))
    cfg = reduced(get_config("granite-20b"))
    flat = tokens.reshape(-1, tokens.shape[-1])

    opt = optim.adagrad(1e-2)
    single = interop.lm_params_from_numpy(params)
    single, ost, loss = spmd.make_train_step(cfg, opt, "syncdp", n_microbatches=2)(
        single, opt.init(single), {"tokens": torch.tensor(flat).long()})
    want = T.leaves((single, ost, loss))
    assert len(T.leaves(got)) == len(want)
    for a, b in zip(T.leaves(got), want):
        np.testing.assert_allclose(a, b.detach().numpy(), **TRAJ)

    jopt = joptim.adagrad(1e-2)
    jout = jax.jit(jspmd.make_train_step(jcfg, jopt, "syncdp", n_microbatches=2))(
        params, jopt.init(params), {"tokens": jnp.asarray(flat)})
    _close([torch.tensor(a) for a in T.leaves(got)], jout)


JAX_MOE = textwrap.dedent("""
    import os
    os.nice({nice})
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import pickle, sys
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_config, reduced
    from repro.models import moe
    from repro.sharding import ctx as shctx
    cfg = reduced(get_config("phi3.5-moe-42b-a6.6b"))
    with open(sys.argv[1] + "/in.pkl", "rb") as f:
        job = pickle.load(f)
    mesh = jax.make_mesh((2, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with shctx.activation_mesh(mesh, batch_axes=("data",)):
        y, aux = jax.jit(lambda p, x: moe.moe_apply(p, x, cfg))(job["params"], job["x"])
    with open(sys.argv[1] + "/jax.pkl", "wb") as f:
        pickle.dump((np.asarray(y), np.asarray(aux)), f)
""")


def test_moe_in_two_groups_matches_jax_on_two_devices(tmp_path):
    """The MoE layer routed in G=2 groups on 2 gloo ranks (a (2, 1) data x
    model mesh) against the JAX package's ``moe_apply`` under a 2-device
    mesh (forced host devices, in a subprocess), on the same weights and
    tokens."""
    jcfg = jreduced(jget_config("phi3.5-moe-42b-a6.6b"))
    from repro.models import moe as jmoe

    params = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.float32))
    x = np.random.default_rng(1).standard_normal((4, 16, jcfg.d_model)).astype(np.float32)
    mesh = M.Mesh(("data", "model"), (2, 1))
    y, aux, groups = _ranks(tmp_path, MOE_BODY, mesh, {"params": params, "x": x})
    assert groups == 2
    out = subprocess.run([sys.executable, "-c", JAX_MOE.format(src=SRC, nice=RANK_NICE),
                          str(tmp_path)],
                         capture_output=True, text=True, timeout=RANK_TIMEOUT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    with open(tmp_path / "jax.pkl", "rb") as f:
        jy, jaux = pickle.load(f)
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, jaux, rtol=1e-5, atol=1e-6)
