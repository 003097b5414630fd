"""The hand-written CUDA kernels against their plain versions, on the card.

These need a CUDA card and nvcc, and skip elsewhere. Run them on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import dataclasses
import math
import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # leave the other test workers their cores

from repro_torch import optim  # noqa: E402
from repro_torch.configs import dlrm_ctr  # noqa: E402
from repro_torch.core import algorithms, runners, streams, sync  # noqa: E402
from repro_torch.core.flatspace import FlatSpace  # noqa: E402
from repro_torch.core.pipeline import PipelineConfig  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.kernels.easgd_update.ops import easgd_pair_flat_op, easgd_round_op  # noqa: E402
from repro_torch.kernels.easgd_update.ref import easgd_round_ref, easgd_update_ref  # noqa: E402
from repro_torch.kernels.embedding_bag.ops import embedding_bag_op  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402
from repro_torch.kernels.sparse_adagrad.ops import sparse_adagrad_op  # noqa: E402
from repro_torch.kernels.sparse_adagrad.ref import sparse_adagrad_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("n_bags,m,d", [(1, 1, 4), (37, 3, 16), (1000, 4, 64)])
def test_embedding_bag_kernel(gen, n_bags, m, d):
    table = torch.randn((500, d), generator=gen).cuda()
    idx = torch.randint(0, 50, (n_bags, m), generator=gen, dtype=torch.int32).cuda()
    before = embedding_bag_op.launches
    got = embedding_bag_op(table, idx)
    assert embedding_bag_op.launches == before + 1
    torch.testing.assert_close(got, embedding_bag_ref(table, idx), rtol=1e-6, atol=1e-6)


def test_embedding_bag_out_of_range_id_is_nan(gen):
    table = torch.randn((10, 8), generator=gen).cuda()
    idx = torch.tensor([[1, 2], [3, 10]], dtype=torch.int32).cuda()
    got = embedding_bag_op(table, idx)
    assert torch.isnan(got[1]).all() and torch.isfinite(got[0]).all()


@pytest.mark.parametrize("n_bags,m", [(1, 1), (37, 3), (2000, 4)])
def test_sparse_adagrad_kernel(gen, n_bags, m):
    table = torch.randn((300, 16), generator=gen).cuda()
    acc = torch.rand((300, 16), generator=gen).cuda()
    idx = torch.randint(0, 60, (n_bags, m), generator=gen, dtype=torch.int32).cuda()
    g = torch.randn((n_bags, 16), generator=gen).cuda()
    kt, ka = sparse_adagrad_op(table.clone(), acc.clone(), idx, g, lr=0.05)
    kt2, ka2 = sparse_adagrad_op(table.clone(), acc.clone(), idx, g, lr=0.05)
    assert torch.equal(kt, kt2) and torch.equal(ka, ka2)  # no atomics: repeatable
    pt, pa = sparse_adagrad_ref(table.clone(), acc.clone(), idx, g, 0.05)
    torch.testing.assert_close(kt, pt, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ka, pa, rtol=1e-5, atol=1e-5)
    assert torch.equal(kt[60:], table[60:]) and torch.equal(ka[60:], acc[60:])


K2_TILE = 32  # csrc/sparse_adagrad.cu's TILE


def _adagrad_f64(table, acc, idx, g, lr, eps=1e-8):
    """The plain version's formula evaluated in float64, rounded to f32."""
    rows = idx.reshape(-1).long()
    g64 = g.double().repeat_interleave(idx.shape[1], dim=0)
    a = acc.double().index_add_(0, rows, g64 * g64)
    s = torch.zeros_like(a).index_add_(0, rows, g64)
    return (table.double() - lr * torch.rsqrt(a + eps) * s).float(), a.float()


def _adagrad_checked(table, acc, idx, g, lr=0.05, ref_keep=None, ref=sparse_adagrad_ref):
    """K2 on clones: one launch, bitwise repeatable, rows not named bitwise
    unchanged, within 1e-5 of ``ref`` (over the bags ``ref_keep`` selects,
    where some ids are out of range). Returns the kernel's result."""
    before = sparse_adagrad_op.launches
    kt, ka = sparse_adagrad_op(table.clone(), acc.clone(), idx, g, lr=lr)
    assert sparse_adagrad_op.launches == before + 1
    kt2, ka2 = sparse_adagrad_op(table.clone(), acc.clone(), idx, g, lr=lr)
    assert torch.equal(kt, kt2) and torch.equal(ka, ka2)  # no atomics: repeatable
    keep = slice(None) if ref_keep is None else ref_keep
    pt, pa = ref(table.clone(), acc.clone(), idx[keep], g[keep], lr)
    torch.testing.assert_close(kt, pt, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ka, pa, rtol=1e-5, atol=1e-5)
    untouched = torch.ones(table.shape[0], dtype=torch.bool, device="cuda")
    named = idx[(idx >= 0) & (idx < table.shape[0])].long()
    untouched[named] = False
    assert torch.equal(kt[untouched], table[untouched])
    assert torch.equal(ka[untouched], acc[untouched])
    return kt, ka


@pytest.mark.parametrize("d", [4, 64, 128, 136])
@pytest.mark.parametrize("lead", [0, 1, 17, 31])
def test_sparse_adagrad_runs_across_tiles(gen, d, lead):
    """Runs of T-1, T, T+1 and 3T+5 occurrences (T the kernel's tile),
    shifted by a lead run so that they straddle tile boundaries at every
    offset; the occurrences come shuffled, one a bag. n_items is no multiple
    of T. d = 136 takes two passes of the kernels' 32-word thread groups."""
    T = K2_TILE
    lengths = [lead, T - 1, 1, T, 2, T + 1, 3 * T + 5, 1, T - 1]
    ids = torch.cat([torch.full((n,), 3 * k, dtype=torch.int32) for k, n in enumerate(lengths)])
    ids = ids[torch.randperm(ids.numel(), generator=gen)]
    assert ids.numel() % T != 0
    n_rows = 3 * len(lengths) + 4
    table = torch.randn((n_rows, d), generator=gen).cuda()
    acc = torch.rand((n_rows, d), generator=gen).cuda()
    g = torch.randn((ids.numel(), d), generator=gen).cuda()
    _adagrad_checked(table, acc, ids.reshape(-1, 1).cuda(), g)


def test_sparse_adagrad_drops_out_of_range_ids_at_both_ends(gen):
    """Ids below 0 sort to the front, ids >= n_rows to the back; runs of
    them (longer than a tile) are dropped and leave every row alone."""
    n_rows, d = 50, 64
    bad = [-7] * 40 + [-1] * 3 + [n_rows] * 45 + [n_rows + 9] * 2
    good = torch.randint(0, n_rows, (300,), generator=gen, dtype=torch.int32).tolist()
    ids = torch.tensor(bad + good, dtype=torch.int32)
    ids = ids[torch.randperm(ids.numel(), generator=gen)].reshape(-1, 1).cuda()
    table = torch.randn((n_rows, d), generator=gen).cuda()
    acc = torch.rand((n_rows, d), generator=gen).cuda()
    g = torch.randn((ids.shape[0], d), generator=gen).cuda()
    in_range = ((ids >= 0) & (ids < n_rows)).reshape(-1)
    _adagrad_checked(table, acc, ids, g, ref_keep=in_range)


def test_sparse_adagrad_one_row_of_100k_occurrences(gen):
    """One row holds 100,000 of 130,000 occurrences (3,125 tiles of one run).
    With g in {+-1/4, +-1/2, +-1} every partial sum of g and g^2 is exact in
    f32, so the accumulator is held against the plain version (whose
    index_add_ adds them with atomics in any order). Its table update is not:
    it adds 10^5 steps of ~1e-5 onto values ~1 one by one, each rounded at
    the value's ulp, and drifts from the exact result by up to 7e-5 on the
    card. The kernel's result is held against the same formula in float64."""
    n_rows, d, hot = 400, 64, 123
    ids = torch.cat([torch.full((100_000,), hot, dtype=torch.int32),
                     torch.randint(0, n_rows, (30_000,), generator=gen, dtype=torch.int32)])
    ids = ids[torch.randperm(ids.numel(), generator=gen)].reshape(-1, 4).cuda()
    table = torch.randn((n_rows, d), generator=gen).cuda()
    acc = torch.rand((n_rows, d), generator=gen).cuda()
    levels = torch.tensor([-1.0, -0.5, -0.25, 0.25, 0.5, 1.0])
    g = levels[torch.randint(0, 6, (ids.shape[0], d), generator=gen)].cuda()
    _, ka = _adagrad_checked(table, acc, ids, g, lr=0.01, ref=_adagrad_f64)
    _, pa = sparse_adagrad_ref(table.clone(), acc.clone(), ids, g, 0.01)
    torch.testing.assert_close(ka, pa, rtol=1e-5, atol=1e-5)


def test_sparse_adagrad_with_no_occurrence_launches_nothing(gen):
    table = torch.randn((10, 8), generator=gen).cuda()
    acc = torch.rand((10, 8), generator=gen).cuda()
    before = sparse_adagrad_op.launches
    kt, ka = sparse_adagrad_op(table.clone(), acc.clone(),
                               torch.zeros((0, 4), dtype=torch.int32).cuda(),
                               torch.zeros((0, 8)).cuda(), lr=0.1)
    assert sparse_adagrad_op.launches == before
    assert torch.equal(kt, table) and torch.equal(ka, acc)


@pytest.mark.parametrize("fired", [[1], [3, 0, 2], [0, 1, 2, 3]])
def test_easgd_round_kernel(gen, fired):
    stack = torch.randn((4, 256, 128), generator=gen).cuda()
    ps = torch.randn((256, 128), generator=gen).cuda()
    f = torch.tensor(fired, dtype=torch.int32).cuda()
    snap = stack.index_select(0, f.long()) + 0.1
    ks, kp = easgd_round_op(stack.clone(), ps.clone(), snap, f, 0.3)
    rs, rp = easgd_round_ref(stack.clone(), ps.clone(), snap, f, 0.3)
    torch.testing.assert_close(ks, rs, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(kp, rp, rtol=1e-6, atol=1e-6)
    for i in set(range(4)) - set(fired):
        assert torch.equal(ks[i], stack[i])


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    table = torch.randn((10, 8), generator=gen).cuda()
    with pytest.raises(ValueError, match="CUDA tensor"):
        embedding_bag_op(table, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 4"):
        embedding_bag_op(torch.randn((10, 6)).cuda(), torch.zeros((2, 2), dtype=torch.int32).cuda())
    stack = torch.randn((2, 8, 128)).cuda()
    f = torch.tensor([0], dtype=torch.int32).cuda()
    with pytest.raises(ValueError, match="snapshot must be a copy"):
        easgd_round_op(stack, torch.randn((8, 128)).cuda(), stack[:1], f, 0.5)


@pytest.mark.parametrize("n", [1, 256, 4096])
def test_easgd_pair_kernel(gen, n):
    ps = torch.randn((n, 128), generator=gen).cuda()
    w = torch.randn((n, 128), generator=gen).cuda()
    ps0, w0 = ps.clone(), w.clone()
    before = easgd_pair_flat_op.launches
    kp, kw = easgd_pair_flat_op(ps, w, 0.3)
    assert easgd_pair_flat_op.launches == before + 1
    rp, rw = easgd_update_ref(ps, w, 0.3)
    torch.testing.assert_close(kp, rp, rtol=0, atol=1e-6)
    torch.testing.assert_close(kw, rw, rtol=0, atol=1e-6)
    assert torch.equal(ps, ps0) and torch.equal(w, w0)  # the inputs are only read
    assert kp.data_ptr() not in (ps.data_ptr(), w.data_ptr())


def test_publish_consume_fences_a_slow_producer(gen):
    """A producer stream spins, then writes a plane; the consumer stream runs
    the threaded round on it. Without the event wait the round would read
    the plane before it is written."""
    n = 4096
    src = torch.randn((n, 128), generator=gen).cuda()
    ps = torch.randn((n, 128), generator=gen).cuda()
    fs = FlatSpace.from_tree({"x": torch.zeros((n * 128,))})
    rnd = algorithms.get("easgd").make_shadow_round(sync.SyncConfig(alpha=0.5), fs)
    producer, consumer = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(producer):
        plane = torch.zeros_like(src)
        torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning before the write
        plane.copy_(src)
        pub = streams.publish(plane)
    with torch.cuda.stream(consumer):
        ws = [streams.consume(pub)]
        new_ps, n_syncs = rnd(ws, ps)
    torch.cuda.synchronize()
    want_ps, want_w = easgd_update_ref(ps, src, 0.5)
    assert n_syncs == 1
    torch.testing.assert_close(new_ps, want_ps, rtol=0, atol=1e-6)
    torch.testing.assert_close(ws[0], want_w, rtol=0, atol=1e-6)


def test_tiny_threaded_run_on_the_card(gen):
    r = runners.ThreadedShadowRunner(dlrm_ctr.tiny(), sync.SyncConfig(gap=3), n_trainers=2,
                                     batch_size=32, optimizer=optim.adagrad(0.02), device="cuda")
    r.warmup()
    before = easgd_pair_flat_op.launches
    out = r.run(10)
    assert all(math.isfinite(x) for x in out["train_loss"]) and out["sync_count"] > 0
    assert out["iter_count"] == [10, 10] and easgd_pair_flat_op.launches > before


# ---------------------------------------------------------------------------
# K5 · MA, K6 · BMUF, K7 · gossip, and the elastic paths that run them
# ---------------------------------------------------------------------------

from repro_torch.kernels import backend  # noqa: E402
from repro_torch.kernels.bmuf_update.ops import bmuf_sync_op, bmuf_sync_rows_op  # noqa: E402
from repro_torch.kernels.bmuf_update.ref import (  # noqa: E402
    bmuf_update_ref, bmuf_update_rows_ref)
from repro_torch.kernels.gossip_update.ops import gossip_pair_flat_op, gossip_round_op  # noqa: E402
from repro_torch.kernels.gossip_update.ref import gossip_pair_ref, gossip_round_ref  # noqa: E402
from repro_torch.kernels.ma_update import ops as ma_ops  # noqa: E402
from repro_torch.kernels.ma_update import ref as ma_ref  # noqa: E402

SYNC_TOL = dict(rtol=1e-6, atol=1e-6)  # the same lerps; nvcc may contract into one FMA
SIZES = [8, 256, 4096]


def _i32(ids):
    return torch.tensor(ids, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("n", SIZES)
def test_replica_mean_kernels(gen, n):
    stack = torch.randn((4, n, 128), generator=gen).cuda()
    before = ma_ops.replica_mean_op.launches
    torch.testing.assert_close(ma_ops.replica_mean_op(stack), ma_ref.replica_mean_ref(stack),
                               **SYNC_TOL)
    assert ma_ops.replica_mean_op.launches == before + 1
    rows = _i32([0, 2, 3])
    torch.testing.assert_close(ma_ops.replica_mean_rows_op(stack, rows),
                               ma_ref.replica_mean_rows_ref(stack, rows), **SYNC_TOL)


@pytest.mark.parametrize("n", SIZES)
def test_ma_pullback_kernels(gen, n):
    stack = torch.randn((4, n, 128), generator=gen).cuda()
    mean = torch.randn((n, 128), generator=gen).cuda()
    ks = ma_ops.ma_sync_op(stack.clone(), mean, 0.3)
    torch.testing.assert_close(ks, ma_ref.ma_update_ref(stack.clone(), mean, 0.3), **SYNC_TOL)
    rows = _i32([3, 1])
    ks = ma_ops.ma_sync_rows_op(stack.clone(), mean, rows, 0.3)
    torch.testing.assert_close(ks, ma_ref.ma_update_rows_ref(stack.clone(), mean, rows, 0.3),
                               **SYNC_TOL)
    assert torch.equal(ks[0], stack[0]) and torch.equal(ks[2], stack[2])
    for planes in ([1], [0, 1, 2]):  # out of place over 1 and 3 planes
        src = stack[planes].clone()
        out = torch.empty_like(src)
        got = ma_ops.ma_sync_op(src, mean, 0.3, out=out)
        assert got is out and torch.equal(src, stack[planes])  # the source is only read
        torch.testing.assert_close(out, ma_ref.ma_update_ref(stack[planes].clone(), mean, 0.3),
                                   **SYNC_TOL)
    # live ids with a gap and one out of range, from the host tuple the
    # algorithms' index_tensor keeps and from a plain device tensor
    for rows in (backend.index_tensor([0, 3, 7], stack.device), _i32([0, 3, 7])):
        before = ma_ops.ma_sync_rows_op.launches
        ks = ma_ops.ma_sync_rows_op(stack.clone(), mean, rows, 0.3)
        assert ma_ops.ma_sync_rows_op.launches == before + 1
        want = ma_ref.ma_update_rows_ref(stack.clone(), mean, _i32([0, 3]), 0.3)
        torch.testing.assert_close(ks, want, **SYNC_TOL)
        assert torch.equal(ks[1], stack[1]) and torch.equal(ks[2], stack[2])  # dead rows


def test_ma_pullback_over_more_ids_than_one_launch_takes(gen):
    """70 replicas: the pull-back's ids go in launches of 64, in order."""
    stack = torch.randn((70, 8, 128), generator=gen).cuda()
    mean = torch.randn((8, 128), generator=gen).cuda()
    ks = ma_ops.ma_sync_op(stack.clone(), mean, 0.3)
    torch.testing.assert_close(ks, ma_ref.ma_update_ref(stack.clone(), mean, 0.3), **SYNC_TOL)
    live = [i for i in reversed(range(70)) if i not in (5, 40)]  # 68 ids, out of order
    ks = ma_ops.ma_sync_rows_op(stack.clone(), mean, backend.index_tensor(live, stack.device), 0.3)
    want = ma_ref.ma_update_rows_ref(stack.clone(), mean, _i32(live), 0.3)
    torch.testing.assert_close(ks, want, **SYNC_TOL)
    dead = sorted(set(range(70)) - set(live))
    assert torch.equal(ks[dead], stack[dead])


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bm,nesterov", [(0.0, False), (0.9, True)])
def test_bmuf_kernels(gen, n, bm, nesterov):
    stack = torch.randn((4, n, 128), generator=gen).cuda()
    mean = torch.randn((n, 128), generator=gen).cuda()
    wg = torch.randn((n, 128), generator=gen).cuda()
    vel = 0.1 * torch.randn((n, 128), generator=gen).cuda()
    kw = dict(eta=0.9, block_momentum=bm, nesterov=nesterov)
    got = bmuf_sync_op(stack.clone(), mean, wg.clone(), vel.clone(), 0.5, **kw)
    want = bmuf_update_ref(stack.clone(), mean, wg.clone(), vel.clone(), 0.5, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **SYNC_TOL)
    rows = _i32([0, 2, 3])
    got = bmuf_sync_rows_op(stack.clone(), mean, wg.clone(), vel.clone(), rows, 0.5, **kw)
    want = bmuf_update_rows_ref(stack.clone(), mean, wg.clone(), vel.clone(), rows, 0.5, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **SYNC_TOL)
    assert torch.equal(got[0][1], stack[1])


@pytest.mark.parametrize("n", SIZES)
def test_gossip_kernels(gen, n):
    a, b = torch.randn((n, 128), generator=gen).cuda(), torch.randn((n, 128), generator=gen).cuda()
    a0, b0 = a.clone(), b.clone()
    for x, y in zip(gossip_pair_flat_op(a, b, 0.4), gossip_pair_ref(a, b, 0.4)):
        torch.testing.assert_close(x, y, **SYNC_TOL)
        assert x.data_ptr() not in (a.data_ptr(), b.data_ptr())
    assert torch.equal(a, a0) and torch.equal(b, b0)
    stack = torch.randn((4, n, 128), generator=gen).cuda()
    for land, sp, pp in (([0, 1, 2, 3], [0, 1, 2, 3], [1, 0, 3, 2]), ([1, 3], [0, 1], [1, 0])):
        snap = stack.index_select(0, torch.tensor(land, device="cuda")) * 1.01
        args = (_i32(land), _i32(sp), _i32(pp))
        ks = gossip_round_op(stack.clone(), snap, *args, 0.6)
        torch.testing.assert_close(ks, gossip_round_ref(stack.clone(), snap, *args, 0.6),
                                   **SYNC_TOL)
        for i in set(range(4)) - set(land):
            assert torch.equal(ks[i], stack[i])


def test_sync_wrappers_refuse_views_of_the_stack(gen):
    stack = torch.randn((4, 8, 128), generator=gen).cuda()
    rows = _i32([0, 1])
    with pytest.raises(ValueError, match="snapshot must be a copy"):
        gossip_round_op(stack, stack[:2], rows, rows, _i32([1, 0]), 0.5)
    with pytest.raises(ValueError, match="separate"):
        ma_ops.ma_sync_op(stack, stack[0], 0.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ma_ops.replica_mean_rows_op(stack, torch.tensor([0], dtype=torch.int32))


def test_sparse_adagrad_zero_gradient_is_a_bitwise_noop(gen):
    """The dead-slot contract of elastic HogwildSim: a zero gradient leaves
    every row it names, and its accumulator, bitwise unchanged."""
    table = torch.randn((300, 16), generator=gen).cuda()
    acc = torch.rand((300, 16), generator=gen).cuda()
    acc[:5] = 0.0  # rows never updated before
    idx = torch.randint(0, 60, (500, 4), generator=gen, dtype=torch.int32).cuda()
    idx[0] = torch.arange(4, dtype=torch.int32)
    kt, ka = sparse_adagrad_op(table.clone(), acc.clone(), idx, torch.zeros((500, 16)).cuda(),
                               lr=0.05)
    assert torch.equal(kt, table) and torch.equal(ka, acc)


def test_publish_consume_fences_the_ma_round(gen):
    """As for EASGD above: a slow producer's plane reaches MA's threaded
    round (mean, out-of-place pull-back) only after its write."""
    n = 4096
    src = torch.randn((n, 128), generator=gen).cuda()
    other = torch.randn((n, 128), generator=gen).cuda()
    fs = FlatSpace.from_tree({"x": torch.zeros((n * 128,))})
    rnd = algorithms.get("ma").make_shadow_round(sync.SyncConfig(algo="ma", alpha=0.5), fs)
    producer, consumer = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(producer):
        plane = torch.zeros_like(src)
        torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning before the write
        plane.copy_(src)
        pub = streams.publish(plane)
    with torch.cuda.stream(consumer):
        ws = [streams.consume(pub), other]
        _, n_syncs = rnd(ws, None)
    torch.cuda.synchronize()
    mean = 0.5 * (src + other)
    assert n_syncs == 1 and ws[0] is not plane
    torch.testing.assert_close(ws[0], 0.5 * src + 0.5 * mean, rtol=0, atol=1e-6)
    torch.testing.assert_close(ws[1], 0.5 * other + 0.5 * mean, rtol=0, atol=1e-6)


@pytest.mark.parametrize("algo", ["ma", "bmuf", "gossip"])
def test_tiny_elastic_sim_on_the_card(gen, algo):
    """Under the reference's schedule the card's run follows the CPU's."""
    sched = [(5, "fail", 1), (9, "join", 1), (11, "join", 3)]
    outs = {}
    for dev in ("cuda", "cpu"):
        sim = runners.HogwildSim(dlrm_ctr.tiny(), sync.SyncConfig(algo=algo, gap=4, delay=1),
                                 n_trainers=3, n_threads=2, batch_size=32,
                                 optimizer=optim.adagrad(0.02), schedule=sched, device=dev)
        outs[dev] = sim.run(16)
    a, b = outs["cuda"], outs["cpu"]
    assert a["sync_count"] == b["sync_count"] > 0
    torch.testing.assert_close(torch.tensor(a["train_loss"]), torch.tensor(b["train_loss"]),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(a["state"].w_stack.cpu(), b["state"].w_stack, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The tiered cache: K2 on hot slots sorted by row, cached runs on the card
# ---------------------------------------------------------------------------

import numpy as np  # noqa: E402

from repro_torch.data import ctr  # noqa: E402
from repro_torch.embeddings import table as emb  # noqa: E402
from repro_torch.embeddings.cache import CacheConfig  # noqa: E402


def test_sparse_adagrad_on_hot_slots_sorted_by_row_is_bitwise_the_full_table(gen):
    """K2 at the sim's shape (iteration 0 of the full-width stream, 212,992
    occurrences) on a hot tier whose slots are a random permutation: with
    the rows as ``order_ids`` every hot row is bitwise the full table's;
    sorted by slot instead, the runs meet the tiles elsewhere and the sums
    change."""
    cfg = dlrm_ctr.CONFIG
    spec = emb.spec_from_config(cfg)
    rows = (ctr.sparse_ids(cfg, 0, 0, 4 * 4 * 128) + spec.offsets[None, :, None]).reshape(
        -1, cfg.multi_hot)
    uniq = np.unique(rows)
    slot_of = np.full(spec.total_rows, -1, np.int64)
    slot_of[uniq] = np.random.default_rng(0).permutation(len(uniq))
    table = torch.randn((spec.total_rows, spec.dim), generator=gen).cuda()
    acc = torch.rand((spec.total_rows, spec.dim), generator=gen).cuda()
    g = torch.randn((rows.shape[0], spec.dim), generator=gen).cuda()
    hot_of = torch.from_numpy(uniq[np.argsort(slot_of[uniq])]).cuda()  # slot -> row
    rows_t = torch.from_numpy(rows).cuda()
    slots_t = torch.from_numpy(slot_of[rows]).cuda()
    ft, fa = sparse_adagrad_op(table.clone(), acc.clone(), rows_t, g, lr=0.05)
    ht, ha = sparse_adagrad_op(table[hot_of], acc[hot_of], slots_t, g, lr=0.05, order_ids=rows_t)
    assert torch.equal(ht, ft[hot_of]) and torch.equal(ha, fa[hot_of])
    nt, _ = sparse_adagrad_op(table[hot_of], acc[hot_of], slots_t, g, lr=0.05)
    assert not torch.equal(nt, ft[hot_of])


@pytest.mark.parametrize("engine", ["flat", "pytree"])
def test_tiny_cached_sim_on_the_card_is_bitwise_uncached(gen, engine):
    outs = []
    for cache in (None, CacheConfig(hot_frac=0.25, lookahead=2)):
        sim = runners.HogwildSim(dlrm_ctr.tiny(), sync.SyncConfig(gap=4, engine=engine),
                                 n_trainers=2, n_threads=2, batch_size=8,
                                 optimizer=optim.adagrad(0.02), seed=1, cache=cache,
                                 device="cuda")
        outs.append(sim.run(8))
    u, c = outs
    assert u["train_loss"] == c["train_loss"] and c["cache_stats"]["evict_rows"] > 0
    for k in ("table", "acc"):
        assert torch.equal(u["state"].emb_state[k], c["state"].emb_state[k])
        assert c["state"].emb_state[k].is_cuda


def test_tiny_threaded_cached_runs_on_the_card(gen):
    """Two trainer streams, the shadow thread's prefetch migrating between
    rounds; and one fixed_rate trainer bitwise its uncached run."""
    r = runners.ThreadedShadowRunner(dlrm_ctr.tiny(), sync.SyncConfig(gap=2), n_trainers=2,
                                     batch_size=16, optimizer=optim.adagrad(0.02),
                                     cache=CacheConfig(hot_frac=0.3, lookahead=2), device="cuda")
    r.warmup()
    out = r.run(10)
    assert out["iter_count"] == [10, 10] and all(math.isfinite(x) for x in out["train_loss"])
    assert out["cache_stats"]["prefetch_rows"] > 0
    assert torch.isfinite(out["emb_state"]["table"]).all()
    one = []
    for cache in (None, CacheConfig(hot_frac=0.25, lookahead=2)):
        r1 = runners.ThreadedShadowRunner(dlrm_ctr.tiny(), sync.SyncConfig(mode="fixed_rate", gap=4),
                                          n_trainers=1, batch_size=16,
                                          optimizer=optim.adagrad(0.02), supervise=False,
                                          cache=cache, device="cuda")
        one.append(r1.run(12)["emb_state"])
    for k in ("table", "acc"):
        assert torch.equal(one[0][k], one[1][k])


# wide tables (m=1) and 32 examples a step: consecutive batches rarely share
# a row (11 of seed 0's first 12 pairs share none), so the stager stages
WIDE = dict(table_sizes=(200_000,) * 4, n_sparse_features=4, multi_hot=1)


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_sim_on_the_card_is_bitwise_serial(gen, depth, cached):
    """The staged lookups run on the stager's stream and reach the owner
    through ``streams.Published``: bitwise the serial run, with the cache's
    counters equal too (a staged lookup's frequency count is taken by the
    step that consumes it). Each step's ``float(loss)`` waits for the
    owner's stream, so the fence has nothing pending here; the next test
    holds the owner back to test it."""
    cfg = dataclasses.replace(dlrm_ctr.tiny(), **WIDE)
    cache = CacheConfig(hot_rows=4096, lookahead=2) if cached else None
    # the serial run prefetches over the pipelined run's horizon
    cache_s = (dataclasses.replace(cache, lookahead=cache.effective_lookahead(depth))
               if cached else None)
    outs = []
    for p, c in ((None, cache_s), (PipelineConfig(depth=depth), cache)):
        sim = runners.HogwildSim(cfg, sync.SyncConfig(gap=4), n_trainers=4, n_threads=1,
                                 batch_size=8, optimizer=optim.adagrad(0.02), seed=3,
                                 cache=c, pipeline=p, device="cuda")
        outs.append(sim.run(12))
    s, p = outs
    assert s["train_loss"] == p["train_loss"]
    for k in ("table", "acc"):
        assert torch.equal(s["state"].emb_state[k], p["state"].emb_state[k]), k
    assert torch.equal(s["state"].w_stack, p["state"].w_stack)
    ps = p["pipeline_stats"]
    assert ps["overlapped"] > 0 and ps["worker_errors"] == 0, ps
    if cached:
        staged = p["cache_stats"].pop("staged_lookups")
        assert staged == ps["overlapped"] and s["cache_stats"].pop("staged_lookups") == 0
        assert s["cache_stats"] == p["cache_stats"]


SLEEP_CYCLES = 1_000_000_000  # about half a second of one SM's clock


@pytest.mark.parametrize("intact", [True, False], ids=["intact", "removed"])
@pytest.mark.parametrize("guard", ["fence", "hazard"])
def test_the_stager_fence_and_hazard_check_order_the_staged_read(gen, guard, intact):
    """The sim's stager (``HogwildSim._stager``) against an owner stream
    that a sleep holds back ahead of each in-place update, with no host wait
    between the steps (the update's ids are made beforehand: building them
    copies the table offsets from the host, which waits for the stream). "fence": batch 2 shares its rows with batch 0 alone,
    whose update is still pending when ``stage(1)`` stages batch 2, so only
    the stager's wait on the owner's event keeps the staged read after it.
    "hazard": batch 2 shares its rows with batch 1, whose update is
    dispatched after ``stage(1)``, so the hazard check must leave batch 2 to
    the serial lookup. Intact, the plane the step gets equals the lookup
    after every update; with the wait (or the check) removed it differs, so
    the case sees the fault it guards against."""
    cfg = dataclasses.replace(dlrm_ctr.tiny(), **WIDE)
    F, m, d = cfg.n_sparse_features, cfg.multi_hot, cfg.embedding_dim
    sim = runners.HogwildSim(cfg, sync.SyncConfig(gap=4), n_trainers=1, n_threads=1,
                             batch_size=8, optimizer=optim.adagrad(0.02),
                             pipeline=PipelineConfig(depth=2), device="cuda")
    ids = {"a": torch.arange(8), "b": torch.arange(100, 108)}
    order = ["a", "b", "a"] if guard == "fence" else ["a", "b", "b"]
    batches = []
    for t, k in enumerate(order):
        b = sim.make_batch(t)
        b["sparse"] = ids[k].reshape(1, 1, 8, 1, 1).expand(1, 1, 8, F, m).to(
            torch.int32).contiguous().cuda()
        batches.append(b)
    sim.make_batch = lambda it: batches[it]
    st = sim.init_state()
    g = torch.randn((8 * F, d), generator=gen).cuda()
    bags = [emb.global_row_ids(sim.spec, b["sparse"].reshape(-1, F, m)).reshape(-1, m)
            for b in batches]
    torch.cuda.synchronize()

    def update(t):  # the owner's in-place K2 of batch t, held back
        torch.cuda._sleep(SLEEP_CYCLES)
        sparse_adagrad_op(st.emb_state["table"], st.emb_state["acc"], bags[t], g, lr=0.5)

    dev = torch.device("cuda")
    with streams.on(streams.new_stream(dev)):
        pipe, stager = sim._stager(st, None, 3, None)
        if not intact and guard == "fence":
            pipe._make_ctx = lambda: (st.emb_state, None)
        if not intact and guard == "hazard":
            prepare = pipe._prepare
            pipe._prepare = lambda it: {**prepare(it), "rows": [np.empty(0, np.int64)]}
        for t in range(2):
            pipe.consume(t)
            pipe.stage(t)
            update(t)
        staged, _ = pipe.consume(2)
        idx2 = batches[2]["sparse"].reshape(-1, F, m)
        got = (streams.consume(staged[0]) if staged[0] is not None
               else emb.lookup(st.emb_state, sim.spec, idx2))
        pipe.close()
    torch.cuda.synchronize()
    stager.synchronize()
    assert (staged[0] is None) == (guard == "hazard" and intact), pipe.stats
    want = emb.lookup(st.emb_state, sim.spec, idx2)
    assert torch.equal(got, want) == intact


def test_a_policy_readmission_runs_on_the_trainers_stream(gen):
    """The policy decides on the shadow thread; the slot's own trainer
    carries the re-admission out, on the stream its steps run on, so the
    bootstrap's weights and fresh optimizer state are made where the
    trainer reads them."""
    from repro_torch.core.membership import FaultSpec
    from repro_torch.core.scheduler import PolicyConfig, StragglerPolicy

    policy = StragglerPolicy(PolicyConfig(eps_floor_frac=0.5, readmit_frac=0.75, window_s=0.5,
                                          probation_s=0.1, min_active=2), n_slots=3)
    # every slot paced by a short sleep, slot 2 by a long one for 4 iterations
    r = runners.ThreadedShadowRunner(
        dlrm_ctr.tiny(), sync.SyncConfig(alpha=0.5, gap=3), n_trainers=3, batch_size=32,
        optimizer=optim.adagrad(0.02), sync_sleep_s=0.01, eps_window_s=0.25,
        fault_spec=FaultSpec(straggler_sleep_s={0: 0.01, 1: 0.01, 2: 0.3},
                             straggler_until={2: 4}),
        straggler_policy=policy, device="cuda")
    r.warmup()
    admitted, stepped = [], {}
    admit, dense = r._admit_slot, r._train_dense

    def spy_admit(slot, reason=""):
        admitted.append((slot, threading.current_thread().name,
                         torch.cuda.current_stream().cuda_stream))
        admit(slot, reason)

    def spy_dense(*a):
        stepped.setdefault(threading.current_thread().name,
                           torch.cuda.current_stream().cuda_stream)
        return dense(*a)

    r._admit_slot, r._train_dense = spy_admit, spy_dense
    out = r.run(400)
    kinds = [(e.kind, e.slot) for e in out["membership_events"]]
    assert kinds[:3] == [("leave", 2), ("join", 2), ("activate", 2)], out["membership_events"]
    assert [a[:2] for a in admitted] == [(2, "trainer-2")]
    assert admitted[0][2] == stepped["trainer-2"] != torch.cuda.default_stream().cuda_stream
    assert all(math.isfinite(x) for x in out["train_loss"])


def test_a_host_wait_on_the_card_under_a_lock_is_caught(gen):
    """Under the port's lockdep, ``torch.cuda.synchronize()`` (and an event's
    or a stream's ``synchronize()``) inside an instrumented lock raises
    ``BlockedUnderLockError``; outside the lock it waits as before, and a
    launch records the backend's launch locks in the graph."""
    from repro_torch.analysis.lockdep import BlockedUnderLockError, instrument

    with instrument() as g:
        lock = threading.Lock()
        x = torch.randn((64, 16), generator=gen).cuda()
        embedding_bag_op(x, torch.zeros((4, 2), dtype=torch.int32, device="cuda"))
        ev = torch.cuda.Event()
        ev.record()
        for wait in (torch.cuda.synchronize, ev.synchronize,
                     torch.cuda.current_stream().synchronize):
            with pytest.raises(BlockedUnderLockError, match="synchronize"):
                with lock:
                    wait()
        torch.cuda.synchronize()
    assert len(g.violations) == 3
    assert {"backend._BUILD_LOCK", "backend._COUNT_LOCK"} <= g.sites


def test_the_stager_launches_the_kernel(gen):
    """Every step's lookup, staged or serial, is one K1 launch on the card
    (the counter rises only where the kernel launches); and one fixed_rate
    threaded trainer pipelined is bitwise its serial run."""
    cfg = dataclasses.replace(dlrm_ctr.tiny(), **WIDE)
    sim = runners.HogwildSim(cfg, sync.SyncConfig(gap=4), n_trainers=4, n_threads=1,
                             batch_size=8, optimizer=optim.adagrad(0.02),
                             pipeline=PipelineConfig(depth=2), device="cuda")
    st = sim.init_state()
    before = embedding_bag_op.launches
    out = sim.run(8, state=st)
    assert embedding_bag_op.launches - before == 8
    ps = out["pipeline_stats"]
    assert ps["overlapped"] > 0 and ps["overlapped"] + ps["hazard_serialized"] == 7, ps
    outs = []
    for p in (None, PipelineConfig(depth=2)):
        r1 = runners.ThreadedShadowRunner(cfg, sync.SyncConfig(mode="fixed_rate", gap=4),
                                          n_trainers=1, batch_size=32,
                                          optimizer=optim.adagrad(0.02), supervise=False,
                                          pipeline=p, device="cuda")
        outs.append(r1.run(10))
    assert outs[0]["train_loss"] == outs[1]["train_loss"]
    for k in ("table", "acc"):
        assert torch.equal(outs[0]["emb_state"][k], outs[1]["emb_state"][k])
    assert outs[1]["pipeline_stats"]["overlapped"] > 0


def test_checkpoint_round_trip_on_the_card(gen, tmp_path):
    sim = runners.HogwildSim(dlrm_ctr.tiny(), sync.SyncConfig(algo="bmuf", gap=3), n_trainers=3,
                             n_threads=2, batch_size=32, optimizer=optim.adagrad(0.02),
                             device="cuda")
    st = sim.run(4)["state"]
    sim.save_state(str(tmp_path / "ck"), st)
    st2 = sim.load_state(str(tmp_path / "ck"))
    for (k, a), (_, b) in zip(T.leaves_with_path(sim._state_tree(st)),
                              T.leaves_with_path(sim._state_tree(st2))):
        assert b.is_cuda and torch.equal(a, b), k
    assert sim.run(2, state=st)["train_loss"] == sim.run(2, state=st2)["train_loss"]


# ---------------------------------------------------------------------------
# K9 · flash attention, K8 · interaction, and the serving path that runs K9
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402

from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import gqa_attention_op  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref, gqa_attention_ref  # noqa: E402
from repro_torch.kernels.interaction.ops import interaction_op  # noqa: E402
from repro_torch.kernels.interaction.ref import interaction_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ATTN_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}  # the reference's own


@pytest.mark.parametrize("b,s,h,kv,d", [
    (1, 128, 2, 2, 64), (1, 100, 2, 2, 64), (2, 256, 8, 1, 128), (2, 384, 2, 2, 32),
    (2, 200, 4, 2, 128), (1, 1, 4, 1, 64), (1, 33, 2, 1, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(gen, b, s, h, kv, d, causal, dtype):
    q = torch.randn((b, s, h, d), generator=gen).to("cuda", dtype)
    k = torch.randn((b, s, kv, d), generator=gen).to("cuda", dtype)
    v = torch.randn((b, s, kv, d), generator=gen).to("cuda", dtype)
    before = gqa_attention_op.launches
    got = gqa_attention_op(q, k, v, causal=causal)
    assert gqa_attention_op.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = gqa_attention_ref(q, k, v, causal=causal)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_bf16_at_the_prefill_shape(gen):
    """phi3's prefill shape (B=4, S=2048, 40 query / 10 KV heads, d=128),
    bf16, causal. Outputs there are ~0.04, so the reference's 3e-2 (set for
    S <= 384) is too loose: the one rounding of the output to bf16 is held
    at atol 6e-3, rtol 1e-2 and 1e-2 in the relative norm."""
    q = torch.randn((4, 2048, 40, 128), generator=gen).to("cuda", torch.bfloat16)
    k, v = (torch.randn((4, 2048, 10, 128), generator=gen).to("cuda", torch.bfloat16)
            for _ in range(2))
    got = gqa_attention_op(q, k, v, causal=True).float()
    want = gqa_attention_ref(q, k, v, causal=True).float()
    torch.testing.assert_close(got, want, rtol=1e-2, atol=6e-3)
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


@pytest.mark.parametrize("s", [1, 33, 127, 128, 129, 1000])
@pytest.mark.parametrize("n_rep", [1, 4, 8, 48])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_tensor_core_edges(gen, s, n_rep, d, causal):
    """The tensor-core kernel's edges: S about its 128-row tiles (rows and
    keys past S are TMA's zero fill, masked), every GQA ratio of the
    reference's configs up to MQA's 48 query heads a KV head (granite-20b
    and -34b), each head dim (d = 32 takes the 64-byte swizzle).
    The reference's bf16 tolerance, and 1e-2 in the relative norm."""
    q = torch.randn((2, s, 2 * n_rep, d), generator=gen).to("cuda", torch.bfloat16)
    k, v = (torch.randn((2, s, 2, d), generator=gen).to("cuda", torch.bfloat16)
            for _ in range(2))
    got = gqa_attention_op(q, k, v, causal=causal).float()
    want = gqa_attention_ref(q, k, v, causal=causal).float()
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


@pytest.mark.parametrize("s", [1, 33, 63, 64, 65, 127, 1000])
@pytest.mark.parametrize("n_rep", [1, 4, 48])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_tensor_core_edges(gen, s, n_rep, d, causal):
    """The 3xTF32 kernel's edges: S about its 64-row query tiles and its key
    tiles of 32 (d = 128) or 64 (rows and keys past S zero-filled, masked),
    GQA up to MQA's 48 query heads a KV head, each head dim. Three TF32
    products hold f32's accuracy: within 1e-5 of the plain version, well
    inside the reference's 2e-4."""
    q = torch.randn((2, s, 2 * n_rep, d), generator=gen).cuda()
    k, v = (torch.randn((2, s, 2, d), generator=gen).cuda() for _ in range(2))
    got = gqa_attention_op(q, k, v, causal=causal)
    want = gqa_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,h,kv,d,causal", [(4, 3136, 56, 8, 128, True),
                                                (32, 1500, 8, 8, 64, False)],
                         ids=["llava_gqa7", "whisper_encoder"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_the_vlm_and_audio_prefill_shapes(gen, b, s, h, kv, d, causal, dtype):
    """llava-next-34b's prefill (2,880 prefix + 256 text positions, 56 query
    heads on 8 KV heads of 128: a GQA ratio of 7, causal) and whisper's
    encoder (1,500 frames, not a multiple of the 128-row tile, 8 heads of
    64, every key). f32 at the reference's 2e-4; bf16 at the prefill
    shape's atol 6e-3, rtol 1e-2 and 1e-2 in the relative norm."""
    q = torch.randn((b, s, h, d), generator=gen).to("cuda", dtype)
    k, v = (torch.randn((b, s, kv, d), generator=gen).to("cuda", dtype) for _ in range(2))
    got = gqa_attention_op(q, k, v, causal=causal).float()
    want = gqa_attention_ref(q, k, v, causal=causal).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        torch.testing.assert_close(got, want, rtol=1e-2, atol=6e-3)
        assert ((got - want).norm() / want.norm()).item() <= 1e-2


def test_flash_attention_bf16_many_query_tiles(gen):
    """B*H = 96 (b, h) pairs with eight query tiles each (768 blocks, several
    waves of the card), causal, at the prefill shape's tolerance."""
    q = torch.randn((3, 1000, 32, 128), generator=gen).to("cuda", torch.bfloat16)
    k, v = (torch.randn((3, 1000, 4, 128), generator=gen).to("cuda", torch.bfloat16)
            for _ in range(2))
    got = gqa_attention_op(q, k, v, causal=True).float()
    want = gqa_attention_ref(q, k, v, causal=True).float()
    torch.testing.assert_close(got, want, rtol=1e-2, atol=6e-3)
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


def test_flash_attention_bh_form(gen):
    q, k, v = (torch.randn((6, 100, 64), generator=gen).cuda() for _ in range(3))
    for causal in (True, False):
        torch.testing.assert_close(flash_attention(q, k, v, causal=causal),
                                   attention_ref(q, k, v, causal=causal), rtol=2e-4, atol=2e-4)


def test_flash_attention_refuses_what_it_does_not_take(gen):
    q = torch.randn((1, 16, 2, 48)).cuda()
    with pytest.raises(ValueError, match="head dim"):
        gqa_attention_op(q, q, q)
    q = torch.randn((1, 16, 3, 64)).cuda()
    with pytest.raises(ValueError, match="multiple of KV heads"):
        gqa_attention_op(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gqa_attention_op(q.half(), q.half(), q.half())


# (2047, 27, 64): B not a multiple of the kernel's 4-sample tile at DLRM's
# shape; (37, 7, 6): d not a multiple of 4 (staged a value at a time)
@pytest.mark.parametrize("b,f,d", [(64, 9, 16), (128, 27, 64), (100, 5, 32), (2048, 27, 64),
                                   (3, 2, 8), (2047, 27, 64), (37, 7, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interaction_kernel(gen, b, f, d, dtype):
    z = torch.randn((b, f, d), generator=gen).to("cuda", dtype)
    before = interaction_op.launches
    got = interaction_op(z)
    assert interaction_op.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, f * (f - 1) // 2)
    torch.testing.assert_close(got, interaction_ref(z), rtol=1e-5, atol=1e-5)


def test_reduced_phi3_serving_on_the_card_follows_the_cpu(gen):
    """The same weights and prompts: prefill logits and the KV cache within
    2e-4 of the CPU's, the same greedy tokens, K9 once per layer."""
    cfg = dataclasses.replace(reduced(get_config("phi3-medium-14b")), n_kv_heads=2)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = serve.make_prompts(cfg, 2, 100, seed=0)
    cpu = serve.generate(params, cfg, prompts, 8)
    before = gqa_attention_op.launches
    card = serve.generate(T.map(lambda x: x.cuda(), params), cfg, prompts.cuda(), 8)
    assert gqa_attention_op.launches == before + cfg.n_layers
    assert torch.equal(card["tokens"].cpu(), cpu["tokens"])
    for key in ("prefill_logits", "last_logits"):
        torch.testing.assert_close(card[key].cpu(), cpu[key], rtol=2e-4, atol=2e-4)


def test_flash_attention_refuses_an_input_that_needs_a_gradient(gen):
    """K9 has no backward: a CUDA input that requires grad is refused while
    grad mode is on, and runs under no_grad."""
    q = torch.randn((1, 64, 2, 64), generator=gen).cuda().requires_grad_()
    k, v = (torch.randn((1, 64, 2, 64), generator=gen).cuda() for _ in range(2))
    with pytest.raises(RuntimeError, match="no backward"):
        gqa_attention_op(q, k, v)
    with torch.no_grad():
        torch.testing.assert_close(gqa_attention_op(q, k, v), gqa_attention_ref(q, k, v),
                                   rtol=2e-4, atol=2e-4)


def _lm_ops():
    from repro_torch.kernels.bmuf_update.ops import bmuf_sync_op, bmuf_sync_rows_op
    from repro_torch.kernels.gossip_update.ops import gossip_pair_flat_op, gossip_round_op
    from repro_torch.kernels.ma_update import ops as ma_ops

    return (embedding_bag_op, sparse_adagrad_op, easgd_round_op, easgd_pair_flat_op,
            ma_ops.replica_mean_op, ma_ops.replica_mean_rows_op, ma_ops.ma_sync_op,
            ma_ops.ma_sync_rows_op, bmuf_sync_op, bmuf_sync_rows_op, gossip_pair_flat_op,
            gossip_round_op, interaction_op, gqa_attention_op)


@pytest.mark.parametrize("algo", ["easgd", "gossip"])
def test_reduced_lm_step_on_the_card_follows_the_cpu(gen, algo):
    """Two shadow steps and a sync of a reduced minicpm-2b (f32, TF32 off,
    S=1100 so that attention runs two query chunks), the same weights and
    tokens on the card and the CPU: losses and every weight within the
    trajectory tolerance; no kernel of the port launches on the card."""
    from repro_torch.core import spmd
    from repro_torch.data import tokens

    cfg = reduced(get_config("minicpm-2b"))
    params = spmd.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    trans = tokens.make_transition(cfg.vocab_size, seed=0)
    toks = tokens.gen_batch(trans, 0, 0, 2 * 2, 1100)["tokens"].reshape(2, 2, 1100)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for dev in ("cuda", "cpu"):
            stack = spmd.stack_replicas(T.map(lambda x: x.to(dev), params), 2)
            opt = optim.sgd(0.1)
            step = spmd.make_train_step(cfg, opt, "shadow")
            sc = sync.SyncConfig(algo=algo, alpha=0.5)
            ost, state = (), algorithms.get(algo).init_state(T.map(lambda x: x[0], stack), sc)
            ops = _lm_ops()
            before = [op.launches for op in ops]
            losses = []
            for _ in range(2):
                stack, ost, loss = step(stack, ost, {"tokens": toks.to(dev)})
                losses.append(loss.cpu())
            stack, state = spmd.make_sync_step(cfg, sc)(stack, state)
            assert [op.launches for op in ops] == before
            out[dev] = (torch.stack(losses), T.map(lambda x: x.cpu(), stack))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-5)
    for a, b in zip(T.leaves(out["cuda"][1]), T.leaves(out["cpu"][1])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_the_lm_launcher_on_the_card_launches_no_kernel(gen):
    """The training window of ``launch/train.py lm`` on the card: the
    training form of attention and the pytree syncs, no K1-K9 launch; a
    finite loss that falls."""
    from repro_torch.launch import train

    ops = _lm_ops()
    before = [op.launches for op in ops]
    out = train.main(["lm", "--iters", "10", "--batch-size", "4", "--seq-len", "64"])
    assert [op.launches for op in ops] == before
    assert all(math.isfinite(x) for x in out["losses"]) and out["loss_end"] < out["loss_start"]


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-1.5-large-398b", "phi3.5-moe-42b-a6.6b",
                                  "kimi-k2-1t-a32b", "phi3-medium-14b CONFIG_SWA"])
def test_reduced_family_serving_on_the_card_follows_the_cpu(gen, arch):
    """A reduced ssm, hybrid, MoE and windowed config (f32, TF32 off): the
    same weights and prompts on the card and the CPU give the same greedy
    tokens, logits and cache within 2e-4; K9 runs once a prefill for each
    unwindowed attention layer and never for a window."""
    from repro_torch.configs import phi3_medium_14b

    cfg = (reduced(phi3_medium_14b.CONFIG_SWA) if arch.endswith("CONFIG_SWA")
           else reduced(get_config(arch)))
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = serve.make_prompts(cfg, 2, 100, seed=0)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = serve.generate(params, cfg, prompts, 8)
        before = gqa_attention_op.launches
        card = serve.generate(T.map(lambda x: x.cuda(), params), cfg, prompts.cuda(), 8)
        n_attn = 0 if cfg.sliding_window else cfg.layer_kinds().count("A")
        assert gqa_attention_op.launches == before + n_attn
        lc, cc = transformer.prefill(T.map(lambda x: x.cuda(), params), cfg, prompts.cuda(), 108)
        lp, cp = transformer.prefill(params, cfg, prompts, 108)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert torch.equal(card["tokens"].cpu(), cpu["tokens"])
    for key in ("prefill_logits", "last_logits"):
        torch.testing.assert_close(card[key].cpu(), cpu[key], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(lc.cpu(), lp, rtol=2e-4, atol=2e-4)
    for a, b in zip(T.leaves(cc), T.leaves(cp)):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-4)


def test_moe_unroute_on_the_card_is_repeatable(gen):
    """Dispatch, expert products and the un-route (a permutation back to the
    token slots, summed over k in order) have no atomics: the same layer
    twice gives the same bits, bf16 and f32, with and without drops."""
    from repro_torch.models import moe

    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(reduced(get_config("kimi-k2-1t-a32b")),
                                  dtype=str(dtype).split(".")[-1])
        p = T.map(lambda x: x.cuda(), moe.moe_init(torch.Generator().manual_seed(1), cfg, dtype))
        x = torch.randn((4, 256, cfg.d_model), generator=gen).to("cuda", dtype)
        for cf in (None, 1.0):
            y1, a1 = moe.moe_apply(p, x, cfg, capacity_factor=cf)
            y2, a2 = moe.moe_apply(p, x, cfg, capacity_factor=cf)
            assert torch.equal(y1, y2) and torch.equal(a1, a2), (dtype, cf)


def test_mamba2_layer_on_the_card_follows_the_cpu(gen):
    """One reduced mamba2 layer (f32, TF32 off), chunked (L=200: chunks of
    25) and in decode steps: the card within the trajectory tolerance of
    the CPU, and its gradients too."""
    from repro_torch.models import mamba2

    cfg = reduced(get_config("jamba-1.5-large-398b"))
    p = mamba2.mamba2_init(torch.Generator().manual_seed(2), cfg, torch.float32)
    x = torch.randn((2, 200, cfg.d_model), generator=gen)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cuda", "cpu"):
            pd = T.map(lambda a: a.to(dev).requires_grad_(), p)
            y = mamba2.mamba2_apply(pd, x.to(dev), cfg)
            grads = torch.autograd.grad(y.square().mean(), T.leaves(pd))
            cache = mamba2.init_mamba_cache(cfg, 2, torch.float32, device=dev)
            ys = []
            with torch.no_grad():
                for t in range(3):
                    yt, cache = mamba2.mamba2_decode(pd, x[:, t:t + 1].to(dev), cfg, cache)
                    ys.append(yt)
            out[dev] = T.map(lambda a: a.detach().cpu(), (y, grads, ys))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    for a, b in zip(T.leaves(out["cuda"]), T.leaves(out["cpu"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-base"])
def test_reduced_vlm_and_audio_on_the_card_follow_the_cpu(gen, arch):
    """Reduced llava (its image prefix) and whisper (its frames), f32, TF32
    off: the same weights and inputs on the card and the CPU give the same
    greedy tokens and logits within 2e-4, K9 once a prefill for each
    self-attention layer (whisper: the encoder's and the decoder's), and
    one shadow step (SGD) and an EASGD sync at the trajectory tolerance."""
    from repro_torch.core import spmd
    from repro_torch.core.sync import SyncConfig
    from repro_torch.data import tokens as tok

    cfg = reduced(get_config(arch))
    params = spmd.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = serve.make_prompts(cfg, 2, 100, seed=0)
    front = serve.make_frontend(cfg, 2, 0)
    n_attn = cfg.n_layers + (cfg.encoder.n_layers if cfg.family == "audio" else 0)
    toks = tok.gen_batch(tok.make_transition(cfg.vocab_size, seed=1), 1, 0, 4, 64)["tokens"]
    batch = {"tokens": toks.reshape(2, 2, 64),
             **{k: serve.make_frontend(cfg, 4, 1)[k].reshape(2, 2, *v.shape[1:])
                for k, v in front.items()}}
    sc = SyncConfig(algo="easgd", alpha=0.5).validate()
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = serve.generate(params, cfg, prompts, 8, frontend=front)
        before = gqa_attention_op.launches
        card = serve.generate(T.map(lambda x: x.cuda(), params), cfg, prompts.cuda(), 8,
                              frontend=T.map(lambda x: x.cuda(), front))
        assert gqa_attention_op.launches == before + n_attn
        res = {}
        for dev in ("cuda", "cpu"):
            stack = spmd.stack_replicas(T.map(lambda t: t.to(dev), params), 2)
            ps = algorithms.get("easgd").init_state(T.map(lambda t: t[0], stack), sc)
            stack, _, loss = spmd.make_train_step(cfg, optim.sgd(0.1), "shadow")(
                stack, (), T.map(lambda t: t.to(dev), batch))
            stack, ps = spmd.make_sync_step(cfg, sc)(stack, ps)
            res[dev] = T.map(lambda t: t.cpu(), (loss, stack, ps))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert torch.equal(card["tokens"].cpu(), cpu["tokens"])
    for key in ("prefill_logits", "last_logits"):
        torch.testing.assert_close(card[key].cpu(), cpu[key], rtol=2e-4, atol=2e-4)
    for a, b in zip(T.leaves(res["cuda"]), T.leaves(res["cpu"])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)



def test_reduced_parallel_block_on_the_card_follows_the_cpu(gen):
    """Reduced phi3.5-moe with ``parallel_block`` (f32, TF32 off): greedy
    tokens equal, prefill and decode logits and the cache within 2e-4 of
    the CPU's; K9 runs once a prefill for each attention layer."""
    cfg = dataclasses.replace(reduced(get_config("phi3.5-moe-42b-a6.6b")), parallel_block=True)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = serve.make_prompts(cfg, 2, 100, seed=0)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = serve.generate(params, cfg, prompts, 8)
        before = gqa_attention_op.launches
        card = serve.generate(T.map(lambda x: x.cuda(), params), cfg, prompts.cuda(), 8)
        assert gqa_attention_op.launches == before + cfg.n_layers
        lc, cc = transformer.prefill(T.map(lambda x: x.cuda(), params), cfg, prompts.cuda(), 108)
        lp, cp = transformer.prefill(params, cfg, prompts, 108)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert torch.equal(card["tokens"].cpu(), cpu["tokens"])
    for key in ("prefill_logits", "last_logits"):
        torch.testing.assert_close(card[key].cpu(), cpu[key], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(lc.cpu(), lp, rtol=2e-4, atol=2e-4)
    for a, b in zip(T.leaves(cc), T.leaves(cp)):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["granite-20b", "phi3.5-moe-42b-a6.6b"])
def test_save_comm_on_the_card_matches_full_remat(gen, arch):
    """The selective remat on the card: the loss and every gradient within
    rtol 1e-5, atol 1e-6 of full remat's (the reference's own test, S=1100:
    the training attention's chunks rematerialised inside each unit)."""
    cfg = reduced(get_config(arch))
    params = T.map(lambda x: x.cuda(), transformer.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    toks = {"tokens": serve.make_prompts(cfg, 2, 1100, seed=1).cuda()}
    out = {}
    for policy in ("full", "save_comm"):
        p = T.map(lambda a: a.detach().clone().requires_grad_(), params)
        loss = transformer.loss_fn(p, cfg, toks, remat=True, remat_policy=policy)
        out[policy] = (loss.detach(), torch.autograd.grad(loss, T.leaves(p)))
    torch.testing.assert_close(out["save_comm"][0], out["full"][0], rtol=1e-5, atol=1e-6)
    for a, b in zip(out["save_comm"][1], out["full"][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
