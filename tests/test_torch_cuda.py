"""The hand-written CUDA kernels against their plain versions, on the card.

These need a CUDA card and nvcc, and skip elsewhere. Run them on the card with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.easgd_update.ops import easgd_round_op  # noqa: E402
from repro_torch.kernels.easgd_update.ref import easgd_round_ref  # noqa: E402
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
