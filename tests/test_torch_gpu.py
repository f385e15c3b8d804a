"""Hopper kernel tests: they need a CUDA card and skip without one.

Run them on the card with ``python -m pytest -m gpu tests/test_torch_*.py``.
Whether a card is present is decided inside each test (the ``cuda``
fixture), never at import or collection, so every test worker collects the
same tests.

The kernel is held to its plain PyTorch version on the same CUDA tensors:
rtol 1e-5 / atol 1e-5 on distances of O(1) coordinates (the same f32 norm
expansion, summed in another order), ids equal outside near-ties.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as quant  # noqa: E402
from repro_torch.kernels import zen_topk as zt  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.testing import topk_mismatch  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels cannot run here)")
    return torch.device("cuda")


def _coords(seed, n, k, dev):
    x = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    x[:, -1] = np.abs(x[:, -1])
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["zen", "lwb", "upb"])
@pytest.mark.parametrize("nq,n_index,k,n", [
    (64, 100_003, 16, 64), (2, 5_000, 16, 10), (9, 70, 8, 128),
    (5, 3_000, 40, 256), (64, 20_000, 256, 16), (3, 1, 4, 5)])
def test_kernel_matches_plain(cuda, storage, mode, nq, n_index, k, n):
    q = _coords(0, nq, k, cuda)
    x, s = quant.encode_rows(_coords(1, n_index, k, cuda), storage)
    before = zt.zen_topk.launches
    got = zt.zen_topk(q, x, n, mode, scales=s)
    torch.cuda.synchronize()
    assert zt.zen_topk.launches == before + 1
    want = zt.zen_topk_scan(q, x, n, mode, scales=s)
    msg = topk_mismatch(got[0], got[1], want[0], want[1], **TOL)
    assert msg is None, msg


def test_dead_rows_never_win(cuda):
    x = _coords(2, 9_000, 16, cuda)
    index = serve.ZenIndex(None, x, None).delete(list(range(0, 9_000, 3)))
    d, ids = ops.zen_topk(_coords(3, 16, 16, cuda), index.coords, 64)
    assert (ids % 3 != 0).all() and torch.isfinite(d).all()


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = _coords(4, 4, 300, cuda)
    with pytest.raises(ValueError, match="k <= 256"):
        zt.zen_topk(q, q, 3)
    q = _coords(5, 4, 8, cuda)
    with pytest.raises(ValueError, match="n_neighbors <= 256"):
        zt.zen_topk(q, _coords(6, 1000, 8, cuda), 300)
    with pytest.raises(ValueError, match="dtype"):
        zt.zen_topk(q, q.double(), 3)


def test_server_on_card_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(0)
    corpus = torch.randn((6_000, 48), generator=gen)
    queries = torch.randn((20, 48), generator=gen)
    pivots = list(range(0, 6_000, 500))
    for storage in quant.SCALAR_STORAGE_DTYPES:
        got = serve.ZenServer(serve.build_index(
            corpus, 12, storage=storage, pivot_ids=pivots, device=cuda),
            rerank_factor=4).query(queries, 10)
        want = serve.ZenServer(serve.build_index(
            corpus, 12, storage=storage, pivot_ids=pivots, device="cpu"),
            rerank_factor=4, chunk=1024).query(queries, 10)
        msg = topk_mismatch(got[0], got[1], want[0], want[1], rtol=1e-4,
                            atol=1e-4)
        assert msg is None, (storage, msg)
