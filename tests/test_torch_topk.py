"""Parity of the port's streaming top-k module (scoring, ``zen_topk_scan``,
dispatch, ``knn_search``) with the JAX package, on the CPU.

The JAX side runs its Pallas kernel in interpret mode and its scan
fallback, as its own tests do. Inputs are seeded numpy arrays handed to
both packages; bf16 and int8 storage are encoded by each package's own
codec (byte-identical, see ``test_torch_codec.py``).

Tolerance: rtol 1e-5 / atol 1e-5 on distances. Both sides evaluate the
same f32 norm expansion, in different reduction orders, on O(1)
coordinates (z2 up to ~50, so a few ulps are ~1e-5 at most); ids must be
equal except where a swap is a near-tie within that tolerance
(``repro_torch.testing.topk_mismatch``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # absent where only the port is installed

import jax.numpy as jnp  # noqa: E402

from repro.core import zen as jzen  # noqa: E402
from repro.kernels import quantize as jquant  # noqa: E402
from repro.kernels import scoring as jscoring  # noqa: E402
from repro.kernels import zen_topk as jzt  # noqa: E402
from repro_torch.core import zen as tzen  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quantize as tquant  # noqa: E402
from repro_torch.kernels import scoring as tscoring  # noqa: E402
from repro_torch.kernels import zen_topk as tzt  # noqa: E402
from repro_torch.testing import topk_mismatch  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _x32():
    """Other test modules flip ``jax_enable_x64`` on at import."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _coords(seed, n, k):
    """Apex-like rows: signed base coordinates, non-negative altitude."""
    x = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    x[:, -1] = np.abs(x[:, -1])
    return x


def _encode(x, storage):
    """(jax values, jax scales, torch values, torch scales)."""
    jv, js = jquant.encode_rows(x, storage)
    tv, ts = tquant.encode_rows(torch.from_numpy(x), storage)
    return (jnp.asarray(jv), None if js is None else jnp.asarray(js),
            tv, ts)


def _check(got, want):
    msg = topk_mismatch(got[0], got[1], np.asarray(want[0]),
                        np.asarray(want[1]), **TOL)
    assert msg is None, msg


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["zen", "lwb", "upb"])
def test_scan_matches_jax_kernel_and_scan(mode, storage):
    """Ragged N (not a multiple of the chunk or the kernel tile), so the
    port's clamped tail chunk is exercised."""
    Q, X = _coords(1, 5, 8), _coords(2, 1000, 8)
    jx, js, tx, ts = _encode(X, storage)
    got = tzt.zen_topk_scan(torch.from_numpy(Q), tx, 10, mode, scales=ts,
                            chunk=128)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    _check(got, jzt.zen_topk(jnp.asarray(Q), jx, 10, mode, scales=js,
                             block_n=128, interpret=True))
    _check(got, jzt.zen_topk_scan(jnp.asarray(Q), jx, 10, mode, scales=js,
                                  chunk=128))


@pytest.mark.parametrize("n_index", [6, 130])
def test_n_neighbors_clamped_to_index_size(n_index):
    Q, X = _coords(3, 4, 6), _coords(4, n_index, 6)
    got = tzt.zen_topk_scan(torch.from_numpy(Q), torch.from_numpy(X), 200,
                            "zen", chunk=64)
    assert got[0].shape == (4, n_index)
    assert (np.sort(got[1].numpy(), 1) == np.arange(n_index)).all()
    _check(got, jzt.zen_topk_scan(jnp.asarray(Q), jnp.asarray(X), 200,
                                  "zen", chunk=64))


@pytest.mark.parametrize("mode", ["zen", "lwb", "upb"])
def test_estimators_match_jax(mode):
    Q, X = _coords(5, 7, 9), _coords(6, 33, 9)
    mid = tscoring.MODE_IDS[mode]
    s = np.random.default_rng(7).uniform(0.5, 2, (33, 1)).astype(np.float32)
    got = tscoring.estimate_tile(torch.from_numpy(Q), torch.from_numpy(X),
                                 mode=mid, scale=torch.from_numpy(s))
    want = jscoring.estimate_tile(jnp.asarray(Q), jnp.asarray(X), true_k=9,
                                  mode=mid, scale=jnp.asarray(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    blk = np.stack([X[i:i + 4] for i in range(7)])  # (Q, R, k) per query
    got = tscoring.estimate_rows(torch.from_numpy(Q), torch.from_numpy(blk),
                                 mode=mid)
    want = jscoring.estimate_rows(jnp.asarray(Q), jnp.asarray(blk), mode=mid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tzen.estimate_pdist(torch.from_numpy(Q), torch.from_numpy(X),
                            mode).numpy(),
        np.asarray(jzen.estimate_pdist(jnp.asarray(Q), jnp.asarray(X), mode)),
        **TOL)


def test_estimate_triple_matches_jax():
    Q, X = _coords(8, 6, 5), _coords(9, 20, 5)
    got = tzen.estimate_triple(torch.from_numpy(Q), torch.from_numpy(X))
    want = jzen.estimate_triple(jnp.asarray(Q), jnp.asarray(X))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    lwb, zen, upb = got
    assert (lwb <= zen + 1e-6).all() and (zen <= upb + 1e-6).all()


def test_mask_invalid():
    d = torch.tensor([[1.0, 2.0, 3.0]])
    ids = torch.tensor([[4, -1, 0]], dtype=torch.int32)
    got = tscoring.mask_invalid(d, ids)
    want = jscoring.mask_invalid(jnp.asarray(d.numpy()),
                                 jnp.asarray(ids.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_knn_search_dense_and_streaming_paths_agree(storage):
    """On the CPU ``chunk`` picks the path; both match the JAX dense path."""
    Q, X = _coords(10, 6, 8), _coords(11, 700, 8)
    jx, js, tx, ts = _encode(X, storage)
    tq = torch.from_numpy(Q)
    dense = tzen.knn_search(tq, tx, 12, "lwb", scales=ts)
    stream = tzen.knn_search(tq, tx, 12, "lwb", chunk=256, scales=ts)
    want = jzen.knn_search(jnp.asarray(Q), jx, 12, "lwb", scales=js)
    _check(dense, want)
    _check(stream, want)
    via_ops = tops.zen_topk(tq, tx, 12, "lwb", scales=ts, chunk=256)
    assert torch.equal(via_ops[0], stream[0])
    assert torch.equal(via_ops[1], stream[1])


def test_kernel_wrapper_takes_cuda_tensors_only():
    """On the CPU the kernel wrapper refuses instead of quietly running the
    plain version; ``ops.zen_topk`` is the dispatcher."""
    x = torch.from_numpy(_coords(12, 10, 4))
    before = tzt.zen_topk.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        tzt.zen_topk(x, x, 3)
    assert tzt.zen_topk.launches == before


@pytest.mark.parametrize("nq,n_index,n_out", [
    (64, 1_000_000, 64), (2, 1_000_000, 16), (64, 1_000_003, 128),
    (8, 100, 64), (3, 7, 7), (64, 50_000, 256)])
def test_launch_geometry_covers_the_index(nq, n_index, n_out):
    plan = tzt.launch_geometry(nq, n_index, n_out, 16, 132)
    w, n_split, split_rows = plan.w, plan.n_split, plan.split_rows
    assert w >= n_out and w & (w - 1) == 0
    assert plan.n_lists == tzt._pow2_ceil(n_split)
    assert plan.merge_smem == 8 * plan.n_lists * w <= tzt.SMEM_LIMIT
    assert plan.kernel == ("mma" if w <= 64 else "simt")
    assert split_rows % plan.tile_rows == 0
    assert n_split * split_rows >= n_index           # every row in a split
    assert (n_split - 1) * split_rows < n_index      # no split wholly empty
