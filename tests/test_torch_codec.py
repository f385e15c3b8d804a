"""The port's storage codec and top-k merge against the JAX package, on the
CPU: both are exact (no tolerance). Quantised codes, bf16 bit patterns and
scales must be byte-identical, and the merge must keep ``lax.top_k``'s tie
order, which ``torch.topk`` does not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # absent where only the port is installed

import jax.numpy as jnp  # noqa: E402

from repro.kernels import quantize as jquant  # noqa: E402
from repro.kernels import scoring as jscoring  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.kernels import quantize as tquant  # noqa: E402
from repro_torch.kernels import scoring as tscoring  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402


def _rows(seed, n=64, k=12):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, k)) * rng.uniform(1e-3, 1e3, (n, 1)))
    x = x.astype(np.float32)
    x[3] = 0.0             # all-zero row: the scale floor
    x[5, 2] = 1.0e15       # the dead-row sentinel magnitude
    x[7] = np.float32(1.00390625)  # an exact bf16 rounding tie (1 + 2^-8)
    return x


def test_merge_topk_keeps_lax_tie_order():
    """``[1, .5, .5, .2, .5]``: lax.top_k gives positions 3,1,2,4; the
    running best sits before new candidates and wins ties against them."""
    x = np.array([[1.0, 0.5, 0.5, 0.2, 0.5]], np.float32)
    neg, pos = jax.lax.top_k(-jnp.asarray(x), 4)
    assert np.asarray(pos).tolist() == [[3, 1, 2, 4]]
    best_d = torch.tensor([[0.2, 0.5, 0.5]])
    best_i = torch.tensor([[9, 2, 7]], dtype=torch.int32)
    new_d = torch.tensor([[0.5, 0.1, 0.2, 0.5]])
    new_i = torch.tensor([[0, 1, 3, 4]], dtype=torch.int32)
    got = tscoring.merge_topk(best_d, best_i, new_d, new_i, 5)
    want = jscoring.merge_topk(*(jnp.asarray(t.numpy()) for t in
                                 (best_d, best_i, new_d, new_i)), 5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].tolist() == [[1, 9, 3, 2, 7]]


def test_merge_topk_random_ties_match_lax():
    rng = np.random.default_rng(3)
    best = np.sort(rng.integers(0, 6, (5, 8)), 1).astype(np.float32)
    new = rng.integers(0, 6, (5, 20)).astype(np.float32)
    bi = rng.permutation(40)[:8].astype(np.int32)[None].repeat(5, 0)
    ni = (100 + np.arange(20, dtype=np.int32))[None]
    got = tscoring.merge_topk(torch.from_numpy(best), torch.from_numpy(bi),
                              torch.from_numpy(new), torch.from_numpy(ni), 8)
    want = jscoring.merge_topk(jnp.asarray(best), jnp.asarray(bi),
                               jnp.asarray(new), jnp.asarray(ni), 8)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_encode_rows_is_byte_exact(storage):
    x = _rows(0)
    jv, js = jquant.encode_rows(x, storage)
    tv, ts = tquant.encode_rows(torch.from_numpy(x), storage)
    assert tv.dtype == tquant.torch_dtype(storage)
    if storage == "bfloat16":  # compare the bit patterns
        np.testing.assert_array_equal(tv.view(torch.int16).numpy(),
                                      np.asarray(jv).view(np.int16))
    else:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (ts is None) == (js is None)
    if ts is not None:
        np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_array_equal(
            tquant.dequantize(tv, ts).numpy(), jquant.dequantize(jv, js))


def test_quantize_round_trip_and_menu():
    x = _rows(1)
    s = tquant.row_scales(torch.from_numpy(x))
    np.testing.assert_array_equal(s.numpy(), jquant.row_scales(x))
    q = tquant.quantize(torch.from_numpy(x), s)
    np.testing.assert_array_equal(q.numpy(), jquant.quantize(x, s.numpy()))
    assert q.abs().amax(1).eq(127).logical_or(torch.from_numpy(
        np.abs(x).max(1) == 0)).all()  # each row's absmax lands on 127
    assert tquant.SCALAR_STORAGE_DTYPES == jquant.SCALAR_STORAGE_DTYPES
    assert tquant.STORAGE_DTYPES == jquant.STORAGE_DTYPES
    with pytest.raises(ValueError, match="IVF-only"):
        tquant.encode_rows(torch.from_numpy(x), "pq")
    with pytest.raises(ValueError, match="storage must be one of"):
        tquant.encode_rows(torch.from_numpy(x), "fp8")


def test_dispatch_buckets_match_jax():
    assert tsched.DEFAULT_NEIGHBOR_MENU == jsched.DEFAULT_NEIGHBOR_MENU
    assert tsched.MIN_Q_BUCKET == jsched.MIN_Q_BUCKET
    for q in range(1, 140):
        assert tsched.bucket_q(q) == jsched.bucket_q(q)
        assert tsched.bucket_q(q, 64) == jsched.bucket_q(q, 64)
    for n in range(1, 300):
        assert tsched.bucket_neighbors(n) == jsched.bucket_neighbors(n)
