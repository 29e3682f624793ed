"""Port vs reference: the residual codec (``repro_torch.core.residual_codec``
against ``repro.core.residual_codec``) on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import residual_codec as rc  # noqa: E402
from repro_torch.core import residual_codec as trc  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _codec_pair(nbits, rng):
    resid = rng.standard_normal((400, 32)).astype(np.float32) * 0.05
    return rc.fit_codec(jnp.asarray(resid), nbits), trc.fit_codec(_t(resid), nbits)


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_pack_unpack_match_reference(nbits):
    rng = np.random.default_rng(nbits)
    idx = rng.integers(0, 2**nbits, (7, 5, 64)).astype(np.uint8)
    want = np.asarray(rc.pack_indices(jnp.asarray(idx), nbits))
    got = trc.pack_indices(_t(idx), nbits).numpy()
    np.testing.assert_array_equal(got, want)
    packed = rng.integers(0, 256, (9, 64 * nbits // 8)).astype(np.uint8)
    np.testing.assert_array_equal(
        trc.unpack_indices(_t(packed), nbits).numpy(),
        np.asarray(rc.unpack_indices(jnp.asarray(packed), nbits)),
    )
    np.testing.assert_array_equal(trc.unpack_indices(_t(got), nbits).numpy(), idx)


def test_pack_rejects_ragged_dim():
    with pytest.raises(ValueError, match="divisible"):
        trc.pack_indices(torch.zeros(3, 5, dtype=torch.uint8), 2)


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_fit_bucketize_compress_decompress_match_reference(nbits):
    rng = np.random.default_rng(10 + nbits)
    ref_codec, codec = _codec_pair(nbits, rng)
    np.testing.assert_array_equal(codec.cutoffs.numpy(), np.asarray(ref_codec.cutoffs))
    np.testing.assert_array_equal(codec.weights.numpy(), np.asarray(ref_codec.weights))
    # from here on both sides use the SAME tables, so results are exact
    codec = trc.ResidualCodec(_t(np.asarray(ref_codec.cutoffs)), _t(np.asarray(ref_codec.weights)), nbits)
    x = rng.standard_normal((50, 32)).astype(np.float32) * 0.05
    # include values exactly on the cutoffs: searchsorted side="right"
    x[0, : codec.cutoffs.numel()] = codec.cutoffs.numpy()
    np.testing.assert_array_equal(
        trc.bucketize(codec, _t(x)).numpy(), np.asarray(rc.bucketize(ref_codec, jnp.asarray(x)))
    )
    packed = trc.compress_residuals(codec, _t(x))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(rc.compress_residuals(ref_codec, jnp.asarray(x)))
    )
    np.testing.assert_array_equal(
        trc.decompress_residuals(codec, packed).numpy(),
        np.asarray(rc.decompress_residuals(ref_codec, jnp.asarray(packed.numpy()))),
    )


@pytest.mark.parametrize("nbits", [2, 4])
def test_assign_compress_decompress_match_reference(nbits):
    rng = np.random.default_rng(20 + nbits)
    ref_codec, _ = _codec_pair(nbits, rng)
    codec = trc.ResidualCodec(_t(np.asarray(ref_codec.cutoffs)), _t(np.asarray(ref_codec.weights)), nbits)
    cents = rng.standard_normal((24, 32)).astype(np.float32)
    emb = (cents[rng.integers(0, 24, 80)] + 0.05 * rng.standard_normal((80, 32))).astype(np.float32)
    want_codes, want_packed = rc.compress(ref_codec, jnp.asarray(emb), jnp.asarray(cents))
    codes, packed = trc.compress(codec, _t(emb), _t(cents))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want_packed))
    assert codes.dtype == torch.int32 and packed.dtype == torch.uint8
    np.testing.assert_array_equal(
        trc.decompress(codec, codes, packed, _t(cents)).numpy(),
        np.asarray(rc.decompress(ref_codec, want_codes, want_packed, jnp.asarray(cents))),
    )


def test_fit_codec_above_2_pow_24_elements():
    """``torch.quantile`` refuses > 2**24 elements; fit_codec must not."""
    rng = np.random.default_rng(5)
    resid = (rng.standard_normal(2**24 + 3) * 0.03).astype(np.float32)
    codec = trc.fit_codec(_t(resid), 2)
    ref_codec = rc.fit_codec(jnp.asarray(resid), 2)
    np.testing.assert_array_equal(codec.cutoffs.numpy(), np.asarray(ref_codec.cutoffs))
    np.testing.assert_array_equal(codec.weights.numpy(), np.asarray(ref_codec.weights))


@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("n", [7, 50, 1001, 4099, 20000])
def test_fit_codec_is_bit_identical_to_reference(nbits, n):
    """Cutoffs and weights equal ``jnp.quantile``'s in every bit.  The sizes
    put most quantile positions between two samples, where XLA rounds the
    interpolation as ``fma(high, w_high, f32(low * w_low))``."""
    rng = np.random.default_rng(100 * nbits + n)
    for scale in (0.03, 1.0):
        resid = (rng.standard_normal(n) * scale).astype(np.float32)
        codec = trc.fit_codec(_t(resid), nbits)
        ref_codec = rc.fit_codec(jnp.asarray(resid), nbits)
        np.testing.assert_array_equal(codec.cutoffs.numpy(), np.asarray(ref_codec.cutoffs))
        np.testing.assert_array_equal(codec.weights.numpy(), np.asarray(ref_codec.weights))


def test_frozen_centroid_build_with_fitted_codec_is_array_identical():
    """With the reference's trained centroids frozen, both packages fit the
    codec on the same residuals; the fit is bit-identical, so every array
    of the two indexes is too."""
    from repro.core import index as ri
    from repro.data import synthetic as syn
    from repro_torch.core import index as ti

    docs, _ = syn.embedding_corpus(150, dim=32, seed=3)
    docs = [np.asarray(d, np.float32) for d in docs]
    cents = np.asarray(ri.build_index(docs, num_centroids=32, nbits=2, kmeans_iters=3).centroids)
    want = ri.build_index(docs, centroids=cents, nbits=2)
    got = ti.build_index(docs, centroids=cents, nbits=2, device="cpu")
    for f in ti.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


def test_fit_codec_rejects_unsupported_nbits():
    with pytest.raises(ValueError, match="nbits"):
        trc.fit_codec(torch.zeros(10), 3)
