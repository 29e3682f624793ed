"""Port vs reference: index assembly, int8 centroid tables, persistence
(``repro_torch.core.index`` / ``indexer`` / ``live.manifest`` against
``repro.core.index`` / ``repro.core.indexer``)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import index as ri  # noqa: E402
from repro.core import indexer as rindexer  # noqa: E402
from repro.data import synthetic as syn  # noqa: E402
from repro_torch.core import index as ti  # noqa: E402
from repro_torch.core import indexer as tindexer  # noqa: E402
from repro_torch.live import manifest as tman  # noqa: E402


@pytest.fixture(scope="module")
def ref_index():
    docs, _ = syn.embedding_corpus(150, dim=32, seed=3)
    return ri.build_index(docs, num_centroids=32, nbits=2, kmeans_iters=3)


def _ref_arrays(idx):
    return {f: np.asarray(getattr(idx, f)) for f in ti.ARRAY_FIELDS}


def _ref_static(idx):
    return {f: getattr(idx, f) for f in ti.STATIC_FIELDS}


def assert_same_index(port, ref_arrays, ref_static):
    for f in ti.ARRAY_FIELDS:
        got = getattr(port, f).numpy()
        want = ref_arrays[f]
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert port.static_dict() == {k: ref_static[k] for k in ti.STATIC_FIELDS}


def test_field_names_dtypes_and_statics_match_reference():
    import dataclasses

    ref_fields = [(f.name, bool(f.metadata.get("static"))) for f in dataclasses.fields(ri.PlaidIndex)]
    port_fields = [(f.name, bool(f.metadata.get("static"))) for f in dataclasses.fields(ti.PlaidIndex)]
    assert port_fields == ref_fields


def test_quantize_centroids_matches_reference_with_half_ties():
    rng = np.random.default_rng(0)
    c = rng.standard_normal((40, 16)).astype(np.float32)
    # row max 127 -> scale exactly 1: entries x.5 hit round-half-to-even
    c[0] = [127, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, 126.5, -126.5, 0, 0, 0, 0, 0, 0, 0]
    c[1] = 0.0  # all-zero row: the 1e-30 scale floor
    want_q, want_s = ri.quantize_centroids(jnp.asarray(c))
    got_q, got_s = ti.quantize_centroids(torch.from_numpy(c))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q[0, :9].tolist() == [127, 0, 2, 2, -2, 0, 4, 126, -126]


def _payload(seed, n_docs=60, K=24, dim=32, nbits=2, empty_centroid=True):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 12, n_docs).astype(np.int32)
    nt = int(lens.sum())
    codes = rng.integers(0, K - int(empty_centroid), nt).astype(np.int32)  # one empty list
    packed = rng.integers(0, 256, (nt, dim * nbits // 8)).astype(np.uint8)
    cents = rng.standard_normal((K, dim)).astype(np.float32)
    cutoffs = np.sort(rng.standard_normal(2**nbits - 1)).astype(np.float32)
    weights = np.sort(rng.standard_normal(2**nbits)).astype(np.float32)
    return cents, codes, packed, lens, cutoffs, weights


@pytest.mark.parametrize("nbits,ivf_list_cap", [(2, None), (4, 5), (1, None)])
def test_assemble_index_array_identical_to_reference(nbits, ivf_list_cap):
    cents, codes, packed, lens, cutoffs, weights = _payload(nbits, nbits=nbits)
    want = ri.assemble_index(
        jnp.asarray(cents), codes, packed, lens, cutoffs=jnp.asarray(cutoffs),
        weights=jnp.asarray(weights), nbits=nbits, ivf_list_cap=ivf_list_cap,
        prune_fraction=0.25,
    )
    got = ti.assemble_index(
        cents, codes, packed, lens, cutoffs=cutoffs, weights=weights, nbits=nbits,
        ivf_list_cap=ivf_list_cap, prune_fraction=0.25, device="cpu",
    )
    assert_same_index(got, _ref_arrays(want), _ref_static(want))


def test_index_assembler_matches_one_shot_and_reference():
    cents, codes, packed, lens, cutoffs, weights = _payload(7)
    want = ri.assemble_index(
        jnp.asarray(cents), codes, packed, lens, cutoffs=jnp.asarray(cutoffs),
        weights=jnp.asarray(weights), nbits=2,
    )
    asm = ti.IndexAssembler(cents, cutoffs=cutoffs, weights=weights, nbits=2, device="cpu")
    bounds = [0, 13, 14, 40, len(lens)]
    offs = np.concatenate([[0], np.cumsum(lens)])
    for a, b in zip(bounds[:-1], bounds[1:]):
        asm.add_chunk(codes[offs[a]:offs[b]], packed[offs[a]:offs[b]], lens[a:b])
    assert asm.num_docs == len(lens) and asm.num_tokens == len(codes)
    assert_same_index(asm.finish(), _ref_arrays(want), _ref_static(want))
    with pytest.raises(RuntimeError, match="twice"):
        asm.finish()


def test_assemble_index_rejects_token_count_mismatch():
    cents, codes, packed, lens, cutoffs, weights = _payload(1)
    with pytest.raises(ValueError, match="doc_lens"):
        ti.assemble_index(cents, codes[:-1], packed[:-1], lens, cutoffs=cutoffs,
                          weights=weights, nbits=2, device="cpu")


def test_index_from_numpy_round_trips(ref_index):
    arrays, static = _ref_arrays(ref_index), _ref_static(ref_index)
    port = ti.index_from_numpy(arrays, static, "cpu")
    assert_same_index(port, arrays, static)
    again = ti.index_from_numpy(port.numpy_arrays(), port.static_dict(), "cpu")
    assert_same_index(again, arrays, static)
    # old indexes without the int8 tables: synthesized bitwise
    legacy = {k: v for k, v in arrays.items() if k not in ("centroids_q", "centroids_scale")}
    assert_same_index(ti.index_from_numpy(legacy, static, "cpu"), arrays, static)
    bad = dict(arrays, codes=arrays["codes"].astype(np.int64))
    with pytest.raises(TypeError, match="codes"):
        ti.index_from_numpy(bad, static, "cpu")


def test_reference_written_directory_loads_array_identical(ref_index, tmp_path):
    rindexer.save_index(str(tmp_path / "v2"), ref_index)
    port = tindexer.load_index(str(tmp_path / "v2"), device="cpu")
    assert_same_index(port, _ref_arrays(ref_index), _ref_static(ref_index))
    rindexer.save_index_v1(str(tmp_path / "v1"), ref_index)
    port1 = tindexer.load_index(str(tmp_path / "v1"), device="cpu")
    assert_same_index(port1, _ref_arrays(ref_index), _ref_static(ref_index))


def test_port_written_directory_loads_in_reference(ref_index, tmp_path):
    port = ti.index_from_numpy(_ref_arrays(ref_index), _ref_static(ref_index), "cpu")
    path = str(tmp_path / "idx")
    tindexer.save_index(path, port)
    back = rindexer.load_index(path)
    assert_same_index(port, _ref_arrays(back), _ref_static(back))
    # the reference's own writer gives the same manifest
    rindexer.save_index(str(tmp_path / "ref"), ref_index)
    with open(os.path.join(path, "manifest.json")) as f:
        mine = json.load(f)
    with open(os.path.join(str(tmp_path / "ref"), "manifest.json")) as f:
        theirs = json.load(f)
    assert mine == theirs


def test_manifest_errors_are_typed(ref_index, tmp_path):
    port = ti.index_from_numpy(_ref_arrays(ref_index), _ref_static(ref_index), "cpu")
    path = str(tmp_path / "idx")
    tindexer.save_index(path, port)
    npz = os.path.join(path, "seg_000000", "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(100)
    with pytest.raises(tman.PayloadCorruptError):
        tindexer.load_index(path, device="cpu")
    os.unlink(npz)
    with pytest.raises(tman.PayloadMissingError):
        tindexer.load_index(path, device="cpu")
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write('{"format_version": 9}')
    with pytest.raises(ValueError, match="format_version"):
        tindexer.load_index(path, device="cpu")


def test_live_directories_are_refused(ref_index, tmp_path):
    from repro.live import manifest as rman

    path = str(tmp_path / "live")
    rman.save_segmented(path, [ref_index, ref_index], [0, 1], None, generation=3)
    with pytest.raises(ValueError, match="live index"):
        tindexer.load_index(path, device="cpu")
