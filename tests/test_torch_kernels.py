"""The kernels' plain PyTorch versions against the reference (K1 and K2:
the Pallas kernels of ``repro.kernels.ops`` in interpret mode on the CPU;
K3: the reference's plain version), and the CUDA kernels against their
plain versions (``gpu`` marker: needs a card, skips here).

Tolerance: rtol = atol = 1e-5 on scores.  The port sums in another order
than XLA (the kernels' 32-lane butterfly), which moves the last bits of a
float32 sum of 32 terms; on the card, kernel and plain version share one
order and agree bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the reference; a host with only the port installed runs the gpu cases
    import jax.numpy as jnp
    from repro.kernels import ops as rops
    from repro.kernels import ref as rref
except ImportError:
    jnp = rops = rref = None

from repro_torch.kernels import decompress as tdec  # noqa: E402
from repro_torch.kernels import fused_score as tfs  # noqa: E402
from repro_torch.kernels import maxsim as tms  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def reference():
    if rops is None:
        pytest.skip("needs jax and the repro package (the reference)")


def _t(x, device="cpu"):
    return torch.from_numpy(np.array(x)).to(device)


def k1_inputs(seed, B=3, nd=37, L=13, K=40, nq=12):
    """Scattered -1 pads (not a suffix), pruned centroids, masked queries;
    nd is not a multiple of the Pallas doc_block."""
    rng = np.random.default_rng(seed)
    return dict(
        s_cq=rng.standard_normal((B, K, nq)).astype(np.float32),
        codes=rng.integers(-1, K, (B, nd, L)).astype(np.int32),
        keep=rng.random((B, K)) > 0.3,
        q_mask=(rng.random((B, nq)) > 0.15).astype(np.float32),
    )


def k2_inputs(seed, nbits, B=2, nd=11, L=9, K=24, nq=6, d=32):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, K, (B, nd, L)).astype(np.int32)
    return dict(
        q=rng.standard_normal((B, nq, d)).astype(np.float32),
        q_mask=(rng.random((B, nq)) > 0.2).astype(np.float32),
        codes=codes,
        packed_res=rng.integers(0, 256, (B, nd, L, d * nbits // 8)).astype(np.uint8),
        tok_valid=(codes >= 0) & (rng.random((B, nd, L)) > 0.2),
        centroids=rng.standard_normal((K, d)).astype(np.float32),
        weights=np.sort(rng.standard_normal(2**nbits)).astype(np.float32),
    )


def k3_inputs(seed, nbits, B=2, n3=7, n_docs=30, maxlen=10, K=24, nq=6, d=32):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, maxlen + 1, n_docs).astype(np.int32)
    lens[3] = maxlen
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    nt = int(offs[-1])
    pids = rng.integers(-1, n_docs, (B, n3)).astype(np.int32)
    pids[0, 0] = -1
    pids[1, -1] = n_docs - 1  # the passage at the very end of the token arrays
    return dict(
        qs=rng.standard_normal((B, nq, d)).astype(np.float32),
        q_masks=(rng.random((B, nq)) > 0.2).astype(np.float32),
        final_pids=pids,
        codes_tok=rng.integers(0, K, nt).astype(np.int32),
        residuals_tok=rng.integers(0, 256, (nt, d * nbits // 8)).astype(np.uint8),
        doc_offsets=offs,
        doc_lens=lens,
        centroids=rng.standard_normal((K, d)).astype(np.float32),
        weights=np.sort(rng.standard_normal(2**nbits)).astype(np.float32),
    )


@pytest.mark.parametrize("seed,nq", [(0, 12), (1, 32), (2, 40)])
@pytest.mark.parametrize("with_keep", [True, False])
def test_k1_plain_matches_pallas(reference, seed, nq, with_keep):
    a = k1_inputs(seed, nq=nq)
    keep = a["keep"] if with_keep else None
    want = rops.centroid_interaction_batched(
        jnp.asarray(a["s_cq"]), jnp.asarray(a["codes"]), jnp.asarray(a["q_mask"]),
        None if keep is None else jnp.asarray(keep), interpret=True, doc_block=8,
    )
    got = tref.centroid_interaction_batched_ref(
        _t(a["s_cq"]), _t(a["codes"]), None if keep is None else _t(keep), _t(a["q_mask"])
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the engine entry point on CPU tensors is the plain version
    np.testing.assert_array_equal(
        tops.centroid_interaction_batched(
            _t(a["s_cq"]), _t(a["codes"]), _t(a["q_mask"]),
            None if keep is None else _t(keep)).numpy(),
        got.numpy(),
    )


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_k2_plain_matches_pallas(reference, nbits):
    a = k2_inputs(10 + nbits, nbits)
    want = rops.decompress_and_score_batched(
        *(jnp.asarray(a[k]) for k in ("q", "q_mask", "codes", "packed_res", "tok_valid",
                                      "centroids", "weights")),
        nbits=nbits, interpret=True, doc_block=4,
    )
    got = tref.decompress_and_score_batched_ref(
        *(_t(a[k]) for k in ("q", "q_mask", "codes", "packed_res", "tok_valid",
                             "centroids", "weights")),
        nbits=nbits,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


_K3_ARGS = ("qs", "q_masks", "final_pids", "codes_tok", "residuals_tok",
            "doc_offsets", "doc_lens", "centroids", "weights")


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_k3_plain_matches_reference_on_valid_lanes(reference, nbits):
    """Against the reference's plain K3 (``repro.kernels.ref``): its Pallas
    K3 uses ``pl.Unblocked``, which jax 0.9 no longer has, so it cannot run
    in interpret mode here; the reference's own K3 tests fail the same way."""
    a = k3_inputs(20 + nbits, nbits)
    want = np.asarray(rref.gather_decompress_maxsim_ref(
        *(jnp.asarray(a[k]) for k in _K3_ARGS), nbits=nbits, doc_maxlen=10,
    ))
    got = tref.gather_decompress_maxsim_ref(
        *(_t(a[k]) for k in _K3_ARGS), nbits=nbits, doc_maxlen=10
    ).numpy()
    ok = a["final_pids"] >= 0  # the reference pins pad lanes in its caller
    np.testing.assert_allclose(got[ok], want[ok], **TOL)
    # a pid == -1 lane has no tokens: sum_i NEG * q_mask
    from repro_torch.constants import NEG

    pad = ~ok
    expect = (NEG * a["q_masks"]).sum(-1)[:, None].repeat(a["final_pids"].shape[1], 1)
    np.testing.assert_allclose(got[pad], expect[pad], rtol=1e-6)


def test_k3_plain_equals_k2_plain_on_gathered_blocks():
    from repro_torch.core import scoring

    a = k3_inputs(5, 2)
    t = {k: _t(v) for k, v in a.items()}
    fused = tref.gather_decompress_maxsim_ref(*(t[k] for k in _K3_ARGS), nbits=2, doc_maxlen=10)
    flat = t["final_pids"].reshape(-1)
    codes, valid = scoring.gather_doc_tokens(t["codes_tok"], t["doc_offsets"], t["doc_lens"], flat, 10, -1)
    res, _ = scoring.gather_doc_tokens(t["residuals_tok"], t["doc_offsets"], t["doc_lens"], flat, 10, 0)
    B, n3 = a["final_pids"].shape
    unfused = tref.decompress_and_score_batched_ref(
        t["qs"], t["q_masks"], codes.reshape(B, n3, 10), res.reshape(B, n3, 10, -1),
        valid.reshape(B, n3, 10), t["centroids"], t["weights"], nbits=2,
    )
    assert torch.equal(fused, unfused)


def test_cpu_calls_are_not_launches_and_other_devices_are_refused():
    tops.reset_launch_counts()
    a = k1_inputs(3)
    tms.centroid_interaction_batched(_t(a["s_cq"]), _t(a["codes"]), _t(a["keep"]), _t(a["q_mask"]))
    assert tops.launch_counts() == {
        "centroid_interaction_batched": 0,
        "decompress_and_score_batched": 0,
        "gather_decompress_maxsim": 0,
        "flash_attention": 0,
    }
    meta = torch.empty((1, 4, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tms.centroid_interaction_batched(meta, meta.int(), meta.bool()[..., 0], meta[..., 0])


def test_kernel_modules_import_without_building():
    """Importing the wrappers compiles nothing (no nvcc on the CPU hosts)."""
    from repro_torch.kernels import _build

    assert _build._LIBS == {}
    assert {p.name for p in _build.sources()} == {
        "maxsim.cu", "decompress.cu", "fused_score.cu", "flash_attention.cu",
    }


# --------------------------------------------------------------------------
# On the card: each kernel against its plain version
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("nq", [12, 32, 40])
def test_k1_kernel_matches_plain_on_card(cuda, nq):
    a = {k: _t(v, cuda) for k, v in k1_inputs(7, nq=nq).items()}
    before = tms.launches
    got = tms.centroid_interaction_batched(a["s_cq"], a["codes"], a["keep"], a["q_mask"])
    want = tref.centroid_interaction_batched_ref(a["s_cq"], a["codes"], a["keep"], a["q_mask"])
    torch.cuda.synchronize()
    assert tms.launches == before + 1
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_k2_kernel_matches_plain_on_card(cuda, nbits):
    a = {k: _t(v, cuda) for k, v in k2_inputs(8, nbits).items()}
    args = [a[k] for k in ("q", "q_mask", "codes", "packed_res", "tok_valid", "centroids", "weights")]
    got = tdec.decompress_and_score_batched(*args, nbits=nbits)
    want = tref.decompress_and_score_batched_ref(*args, nbits=nbits)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_k3_kernel_matches_plain_on_card(cuda, nbits):
    a = {k: _t(v, cuda) for k, v in k3_inputs(9, nbits).items()}
    args = [a[k] for k in _K3_ARGS]
    got = tfs.gather_decompress_maxsim(*args, nbits=nbits, doc_maxlen=10)
    want = tref.gather_decompress_maxsim_ref(*args, nbits=nbits, doc_maxlen=10)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
def test_wrappers_check_their_arguments_on_card(cuda):
    a = {k: _t(v, cuda) for k, v in k1_inputs(4).items()}
    with pytest.raises(TypeError, match="codes"):
        tms.centroid_interaction_batched(a["s_cq"], a["codes"].long(), a["keep"], a["q_mask"])
    with pytest.raises(ValueError, match="contiguous"):
        tms.centroid_interaction_batched(
            a["s_cq"].transpose(1, 2).contiguous().transpose(1, 2), a["codes"], a["keep"], a["q_mask"]
        )
