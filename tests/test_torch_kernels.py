"""The kernels' plain PyTorch versions against the reference (K1, K2, K4,
K5 and K6: the Pallas kernels of ``repro.kernels.ops`` in interpret mode on
the CPU; K3: the reference's plain version), and the CUDA kernels against
their plain versions (``gpu`` marker: needs a card, skips here).

Tolerance: rtol = atol = 1e-5 on scores.  The port sums in another order
than XLA (the kernels' 32-lane butterfly), which moves the last bits of a
float32 sum of 32 terms; on the card, kernel and plain version share one
order and agree bit for bit: K1, K2, K3, K5 and K6 are held with
``torch.equal``.  K4 is a table lookup and is held exactly.
"""
import types

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


_K2_ARGS = ("q", "q_mask", "codes", "packed_res", "tok_valid", "centroids", "weights")


def _k2_whole_block(q, q_mask, codes, packed_res, tok_valid, centroids, weights, *, nbits):
    """K2 as one expression over whole blocks: every slot's every token is
    decompressed and scored, invalid ones then set to NEG."""
    from repro_torch.constants import NEG
    from repro_torch.core import scoring

    safe = torch.where(codes >= 0, codes, 0).long()
    emb = centroids.float()[safe] + tref.decompress_residuals_ref(
        packed_res, weights.float(), nbits=nbits)
    emb_t = emb.transpose(-1, -2).contiguous()  # (B, nd, d, L)
    scores = scoring.dot_in_order(q.float()[:, None, :, :, None], emb_t[:, :, None, :, :])
    scores = torch.where(tok_valid[:, :, None, :], scores, NEG)  # (B, nd, nq, L)
    return scoring.lane_tree_sum(scores.amax(dim=-1) * q_mask.float()[:, None, :])


@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("seed,nq,d", [(7, 6, 32), (8, 33, 128)])
def test_k2_plain_equals_whole_block_formulation(nbits, seed, nq, d):
    """K2's plain version scores each lane's valid tokens only; that must
    not change a bit against scoring every token of the block, on ragged
    blocks: a lane and a slot with no valid token, -1 codes (invalid, and
    one marked valid, which reads centroid 0 as the kernel does)."""
    a = k2_inputs(seed, nbits, B=3, nq=nq, d=d)
    a["tok_valid"][1] = False
    a["tok_valid"][0, 2] = False
    a["codes"][2, 3, :4] = -1
    a["tok_valid"][2, 3, :3] = False
    a["tok_valid"][2, 3, 3] = True
    t = [_t(a[k]) for k in _K2_ARGS]
    got = tref.decompress_and_score_batched_ref(*t, nbits=nbits)
    want = _k2_whole_block(*t, nbits=nbits)
    assert got.shape == (3, a["codes"].shape[1])
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# K4 (decompress_residuals) and the single-query K5 / K6
# --------------------------------------------------------------------------
@pytest.mark.parametrize("nbits", [1, 2, 4])
@pytest.mark.parametrize("lead", [(37,), (3, 7, 5)])
def test_k4_plain_matches_pallas_exactly(reference, nbits, lead):
    """Any leading dims flatten into one call, as ``repro.kernels.ops``
    flattens them; ``row_block`` does not divide the row count."""
    rng = np.random.default_rng(30 + nbits)
    packed = rng.integers(0, 256, (*lead, 64 * nbits // 8)).astype(np.uint8)
    weights = np.sort(rng.standard_normal(2**nbits)).astype(np.float32)
    want = np.asarray(rops.decompress_residuals(
        jnp.asarray(packed), jnp.asarray(weights), nbits=nbits, interpret=True, row_block=16,
    ))
    got = tops.decompress_residuals(_t(packed), _t(weights), nbits=nbits).numpy()
    assert got.shape == want.shape == (*lead, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tref.decompress_residuals_ref(_t(packed), _t(weights), nbits=nbits).numpy(), want
    )


@pytest.mark.parametrize("seed,nq", [(0, 12), (1, 40)])
@pytest.mark.parametrize("with_keep", [True, False])
def test_k5_plain_matches_pallas(reference, seed, nq, with_keep):
    a = k1_inputs(40 + seed, B=1, nq=nq)
    s_cq, codes, q_mask = a["s_cq"][0], a["codes"][0], a["q_mask"][0]
    keep = a["keep"][0] if with_keep else None
    want = rops.centroid_interaction(
        jnp.asarray(s_cq), jnp.asarray(codes), jnp.asarray(q_mask),
        None if keep is None else jnp.asarray(keep), interpret=True, doc_block=8,
    )
    got = tops.centroid_interaction(
        _t(s_cq), _t(codes), _t(q_mask), None if keep is None else _t(keep)
    )
    assert got.shape == (codes.shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_k6_plain_matches_pallas(reference, nbits):
    a = k2_inputs(50 + nbits, nbits, B=1)
    args = ("q", "q_mask", "codes", "packed_res", "tok_valid")
    want = rops.decompress_and_score(
        *(jnp.asarray(a[k][0]) for k in args),
        jnp.asarray(a["centroids"]), jnp.asarray(a["weights"]),
        nbits=nbits, interpret=True, doc_block=4,
    )
    got = tops.decompress_and_score(
        *(_t(a[k][0]) for k in args), _t(a["centroids"]), _t(a["weights"]), nbits=nbits
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_single_query_plain_versions_are_lanes_of_the_batched_ones():
    """K5 / K6's plain versions equal one lane of K1 / K2's bit for bit:
    the kernels they stand for are the batched kernels at B=1."""
    a = {k: _t(v) for k, v in k1_inputs(6).items()}
    batched = tref.centroid_interaction_batched_ref(a["s_cq"], a["codes"], a["keep"], a["q_mask"])
    for b in range(a["s_cq"].shape[0]):
        one = tref.centroid_interaction_ref(a["s_cq"][b], a["codes"][b], a["keep"][b], a["q_mask"][b])
        assert torch.equal(one, batched[b])
    a = {k: _t(v) for k, v in k2_inputs(7, 2).items()}
    lane = ("q", "q_mask", "codes", "packed_res", "tok_valid")
    batched = tref.decompress_and_score_batched_ref(
        *(a[k] for k in lane), a["centroids"], a["weights"], nbits=2
    )
    for b in range(a["q"].shape[0]):
        one = tref.decompress_and_score_ref(
            *(a[k][b] for k in lane), a["centroids"], a["weights"], nbits=2
        )
        assert torch.equal(one, batched[b])


@pytest.mark.parametrize("batched", [True, False])
def test_k1_k5_without_keep_or_mask_equal_all_true_calls(batched):
    """``keep_centroid=None`` / ``q_mask=None`` (the kernels' null pointers:
    stage 3 keeps every centroid) equal the calls with all-true keep and
    all-ones q_mask bit for bit, through ``ops``."""
    a = {k: _t(v) for k, v in k1_inputs(5, nq=32).items()}
    B, K, nq = a["s_cq"].shape
    keep1, mask1 = torch.ones(B, K, dtype=torch.bool), torch.ones(B, nq)
    if batched:
        fn, s, c, m = tops.centroid_interaction_batched, a["s_cq"], a["codes"], a["q_mask"]
    else:
        fn, s, c, m = tops.centroid_interaction, a["s_cq"][0], a["codes"][0], a["q_mask"][0]
        keep1, mask1 = keep1[0], mask1[0]
    assert torch.equal(fn(s, c, m, None), fn(s, c, m, keep1))
    assert torch.equal(fn(s, c, None, None), fn(s, c, mask1, keep1))
    # a non-contiguous, non-f32 s_cq is copied by the adapter, not refused
    assert torch.equal(fn(s.double().transpose(-1, -2).contiguous().transpose(-1, -2), c, m),
                       fn(s, c, m))


def test_k1_warps_take_more_candidates_only_in_large_launches():
    """K5's launch (B=1 x 8192 candidates) takes 2 a warp, fewer than one
    wave of warps; stage 2 (B=32 x 8192) and stage 3 (B=32 x 4096) take
    MAX_PER_WARP; a launch of fewer than WARP_CANDIDATES takes 1."""
    assert tms.per_warp(1, 8192) == 2
    assert tms.per_warp(2, 1001) == 1
    assert tms.per_warp(32, 4096) == tms.MAX_PER_WARP
    assert tms.per_warp(32, 8192) == tms.MAX_PER_WARP


def test_cpu_calls_are_not_launches_and_other_devices_are_refused():
    tops.reset_launch_counts()
    a = k1_inputs(3)
    tms.centroid_interaction_batched(_t(a["s_cq"]), _t(a["codes"]), _t(a["keep"]), _t(a["q_mask"]))
    tms.centroid_interaction(_t(a["s_cq"][0]), _t(a["codes"][0]), _t(a["keep"][0]), _t(a["q_mask"][0]))
    tdec.decompress_residuals(torch.zeros((4, 8), dtype=torch.uint8), torch.ones(4), nbits=2)
    assert tops.launch_counts() == {
        "centroid_interaction_batched": 0,
        "decompress_and_score_batched": 0,
        "gather_decompress_maxsim": 0,
        "flash_attention": 0,
        "decompress_residuals": 0,
        "centroid_interaction": 0,
        "decompress_and_score": 0,
    }
    # a meta tensor takes the dry-run's branch: the plain version's shape,
    # nothing computed, no launch counted
    meta = torch.empty((1, 4, 2), device="meta")
    out = tms.centroid_interaction_batched(meta, meta.int(), meta.bool()[..., 0], meta[..., 0])
    assert out.device.type == "meta" and out.shape == (1, 4) and out.dtype == torch.float32
    res = tdec.decompress_residuals(meta.to(torch.uint8)[0], meta[0, 0], nbits=2)
    assert res.device.type == "meta" and res.shape == (4, 8)
    assert sum(tops.launch_counts().values()) == 0
    # any other device is refused
    from repro_torch.kernels import _build

    with pytest.raises(ValueError, match="unsupported device"):
        _build.on_card(types.SimpleNamespace(device=torch.device("xpu")), "centroid_interaction")


def test_kernel_modules_import_without_building():
    """Importing the wrappers compiles nothing (no nvcc on the CPU hosts)."""
    from repro_torch.kernels import _build

    assert _build._LIBS == {}
    assert {p.name for p in _build.sources()} == {
        "maxsim.cu", "decompress.cu", "fused_score.cu", "flash_attention.cu",
    }


@pytest.mark.parametrize(
    "B,nd,L,want",
    [
        (32, 1024, 180, 16),  # k=1000's stage 4: capped, 2048 blocks
        (32, 256, 180, 15),  # k=100
        (32, 64, 180, 3),  # k=10: 683 blocks, still >= 2 waves of 264
        (1, 1024, 180, 1),  # K6 (the _search oracle): 1024 blocks
        (1, 7, 180, 1),  # fewer finalists than one wave: never below 1
        (32, 1024, 2048, 2),  # K2's row list holds 16 KB: G * L * 4 bytes
        (32, 1024, None, 16),  # K3 keeps no row list
    ],
)
def test_passages_per_block_keeps_two_waves(B, nd, L, want):
    g = tdec.passages_per_block(B, nd, L)
    assert g == want
    blocks = B * nd // g
    wave = tdec.SMS * tdec.BLOCKS_PER_SM
    assert g == 1 or blocks >= tdec.MIN_WAVES * wave
    if L:
        assert g * L * 4 <= tdec.ROW_LIST_BYTES or g == 1


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
    assert torch.equal(got, want)  # exact max, the plain version's tree sum


@pytest.mark.gpu
@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_k2_kernel_matches_plain_on_card(cuda, nbits):
    a = {k: _t(v, cuda) for k, v in k2_inputs(8, nbits).items()}
    args = [a[k] for k in ("q", "q_mask", "codes", "packed_res", "tok_valid", "centroids", "weights")]
    got = tdec.decompress_and_score_batched(*args, nbits=nbits)
    want = tref.decompress_and_score_batched_ref(*args, nbits=nbits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)  # the shared-order contract: bit for bit


@pytest.mark.gpu
@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_k3_kernel_matches_plain_on_card(cuda, nbits):
    a = {k: _t(v, cuda) for k, v in k3_inputs(9, nbits).items()}
    args = [a[k] for k in _K3_ARGS]
    got = tfs.gather_decompress_maxsim(*args, nbits=nbits, doc_maxlen=10)
    want = tref.gather_decompress_maxsim_ref(*args, nbits=nbits, doc_maxlen=10)
    torch.cuda.synchronize()
    assert torch.equal(got, want)  # the shared-order contract: bit for bit


@pytest.mark.gpu
@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_k4_kernel_equals_plain_on_card(cuda, nbits):
    """Bit for bit, on a ragged row count and on an input that starts at an
    odd byte offset (a slice of a larger tensor)."""
    rng = np.random.default_rng(60 + nbits)
    big = _t(rng.integers(0, 256, (1001, 16 * nbits)).astype(np.uint8), cuda)
    w = _t(np.sort(rng.standard_normal(2**nbits)).astype(np.float32), cuda)
    before = tdec.residual_launches
    for packed in (big, big.reshape(-1)[1:-(16 * nbits - 1)].reshape(1000, 16 * nbits)):
        got = tdec.decompress_residuals(packed, w, nbits=nbits)
        torch.cuda.synchronize()
        assert torch.equal(got, tref.decompress_residuals_ref(packed, w, nbits=nbits))
    assert tdec.residual_launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("nq", [12, 40])
def test_k5_kernel_matches_plain_on_card(cuda, nq):
    a = {k: _t(v[0], cuda) for k, v in k1_inputs(11, B=1, nq=nq).items()}
    before = (tms.launches, tms.single_launches)
    got = tms.centroid_interaction(a["s_cq"], a["codes"], a["keep"], a["q_mask"])
    want = tref.centroid_interaction_ref(a["s_cq"], a["codes"], a["keep"], a["q_mask"])
    torch.cuda.synchronize()
    assert (tms.launches, tms.single_launches) == (before[0], before[1] + 1)
    assert torch.equal(got, want)  # exact max, the plain version's tree sum


def _k1_corner_case(dev, seed, B, nd, L, K, nq):
    """Codes with -1 pads scattered through each row and at its tail, some
    all-pad and all-pruned candidates, a lane whose keep is all false, and
    a masked query or two."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s_cq = torch.randn(B, K, nq, generator=g, device=dev)
    codes = torch.randint(0, K, (B, nd, L), generator=g, device=dev, dtype=torch.int32)
    codes[torch.rand(B, nd, L, generator=g, device=dev) < 0.3] = -1  # pads in the middle
    lens = torch.randint(0, L + 1, (B, nd, 1), generator=g, device=dev)
    codes[torch.arange(L, device=dev) >= lens] = -1  # and at the tail
    codes[:, ::7] = -1  # all-pad candidates
    keep = torch.rand(B, K, generator=g, device=dev) > 0.4
    codes[:, 3::11] = codes[:, 3::11].clamp(max=0)  # only centroid 0 and pads ...
    keep[:, 0] = False  # ... and centroid 0 pruned: all-pruned candidates
    if B > 1:
        keep[1] = False  # a lane that prunes every centroid
    q_mask = (torch.rand(B, nq, generator=g, device=dev) > 0.1).float()
    return s_cq, codes, keep, q_mask


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,nd,L,K,nq",
    [
        (2, 1001, 180, 2**18, 32),  # ColBERTv2's widths, B=2 at K=2^18; nd % 8 != 0
        (3, 300, 180, 4096, 12),  # nq % 32 != 0: one query a lane
        (3, 300, 180, 4096, 40),  # two groups of 32 queries
        (3, 300, 33, 4096, 32),  # one token past a 32-token chunk; rows not 16-byte
        (16, 8192, 180, 4096, 32),  # MAX_PER_WARP candidates a warp at the default plan
        (3, 300, 1, 4096, 32),  # one-token passages
        (3, 300, 300, 4096, 32),  # two windows of the codes
        (3, 300, 300, 4096, 40),
        (3, 77, 180, 4096, 16),  # the float4 path at 2 and 1 lanes a row
        (3, 77, 180, 4096, 4),
    ],
)
def test_k1_k5_equal_plain_at_full_width_and_corners_on_card(cuda, monkeypatch, B, nd, L, K, nq):
    """K1 and K5 bit for bit: with keep, with a null keep against an
    all-true one, with a null q_mask, at 1, 3 and 8 candidates a warp (the
    last warp's run cut short by nd), and K5 on each lane."""
    s_cq, codes, keep, q_mask = _k1_corner_case(cuda, B * nd + L + nq, B, nd, L, K, nq)
    ones = torch.ones_like(keep)
    for kp, qm in ((keep, q_mask), (None, q_mask), (ones, q_mask), (keep, None)):
        want = tref.centroid_interaction_batched_ref(s_cq, codes, kp, qm)
        for pw in (1, 3, 8):  # candidates a warp
            monkeypatch.setattr(tms, "MAX_PER_WARP", pw)
            monkeypatch.setattr(tms, "WARP_CANDIDATES", 1)
            got = tms.centroid_interaction_batched(s_cq, codes, kp, qm)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (pw, kp is None, qm is None,
                                            float((got - want).abs().max()))
    monkeypatch.undo()
    assert torch.equal(tms.centroid_interaction_batched(s_cq, codes, None, q_mask),
                       tms.centroid_interaction_batched(s_cq, codes, ones, q_mask))
    if B > 1:  # the lane whose keep is all false scores 0 everywhere
        assert not bool(tms.centroid_interaction_batched(s_cq, codes, keep, q_mask)[1].any())
    before = tms.single_launches
    for b in range(B):
        got = tms.centroid_interaction(s_cq[b], codes[b], keep[b], q_mask[b])
        want = tref.centroid_interaction_ref(s_cq[b], codes[b], keep[b], q_mask[b])
        torch.cuda.synchronize()
        assert torch.equal(got, want), b
    assert tms.single_launches == before + B


@pytest.mark.gpu
def test_k1_unaligned_scores_take_the_lane_path_on_card(cuda):
    """An s_cq that starts off a 16-byte boundary cannot take float4 loads:
    the kernel reads it one query a lane, bit for bit all the same."""
    s_cq, codes, keep, q_mask = _k1_corner_case(cuda, 5, 2, 100, 180, 4096, 32)
    flat = torch.empty(s_cq.numel() + 1, device=cuda)
    odd = flat[1:].view(s_cq.shape).copy_(s_cq)
    assert odd.data_ptr() % 16 != 0
    got = tms.centroid_interaction_batched(odd, codes, keep, q_mask)
    torch.cuda.synchronize()
    assert torch.equal(got, tref.centroid_interaction_batched_ref(s_cq, codes, keep, q_mask))


@pytest.mark.gpu
@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_k6_kernel_matches_plain_on_card(cuda, nbits):
    a = k2_inputs(12, nbits, B=1)
    args = [_t(a[k][0], cuda) for k in ("q", "q_mask", "codes", "packed_res", "tok_valid")]
    args += [_t(a["centroids"], cuda), _t(a["weights"], cuda)]
    before = (tdec.launches, tdec.single_launches)
    got = tdec.decompress_and_score(*args, nbits=nbits)
    want = tref.decompress_and_score_ref(*args, nbits=nbits)
    torch.cuda.synchronize()
    assert (tdec.launches, tdec.single_launches) == (before[0], before[1] + 1)
    assert torch.equal(got, want)  # the shared-order contract: bit for bit


@pytest.mark.gpu
def test_wrappers_check_their_arguments_on_card(cuda):
    a = {k: _t(v, cuda) for k, v in k1_inputs(4).items()}
    with pytest.raises(TypeError, match="codes"):
        tms.centroid_interaction_batched(a["s_cq"], a["codes"].long(), a["keep"], a["q_mask"])
    with pytest.raises(ValueError, match="contiguous"):
        tms.centroid_interaction_batched(
            a["s_cq"].transpose(1, 2).contiguous().transpose(1, 2), a["codes"], a["keep"], a["q_mask"]
        )


def _full_width_case(dev, seed, B, nd, nq, d=128, nbits=2, maxlen=180, n_docs=20000, K=4096):
    """K3's CSR arrays at the main path's widths (lens 8..180, a few empty
    passages, pid == -1 slots), and K2's (B, nd, L) blocks gathered from
    them with scattered invalid rows and all-invalid passages added."""
    from repro_torch.core import scoring

    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(8, maxlen + 1, (n_docs,), generator=g, device=dev, dtype=torch.int32)
    lens[:: 97] = 0  # passages without tokens
    lens[1] = maxlen
    offs = torch.zeros(n_docs + 1, dtype=torch.int32, device=dev)
    offs[1:] = torch.cumsum(lens, 0)
    nt = int(offs[-1])
    pd = d * nbits // 8
    pids = torch.randint(0, n_docs, (B, nd), generator=g, device=dev, dtype=torch.int32)
    pids[:, ::13] = -1
    pids[0, 0] = 1  # a passage of maxlen tokens
    pids[0, -1] = n_docs - 1  # the passage at the very end of the token arrays
    k3 = dict(
        qs=torch.randn(B, nq, d, generator=g, device=dev),
        q_masks=(torch.rand(B, nq, generator=g, device=dev) > 0.1).float(),
        final_pids=pids,
        codes_tok=torch.randint(0, K, (nt,), generator=g, device=dev, dtype=torch.int32),
        residuals_tok=torch.randint(0, 256, (nt, pd), generator=g, device=dev, dtype=torch.uint8),
        doc_offsets=offs,
        doc_lens=lens,
        centroids=torch.randn(K, d, generator=g, device=dev),
        weights=torch.sort(torch.randn(2**nbits, generator=g, device=dev)).values,
    )
    flat = pids.reshape(-1)
    codes, valid = scoring.gather_doc_tokens(k3["codes_tok"], offs, lens, flat, maxlen, -1)
    res, _ = scoring.gather_doc_tokens(k3["residuals_tok"], offs, lens, flat, maxlen, 0)
    valid = valid & (torch.rand(valid.shape, generator=g, device=dev) > 0.1)
    valid[::17] = False  # whole passages invalid
    k2 = dict(
        q=k3["qs"], q_mask=k3["q_masks"], codes=codes.reshape(B, nd, maxlen),
        packed_res=res.reshape(B, nd, maxlen, pd), tok_valid=valid.reshape(B, nd, maxlen),
        centroids=k3["centroids"], weights=k3["weights"],
    )
    return k2, k3


_K2_ARGS = ("q", "q_mask", "codes", "packed_res", "tok_valid", "centroids", "weights")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,nd,nq",
    [
        (1, 1024, 32),  # K6's shape: one lane, G = 1, 1024 blocks
        (32, 64, 32),  # k=10's stage 4: G = 3
        (8, 1024, 32),  # G = 15, many tiles a block
        (4, 256, 64),  # nqp 64: 8 accumulators a query lane
        (4, 256, 20),  # nq not a multiple of the query lanes
    ],
)
def test_k2_k3_k6_equal_plain_at_full_width_on_card(cuda, B, nd, nq):
    """nq up to 64, d 128, L 180, ragged lengths 8..180, scattered invalid
    rows, all-invalid passages and pid == -1 slots, grids below and above
    one wave: bit for bit."""
    k2, k3 = _full_width_case(cuda, 40 + nq + B, B, nd, nq)
    args2 = [k2[k] for k in _K2_ARGS]
    got = tdec.decompress_and_score_batched(*args2, nbits=2)
    want = tref.decompress_and_score_batched_ref(*args2, nbits=2)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())
    args3 = [k3[k] for k in _K3_ARGS]
    got = tfs.gather_decompress_maxsim(*args3, nbits=2, doc_maxlen=180)
    want = tref.gather_decompress_maxsim_ref(*args3, nbits=2, doc_maxlen=180)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())
    if B == 1:
        args6 = [k2[k][0] for k in _K2_ARGS[:5]] + [k2["centroids"], k2["weights"]]
        before = tdec.single_launches
        got = tdec.decompress_and_score(*args6, nbits=2)
        want = tref.decompress_and_score_ref(*args6, nbits=2)
        torch.cuda.synchronize()
        assert tdec.single_launches == before + 1
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("nbits,d", [(1, 64), (4, 6), (2, 12), (1, 8)])
def test_k2_k3_narrow_copies_equal_plain_on_card(cuda, nbits, d):
    """Byte rows of 8, 3, 3 and 1 bytes (cp.async narrowed to 8 bytes, or a
    plain copy) and d % 4 != 0 (4-byte centroid copies, the dims' tail)."""
    a = {k: _t(v, cuda) for k, v in k2_inputs(70 + d, nbits, d=d, nd=40, L=30).items()}
    args = [a[k] for k in _K2_ARGS]
    got = tdec.decompress_and_score_batched(*args, nbits=nbits)
    want = tref.decompress_and_score_batched_ref(*args, nbits=nbits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    a = {k: _t(v, cuda) for k, v in k3_inputs(80 + d, nbits, d=d, n3=40).items()}
    args = [a[k] for k in _K3_ARGS]
    got = tfs.gather_decompress_maxsim(*args, nbits=nbits, doc_maxlen=10)
    want = tref.gather_decompress_maxsim_ref(*args, nbits=nbits, doc_maxlen=10)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
