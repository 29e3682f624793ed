"""K7 (flash attention) and the plain ``chunked_attention`` of the port
against the reference (``repro.kernels.flash_attention`` in interpret mode,
``repro.models.layers.chunked_attention``), and the CUDA kernel against its
plain version (``gpu`` marker: needs a card, skips here).

Tolerances, with their reasons:

* f32, port vs reference: atol = rtol = 1e-5.  Both compute softmax and
  ``p . v`` in f32 over the same tiles, but sum in another order.
* bf16, port vs reference: one bf16 ulp of the output (rtol 2^-7) plus
  1e-6.  Both round an f32 result to bf16 once; f32 results a few ulp apart
  can round to neighbouring bf16 values.
* on the card, kernel vs plain version: f32 atol = rtol = 1e-5 (the kernel
  walks 64-key tiles with rescaling, the plain version one whole-S tile);
  bf16 one bf16 ulp as above.  The bf16 kernel computes both products on
  the tensor cores, with ``p`` split into three bf16 terms for ``p . v``; the
  emulation tests below hold that arithmetic to the same one ulp on the CPU.
"""
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the reference; a host with only the port installed runs the gpu cases
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as ref_flash
    from repro.models import layers as ref_layers
except ImportError:
    jnp = ref_flash = ref_layers = None

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=1e-6)

#: the reference's own flash test shapes (tests/test_flash_attention.py)
JAX_SHAPES = [
    (2, 64, 4, 2, 16, True, 32),
    (1, 128, 8, 1, 32, True, 32),  # MQA
    (2, 64, 4, 4, 16, False, 16),  # MHA, non-causal
    (1, 96, 6, 2, 8, True, 48),  # odd-ish head grouping
]


@pytest.fixture
def reference():
    if ref_flash is None:
        pytest.skip("needs jax and the repro package (the reference)")


def qkv(seed, B, S, H, Hkv, dh):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, S, H, dh)).astype(np.float32),
        rng.standard_normal((B, S, Hkv, dh)).astype(np.float32),
        rng.standard_normal((B, S, Hkv, dh)).astype(np.float32),
    )


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,S,H,Hkv,dh,causal,q_blk", JAX_SHAPES)
def test_plain_k7_matches_reference_kernel_f32(reference, B, S, H, Hkv, dh, causal, q_blk):
    q, k, v = qkv(0, B, S, H, Hkv, dh)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     q_blk=q_blk, kv_blk=q_blk, interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_plain_k7_matches_reference_kernel_bf16(reference):
    q, k, v = qkv(1, 1, 64, 4, 2, 16)
    want = ref_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                     q_blk=32, kv_blk=32, interpret=True)
    got = tfa.flash_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize(
    "S,causal,window,q_chunk,k_chunk,dtype",
    [
        (40, True, 12, 16, 8, "float32"),  # sliding window, ragged S
        (40, False, 9, 8, 16, "bfloat16"),  # bidirectional window
        (37, True, None, 16, 16, "float32"),  # causal: off-diagonal chunks unmasked
        (37, False, None, 16, 8, "bfloat16"),  # padding-only mask
    ],
)
def test_chunked_attention_matches_reference(reference, S, causal, window, q_chunk, k_chunk, dtype):
    q, k, v = qkv(2, 2, S, 6, 2, 16)
    want = ref_layers.chunked_attention(
        *(jnp.asarray(x, dtype) for x in (q, k, v)),
        causal=causal, window=window, q_chunk=q_chunk, k_chunk=k_chunk,
    )
    got = tlayers.chunked_attention(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)),
        causal=causal, window=window, q_chunk=q_chunk, k_chunk=k_chunk,
    )
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(_np(got), _np(want), **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_plain_k7_equals_chunked_attention_on_the_same_function():
    """Flash and chunked are one function: GQA by grouping (K7) equals the
    repeated-KV chunked path, causal and not."""
    q, k, v = (torch.from_numpy(x) for x in qkv(3, 2, 33, 8, 2, 16))
    for causal in (False, True):
        flash = tfa.flash_attention(q, k, v, causal=causal)
        chunked = tlayers.chunked_attention(
            q, k.repeat_interleave(4, dim=2), v.repeat_interleave(4, dim=2),
            causal=causal, q_chunk=33, k_chunk=33,
        )
        torch.testing.assert_close(flash, chunked, **F32_TOL)


def test_cpu_calls_are_not_launches():
    tops.reset_launch_counts()
    q, k, v = (torch.from_numpy(x) for x in qkv(4, 1, 8, 2, 1, 8))
    tfa.flash_attention(q, k, v, causal=False)
    assert tops.launch_counts()["flash_attention"] == 0
    # a meta tensor takes the dry-run's branch: q's shape and dtype, no launch
    meta = torch.empty((1, 8, 2, 8), device="meta")
    out = tfa.flash_attention(meta, meta[:, :, :1], meta[:, :, :1])
    assert out.device.type == "meta" and out.shape == meta.shape and out.dtype == meta.dtype
    assert tops.launch_counts()["flash_attention"] == 0
    # any other device is refused
    from repro_torch.kernels import _build

    with pytest.raises(ValueError, match="unsupported device"):
        _build.on_card(types.SimpleNamespace(device=torch.device("xpu")), "flash_attention")


# --------------------------------------------------------------------------
# The bf16 kernel's arithmetic, emulated on the CPU
# --------------------------------------------------------------------------
def emulate_bf16_kernel(q, k, v, *, causal, terms=3):
    """The bf16 kernel's arithmetic in plain torch: 64-key tiles with the
    online rescaling; ``q . k^T`` from bf16 inputs summed in f32 (the
    products are exact); ``p`` in f32, then ``p . v`` as the f32 sum of
    ``t . v`` over ``p``'s first ``terms`` bf16 terms ``t`` (the kernel's
    three: ``bf16(p)``, ``bf16(p - bf16(p))``, and one more of the rest)."""
    B, S, H, dh = q.shape
    g = H // k.shape[2]
    qf = q.float().transpose(1, 2)  # (B, H, S, dh)
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, dh))
    pos = torch.arange(S)
    for k0 in range(0, S, 64):
        kt, vt = kf[:, :, k0 : k0 + 64], vf[:, :, k0 : k0 + 64]
        s = (qf @ kt.transpose(-1, -2)) * dh**-0.5
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2])
            s = torch.where(keys[None, :] <= pos[:, None], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        pv, rest = torch.zeros_like(acc), p
        for _ in range(terms):
            t = rest.bfloat16().float()
            pv = pv + t @ vt
            rest = rest - t  # exact in f32
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp(min=1e-20)).transpose(1, 2).bfloat16()


#: (seed, B, S, H, Hkv, dh, causal): the encoder's passage shape at reduced
#: B, and a ragged causal case whose short rows have outputs near zero
PASSAGES = (6, 2, 180, 48, 12, 64, False)
CAUSAL_65 = (10, 2, 65, 8, 2, 64, True)


def _bf16_case(seed, B, S, H, Hkv, dh, causal):
    """bf16 inputs made with numpy, and the reference's output on them."""
    q, k, v = (x.astype(jnp.bfloat16) for x in map(jnp.asarray, qkv(seed, B, S, H, Hkv, dh)))
    want = ref_flash(q, k, v, causal=causal, interpret=True)
    return [torch.from_numpy(np.asarray(x, np.float32)).bfloat16() for x in (q, k, v, want)]


def _outside_one_ulp(got, want) -> int:
    tol = BF16_TOL["atol"] + BF16_TOL["rtol"] * want.float().abs()
    return int(((got.float() - want.float()).abs() > tol).sum())


@pytest.mark.parametrize("case", [PASSAGES, CAUSAL_65], ids=["passages", "causal65"])
def test_split_p_emulation_within_one_bf16_ulp(reference, case):
    """The tolerance argument of the bf16 kernel: with ``p`` split into
    three bf16 terms for ``p . v`` its arithmetic stays within one bf16 ulp
    of the reference (``p`` in f32) everywhere.  Fewer terms do not
    (``test_fewer_p_terms_miss_one_bf16_ulp``): one bf16 ``p`` misses for
    about 11% of the outputs at the passage shape, and ``bf16(p) +
    bf16(p - bf16(p))`` (~2^-18 of ``p``) for about one in a million, near
    zero in short causal rows, where the 1e-6 atol is all the room there
    is.  Hence three."""
    seed, *shape = case
    q, k, v, want = _bf16_case(seed, *shape)
    got = emulate_bf16_kernel(q, k, v, causal=shape[-1])
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("terms,case,at_least", [(1, PASSAGES, 100_000), (2, CAUSAL_65, 1)],
                         ids=["one_term", "two_terms"])
def test_fewer_p_terms_miss_one_bf16_ulp(reference, terms, case, at_least):
    """The design's other arms, on the same inputs as the three-term test:
    one bf16 ``p`` (the tensor cores' plain input) misses one bf16 ulp for
    ~11% of the passage-shape outputs (121,066 of 1,105,920); two terms
    miss it for one output of the causal case."""
    seed, *shape = case
    q, k, v, want = _bf16_case(seed, *shape)
    got = emulate_bf16_kernel(q, k, v, causal=shape[-1], terms=terms)
    assert _outside_one_ulp(got, want) >= at_least


# --------------------------------------------------------------------------
# On the card: the kernel against its plain version
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


#: bf16 (S, dh, causal) over ragged and full tiles and every head-dim
#: padding, at B=2 and 8 query heads; the KV grouping cycles through MHA,
#: 4 query heads a group and MQA
BF16_GRID = [
    (2, S, 8, (8, 2, 1)[i % 3], dh, causal, "bfloat16")
    for i, (S, dh, causal) in enumerate(
        itertools.product((1, 32, 63, 65, 180, 257), (8, 16, 64, 72, 128), (False, True))
    )
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,S,H,Hkv,dh,causal,dtype",
    [(*shape[:6], "float32") for shape in JAX_SHAPES]
    + [
        (32, 32, 48, 12, 64, False, "bfloat16"),  # encoder queries
        (4, 180, 48, 12, 64, False, "bfloat16"),  # encoder passages
        (2, 77, 6, 3, 128, True, "bfloat16"),  # dh 128, ragged S
        (1, 129, 4, 1, 24, True, "float32"),  # dh padded to 64, MQA
        (3, 77, 48, 1, 64, True, "bfloat16"),  # MQA: 16 heads stacked in a tile
    ]
    + BF16_GRID,
)
def test_k7_kernel_matches_plain_on_card(cuda, B, S, H, Hkv, dh, causal, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, dt) for x in qkv(5, B, S, H, Hkv, dh))
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, causal=causal)
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    assert got.dtype == dt
    torch.testing.assert_close(got.float(), want.float(), **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.gpu
def test_k7_takes_offset_and_transposed_views_on_card(cuda):
    """A view the kernel cannot read as it stands (bf16 at an odd offset:
    TMA needs 16-byte alignment; transposed: not contiguous) is copied
    first, so K7 takes any strides, as the reference does, and equals its
    plain version within the bf16 tolerance.  Wrong dtype and shape still
    raise, as does a launch the C function refuses."""
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in qkv(9, 1, 16, 4, 2, 16))
    flat = torch.zeros(q.numel() + 1, device=cuda, dtype=torch.bfloat16)
    offset = flat[1:].view(q.shape)
    offset.copy_(q)
    transposed = q.transpose(1, 2).contiguous().transpose(1, 2)
    before = tfa.launches
    for view in (offset, transposed):
        assert view.data_ptr() % 16 or not view.is_contiguous()
        got = tfa.flash_attention(view, k, v)
        torch.cuda.synchronize()
        want = tref.flash_attention_ref(view, k, v, causal=True)
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
        torch.testing.assert_close(got, tfa.flash_attention(q, k, v), rtol=0, atol=0)
    assert tfa.launches == before + 4
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="shape"):
        tfa.flash_attention(q, k[:, :8], v)
    # a launch the C function refuses (dh 7) raises; it is not swallowed
    fn = _build.c_function("flash_attention", "plaid_flash_attention_bf16", 4, 6)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        _build.launch(fn, [q, k, v, torch.empty_like(q)], [1, 16, 4, 2, 7, 0], q.device)
