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
  bf16 one bf16 ulp as above.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
try:  # the reference; a host with only the port installed runs the gpu cases
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention as ref_flash
    from repro.models import layers as ref_layers
except ImportError:
    jnp = ref_flash = ref_layers = None

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
    meta = torch.empty((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention(meta, meta[:, :, :1], meta[:, :, :1])


# --------------------------------------------------------------------------
# On the card: the kernel against its plain version
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,S,H,Hkv,dh,causal,dtype",
    [(*shape[:6], "float32") for shape in JAX_SHAPES]
    + [
        (32, 32, 48, 12, 64, False, "bfloat16"),  # encoder queries
        (4, 180, 48, 12, 64, False, "bfloat16"),  # encoder passages
        (2, 77, 6, 3, 128, True, "bfloat16"),  # dh 128, ragged S
        (1, 129, 4, 1, 24, True, "float32"),  # dh padded to 64, MQA
    ],
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
