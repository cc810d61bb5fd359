"""The port's flash attention (``repro_torch.kernels.flash_attention``) on
the CPU against the reference's Pallas kernel in interpret mode.

The CUDA kernel itself runs only on a card (``tests/test_torch_gpu.py``);
here its plain version, the GQA wrapper and the naive oracle are held to
the reference. Inputs are numpy draws from a seed, handed to both packages.

Tolerances: atol 1e-5 in float32 and 2e-2 in bfloat16, the reference test's
own (``tests/test_flash_attention.py``): the two run the same arithmetic in
another summation order, and a bfloat16 output may round to the
neighbouring value.

The float32 kernel takes its products on the tensor cores in split TF32;
its numerics are emulated here in plain torch inside the plain version's
online softmax and held to the card's float32 tolerance, |d| <= 1e-5 +
1e-5|x| (chip_smoke.py, tests/test_torch_gpu.py), which one TF32 product
does not hold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_bhsd
from repro.kernels.flash_attention.ops import flash_attention as jax_gqa
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attention import kernel as t_kernel

# The reference test's cases: (BH, Sq, Sk, Dh, causal, window, dtype, blk).
CASES = [
    (4, 128, 128, 64, True, None, "float32", 64),
    (2, 128, 128, 128, True, None, "float32", 64),
    (2, 64, 256, 64, True, None, "float32", 64),  # end-aligned queries
    (2, 128, 128, 64, True, 48, "float32", 64),  # sliding window
    (2, 128, 128, 64, False, None, "float32", 64),  # bidirectional
    (2, 128, 128, 64, True, None, "bfloat16", 64),
    (1, 256, 256, 256, True, None, "float32", 128),
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _draw(seed, *shapes):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return jnp.asarray(a, getattr(jnp, dtype)), torch.as_tensor(a).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("tiles", ["reference", "kernel", "wgmma"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_reference_kernel(case, tiles):
    """The plain version, at the case's blocks, at its default tiles (the
    CUDA kernel's for the case's dtype) and at the bf16 wgmma design's
    128 x 64 tiles, against the Pallas kernel at the case's blocks."""
    BH, Sq, Sk, Dh, causal, window, dtype, blk = case
    q, k, v = (_pair(a, dtype) for a in _draw(0, (BH, Sq, Dh), (BH, Sk, Dh), (BH, Sk, Dh)))
    want = flash_attention_bhsd(q[0], k[0], v[0], causal=causal, window=window,
                                blk_q=blk, blk_k=blk)
    blq, blk_ = t_kernel.TILES[torch.bfloat16]
    blocks = {"reference": dict(blk_q=blk, blk_k=blk), "kernel": {},
              "wgmma": dict(blk_q=blq, blk_k=blk_)}[tiles]
    got = t_kernel.flash_attention_bhsd_plain(q[1], k[1], v[1], causal=causal,
                                              window=window, **blocks)
    assert got.dtype == q[1].dtype and got.shape == (BH, Sq, Dh)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_oracle_matches_reference_oracle(case):
    BH, Sq, Sk, Dh, causal, window, dtype, _ = case
    q, k, v = (_pair(a, dtype) for a in _draw(1, (BH, Sq, Dh), (BH, Sk, Dh), (BH, Sk, Dh)))
    want = jax_ref(q[0], k[0], v[0], causal=causal, window=window)
    got = flash_attention_ref(q[1], k[1], v[1], causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)


def test_block_size_invariance():
    """The blocking changes only the summation order (f32, atol 1e-5)."""
    q, k, v = (torch.as_tensor(a) for a in _draw(2, (2, 256, 64), (2, 256, 64), (2, 256, 64)))
    outs = [t_kernel.flash_attention_bhsd_plain(q, k, v, blk_q=bq, blk_k=bk)
            for bq, bk in ((32, 32), (64, 64), (128, 128), (64, 32), (256, 16), (128, 64))]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 37), (False, None),
                                           (False, 50)])
def test_ragged_tails_match_oracle(causal, window):
    """The kernel's tiles do not divide Sq or Sk here: the short last blocks
    of the plain version against the reference's naive oracle (f32)."""
    q, k, v = (torch.as_tensor(a) for a in _draw(3, (3, 100, 64), (3, 173, 64), (3, 173, 64)))
    got = t_kernel.flash_attention_bhsd_plain(q, k, v, causal=causal, window=window)
    want = jax_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                   causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_wrapper_matches_reference(dtype):
    """Model layout q (B, Sq, M, G, Dh), k/v (B, Sk, M, Dh): key/value head
    bh // G read in place equals the reference's repeated K/V, head
    h = m*G + g."""
    B, Sq, Sk, M, G, Dh = 2, 128, 128, 2, 3, 64
    q, k, v = (_pair(a, dtype) for a in _draw(4, (B, Sq, M, G, Dh), (B, Sk, M, Dh),
                                              (B, Sk, M, Dh)))
    want = jax_gqa(q[0], k[0], v[0], blk_q=64, blk_k=64)
    got = flash_attention(q[1], k[1], v[1])
    assert got.shape == (B, Sq, M * G, Dh)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)
    # head m*G + g of batch b is the BHSD plain version on that plane
    plane = t_kernel.flash_attention_bhsd_plain(q[1][1:, :, 1, 2], k[1][1:, :, 1],
                                                v[1][1:, :, 1])
    np.testing.assert_allclose(_np(got[1, :, 1 * G + 2]), _np(plane[0]), atol=0, rtol=0)


def test_fully_masked_rows_in_live_blocks():
    """A sliding window narrower than a key block leaves rows with every
    key of a live block masked (-1e30): p = 1 there, wiped by the row's
    first real block. The result is the masked softmax (f32 oracle)."""
    q, k, v = (torch.as_tensor(a) for a in _draw(5, (2, 192, 64), (2, 192, 64), (2, 192, 64)))
    for window in (1, 5, 31):
        got = t_kernel.flash_attention_bhsd_plain(q, k, v, window=window, blk_q=64, blk_k=64)
        want = flash_attention_ref(q, k, v, window=window)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(  # window 1: each query sees only its own key
        t_kernel.flash_attention_bhsd_plain(q, k, v, window=1).numpy(), v.numpy(), atol=1e-6)


@pytest.mark.parametrize("Dh", t_kernel.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_shared_bytes_fit_a_cta(dtype, Dh):
    """Each design's shared memory at each head dim fits what one CTA may
    opt in to on Hopper (232,448 bytes); the bf16 design's base and its K/V
    tiles lie on 1024-byte swizzle atoms."""
    got = t_kernel.shared_bytes(Dh, dtype)
    assert 0 < got <= t_kernel.SMEM_LIMIT == 232_448
    if dtype == torch.bfloat16:
        bq, bk = t_kernel.TILES[dtype]
        assert (bq * Dh * 2) % 1024 == 0 and (bk * Dh * 2) % 1024 == 0
    else:  # F32Layout<Dh>::kBytes: Q rows and K/V rows in 16-byte units
        assert got == {64: 58_368, 128: 107_520, 256: 205_824}[Dh]
        assert ((Dh + 16) * 4) % 16 == 0 and ((Dh + 4) * 4) % 16 == 0
        if Dh <= 128:  # two CTAs an SM (228 KB, 1 KB reserved per CTA)
            assert 2 * (got + 1024) <= 228 * 1024


def test_plain_default_tiles_follow_the_dtype():
    """Without blocks the plain version takes its kernel's tiles: the same
    result as asking for them (bitwise), for float32 and bf16."""
    q, k, v = (torch.as_tensor(a) for a in _draw(7, (2, 200, 64), (1, 300, 64), (1, 300, 64)))
    for dtype, (bq, bk) in t_kernel.TILES.items():
        a, b, c = (x.to(dtype) for x in (q, k, v))
        got = t_kernel.flash_attention_bhsd_plain(a, b, c, window=70)
        want = t_kernel.flash_attention_bhsd_plain(a, b, c, window=70, blk_q=bq, blk_k=bk)
        assert torch.equal(got, want)


def test_wrappers_refuse_what_they_do_not_take():
    q, k, v = (torch.as_tensor(a) for a in _draw(6, (4, 64, 64), (2, 64, 64), (2, 64, 64)))
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.flash_attention_bhsd_cuda(q, k, v)  # the kernel takes no CPU tensors
    with pytest.raises(ValueError, match="Sq <= Sk"):
        t_kernel.flash_attention_bhsd_plain(q, k[:, :32], v[:, :32])
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        t_kernel.flash_attention_bhsd_plain(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="do not fit"):
        t_kernel.flash_attention_bhsd_plain(q, k[:1].expand(3, 64, 64), v[:1].expand(3, 64, 64))
    with pytest.raises(ValueError, match="window"):
        t_kernel.flash_attention_bhsd_plain(q, k, v, window=0)
    meta = torch.empty((1, 64, 2, 2, 64), device="meta")
    with pytest.raises(ValueError, match="meta"):  # no mix of devices
        flash_attention(meta, k.reshape(1, 64, 2, 64), v.reshape(1, 64, 2, 64))
    assert t_kernel.flash_attention_bhsd_cuda.launches == 0


# ---------------------------------------------------------------------------
# Split TF32: the float32 kernel's products, emulated in plain torch
# ---------------------------------------------------------------------------

_BMM = torch.bmm  # the plain version's products, before any test patches them


def _tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` does: half a TF32 unit (bit 12) added
    to the magnitude bits of the float32, then the 13 low bits cleared. The
    sign bit takes no carry for any finite x, and inf stays inf."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    """x = big + small (+ ~2^-22 |x|), both TF32 (the kernel's split_tf32)."""
    big = _tf32(x)
    return big, _tf32(x - big)


def _bmm_split(a, b):
    """a @ b as the kernel takes it: small_a big_b + big_a small_b summed
    apart from big_a big_b, then the two added; each product of TF32 values
    exact in float32, every sum in float32."""
    (ab, a_s), (bb, b_s) = _split(a), _split(b)
    return _BMM(a_s, bb) + _BMM(ab, b_s) + _BMM(ab, bb)


def _bmm_tf32(a, b):
    """a @ b as one TF32 product on the tensor cores."""
    return _BMM(_tf32(a), _tf32(b))


def _plain_with(monkeypatch, bmm, case, seed=8):
    """The plain version (float32, its default tiles) with its two products,
    S = Q K^T and P V, taken by ``bmm``, and without; q and k/v as the card's
    cases draw them: standard normal, 4 query heads over 2 key/value
    heads."""
    Dh, Sq, Sk, causal, window = case
    q, k, v = (torch.as_tensor(a) for a in _draw(seed, (4, Sq, Dh), (2, Sk, Dh), (2, Sk, Dh)))
    want = t_kernel.flash_attention_bhsd_plain(q, k, v, causal=causal, window=window)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "bmm", bmm)
        got = t_kernel.flash_attention_bhsd_plain(q, k, v, causal=causal, window=window)
    return got.numpy(), want.numpy()


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """The bit operation against rounding to 11 significant bits in float64,
    on normal float32s of both signs over 200 binades and on exact ties
    (the 13 dropped bits 0x1000), which go away from zero."""
    rs = np.random.default_rng(9)
    bits = rs.integers(0x0C800000, 0x72000000, 20_000, dtype=np.int64)  # 2^-102 .. 2^101
    bits[:5_000] = (bits[:5_000] & ~0x1FFF) | 0x1000  # ties
    bits[::2] |= 0x80000000  # negative half
    x = bits.astype(np.uint32).view(np.float32)
    got = _tf32(torch.as_tensor(x)).numpy()
    mag = np.abs(x.astype(np.float64))
    unit = np.exp2(np.floor(np.log2(mag)) - 10)
    want = np.sign(x) * np.floor(mag / unit + 0.5) * unit
    np.testing.assert_array_equal(got.astype(np.float64), want)
    assert np.all(got.view(np.uint32) & 0x1FFF == 0)
    big, small = _split(torch.as_tensor(x))
    assert np.all(small.numpy().view(np.uint32) & 0x1FFF == 0)
    rest = np.abs(x.astype(np.float64) - big.numpy() - small.numpy())
    assert np.all(rest <= 2.0**-22 * mag)


SPLIT_CASES = [(Dh, Sq, Sk, causal, window)
               for Dh in t_kernel.HEAD_DIMS
               for Sq, Sk in ((512, 512), (256, 2048))
               for causal, window in ((True, None), (True, 128))]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_tf32_products_hold_the_float32_tolerance(monkeypatch, case):
    """Both products of the online softmax in split TF32 stay within the
    card's float32 tolerance of the plain version: Dh 64/128/256, 512 and
    2048 keys (Sq 256 end-aligned), causal with and without a window."""
    got, want = _plain_with(monkeypatch, _bmm_split, case)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("Dh", t_kernel.HEAD_DIMS)
def test_one_tf32_product_misses_the_float32_tolerance(monkeypatch, Dh):
    """One TF32 product per product (10 mantissa bits) moves some output
    past |d| <= 1e-5 + 1e-5|x|: why the kernel splits."""
    got, want = _plain_with(monkeypatch, _bmm_tf32, (Dh, 512, 512, True, None))
    excess = np.abs(got - want) - (1e-5 + 1e-5 * np.abs(want))
    assert excess.max() > 0
