"""The port's flash attention (``repro_torch.kernels.flash_attention``) on
the CPU against the reference's Pallas kernel in interpret mode.

The CUDA kernel itself runs only on a card (``tests/test_torch_gpu.py``);
here its plain version, the GQA wrapper and the naive oracle are held to
the reference. Inputs are numpy draws from a seed, handed to both packages.

Tolerances: atol 1e-5 in float32 and 2e-2 in bfloat16, the reference test's
own (``tests/test_flash_attention.py``): the two run the same arithmetic in
another summation order, and a bfloat16 output may round to the
neighbouring value.
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
