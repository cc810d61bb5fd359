"""The flash-attention forward kernels: CUDA build, binding, plain version.

``csrc/flash_attention.cu`` holds hand-written Hopper (sm_90a) kernels that
replace the Pallas TPU kernel ``src/repro/kernels/flash_attention/kernel.py:28
_kernel`` (launcher ``flash_attention_bhsd`` :92): for bfloat16, a
warp-specialised design on ``wgmma`` tensor cores fed by TMA
(``flash_fwd_wgmma_kernel<Dh>``); for float32, the first FP32-lane design
(``flash_fwd_kernel<float, Dh>``), since TF32 tensor cores cannot hold the
float32 tolerance. They are compiled with ``nvcc`` at first use
(``kernels/build.py``) and called through ``ctypes`` on PyTorch's current
stream; nothing is built when this module is imported.

:func:`flash_attention_bhsd_cuda` launches them and counts accepted launches
in ``flash_attention_bhsd_cuda.launches``. :func:`flash_attention_bhsd_plain`
is the plain PyTorch version of the same function: a blockwise online
softmax over key blocks in the kernel's order, with the same block skip,
masks and clamp. The CPU path and the tests use it; the card's main path
does not.

Both take q (BH, Sq, Dh) and k/v (BH / G, Sk, Dh) with Sq <= Sk; query head
bh reads key/value head bh // G. Queries are end-aligned to the keys.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as build_lib

SOURCE = build_lib.CSRC / "flash_attention.cu"
NVCC_FLAGS = build_lib.BASE_FLAGS  # no fast math: expf, exp2f must underflow to 0
# Each design's (query, key) tiles: kBQ, kBK (float32) and kWgBQ, kWgBK (bf16).
TILES = {torch.float32: (64, 32), torch.bfloat16: (128, 64)}
HEAD_DIMS = (64, 128, 256)  # the kernels' instantiations
NEG_INF = -1e30  # the reference's masked logit
SMEM_LIMIT = 232_448  # shared memory one CTA may opt in to on Hopper
# What the C entry point returns beside CUDA's own errors (csrc kErr*).
_LAUNCH_ERRORS = {10000: "cuTensorMapEncodeTiled not found",
                  20000: "too few registers at launch for the roles' setmaxnreg",
                  20001: "more CTAs than the grid's x dimension takes"}


def shared_bytes(Dh: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one CTA of the design for ``dtype``.

    bf16 (``WgLayout<Dh>::kBytes``): Q (128 rows), two stages of a K and a V
    tile (64 rows each), all Dh bf16 wide, five 8-byte barriers and 1024 B
    to align the base to the swizzle atom. float32 (``smem_bytes<Dh>()``):
    the Q and K tiles padded by a column, V, the padded logit tile, and m, l
    and the correction per row, all float32."""
    bq, bk = TILES[dtype]
    if dtype == torch.bfloat16:
        return 2 * Dh * (bq + 2 * 2 * bk) + 8 * 5 + 1024
    return 4 * (bq * (Dh + 1) + bk * (Dh + 1) + bk * Dh + bq * (bk + 1) + 3 * bq)


def build():
    """Compile the kernel if its library is missing; returns the library
    path and the ``-Xptxas -v`` report (registers, shared memory, spills)."""
    # detlint: ignore[DET005] — attention is held to a tolerance, not
    # bitwise (LM side-stack): FMA contraction is allowed; no fast math
    return build_lib.build(SOURCE, NVCC_FLAGS)


@functools.cache
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def check_inputs(q, k, v, window):
    """Shapes and types both versions take; returns (BH, G, Sq, Sk, Dh)."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"expected q (BH, Sq, Dh) and k, v (BHkv, Sk, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, Dh = q.shape
    BHkv, Sk, _ = k.shape
    if k.shape[2] != Dh or BHkv == 0 or BH % BHkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not 0 < Sq <= Sk:
        raise ValueError(f"queries are end-aligned to the keys: need 0 < Sq <= Sk, "
                         f"got Sq={Sq}, Sk={Sk}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    return BH, BH // BHkv, Sq, Sk, Dh


def flash_attention_bhsd_cuda(q, k, v, *, causal=True, window=None, scale=None):
    """Launch the kernel on the current stream (no host sync). CUDA tensors
    only, contiguous, Dh in :data:`HEAD_DIMS`; raises on anything else and if
    the launch is refused. Returns o (BH, Sq, Dh) in q's dtype."""
    BH, G, Sq, Sk, Dh = check_inputs(q, k, v, window)
    if not q.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {q.device}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in the kernel's {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if q.dtype == torch.bfloat16:
        if -(-Sq // TILES[q.dtype][0]) * BH > 2**31 - 1:
            raise ValueError(f"{BH} heads of {Sq} queries exceed the grid's 2**31 - 1 CTAs")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("bf16 q, k, v must be 16-byte aligned (TMA)")
    elif BH > 65535:
        raise ValueError(f"BH={BH} exceeds the grid's y limit of 65535")
    scale = Dh**-0.5 if scale is None else scale
    # detlint: ignore[DET005] — both flash kernels store every real query
    # row's Dh outputs (the float32 kernel's r < nq loop, the bf16 kernel's
    # rows < Sq), and the grid covers every row
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().flash_attention_launch(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), BH, G, Sq, Sk, Dh, int(causal), int(window is not None),
            int(window or 0), float(scale), stream,
        )
    if err != 0:
        what = _LAUNCH_ERRORS.get(err) or (
            f"tensor map refused, CUresult {err - 11000}" if 11000 <= err < 12000
            else f"CUDA error {err}")
        raise RuntimeError(f"flash attention kernel launch failed: {what}")
    flash_attention_bhsd_cuda.launches += 1
    return out


flash_attention_bhsd_cuda.launches = 0


def flash_attention_bhsd_plain(q, k, v, *, causal=True, window=None, scale=None,
                               blk_q=None, blk_k=None):
    """The kernel's function in plain PyTorch, on any device: f32 logits of
    f32 ``q * scale`` and ``k``, an online softmax over key blocks of
    ``blk_k`` in order per query block of ``blk_q`` (by default the tiles of
    the kernel for q's dtype), blocks the masks leave empty skipped, masked
    logits -1e30, ``acc / max(l, 1e-30)`` cast to q's dtype. Any head dim;
    the last blocks may be short."""
    BH, G, Sq, Sk, Dh = check_inputs(q, k, v, window)
    blk_q = blk_q or TILES[q.dtype][0]
    blk_k = blk_k or TILES[q.dtype][1]
    scale = Dh**-0.5 if scale is None else scale
    dev = q.device
    off = Sk - Sq
    kf = k.float().repeat_interleave(G, dim=0)  # head bh reads kv head bh // G
    vf = v.float().repeat_interleave(G, dim=0)
    # detlint: ignore[DET005] — the plain version: the loop below fills
    # every query block
    out = torch.empty_like(q)
    for q0 in range(0, Sq, blk_q):
        qb = q[:, q0:q0 + blk_q].float() * scale
        nq = qb.shape[1]
        q_lo, q_hi = q0 + off, q0 + nq - 1 + off
        qpos = torch.arange(q_lo, q_hi + 1, dtype=torch.int32, device=dev)[:, None]
        m = torch.full((BH, nq), float("-inf"), dtype=torch.float32, device=dev)
        l = torch.zeros((BH, nq), dtype=torch.float32, device=dev)
        acc = torch.zeros((BH, nq, Dh), dtype=torch.float32, device=dev)
        for k0 in range(0, Sk, blk_k):
            kb, vb = kf[:, k0:k0 + blk_k], vf[:, k0:k0 + blk_k]
            k_hi = k0 + kb.shape[1] - 1
            live = True
            if causal:
                live = k0 <= q_hi
            if window is not None:
                live = live and k_hi > q_lo - window
            if not live:
                continue
            logits = torch.bmm(qb, kb.transpose(1, 2))
            kpos = torch.arange(k0, k_hi + 1, dtype=torch.int32, device=dev)[None, :]
            mask = torch.ones((nq, kb.shape[1]), dtype=torch.bool, device=dev)
            if causal:
                mask = kpos <= qpos
            if window is not None:
                mask = mask & (kpos > qpos - window)
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            m = m_new
            acc = acc * corr[..., None] + torch.bmm(p, vb)
        out[:, q0:q0 + nq] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out
