"""Naive masked attention with an f32 softmax: the oracle for the
flash-attention kernel (the reference's ``kernels/flash_attention/ref.py``)."""

from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q: (BH, Sq, Dh); k, v: (BH, Sk, Dh). Returns (BH, Sq, Dh)."""
    Dh = q.shape[-1]
    scale = scale if scale is not None else Dh**-0.5
    logits = torch.einsum("bqd,bkd->bqk", q, k).float() * scale
    Sq, Sk = q.shape[1], k.shape[1]
    dev = q.device
    qpos = torch.arange(Sq, dtype=torch.int32, device=dev)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, dtype=torch.int32, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask[None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs.to(q.dtype), v)
