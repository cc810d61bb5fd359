"""Model-layout GQA flash attention (the reference's
``kernels/flash_attention/ops.py``).

Takes the model's grouped layout, q (B, Sq, M, G, Dh) and k/v (B, Sk, M, Dh),
flattens (B, M, G) into the kernel's head axis and (B, M) into the key/value
head axis (the kernel reads key/value head bh // G in place, so K and V are
not repeated), and returns (B, Sq, M*G, Dh) with head h = m*G + g.

CUDA tensors launch the kernel (or raise); CPU tensors run its plain
version. Nothing else: no fall back from one to the other. ``meta``
tensors (the dry run, ``launch/dryrun.py``) compute nothing: they get an
empty output of the kernel's shape and dtype, and no flops are counted for
it (the dry run adds the reference's analytic attention count instead;
the plain version would score all Sq x Sk pairs, twice a causal count).

The kernel computes the forward only, as the reference's Pallas kernel
does: where grad mode is on and an input requires grad, the call raises
(on the card and on the CPU alike) rather than return an output that no
gradient would flow through. Training attends through the chunked online
softmax (``models/attention.py:self_attention``'s ``train``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, Sq, M, G, Dh); k, v: (B, Sk, M, Dh) -> (B, Sq, M*G, Dh)."""
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention is forward-only: it has no backward, so it "
                           "refuses inputs that require grad (train with attn_impl "
                           "'chunked', or through forward_train, which does so for 'flash')")
    B, Sq, M, G, Dh = q.shape
    Sk = k.shape[1]
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * M * G, Sq, Dh).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * M, Sk, Dh).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * M, Sk, Dh).contiguous()
    if q.is_cuda:
        out = kernel.flash_attention_bhsd_cuda(qf, kf, vf, causal=causal,
                                               window=window, scale=scale)
    elif q.device.type == "cpu":
        out = kernel.flash_attention_bhsd_plain(qf, kf, vf, causal=causal,
                                                window=window, scale=scale)
    elif q.device.type == "meta":  # shapes only: nothing runs on meta
        kernel.check_inputs(qf, kf, vf, window)
        out = torch.empty_like(qf)
    else:
        raise ValueError(f"flash attention runs on CUDA, the CPU or meta, not {q.device}")
    return out.reshape(B, M, G, Sq, Dh).permute(0, 3, 1, 2, 4).reshape(B, Sq, M * G, Dh)
