"""Int8 gradient compression with error feedback, for a cross-pod
data-parallel all-reduce (the reference's ``optim/grad_compress.py``).

Per-tensor symmetric int8 quantization cuts the bytes of a gradient
all-reduce 4x; the quantization residual is carried to the next step
(error feedback), which keeps SGD/Adam convergence (Karimireddy et al.,
2019). :func:`compressed_psum_tree` is the reference's ``shard_map``-side
helper on ``torch.distributed``: where the reference sums over a mesh axis
(``axis_name``), it sums over a process group (``group``, default the world
group).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.base import tree_leaves, tree_unflatten


def compress_int8(g):
    """Per-tensor symmetric quantization. Returns (q int8, scale f32)."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale


def error_feedback_update(g, residual):
    """Apply the carried residual, quantize, compute the new residual.

    Returns (quantized_pair, new_residual). The caller all-reduces the
    quantized payload and decompresses."""
    g_corrected = g.float() + residual
    q, scale = compress_int8(g_corrected)
    new_residual = g_corrected - decompress_int8(q, scale)
    return (q, scale), new_residual


def compressed_psum_tree(grads, residuals, group=None):
    """int8-compress each gradient leaf, sum the int8 payloads over
    ``group`` in int32, decompress, and return (the mean gradients, the new
    residuals), both trees of ``grads``' structure."""
    n = dist.get_world_size(group)
    flat_r = dict(tree_leaves(residuals))
    outs, new_res = {}, {}
    for path, g in tree_leaves(grads):
        (q, scale), new_res[path] = error_feedback_update(g, flat_r[path])
        # int8 payloads sum without overflow in int32 across <= 128 pods
        summed = q.to(torch.int32)
        dist.all_reduce(summed, group=group)
        # scales differ per rank: sum them and take the mean contribution
        scale_sum = scale.clone()
        dist.all_reduce(scale_sum, group=group)
        outs[path] = summed.float() * (scale_sum / n) / n
    return tree_unflatten(grads, outs), tree_unflatten(grads, new_res)
