"""Attention: GQA with optional qk-norm, QKV biases and sliding windows,
RoPE, and a ring-buffer KV cache (the reference's ``models/attention.py``).

With sharding rules (``models/sharding.py``) the activations are DTensors
and the reference's constraints redistribute them; :func:`flash_sharded`
runs the flash kernel on each rank's data shard of the (B, M, G) planes,
the reference's ``shard_map``. Without rules everything runs on one device.

Shapes: H query heads grouped over M kv heads (G = H // M). Attention math
is written grouped, q (B, S, M, G, Dh) against k/v (B, S, M, Dh), without
materialising repeated K/V.

Cache contract (decode): a cache entry is a dict with k/v of shape
(B, M, T, Dh), T the allocated slots (full length, or the window for SWA
archs). Absolute position p sits in slot ``p % T``. Keys are stored post-RoPE
at absolute positions. Slot i holds position ``pos - ((pos - i) mod T)`` for
query position ``pos`` (floor mod), valid iff that is >= 0. The port writes
the new key/value into the cache in place.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers
from repro_torch.models import sharding as shard_lib

NEG_INF = -1e30


def rotary(cfg, positions):
    """The rotary tables (sin, cos) for (B or 1, S) ``positions``, or None
    when the arch has no RoPE; one pass computes them once for all layers."""
    if not cfg.rope_theta:
        return None
    return layers.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta, 4)


def qkv_project(x, p, cfg, rot):
    """x: (B, S, D) -> q (B,S,M,G,Dh), k,v (B,S,M,Dh), roped by the
    :func:`rotary` tables ``rot``."""
    H, M, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G = H // M
    split, merge = shard_lib.split_dim, shard_lib.merge_dims
    q = split(layers.matmul(x, merge(p["wq"], 1)), -1, (H, Dh))
    k = split(layers.matmul(x, merge(p["wk"], 1)), -1, (M, Dh))
    v = split(layers.matmul(x, merge(p["wv"], 1)), -1, (M, Dh))
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rot is not None:
        q = layers.apply_rope(q, *rot)
        k = layers.apply_rope(k, *rot)
    return split(q, 2, (M, G)), k, v


def attend(q, k, v, mask, cfg):
    """q: (B,Sq,M,G,Dh); k,v: (B,Sk,M,Dh); mask broadcastable to
    (B,M,G,Sq,Sk). Logits in the compute dtype, softmax in float32.
    Returns (B,Sq,H,Dh). DTensors attend split over the batch alone
    (``sharding.batch_split``)."""
    q, k, v = shard_lib.batch_split(q, k, v)
    scale = cfg.resolved_head_dim**-0.5
    logits = torch.einsum("bsmgk,btmk->bmgst", q, k) * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bmgst,btmk->bsmgk", probs, v)
    B, Sq = out.shape[0], out.shape[1]
    return out.reshape(B, Sq, cfg.num_heads, cfg.resolved_head_dim)


def out_project(out, p):
    """(B, S, H, Dh) attention output through ``wo`` (H, Dh, D)."""
    merge = shard_lib.merge_dims
    return layers.matmul(merge(out, 2), merge(p["wo"], 0))


def causal_window_mask(sq: int, sk_offset: int, sk: int, window: Optional[int], device):
    """(Sq, Sk) mask; query i is at absolute position sk_offset + i."""
    qpos = sk_offset + torch.arange(sq, dtype=torch.int32, device=device)[:, None]
    kpos = torch.arange(sk, dtype=torch.int32, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def attend_chunked(q, k, v, cfg, *, causal=True, window=None, chunk=1024):
    """Online-softmax attention over KV chunks in plain PyTorch (the
    reference's XLA flash algorithm): never materialises (Sq, Sk), computes
    every chunk (no skip). The accumulator stays in the compute dtype, the
    running max and sum in float32.

    q: (B,Sq,M,G,Dh); k,v: (B,Sk,M,Dh). Returns (B,Sq,H,Dh). DTensors
    attend split over the batch alone (``sharding.batch_split``)."""
    q, k, v = shard_lib.batch_split(q, k, v)
    B, Sq, M, G, Dh = q.shape
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    if Sk % chunk:
        raise ValueError(f"Sk={Sk} is not a multiple of the chunk {chunk}")
    scale = cfg.resolved_head_dim**-0.5
    q = q * scale
    dev = q.device
    qpos = torch.arange(Sq, dtype=torch.int32, device=dev)[:, None]
    m = torch.full((B, M, G, Sq), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((B, M, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, M, G, Dh), dtype=q.dtype, device=dev)
    for j in range(Sk // chunk):
        kj, vj = k[:, j * chunk:(j + 1) * chunk], v[:, j * chunk:(j + 1) * chunk]
        logits = torch.einsum("bsmgk,btmk->bmgst", q, kj).float()
        kpos = j * chunk + torch.arange(chunk, dtype=torch.int32, device=dev)[None, :]
        mask = torch.ones((Sq, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask = kpos <= qpos
        if window is not None:
            mask = mask & (kpos > qpos - window)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bmgst,btmk->bsmgk", p.to(q.dtype), vj)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None].to(acc.dtype)
    return out.reshape(B, Sq, cfg.num_heads, cfg.resolved_head_dim)


def flash_route(q_shape, k_shape, rules) -> str:
    """Which route :func:`flash_sharded` takes for q (B, Sq, M, G, Dh) and
    k (B, Sk, M, Dh) under ``rules``: "kernel", or "chunked" where the
    reference falls back (no mesh, no data axes, planes B*M*G that do not
    divide the data axes, or Sq / Sk not a multiple of its block)."""
    B, Sq, M, G, _ = q_shape
    Sk = k_shape[1]
    blk = max(min(512, Sq, Sk), 128)
    if rules is None or not hasattr(rules, "mesh"):
        return "chunked"
    dsize = shard_lib.data_size(rules.mesh)
    if not shard_lib.data_axes(rules.mesh) or (B * M * G) % dsize or Sq % blk or Sk % blk:
        return "chunked"
    return "kernel"


def flash_sharded(q, k, v, cfg, rules, *, causal=True, window=None):
    """The flash kernel per data shard (the reference's ``shard_map``): the
    (B, M, G) planes split over the data axes, the model axis replicated;
    each rank calls the kernel wrapper on its planes. Forward only, so for
    prefill and decode. :func:`flash_route` says when it attends through
    :func:`attend_chunked` instead, as the reference does.

    q: (B,Sq,M,G,Dh); k,v: (B,Sk,M,Dh), DTensors on ``rules.mesh`` (plain
    tensors: the whole planes on this rank). Returns (B,Sq,H,Dh)."""
    if flash_route(q.shape, k.shape, rules) == "chunked":
        with shard_lib.replicate_plain(isinstance(q, DTensor)):
            return attend_chunked(q, k, v, cfg, causal=causal, window=window,
                                  chunk=cfg.attn_chunk)
    if not isinstance(q, DTensor):
        return flash_attention(q, k, v, causal=causal, window=window)
    mesh = q.device_mesh
    manual = shard_lib.data_axes(mesh)
    split = tuple(Shard(0) if n in manual else Replicate() for n in mesh.mesh_dim_names)
    B, Sq, M, G, Dh = q.shape
    Sk = k.shape[1]
    dsize = shard_lib.data_size(mesh)
    if B % dsize == 0:  # a data shard of the planes is a shard of the batch
        ql, kl, vl = (t.redistribute(mesh, split).to_local() for t in (q, k, v))
        out = flash_attention(ql, kl, vl, causal=causal, window=window)
        return DTensor.from_local(out, mesh, split, run_check=False)
    # the planes' shards cut across batch rows: this rank's block of the
    # flattened planes, K/V repeated per query head (the reference's layout)
    qf = shard_lib.replicated(q).permute(0, 2, 3, 1, 4).reshape(B * M * G, Sq, Dh)
    kf, vf = (shard_lib.replicated(t).permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
              .reshape(B * M * G, Sk, Dh) for t in (k, v))
    coord = mesh.get_coordinate()
    idx = 0
    for n in manual:
        i = mesh.mesh_dim_names.index(n)
        idx = idx * mesh.size(i) + coord[i]
    n_l = B * M * G // dsize
    blk = slice(idx * n_l, (idx + 1) * n_l)
    out = flash_attention(qf[blk, :, None, None], kf[blk, :, None], vf[blk, :, None],
                          causal=causal, window=window)[:, :, 0]
    out = DTensor.from_local(out, mesh, split, run_check=False)
    out = shard_lib.replicated(out).reshape(B, M, G, Sq, Dh)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, M * G, Dh)
    return shard_lib.as_replicated(out, q)


def self_attention(x, p, cfg, rot, *, window=None, causal=True, train=False, rules=None):
    """Full-sequence attention (train / prefill); ``rot`` holds the
    :func:`rotary` tables of positions ``arange(S)``. Returns (out, (k, v)).

    ``train`` marks a training forward: there ``attn_impl="flash"`` attends
    through :func:`attend_chunked` with ``cfg.attn_chunk``, as the
    reference's ``flash_sharded`` does without a mesh, since the kernel is
    forward-only. With ``rules``, q/k/v take the reference's constraints and
    the flash route is :func:`flash_sharded`; without, the kernel on all
    planes (the reference under a 1 x 1 mesh)."""
    S = x.shape[1]
    q, k, v = qkv_project(x, p, cfg, rot)
    if rules is not None:
        q = rules.constraint(q, "batch", "q_seq", "kv_heads", None, "head_dim")
        k = rules.constraint(k, "batch", "seq", "kv_heads", "head_dim")
        v = rules.constraint(v, "batch", "seq", "kv_heads", "head_dim")
    if cfg.attn_impl == "flash" and not train:
        if rules is not None:
            out = flash_sharded(q, k, v, cfg, rules, causal=causal, window=window)
        else:
            out = flash_attention(q, k, v, causal=causal, window=window)
    elif cfg.attn_impl in ("flash", "chunked"):
        out = attend_chunked(q, k, v, cfg, causal=causal, window=window,
                             chunk=cfg.attn_chunk)
    elif cfg.attn_impl == "naive":
        if causal:
            mask = causal_window_mask(S, 0, S, window, x.device)[None, None, None]
        else:
            mask = torch.ones((1, 1, 1, S, S), dtype=torch.bool, device=x.device)
        out = attend(q, k, v, mask, cfg)
    else:
        raise ValueError(f"unknown attn_impl '{cfg.attn_impl}'")
    return out_project(out, p), (k, v)


def init_cache_entry(cfg, batch: int, alloc: int, *, device, dtype=torch.bfloat16):
    M, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, M, alloc, Dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, M, alloc, Dh), dtype=dtype, device=device),
    }


def cache_entry_struct(cfg, batch: int, alloc: int, dtype=torch.bfloat16):
    """:func:`init_cache_entry`'s shapes and dtype as ``meta`` tensors."""
    return init_cache_entry(cfg, batch, alloc, device="meta", dtype=dtype)


def cache_axes():
    return ("batch", "kv_heads", "cache_seq", "head_dim")


def write_slot(cache, new, slot: int) -> None:
    """``cache[:, :, slot] = new`` in place: cache (B, M, T, Dh), new
    (B, M, Dh). On DTensors each rank writes its own shard (an in-place
    index write has no sharding strategy): ``new`` redistributed to the
    cache's placements, the slot written where this rank holds it."""
    if not isinstance(cache, DTensor):
        cache[:, :, slot] = new.to(cache.dtype)
        return
    mesh = cache.device_mesh
    keep = tuple(Replicate() if pl == Shard(2) else pl for pl in cache.placements)
    new = new.to(cache.dtype)[:, :, None].redistribute(mesh, keep).to_local()
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh, cache.placements)
    if offset[2] <= slot < offset[2] + shape[2]:
        cache.to_local()[:, :, slot - offset[2]] = new[:, :, 0]


def decode_tables(cfg, pos: int, T: int, *, window=None, device):
    """What one decode position needs in every layer: the rotary tables at
    ``pos`` and the (1,1,1,1,T) validity mask of the ring's slots (slot i
    holds position pos - ((pos - i) mod T), floor mod; valid iff >= 0 and
    inside the window)."""
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=device)
    i = torch.arange(T, dtype=torch.int64, device=device)
    slot_pos = pos - torch.remainder(pos - i, T)
    valid = slot_pos >= 0
    if window is not None:
        valid = valid & (slot_pos > pos - window)
    return rotary(cfg, positions), valid[None, None, None, None, :]


def decode_attention(x, p, cache, pos: int, cfg, tables):
    """Single-token decode. x: (B, 1, D); pos: absolute position (a Python
    int); ``tables``: :func:`decode_tables` for ``pos`` (the window enters
    there). Writes the new key/value into ``cache`` in place
    (:func:`write_slot`); returns (out (B,1,D), cache). The reference takes
    its rules here but constrains nothing: a sharded cache keeps its
    placements."""
    rot, mask = tables
    q, k_new, v_new = qkv_project(x, p, cfg, rot)
    slot = pos % cache["k"].shape[2]
    write_slot(cache["k"], k_new[:, 0], slot)
    write_slot(cache["v"], v_new[:, 0], slot)
    kk = cache["k"].permute(0, 2, 1, 3).to(q.dtype)  # (B, T, M, Dh)
    vv = cache["v"].permute(0, 2, 1, 3).to(q.dtype)
    return out_project(attend(q, kk, vv, mask, cfg), p), cache
