"""Whisper-style encoder-decoder backbone, arXiv:2212.04356 (the
reference's ``repro/models/encdec.py``).

The conv/log-mel frontend is a stub, as in the reference: the encoder
takes precomputed frame embeddings (B, enc_frames, D). The backbone: pre-LN
transformer with GELU MLPs and biased projections, sinusoidal encoder
positions, learned decoder positions, causal decoder self-attention and
cross-attention to the encoder output.

As in the reference, :func:`init_cache` makes the cross-attention keys and
values (``xk``, ``xv``) zeros and nothing fills them from :func:`encode`'s
output, so a decode step's cross-attention reads zeros (ROADMAP queue 3,
"Faults in the reference", item 4). The port mirrors that.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import sharding as shard_lib
from repro_torch.models.base import ParamSpec
from repro_torch.models.transformer import _ckpt, layer_list


def _attn_specs(cfg, n, prefix=""):
    D, H, M, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = prefix
    return {
        p + "wq": ParamSpec((n, D, H, Dh), ("layers", "embed_fsdp", "heads", "head_dim")),
        p + "wk": ParamSpec((n, D, M, Dh), ("layers", "embed_fsdp", "kv_heads", "head_dim")),
        p + "wv": ParamSpec((n, D, M, Dh), ("layers", "embed_fsdp", "kv_heads", "head_dim")),
        p + "wo": ParamSpec((n, H, Dh, D), ("layers", "heads", "head_dim", "embed_fsdp")),
        p + "bq": ParamSpec((n, H, Dh), ("layers", "heads", "head_dim"), "zeros"),
        p + "bk": ParamSpec((n, M, Dh), ("layers", "kv_heads", "head_dim"), "zeros"),
        p + "bv": ParamSpec((n, M, Dh), ("layers", "kv_heads", "head_dim"), "zeros"),
        p + "bo": ParamSpec((n, D), ("layers", None), "zeros"),
    }


def _mlp_specs(cfg, n):
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_in": ParamSpec((n, D, F), ("layers", "embed_fsdp", "mlp")),
        "b_in": ParamSpec((n, F), ("layers", "mlp"), "zeros"),
        "w_out": ParamSpec((n, F, D), ("layers", "mlp", "embed_fsdp")),
        "b_out": ParamSpec((n, D), ("layers", None), "zeros"),
    }


def _ln(n, D, prefix):
    return {
        prefix + "_w": ParamSpec((n, D), ("layers", None), "ones"),
        prefix + "_b": ParamSpec((n, D), ("layers", None), "zeros"),
    }


def model_specs(cfg, max_target_positions: int = 448) -> dict:
    D, V = cfg.d_model, cfg.vocab_size
    ne, nd = cfg.enc_layers, cfg.num_layers
    return {
        "embed": ParamSpec((V, D), ("vocab", "embed_fsdp"), "embed"),
        "pos_dec": ParamSpec((max_target_positions, D), ("seq", "embed_fsdp"), "embed"),
        "enc_layers": {
            **_attn_specs(cfg, ne), **_mlp_specs(cfg, ne),
            **_ln(ne, D, "ln1"), **_ln(ne, D, "ln2"),
        },
        "dec_layers": {
            **_attn_specs(cfg, nd), **_attn_specs(cfg, nd, "x_"),
            **_mlp_specs(cfg, nd),
            **_ln(nd, D, "ln1"), **_ln(nd, D, "ln2"), **_ln(nd, D, "ln3"),
        },
        "enc_norm_w": ParamSpec((D,), (None,), "ones"),
        "enc_norm_b": ParamSpec((D,), (None,), "zeros"),
        "dec_norm_w": ParamSpec((D,), (None,), "ones"),
        "dec_norm_b": ParamSpec((D,), (None,), "zeros"),
    }


def _project(x, w, b):
    """x (B, S, D) through w (D, n, Dh) plus b (n, Dh) -> (B, S, n, Dh)."""
    return shard_lib.split_dim(x @ shard_lib.merge_dims(w, 1), -1, tuple(w.shape[1:])) + b


def _mha(x, kv_x, layer, cfg, prefix="", causal=False, mask=None, train=False, rules=None):
    """Generic (self or cross) full attention with biases, no RoPE. Three
    routes, as the reference's: the flash kernel for causal self-attention
    (Sq == Sk) under ``attn_impl="flash"`` (with ``rules``, through
    ``attention.flash_sharded``; in a training forward, ``train``, the
    chunked online softmax in its place, as the reference does without a
    mesh); the chunked online softmax under ``"chunked"`` when the keys
    divide into chunks; else ``attend`` with ``mask`` (by default causal or
    full)."""
    H, M = cfg.num_heads, cfg.num_kv_heads
    Sq, Sk = x.shape[1], kv_x.shape[1]
    q = _project(x, layer[prefix + "wq"], layer[prefix + "bq"])
    k = _project(kv_x, layer[prefix + "wk"], layer[prefix + "bk"])
    v = _project(kv_x, layer[prefix + "wv"], layer[prefix + "bv"])
    q = shard_lib.split_dim(q, 2, (M, H // M))
    flash = cfg.attn_impl == "flash" and mask is None and causal and Sq == Sk
    if flash and not train and rules is not None:
        out = attn_lib.flash_sharded(q, k, v, cfg, rules, causal=True)
    elif flash and not train:
        out = flash_attention(q, k, v, causal=True)
    elif flash or (cfg.attn_impl == "chunked" and mask is None
                   and Sk % min(cfg.attn_chunk, Sk) == 0):
        out = attn_lib.attend_chunked(q, k, v, cfg, causal=causal, window=None,
                                      chunk=cfg.attn_chunk)
    else:
        if mask is None:
            if causal:
                mask = attn_lib.causal_window_mask(Sq, 0, Sk, None, x.device)[None, None, None]
            else:
                mask = torch.ones((1, 1, 1, Sq, Sk), dtype=torch.bool, device=x.device)
        out = attn_lib.attend(q, k, v, mask, cfg)
    return attn_lib.out_project(out, {"wo": layer[prefix + "wo"]}) + layer[prefix + "bo"]


def _enc_layer(x, layer, cfg, train, rules):
    hn = L.layer_norm(x, layer["ln1_w"], layer["ln1_b"], cfg.norm_eps)
    x = x + _mha(hn, hn, layer, cfg, train=train, rules=rules)
    hn = L.layer_norm(x, layer["ln2_w"], layer["ln2_b"], cfg.norm_eps)
    return x + L.gelu_mlp(hn, layer["w_in"], layer["b_in"], layer["w_out"], layer["b_out"])


def _dec_layer(x, layer, enc_out, cfg, train, rules):
    hn = L.layer_norm(x, layer["ln1_w"], layer["ln1_b"], cfg.norm_eps)
    x = x + _mha(hn, hn, layer, cfg, causal=True, train=train, rules=rules)
    hn = L.layer_norm(x, layer["ln2_w"], layer["ln2_b"], cfg.norm_eps)
    x = x + _mha(hn, enc_out, layer, cfg, prefix="x_", train=train, rules=rules)
    hn = L.layer_norm(x, layer["ln3_w"], layer["ln3_b"], cfg.norm_eps)
    return x + L.gelu_mlp(hn, layer["w_in"], layer["b_in"], layer["w_out"], layer["b_out"])


def encode(cfg, params, frames, *, train=False, rules=None):
    """frames: (B, F, D) precomputed embeddings (frontend stub). Each layer
    runs under remat (``transformer._ckpt``) where grad mode is on;
    ``train`` marks a training forward (see :func:`_mha`); ``rules``: the
    sharding rules, or None."""
    pe = L.sinusoidal_positions(frames.shape[1], cfg.d_model, device=frames.device)
    x = frames + pe[None].to(frames.dtype)
    body = _ckpt(lambda h, layer: _enc_layer(h, layer, cfg, train, rules), cfg)
    for layer in layer_list(params["enc_layers"]):
        x = body(x, layer)
    return L.layer_norm(x, params["enc_norm_w"], params["enc_norm_b"], cfg.norm_eps)


def decode_train(cfg, params, tokens, enc_out, *, train=False, rules=None):
    """Teacher-forced decoder. tokens: (B, S). Returns logits (B, S, V).
    Remat, ``train`` and ``rules`` as in :func:`encode`."""
    S = tokens.shape[1]
    x = (L.embed(tokens, params["embed"]) + params["pos_dec"][None, :S]).to(enc_out.dtype)
    body = _ckpt(lambda h, layer, enc: _dec_layer(h, layer, enc, cfg, train, rules), cfg)
    for layer in layer_list(params["dec_layers"]):
        x = body(x, layer, enc_out)
    x = L.layer_norm(x, params["dec_norm_w"], params["dec_norm_b"], cfg.norm_eps)
    logits = x @ params["embed"].to(x.dtype).t()
    return logits if rules is None else rules.constraint(logits, "batch", "seq", "vocab")


def init_cache(cfg, batch, cache_len, enc_frames=None, *, device=None, dtype=torch.bfloat16,
               abstract=False):
    """k/v (n, B, M, cache_len, Dh) for decoder self-attention and the
    cross-attention xk/xv (n, B, M, F, Dh), all zeros (``abstract``: shapes
    and dtypes only, ``meta`` tensors)."""
    device = "meta" if abstract else device
    n = cfg.num_layers
    M, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    F = enc_frames or cfg.enc_frames
    zeros = lambda s: torch.zeros(s, dtype=dtype, device=device)
    return {
        "k": zeros((n, batch, M, cache_len, Dh)),
        "v": zeros((n, batch, M, cache_len, Dh)),
        # Cross-attention K/V precomputed from the encoder output.
        "xk": zeros((n, batch, M, F, Dh)),
        "xv": zeros((n, batch, M, F, Dh)),
    }


def cache_axes_tree(cfg, cache):
    ax = ("layers", "batch", "kv_heads", "cache_seq", "head_dim")
    xax = ("layers", "batch", "kv_heads", "frames", "head_dim")
    return {"k": ax, "v": ax, "xk": xax, "xv": xax}


def decode_step(cfg, params, cache, token, pos: int):
    """token: (B, 1); pos: absolute position (a Python int). Writes the
    step's self-attention key/value into ``cache`` in place; returns
    (logits (B, 1, V), cache)."""
    x = L.embed(token, params["embed"]) + params["pos_dec"][pos][None, None, :]
    H, M = cfg.num_heads, cfg.num_kv_heads
    _, valid = attn_lib.decode_tables(cfg, pos, cache["k"].shape[3], device=x.device)
    full = torch.ones((1, 1, 1, 1, cache["xk"].shape[3]), dtype=torch.bool, device=x.device)
    for i, layer in enumerate(layer_list(params["dec_layers"])):
        k, v, xk, xv = cache["k"][i], cache["v"][i], cache["xk"][i], cache["xv"][i]
        hn = L.layer_norm(x, layer["ln1_w"], layer["ln1_b"], cfg.norm_eps)
        q = _project(hn, layer["wq"], layer["bq"])
        slot = pos % k.shape[2]
        attn_lib.write_slot(k, _project(hn, layer["wk"], layer["bk"])[:, 0], slot)
        attn_lib.write_slot(v, _project(hn, layer["wv"], layer["bv"])[:, 0], slot)
        out = attn_lib.attend(shard_lib.split_dim(q, 2, (M, H // M)),
                              k.permute(0, 2, 1, 3).to(q.dtype),
                              v.permute(0, 2, 1, 3).to(q.dtype), valid, cfg)
        x = x + attn_lib.out_project(out, layer) + layer["bo"]
        # cross attention against precomputed enc K/V
        hn = L.layer_norm(x, layer["ln2_w"], layer["ln2_b"], cfg.norm_eps)
        qx = shard_lib.split_dim(_project(hn, layer["x_wq"], layer["x_bq"]), 2, (M, H // M))
        outx = attn_lib.attend(qx, xk.permute(0, 2, 1, 3).to(qx.dtype),
                               xv.permute(0, 2, 1, 3).to(qx.dtype), full, cfg)
        x = x + attn_lib.out_project(outx, {"wo": layer["x_wo"]}) + layer["x_bo"]
        hn = L.layer_norm(x, layer["ln3_w"], layer["ln3_b"], cfg.norm_eps)
        x = x + L.gelu_mlp(hn, layer["w_in"], layer["b_in"], layer["w_out"], layer["b_out"])
    x = L.layer_norm(x, params["dec_norm_w"], params["dec_norm_b"], cfg.norm_eps)
    return x @ params["embed"].to(x.dtype).t(), cache
