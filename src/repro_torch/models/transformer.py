"""Decoder-only model assembly for the dense family: parameter specs,
prefill forward and cached decode (the dense branch of the reference's
``models/transformer.py``).

Layer parameters are stacked on a leading axis under the reference's names
and shapes; the forward walks them with a Python loop (the reference's
``lax.scan``). The other families raise ``NotImplementedError``: their
blocks (``moe``, ``ssd``, ``rglru``, ``encdec``, the VLM front end) are not
ported yet (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.base import ParamSpec


def require_dense(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the '{cfg.family}' family is not ported yet; the port "
            "serves the dense family only (ROADMAP queue 1 item 7)"
        )


def attn_specs(cfg, n: int) -> dict:
    D, H, M, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    s = {
        "wq": ParamSpec((n, D, H, Dh), ("layers", "embed_fsdp", "heads", "head_dim")),
        "wk": ParamSpec((n, D, M, Dh), ("layers", "embed_fsdp", "kv_heads", "head_dim")),
        "wv": ParamSpec((n, D, M, Dh), ("layers", "embed_fsdp", "kv_heads", "head_dim")),
        "wo": ParamSpec((n, H, Dh, D), ("layers", "heads", "head_dim", "embed_fsdp")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((n, H, Dh), ("layers", "heads", "head_dim"), "zeros")
        s["bk"] = ParamSpec((n, M, Dh), ("layers", "kv_heads", "head_dim"), "zeros")
        s["bv"] = ParamSpec((n, M, Dh), ("layers", "kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((n, Dh), ("layers", "head_dim"), "ones")
        s["k_norm"] = ParamSpec((n, Dh), ("layers", "head_dim"), "ones")
    return s


def mlp_specs(cfg, n: int) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((n, D, F), ("layers", "embed_fsdp", "mlp")),
        "w_up": ParamSpec((n, D, F), ("layers", "embed_fsdp", "mlp")),
        "w_down": ParamSpec((n, F, D), ("layers", "mlp", "embed_fsdp")),
    }


def _norm(n, D):
    return ParamSpec((n, D), ("layers", None), "ones")


def model_specs(cfg) -> dict:
    require_dense(cfg)
    D, V, n = cfg.d_model, cfg.vocab_size, cfg.num_layers
    specs: dict = {
        "embed": ParamSpec((V, D), ("vocab", "embed_fsdp"), "embed"),
        "final_norm": ParamSpec((D,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((V, D), ("vocab", "embed_fsdp"), "embed")
    specs["layers"] = {
        **attn_specs(cfg, n), **mlp_specs(cfg, n),
        "ln1": _norm(n, D), "ln2": _norm(n, D),
    }
    return specs


def layer_list(layers) -> list:
    """Per-layer parameter dicts: views into the stacked tensors, or the
    list itself when a session already unstacked them (``model.prepare``)."""
    if isinstance(layers, list):
        return layers
    n = next(iter(layers.values())).shape[0]
    return [{k: a[i] for k, a in layers.items()} for i in range(n)]


def attn_block(x, layer, cfg, rot, *, window):
    h = L.rms_norm(x, layer["ln1"], cfg.norm_eps)
    out, kv = attn_lib.self_attention(h, layer, cfg, rot, window=window)
    x = x + out
    h = L.rms_norm(x, layer["ln2"], cfg.norm_eps)
    return x + L.swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"]), kv


def stack_forward(cfg, params, x, *, want_cache=False, cache_len=0):
    """x: (B, S, D) embedded input. Returns (hidden (B,S,D), cache or None):
    the cache stacks each layer's ring buffer, k/v (n, B, M, T, Dh)."""
    require_dense(cfg)
    window = cfg.attn_window
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]
    rot = attn_lib.rotary(cfg, positions)
    ks, vs = [], []
    for layer in layer_list(params["layers"]):
        x, kv = attn_block(x, layer, cfg, rot, window=window)
        if want_cache:
            c = _kv_to_cache(kv, cache_len, window)
            ks.append(c["k"])
            vs.append(c["v"])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if want_cache else None
    return x, cache


def _kv_to_cache(kv, cache_len, window):
    """(k, v) of (B, S, M, Dh) -> ring-buffer cache (B, M, T, Dh)."""
    k, v = kv
    S = k.shape[1]
    T = min(cache_len or S, window or S, S) if (window or cache_len) else S
    T = min(T, S)
    slots = torch.arange(S - T, S, device=k.device) % T
    kk = torch.zeros((k.shape[0], k.shape[2], T, k.shape[3]), dtype=k.dtype, device=k.device)
    vv = torch.zeros_like(kk)
    kk[:, :, slots] = k[:, S - T:].permute(0, 2, 1, 3)
    vv[:, :, slots] = v[:, S - T:].permute(0, 2, 1, 3)
    return {"k": kk, "v": vv}


def init_cache(cfg, batch: int, cache_len: int, *, device, dtype=torch.bfloat16):
    """Stacked per-layer decode state: k/v (n, B, M, T, Dh), bf16 by default
    whatever the compute dtype (as the reference's)."""
    require_dense(cfg)
    n = cfg.num_layers
    T = min(cache_len, cfg.attn_window) if cfg.attn_window else cache_len
    M, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((n, batch, M, T, Dh), dtype=dtype, device=device),
        "v": torch.zeros((n, batch, M, T, Dh), dtype=dtype, device=device),
    }


def decode_stack(cfg, params, x, cache, pos: int):
    """x: (B, 1, D); pos: absolute position. Updates ``cache`` in place;
    returns (hidden, cache)."""
    require_dense(cfg)
    tables = attn_lib.decode_tables(cfg, pos, cache["k"].shape[3], window=cfg.attn_window,
                                    device=x.device)
    for i, layer in enumerate(layer_list(params["layers"])):
        hn = L.rms_norm(x, layer["ln1"], cfg.norm_eps)
        out, _ = attn_lib.decode_attention(
            hn, layer, {"k": cache["k"][i], "v": cache["v"][i]}, pos, cfg, tables)
        x = x + out
        hn = L.rms_norm(x, layer["ln2"], cfg.norm_eps)
        x = x + L.swiglu(hn, layer["w_gate"], layer["w_up"], layer["w_down"])
    return x, cache
