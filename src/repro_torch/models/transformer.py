"""Decoder-only model assembly for the dense, moe, vlm, ssm and hybrid
families: parameter specs, train/prefill forward and cached decode (the
reference's ``models/transformer.py``).

Layer parameters are stacked on a leading axis under the reference's names
and shapes; the forward walks them with a Python loop (the reference's
``lax.scan``), through :func:`layer_list` views. The hybrid family
(RecurrentGemma) walks whole (rec, rec, attn) cycles, then the rec
remainder, and returns the reference's nested prefill cache. Where grad
mode is on, each layer (each hybrid cycle) runs under :func:`_ckpt`, the
reference's remat, on the reference's boundaries.

With sharding rules (``models/sharding.py``) every block takes the
reference's constraints and the parameters, activations and caches are
DTensors; without, everything runs on one device.

Decode writes attention keys and values into the cache in place; the
recurrent states (``conv``, ``ssm``, ``lru``) are replaced by the step's new
stacked tensors, whose dtype is the reference's (a float32 step promotes
them, as ``jnp.stack`` does).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.base import ParamSpec

# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


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
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((n, D, F_), ("layers", "embed_fsdp", "mlp")),
        "w_up": ParamSpec((n, D, F_), ("layers", "embed_fsdp", "mlp")),
        "w_down": ParamSpec((n, F_, D), ("layers", "mlp", "embed_fsdp")),
    }


def moe_specs(cfg, n: int) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamSpec((n, D, E), ("layers", "embed_fsdp", None), "small"),
        "w_gate": ParamSpec((n, E, D, F_), ("layers", "expert", "embed_fsdp", "mlp")),
        "w_up": ParamSpec((n, E, D, F_), ("layers", "expert", "embed_fsdp", "mlp")),
        "w_down": ParamSpec((n, E, F_, D), ("layers", "expert", "mlp", "embed_fsdp")),
    }


def ssd_specs(cfg, n: int) -> dict:
    D = cfg.d_model
    Din = cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = Din + 2 * G * N
    proj_out = 2 * Din + 2 * G * N + H
    return {
        "in_proj": ParamSpec((n, D, proj_out), ("layers", "embed_fsdp", None)),
        "conv_w": ParamSpec((n, cfg.d_conv, conv_dim), ("layers", "conv", None)),
        "conv_b": ParamSpec((n, conv_dim), ("layers", None), "zeros"),
        "A_log": ParamSpec((n, H), ("layers", None), "ones"),
        "D": ParamSpec((n, H), ("layers", None), "ones"),
        "dt_bias": ParamSpec((n, H), ("layers", None), "zeros"),
        "norm": ParamSpec((n, Din), ("layers", None), "ones"),
        "out_proj": ParamSpec((n, Din, D), ("layers", None, "embed_fsdp")),
    }


def rec_specs(cfg, n: int) -> dict:
    D = cfg.d_model
    W = cfg.lru_width or D
    return {
        "w_gelu": ParamSpec((n, D, W), ("layers", "embed_fsdp", "lru")),
        "w_lin": ParamSpec((n, D, W), ("layers", "embed_fsdp", "lru")),
        "conv_w": ParamSpec((n, 4, W), ("layers", "conv", "lru")),
        "conv_b": ParamSpec((n, W), ("layers", "lru"), "zeros"),
        "w_a": ParamSpec((n, W, W), ("layers", "lru", None), "small"),
        "b_a": ParamSpec((n, W), ("layers", "lru"), "zeros"),
        "w_x": ParamSpec((n, W, W), ("layers", "lru", None), "small"),
        "b_x": ParamSpec((n, W), ("layers", "lru"), "zeros"),
        "lam": ParamSpec((n, W), ("layers", "lru"), "ones"),
        "w_out": ParamSpec((n, W, D), ("layers", "lru", "embed_fsdp")),
    }


def _norm(n, D):
    return ParamSpec((n, D), ("layers", None), "ones")


def hybrid_layer_types(cfg) -> list[str]:
    pat = cfg.block_pattern or ("attn",)
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def _mlp_prefixed(cfg, n, D) -> dict:
    return {**{f"mlp_{k}": v for k, v in mlp_specs(cfg, n).items()}, "ln2": _norm(n, D)}


def model_specs(cfg) -> dict:
    D, V, n = cfg.d_model, cfg.vocab_size, cfg.num_layers
    specs: dict = {
        "embed": ParamSpec((V, D), ("vocab", "embed_fsdp"), "embed"),
        "final_norm": ParamSpec((D,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((V, D), ("vocab", "embed_fsdp"), "embed")
    if cfg.family == "ssm":
        specs["layers"] = {**ssd_specs(cfg, n), "ln": _norm(n, D)}
    elif cfg.family == "hybrid":
        types = hybrid_layer_types(cfg)
        n_rec, n_attn = types.count("rec"), types.count("attn")
        specs["rec_layers"] = {**rec_specs(cfg, n_rec), "ln1": _norm(n_rec, D),
                               **_mlp_prefixed(cfg, n_rec, D)}
        specs["attn_layers"] = {**attn_specs(cfg, n_attn), "ln1": _norm(n_attn, D),
                                **_mlp_prefixed(cfg, n_attn, D)}
    else:  # dense / moe / vlm
        ffn = moe_specs(cfg, n) if cfg.family == "moe" else mlp_specs(cfg, n)
        specs["layers"] = {**attn_specs(cfg, n), **ffn,
                           "ln1": _norm(n, D), "ln2": _norm(n, D)}
    return specs


def layer_list(layers) -> list:
    """Per-layer parameter dicts: views into the stacked tensors, or the
    list itself when a session already unstacked them (``model.prepare``).
    The views come from one ``unbind`` per stacked tensor, whose backward
    stacks the layers' gradients once (indexing layer by layer would, in
    the backward, zero-fill and add a whole stacked tensor per layer)."""
    if isinstance(layers, list):
        return layers
    per_key = {k: a.unbind(0) for k, a in layers.items()}
    n = next(iter(layers.values())).shape[0]
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


def _stack(trees: list):
    """The leaves of equal-structured tuples / dicts / tensors stacked on a
    new leading axis (the reference's ``lax.scan`` outputs), promoted to
    one dtype as ``jnp.stack`` promotes."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([t[i] for t in trees]) for i in range(len(first)))
    dt = first.dtype
    for t in trees[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.stack([t.to(dt) for t in trees])


#: The products whose outputs the "dots" policy saves (``dots_saveable``).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _ckpt(fn, cfg):
    """Remat policy knob (cfg.remat_policy): 'nothing' (save only the
    inputs, recompute all in the backward), 'dots' (save the matmul outputs,
    recompute the rest), 'none' (no remat). Only where grad mode is on:
    without it ``fn`` runs as it is."""
    if cfg.remat_policy == "none":
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_saveable)

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        # nothing in a layer draws random numbers: no RNG state to replay
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    return remat


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _mlp_of(layer) -> dict:
    """The SwiGLU weights of a layer: its ``mlp_``-prefixed entries (hybrid
    layers), else the layer itself."""
    mlp = {k[4:]: v for k, v in layer.items() if k.startswith("mlp_")}
    return mlp if mlp else layer


def _swiglu(h, layer, rules=None):
    mlp = _mlp_of(layer)
    return L.swiglu(h, mlp["w_gate"], mlp["w_up"], mlp["w_down"], rules)


def attn_block(x, layer, cfg, rot, *, window, train=False, rules=None):
    """Pre-norm attention then the FFN (MoE for the moe family). Returns
    (x, (k, v), aux); aux is the MoE's, else empty. ``train``: see
    ``attention.self_attention``."""
    h = L.rms_norm(x, layer["ln1"], cfg.norm_eps)
    out, kv = attn_lib.self_attention(h, layer, cfg, rot, window=window, train=train,
                                      rules=rules)
    x = x + out
    h = L.rms_norm(x, layer["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        m, aux = moe_lib.moe_ffn_dispatch(h, layer, cfg, rules)
    else:
        m, aux = _swiglu(h, layer, rules), {}
    return x + m, kv, aux


def ssd_block(x, layer, cfg, state=None):
    """Mamba2 block. Returns (x, (conv_tail, ssm_state))."""
    h = L.rms_norm(x, layer["ln"], cfg.norm_eps)
    Din = cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = h @ layer["in_proj"]
    z, xBC, dt_raw = torch.split(zxbcdt, [Din, Din + 2 * G * N, H], dim=-1)
    xBC = F.silu(ssd_lib.causal_conv1d(xBC, layer["conv_w"], layer["conv_b"]))
    xs, B_, C_ = torch.split(xBC, [Din, G * N, G * N], dim=-1)
    b, S = x.shape[:2]
    xs = xs.reshape(b, S, H, Din // H)
    B_ = B_.reshape(b, S, G, N)
    C_ = C_.reshape(b, S, G, N)
    dt = F.softplus(dt_raw + layer["dt_bias"])  # (b,S,H)
    A = -torch.exp(layer["A_log"].float())
    init = state[1] if state is not None else None
    y, ssm_state = ssd_lib.ssd_scan_ref(
        xs.float(), dt.float(), A, B_.float(), C_.float(),
        min(cfg.ssd_chunk, S), initial_state=init,
    )
    y = y.to(x.dtype) + xs * layer["D"][None, None, :, None]
    y = y.reshape(b, S, Din)
    y = L.rms_norm(y * F.silu(z), layer["norm"], cfg.norm_eps)
    out = y @ layer["out_proj"]
    # conv state for decode: the last (k-1) *pre-activation* conv inputs
    k = layer["conv_w"].shape[0]
    conv_tail = zxbcdt[:, -(k - 1):, Din:2 * Din + 2 * G * N]
    return x + out, (conv_tail, ssm_state)


def rec_block(x, layer, cfg, state=None, rules=None):
    h = L.rms_norm(x, layer["ln1"], cfg.norm_eps)
    out, new_state = rglru_lib.recurrent_block(h, layer, cfg, state, rules)
    x = x + out
    h = L.rms_norm(x, layer["ln2"], cfg.norm_eps)
    return x + _swiglu(h, layer, rules), new_state


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------


def _zero_aux() -> dict:
    return {"load_balance": 0.0, "router_z": 0.0, "dropped_fraction": 0.0}


def stack_forward(cfg, params, x, *, want_cache=False, cache_len=0, train=False, rules=None):
    """x: (B, S, D) embedded input. Returns (hidden (B,S,D), cache or None,
    aux). The cache is the reference's: k/v (n, B, M, T, Dh) for attention
    stacks, (conv tails, ssm states) for ssm, the nested cycles/remainder
    tree for hybrid; aux the mean over layers of the MoE's. ``train`` marks
    a training forward (``attention.self_attention``); ``rules``: the
    sharding rules, or None."""
    if cfg.family == "ssm":
        body = _ckpt(lambda h, layer: ssd_block(h, layer, cfg), cfg)
        states = []
        for layer in layer_list(params["layers"]):
            x, st = body(x, layer)
            states.append(st)
        return x, (_stack(states) if want_cache else None), _zero_aux()

    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]
    rot = attn_lib.rotary(cfg, positions)
    if cfg.family == "hybrid":
        return _hybrid_forward(cfg, params, x, rot, want_cache, cache_len, train, rules)

    # dense / moe / vlm
    window = cfg.attn_window
    body = _ckpt(lambda h, layer: attn_block(h, layer, cfg, rot, window=window, train=train,
                                             rules=rules), cfg)
    caches, auxs = [], []
    for layer in layer_list(params["layers"]):
        x, kv, aux = body(x, layer)
        if want_cache:
            caches.append(_kv_to_cache(kv, cache_len, window))
        auxs.append(aux)
    aux = _zero_aux()
    if cfg.family == "moe":
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    return x, (_stack(caches) if want_cache else None), aux


def _kv_to_cache(kv, cache_len, window):
    """(k, v) of (B, S, M, Dh) -> ring-buffer cache (B, M, T, Dh): the last
    T positions, position p in slot p % T, i.e. rotated by (S - T) % T."""
    k, v = kv
    S = k.shape[1]
    T = min(cache_len or S, window or S, S) if (window or cache_len) else S
    T = min(T, S)
    r = (S - T) % T

    def ring(a):
        a = a[:, S - T:].permute(0, 2, 1, 3)
        # a concatenation, not an index write: it has a sharding strategy
        return torch.cat([a[:, :, T - r:], a[:, :, :T - r]], dim=2)

    return {"k": ring(k), "v": ring(v)}


def _hybrid_forward(cfg, params, x, rot, want_cache, cache_len, train=False, rules=None):
    """Whole (rec, rec, attn) cycles (cycle c uses attention layer c), then
    the remainder as rec layers; remat (:func:`_ckpt`) wraps each whole
    cycle, not the remainder, as the reference's scan body. The cache, if
    wanted, is the reference's ``{"cycles": per pattern slot, stacked over
    cycles, "rem": per layer}``."""
    types = hybrid_layer_types(cfg)
    pat = len(cfg.block_pattern)
    cycles = cfg.num_layers // pat
    rem = types[cycles * pat:]
    rec, attn = layer_list(params["rec_layers"]), layer_list(params["attn_layers"])
    window = cfg.local_window
    n_rec = cfg.block_pattern.count("rec")

    def cycle(h, rec_layers, attn_layer):
        states, rj = [], 0
        for t in cfg.block_pattern:
            if t == "rec":
                h, st = rec_block(h, rec_layers[rj], cfg, rules=rules)
                states.append(st)
                rj += 1
            else:
                h, kv, _ = attn_block(h, attn_layer, cfg, rot, window=window, train=train,
                                      rules=rules)
                states.append(_kv_to_cache(kv, cache_len, window) if want_cache else None)
        return h, tuple(states)

    cycle = _ckpt(cycle, cfg)
    cycle_states = []
    for c in range(cycles):
        x, states = cycle(x, rec[c * n_rec:(c + 1) * n_rec], attn[c])
        cycle_states.append(states)
    ri = cycles * n_rec
    rem_states = []
    for i in range(len(rem)):
        x, st = rec_block(x, rec[ri + i], cfg, rules=rules)
        rem_states.append(st)
    cache = None
    if want_cache:
        cache = {"cycles": _stack(cycle_states) if cycle_states else None,
                 "rem": tuple(rem_states)}
    return x, cache, _zero_aux()


# ---------------------------------------------------------------------------
# Decode (single token with cache)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, cache_len: int, *, device=None, dtype=torch.bfloat16,
               abstract=False):
    """Stacked per-layer decode state, in ``dtype`` (bf16 by default,
    whatever the compute dtype, as the reference's) except the float32
    ``ssm`` and ``lru`` states: k/v (n, B, M, T, Dh); ssm: conv
    (n, B, d_conv - 1, conv_dim) and ssm (n, B, H, P, N); hybrid: conv
    (n_rec, B, 3, W), lru (n_rec, B, W) and a local-window k/v.
    ``abstract``: shapes and dtypes only (``meta`` tensors)."""
    device = "meta" if abstract else device
    zeros = lambda s, d: torch.zeros(s, dtype=d, device=device)
    n = cfg.num_layers
    if cfg.family == "ssm":
        Din, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        conv_dim = Din + 2 * G * N
        return {
            "conv": zeros((n, batch, cfg.d_conv - 1, conv_dim), dtype),
            "ssm": zeros((n, batch, H, Din // H, N), torch.float32),
        }
    M, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.family == "hybrid":
        types = hybrid_layer_types(cfg)
        n_rec, n_attn = types.count("rec"), types.count("attn")
        W = cfg.lru_width or cfg.d_model
        T = min(cache_len, cfg.local_window)
        return {
            "conv": zeros((n_rec, batch, 3, W), dtype),
            "lru": zeros((n_rec, batch, W), torch.float32),
            "k": zeros((n_attn, batch, M, T, Dh), dtype),
            "v": zeros((n_attn, batch, M, T, Dh), dtype),
        }
    T = min(cache_len, cfg.attn_window) if cfg.attn_window else cache_len
    return {"k": zeros((n, batch, M, T, Dh), dtype), "v": zeros((n, batch, M, T, Dh), dtype)}


def cache_axes_tree(cfg, cache):
    """Logical axes for each cache leaf (for shardings)."""
    ax = {
        "k": ("layers", "batch", "kv_heads", "cache_seq", "head_dim"),
        "v": ("layers", "batch", "kv_heads", "cache_seq", "head_dim"),
        "conv": ("layers", "batch", "conv", "lru"),
        "lru": ("layers", "batch", "lru"),
        "ssm": ("layers", "batch", None, "head_dim", "state"),
    }
    return {k: ax[k] for k in cache}


def _attn_decode_layer(x, layer, cache, i, pos, cfg, tables, rules=None):
    """One attention layer of a decode step: attention into layer i's ring
    (in place), then the FFN."""
    hn = L.rms_norm(x, layer["ln1"], cfg.norm_eps)
    out, _ = attn_lib.decode_attention(
        hn, layer, {"k": cache["k"][i], "v": cache["v"][i]}, pos, cfg, tables)
    x = x + out
    hn = L.rms_norm(x, layer["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        return x + moe_lib.moe_ffn_dispatch(hn, layer, cfg, rules)[0]
    return x + _swiglu(hn, layer, rules)


def decode_stack(cfg, params, x, cache, pos: int, rules=None):
    """x: (B, 1, D); pos: absolute position. Updates ``cache`` (see the
    module docstring); returns (hidden, cache)."""
    if cfg.family == "ssm":
        convs, ssms = [], []
        for i, layer in enumerate(layer_list(params["layers"])):
            x, (conv, ssm) = _ssd_decode_block(x, layer, cfg,
                                               (cache["conv"][i], cache["ssm"][i]))
            convs.append(conv)
            ssms.append(ssm)
        cache["conv"], cache["ssm"] = _stack(convs), _stack(ssms)
        return x, cache
    if cfg.family == "hybrid":
        return _hybrid_decode(cfg, params, x, cache, pos, rules)
    tables = attn_lib.decode_tables(cfg, pos, cache["k"].shape[3], window=cfg.attn_window,
                                    device=x.device)
    for i, layer in enumerate(layer_list(params["layers"])):
        x = _attn_decode_layer(x, layer, cache, i, pos, cfg, tables, rules)
    return x, cache


def _ssd_decode_block(x, layer, cfg, state):
    conv_st, ssm_st = state
    h = L.rms_norm(x, layer["ln"], cfg.norm_eps)
    Din, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = (h @ layer["in_proj"])[:, 0]
    z, xBC_new, dt_raw = torch.split(zxbcdt, [Din, Din + 2 * G * N, H], dim=-1)
    xBC, conv_st = ssd_lib.conv_decode_step(
        xBC_new, conv_st.to(xBC_new.dtype), layer["conv_w"], layer["conv_b"])
    xBC = F.silu(xBC)
    xs, B_, C_ = torch.split(xBC, [Din, G * N, G * N], dim=-1)
    b = x.shape[0]
    xs = xs.reshape(b, H, Din // H)
    B_ = B_.reshape(b, G, N)
    C_ = C_.reshape(b, G, N)
    dt = F.softplus(dt_raw + layer["dt_bias"])
    A = -torch.exp(layer["A_log"].float())
    y, ssm_st = ssd_lib.ssd_decode_step(
        xs.float(), dt.float(), A, B_.float(), C_.float(), ssm_st)
    y = y.to(x.dtype) + xs * layer["D"][None, :, None]
    y = y.reshape(b, Din)
    y = L.rms_norm(y * F.silu(z), layer["norm"], cfg.norm_eps)
    out = y @ layer["out_proj"]
    return x + out[:, None, :], (conv_st, ssm_st)


def _hybrid_decode(cfg, params, x, cache, pos: int, rules=None):
    """The reference's layer walk: rec layers update conv/lru, attention
    layers their local-window ring. After the first rec layer x is float32
    (the float32 lru state promotes it, as in the reference)."""
    rec, attn = layer_list(params["rec_layers"]), layer_list(params["attn_layers"])
    tables = attn_lib.decode_tables(cfg, pos, cache["k"].shape[3], window=cfg.local_window,
                                    device=x.device)
    ri = ai = 0
    convs, lrus = [], []
    for t in hybrid_layer_types(cfg):
        if t == "rec":
            layer = rec[ri]
            hn = L.rms_norm(x, layer["ln1"], cfg.norm_eps)
            out, (conv, lru) = rglru_lib.recurrent_block_decode(
                hn, layer, (cache["conv"][ri].to(x.dtype), cache["lru"][ri]))
            x = x + out
            hn = L.rms_norm(x, layer["ln2"], cfg.norm_eps)
            x = x + _swiglu(hn, layer, rules)
            convs.append(conv)
            lrus.append(lru)
            ri += 1
        else:
            x = _attn_decode_layer(x, attn[ai], cache, ai, pos, cfg, tables, rules)
            ai += 1
    cache["conv"], cache["lru"] = _stack(convs), _stack(lrus)
    return x, cache
