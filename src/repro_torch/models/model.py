"""Top-level model API: specs, parameters, prefill and cached decode (the
reference's ``models/model.py`` for the dense family).

Parameters are a dict tree of tensors (float32, the reference's
``param_dtype``). ``forward_prefill`` and ``decode_step`` run in
``cfg.compute_dtype``: they cast float32 leaves to it, which costs nothing
when the caller passed parameters already cast with :func:`cast_params`
(a serving session does so once, :func:`prepare`; the values are those of
the reference's per-call ``_cast``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import base as base_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf_lib


def model_specs(cfg: ModelConfig) -> dict:
    return tf_lib.model_specs(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    return base_lib.init_params(model_specs(cfg), generator, device)


def param_count(cfg: ModelConfig) -> int:
    """Total parameter count — the N in MODEL_FLOPS=6ND."""
    return base_lib.param_count(model_specs(cfg))


def cast_params(cfg: ModelConfig, params):
    """The parameters in the compute dtype (float32 leaves cast)."""
    return base_lib.cast_floats(params, getattr(torch, cfg.compute_dtype))


def prepare(cfg: ModelConfig, params):
    """The parameters as a serving session holds them: cast to the compute
    dtype, the stacked layers split into a list of per-layer dicts (views),
    so that a decode step does not slice them again. Every function here
    takes this form as well as the stacked one."""
    p = cast_params(cfg, params)
    return {**p, "layers": tf_lib.layer_list(p["layers"])}


def _unembed_table(cfg, p):
    return p["embed"] if cfg.tie_embeddings else p["unembed"]


def forward_prefill(cfg: ModelConfig, params, batch):
    """Full-sequence forward. batch["tokens"]: (B, S) integer tokens.
    Returns (last-position logits (B, 1, V), decode cache k/v (n, B, M, S, Dh)
    in the compute dtype)."""
    tf_lib.require_dense(cfg)
    p = cast_params(cfg, params)
    x = L.embed(batch["tokens"], p["embed"])
    S = x.shape[1]
    h, cache = tf_lib.stack_forward(cfg, p, x, want_cache=True, cache_len=S)
    h = L.rms_norm(h, p["final_norm"], cfg.norm_eps)
    logits = L.unembed(h[:, -1:], _unembed_table(cfg, p))
    return logits, cache


def decode_step(cfg: ModelConfig, params, cache, token, pos: int):
    """One decode step. token: (B, 1); pos: absolute position (a Python int).
    Writes the step's key/value into ``cache`` in place; returns (logits
    (B, 1, V), cache)."""
    tf_lib.require_dense(cfg)
    p = cast_params(cfg, params)
    x = L.embed(token, p["embed"])
    h, cache = tf_lib.decode_stack(cfg, p, x, cache, pos)
    h = L.rms_norm(h, p["final_norm"], cfg.norm_eps)
    return L.unembed(h, _unembed_table(cfg, p)), cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device):
    return tf_lib.init_cache(cfg, batch, cache_len, device=device)
