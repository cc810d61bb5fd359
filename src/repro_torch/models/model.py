"""Top-level model API: specs, parameters, the training loss, prefill and
cached decode (the reference's ``models/model.py``). Every function
dispatches on ``cfg.family``:

  dense | moe | vlm | hybrid | ssm -> models/transformer.py
  audio (enc-dec)                  -> models/encdec.py

Parameters are a dict tree of tensors (float32, the reference's
``param_dtype``). ``forward_train``, ``forward_prefill`` and ``decode_step``
run in ``cfg.compute_dtype``: they cast float32 leaves to it (a
differentiable cast: gradients reach the float32 leaves), which costs nothing
when the caller passed parameters already cast with :func:`cast_params`
(a serving session does so once, :func:`prepare`; the values are those of
the reference's per-call ``_cast``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import base as base_lib
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf_lib

#: The stacked layer groups of every family's tree.
LAYER_GROUPS = ("layers", "rec_layers", "attn_layers", "enc_layers", "dec_layers")


def model_specs(cfg: ModelConfig, max_target_positions: int = 0) -> dict:
    if cfg.family == "audio":
        return encdec_lib.model_specs(cfg, max(max_target_positions, 448))
    return tf_lib.model_specs(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                max_target_positions: int = 0):
    return base_lib.init_params(model_specs(cfg, max_target_positions), generator, device)


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Total (or MoE-active) parameter count — the N in MODEL_FLOPS=6ND."""
    total = base_lib.param_count(model_specs(cfg))
    if active_only and cfg.family == "moe":
        # replace the expert count with experts_per_token for the active count
        E, K = cfg.num_experts, cfg.experts_per_token
        expert_params = 3 * cfg.num_layers * E * cfg.d_model * cfg.d_ff
        total = total - expert_params + expert_params * K // E
    return total


def cast_params(cfg: ModelConfig, params):
    """The parameters in the compute dtype (float32 leaves cast)."""
    return base_lib.cast_floats(params, getattr(torch, cfg.compute_dtype))


def prepare(cfg: ModelConfig, params):
    """The parameters as a serving session holds them: cast to the compute
    dtype, each stacked layer group split into a list of per-layer dicts
    (views), so that a decode step does not slice them again. Every
    function here takes this form as well as the stacked one."""
    p = cast_params(cfg, params)
    return {**p, **{k: tf_lib.layer_list(p[k]) for k in LAYER_GROUPS if k in p}}


def _unembed_table(cfg, p):
    return p["embed"] if cfg.tie_embeddings else p["unembed"]


def forward_train(cfg: ModelConfig, params, batch) -> tuple:
    """Returns (loss, metrics) of one batch: the next-token cross entropy,
    plus the MoE's auxiliary losses for the moe family. batch["tokens"]:
    (B, S) integer tokens; vlm also batch["patch_embeds"] (B, Np, D), put
    before the tokens, the loss over the text span only; audio
    batch["frames"] (B, F, D) and an optional batch["loss_mask"] over the
    (B, S - 1) predicted positions. Attention takes its training route
    (``attention.self_attention``'s ``train``)."""
    compute = getattr(torch, cfg.compute_dtype)
    p = cast_params(cfg, params)
    tokens = batch["tokens"]

    if cfg.family == "audio":
        enc_out = encdec_lib.encode(cfg, p, batch["frames"].to(compute), train=True)
        logits = encdec_lib.decode_train(cfg, p, tokens, enc_out, train=True)
        loss = L.cross_entropy_loss(logits[:, :-1], tokens[:, 1:], batch.get("loss_mask"))
        return loss, {"loss": loss}

    x = L.embed(tokens, p["embed"]).to(compute)
    npatch = 0
    if cfg.family == "vlm":
        patches = batch["patch_embeds"].to(compute)  # (B, Np, D)
        x = torch.cat([patches, x], dim=1)
        npatch = patches.shape[1]
    h, _, aux = tf_lib.stack_forward(cfg, p, x, train=True)
    h = L.rms_norm(h, p["final_norm"], cfg.norm_eps)
    logits = L.unembed(h, _unembed_table(cfg, p))
    # token t_j sits at position npatch + j: the loss over the text span only
    loss = L.cross_entropy_loss(logits[:, npatch:-1], tokens[:, 1:])
    metrics = {"loss": loss}
    if cfg.family == "moe":
        loss = loss + 0.01 * aux["load_balance"] + 0.001 * aux["router_z"]
        metrics.update({"load_balance": aux["load_balance"],
                        "dropped_fraction": aux["dropped_fraction"]})
    return loss, metrics


def forward_prefill(cfg: ModelConfig, params, batch):
    """Full-sequence forward. batch["tokens"]: (B, S) integer tokens; vlm
    also batch["patch_embeds"] (B, Np, D), put before the tokens; audio
    batch["frames"] (B, F, D). Returns (last-position logits (B, 1, V), the
    family's decode cache, for audio ``{"enc_out": ...}``)."""
    compute = getattr(torch, cfg.compute_dtype)
    p = cast_params(cfg, params)
    if cfg.family == "audio":
        enc_out = encdec_lib.encode(cfg, p, batch["frames"].to(compute))
        logits = encdec_lib.decode_train(cfg, p, batch["tokens"], enc_out)
        return logits[:, -1:], {"enc_out": enc_out}
    x = L.embed(batch["tokens"], p["embed"]).to(compute)
    if cfg.family == "vlm":
        x = torch.cat([batch["patch_embeds"].to(compute), x], dim=1)
    S = x.shape[1]
    h, cache, _ = tf_lib.stack_forward(cfg, p, x, want_cache=True, cache_len=S)
    h = L.rms_norm(h, p["final_norm"], cfg.norm_eps)
    logits = L.unembed(h[:, -1:], _unembed_table(cfg, p))
    return logits, cache


def decode_step(cfg: ModelConfig, params, cache, token, pos: int):
    """One decode step. token: (B, 1); pos: absolute position (a Python int).
    Updates ``cache`` (attention keys/values in place); returns (logits
    (B, 1, V), cache)."""
    p = cast_params(cfg, params)
    if cfg.family == "audio":
        return encdec_lib.decode_step(cfg, p, cache, token, pos)
    x = L.embed(token, p["embed"])
    h, cache = tf_lib.decode_stack(cfg, p, x, cache, pos)
    h = L.rms_norm(h, p["final_norm"], cfg.norm_eps)
    return L.unembed(h, _unembed_table(cfg, p)), cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device):
    if cfg.family == "audio":
        return encdec_lib.init_cache(cfg, batch, cache_len, device=device)
    return tf_lib.init_cache(cfg, batch, cache_len, device=device)
