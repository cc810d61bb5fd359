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

With sharding rules (``models/sharding.py``'s ``MeshRules`` on a
``DeviceMesh``) the three take DTensor parameters, batches and caches, placed
by ``launch/steps.py``'s shardings, and apply the reference's constraints;
the specs of every parameter, cache and input come from
:func:`param_partition_specs`, :func:`cache_partition_specs` and
:func:`batch_partition_specs`.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import base as base_lib
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import layers as L
from repro_torch.models import sharding as shard_lib
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


def abstract_params(cfg: ModelConfig, max_target_positions: int = 0):
    """:func:`init_params`' shapes and dtypes as ``meta`` tensors."""
    return base_lib.abstract_params(model_specs(cfg, max_target_positions))


def param_partition_specs(cfg: ModelConfig, rules, max_target_positions: int = 0):
    return base_lib.param_partition_specs(model_specs(cfg, max_target_positions), rules)


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


def forward_train(cfg: ModelConfig, params, batch, rules=None) -> tuple:
    """Returns (loss, metrics) of one batch: the next-token cross entropy,
    plus the MoE's auxiliary losses for the moe family. batch["tokens"]:
    (B, S) integer tokens; vlm also batch["patch_embeds"] (B, Np, D), put
    before the tokens, the loss over the text span only; audio
    batch["frames"] (B, F, D) and an optional batch["loss_mask"] over the
    (B, S - 1) predicted positions. Attention takes its training route
    (``attention.self_attention``'s ``train``). ``rules``: the sharding
    rules, or None."""
    with shard_lib.replicate_plain(shard_lib.mesh_of(rules) is not None):
        return _forward_train(cfg, params, batch, rules)


def _forward_train(cfg, params, batch, rules):
    compute = getattr(torch, cfg.compute_dtype)
    p = cast_params(cfg, params)
    tokens = batch["tokens"]

    if cfg.family == "audio":
        enc_out = encdec_lib.encode(cfg, p, batch["frames"].to(compute), train=True,
                                    rules=rules)
        logits = encdec_lib.decode_train(cfg, p, tokens, enc_out, train=True, rules=rules)
        loss = L.cross_entropy_loss(logits[:, :-1], tokens[:, 1:], batch.get("loss_mask"))
        return loss, {"loss": loss}

    x = L.embed(tokens, p["embed"]).to(compute)
    if rules is not None:
        x = rules.constraint(x, "batch", "seq", "embed")
    npatch = 0
    if cfg.family == "vlm":
        patches = batch["patch_embeds"].to(compute)  # (B, Np, D)
        x = torch.cat([patches, x], dim=1)
        npatch = patches.shape[1]
    h, _, aux = tf_lib.stack_forward(cfg, p, x, train=True, rules=rules)
    h = L.rms_norm(h, p["final_norm"], cfg.norm_eps)
    logits = L.unembed(h, _unembed_table(cfg, p), rules)
    # token t_j sits at position npatch + j: the loss over the text span only
    loss = L.cross_entropy_loss(logits[:, npatch:-1], tokens[:, 1:])
    metrics = {"loss": loss}
    if cfg.family == "moe":
        loss = loss + 0.01 * aux["load_balance"] + 0.001 * aux["router_z"]
        metrics.update({"load_balance": aux["load_balance"],
                        "dropped_fraction": aux["dropped_fraction"]})
    return loss, metrics


def forward_prefill(cfg: ModelConfig, params, batch, rules=None):
    """Full-sequence forward. batch["tokens"]: (B, S) integer tokens; vlm
    also batch["patch_embeds"] (B, Np, D), put before the tokens; audio
    batch["frames"] (B, F, D). Returns (last-position logits (B, 1, V), the
    family's decode cache, for audio ``{"enc_out": ...}``). ``rules``: the
    sharding rules, or None."""
    with shard_lib.replicate_plain(shard_lib.mesh_of(rules) is not None):
        return _forward_prefill(cfg, params, batch, rules)


def _forward_prefill(cfg, params, batch, rules):
    compute = getattr(torch, cfg.compute_dtype)
    p = cast_params(cfg, params)
    if cfg.family == "audio":
        enc_out = encdec_lib.encode(cfg, p, batch["frames"].to(compute), rules=rules)
        logits = encdec_lib.decode_train(cfg, p, batch["tokens"], enc_out, rules=rules)
        return logits[:, -1:], {"enc_out": enc_out}
    x = L.embed(batch["tokens"], p["embed"]).to(compute)
    if cfg.family == "vlm":
        x = torch.cat([batch["patch_embeds"].to(compute), x], dim=1)
    S = x.shape[1]
    h, cache, _ = tf_lib.stack_forward(cfg, p, x, want_cache=True, cache_len=S, rules=rules)
    h = L.rms_norm(h, p["final_norm"], cfg.norm_eps)
    logits = L.unembed(h[:, -1:], _unembed_table(cfg, p), rules)
    return logits, cache


def decode_step(cfg: ModelConfig, params, cache, token, pos: int, rules=None):
    """One decode step. token: (B, 1); pos: absolute position (a Python int).
    Updates ``cache`` (attention keys/values in place); returns (logits
    (B, 1, V), cache). ``rules``: the sharding rules, or None; a sharded
    cache leaf that the step replaces keeps its placements (the reference's
    ``out_shardings``)."""
    with shard_lib.replicate_plain(shard_lib.mesh_of(rules) is not None):
        placed = {k: v.placements for k, v in cache.items() if shard_lib.is_dtensor(v)}
        logits, cache = _decode_step(cfg, params, cache, token, pos, rules)
        for k, pl in placed.items():
            if cache[k].placements != pl:
                cache[k] = cache[k].redistribute(cache[k].device_mesh, pl)
        return logits, cache


def _decode_step(cfg, params, cache, token, pos, rules):
    p = cast_params(cfg, params)
    if cfg.family == "audio":
        return encdec_lib.decode_step(cfg, p, cache, token, pos)
    x = L.embed(token, p["embed"])
    h, cache = tf_lib.decode_stack(cfg, p, x, cache, pos, rules)
    h = L.rms_norm(h, p["final_norm"], cfg.norm_eps)
    return L.unembed(h, _unembed_table(cfg, p), rules), cache


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device=None, abstract=False):
    if cfg.family == "audio":
        return encdec_lib.init_cache(cfg, batch, cache_len, device=device, abstract=abstract)
    return tf_lib.init_cache(cfg, batch, cache_len, device=device, abstract=abstract)


def cache_axes(cfg: ModelConfig, cache):
    if cfg.family == "audio":
        return encdec_lib.cache_axes_tree(cfg, cache)
    return tf_lib.cache_axes_tree(cfg, cache)


def cache_partition_specs(cfg: ModelConfig, cache, rules):
    """The spec of each cache leaf, asked in sorted-key order (``jax.tree``'s,
    for ``rules.dropped``)."""
    axes = cache_axes(cfg, cache)
    return {k: rules.spec(tuple(cache[k].shape), axes[k]) for k in sorted(cache)}


# ---------------------------------------------------------------------------
# Input specs (shapes and dtypes of every (arch x shape) cell's inputs)
# ---------------------------------------------------------------------------


def _struct(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract inputs for one (arch, shape) cell: ``meta`` tensors with the
    reference's shapes and dtypes."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            return {"frames": _struct((B, cfg.enc_frames, cfg.d_model), bf16),
                    "tokens": _struct((B, S), i32)}
        if cfg.family == "vlm":
            return {"patch_embeds": _struct((B, cfg.num_patches, cfg.d_model), bf16),
                    "tokens": _struct((B, S - cfg.num_patches), i32)}
        return {"tokens": _struct((B, S), i32)}
    # decode: one new token against a cache of length S
    return {"token": _struct((B, 1), i32), "cache": init_cache(cfg, B, S, abstract=True),
            "pos": _struct((), i32)}


_BATCH_AXES = {"tokens": ("batch", "seq"), "token": ("batch", "seq"),
               "frames": ("batch", "frames", "embed"),
               "patch_embeds": ("batch", "patches", "embed"), "pos": ()}


def batch_partition_specs(cfg: ModelConfig, shape: ShapeConfig, rules):
    """PartitionSpecs matching :func:`input_specs` (asked in its key order,
    as the reference)."""
    out = {}
    for k, v in input_specs(cfg, shape).items():
        if k == "cache":
            out[k] = cache_partition_specs(cfg, v, rules)
        else:
            out[k] = rules.spec(tuple(v.shape), _BATCH_AXES[k])
    return out
