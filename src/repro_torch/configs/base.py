"""Config dataclasses: model architectures, input shapes, epidemic datasets."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | vlm | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_window: Optional[int] = None  # sliding-window attention
    rope_theta: Optional[float] = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # hybrid (RecurrentGemma / Griffin)
    block_pattern: tuple = ()  # e.g. ("rec", "rec", "attn"), cycled
    local_window: int = 2048
    lru_width: int = 0  # 0 => d_model
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_groups: int = 1
    d_conv: int = 4
    expand: int = 2
    ssd_chunk: int = 256
    # encoder-decoder (Whisper)
    enc_layers: int = 0
    enc_frames: int = 1500
    # VLM (LLaVA-Next)
    num_patches: int = 0  # patch tokens prepended (anyres stub)
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # performance knobs (defaults = naive baseline)
    attn_impl: str = "naive"  # naive | chunked (online-softmax KV blocks) | flash
    attn_chunk: int = 1024  # KV chunk for attn_impl=chunked
    remat_policy: str = "nothing"  # nothing | dots | none
    moe_dispatch: str = "pjit"  # pjit (global scatter) | shard_map (local)
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // 64  # mamba2 head dim is 64

    @property
    def sub_quadratic(self) -> bool:
        """Supports decoding with O(1)/O(window) state (long_500k rule)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True  # RG-LRU state + local-window attention
        return self.attn_window is not None  # SWA

    def param_count(self) -> int:
        from repro_torch.models import model as model_lib

        return model_lib.param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import model as model_lib

        return model_lib.param_count(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether this (arch, shape) cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k decode skipped per assignment"
    return True, ""


@dataclasses.dataclass(frozen=True)
class EpidemicConfig:
    name: str
    generator: str  # twin | ws | grid
    num_people: int
    num_locations: int = 0  # ws only
    grid: tuple = ()  # grid only
    scale_note: str = ""
    seed: int = 0
    tau: float = 2.0e-5
    days: int = 200

    def build(self, pad_multiple: int = 128):
        from repro_torch.data import (
            digital_twin_population,
            grid_population,
            watts_strogatz_population,
        )

        if self.generator == "twin":
            return digital_twin_population(
                self.num_people, seed=self.seed, name=self.name,
                pad_multiple=pad_multiple,
            )
        if self.generator == "ws":
            return watts_strogatz_population(
                self.num_people, self.num_locations, seed=self.seed,
                name=self.name, pad_multiple=pad_multiple,
            )
        if self.generator == "grid":
            w, h = self.grid
            return grid_population(
                w, h, density=self.num_people / (w * h), seed=self.seed,
                name=self.name, pad_multiple=pad_multiple,
            )
        raise ValueError(self.generator)
