"""The ten language-model architectures of the reference package
(``repro/configs/archs.py``, field for field), plus ``reduced_config`` for
CPU tests.

Each entry cites its source. The port serves and trains every family
(``models/model.py``, ``launch/{serve,train}.py``), shards it on a
``DeviceMesh`` and dry-runs every arch x shape cell (``launch/dryrun.py``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig

SMOLLM_360M = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152, head_dim=64,
    tie_embeddings=True,
    source="[hf:HuggingFaceTB/SmolLM-135M; hf] llama-arch small, GQA kv=5",
)

GRANITE_3_2B = ModelConfig(
    name="granite-3-2b", family="dense",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=49155, head_dim=64,
    tie_embeddings=True,
    source="[hf:ibm-granite/granite-3.0-2b-base; hf] GQA",
)

QWEN3_14B = ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=17408, vocab_size=151936, head_dim=128,
    qk_norm=True,
    source="[hf:Qwen/Qwen3-8B; hf] qk_norm, GQA",
)

QWEN2_1_5B = ModelConfig(
    name="qwen2-1.5b", family="dense",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    qkv_bias=True, tie_embeddings=True,
    source="[arXiv:2407.10671; hf] GQA, QKV bias",
)

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    num_experts=8, experts_per_token=2, attn_window=4096,
    source="[arXiv:2401.04088; hf] 8 experts top-2, SWA",
)

MOONSHOT_16B_A3B = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128,
    num_experts=64, experts_per_token=6,
    source="[hf:moonshotai/Moonlight-16B-A3B; hf] kimi/moonlight, 64e top-6",
)

RECURRENTGEMMA_9B = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    block_pattern=("rec", "rec", "attn"), local_window=2048,
    lru_width=4096, tie_embeddings=True,
    source="[arXiv:2402.19427; unverified] RG-LRU + local attn, 1:2",
)

LLAVA_NEXT_MISTRAL_7B = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    attn_window=4096, num_patches=576,
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] anyres tiling "
    "(frontend stubbed: precomputed patch embeddings); mistral SWA backbone",
)

MAMBA2_130M = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_groups=1, d_conv=4, expand=2, ssd_chunk=256,
    tie_embeddings=True, rope_theta=None,
    source="[arXiv:2405.21060; unverified] SSD (state-space duality)",
)

WHISPER_BASE = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    enc_layers=6, enc_frames=1500, rope_theta=None, norm_eps=1e-5,
    source="[arXiv:2212.04356; unverified] enc-dec, conv frontend (stubbed: "
    "precomputed frame embeddings)",
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        SMOLLM_360M, GRANITE_3_2B, QWEN3_14B, QWEN2_1_5B,
        MIXTRAL_8X7B, MOONSHOT_16B_A3B, RECURRENTGEMMA_9B,
        LLAVA_NEXT_MISTRAL_7B, MAMBA2_130M, WHISPER_BASE,
    )
}


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests: few layers, narrow
    width, few experts, small vocab. Structure (GQA ratios, pattern,
    flags) is preserved."""
    kv = max(cfg.num_kv_heads, 1)
    heads = max(cfg.num_heads, 1)
    g = max(heads // kv, 1)
    small_kv = min(kv, 2)
    small_heads = small_kv * min(g, 3)
    repl = {
        "num_layers": min(cfg.num_layers, 4 if not cfg.block_pattern else 4),
        "d_model": 64,
        "num_heads": small_heads if cfg.family != "ssm" else 0,
        "num_kv_heads": small_kv if cfg.family != "ssm" else 0,
        "head_dim": 16 if cfg.family != "ssm" else 0,
        "d_ff": 128 if cfg.d_ff else 0,
        "vocab_size": 512,
        "num_experts": min(cfg.num_experts, 4),
        "experts_per_token": min(cfg.experts_per_token, 2),
        "attn_window": 32 if cfg.attn_window else None,
        "local_window": 32,
        "lru_width": 64 if cfg.lru_width else 0,
        "ssm_state": 16 if cfg.ssm_state else 0,
        "ssd_chunk": 16,
        "enc_layers": min(cfg.enc_layers, 2),
        "enc_frames": 24 if cfg.enc_frames and cfg.family == "audio" else cfg.enc_frames,
        "num_patches": 8 if cfg.num_patches else 0,
        "name": cfg.name + "-smoke",
    }
    return dataclasses.replace(cfg, **repl)
