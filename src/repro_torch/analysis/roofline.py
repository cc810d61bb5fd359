"""Three-term roofline model (NVIDIA H100 SXM target) from dry-run
measurements (the reference's ``repro/analysis/roofline.py``, its formulas
unchanged, its TPU v5e constants replaced by an H100's).

    compute    = flops_per_chip / PEAK_FLOPS
    memory     = bytes_per_chip / HBM_BW
    collective = collective_bytes_per_chip / LINK_BW

The measurements are per rank (``analysis/hlo.py:measure_compiled`` counts
what one rank of the mesh computes, its local shards), so, as in the
reference, there is no division by the chip count here.

The production meshes are 16 x 16 and 2 x 16 x 16 chips. A DGX H100 host
holds eight H100s joined by NVLink, so a 16 x 16 mesh of H100s spans 32
hosts (64 for two pods), and a collective over either mesh axis leaves a
host. ``LINK_BW`` is therefore the per-GPU network figure, the conservative
counterpart of the reference's single-ICI-link figure.

Layer correction: the reference's XLA cost analysis counts a scanned
layer's body once, so its dry run compiles 1- and 2-unit variants and
extrapolates, ``m1 + (L - 1)(m2 - m1)``. The port's layers are a Python
loop and its dispatcher sees every one; ``launch/dryrun.py`` still records
the extrapolation as a cross-check of the full-depth count.
"""

from __future__ import annotations

import dataclasses

# --- NVIDIA H100 SXM constants (per chip) ---------------------------------
# Dense bf16 tensor-core peak (NVIDIA H100 data sheet, SXM5: 989 TFLOP/s;
# the data sheet's 1,979 is with 2:4 sparsity).
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
# HBM3 bandwidth (NVIDIA H100 data sheet, SXM5: 3.35 TB/s).
HBM_BW = 3.35e12  # B/s
# One 400 Gb/s NIC per GPU, as in a DGX H100 (8 ConnectX-7 for 8 GPUs): the
# rate a mesh that spans hosts gets per GPU. NVLink within a host gives
# 450 GB/s each way (900 GB/s in all, data sheet); it is not the bound of a
# 16 x 16 mesh, whose axes cross hosts.
LINK_BW = 50e9  # B/s
# HBM3 capacity (NVIDIA H100 data sheet, SXM5: 80 GB).
HBM_BYTES = 80e9  # bytes


@dataclasses.dataclass
class RooflineTerms:
    flops: float  # per-chip
    bytes_accessed: float  # per-chip HBM traffic proxy
    collective_bytes: float  # per-chip
    model_flops_global: float  # 6*N*D (train) or 2*N*D (inference)
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline-ideal step time = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / measured FLOPs (global): remat/padding/redundancy
        waste."""
        measured_global = self.flops * self.chips
        return self.model_flops_global / measured_global if measured_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the chips' peak that the ideal schedule achieves on
        *useful* model FLOPs: (MODEL_FLOPS / chips / peak) / t_bound."""
        if self.t_bound == 0:
            return 0.0
        t_model = self.model_flops_global / self.chips / PEAK_FLOPS_BF16
        return t_model / self.t_bound

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def extrapolate_layers(m1: dict, m2: dict, num_layers: int,
                       layers_per_unit: float = 1.0) -> dict:
    """m1/m2: measurements with 1 and 2 layer units; returns corrected
    totals for ``num_layers`` layers (num_layers/layers_per_unit units)."""
    units = num_layers / layers_per_unit

    def fix(a, b):
        delta = b - a
        return a + max(units - 1.0, 0.0) * delta

    out = {
        "flops": fix(m1["flops"], m2["flops"]),
        "bytes_accessed": fix(m1["bytes_accessed"], m2["bytes_accessed"]),
        "collective_total_bytes": fix(
            m1["collectives"]["total_bytes"], m2["collectives"]["total_bytes"]
        ),
    }
    ops = set(m1["collectives"]["bytes"]) | set(m2["collectives"]["bytes"])
    out["collective_bytes_by_op"] = {
        op: fix(
            m1["collectives"]["bytes"].get(op, 0),
            m2["collectives"]["bytes"].get(op, 0),
        )
        for op in ops
    }
    return out


def model_flops(cfg, shape, param_count: int, active_param_count: int) -> float:
    """MODEL_FLOPS for one step of this cell (global, all chips)."""
    n_active = active_param_count
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def analytic_attention_flops(cfg, shape) -> float:
    """Global forward attention FLOPs per step (QK^T + PV), for cells using
    the flash kernel: its body is a hand-written kernel that the dispatcher
    does not see into (on the card a ``ctypes`` launch, on ``meta`` tensors
    no op at all), so the roofline adds the exact analytic count.
    Causal masking halves the effective key length; sliding windows cap it.
    """
    B = shape.global_batch
    H = max(cfg.num_heads, 1)
    Dh = cfg.resolved_head_dim if cfg.num_heads else 0

    def attn(bq, sq, sk, causal=True, window=None):
        sk_eff = min(sk, window) if window else sk
        factor = 0.5 if (causal and window is None and sq == sk) else 1.0
        return 4.0 * bq * H * sq * sk_eff * Dh * factor

    if shape.kind == "decode":
        sq = 1
    else:
        sq = shape.seq_len

    if cfg.family == "audio":
        enc = cfg.enc_layers * attn(B, cfg.enc_frames, cfg.enc_frames, causal=False)
        sk = shape.seq_len
        dec_self = cfg.num_layers * attn(B, sq, sk)
        cross = cfg.num_layers * attn(B, sq, cfg.enc_frames, causal=False)
        if shape.kind == "decode":
            enc = 0.0  # encoder not run at decode
        return enc + dec_self + cross
    if cfg.family == "ssm":
        return 0.0
    if cfg.family == "hybrid":
        from repro_torch.models.transformer import hybrid_layer_types

        n_attn = hybrid_layer_types(cfg).count("attn")
        return n_attn * attn(B, sq, shape.seq_len, window=cfg.local_window)
    return cfg.num_layers * attn(B, sq, shape.seq_len, window=cfg.attn_window)


def roofline_from_measurements(
    corrected: dict, model_flops_global: float, chips: int
) -> RooflineTerms:
    return RooflineTerms(
        flops=corrected["flops"],
        bytes_accessed=corrected["bytes_accessed"],
        collective_bytes=corrected["collective_total_bytes"],
        model_flops_global=model_flops_global,
        chips=chips,
    )
