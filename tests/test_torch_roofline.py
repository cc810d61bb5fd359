"""The port's roofline arithmetic and per-rank measurement
(``repro_torch.analysis.{roofline,hlo,report}``, the abstract views, the
shape helpers of ``repro_torch.configs``) against the reference's.

(1) Exact arithmetic on configs, for all ten archs and the four LM shapes:
``supports_shape``, ``get_shape``, ``list_archs``, ``param_count`` (total
and active), ``model_flops`` and ``analytic_attention_flops`` equal the
reference's.

(2) The abstract views at full size, leaf for leaf (shape and dtype):
``abstract_params`` (``models/model.py`` and ``models/base.py``),
``cache_entry_struct`` and ``abstract_opt_state`` against the reference's
``ShapeDtypeStruct`` trees; the port's are ``meta`` tensors.

(3) ``RooflineTerms``: with the port's H100 constants set to the reference's
TPU v5e values every property equals the reference's, and ``row()`` has its
keys; with its own constants each time is its term over the H100 figure.
``extrapolate_layers`` is exact.

(4) ``collective_bytes`` on a fake 2 x 2 world (torch's ``"fake"`` backend,
made in a fixture and destroyed after each test): an all-gather,
reduce-scatter and all-reduce of DTensor redistributions on ``meta``
tensors and a ``torch.distributed`` all-to-all of known shapes, held to the
reference's parser on an HLO text of the same shapes and group sizes (built
as ``tests/test_analysis.py`` builds one).

(5) ``measure_compiled`` pinned on tiny functions counted by hand, and its
keys equal to the reference's.

(6) The report tables: the same JSON records through both packages'
``dryrun_table``, ``roofline_table`` and ``compare`` print identical text.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jcfg
from repro.analysis import hlo as j_hlo
from repro.analysis import report as j_report
from repro.analysis import roofline as j_rf
from repro.launch import steps as j_steps
from repro.models import attention as j_attn
from repro.models import model as JM
from repro_torch import configs as tcfg
from repro_torch.analysis import hlo as t_hlo
from repro_torch.analysis import report as t_report
from repro_torch.analysis import roofline as t_rf
from repro_torch.launch import dryrun as t_dryrun
from repro_torch.launch import steps as t_steps
from repro_torch.models import attention as t_attn
from repro_torch.models import base as t_base
from repro_torch.models import model as TM
from repro_torch.models.base import tree_leaves

ARCHS = sorted(jcfg.ARCHS)
SHAPES = [s.name for s in jcfg.LM_SHAPES]


# ---------------------------------------------------------------------------
# (1) exact arithmetic on configs
# ---------------------------------------------------------------------------


def test_shape_helpers_and_arch_list():
    assert tcfg.list_archs() == jcfg.list_archs()
    for name in SHAPES:
        assert tcfg.get_shape(name) .__dict__ == jcfg.get_shape(name).__dict__
    for const in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert getattr(tcfg, const).__dict__ == getattr(jcfg, const).__dict__
    with pytest.raises(KeyError):
        tcfg.get_shape("train_8k")


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_arithmetic_equals_the_reference(arch):
    tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
    n, na = TM.param_count(tc), TM.param_count(tc, active_only=True)
    assert (n, na) == (JM.param_count(jc), JM.param_count(jc, active_only=True))
    for name in SHAPES:
        ts, js = tcfg.get_shape(name), jcfg.get_shape(name)
        assert tcfg.supports_shape(tc, ts) == jcfg.supports_shape(jc, js)
        assert t_rf.model_flops(tc, ts, n, na) == j_rf.model_flops(jc, js, n, na)
        assert t_rf.analytic_attention_flops(tc, ts) == j_rf.analytic_attention_flops(jc, js)


# ---------------------------------------------------------------------------
# (2) the abstract views, leaf for leaf
# ---------------------------------------------------------------------------


def _jax_leaves(tree) -> dict:
    return {tuple(str(getattr(k, "key", k)) for k in path): (tuple(v.shape), str(v.dtype))
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _torch_leaves(tree) -> dict:
    out = {}
    for path, v in tree_leaves(tree):
        assert v.device.type == "meta", path
        out[path] = (tuple(v.shape), str(v.dtype).removeprefix("torch."))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_views_match_leaf_for_leaf(arch):
    tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
    mtp = 4096 + 8
    t_params, j_params = TM.abstract_params(tc, mtp), JM.abstract_params(jc, mtp)
    assert _torch_leaves(t_params) == _jax_leaves(j_params)
    assert _torch_leaves(t_base.abstract_params(TM.model_specs(tc))) == \
        _jax_leaves(JM.abstract_params(jc))
    assert _torch_leaves(t_steps.abstract_opt_state(t_params)) == \
        _jax_leaves(j_steps.abstract_opt_state(j_params))
    if tc.num_heads:
        assert _torch_leaves(t_attn.cache_entry_struct(tc, 8, 1024)) == \
            _jax_leaves(j_attn.cache_entry_struct(jc, 8, 1024))
        assert _torch_leaves(t_attn.cache_entry_struct(tc, 2, 64, torch.float32)) == \
            _jax_leaves(j_attn.cache_entry_struct(jc, 2, 64, np.float32))


# ---------------------------------------------------------------------------
# (3) the roofline formulas
# ---------------------------------------------------------------------------

_TERMS = (  # (flops, bytes, collective bytes, model flops, chips)
    (3.8e14, 2.1e12, 4.0e9, 3.3e15, 256),
    (1.0e12, 1.0e9, 9.0e10, 5.0e14, 512),
    (2.0e10, 6.0e11, 0.0, 1.0e12, 256),
    (0.0, 0.0, 0.0, 1.0e12, 16),
)
_CONSTANTS = ("PEAK_FLOPS_BF16", "HBM_BW", "LINK_BW")


@pytest.mark.parametrize("inputs", _TERMS)
def test_roofline_terms_equal_the_reference_with_its_constants(inputs, monkeypatch):
    for name in _CONSTANTS:
        monkeypatch.setattr(t_rf, name, getattr(j_rf, name))
    t, j = t_rf.RooflineTerms(*inputs), j_rf.RooflineTerms(*inputs)
    for prop in ("t_compute", "t_memory", "t_collective", "bottleneck", "t_bound",
                 "useful_flops_fraction", "roofline_fraction"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.row() == j.row()


def test_roofline_terms_use_h100_constants():
    assert (t_rf.PEAK_FLOPS_BF16, t_rf.HBM_BW, t_rf.LINK_BW, t_rf.HBM_BYTES) == \
        (989e12, 3.35e12, 50e9, 80e9)
    t = t_rf.RooflineTerms(*_TERMS[0])
    assert (t.t_compute, t.t_memory, t.t_collective) == \
        (3.8e14 / 989e12, 2.1e12 / 3.35e12, 4.0e9 / 50e9)
    assert list(t.row()) == list(j_rf.RooflineTerms(*_TERMS[0]).row())
    corrected = {"flops": 3.8e14, "bytes_accessed": 2.1e12, "collective_total_bytes": 4.0e9}
    assert t_rf.roofline_from_measurements(corrected, 3.3e15, 256) == t


def _meas(seed):
    rng = np.random.default_rng(seed)
    ops = ("all-gather", "all-reduce", "reduce-scatter")[: 1 + seed % 3]
    b = {op: int(rng.integers(0, 2**30)) for op in ops}
    return {"flops": float(rng.integers(0, 2**40)),
            "bytes_accessed": float(rng.integers(0, 2**36)),
            "collectives": {"bytes": b, "total_bytes": sum(b.values())}}


@pytest.mark.parametrize("layers,per_unit", [(28, 1), (38, 3), (1, 1), (48, 1.0)])
def test_extrapolate_layers_is_exact(layers, per_unit):
    m1, m2 = _meas(layers), _meas(layers + 1)
    assert t_rf.extrapolate_layers(m1, m2, layers, per_unit) == \
        j_rf.extrapolate_layers(m1, m2, layers, per_unit)


# ---------------------------------------------------------------------------
# (4) collective bytes on a fake 2 x 2 world
# ---------------------------------------------------------------------------


@pytest.fixture
def mesh22():
    """A (data 2, model 2) cpu DeviceMesh of a fake four-rank world, this
    process rank 0; the world is destroyed after the test."""
    from torch.distributed.device_mesh import init_device_mesh

    assert not dist.is_initialized()
    with t_dryrun.fake_world(4):
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    assert not dist.is_initialized()


_HLO = """
HloModule m
ENTRY %main {
  %x = f32[128,256]{1,0} parameter(0)
  %ag = f32[256,256]{1,0} all-gather(%x), replica_groups=[2,2]<=[4], dimensions={0}
  %rs = f32[128,256]{1,0} reduce-scatter(%y), replica_groups=[2,2]<=[4], dimensions={0}
  %ar = f32[256,256]{1,0} all-reduce(%y), replica_groups=[2,2]<=[4], to_apply=%add
  %a2a = s32[64,8]{1,0} all-to-all(%z), replica_groups={{0,1,2,3}}
}
"""


def test_collective_bytes_match_the_reference_parser(mesh22):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def fn():
        x = DTensor.from_local(torch.empty(128, 256, device="meta"), mesh22,
                               (Replicate(), Shard(0)), run_check=False)
        x.redistribute(mesh22, (Replicate(), Replicate()))  # all-gather over model
        y = DTensor.from_local(torch.empty(256, 256, device="meta"), mesh22,
                               (Replicate(), Partial()), run_check=False)
        y.redistribute(mesh22, (Replicate(), Shard(0)))  # reduce-scatter over model
        y.redistribute(mesh22, (Replicate(), Replicate()))  # all-reduce over model
        out = torch.empty(64, 8, dtype=torch.int32)
        dist.all_to_all_single(out, torch.zeros(64, 8, dtype=torch.int32))  # the world

    got = t_hlo.collective_bytes(fn)
    want = j_hlo.collective_bytes(_HLO)
    assert got == want
    assert want["bytes"] == {"all-gather": 128 * 256 * 4, "reduce-scatter": 256 * 256 * 4,
                             "all-reduce": 256 * 256 * 4, "all-to-all": 64 * 8 * 4}


def test_matmul_on_the_mesh_is_counted_per_rank(mesh22):
    """A (64, 128) x (128, 256) product with the rows split over data and
    the contraction over model: each rank multiplies its (32, 64) block by
    its (64, 256) block and leaves a partial sum; reducing it is one
    all-reduce of the (32, 256) block over model."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    a = DTensor.from_local(torch.empty(32, 64, device="meta"), mesh22,
                           (Shard(0), Shard(1)), run_check=False)
    b = DTensor.from_local(torch.empty(64, 256, device="meta"), mesh22,
                           (Replicate(), Shard(0)), run_check=False)
    m = t_hlo.measure_compiled(lambda a, b: (a @ b).redistribute(
        mesh22, (Shard(0), Replicate())), a, b)
    assert m["flops"] == 2 * 32 * 64 * 256  # the global product / 4 ranks
    assert m["collectives"] == {"bytes": {"all-reduce": 32 * 256 * 4},
                                "count": {"all-reduce": 1}, "total_bytes": 32 * 256 * 4}
    assert m["memory"]["argument_bytes"] == (32 * 64 + 64 * 256) * 4
    assert m["memory"]["output_bytes"] == 32 * 256 * 4


# ---------------------------------------------------------------------------
# (5) measure_compiled by hand
# ---------------------------------------------------------------------------


def test_measure_compiled_counts_a_tiny_function():
    """y = exp(a @ b); s = y.sum() on (8, 16) x (16, 32) float32: one matmul
    of 2·8·16·32 flops; bytes in and out of mm (512 + 2048 in, 1024 out),
    exp (1024 in, 1024 out) and sum (1024 in, 4 out); 256 exp outputs; the
    live tensors peak with the product and its exp (2 x 1024 bytes)."""
    a, b = torch.ones(8, 16), torch.ones(16, 32)
    m = t_hlo.measure_compiled(lambda a, b: torch.exp(a @ b).sum(), a, b)
    assert m["flops"] == 2 * 8 * 16 * 32
    assert m["bytes_accessed"] == (512 + 2048 + 1024) + (1024 + 1024) + (1024 + 4)
    assert m["transcendentals"] == 256
    assert m["memory"] == {"argument_bytes": 512 + 2048, "output_bytes": 4,
                           "temp_bytes": 2048, "generated_code_bytes": 0}
    assert m["collectives"] == {"bytes": {}, "count": {}, "total_bytes": 0}
    assert set(m) == {"flops", "bytes_accessed", "transcendentals", "memory", "collectives"}


def test_measure_compiled_frees_and_skips_views():
    """Views and in-place ops move no new storage: t.view, t.t() and
    t.add_ count no temp bytes; a freed intermediate leaves the peak where
    it was."""
    x = torch.ones(64, 64, device="meta")

    def fn(x):
        y = x * 2  # 16 KiB made
        y.add_(1)  # in place: no new storage
        z = y.t().reshape(-1)  # a copy: the transpose is not contiguous
        del y
        return z.view(64, 64)

    m = t_hlo.measure_compiled(fn, x)
    assert m["memory"]["temp_bytes"] == 2 * 64 * 64 * 4
    assert m["flops"] == 0 and m["transcendentals"] == 0


# ---------------------------------------------------------------------------
# (6) the report tables
# ---------------------------------------------------------------------------


def _record(arch, shape, mesh, seed, **extra):
    rng = np.random.default_rng(seed)
    row = j_rf.RooflineTerms(*(float(rng.integers(1, 2**40)) for _ in range(4)), 256).row()
    return {"arch": arch, "shape": shape, "mesh": mesh, "compile_s": round(rng.random() * 9, 2),
            "scanned": {"memory": {"temp_bytes": int(rng.integers(0, 2**34))}},
            "roofline": row, **extra}


def test_report_tables_print_the_reference_text(tmp_path, capsys):
    cells = [("qwen2-1.5b", "prefill_32k"), ("qwen2-1.5b", "long_500k"),
             ("mixtral-8x7b", "train_4k"), ("mamba2-130m", "decode_32k")]
    for i, (arch, shape) in enumerate(cells):
        for mesh in ("16x16", "2x16x16"):
            rec = _record(arch, shape, mesh, 2 * i + len(mesh))
            if shape == "long_500k":
                rec = {"arch": arch, "shape": shape, "mesh": mesh, "skipped": "why"}
            if arch == "mixtral-8x7b" and mesh == "2x16x16":
                rec = {"arch": arch, "shape": shape, "mesh": mesh, "error": "RuntimeError()"}
            with open(tmp_path / f"{arch}_{shape}_{mesh}.json", "w") as f:
                json.dump(rec, f)
    with open(tmp_path / "qwen2-1.5b_prefill_32k_16x16_flash.json", "w") as f:
        json.dump(_record("qwen2-1.5b", "prefill_32k", "16x16", 99), f)
    with open(tmp_path / "qwen2-1.5b_prefill_32k_16x16_opt.json", "w") as f:
        json.dump({"arch": "qwen2-1.5b", "error": "x"}, f)
    d = str(tmp_path)
    opts = [("flash", "qwen2-1.5b_prefill_32k_16x16_flash"),
            ("opt", "qwen2-1.5b_prefill_32k_16x16_opt"), ("missing", "nope")]
    for render in (lambda m: m.dryrun_table(d), lambda m: m.roofline_table(d),
                   lambda m: m.roofline_table(d, "_2x16x16"),
                   lambda m: m.compare(d, "qwen2-1.5b_prefill_32k_16x16", opts)):
        render(j_report)
        want = capsys.readouterr().out
        render(t_report)
        got = capsys.readouterr().out
        assert got == want and want.count("\n") > 3
    for b in (0, 2**20, 3 * 2**28, 2**28 + 1, 5 * 2**30):
        assert t_report.fmt_bytes(b) == j_report.fmt_bytes(b)
    assert [k for k, _ in t_report.load(d, "*_16x16.json")] == \
        [k for k, _ in j_report.load(d, "*_16x16.json")]
    assert t_report.main(["--dir", d, "--section", "roofline"]) == 0
    assert "| qwen2-1.5b | prefill_32k |" in capsys.readouterr().out
    assert math.isfinite(t_rf.RooflineTerms(1, 1, 1, 1, 1).roofline_fraction)
