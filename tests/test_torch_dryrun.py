"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: cells of
reduced configs (``reduced_config``) on small fake worlds, the epidemic dry
run on twin-2k, and the CLI.

Every fake world is made by ``compile_cell`` / ``run_epidemic_dryrun`` /
``fake_world`` inside the test and destroyed before it returns; each test
checks that no process group is left.

(1) A dense cell (qwen2-1.5b reduced, a train step of 4 x 64 tokens on a
(data 2, model 2) mesh, not quick): the 1- and 2-layer runs extrapolate
exactly to the full-depth count, ``corrected["flops"] ==
scanned["flops"]``, and the record has the reference's keys. (2) A MoE
(mixtral-8x7b) and a hybrid (recurrentgemma-9b) cell, prefill and decode:
the runs complete and the roofline row is finite. (3) A flash cell
(qwen2-1.5b, ``attn_impl=flash``, a 4 x 128 prefill): the kernel's meta
route counts nothing and the record adds exactly the reference's
``analytic_attention_flops / chips``. (4) The ``dropped_shardings``
strings of a (data 2, model 4) mesh equal the reference's
``MeshRules.dropped`` after its shardings and an ``eval_shape`` trace of the
same step on an ``AbstractMesh`` of that shape. (5) ``run_epidemic_dryrun``
on twin-2k (2,000 people) over a fake 4-worker world: the day runs, its
collectives are the topology's schedule (2 all-to-all, 1 all-gather, 1
all-reduce) with the counters' bytes. (6) The CLI writes the reference's
artifact names and records a failed cell as ``error``. (7) whisper-base's
encoder self-attention, forward and backward, on fake 3-D worlds, the
op of the 2 x 16 x 16 train_4k cell whose backward viewed a
non-contiguous gradient (the whole cell takes minutes).
"""

import dataclasses
import json
import math
import os

import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro import configs as jcfg
from repro.analysis import roofline as j_rf
from repro.launch import steps as j_steps
from repro.models import model as JM
from repro_torch import configs as tcfg
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import steps as t_steps
from repro_torch.models import encdec
from repro_torch.models import model as TM
from repro_torch.models import sharding as t_shard
from repro_torch.models.transformer import layer_list

MESH = (2, 2)
TRAIN = ShapeConfig("train_s", "train", 64, 4)
PREFILL = ShapeConfig("prefill_s", "prefill", 128, 4)
DECODE = ShapeConfig("decode_s", "decode", 64, 4)
# the reference's record keys (src/repro/launch/dryrun.py:compile_cell)
KEYS = {"arch", "shape", "mesh", "kind", "chips", "param_count", "active_param_count",
        "lower_s", "compile_s", "scanned", "dropped_shardings", "m1", "m2", "corrected",
        "model_flops_global", "roofline"}
MEAS_KEYS = {"flops", "bytes_accessed", "transcendentals", "memory", "collectives"}


@pytest.fixture(autouse=True)
def _no_world_left():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    assert not dist.is_initialized()
    yield
    torch.set_num_threads(n)
    assert not dist.is_initialized(), "a fake world outlived its test"


def _cfg(arch, **kw):
    return dataclasses.replace(tcfg.reduced_config(tcfg.ARCHS[arch]), **kw)


def _cell(arch, shape, quick=False, mesh=MESH, **kw):
    return dryrun.compile_cell(arch, shape, False, quick=quick, cfg=_cfg(arch, **kw),
                               mesh_shape=mesh)


def test_dense_cell_extrapolates_exactly_to_full_depth():
    cfg = _cfg("qwen2-1.5b")
    rec = _cell("qwen2-1.5b", TRAIN)
    assert set(rec) == KEYS
    assert (rec["mesh"], rec["chips"], rec["kind"]) == ("2x2", 4, "train")
    for m in ("scanned", "m1", "m2"):
        assert set(rec[m]) == MEAS_KEYS
    assert cfg.num_layers == 4 and rec["m2"]["flops"] > rec["m1"]["flops"] > 0
    assert rec["corrected"]["flops"] == rec["scanned"]["flops"]
    assert rec["corrected"]["bytes_accessed"] == rec["scanned"]["bytes_accessed"]
    assert rec["model_flops_global"] == j_rf.model_flops(
        jcfg.reduced_config(jcfg.ARCHS["qwen2-1.5b"]), TRAIN, rec["param_count"],
        rec["active_param_count"])
    # the train step's gradients are reduced over the data axis
    assert rec["scanned"]["collectives"]["total_bytes"] > 0
    assert rec["scanned"]["memory"]["temp_bytes"] > 0
    assert set(rec["roofline"]) == set(j_rf.RooflineTerms(1, 1, 1, 1, 1).row())


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "recurrentgemma-9b"])
@pytest.mark.parametrize("shape", [PREFILL, DECODE], ids=lambda s: s.kind)
def test_moe_and_hybrid_cells_run(arch, shape):
    rec = _cell(arch, shape, quick=shape.kind == "decode")
    assert "error" not in rec and rec["scanned"]["flops"] > 0
    assert rec["chips"] == 4 and set(rec["scanned"]) == MEAS_KEYS
    assert all(math.isfinite(v) for v in rec["roofline"].values() if not isinstance(v, str))
    if shape.kind == "prefill":  # the 1-/2-unit runs (hybrid: a unit is the pattern)
        assert rec["m2"]["flops"] > rec["m1"]["flops"]


def test_flash_cell_adds_the_reference_analytic_count():
    rec = _cell("qwen2-1.5b", PREFILL, attn_impl="flash")
    chunked = _cell("qwen2-1.5b", PREFILL, quick=True, attn_impl="chunked")
    jc = dataclasses.replace(jcfg.reduced_config(jcfg.ARCHS["qwen2-1.5b"]), attn_impl="flash")
    add = j_rf.analytic_attention_flops(jc, PREFILL) / 4
    assert rec["flash_analytic_flops_per_chip"] == add > 0
    assert rec["corrected"]["flops"] == rec["scanned"]["flops"] + add
    # the kernel's meta route counts nothing: the flash step's matmuls are
    # the chunked step's without its attention products
    assert rec["scanned"]["flops"] < chunked["scanned"]["flops"]


def _ref_dropped(arch, shape, mesh_shape):
    from jax.sharding import AbstractMesh

    from repro.models.sharding import MeshRules as JRules

    jc = jcfg.reduced_config(jcfg.ARCHS[arch])
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    rules = JRules.for_mesh(mesh)
    mtp = shape.seq_len + 8
    params, batch = JM.abstract_params(jc, mtp), JM.input_specs(jc, shape)
    if shape.kind == "train":
        j_steps.train_shardings(jc, shape, rules, mesh, mtp)
        loss = lambda p, b: JM.forward_train(jc, p, rules, b)[0]
        jax.eval_shape(jax.value_and_grad(loss), params, batch)
    else:
        j_steps.prefill_shardings(jc, shape, rules, mesh, None, mtp)
        jax.eval_shape(lambda p, b: JM.forward_prefill(jc, p, rules, b), params, batch)
    return [f"{ax}:{dim}%{size} {why}" for (axes, ax, dim, size, why) in rules.dropped]


@pytest.mark.parametrize("shape", [PREFILL, TRAIN], ids=lambda s: s.kind)
def test_dropped_shardings_equal_the_reference(shape):
    """smollm's reduced 6 heads over 2 kv heads do not divide a model axis
    of 4: the guard replicates them, in the specs and in the step's
    constraints."""
    rec = _cell("smollm-360m", shape, quick=True, mesh=(2, 4))
    want = _ref_dropped("smollm-360m", shape, (2, 4))
    assert want and rec["dropped_shardings"] == want


# (mesh, batch, frames, d_model, heads): the production multi-pod world at
# whisper-base's published widths (the train_4k cell's placements and local
# shapes), and a small world with the same unevenness: the local batch does
# not split over the model axis, nor do the frames or the heads
ENCODER_WORLDS = {"2x16x16": ((2, 16, 16), 256, 1500, 512, 8),
                  "2x2x4": ((2, 2, 4), 8, 6, 64, 2)}


@pytest.mark.parametrize("world", sorted(ENCODER_WORLDS))
def test_encoder_attention_backward_on_a_3d_world(world):
    """``encdec._mha`` of an encoder layer, forward and backward, on ``meta``
    DTensors placed by the train step's shardings, with the output's
    gradient placed as the layer's backward gives it (the batch split over
    pod and data, a partial sum over model). The heads do not divide the
    model axis, so the value projection's ``split_dim`` replicates it; that
    redistribution's backward moved the gradient's model shard from the
    frames, split unevenly, to the features (an all-to-all that pads, then
    narrows), and the projection's matmul viewed the non-contiguous block
    (on 2 x 16 x 16: (8, 1500, 32), strides (48128, 32, 1), to (12000, 32))."""
    mesh_shape, batch, frames, d_model, heads = ENCODER_WORLDS[world]
    cfg = dataclasses.replace(tcfg.get_config("whisper-base"), enc_layers=1, enc_frames=frames,
                              d_model=d_model, num_heads=heads, num_kv_heads=heads,
                              head_dim=d_model // heads)
    shape = ShapeConfig("train_s", "train", 16, batch)
    with dryrun.fake_world(math.prod(mesh_shape)):
        mesh = dryrun._mesh(True, mesh_shape)
        rules = t_shard.MeshRules.for_mesh(mesh)
        p_s, _, b_s = t_steps.train_shardings(cfg, shape, rules, mesh, 24)[0]
        layers = t_steps.place(TM.abstract_params(cfg, 24)["enc_layers"], p_s["enc_layers"])
        x = t_steps.place(TM.input_specs(cfg, shape)["frames"], b_s["frames"])
        leaves = {k: v.detach().requires_grad_() for k, v in layers.items()}
        x.requires_grad_()
        with torch.enable_grad(), t_shard.replicate_plain():
            layer = layer_list(TM.cast_params(cfg, leaves))[0]
            out = encdec._mha(x, x, layer, cfg, train=True, rules=rules)
            data = mesh.size(0) * mesh.size(1)
            g_out = DTensor.from_local(
                torch.empty((batch // data, frames, d_model), dtype=out.dtype, device="meta"),
                mesh, (Shard(0), Shard(0), Partial()), shape=out.shape, stride=out.stride(),
                run_check=False)
            grads = torch.autograd.grad(out, [x, *leaves.values()], g_out, allow_unused=True)
        assert (x.to_local().shape, tuple(x.placements)) == (
            (batch // data, frames, d_model), (Shard(0), Shard(0), Replicate()))
        got = dict(zip(["frames", *leaves], grads))
        assert got["frames"].shape == x.shape
        for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"):
            assert got[k].shape == leaves[k].shape, k
        # the guard replicated the heads: split_dim's redistribution
        assert any(ax == "heads" and why == "indivisible"
                   for (_, ax, _, _, why) in rules.dropped)


def test_contiguous_local_copies_only_a_non_contiguous_block():
    """The block DTensor's all-to-all leaves after a padded shard (a narrow
    of (8, 1504, 32)) is copied; ``DTensor.contiguous`` reads the global
    strides and would not copy it. A contiguous block is returned as it
    is."""
    with dryrun.fake_world(16):
        mesh = dryrun._mesh(False, (1, 16))
        placed = (Replicate(), Shard(2))
        block = torch.empty(8, 1504, 32, device="meta")[:, :1500]
        x = DTensor.from_local(block, mesh, placed, shape=(8, 1500, 512),
                               stride=(768000, 512, 1), run_check=False)
        assert x.is_contiguous() and x.contiguous().to_local().stride() == (48128, 32, 1)
        y = t_shard.contiguous_local(x)
        assert y.to_local().is_contiguous() and y.to_local().shape == (8, 1500, 32)
        assert (y.shape, y.stride(), tuple(y.placements)) == (x.shape, x.stride(), placed)
        assert t_shard.contiguous_local(y) is y


def test_skipped_cell_builds_no_world():
    rec = dryrun.compile_cell("qwen2-1.5b", "long_500k", True, quick=True)
    assert rec == {"arch": "qwen2-1.5b", "shape": "long_500k", "mesh": "2x16x16",
                   "kind": "decode", "skipped": jcfg.supports_shape(
                       jcfg.get_config("qwen2-1.5b"), jcfg.LONG_500K)[1]}


def test_epidemic_dryrun_twin_2k_on_four_fake_workers():
    rec = dryrun.run_epidemic_dryrun("twin-2k", False, workers=4)
    assert rec["workers"] == 4 and rec["pop"]["people"] == 2000
    assert rec["day"].startswith("run")
    coll = rec["measured"]["collectives"]
    assert coll["count"] == {"all-to-all": 2, "all-gather": 1, "all-reduce": 1}
    assert rec["topology"]["counts"] == {"all_to_all": 2, "all_gather": 1, "all_reduce": 1}
    assert {k.replace("-", "_"): v for k, v in coll["bytes"].items()} == \
        rec["topology"]["bytes_sent"]
    assert min(rec["bytes"].values()) > 0 and rec["build_s"] >= 0 and rec["day_s"] > 0


def test_cli_writes_the_reference_artifacts(tmp_path, monkeypatch, capsys):
    reduced = _cfg("qwen2-1.5b")
    monkeypatch.setitem(tcfg.ARCHS, "qwen2-1.5b", reduced)  # get_config reads ARCHS
    monkeypatch.setattr(dryrun, "_mesh", lambda mp, shape: _small_mesh())
    monkeypatch.setattr(dryrun, "mesh_num_devices", lambda m: 4)
    monkeypatch.setattr(dryrun, "get_shape", lambda name: PREFILL)
    rc = dryrun.main(["--arch", "qwen2-1.5b", "--shape", "prefill_32k", "--quick",
                      "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "[ok]   qwen2-1.5b_prefill_32k_16x16:" in out
    rec = json.load(open(tmp_path / "qwen2-1.5b_prefill_32k_16x16.json"))
    assert rec["cfg_overrides"] == {} and rec["scanned"]["flops"] > 0
    # a failed cell is recorded as an error, and the exit code says so
    rc = dryrun.main(["--arch", "qwen2-1.5b", "--shape", "prefill_32k", "--quick",
                      "--out", str(tmp_path), "--set", "no_such_field=1", "--tag", "bad"])
    assert rc == 1 and "[FAIL] qwen2-1.5b_prefill_32k_16x16_bad" in capsys.readouterr().out
    bad = json.load(open(tmp_path / "qwen2-1.5b_prefill_32k_16x16_bad.json"))
    assert "no_such_field" in bad["error"] and "traceback" in bad
    assert sorted(os.listdir(tmp_path)) == ["qwen2-1.5b_prefill_32k_16x16.json",
                                            "qwen2-1.5b_prefill_32k_16x16_bad.json"]


def _small_mesh():
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
