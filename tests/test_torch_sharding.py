"""The port's LM sharding (``repro_torch.models.sharding``, the sharded model
paths, ``launch/steps.py``'s shardings) on the CPU against the reference's.

(1) Specs without ranks: for all ten archs on abstract meshes 1 x 1, 2 x 2,
16 x 16 and 2 x 16 x 16, the port's parameter, decode-cache and batch specs
equal the reference's ``MeshRules`` on a ``jax.sharding.AbstractMesh`` of
the same shape, position for position, and so do the ``dropped`` lists;
and the reference's own guard cases (``tests/test_sharding.py``).

(2) One spawn of four gloo ranks on a (data 2, model 2) ``DeviceMesh``, in
float32 compute, reduced configs, numpy-seeded parameters: a sharded
prefill of every family (qwen2 with ``attn_impl="flash"``, so
``flash_sharded`` takes the kernel route, the plain version on the CPU;
mixtral under both MoE dispatches) and a train step of every family, and
four decode steps of qwen2, mixtral, recurrentgemma and mamba2 (the
hybrid's conv / lru and the ssm's conv / ssm states replaced each step),
each against the unsharded port; reruns bitwise; the
flash route on a divisible shape (the kernel), on queries that are not a
multiple of the block (chunked) and on planes whose data shards cut across
batch rows (the kernel on each rank's block of planes); and the c10d
kernels that stand in for DTensor's functional collectives on CUDA meshes,
held to the functional ones.

(3) The reference under a real 2 x 2 JAX mesh (four host devices, Auto
axes), in one subprocess, on the same parameters and inputs: the port's
sharded results held to it. The MoE ``shard_map`` route is held to the
reference's ``shard_map`` route.

Tolerances (chip_smoke.py's phase 9 float32 checks; the paths differ in the
order of their partial sums only):
- prefill logits within 1e-4 of the largest |logit|;
- the loss within 1e-5 relative;
- each gradient leaf within 1e-4 of its largest |g|, plus 1e-8 (the key
  biases' gradients are zero in exact arithmetic and read as rounding);
- parameters after one AdamW step from the same gradients within 1e-6 of a
  leaf's largest |x|;
- decode logits within 1e-4 of the largest |logit|, on a float32 cache in
  both packages (on the default bfloat16 cache a cached value whose float32
  inputs differ in the last bits rounds to the neighbouring bfloat16, which
  moved logits by up to 3.6e-3 here).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as TM
from repro_torch.models.base import tree_leaves
from repro_torch.models.sharding import AbstractMesh, MeshRules, NullRules, PartitionSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL, LOSS_RTOL, GRAD_TOL, OPT_TOL = 1e-4, 1e-5, (1e-4, 1e-8), 1e-6
MESHES = {"1x1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHAPES = (ShapeConfig("train_4k", "train", 4096, 256),
          ShapeConfig("prefill_32k", "prefill", 32768, 32),
          ShapeConfig("decode_32k", "decode", 32768, 128))
SPAWN = dict(backend="gloo", device="cpu", threads=1, timeout_s=60.0, wall_s=600.0)

# (label, arch, overrides) of the sharded runs; qwen2 and mixtral also train
# and decode
CASES = (("qwen2", "qwen2-1.5b", dict(attn_impl="flash")),
         ("smollm", "smollm-360m", {}),
         ("mixtral", "mixtral-8x7b", {}),
         ("mixtral_shard_map", "mixtral-8x7b", dict(moe_dispatch="shard_map")),
         ("llava", "llava-next-mistral-7b", {}),
         ("recurrentgemma", "recurrentgemma-9b", {}),
         ("mamba2", "mamba2-130m", {}),
         ("whisper", "whisper-base", dict(attn_impl="flash")))
TRAINED = tuple(c[0] for c in CASES)
DECODED = ("qwen2", "mixtral", "recurrentgemma", "mamba2")
PREFILL_B, PREFILL_S = 4, 128  # S a multiple of flash_sharded's 128 block
TRAIN_B, TRAIN_S = 4, 32
DECODE_STEPS, DECODE_T = 4, 8
# flash_sharded's route: (B, Sq, Sk) with qwen2's reduced heads (M 2, G 3)
ROUTES = {"divisible": (4, 128, 128), "short": (4, 96, 96), "batch_of_one": (1, 128, 128)}


def _cfg(arch, **kw):
    return dataclasses.replace(tcfg.reduced_config(tcfg.ARCHS[arch]), compute_dtype="float32",
                               **kw)


# ---------------------------------------------------------------------------
# (1) specs without ranks
# ---------------------------------------------------------------------------


def _ref_rules(mesh):
    from jax.sharding import AbstractMesh as JaxAbstractMesh

    from repro.models.sharding import MeshRules as JaxMeshRules

    return JaxMeshRules.for_mesh(JaxAbstractMesh(*MESHES[mesh]))


def _flat(tree, prefix=()):
    """(path, spec) pairs of a nested dict of specs, sorted by path."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _flat(v, prefix + (k,))
        else:
            out.append((prefix + (k,), tuple(v)))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(tcfg.ARCHS))
def test_specs_equal_the_reference(arch, mesh):
    """Parameter (max_target_positions 64), decode-cache and batch specs of
    the train, prefill and decode shapes, and the dropped lists."""
    from repro import configs as jcfg
    from repro.models import model as JM

    jcfg_, tcfg_ = jcfg.ARCHS[arch], tcfg.ARCHS[arch]
    ref, port = _ref_rules(mesh), MeshRules.for_mesh(AbstractMesh(*MESHES[mesh]))
    assert port.rules == ref.rules
    assert _flat(TM.param_partition_specs(tcfg_, port, 64)) == \
        _flat(JM.param_partition_specs(jcfg_, ref, 64))
    tcache = TM.init_cache(tcfg_, 8, 256, abstract=True)
    jcache = JM.init_cache(jcfg_, 8, 256, abstract=True)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in tcache.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}
    assert _flat(TM.cache_partition_specs(tcfg_, tcache, port)) == \
        _flat(JM.cache_partition_specs(jcfg_, jcache, ref))
    for shape in SHAPES:
        jshape = jcfg.ShapeConfig(*dataclasses.astuple(shape))
        assert _flat(TM.batch_partition_specs(tcfg_, shape, port)) == \
            _flat(JM.batch_partition_specs(jcfg_, jshape, ref))
        tin, jin = TM.input_specs(tcfg_, shape), JM.input_specs(jcfg_, jshape)
        assert list(tin) == list(jin)
    assert port.dropped == ref.dropped


def test_divisibility_guard():
    rules = MeshRules.for_mesh(AbstractMesh((1, 1), ("data", "model")))
    rules.rules["heads"] = "model"
    assert rules.spec((40, 64), ("heads", "head_dim")) == PartitionSpec("model", None)
    wide = MeshRules.for_mesh(AbstractMesh((16, 16), ("data", "model")))
    assert wide.spec((40, 64), ("heads", "head_dim")) == PartitionSpec(None, None)
    assert wide.dropped == [(("heads", "head_dim"), "heads", 40, 16, "indivisible")]


def test_prunes_missing_pod_axis():
    rules = MeshRules.for_mesh(AbstractMesh((1, 1), ("data", "model")))
    assert rules.rules["batch"] == ("data",)  # 'pod' pruned
    pod = MeshRules.for_mesh(AbstractMesh((2, 16, 16), ("pod", "data", "model")))
    assert pod.rules["batch"] == ("pod", "data")


def test_duplicate_axis_dropped():
    rules = MeshRules.for_mesh(AbstractMesh((1, 1), ("data", "model")))
    rules.rules["embed"] = "model"
    rules.rules["mlp"] = "model"
    assert rules.spec((64, 128), ("embed", "mlp")) == PartitionSpec("model", None)
    assert any(w == "duplicate" for *_, w in rules.dropped)


def test_shardings_need_a_device_mesh():
    """Without a DeviceMesh, sharding and constraint raise (no quiet
    replication); NullRules constrain nothing."""
    rules = MeshRules.for_mesh(AbstractMesh((2, 2), ("data", "model")))
    with pytest.raises(TypeError, match="DeviceMesh"):
        rules.sharding((4, 8), ("batch", None))
    with pytest.raises(TypeError, match="DeviceMesh"):
        rules.constraint(torch.zeros(4, 8), "batch", None)
    x = torch.zeros(4, 8)
    assert NullRules().constraint(x, "batch", None) is x
    assert NullRules().spec((4, 8), ("batch", None)) == PartitionSpec()


# ---------------------------------------------------------------------------
# the shared inputs: numpy-seeded parameters and batches
# ---------------------------------------------------------------------------


def _numpy_params(cfg, seed: int) -> dict:
    """{path: array} by each ParamSpec's init rule, from a numpy seed."""
    rs = np.random.default_rng(seed)
    out = {}
    for path, spec in tree_leaves(TM.model_specs(cfg, 64)):
        if spec.init in ("zeros", "ones"):
            a = (np.zeros if spec.init == "zeros" else np.ones)(spec.shape, np.float32)
        else:
            dims = [d for d, ax in zip(spec.shape, spec.axes) if ax != "layers"]
            fan = int(np.prod(dims[:-1])) if len(dims) > 1 else 1
            scale = {"embed": 0.02, "small": 0.006}.get(spec.init, 1.0 / max(fan ** 0.5, 1.0))
            a = (rs.standard_normal(spec.shape) * scale).astype(np.float32)
        out["/".join(path)] = a
    return out


def _numpy_batch(cfg, B: int, S: int, seed: int) -> dict:
    rs = np.random.default_rng(seed)
    toks = rs.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        return {"patch_embeds": (rs.standard_normal((B, cfg.num_patches, cfg.d_model)) * 0.1)
                .astype(np.float32), "tokens": toks[:, : S - cfg.num_patches]}
    if cfg.family == "audio":
        return {"frames": (rs.standard_normal((B, cfg.enc_frames, cfg.d_model)) * 0.1)
                .astype(np.float32), "tokens": toks}
    return {"tokens": toks}


def _inputs(tmp) -> str:
    """One npz of every case's parameters and batches; returns its path."""
    arrays = {}
    for i, (label, arch, kw) in enumerate(CASES):
        cfg = _cfg(arch, **kw)
        arrays.update({f"{label}/params/{k}": v for k, v in _numpy_params(cfg, 10 + i).items()})
        for what, (B, S) in (("prefill", (PREFILL_B, PREFILL_S)), ("train", (TRAIN_B, TRAIN_S))):
            arrays.update({f"{label}/{what}/{k}": v
                           for k, v in _numpy_batch(cfg, B, S, 50 + i).items()})
        rs = np.random.default_rng(90 + i)
        arrays[f"{label}/decode/tokens"] = rs.integers(
            0, cfg.vocab_size, (DECODE_STEPS, PREFILL_B, 1)).astype(np.int32)
    path = os.path.join(str(tmp), "inputs.npz")
    np.savez(path, **arrays)
    return path


def _group(npz, prefix: str) -> dict:
    """The nested dict under ``prefix`` of an npz of "a/b/c" keys."""
    out: dict = {}
    for key in npz.files:
        if key.startswith(prefix + "/"):
            node = out
            *heads, last = key[len(prefix) + 1:].split("/")
            for h in heads:
                node = node.setdefault(h, {})
            node[last] = npz[key]
    return out


# ---------------------------------------------------------------------------
# (2) the port on four gloo ranks
# ---------------------------------------------------------------------------


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict) else torch.as_tensor(v)
            for k, v in tree.items()}


def _whole(x) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    x = x.full_tensor() if isinstance(x, DTensor) else x
    return x.detach().float().numpy()


def _flat_np(tree) -> dict:
    return {"/".join(p): _whole(a) for p, a in tree_leaves(tree)}


def _local_bytes(tree) -> list:
    """Each leaf's local block, bit for bit (bitwise rerun checks)."""
    from torch.distributed.tensor import DTensor

    return [(a.to_local() if isinstance(a, DTensor) else a).detach().numpy().tobytes()
            for _, a in tree_leaves(tree)]


def _decode_runs(label, cfg, params, npz, rules, mesh) -> dict:
    """Four decode steps from a zero float32 cache placed by
    decode_shardings, the tokens given, sharded and unsharded."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf_lib

    toks = torch.as_tensor(npz[f"{label}/decode/tokens"])
    dshape = ShapeConfig("d", "decode", DECODE_T, PREFILL_B)
    cache0 = tf_lib.init_cache(cfg, PREFILL_B, DECODE_T, device="cpu", dtype=torch.float32)
    (dps, dcs, dts, _), _ = steps.decode_shardings(cfg, dshape, rules, mesh, cache0, 64)
    dcache, ddp = steps.place(cache0, dcs), steps.place(params, dps)
    ucache = tf_lib.init_cache(cfg, PREFILL_B, DECODE_T, device="cpu", dtype=torch.float32)
    dec, udec = [], []
    with torch.no_grad():
        for pos in range(DECODE_STEPS):
            lg, dcache = TM.decode_step(cfg, ddp, dcache, steps.place(toks[pos], dts), pos, rules)
            dec.append(_whole(lg))
            lg, ucache = TM.decode_step(cfg, params, ucache, toks[pos], pos)
            udec.append(lg.numpy())
    return {f"{label}/decode": np.stack(dec), f"{label}/decode_unsharded": np.stack(udec),
            f"{label}/decode_cache_placed": all(dcache[k].placements == dcs[k].placements
                                                for k in dcache)}


def _rank_runs(npz_path: str) -> dict:
    """Every sharded run of one rank; rank 0's whole values and every rank's
    bitwise and route checks."""
    import copy

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import steps
    from repro_torch.models import attention as attn
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    npz = np.load(npz_path)
    out = {"rank": dist.get_rank()}
    for label, arch, kw in CASES:
        cfg = _cfg(arch, **kw)
        params = _tensors(_group(npz, f"{label}/params"))
        rules = MeshRules.for_mesh(mesh)
        batch = _tensors(_group(npz, f"{label}/prefill"))
        shape = ShapeConfig("p", "prefill", PREFILL_S, PREFILL_B)
        (ps, bs), _ = steps.prefill_shardings(cfg, shape, rules, mesh, None, 64)
        dp, db = steps.place(params, ps), steps.place(batch, bs)
        prefill = steps.make_prefill_step(cfg, rules)
        calls = []
        real = attn.flash_attention
        attn.flash_attention = lambda *a, **k: calls.append(a[0].shape) or real(*a, **k)
        try:
            with torch.no_grad():
                logits, _ = prefill(dp, db)
                again, _ = prefill(dp, db)
        finally:
            attn.flash_attention = real
        with torch.no_grad():
            unsharded = TM.forward_prefill(cfg, params, batch)[0]
        out[f"{label}/prefill"] = _whole(logits)
        out[f"{label}/prefill_unsharded"] = _whole(unsharded)
        out[f"{label}/prefill_rerun_bitwise"] = logits.to_local().numpy().tobytes() == \
            again.to_local().numpy().tobytes()
        out[f"{label}/flash_calls"] = [tuple(s) for s in calls]
        if label in DECODED:
            out.update(_decode_runs(label, cfg, params, npz, rules, mesh))
        if label not in TRAINED:
            continue
        # a train step: loss and gradients, twice, and AdamW from the same
        # (unsharded) gradients
        tbatch = _tensors(_group(npz, f"{label}/train"))
        tshape = ShapeConfig("t", "train", TRAIN_S, TRAIN_B)
        (tps, tos, tbs), _ = steps.train_shardings(cfg, tshape, rules, mesh, 64)
        tp, tb = steps.place(params, tps), steps.place(tbatch, tbs)
        runs = [steps.loss_and_grads(cfg, tp, tb, rules) for _ in range(2)]
        loss0, _, grads0 = steps.loss_and_grads(cfg, params, tbatch)
        out[f"{label}/loss"] = float(_whole(runs[0][0]))
        out[f"{label}/loss_unsharded"] = float(loss0)
        out[f"{label}/grads"] = _flat_np(runs[0][2])
        out[f"{label}/grads_unsharded"] = _flat_np(grads0)
        out[f"{label}/train_rerun_bitwise"] = (
            _whole(runs[0][0]).tobytes() == _whole(runs[1][0]).tobytes()
            and _local_bytes(runs[0][2]) == _local_bytes(runs[1][2]))
        opt = AdamWConfig()
        pa = copy.deepcopy(params)
        adamw_update(opt, pa, grads0, adamw_init(pa))
        pb = steps.place(copy.deepcopy(params), tps)
        adamw_update(opt, pb, steps.place(grads0, tps), steps.place(adamw_init(params), tos))
        out[f"{label}/adamw_gap"] = max(
            float(np.abs(_whole(b) - _whole(a)).max() / max(np.abs(_whole(a)).max(), 1e-30))
            for (_, a), (_, b) in zip(tree_leaves(pa), tree_leaves(pb)))
    # flash_sharded's route on qwen2's reduced heads
    cfg = _cfg("qwen2-1.5b", attn_impl="flash")
    rules = MeshRules.for_mesh(mesh)
    routes = {}
    for name, (B, Sq, Sk) in ROUTES.items():
        M, G, Dh = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim
        rs = np.random.default_rng(7)
        q, k, v = (torch.as_tensor(rs.standard_normal(s).astype(np.float32))
                   for s in ((B, Sq, M, G, Dh), (B, Sk, M, Dh), (B, Sk, M, Dh)))
        from torch.distributed.tensor import DTensor, Replicate

        rep = lambda t: DTensor.from_local(t, mesh, (Replicate(), Replicate()))
        got = attn.flash_sharded(rep(q), rep(k), rep(v), cfg, rules, causal=True)
        want = attn.attend_chunked(q, k, v, cfg, causal=True, chunk=cfg.attn_chunk)
        routes[name] = (attn.flash_route(q.shape, k.shape, rules),
                        float(np.abs(_whole(got) - want.numpy()).max()))
    out["routes"] = routes
    # the production meshes need their 256 or 512 ranks
    raised = []
    for multi_pod in (False, True):
        try:
            mesh_lib.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        except RuntimeError as e:
            raised.append(str(e))
    out["production_mesh_raises"] = raised
    return out


def _rank_collectives(install: bool) -> dict:
    """DTensor redistributions through the functional collectives, with the
    c10d kernels that ``blocking_collectives`` installs on CUDA meshes
    installed here for the CPU, or not."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models.sharding import blocking_collectives

    if install:
        blocking_collectives("CPU")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    a = torch.as_tensor(np.random.default_rng(3).standard_normal((8, 12)).astype(np.float32))
    rep = DTensor.from_local(a, mesh, (Replicate(), Replicate()))
    part = DTensor.from_local(a / 4, mesh, (Partial(), Partial()))
    runs = {"gather": rep.redistribute(mesh, (Shard(0), Shard(1))).redistribute(
                mesh, (Replicate(), Replicate())),
            "reduce_scatter": part.redistribute(mesh, (Shard(0), Shard(1))),
            "all_to_all": rep.redistribute(mesh, (Shard(0), Shard(1))).redistribute(
                mesh, (Shard(1), Shard(0)))}
    return {k: v.to_local().numpy() for k, v in runs.items()}


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    return {install: mesh_lib.spawn(_rank_collectives, 4, init_dir=str(tmp / str(install)),
                                    args=(install,), **SPAWN)
            for install in (False, True)}


@pytest.mark.parametrize("kind", ["gather", "reduce_scatter", "all_to_all"])
def test_blocking_collectives_equal_the_functional_ones(collectives, kind):
    """The c10d kernels that stand in for DTensor's functional all-gather,
    reduce-scatter and all-to-all on CUDA meshes over gloo give every rank
    the blocks the functional ones give, bitwise (here on the CPU)."""
    for plain, blocking in zip(collectives[False], collectives[True]):
        assert plain[kind].shape == blocking[kind].shape
        assert plain[kind].tobytes() == blocking[kind].tobytes()


# ---------------------------------------------------------------------------
# (3) the reference under a real 2 x 2 JAX mesh
# ---------------------------------------------------------------------------

REFERENCE = textwrap.dedent('''
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from repro import configs as jcfg
    from repro.launch import steps as S
    from repro.models import attention as attn, model as JM, transformer as tf
    from repro.models.sharding import MeshRules

    npz_path, out_path, cases, trained, decoded, dims = sys.argv[1:7]
    cases, trained, decoded = json.loads(cases), json.loads(trained), json.loads(decoded)
    (PB, PS, TB, TS, STEPS, T) = json.loads(dims)
    npz = np.load(npz_path)
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)

    def group(prefix):
        out = {}
        for key in npz.files:
            if key.startswith(prefix + "/"):
                node = out
                *heads, last = key[len(prefix) + 1:].split("/")
                for h in heads:
                    node = node.setdefault(h, {})
                node[last] = jnp.asarray(npz[key])
        return out

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "/"))
            else:
                out[prefix + k] = np.asarray(v, np.float32)
        return out

    res = {}
    for label, arch, kw in cases:
        cfg = dataclasses.replace(jcfg.reduced_config(jcfg.ARCHS[arch]),
                                  compute_dtype="float32", **kw)
        rules = MeshRules.for_mesh(mesh)
        params, batch = group(label + "/params"), group(label + "/prefill")
        shape = jcfg.ShapeConfig("p", "prefill", PS, PB)
        (ps, bs), _ = S.prefill_shardings(cfg, shape, rules, mesh, None, 64)
        step = jax.jit(S.make_prefill_step(cfg, rules), in_shardings=(ps, bs))
        res[label + "/prefill"] = np.asarray(step(params, batch)[0], np.float32)
        if label in decoded:
            dshape = jcfg.ShapeConfig("d", "decode", T, PB)
            cache = tf.init_cache(cfg, PB, T, dtype=jnp.float32)
            (dps, dcs, dts, dpos), _ = S.decode_shardings(cfg, dshape, rules, mesh, cache, 64)
            dec = jax.jit(lambda p, c, t, pos: JM.decode_step(cfg, p, rules, c, t, pos),
                          in_shardings=(dps, dcs, dts, dpos))
            toks, logits = npz[label + "/decode/tokens"], []
            for pos in range(STEPS):
                lg, cache = dec(params, cache, jnp.asarray(toks[pos]), jnp.int32(pos))
                cache = jax.device_put(cache, dcs)  # decode_shardings' out_shardings
                logits.append(np.asarray(lg, np.float32))
            res[label + "/decode"] = np.stack(logits)
        if label not in trained:
            continue
        tbatch = group(label + "/train")
        tshape = jcfg.ShapeConfig("t", "train", TS, TB)
        (tps, _, tbs), _ = S.train_shardings(cfg, tshape, rules, mesh, 64)
        vg = jax.jit(jax.value_and_grad(lambda p, b: JM.forward_train(cfg, p, rules, b)[0]),
                     in_shardings=(tps, tbs))
        loss, grads = vg(params, tbatch)
        res[label + "/loss"] = float(loss)
        res.update({label + "/grads/" + k: v for k, v in flat(grads).items()})
    # flash_sharded's route: chunked where the reference calls attend_chunked
    cfg = dataclasses.replace(jcfg.reduced_config(jcfg.ARCHS["qwen2-1.5b"]),
                              compute_dtype="float32", attn_impl="flash")
    rules = MeshRules.for_mesh(mesh)
    routes = {}
    real = attn.attend_chunked
    for name, (B, Sq, Sk) in json.loads(sys.argv[7]).items():
        M, G, Dh = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim
        seen = []
        attn.attend_chunked = lambda *a, **k: seen.append(1) or real(*a, **k)
        q = jnp.zeros((B, Sq, M, G, Dh)); k = jnp.zeros((B, Sk, M, Dh))
        attn.flash_sharded(q, k, k, cfg, rules, causal=True)
        attn.attend_chunked = real
        routes[name] = "chunked" if seen else "kernel"
    res["routes"] = np.asarray(json.dumps(routes))
    np.savez(out_path, **res)
''')


def _reference_process(npz_path: str, tmp) -> tuple:
    out = os.path.join(str(tmp), "reference.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    dims = [PREFILL_B, PREFILL_S, TRAIN_B, TRAIN_S, DECODE_STEPS, DECODE_T]
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, npz_path, out, json.dumps(CASES),
         json.dumps(TRAINED), json.dumps(DECODED), json.dumps(dims), json.dumps(ROUTES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out


# ---------------------------------------------------------------------------
# fixtures and tests of (2) and (3)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides at once: the reference's subprocess, then the port's spawn."""
    tmp = tmp_path_factory.mktemp("sharding")
    npz_path = _inputs(tmp)
    proc, out = _reference_process(npz_path, tmp)
    try:
        ranks = mesh_lib.spawn(_rank_runs, 4, init_dir=str(tmp / "pg"), args=(npz_path,),
                               **SPAWN)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    ref = dict(np.load(out))
    ref["routes"] = json.loads(str(ref["routes"]))
    return ranks, ref


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_sharded_prefill(runs, label):
    """Every family's sharded prefill: within 1e-4 of the largest |logit|
    of the reference's sharded prefill and of the unsharded port's (the
    shard_map MoE against the reference's shard_map route only: its
    per-shard capacity drops other tokens than the global dispatch), and a
    rerun bitwise on every rank."""
    ranks, ref = runs
    got = ranks[0][f"{label}/prefill"]
    assert np.isfinite(got).all()
    assert _rel(got, ref[f"{label}/prefill"]) <= LOGIT_TOL
    if label != "mixtral_shard_map":
        assert _rel(got, ranks[0][f"{label}/prefill_unsharded"]) <= LOGIT_TOL
    assert all(r[f"{label}/prefill_rerun_bitwise"] for r in ranks)


def test_flash_sharded_kernel_route_per_data_shard(runs):
    """qwen2's and whisper's sharded prefills call the kernel wrapper once
    per layer on each rank, on the rank's half of the batch; no other case
    reaches it."""
    ranks, _ = runs
    qwen2, whisper = _cfg("qwen2-1.5b"), _cfg("whisper-base")
    for r in ranks:
        assert r["qwen2/flash_calls"] == [(PREFILL_B // 2, PREFILL_S, qwen2.num_kv_heads,
                                           qwen2.num_heads // qwen2.num_kv_heads,
                                           qwen2.resolved_head_dim)] * qwen2.num_layers * 2
        # whisper's decoder self-attention only (its encoder's 24 frames
        # are not a multiple of the block)
        assert len(r["whisper/flash_calls"]) == whisper.num_layers * 2
        assert all(not r[f"{c[0]}/flash_calls"] for c in CASES
                   if c[0] not in ("qwen2", "whisper"))


@pytest.mark.parametrize("label", TRAINED)
def test_sharded_train_step(runs, label):
    """Loss and every gradient leaf against the reference's sharded
    value_and_grad and the unsharded port (the shard_map MoE against the
    reference's alone, as its prefill); one sharded AdamW step from the
    same gradients against the unsharded one; the step again, bitwise."""
    ranks, ref = runs
    r = ranks[0]
    unsharded = label != "mixtral_shard_map"
    for want in (ref[f"{label}/loss"],) + ((r[f"{label}/loss_unsharded"],) if unsharded else ()):
        assert abs(r[f"{label}/loss"] - want) <= LOSS_RTOL * abs(want)
    rel, floor = GRAD_TOL
    for path, g in r[f"{label}/grads"].items():
        wants = [ref[f"{label}/grads/{path}"]]
        if unsharded:
            wants.append(r[f"{label}/grads_unsharded"][path])
        for want in wants:
            assert np.abs(g - want).max() <= rel * np.abs(want).max() + floor, path
    assert r[f"{label}/adamw_gap"] <= OPT_TOL
    assert all(x[f"{label}/train_rerun_bitwise"] for x in ranks)


@pytest.mark.parametrize("label", DECODED)
def test_sharded_decode(runs, label):
    """Four decode steps on the float32 cache placed by decode_shardings,
    which keeps its placements, against the reference's and the unsharded
    port's."""
    ranks, ref = runs
    got = ranks[0][f"{label}/decode"]
    assert got.shape == ref[f"{label}/decode"].shape and np.isfinite(got).all()
    assert _rel(got, ref[f"{label}/decode"]) <= LOGIT_TOL
    assert _rel(got, ranks[0][f"{label}/decode_unsharded"]) <= LOGIT_TOL
    assert all(r[f"{label}/decode_cache_placed"] for r in ranks)


def test_flash_route_equals_the_reference(runs):
    """The kernel route where the reference takes it, chunked where it falls
    back (queries not a multiple of the block; planes that do not divide the
    data axes), and either route equal to attend_chunked."""
    ranks, ref = runs
    want = {"divisible": "kernel", "short": "chunked", "batch_of_one": "kernel"}
    assert ref["routes"] == want
    for r in ranks:
        assert {k: v[0] for k, v in r["routes"].items()} == want
        assert all(v[1] <= 1e-5 for v in r["routes"].values()), r["routes"]


def test_production_mesh_raises_on_four_ranks(runs):
    ranks, _ = runs
    for r in ranks:
        assert len(r["production_mesh_raises"]) == 2
        assert "256 ranks, have 4" in r["production_mesh_raises"][0]
        assert "512 ranks, have 4" in r["production_mesh_raises"][1]
