"""The port's dense language-model serving path (``repro_torch.models``,
``repro_torch.launch.serve``) on the CPU against the reference's.

Inputs are numpy draws from a seed; parameters are the reference's
(``jax.random``), carried across with ``params_from_numpy``. The reference
reaches its Pallas flash kernel only under a mesh, so its prefills run
under a 1x1 ``MeshRules`` (interpret mode on the CPU).

Tolerances, all in float32 compute:
- layers and attention: atol 1e-5 (the same arithmetic in another
  summation order; values of order 1);
- prefill logits and cache: atol 1e-5 (measured: ~1e-6 after four layers);
- decode logits: atol 2e-3. The decode cache is bfloat16 in both packages,
  and a cached key or value whose float32 inputs differ in the last bits can
  round to the neighbouring bfloat16 (2^-8 relative), which moves a logit by
  up to ~2e-4 here (measured); the bound leaves a factor of ten;
- the serving replay against the prefill: atol 1e-2. The prefill attends
  over float32 keys and values, the replay over the bfloat16 cache, so every
  cached value carries up to 2^-9 relative rounding, through four layers
  (measured: ~2e-3 on logits of magnitude ~0.5).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as jcfg
from repro.data.tokens import TokenPipeline as JaxPipeline
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models.sharding import MeshRules
from repro_torch import configs as tcfg
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.flash_attention import kernel as t_kernel
from repro_torch.launch import serve as t_serve
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models.base import params_from_numpy

ATOL = 1e-5
DECODE_ATOL = 2e-3
REPLAY_ATOL = 1e-2
SLICE_ARCHS = ("qwen2-1.5b", "qwen3-14b")
B, S = 2, 128


def _f32(seed, *shapes):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def _cfgs(name, **kw):
    """The reduced config of ``name`` in both packages, float32 compute."""
    kw = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(jcfg.reduced_config(jcfg.ARCHS[name]), **kw),
            dataclasses.replace(tcfg.reduced_config(tcfg.ARCHS[name]), **kw))


# --------------------------------------------------------------------------
# configs, data, parameters
# --------------------------------------------------------------------------


def test_archs_and_reduced_configs_equal_reference():
    assert list(tcfg.ARCHS) == list(jcfg.ARCHS)
    for name in jcfg.ARCHS:
        assert dataclasses.asdict(tcfg.get_config(name)) == \
            dataclasses.asdict(jcfg.get_config(name))
        assert dataclasses.asdict(tcfg.reduced_config(tcfg.ARCHS[name])) == \
            dataclasses.asdict(jcfg.reduced_config(jcfg.ARCHS[name]))
    assert [f.name for f in dataclasses.fields(tcfg.ModelConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.ModelConfig)]
    assert tcfg.LM_SHAPES == tuple(tcfg.ShapeConfig(*dataclasses.astuple(s))
                                   for s in jcfg.LM_SHAPES)


@pytest.mark.parametrize("args", [(512, 64, 8, 0), (151936, 33, 3, 5), (49155, 17, 4, 2)])
def test_token_pipeline_byte_identical(args):
    for step in (0, 3):
        got, want = TokenPipeline(*args).batch(step), JaxPipeline(*args).batch(step)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert TokenPipeline(*args).shard(1, 1, 2).tobytes() == \
        JaxPipeline(*args).shard(1, 1, 2).tobytes()


def test_param_specs_and_counts_match_reference():
    """Every dense arch at full width: the same names, shapes and init rules,
    so the same parameter count; the other families are refused."""
    from repro.models.base import is_spec

    for name, cfg in tcfg.ARCHS.items():
        if cfg.family != "dense":
            with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
                TM.model_specs(cfg)
            continue
        want = jax.tree_util.tree_leaves_with_path(JM.model_specs(jcfg.ARCHS[name]),
                                                   is_leaf=is_spec)
        got = dict(_spec_leaves(TM.model_specs(cfg)))
        assert sorted(got) == sorted(_path(p) for p, _ in want)
        for p, s in want:
            assert (got[_path(p)].shape, got[_path(p)].init) == (s.shape, s.init)
        assert TM.param_count(cfg) == cfg.param_count() == JM.param_count(jcfg.ARCHS[name])


def _path(p):
    return tuple(k.key for k in p)


def _spec_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _spec_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_init_params_rule_and_seed():
    cfg = tcfg.reduced_config(tcfg.ARCHS["qwen2-1.5b"])
    make = lambda seed: TM.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    a, b, c = make(0), make(0), make(1)
    specs = dict(_spec_leaves(TM.model_specs(cfg)))
    for path, spec in specs.items():
        x = a
        for k in path:
            x = x[k]
        assert x.shape == spec.shape and x.dtype == torch.float32
        if spec.init == "zeros":
            assert not x.any()
        elif spec.init == "ones":
            assert bool((x == 1).all())
        else:
            fan_in = np.prod([d for d, ax in zip(spec.shape, spec.axes)
                              if ax != "layers"][:-1]) if spec.init == "fanin" else None
            std = {"embed": 0.02, "small": 0.006}.get(spec.init) or fan_in**-0.5
            assert abs(float(x.std()) / std - 1) < 0.1, (path, float(x.std()), std)
    assert torch.equal(a["embed"], b["embed"]) and not torch.equal(a["embed"], c["embed"])


# --------------------------------------------------------------------------
# layers and attention against the reference
# --------------------------------------------------------------------------


def test_rms_norm_rope_swiglu():
    x, w = _f32(0, (2, 7, 3, 16), (16,))
    _close(tlayers.rms_norm(_t(x), _t(w), 1e-6), jlayers.rms_norm(x, w, 1e-6))
    pos = np.arange(3, 10, dtype=np.int32)[None, :].repeat(2, 0)
    for theta in (10000.0, 1e6):
        _close(tlayers.rope(_t(x), _t(pos), theta), jlayers.rope(x, pos, theta))
    h, wg, wu, wd = _f32(1, (2, 5, 32), (32, 48), (32, 48), (48, 32))
    wg, wu, wd = wg / 32**0.5, wu / 32**0.5, wd / 48**0.5  # fan-in scaled, as initialised
    _close(tlayers.swiglu(_t(h), _t(wg), _t(wu), _t(wd)), jlayers.swiglu(h, wg, wu, wd))
    xb = jnp.asarray(x, jnp.bfloat16)  # the norm computes in f32 and casts back
    got = tlayers.rms_norm(_t(x).bfloat16(), _t(w), 1e-6)
    assert got.dtype == torch.bfloat16
    _close(got.float(), jlayers.rms_norm(xb, w, 1e-6).astype(jnp.float32), atol=1e-2)


@pytest.mark.parametrize("window", [None, 24])
def test_attend_and_chunked(window):
    jc, tc = _cfgs("qwen2-1.5b")
    Bq, Sq, M, G, Dh = 2, 64, 2, 3, 16
    q, k, v = _f32(2, (Bq, Sq, M, G, Dh), (Bq, Sq, M, Dh), (Bq, Sq, M, Dh))
    mask_j = jattn.causal_window_mask(Sq, 0, Sq, window)
    mask_t = tattn.causal_window_mask(Sq, 0, Sq, window, "cpu")
    assert np.array_equal(mask_t.numpy(), np.asarray(mask_j))
    _close(tattn.attend(_t(q), _t(k), _t(v), mask_t[None, None, None], tc),
           jattn.attend(q, k, v, mask_j[None, None, None], jc))
    for causal in (True, False):
        _close(tattn.attend_chunked(_t(q), _t(k), _t(v), tc, causal=causal, window=window,
                                    chunk=16),
               jattn.attend_chunked(q, k, v, jc, causal=causal, window=window, chunk=16))


@pytest.mark.parametrize("name,window,alloc", [("qwen2-1.5b", None, 40),
                                               ("qwen3-14b", 12, 12)])
def test_decode_attention_ring_cache(name, window, alloc):
    """Single-token decode into the bf16 ring cache, past a full ring
    (alloc 12 < 20 positions) with a window, so floor-mod slot validity
    and slot reuse are exercised."""
    jc, tc = _cfgs(name)
    from repro_torch.models.transformer import attn_specs
    from repro.models.transformer import attn_specs as j_attn_specs

    specs = j_attn_specs(jc, 1)
    layer = jax.tree.map(lambda a: a[0], JM.base_lib.init_params(specs, jax.random.key(1)))
    layer = {k: a + 0.1 for k, a in layer.items()}  # nonzero biases, norms off 1
    tlayer = params_from_numpy(jax.tree.map(np.asarray, layer), "cpu")
    assert set(tlayer) == set(attn_specs(tc, 1))
    cj = jattn.init_cache_entry(jc, 2, alloc)
    ct = tattn.init_cache_entry(tc, 2, alloc, device="cpu")
    xs = _f32(3, (20, 2, 1, jc.d_model))[0]
    step = jax.jit(lambda x, cache, pos: jattn.decode_attention(x, layer, cache, pos, jc,
                                                                None, window=window))
    for pos in range(20):
        oj, cj = step(xs[pos], cj, jnp.int32(pos))
        tables = tattn.decode_tables(tc, pos, alloc, window=window, device="cpu")
        ot, ct = tattn.decode_attention(_t(xs[pos]), tlayer, ct, pos, tc, tables)
        _close(ot, oj, atol=DECODE_ATOL)
        # the cached values may differ by one bf16 rounding (module docstring)
        _close(ct["k"].float(), np.asarray(cj["k"], np.float32), atol=2e-2)


# --------------------------------------------------------------------------
# the slice: prefill (flash through a 1x1 mesh) and decode against JAX
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=SLICE_ARCHS)
def slice_case(request):
    name = request.param
    jc, tc = _cfgs(name, attn_impl="flash")
    params = JM.init_params(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(7).integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rules = MeshRules.for_mesh(mesh)
    with mesh:
        logits, cache = jax.jit(lambda p, b: JM.forward_prefill(jc, p, rules, b))(
            params, {"tokens": jnp.asarray(toks)})
    return dict(jc=jc, tc=tc, params=params, tp=tp, toks=toks,
                logits=np.asarray(logits), cache=jax.tree.map(np.asarray, cache))


def test_params_from_numpy_carries_every_leaf(slice_case):
    """Name for name, shape for shape, value for value (qwen3-14b's
    embeddings are untied, so its tree has ``unembed``)."""
    c = slice_case
    want = jax.tree_util.tree_leaves_with_path(c["params"])
    got = dict(_spec_leaves(c["tp"]))
    assert sorted(got) == sorted(_path(p) for p, _ in want) == sorted(
        dict(_spec_leaves(TM.model_specs(c["tc"]))))
    for p, a in want:
        assert got[_path(p)].dtype == torch.float32
        assert np.array_equal(got[_path(p)].numpy(), np.asarray(a))


def test_prefill_matches_reference_flash(slice_case, monkeypatch):
    c = slice_case
    calls = []
    plain = t_kernel.flash_attention_bhsd_plain
    monkeypatch.setattr(t_kernel, "flash_attention_bhsd_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    logits, cache = TM.forward_prefill(c["tc"], c["tp"], {"tokens": _t(c["toks"]).long()})
    assert len(calls) == c["tc"].num_layers  # the flash branch, once per layer
    assert logits.shape == (B, 1, c["tc"].vocab_size)
    _close(logits, c["logits"])
    for k in ("k", "v"):
        assert cache[k].shape == c["cache"][k].shape
        _close(cache[k], c["cache"][k])
    # the three attention implementations are one function
    for impl in ("naive", "chunked"):
        other = dataclasses.replace(c["tc"], attn_impl=impl, attn_chunk=32)
        _close(TM.forward_prefill(other, c["tp"], {"tokens": _t(c["toks"]).long()})[0],
               c["logits"])


def test_decode_steps_match_reference(slice_case):
    """A prompt of 8 replayed through decode_step, then 8 greedy steps, each
    package feeding its own argmax: logits within DECODE_ATOL at every step
    while both were fed the same tokens, and the greedy tokens equal up to
    the first step where the reference's top-2 logits are within
    DECODE_ATOL of each other (a near-tie the tolerance cannot order)."""
    c = slice_case
    jc, tc = c["jc"], c["tc"]
    P, gen = 8, 8
    cj, ct = JM.init_cache(jc, B, P + gen), TM.init_cache(tc, B, P + gen, device="cpu")
    step = jax.jit(lambda p, cache, t, pos: JM.decode_step(jc, p, None, cache, t, pos))
    tok_j = tok_t = c["toks"][:, :1]
    tied = False
    for pos in range(P + gen - 1):
        if pos < P:
            tok_j = tok_t = c["toks"][:, pos:pos + 1]
        lj, cj = step(c["params"], cj, jnp.asarray(tok_j), jnp.int32(pos))
        lt, ct = TM.decode_step(tc, c["tp"], ct, _t(tok_t).long(), pos)
        lj = np.asarray(lj)
        _close(lt, lj, atol=DECODE_ATOL)
        if pos >= P - 1:
            top2 = np.sort(lj[:, -1], axis=-1)[:, -2:]
            tied = tied or bool((top2[:, 1] - top2[:, 0] <= DECODE_ATOL).any())
            tok_j = lj[:, -1].argmax(-1)[:, None].astype(np.int32)
            tok_t = lt[:, -1].argmax(-1)[:, None].numpy().astype(np.int32)
            if not np.array_equal(tok_t, tok_j):
                assert tied, f"greedy tokens differ at position {pos} without a near-tie"
                return  # the contexts differ from here on


def test_serve_replay_matches_prefill(slice_case):
    """serve(): the replay's logits at prompt_len - 1 equal the prefill's
    last-position logits (f32 compute, bf16 cache: REPLAY_ATOL), and the
    three attention implementations generate the same tokens."""
    c = slice_case
    runs = {}
    for impl in ("flash", "naive", "chunked"):
        cfg = dataclasses.replace(c["tc"], attn_impl=impl, attn_chunk=16)
        res = t_serve.serve(cfg, c["tp"], c["toks"][:, :48], 6, device="cpu")
        assert res.tokens.shape == (B, 6) and res.decode_steps == 48 + 6 - 1
        _close(res.replay_logits, res.prefill_logits, atol=REPLAY_ATOL)
        runs[impl] = res
    _close(runs["flash"].prefill_logits[:, 0], TM.forward_prefill(
        c["tc"], c["tp"], {"tokens": _t(c["toks"][:, :48]).long()})[0][:, 0])
    assert np.array_equal(runs["flash"].tokens, runs["naive"].tokens)
    assert np.array_equal(runs["flash"].tokens, runs["chunked"].tokens)
    # the steps module's greedy decode step continues the session the same way
    decode = make_decode_step(c["tc"])
    cache = TM.init_cache(c["tc"], B, 48 + 6, device="cpu")
    tok = None
    for pos in range(48 + 5):
        tok, cache = decode(c["tp"], cache, _t(c["toks"][:, pos:pos + 1]).long()
                            if pos < 48 else tok, pos)
        if pos >= 47:
            assert np.array_equal(tok.numpy()[:, 0], runs["flash"].tokens[:, pos - 47])


@pytest.mark.parametrize("name", [n for n, c in tcfg.ARCHS.items() if c.family == "dense"])
def test_serve_every_dense_arch(name):
    """Each dense arch (reduced, f32, port only): the flash prefill equals
    the naive one (ATOL) and the replay's logits the prefill's (REPLAY_ATOL)."""
    _, tc = _cfgs(name, attn_impl="flash")
    params = TM.init_params(tc, torch.Generator().manual_seed(1), "cpu")
    toks = np.random.default_rng(2).integers(0, tc.vocab_size, (2, 40))
    res = t_serve.serve(tc, params, toks, 3, device="cpu")
    naive = TM.forward_prefill(dataclasses.replace(tc, attn_impl="naive"), params,
                               {"tokens": _t(toks).long()})[0]
    _close(res.prefill_logits, naive)
    _close(res.replay_logits, res.prefill_logits, atol=REPLAY_ATOL)
    assert res.tokens.shape == (2, 3)


def test_serve_cli_on_cpu(capsys):
    t_serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "16", "--gen", "5",
                  "--set", "attn_impl=flash", "--set", "attn_chunk=8"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "qwen2-1.5b-smoke" and out["batch"] == 2
    assert out["tokens_generated"] == 10 and len(out["sample_generation"]) == 5
    assert set(out) == {"arch", "batch", "prefill_s", "decode_s", "tokens_generated",
                        "tokens_per_s", "sample_generation"}
    with pytest.raises(SystemExit):
        t_serve.main(["--device", "cpu", "--set", "no_such_field=1"])
    with pytest.raises(NotImplementedError, match="moe"):
        t_serve.main(["--device", "cpu", "--arch", "mixtral-8x7b"])
