"""The port's vlm, moe, ssm, hybrid and audio language models
(``repro_torch.models``, ``repro_torch.launch.serve``) on the CPU against
the reference's.

Inputs are numpy draws from a seed; parameters are the reference's
(``jax.random``), carried across with ``params_from_numpy``. The reference
reaches its Pallas flash kernel only under a mesh, so its prefills run
under a 1x1 ``MeshRules`` (interpret mode on the CPU), at lengths that
divide the kernel's 128-row blocks (vlm: 8 patches + 120 tokens).

Tolerances, all in float32 compute:
- layers, attention routes and the MoE: atol 1e-5 (the same arithmetic in
  another summation order; values of order 1);
- prefill logits and caches: atol 1e-5 for the attention families
  (measured: up to 2.5e-6); the scan families (ssm, hybrid) sum their
  recurrences in another order (the SSD's inter-chunk loop, the RG-LRU's
  doubling scan against JAX's associative scan) and are held to atol 1e-4
  (measured: up to 1.4e-5, the ssm state);
- decode logits: atol 2e-3, as the dense family's (tests/test_torch_models.py):
  the attention caches are bfloat16 in both packages, and a cached value
  whose float32 inputs differ in the last bits can round to the
  neighbouring bfloat16;
- the serving replay against the prefill: atol 1e-2 (the same bfloat16
  cache against the prefill's float32 keys and values).
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
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import ssd as jssd
from repro.models.base import is_spec
from repro.models.sharding import MeshRules
from repro_torch import configs as tcfg
from repro_torch.kernels.flash_attention import kernel as t_kernel
from repro_torch.launch import serve as t_serve
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import ssd as tssd
from repro_torch.models.base import params_from_numpy

ATOL = 1e-5
SCAN_ATOL = 1e-4
DECODE_ATOL = 2e-3
REPLAY_ATOL = 1e-2
ARCHS = {  # one arch per family (two for moe: top-2 with a window, and no window)
    "vlm": "llava-next-mistral-7b",
    "moe": "mixtral-8x7b",
    "moe-nowindow": "moonshot-v1-16b-a3b",
    "ssm": "mamba2-130m",
    "hybrid": "recurrentgemma-9b",
    "audio": "whisper-base",
}
B, S = 2, 128


def _f32(seed, *shapes):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def _cfgs(name, **kw):
    """The reduced config of ``name`` in both packages, float32 compute."""
    kw = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(jcfg.reduced_config(jcfg.ARCHS[name]), **kw),
            dataclasses.replace(tcfg.reduced_config(tcfg.ARCHS[name]), **kw))


def _key(k):
    return k.key if hasattr(k, "key") else k.idx


def _ref_leaves(tree, is_leaf=None):
    """(path, leaf) of a reference tree, paths as tuples of keys / indices."""
    return [(tuple(_key(k) for k in p), a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)]


def _port_leaves(tree, prefix=()):
    """(path, leaf) of a port tree in jax's flattening order (dicts by
    sorted key, tuples in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _port_leaves(t, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def _same_tree(got, want, atol):
    g, w = list(_port_leaves(got)), _ref_leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b)), p
        _close(a, b, atol=atol)


# --------------------------------------------------------------------------
# parameter specs and counts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n, c in tcfg.ARCHS.items() if c.family != "dense"])
@pytest.mark.parametrize("reduced", [False, True])
def test_param_specs_and_counts_match_reference(name, reduced):
    """Every non-dense arch, at full width and reduced: the same names,
    shapes, axes and init rules, so the same parameter counts (MoE-active
    too); audio also at a longer decoder position table."""
    cfg, jc = tcfg.ARCHS[name], jcfg.ARCHS[name]
    if reduced:
        cfg, jc = tcfg.reduced_config(cfg), jcfg.reduced_config(jc)
    for mtp in (0, 600):
        want = _ref_leaves(JM.model_specs(jc, mtp), is_leaf=is_spec)
        got = list(_port_leaves(TM.model_specs(cfg, mtp)))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, a), (_, b) in zip(got, want):
            assert (a.shape, a.axes, a.init, a.dtype) == (b.shape, b.axes, b.init, b.dtype), p
    for active in (False, True):
        assert TM.param_count(cfg, active) == JM.param_count(jc, active)
    assert cfg.param_count() == jc.param_count()
    assert cfg.active_param_count() == jc.active_param_count()


# --------------------------------------------------------------------------
# modules against the reference functions
# --------------------------------------------------------------------------


def test_layer_norm_gelu_mlp_sinusoidal():
    x, w, b = _f32(0, (2, 7, 48), (48,), (48,))
    x = x * 3 + 1  # a mean and a spread to normalise away
    _close(tlayers.layer_norm(_t(x), _t(w), _t(b), 1e-5), jlayers.layer_norm(x, w, b, 1e-5))
    got = tlayers.layer_norm(_t(x).bfloat16(), _t(w), _t(b), 1e-5)
    assert got.dtype == torch.bfloat16  # float32 inside, cast back
    _close(got, jlayers.layer_norm(jnp.asarray(x, jnp.bfloat16), w, b, 1e-5), atol=5e-2)
    h, wi, bi, wo, bo = _f32(1, (2, 5, 32), (32, 64), (64,), (64, 32), (32,))
    wi, wo = wi / 32**0.5, wo / 64**0.5
    _close(tlayers.gelu_mlp(_t(h), _t(wi), _t(bi), _t(wo), _t(bo)),
           jlayers.gelu_mlp(h, wi, bi, wo, bo))
    # torch's and XLA's float32 exp differ in the last bit for ~10% of the
    # frequencies (one ulp, <= 3e-8 here); at position 1,499 that moves the
    # angle, and so the sine, by up to ~1,499 * 3e-8 plus the angle's own
    # rounding (one ulp of 1,499 rad is 1.2e-4): hence 1e-4 at 1,500 frames
    for length, dim in ((24, 64), (1500, 512), (7, 6)):
        want = jax.jit(jlayers.sinusoidal_positions, static_argnums=(0, 1))(length, dim)
        _close(tlayers.sinusoidal_positions(length, dim), want,
               atol=1e-4 if length > 100 else ATOL)


def _moe_case(E=8, K=2, cf=1.25, T=48, D=32, F=40, seed=0):
    jc, tc = _cfgs("moonshot-v1-16b-a3b", num_experts=E, experts_per_token=K,
                   capacity_factor=cf, d_model=D, d_ff=F)
    x, router, wg, wu, wd = _f32(seed, (2, T // 2, D), (D, E), (E, D, F), (E, D, F), (E, F, D))
    p = {"router": router * 0.3, "w_gate": wg / D**0.5, "w_up": wu / D**0.5,
         "w_down": wd / F**0.5}
    return jc, tc, x, p


def _moe_against_reference(jc, tc, x, p):
    want, waux = jax.jit(jmoe.moe_ffn, static_argnums=2)(x, p, jc)
    got, aux = tmoe.moe_ffn(_t(x), {k: _t(v) for k, v in p.items()}, tc)
    _close(got, want)
    for k in ("dropped_fraction", "router_z", "load_balance"):
        _close(aux[k], waux[k])
    disp, _ = tmoe.moe_ffn_dispatch(_t(x), {k: _t(v) for k, v in p.items()}, tc)
    assert torch.equal(disp, got)
    return float(aux["dropped_fraction"])


def test_moe_top_k_ties_break_to_the_lower_expert():
    """Tied router logits: the port's stable sort picks jax.lax.top_k's
    experts, lower index first; a tied row at the K boundary included."""
    rs = np.random.default_rng(3)
    logits = rs.integers(0, 4, (64, 8)).astype(np.float32)
    logits[0] = [1, 3, 3, 0, 3, 2, 3, 1]  # a four-way tie across the boundary
    want_v, want_i = jax.lax.top_k(logits, 2)
    got_v, got_i = tmoe.route(_t(logits), 2)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i[0].tolist() == [1, 2]
    # duplicate router columns: experts 1/2, 3/4 and 5/6/7 tie for every token
    jc, tc, x, p = _moe_case(cf=4.0)
    p["router"] = p["router"][:, [0, 1, 1, 2, 2, 3, 3, 3]]
    rl = np.asarray(jnp.einsum("td,de->te", x.reshape(-1, 32), p["router"]))
    assert (np.sort(rl, -1)[:, -2] == np.sort(rl, -1)[:, -3]).any()  # ties at the boundary
    assert _moe_against_reference(jc, tc, x, p) == 0.0


@pytest.mark.parametrize("K,cf", [(2, 0.25), (2, 0.5), (4, 0.5)])
def test_moe_drops_over_capacity(K, cf):
    """Forced drops (capacity 8 or 16 against 12 or 24 assignments an
    expert on average): the same assignments dropped (token-major
    positions), the same dropped fraction and outputs."""
    jc, tc, x, p = _moe_case(K=K, cf=cf, seed=1)
    dropped = _moe_against_reference(jc, tc, x, p)
    assert dropped > 0.0


def test_moe_capacity():
    for name in ("mixtral-8x7b", "moonshot-v1-16b-a3b"):
        cfg, jc = tcfg.ARCHS[name], jcfg.ARCHS[name]
        for T in (1, 8, 1024, 4097):
            assert tmoe.capacity(cfg, T) == jmoe.capacity(jc, T)


@pytest.mark.parametrize("S,chunk,init", [(37, 16, True), (48, 16, False), (5, 8, True)])
def test_ssd_scan_ref(S, chunk, init):
    """The chunked SSD against the reference's: padded lengths and an
    initial state; and the decode recurrence step by step against the
    scan's final state."""
    b, H, P, G, N = 2, 4, 8, 2, 8
    x, dt_raw, a_log, Bm, Cm, h0 = _f32(4, (b, S, H, P), (b, S, H), (H,), (b, S, G, N),
                                        (b, S, G, N), (b, H, P, N))
    dt = np.log1p(np.exp(dt_raw)).astype(np.float32) * 0.5
    A = -np.exp(a_log).astype(np.float32)
    h0 = h0 if init else None
    want_y, want_s = jax.jit(jssd.ssd_scan_ref, static_argnums=5)(x, dt, A, Bm, Cm, chunk, h0)
    got_y, got_s = tssd.ssd_scan_ref(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                                     None if h0 is None else _t(h0))
    _close(got_y, want_y, atol=SCAN_ATOL)
    _close(got_s, want_s, atol=SCAN_ATOL)
    state = _t(h0) if init else torch.zeros((b, H, P, N))
    for t in range(S):
        y, state = tssd.ssd_decode_step(_t(x[:, t]), _t(dt[:, t]), _t(A), _t(Bm[:, t]),
                                        _t(Cm[:, t]), state)
        _close(y, want_y[:, t], atol=SCAN_ATOL)
    _close(state, want_s, atol=SCAN_ATOL)
    seg = np.asarray(jssd.segsum(dt_raw[0, :8, 0]))
    assert np.array_equal(np.isinf(tssd.segsum(_t(dt_raw[0, :8, 0])).numpy()), np.isinf(seg))


def test_causal_conv_and_its_decode_step():
    x, w, bias = _f32(5, (2, 9, 12), (4, 12), (12,))
    want = jssd.causal_conv1d(x, w, bias)
    _close(tssd.causal_conv1d(_t(x), _t(w), _t(bias)), want)
    state = torch.zeros((2, 3, 12))
    for t in range(9):
        y, state = tssd.conv_decode_step(_t(x[:, t]), state, _t(w), _t(bias))
        _close(y, want[:, t])


def _rg_params(W, seed):
    wa, wx, ba, bx, lam = _f32(seed, (W, W), (W, W), (W,), (W,), (W,))
    return {"w_a": wa * 0.05, "w_x": wx * 0.05, "b_a": ba, "b_x": bx, "lam": lam}


@pytest.mark.parametrize("S", [1, 37])
def test_rglru_scan_against_a_loop_and_the_reference(S):
    W = 16
    p = _rg_params(W, 6)
    x, h0 = _f32(7, (2, S, W), (2, W))
    tp = {k: _t(v) for k, v in p.items()}
    for init in (None, h0):
        want_h, want_s = jax.jit(jrglru.rglru_scan)(x, p, init)
        got_h, got_s = trglru.rglru_scan(_t(x), tp, None if init is None else _t(init))
        _close(got_h, want_h)
        _close(got_s, want_s)
        state = torch.zeros((2, W)) if init is None else _t(init)
        loop = []
        for t in range(S):
            h, state = trglru.rglru_decode_step(_t(x[:, t]), tp, state)
            loop.append(h)
        _close(got_h, torch.stack(loop, 1).numpy())
    assert trglru.C_FACTOR == jrglru.C_FACTOR


def test_recurrent_block_and_its_decode():
    jc, tc = _cfgs("recurrentgemma-9b")
    from repro.models.transformer import rec_specs

    layer = jax.tree.map(lambda a: a[0] + 0.05,
                         JM.base_lib.init_params(rec_specs(jc, 1), jax.random.key(2)))
    tl = params_from_numpy(jax.tree.map(np.asarray, layer), "cpu")
    x = _f32(8, (2, 12, jc.d_model))[0]
    want, (w_conv, w_lru) = jax.jit(jrglru.recurrent_block, static_argnums=2)(x, layer, jc)
    got, (g_conv, g_lru) = trglru.recurrent_block(_t(x), tl, tc)
    _close(got, want)
    _close(g_conv, w_conv)
    _close(g_lru, w_lru)
    st = (torch.zeros((2, 3, 64)), torch.zeros((2, 64)))
    for t in range(12):
        out, st = trglru.recurrent_block_decode(_t(x[:, t:t + 1]), tl, st)
        _close(out, want[:, t:t + 1])
    _close(st[0], w_conv)


@pytest.mark.parametrize("route", ["flash", "chunked", "naive", "cross", "mask"])
def test_encdec_mha_routes(route):
    """encdec._mha on each route against the reference's: flash (causal
    self-attention, Sq == Sk; the reference falls back to its chunked
    online softmax without a mesh), chunked, naive (causal and full),
    cross-attention over 24 frames, and a caller's mask."""
    impl = {"cross": "flash", "mask": "chunked"}.get(route, route)
    jc, tc = _cfgs("whisper-base", attn_impl=impl, attn_chunk=8)
    from repro.models.encdec import _attn_specs

    layer = jax.tree.map(lambda a: a[0] + 0.03,
                         JM.base_lib.init_params(_attn_specs(jc, 1), jax.random.key(3)))
    tl = params_from_numpy(jax.tree.map(np.asarray, layer), "cpu")
    x, kv = _f32(9, (2, 32, jc.d_model), (2, 24, jc.d_model))
    calls = []
    plain = t_kernel.flash_attention_bhsd_plain
    t_kernel.flash_attention_bhsd_plain = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        for causal in (True, False):
            if route == "cross":
                args, kw = (kv,), dict(causal=False)
            elif route == "mask":
                m = np.random.default_rng(1).random((1, 1, 1, 32, 32)) < 0.7
                m[..., 0] = True
                args, kw = (x,), dict(causal=causal, mask=m)
            else:
                args, kw = (x,), dict(causal=causal)
            want = jax.jit(jencdec._mha, static_argnums=(3, 4), static_argnames="causal")(
                x, *args, layer, jc, None, **kw)
            tkw = {**kw, "mask": _t(kw["mask"])} if "mask" in kw else kw
            got = tencdec._mha(_t(x), *(_t(a) for a in args), tl, tc, **tkw)
            _close(got, want)
    finally:
        t_kernel.flash_attention_bhsd_plain = plain
    assert len(calls) == (1 if route == "flash" else 0)  # flash: the causal call only


# --------------------------------------------------------------------------
# each family: prefill (flash through a 1x1 mesh) and decode against JAX
# --------------------------------------------------------------------------


def _batch(cfg, toks, seed=11):
    b = {"tokens": toks}
    if cfg.family == "vlm":
        b["patch_embeds"] = _f32(seed, (toks.shape[0], cfg.num_patches, cfg.d_model))[0]
    if cfg.family == "audio":
        b["frames"] = _f32(seed, (toks.shape[0], cfg.enc_frames, cfg.d_model))[0]
    return b


def _tbatch(batch):
    return {k: _t(v).long() if k == "tokens" else _t(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=list(ARCHS))
def family_case(request):
    name = ARCHS[request.param]
    jc, tc = _cfgs(name, attn_impl="flash")
    params = JM.init_params(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    n_tok = S - jc.num_patches if jc.family == "vlm" else S
    toks = np.random.default_rng(7).integers(0, jc.vocab_size, (B, n_tok)).astype(np.int32)
    batch = _batch(jc, toks)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rules = MeshRules.for_mesh(mesh)
    with mesh:
        logits, cache = jax.jit(lambda p, b: JM.forward_prefill(jc, p, rules, b))(
            params, jax.tree.map(jnp.asarray, batch))
    return dict(family=request.param, jc=jc, tc=tc, params=params, tp=tp, toks=toks,
                batch=batch, logits=np.asarray(logits), cache=jax.tree.map(np.asarray, cache))


def _flash_layers(cfg) -> int:
    """Flash launches of one prefill: every attention layer's causal
    self-attention (audio: the decoder's; ssm: none)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        from repro_torch.models.transformer import hybrid_layer_types

        return hybrid_layer_types(cfg).count("attn")
    return cfg.num_layers


def test_params_from_numpy_carries_every_leaf(family_case):
    """Name for name, shape for shape, value for value, the hybrid's two
    layer groups and the audio's encoder/decoder trees included."""
    c = family_case
    want = _ref_leaves(c["params"])
    got = list(_port_leaves(c["tp"]))
    assert [p for p, _ in got] == [p for p, _ in want] == \
        [p for p, _ in _port_leaves(TM.model_specs(c["tc"]))]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), np.asarray(b)), p


def test_prefill_matches_reference_flash(family_case, monkeypatch):
    """Last-position logits and the decode cache leaf for leaf (the
    hybrid's nested cycles/remainder tree, the ssm's (conv, ssm) tuple,
    audio's enc_out), flash launched once per attention layer; the naive
    and chunked implementations give the same logits."""
    c = family_case
    calls = []
    plain = t_kernel.flash_attention_bhsd_plain
    monkeypatch.setattr(t_kernel, "flash_attention_bhsd_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    logits, cache = TM.forward_prefill(c["tc"], c["tp"], _tbatch(c["batch"]))
    assert len(calls) == _flash_layers(c["tc"])
    assert logits.shape == (B, 1, c["tc"].vocab_size)
    atol = SCAN_ATOL if c["tc"].family in ("ssm", "hybrid") else ATOL
    _close(logits, c["logits"], atol=atol)
    _same_tree(cache, c["cache"], atol)
    for impl in ("naive", "chunked"):
        other = dataclasses.replace(c["tc"], attn_impl=impl, attn_chunk=32)
        _close(TM.forward_prefill(other, c["tp"], _tbatch(c["batch"]))[0], c["logits"],
               atol=atol)


def test_decode_steps_match_reference(family_case):
    """A prompt replayed through decode_step, then 8 greedy steps, each
    package feeding its own argmax: logits within DECODE_ATOL at every step
    while both were fed the same tokens, the caches alike, and the greedy
    tokens equal up to the first step where the reference's top-2 logits
    are within DECODE_ATOL (a near-tie the tolerance cannot order). The
    hybrid's prompt (40) outruns its local window (32), so the ring wraps."""
    c = family_case
    jc, tc = c["jc"], c["tc"]
    P, gen = (40 if tc.family == "hybrid" else 8), 8
    cj, ct = JM.init_cache(jc, B, P + gen), TM.init_cache(tc, B, P + gen, device="cpu")
    _same_tree(ct, cj, 0.0)
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
        if pos == P - 1:
            _same_tree(ct, jax.tree.map(np.asarray, cj), 2e-2)  # one bf16 rounding
        if pos >= P - 1:
            top2 = np.sort(lj[:, -1], axis=-1)[:, -2:]
            tied = tied or bool((top2[:, 1] - top2[:, 0] <= DECODE_ATOL).any())
            tok_j = lj[:, -1].argmax(-1)[:, None].astype(np.int32)
            tok_t = lt[:, -1].argmax(-1)[:, None].numpy().astype(np.int32)
            if not np.array_equal(tok_t, tok_j):
                assert tied, f"greedy tokens differ at position {pos} without a near-tie"
                return  # the contexts differ from here on


def _prefill_dropped(cfg, params, toks) -> float:
    from repro_torch.models.transformer import stack_forward

    x = tlayers.embed(_t(toks).long(), params["embed"])
    return float(stack_forward(cfg, params, x)[2]["dropped_fraction"])


def test_serve_replay_matches_prefill(family_case):
    """serve(): the replay's logits at prompt_len - 1 equal the prefill's
    (ssm, hybrid, moe), or, for vlm, a text-only prefill's (the replay never
    sees the zero patches: ROADMAP queue 3, "Faults in the reference", item
    3); flash and naive sessions generate the same tokens. Audio is refused.

    A moe prefill may drop assignments over capacity (~6% of 80 tokens at
    the configured capacity) where a decode step of 2 tokens drops none, and
    then the two compute other functions; the replay is held to the prefill
    at a capacity factor of E / K, where nothing can drop."""
    c = family_case
    tc = c["tc"]
    P = 24
    toks = c["toks"][:, :P]
    if tc.family == "moe":
        tc = dataclasses.replace(tc, capacity_factor=tc.num_experts / tc.experts_per_token)
        assert _prefill_dropped(tc, c["tp"], toks) == 0.0
    if tc.family == "audio":
        with pytest.raises(ValueError, match="serve driver targets LMs"):
            t_serve.serve(tc, c["tp"], toks, 4, device="cpu")
        return
    runs = {}
    for impl in ("flash", "naive"):
        cfg = dataclasses.replace(tc, attn_impl=impl)
        res = t_serve.serve(cfg, c["tp"], toks, 4, device="cpu")
        assert res.tokens.shape == (B, 4) and res.decode_steps == P + 4 - 1
        runs[impl] = res
    res = runs["flash"]
    assert np.array_equal(res.tokens, runs["naive"].tokens)
    batch = {"tokens": _t(toks).long()}
    if tc.family == "vlm":
        batch["patch_embeds"] = torch.zeros((B, tc.num_patches, tc.d_model))
    _close(res.prefill_logits, TM.forward_prefill(tc, c["tp"], batch)[0])
    if tc.family == "vlm":
        text = TM.forward_prefill(dataclasses.replace(tc, family="dense"), c["tp"],
                                  {"tokens": _t(toks).long()})[0]
        _close(res.replay_logits, text, atol=REPLAY_ATOL)
        assert float((res.replay_logits - res.prefill_logits).abs().max()) > REPLAY_ATOL
    else:
        _close(res.replay_logits, res.prefill_logits, atol=REPLAY_ATOL)


def test_audio_cross_attention_cache_stays_zero():
    """The reference's audio decode never fills xk/xv from the encoder
    (ROADMAP queue 3, "Faults in the reference", item 4): the port's
    decode leaves them zero too, so a step's logits do not depend on the
    audio that the prefill encoded."""
    _, tc = _cfgs("whisper-base")
    params = TM.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (B, 6))
    logits = []
    for seed in (11, 12):
        batch = _tbatch(_batch(tc, toks, seed))
        _, enc = TM.forward_prefill(tc, params, batch)
        assert set(enc) == {"enc_out"} and enc["enc_out"].shape == (B, tc.enc_frames, tc.d_model)
        cache = TM.init_cache(tc, B, 6, device="cpu")
        for pos in range(6):
            lg, cache = TM.decode_step(tc, params, cache, _t(toks[:, pos:pos + 1]).long(), pos)
        assert not cache["xk"].any() and not cache["xv"].any()
        logits.append(lg)
    assert torch.equal(logits[0], logits[1])


@pytest.mark.parametrize("name", ["llava-next-mistral-7b", "mixtral-8x7b", "mamba2-130m",
                                  "recurrentgemma-9b"])
def test_serve_cli_on_cpu(name, capsys):
    t_serve.main(["--device", "cpu", "--arch", name, "--batch", "2", "--prompt-len", "12",
                  "--gen", "4", "--set", "attn_impl=flash"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == f"{name}-smoke" and out["batch"] == 2
    assert out["tokens_generated"] == 8 and len(out["sample_generation"]) == 4


def test_serve_cli_refuses_audio():
    with pytest.raises(SystemExit, match="serve driver targets LMs"):
        t_serve.main(["--device", "cpu", "--arch", "whisper-base"])
