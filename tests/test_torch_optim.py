"""The port's optimizer (``repro_torch.optim``) and training loss
(``models/layers.py:cross_entropy_loss``) on the CPU against the
reference's.

Inputs are numpy draws from a seed, given to both packages. Tolerances:
- schedules, the global norm and the loss: 1e-6 relative (float32 values
  of order 1, the same arithmetic up to the last bits of ``cos`` and of
  summation order);
- AdamW: each leaf of the new parameters and moments within 1e-6 of that
  leaf's largest magnitude (the same elementwise float32 arithmetic; XLA
  may fuse a product into an add, PyTorch rounds each);
- int8 compression: payloads equal, scales and residuals within 1e-6
  relative.

Then the reference's own ``tests/test_optim.py`` cases on the port, the
cross-rank ``compressed_psum_tree`` on two gloo ranks against the
reference's formula, and the reference's AdamW state carried across by
``params_from_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import optim as jopt
from repro.models import layers as jlayers
from repro.optim import adamw as jadamw
from repro_torch import optim as topt
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import layers as tlayers
from repro_torch.models.base import params_from_numpy, tree_leaves
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import grad_compress as tgc

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These steps are small: one intra-op thread runs them fastest, and
    keeps the file from oversubscribing the cores beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    m = np.abs(want).max()
    d = np.abs(np.asarray(got, np.float64) - want).max()
    return d / m if m else d


def _tree(seed, scale=1.0):
    """A nested tree of float32 leaves of several shapes (numpy)."""
    rs = np.random.default_rng(seed)
    f = lambda *s: (rs.standard_normal(s) * scale).astype(np.float32)
    return {"embed": f(16, 8), "final_norm": f(8),
            "layers": {"wq": f(2, 8, 4), "w_up": f(2, 8, 12), "ln1": f(2, 8)}}


def _t(tree):
    return params_from_numpy(tree, "cpu")


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", [("linear_warmup", (10,)), ("linear_warmup", (0,)),
                                   ("cosine_schedule", (20, 100)),
                                   ("cosine_schedule", (5, 30, 0.2)),
                                   ("cosine_schedule", (0, 1))])
def test_schedule_matches_reference(sched):
    name, args = sched
    jf, tf = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.array([float(jf(jnp.asarray(s))) for s in steps])
    got = tf(torch.as_tensor(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_global_norm_matches_reference():
    g = _tree(1)
    want = float(jadamw.global_norm(_j(g)))
    got = tadamw.global_norm(_t(g))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= RTOL * want


def _state(seed, step):
    """A mid-training AdamW state: moments of a few steps, ``step``."""
    mu = _tree(seed, 0.01)
    nu = jax.tree.map(lambda a: np.abs(a) * 1e-4, _tree(seed + 1))
    return {"mu": mu, "nu": nu, "step": np.asarray(step, np.int32)}


@pytest.mark.parametrize("case", ["fresh", "mid", "clipped", "scheduled", "no_decay"])
def test_adamw_update_matches_reference(case):
    kw = {"lr": 3e-3}
    grad_scale, step = 0.05, 3
    if case == "fresh":
        step = 0
    if case == "clipped":
        grad_scale = 10.0  # the global norm is far above clip_norm
    if case == "scheduled":
        kw["schedule"] = "cosine"
    if case == "no_decay":
        kw["weight_decay"] = 0.0
    sched = kw.pop("schedule", None)
    jcfg = jopt.AdamWConfig(**kw, schedule=jopt.cosine_schedule(2, 10) if sched else None)
    tcfg = topt.AdamWConfig(**kw, schedule=topt.cosine_schedule(2, 10) if sched else None)
    params, grads = _tree(10), _tree(11, grad_scale)
    state = _state(12, step)
    if case == "fresh":
        state = jax.tree.map(np.asarray, jopt.adamw_init(_j(params)))
    jp, js, jm = jax.jit(lambda p, g, s: jopt.adamw_update(jcfg, p, g, s))(
        _j(params), _j(grads), _j(state))
    tp, ts, tm = topt.adamw_update(tcfg, _t(params), _t(grads), params_from_numpy(state, "cpu"))
    assert int(ts["step"]) == int(js["step"]) == step + 1
    assert ts["step"].dtype == torch.int32
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= RTOL * float(jm["grad_norm"])
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= RTOL * float(jm["lr"])
    for got, want in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
        w = dict((p, np.asarray(a)) for p, a in tree_leaves(jax.tree.map(np.asarray, want)))
        for path, a in tree_leaves(got):
            assert a.dtype == torch.float32
            assert _rel(a, w[path]) <= RTOL, (case, path)


def test_adamw_update_is_in_place_and_leaves_the_gradients():
    """The update writes the new values into the given parameter and moment
    tensors and returns them; the gradients are not touched."""
    params, grads = _t(_tree(20)), _t(_tree(21, 0.1))
    grads_before = {p: a.clone() for p, a in tree_leaves(grads)}
    state = topt.adamw_init(params)
    ids = [id(a) for _, a in tree_leaves(params)] + [id(a) for _, a in tree_leaves(state["mu"])]
    p2, s2, _ = topt.adamw_update(topt.AdamWConfig(lr=0.1), params, grads, state)
    assert [id(a) for _, a in tree_leaves(p2)] + [id(a) for _, a in tree_leaves(s2["mu"])] == ids
    assert all(torch.equal(a, grads_before[p]) for p, a in tree_leaves(grads))
    assert int(s2["step"]) == 1 and int(state["step"]) == 0


def test_adamw_init_matches_reference():
    params = _tree(30)
    want = jopt.adamw_init(_j(params))
    got = topt.adamw_init(_t(params))
    assert got["step"].shape == () and got["step"].dtype == torch.int32
    for k in ("mu", "nu"):
        ref = tree_leaves(jax.tree.map(np.asarray, want[k]))
        for (path, a), (_, b) in zip(tree_leaves(got[k]), ref):
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape and not a.any()


def test_reference_adamw_state_carries_across():
    """params_from_numpy turns the reference's {"mu", "nu", "step"} into the
    port's, and an update from it continues the reference's."""
    params, grads = _tree(40), _tree(41, 0.1)
    cfg_j, cfg_t = jopt.AdamWConfig(lr=1e-2), topt.AdamWConfig(lr=1e-2)
    jp, js = _j(params), jopt.adamw_init(_j(params))
    step = jax.jit(lambda p, g, s: jopt.adamw_update(cfg_j, p, g, s)[:2])
    for _ in range(3):
        jp, js = step(jp, _j(grads), js)
    ts = params_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 3
    assert ts["mu"]["layers"]["wq"].dtype == torch.float32
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jp2, js2 = step(jp, _j(grads), js)
    tp2, ts2, _ = topt.adamw_update(cfg_t, tp, _t(grads), ts)
    for path, a in tree_leaves(tp2):
        want = dict(tree_leaves(jax.tree.map(np.asarray, jp2)))[path]
        assert _rel(a, want) <= RTOL, path
    assert int(ts2["step"]) == int(js2["step"]) == 4


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-2, 1.0, 0.0])
def test_compress_int8_matches_reference(scale):
    g = (np.random.default_rng(50).standard_normal((37, 11)) * scale).astype(np.float32)
    jq, js = jopt.compress_int8(jnp.asarray(g))
    tq, ts = topt.compress_int8(torch.as_tensor(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert abs(float(ts) - float(js)) <= RTOL * float(js)
    back = topt.decompress_int8(tq, ts)
    assert back.dtype == torch.float32
    np.testing.assert_allclose(back.numpy(), np.asarray(jopt.decompress_int8(jq, js)),
                               rtol=RTOL, atol=0)


def test_error_feedback_update_matches_reference():
    rs = np.random.default_rng(51)
    g = (rs.standard_normal(64) * 0.1).astype(np.float32)
    r = (rs.standard_normal(64) * 1e-3).astype(np.float32)
    (jq, js), jr = jopt.error_feedback_update(jnp.asarray(g), jnp.asarray(r))
    (tq, ts), tr = topt.error_feedback_update(torch.as_tensor(g), torch.as_tensor(r))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert abs(float(ts) - float(js)) <= RTOL * float(js)
    assert _rel(tr, np.asarray(jr)) <= RTOL


def _rank_psum(grads, residuals):
    """One rank of the compressed all-reduce: rank r's gradients are
    ``grads[r]``."""
    r = dist.get_rank()
    out, res = tgc.compressed_psum_tree(params_from_numpy(grads[r], "cpu"),
                                        params_from_numpy(residuals[r], "cpu"))
    as_np = lambda t: {"/".join(p): a.numpy() for p, a in tree_leaves(t)}
    return as_np(out), as_np(res)


def test_compressed_psum_tree_on_two_ranks(tmp_path):
    """Each rank gets the reference's formula over both ranks' payloads:
    the int32 sum of the int8 payloads times the mean scale over n, and its
    own residual."""
    grads = [_tree(60 + r, 0.1) for r in range(2)]
    residuals = [_tree(70 + r, 1e-3) for r in range(2)]
    out = mesh_lib.spawn(_rank_psum, 2, backend="gloo", device="cpu", threads=1,
                         init_dir=str(tmp_path), args=(grads, residuals))
    for path, _ in tree_leaves(grads[0]):
        key = "/".join(path)
        pairs = [jopt.error_feedback_update(jnp.asarray(dict(tree_leaves(grads[r]))[path]),
                                            jnp.asarray(dict(tree_leaves(residuals[r]))[path]))
                 for r in range(2)]
        summed = sum(np.asarray(q, np.int32) for (q, _), _ in pairs)
        scale_sum = np.float32(sum(np.float32(s) for (_, s), _ in pairs))
        want = summed.astype(np.float32) * (scale_sum / np.float32(2)) / np.float32(2)
        for r in range(2):
            assert out[r][0][key].dtype == np.float32
            np.testing.assert_allclose(out[r][0][key], want, rtol=RTOL, atol=0)
            assert _rel(out[r][1][key], np.asarray(pairs[r][1])) <= RTOL


# ---------------------------------------------------------------------------
# the reference's own tests/test_optim.py cases, on the port
# ---------------------------------------------------------------------------


def test_adamw_reduces_quadratic():
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 5.0], dtype=torch.float32)}
    state = topt.adamw_init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}  # the gradient of sum(w ** 2)
        params, state, m = topt.adamw_update(cfg, params, g, state)
    assert float(params["w"].abs().max()) < 0.05
    assert int(state["step"]) == 200


def test_grad_clipping():
    cfg = topt.AdamWConfig(lr=0.0, clip_norm=1.0)
    params = {"w": torch.ones(4, dtype=torch.float32)}
    state = topt.adamw_init(params)
    g = {"w": torch.full((4,), 100.0, dtype=torch.float32)}
    _, _, m = topt.adamw_update(cfg, params, g, state)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_cosine_schedule_shape():
    f = topt.cosine_schedule(10, 100)
    xs = [float(f(torch.tensor(s))) for s in (0, 5, 10, 50, 100)]
    assert xs[0] == 0.0
    assert xs[1] == pytest.approx(0.5)
    assert xs[2] == pytest.approx(1.0)
    assert xs[3] < 1.0
    assert xs[4] == pytest.approx(0.1, abs=1e-6)


def test_int8_compression_roundtrip():
    g = torch.as_tensor(np.random.default_rng(0).standard_normal(1000).astype(np.float32)) * 0.01
    q, scale = topt.compress_int8(g)
    back = topt.decompress_int8(q, scale)
    assert q.dtype == torch.int8
    np.testing.assert_allclose(back.numpy(), g.numpy(), atol=float(scale))


def test_error_feedback_converges():
    """Residual carrying: the cumulative sum of decompressed grads tracks
    the cumulative sum of true grads to within one quantization step."""
    true_sum = torch.zeros(64, dtype=torch.float32)
    sent_sum = torch.zeros(64, dtype=torch.float32)
    res = torch.zeros(64, dtype=torch.float32)
    rs = np.random.default_rng(1)
    for _ in range(50):
        g = torch.as_tensor(rs.standard_normal(64).astype(np.float32)) * 0.1
        (q, s), res = topt.error_feedback_update(g, res)
        sent_sum = sent_sum + topt.decompress_int8(q, s)
        true_sum = true_sum + g
    assert float((sent_sum - true_sum).abs().max()) < 0.01


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask", ["none", "half", "empty"])
def test_cross_entropy_loss_matches_reference(mask):
    rs = np.random.default_rng(80)
    logits = (rs.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rs.integers(0, 50, (3, 7)).astype(np.int32)
    m = {"none": None, "half": (rs.random((3, 7)) < 0.5).astype(np.float32),
         "empty": np.zeros((3, 7), np.float32)}[mask]
    want = float(jlayers.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                            None if m is None else jnp.asarray(m)))
    got = tlayers.cross_entropy_loss(torch.as_tensor(logits), torch.as_tensor(labels),
                                     None if m is None else torch.as_tensor(m))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= RTOL * max(abs(want), 1.0)


def test_cross_entropy_loss_of_bf16_logits_is_float32():
    rs = np.random.default_rng(81)
    logits = torch.as_tensor(rs.standard_normal((2, 5, 30)).astype(np.float32))
    labels = torch.as_tensor(rs.integers(0, 30, (2, 5)))
    got = tlayers.cross_entropy_loss(logits.to(torch.bfloat16), labels)
    assert got.dtype == torch.float32
    assert float(got) == float(tlayers.cross_entropy_loss(logits.to(torch.bfloat16).float(),
                                                          labels))
