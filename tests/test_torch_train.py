"""LM training in the port (``models/model.py:forward_train``,
``launch/steps.py``) on the CPU against the reference's, every arch at
``reduced_config`` in float32.

The reference's parameters (``jax.random``) are carried across with
``params_from_numpy``; batches are numpy draws from a seed, shaped as
``tests/test_models.py:make_batch`` shapes them (vlm: 8 patches + 24
tokens), and the five-step loops read the same ``TokenPipeline`` batches
(the two pipelines' bytes are equal). Each reference function is jitted
once per arch and shared by the tests of that arch.

Tolerances, float32:
- ``forward_train``'s loss and metrics: 1e-5 relative (measured: up to
  1.5e-7);
- gradients, leaf for leaf against ``jax.grad``: within 1e-4 of the leaf's
  largest |g|, plus 1e-8 (measured: up to 1.4e-5, the ssm's scan summed in
  another order). The floor is for the key biases of the audio family,
  whose gradients are zero in exact arithmetic (softmax is invariant to a
  shift of a row) and read ~1e-10 of rounding in either package;
- five ``make_train_step`` steps against a jitted reference loop: each
  step's loss within 1e-4 relative. Parameters after a step are not
  compared element by element: Adam's first steps move a parameter by
  about ±lr wherever its gradient is near zero, and the sign of a
  near-zero gradient is rounding.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import optim as jopt
from repro.data.tokens import TokenPipeline as JPipe
from repro.models import model as JM
from repro_torch import configs as tcfg
from repro_torch import optim as topt
from repro_torch.data.tokens import TokenPipeline as TPipe
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.base import params_from_numpy, tree_leaves

ARCHS = sorted(jcfg.ARCHS)
B, S = 2, 32
LOSS_RTOL, GRAD_TOL, STEP_RTOL = 1e-5, (1e-4, 1e-8), 1e-4
STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These steps are small: one intra-op thread runs them fastest, and
    keeps the file from oversubscribing the cores beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    return (dataclasses.replace(jcfg.reduced_config(jcfg.ARCHS[name]), compute_dtype="float32"),
            dataclasses.replace(tcfg.reduced_config(tcfg.ARCHS[name]), compute_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's config, parameters (numpy) and jitted
    value_and_grad of forward_train for ``name``."""
    jc, tc = _cfgs(name)
    params = jax.tree.map(np.asarray, JM.init_params(jc, jax.random.key(0),
                                                     max_target_positions=64))
    vg = jax.jit(jax.value_and_grad(lambda p, b: JM.forward_train(jc, p, None, b),
                                    has_aux=True))
    return jc, tc, params, vg


def _batch(cfg, seed):
    rs = np.random.default_rng(seed)
    toks = rs.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "audio":
        return {"tokens": toks,
                "frames": (rs.standard_normal((B, cfg.enc_frames, cfg.d_model)) * 0.1
                           ).astype(np.float32)}
    if cfg.family == "vlm":
        return {"tokens": toks[:, : S - cfg.num_patches],
                "patch_embeds": (rs.standard_normal((B, cfg.num_patches, cfg.d_model)) * 0.1
                                 ).astype(np.float32)}
    return {"tokens": toks}


def _torch_batch(batch):
    return {k: torch.as_tensor(v).long() if k == "tokens" else torch.as_tensor(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_forward_train_and_gradients_match_reference(name):
    jc, tc, params, vg = _reference(name)
    batch = _batch(jc, 1)
    (jloss, jmetrics), jgrads = vg(params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = tsteps.loss_and_grads(tc, params_from_numpy(params, "cpu"),
                                                 _torch_batch(batch))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert sorted(metrics) == sorted(jmetrics)
    for k, v in jmetrics.items():
        assert abs(float(metrics[k]) - float(v)) <= LOSS_RTOL * max(abs(float(v)), 1.0), k
    want = jax.tree.map(np.asarray, jgrads)
    got, ref = list(tree_leaves(grads)), list(tree_leaves(want))
    assert [p for p, _ in got] == [p for p, _ in ref]
    rel, floor = GRAD_TOL
    for (path, g), (_, w) in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, path
        d = np.abs(g.numpy() - w).max()
        assert d <= rel * np.abs(w).max() + floor, (path, d, np.abs(w).max())


def _ref_batch(cfg, toks):
    """launch/train.py's make_batch on the reference's side."""
    if cfg.family == "audio":
        return {"tokens": jnp.asarray(toks),
                "frames": jnp.zeros((B, cfg.enc_frames, cfg.d_model), jnp.float32)}
    if cfg.family == "vlm":
        return {"tokens": jnp.asarray(toks[:, : S - cfg.num_patches]),
                "patch_embeds": jnp.zeros((B, cfg.num_patches, cfg.d_model), jnp.float32)}
    return {"tokens": jnp.asarray(toks)}


@pytest.mark.parametrize("name", ARCHS)
def test_five_train_steps_match_reference(name):
    jc, tc, params, vg = _reference(name)
    jopt_cfg = jopt.AdamWConfig(lr=3e-3, schedule=jopt.cosine_schedule(2, STEPS))
    topt_cfg = topt.AdamWConfig(lr=3e-3, schedule=topt.cosine_schedule(2, STEPS))
    update = jax.jit(lambda p, g, s: jopt.adamw_update(jopt_cfg, p, g, s))
    jpipe, tpipe = JPipe(jc.vocab_size, S, B, seed=0), TPipe(tc.vocab_size, S, B, seed=0)
    jp, js = params, jopt.adamw_init(params)
    tp = params_from_numpy(params, "cpu")
    ts = topt.adamw_init(tp)
    step = tsteps.make_train_step(tc, topt_cfg)
    for s in range(STEPS):
        (_, jm), jg = vg(jp, _ref_batch(jc, jpipe.batch(s)))
        jp, js, _ = update(jp, jg, js)
        tp, ts, tm = step(tp, ts, ttrain.make_batch(tc, tpipe, s, "cpu"))
        want = float(jm["loss"])  # the cross entropy (the moe's loss adds its aux terms)
        assert abs(float(tm["loss"]) - want) <= STEP_RTOL * abs(want), s
    assert int(ts["step"]) == int(js["step"]) == STEPS
