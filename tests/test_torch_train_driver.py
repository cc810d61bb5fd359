"""The port's training machinery on the CPU, without the reference: remat,
the training attention route, and the driver ``launch/train.py``.

- The three remat policies ("nothing", "dots", "none") give bitwise-equal
  losses and gradients for every family, and remat really recomputes: a
  layer body runs twice per training step under "nothing" and "dots"
  (forward, then recomputed in the backward), once under "none" and once
  without grad mode, on the reference's boundaries (each layer; each
  whole (rec, rec, attn) cycle of the hybrid, not its remainder; each
  encoder and decoder layer of the audio family).
- ``attn_impl="flash"`` in ``forward_train`` attends through the chunked
  online softmax, so loss and gradients are bitwise ``attn_impl="chunked"``'s,
  and ``flash_attention`` raises under autograd (the kernel is
  forward-only), on the CPU as on the card.
- ``train()`` with injected failures recovers to parameters and moments
  bitwise equal to the uninterrupted run's; a resumed run too; the CLI
  prints the reference's JSON fields; ``--grad-compression`` has no effect,
  as in the reference.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import steps
from repro_torch.launch import train as T
from repro_torch.models import attention, encdec, transformer
from repro_torch.models import model as M
from repro_torch.models.base import tree_leaves

FAMILIES = {"dense": "smollm-360m", "moe": "mixtral-8x7b", "vlm": "llava-next-mistral-7b",
            "ssm": "mamba2-130m", "hybrid": "recurrentgemma-9b", "audio": "whisper-base"}
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These steps are small: one intra-op thread runs them fastest, and
    keeps the file from oversubscribing the cores beside other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, **kw):
    return dataclasses.replace(tcfg.reduced_config(tcfg.ARCHS[name]), compute_dtype="float32",
                               **kw)


def _setup(name, seed=0, **kw):
    cfg = _cfg(name, **kw)
    # detlint: ignore[DET001] — seeded test weights
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu",
                           max_target_positions=64)
    pipe = TokenPipeline(cfg.vocab_size, S, B, seed=seed)
    batch = T.make_batch(cfg, pipe, 0, "cpu")
    if cfg.family in ("vlm", "audio"):  # non-zero stand-ins for the stubs
        key = "patch_embeds" if cfg.family == "vlm" else "frames"
        rs = np.random.default_rng(seed)
        batch[key] = torch.as_tensor(rs.standard_normal(batch[key].shape).astype(np.float32))
    return cfg, params, batch


def _same(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_policies_are_bitwise_equal(family):
    out = {}
    for policy in ("nothing", "dots", "none"):
        cfg, params, batch = _setup(FAMILIES[family], remat_policy=policy)
        loss, metrics, grads = steps.loss_and_grads(cfg, params, batch)
        out[policy] = (loss, metrics, grads)
    ref = out["none"]
    for policy in ("nothing", "dots"):
        loss, metrics, grads = out[policy]
        assert torch.equal(loss, ref[0]), policy
        assert all(torch.equal(metrics[k], ref[1][k]) for k in ref[1]), policy
        assert _same(grads, ref[2]), policy


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(torch.is_grad_enabled())
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


# (module, layer function, its calls per forward at reduced_config)
BODIES = {"dense": (transformer, "attn_block", 4), "moe": (transformer, "attn_block", 4),
          "ssm": (transformer, "ssd_block", 4),
          # one (rec, rec, attn) cycle and a remainder rec layer: the cycle's
          # two recs are recomputed, the remainder's is not
          "hybrid": (transformer, "rec_block", 3),
          "audio": (encdec, "_dec_layer", 4)}


@pytest.mark.parametrize("family", sorted(BODIES))
@pytest.mark.parametrize("policy", ["nothing", "dots", "none"])
def test_remat_recomputes_each_layer_in_the_backward(monkeypatch, family, policy):
    module, name, per_forward = BODIES[family]
    calls = _count_calls(monkeypatch, module, name)
    cfg, params, batch = _setup(FAMILIES[family], remat_policy=policy)
    steps.loss_and_grads(cfg, params, batch)
    if policy == "none":
        want = per_forward
    elif family == "hybrid":
        want = per_forward + 2  # the cycle's two rec layers, again
    else:
        want = 2 * per_forward
    assert len(calls) == want
    calls.clear()
    with torch.no_grad():
        M.forward_prefill(cfg, params, batch)
    assert len(calls) == per_forward  # no remat without grad mode


def test_audio_encoder_layers_are_rematerialised(monkeypatch):
    calls = _count_calls(monkeypatch, encdec, "_enc_layer")
    cfg, params, batch = _setup("whisper-base")
    steps.loss_and_grads(cfg, params, batch)
    assert len(calls) == 2 * cfg.enc_layers


@pytest.mark.parametrize("family", ["dense", "moe", "vlm", "hybrid"])
def test_flash_trains_through_the_chunked_softmax(family):
    out = {}
    for impl in ("flash", "chunked"):
        cfg, params, batch = _setup(FAMILIES[family], attn_impl=impl)
        out[impl] = steps.loss_and_grads(cfg, params, batch)
    assert torch.equal(out["flash"][0], out["chunked"][0])
    assert _same(out["flash"][2], out["chunked"][2])


def test_audio_flash_trains_its_causal_self_attention_chunked(monkeypatch):
    """The audio family's flash route covers only the decoder's causal
    self-attention (encoder and cross-attention attend in full under
    "flash", as in the reference), so a training forward attends there
    through the chunked softmax: once per decoder layer, again in its
    recompute, and never through the kernel."""
    chunked = []
    orig = attention.attend_chunked
    monkeypatch.setattr(attention, "attend_chunked",
                        lambda *a, **k: chunked.append(k["causal"]) or orig(*a, **k))
    flash = _count_calls(monkeypatch, encdec, "flash_attention")
    cfg, params, batch = _setup("whisper-base", attn_impl="flash")
    steps.loss_and_grads(cfg, params, batch)
    assert chunked == [True] * (2 * cfg.num_layers) and not flash


def test_flash_attention_raises_under_autograd():
    rs = np.random.default_rng(0)
    q = torch.as_tensor(rs.standard_normal((1, 16, 2, 2, 8)).astype(np.float32))
    k = torch.as_tensor(rs.standard_normal((1, 16, 2, 8)).astype(np.float32))
    v = torch.as_tensor(rs.standard_normal((1, 16, 2, 8)).astype(np.float32))
    out = flash_attention(q, k, v)  # nothing requires grad: the forward runs
    with torch.no_grad():
        assert torch.equal(flash_attention(q.requires_grad_(), k, v), out)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q, k, v)


@pytest.mark.parametrize("module", [attention, encdec])
def test_prefill_keeps_the_flash_route(monkeypatch, module):
    """Prefill keeps the kernel's route under attn_impl="flash" (its plain
    version on the CPU); only a training forward takes the chunked one."""
    cfg, params, batch = _setup("smollm-360m" if module is attention else "whisper-base",
                                attn_impl="flash")
    calls = _count_calls(monkeypatch, module, "flash_attention")
    with torch.no_grad():
        M.forward_prefill(cfg, params, batch)
    assert len(calls) == cfg.num_layers  # one per (decoder) self-attention layer
    steps.loss_and_grads(cfg, params, batch)
    assert len(calls) == cfg.num_layers


def _args(*extra):
    return T.parse_args(["--device", "cpu", "--preset", "smoke", "--batch", str(B), "--seq",
                         str(S), "--log-every", "1", *extra])


def _run(args):
    return T.train(T.build_cfg(args), args)


@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x7b"])
def test_injected_failures_recover_bitwise(tmp_path, arch):
    base = ("--arch", arch, "--steps", "8")
    p0, o0, r0 = _run(_args(*base))
    p1, o1, r1 = _run(_args(*base, "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
                            "--inject-failures", "4,7"))
    assert r0["restarts"] == 0 and r1["restarts"] == 2
    assert _same(p0, p1) and _same(o0, o1)
    assert int(o1["step"]) == 8
    assert dict(r1["losses"]) == dict(r0["losses"])
    assert [s for s, _ in r1["losses"]] == [0, 1, 2, 3, 3, 4, 5, 6, 6, 7]


def test_resume_continues_bitwise(tmp_path):
    p0, o0, _ = _run(_args("--steps", "6"))
    _run(_args("--steps", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"))
    p1, o1, r1 = _run(_args("--steps", "6", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                            "--resume"))
    assert [s for s, _ in r1["losses"]] == [4, 5]
    assert _same(p0, p1) and _same(o0, o1)


def test_grad_compression_has_no_effect():
    _, _, a = _run(_args("--steps", "2"))
    _, _, b = _run(_args("--steps", "2", "--grad-compression", "int8"))
    assert a["losses"] == b["losses"]


def test_cli_prints_the_reference_fields(capsys):
    T.main(["--device", "cpu", "--preset", "smoke", "--steps", "3", "--batch", "2", "--seq",
            "32", "--log-every", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch=smollm-360m-smoke params={M.param_count(_cfg('smollm-360m')):,}"
    assert [ln.split()[:2] for ln in lines[1:4]] == [["step", str(s)] for s in range(3)]
    out = json.loads(lines[-1])
    assert list(out) == ["arch", "steps", "wall_s", "first_loss", "final_loss", "restarts",
                         "checkpoints"]
    assert out["arch"] == "smollm-360m-smoke" and out["steps"] == 3
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["final_loss"])
    assert out["restarts"] == 0 and out["checkpoints"] == 0


def test_cli_set_overrides_after_the_preset():
    cfg = T.build_cfg(T.parse_args(["--preset", "full", "--set", "num_layers=3", "--set",
                                    "attn_impl=flash"]))
    assert cfg.num_layers == 3 and cfg.attn_impl == "flash"
    assert cfg.d_model == tcfg.ARCHS["smollm-360m"].d_model
    assert cfg.compute_dtype == "bfloat16"


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_make_batch_builds_the_reference_stubs(family):
    cfg = _cfg(FAMILIES[family])
    batch = T.make_batch(cfg, TokenPipeline(cfg.vocab_size, S, B, 0), 3, "cpu")
    if family == "vlm":
        assert batch["tokens"].shape == (B, S - cfg.num_patches)
        assert batch["patch_embeds"].shape == (B, cfg.num_patches, cfg.d_model)
        assert not batch["patch_embeds"].any()
    else:
        assert batch["tokens"].shape == (B, S)
        assert batch["frames"].shape == (B, cfg.enc_frames, cfg.d_model)
        assert not batch["frames"].any()


def test_train_asks_for_the_card_unless_told():
    args = T.parse_args(["--preset", "smoke", "--steps", "1"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.train(T.build_cfg(args), args)
