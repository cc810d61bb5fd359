"""End-to-end LM training driver in the port (the reference's
``repro/launch/train.py``, with its flags, defaults, log lines and JSON
fields).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --preset smoke --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --preset full --steps 30 --ckpt-dir /tmp/ckpt --ckpt-every 10 \
        --inject-failures 15

Any registered arch (reduced presets for the CPU), AdamW with the cosine
schedule, the deterministic synthetic token pipeline, checkpoint/restart
(restart-exact: a recovered run ends with the parameters and moments of
the uninterrupted run, bit for bit) and the fault-tolerant step loop with
injected failures (``--inject-failures``). It runs on the card unless
``--device cpu``; ``--set KEY=VALUE`` overrides a ``ModelConfig`` field
after the preset (as ``launch/serve.py``'s), e.g. ``attn_impl=flash``,
under which training attends through the chunked online softmax, as the
reference's does without a mesh.

``--grad-compression`` is accepted and has no effect, as in the reference,
whose ``train_step`` never reads it (ROADMAP queue 3, "Faults in the
reference").

Parameters are drawn from ``torch.Generator`` seeded with ``--seed``, so
their values differ from the reference's ``jax.random`` draw; a caller may
pass its own (e.g. the reference's, through
``models.base.params_from_numpy``) to :func:`train`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.engine.core import resolve_device
from repro_torch.launch.serve import parse_overrides
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.runtime import FaultConfig, FaultTolerantLoop

#: The reference's final JSON fields, in its order.
RESULT_FIELDS = ("arch", "steps", "wall_s", "first_loss", "final_loss", "restarts",
                 "checkpoints")


def build_cfg(args):
    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = reduced_config(cfg)
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
    elif args.preset == "small100m":
        # ~100M-class config in the same family (example driver target)
        cfg = dataclasses.replace(
            cfg, num_layers=min(cfg.num_layers, 8), d_model=512,
            num_heads=8, num_kv_heads=max(1, min(cfg.num_kv_heads, 4)),
            head_dim=64, d_ff=2048, vocab_size=min(cfg.vocab_size, 32768),
            num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
            compute_dtype="float32",
        )
    return dataclasses.replace(cfg, **parse_overrides(args.set))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "small100m", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failures", default="",
                    help="comma-separated steps at which to simulate a crash")
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8"],
                    help="accepted and unused, as in the reference")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig overrides, e.g. --set attn_impl=flash")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; the CPU only on request)")
    return ap.parse_args(argv)


def make_batch(cfg, pipe: TokenPipeline, step: int, device) -> dict:
    """The batch of ``step``: the pipeline's tokens; audio adds zero frames,
    vlm zero patch embeddings before the first ``seq - num_patches`` tokens
    (the reference's stubs)."""
    toks = torch.as_tensor(pipe.batch(step), device=device).long()
    B, S = toks.shape
    if cfg.family == "audio":
        return {"tokens": toks,
                "frames": torch.zeros((B, cfg.enc_frames, cfg.d_model), dtype=torch.float32,
                                      device=device)}
    if cfg.family == "vlm":
        return {"tokens": toks[:, : S - cfg.num_patches],
                "patch_embeds": torch.zeros((B, cfg.num_patches, cfg.d_model),
                                            dtype=torch.float32, device=device)}
    return {"tokens": toks}


def train(cfg, args, params=None):
    """Train ``cfg`` as ``args`` (see :func:`parse_args`) says. ``params``
    (float32, on ``args.device``) replaces the seeded draw. Returns
    (params, opt_state, result): ``result`` holds the reference's JSON
    fields (:data:`RESULT_FIELDS`); ``losses``, the logged (step, loss)
    pairs in the order they were logged (a replayed step logs again);
    ``metrics``, the last step's metrics as floats; and ``step_s``, the host
    seconds of each step call in order (a logged step's ends in the
    synchronising read of its loss, so with ``--log-every 1`` each is the
    step's wall time)."""
    device = resolve_device(args.device)
    print(f"arch={cfg.name} params={M.param_count(cfg):,}")
    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    opt_cfg = AdamWConfig(lr=args.lr, schedule=cosine_schedule(20, args.steps))
    if params is None:
        # detlint: ignore[DET001] — the random weights' seeded generator
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = M.init_params(cfg, gen, device, max_target_positions=args.seq + 8)
    opt_state = adamw_init(params)
    train_step = make_train_step(cfg, opt_cfg)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if args.resume and mgr and mgr.latest_step() is not None:
        start = mgr.latest_step()
        restored = mgr.restore({"params": params, "opt": opt_state}, start)
        params, opt_state = restored["params"], restored["opt"]
        print(f"resumed from step {start}")

    inject = {int(s) for s in args.inject_failures.split(",") if s}
    injected = set()
    holder = {"params": params, "opt": opt_state, "losses": []}

    def step_fn(step):
        if step in inject and step not in injected:
            injected.add(step)
            raise RuntimeError(f"injected failure at step {step}")
        batch = make_batch(cfg, pipe, step, device)
        holder["params"], holder["opt"], metrics = train_step(
            holder["params"], holder["opt"], batch)
        holder["metrics"] = metrics
        if step % args.log_every == 0:
            loss = float(metrics["loss"])
            holder["losses"].append((step, loss))
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        return step + 1

    def save_fn(step, _):
        if mgr:
            mgr.save(step, {"params": holder["params"], "opt": holder["opt"]})

    def restore_fn():
        if mgr is None:
            raise RuntimeError("failure injected but no --ckpt-dir for recovery")
        step = mgr.latest_step() or 0
        if mgr.latest_step() is not None:
            restored = mgr.restore({"params": holder["params"], "opt": holder["opt"]}, step)
            holder["params"], holder["opt"] = restored["params"], restored["opt"]
        print(f"[recovery] restored step {step}", flush=True)
        return step, step

    if mgr:
        mgr.save(0, {"params": params, "opt": opt_state}, blocking=True)
    loop = FaultTolerantLoop(
        step_fn, save_fn, restore_fn,
        FaultConfig(checkpoint_interval=args.ckpt_every, max_restarts=8),
    )
    t0 = time.time()
    loop.run(start, start, args.steps - start)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    if mgr:
        mgr.wait()
    losses = holder["losses"]
    result = {
        "arch": cfg.name, "steps": args.steps, "wall_s": round(wall, 1),
        "first_loss": losses[0][1] if losses else None,
        "final_loss": losses[-1][1] if losses else None,
        "restarts": loop.stats.restarts,
        "checkpoints": loop.stats.checkpoints,
        "losses": losses,
        "metrics": {k: float(v) for k, v in holder.get("metrics", {}).items()},
        "step_s": list(loop.stats.step_times),
    }
    return holder["params"], holder["opt"], result


def main(argv=None):
    args = parse_args(argv)
    _, _, result = train(build_cfg(args), args)
    print(json.dumps({k: result[k] for k in RESULT_FIELDS}))


if __name__ == "__main__":
    main()
