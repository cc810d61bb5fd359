"""LM token serving in the port: prefill a batch of prompts, then
decode greedily with the ring-buffer KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --preset full --batch 8 --prompt-len 512 --gen 32 --set attn_impl=flash
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

The reference's ``repro/launch/serve.py`` with its flags, its defaults and
its JSON fields, on the card unless ``--device cpu``; ``--set KEY=VALUE``
overrides a ``ModelConfig`` field (the reference's ``launch/dryrun.py``
idiom), e.g. ``attn_impl=flash`` for the flash-attention kernel in prefill.

:func:`serve` is the session: it times one prefill, then (as the reference
does) discards the prefill's cache, allocates a fresh bf16 cache for
``prompt_len + gen`` positions, replays the prompt through decode steps one
position at a time and decodes ``gen`` tokens greedily. The replay feeds
prompt token ``t`` at position ``t`` for every ``t < prompt_len``, so its
logits at ``prompt_len - 1`` are the prefill's last-position logits up to
rounding. (The reference's loop feeds token ``prompt_len - 2`` a second time
at position ``prompt_len - 1``; see ROADMAP queue 3.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import ModelConfig, get_config, reduced_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.engine.core import resolve_device
from repro_torch.launch import steps
from repro_torch.models import model as M


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray  # (B, gen) int32, the greedy generation
    prefill_logits: torch.Tensor  # (B, 1, V), the prefill's last position
    replay_logits: torch.Tensor | None  # (B, 1, V) at prompt_len - 1 (None if gen == 0)
    prefill_s: float
    decode_s: float  # the replay and the generation: prompt_len + gen - 1 steps
    decode_steps: int


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, prompts, gen: int, *, device="cuda") -> ServeResult:
    """Serve ``prompts`` ((B, prompt_len) integer tokens) with ``params``:
    one prefill, then the replay and ``gen`` greedy tokens. ``params`` are
    cast to the compute dtype once for the session."""
    device = resolve_device(device)
    prompts = torch.as_tensor(prompts, device=device).long()
    B, P = prompts.shape
    if P < 1 or gen < 0:
        raise ValueError(f"need prompt_len >= 1 and gen >= 0, got {P} and {gen}")
    total = P + gen
    with torch.no_grad():
        p = M.prepare(cfg, params)
        prefill = steps.make_prefill_step(cfg)
        _sync(device)
        t0 = time.perf_counter()
        prefill_logits, _ = prefill(p, {"tokens": prompts})
        _sync(device)
        t_prefill = time.perf_counter() - t0

        cache = M.init_cache(cfg, B, total, device=device)
        out, replay_logits = [], None
        t0 = time.perf_counter()
        for pos in range(total - 1):
            if pos < P:
                tok = prompts[:, pos:pos + 1]
            logits, cache = M.decode_step(cfg, p, cache, tok, pos)
            if pos >= P - 1:
                if pos == P - 1:
                    replay_logits = logits
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                out.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
    tokens = (torch.cat(out, dim=1).to(torch.int32).cpu().numpy() if out
              else np.zeros((B, 0), np.int32))
    return ServeResult(tokens, prefill_logits, replay_logits, t_prefill, t_decode,
                       total - 1)


def summary(cfg, res: ServeResult) -> dict:
    """The reference's JSON fields."""
    gen = res.tokens
    return {
        "arch": cfg.name,
        "batch": int(gen.shape[0]),
        "prefill_s": round(res.prefill_s, 3),
        "decode_s": round(res.decode_s, 3),
        "tokens_generated": int(gen.size),
        "tokens_per_s": round(gen.size / max(res.decode_s, 1e-9), 1),
        "sample_generation": gen[0][:16].tolist(),
    }


def parse_overrides(pairs) -> dict:
    """``KEY=VALUE`` strings as ModelConfig overrides; a value is an int or
    a float where it parses as one, else a string."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    out = {}
    for kv in pairs:
        k, sep, v = kv.partition("=")
        if not sep or k not in fields:
            raise SystemExit(f"error: --set {kv!r}: expected KEY=VALUE with KEY a "
                             "ModelConfig field")
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig overrides, e.g. --set attn_impl=flash")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; the CPU only on request)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = dataclasses.replace(reduced_config(cfg), compute_dtype="float32")
    cfg = dataclasses.replace(cfg, **parse_overrides(args.set))
    device = resolve_device(args.device)
    # detlint: ignore[DET001] — the random weights' seeded generator
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device)
    prompts = TokenPipeline(cfg.vocab_size, args.prompt_len, args.batch, args.seed).batch(0)
    res = serve(cfg, params, prompts, args.gen, device=device)
    print(json.dumps(summary(cfg, res)))


if __name__ == "__main__":
    main()
