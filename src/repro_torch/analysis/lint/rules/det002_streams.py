"""DET002: undeclared or reused counter-RNG stream ids.

Every random decision owns a declared stream constant in the port's
``core/rng.py`` (CONTACT, INFECT, ...), the reference's ids, since the two
packages draw the same numbers. Two decisions sharing one id silently
correlate their draws; an ad-hoc literal id is invisible to the registry
and can collide with a future stream. The rule (a) flags duplicate values
inside the registry itself and (b) checks that every draw call site passes
a declared constant in the stream slot.
"""

from __future__ import annotations

import ast
from collections import defaultdict

from repro_torch.analysis.lint.engine import parse_stream_registry

#: draw function -> index of the stream argument (first of ``*words``).
_DRAW_STREAM_ARG = {
    "uniform": 1,
    "uniform_plain": 1,
    "np_uniform": 1,
    "hash_u32": 1,
    "exponential": 2,  # (mean, seed, stream, ...)
    "categorical": 2,  # (cum_probs, seed, stream, ...)
}

_RNG_MODULE = "repro_torch.core.rng"


def _unwrap_int(node: ast.AST) -> ast.AST:
    """``int(rng.X)`` (the numpy-mirror idiom) -> ``rng.X``."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "int" and len(node.args) == 1):
        return node.args[0]
    return node


class StreamRegistryRule:
    code = "DET002"
    description = ("undeclared or reused RNG stream ids (call sites must pass a "
                   "constant declared in core/rng.py)")

    def check(self, ctx):
        if ctx.tree is None:
            return
        if ctx.is_rng_module or ctx.endswith(ctx.config.rng_module_suffix):
            # (a) the registry itself: one id per stream.
            by_value = defaultdict(list)
            for name, value in parse_stream_registry(ctx.tree).items():
                by_value[value].append(name)
            for value, names in sorted(by_value.items()):
                if len(names) > 1:
                    yield ctx.finding(self.code, ctx.tree,
                                      f"stream id {value:#x} reused by "
                                      f"{', '.join(sorted(names))}: every random decision "
                                      "needs its own stream")
            return

        # (b) call sites: the stream slot must be a declared constant.
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.imports.resolve(node.func)
            if not name or not name.startswith(_RNG_MODULE + "."):
                continue
            fn = name[len(_RNG_MODULE) + 1:]
            if fn not in _DRAW_STREAM_ARG:
                continue
            idx = _DRAW_STREAM_ARG[fn]
            if len(node.args) <= idx:
                yield ctx.finding(self.code, node, f"rng.{fn}() call with no stream "
                                  f"argument (expected a declared stream at position {idx})")
                continue
            stream = _unwrap_int(node.args[idx])
            const = (stream.attr if isinstance(stream, ast.Attribute)
                     else stream.id if isinstance(stream, ast.Name) else None)
            if const is None:
                yield ctx.finding(self.code, node, f"rng.{fn}() stream argument is not a "
                                  "declared constant (literal or computed ids are "
                                  "invisible to the core/rng.py registry)")
            elif ctx.streams and const not in ctx.streams:
                yield ctx.finding(self.code, node, f"rng.{fn}() uses undeclared stream "
                                  f"'{const}' (registry: {', '.join(sorted(ctx.streams))})")
