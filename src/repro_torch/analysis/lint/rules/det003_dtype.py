"""DET003: constructors whose dtype follows ``torch.get_default_dtype()``.

``torch.zeros(n)`` is float32 only while nobody has called
``torch.set_default_dtype(torch.float64)``; one such call anywhere in the
process (a library, a notebook cell, a test) turns every unpinned
constructor into float64, and a float64 value meeting float32 state
changes either the state's dtype (promotion) or its rounding — the port's
form of the reference's ``JAX_ENABLE_X64`` promotion class. Flagged:

  * ``torch.zeros/ones/empty/full/eye/linspace/logspace/empty_strided/
    scalar_tensor`` without ``dtype=``;
  * ``torch.tensor``/``torch.as_tensor`` of Python literals holding a
    float, without ``dtype=`` (a numpy array or another tensor brings its
    own dtype);
  * ``torch.arange`` with a float literal argument and no ``dtype=``.
    ``torch.arange`` of ints is int64 whatever the default, so not a
    finding; neither are the ``*_like`` and ``Tensor.new_*`` forms, which
    follow their input.

Pinning is mechanical: pass ``dtype=``.
"""

from __future__ import annotations

import ast

_CONSTRUCTORS = {"zeros", "ones", "empty", "full", "eye", "linspace", "logspace",
                 "empty_strided", "scalar_tensor"}


def _has_dtype(node: ast.Call) -> bool:
    return any(kw.arg == "dtype" for kw in node.keywords)


def _literal_has_float(node: ast.AST) -> bool:
    """True if ``node`` is built only of numeric literals (negated, combined,
    in lists or tuples) and one of them is a float."""
    saw_float = False
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant):
            if isinstance(sub.value, float):
                saw_float = True
            elif not isinstance(sub.value, (int, bool)):
                return False
        elif not isinstance(sub, (ast.UnaryOp, ast.BinOp, ast.operator, ast.unaryop,
                                  ast.Tuple, ast.List, ast.expr_context)):
            return False
    return saw_float


class DefaultDtypeRule:
    code = "DET003"
    description = ("torch constructor without dtype= whose dtype follows "
                   "torch.get_default_dtype() (float64 after set_default_dtype)")

    def check(self, ctx):
        if ctx.tree is None:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or _has_dtype(node):
                continue
            name = ctx.imports.resolve(node.func)
            if not name or not name.startswith("torch.") or name.count(".") != 1:
                continue
            fn = name[len("torch."):]
            if fn in _CONSTRUCTORS:
                yield ctx.finding(self.code, node, f"torch.{fn}() without dtype=: its "
                                  "dtype follows torch.get_default_dtype() — pin it")
            elif fn in ("tensor", "as_tensor") and node.args \
                    and _literal_has_float(node.args[0]):
                yield ctx.finding(self.code, node, f"torch.{fn}(<float literal>) without "
                                  "dtype=: its dtype follows torch.get_default_dtype()")
            elif fn == "arange" and any(_literal_has_float(a) for a in node.args):
                yield ctx.finding(self.code, node, "torch.arange() with a float argument "
                                  "and no dtype=: its dtype follows "
                                  "torch.get_default_dtype()")
