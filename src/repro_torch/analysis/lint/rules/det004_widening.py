"""DET004: integer sums narrowed before they cross a collective.

The reference's contacts bug: per-visit contact counts summed to int32 and
all-reduced across workers — at paper scale the global sum wraps within one
day, and it wraps *differently per mesh shape*, silently breaking the
bitwise contract. In torch an integer ``.sum()`` is int64 unless narrowed,
so the rule looks for the narrowing: for every operand of a
``torch.distributed`` ``all_reduce``/``all_gather``/``all_gather_into_tensor``/
``all_to_all_single``/``reduce_scatter_tensor`` (and of the topologies'
counted ``psum``/``all_gather``/``all_to_all``), find the ``.sum()`` /
``torch.sum(...)`` feeding it — in the operand or, one level back, in the
local assignments of a name operand — and classify the summed source:

  * a **bool mask** (comparison / mask algebra / bool dtype) — its sum is
    bounded by the shard width, any width is safe;
  * anything else — the sum is unbounded, and a ``sum(dtype=<32-bit or
    narrower int>)``, or a ``.to(...)``/``.type(...)``/``.int()``/
    ``.short()`` to such a dtype on the way to the collective, is flagged.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.lint.engine import is_boolish, local_assignments

#: torch.distributed collective -> index of the tensor it sends
_DIST_OPERAND = {"all_reduce": 0, "all_gather": 1, "all_gather_into_tensor": 1,
                 "all_to_all_single": 1, "reduce_scatter_tensor": 1}
#: the topologies' counted wrappers (engine/topology.py): operand first
_WRAPPERS = {"psum", "all_gather", "all_to_all"}
_NARROW = {"int32", "uint32", "int16", "uint16", "int8", "uint8", "int", "short"}


def _narrow(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute):
        return node.attr in _NARROW
    return isinstance(node, ast.Name) and node.id in _NARROW


def _is_sum(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "sum")


def _sum_source(node: ast.Call) -> ast.AST:
    """The summed expression: ``x.sum()`` -> x, ``torch.sum(x)`` -> x."""
    obj = node.func.value
    if isinstance(obj, ast.Name) and obj.id == "torch" and node.args:
        return node.args[0]
    return obj


def _narrowing(operand: ast.AST, sum_call: ast.Call):
    """The narrowing applied to ``sum_call`` inside ``operand``, or None:
    ``sum(dtype=X)``, or ``.to(X)`` / ``.type(X)`` / ``.int()`` / ``.short()``
    taken of it."""
    for kw in sum_call.keywords:
        if kw.arg == "dtype" and _narrow(kw.value):
            return kw.value
    for node in ast.walk(operand):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.value is sum_call):
            continue
        attr = node.func.attr
        if attr in ("int", "short") and not node.args:
            return node.func
        if attr in ("to", "type") and node.args and _narrow(node.args[0]):
            return node.args[0]
        if attr in ("to", "type") and any(kw.arg == "dtype" and _narrow(kw.value)
                                          for kw in node.keywords):
            return node.func
    return None


class WideningRule:
    code = "DET004"
    description = ("integer .sum() narrowed to 32 bits or fewer before a "
                   "torch.distributed collective (wraps across workers at scale)")

    def _operands(self, ctx, node, env):
        """The expressions a collective call sends: its operand, and the
        local assignments of a name operand (one level)."""
        if not isinstance(node, ast.Call):
            return []
        f = node.func
        name = ctx.imports.resolve(f) or ""
        idx = None
        if name.startswith("torch.distributed."):
            idx = _DIST_OPERAND.get(name.rsplit(".", 1)[1])
        elif isinstance(f, ast.Attribute) and f.attr in _WRAPPERS:
            idx = 0
        if idx is None or len(node.args) <= idx:
            return []
        op = node.args[idx]
        out = [op]
        if isinstance(op, ast.Name):
            out += env.get(op.id, [])
        return out

    def _check(self, ctx, call, operand, env):
        for node in ast.walk(operand):
            if not _is_sum(node):
                continue
            src = _sum_source(node)
            if is_boolish(src, env):
                continue  # bounded by the shard width
            if _narrowing(operand, node) is not None:
                yield ctx.finding(self.code, call,
                                  "unbounded .sum() is narrowed to a 32-bit-or-narrower "
                                  "int before a collective: keep it int64 (torch's "
                                  "integer sum) across workers")

    def check(self, ctx):
        if ctx.tree is None:
            return
        covered = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            env = local_assignments(fn)
            for node in ast.walk(fn):
                if id(node) in covered:
                    continue
                ops = self._operands(ctx, node, env)
                if ops:
                    covered.add(id(node))
                for op in ops:
                    yield from self._check(ctx, node, op, env)
        env = local_assignments(ctx.tree)
        for node in ast.walk(ctx.tree):
            if id(node) not in covered:
                for op in self._operands(ctx, node, env):
                    yield from self._check(ctx, node, op, env)
