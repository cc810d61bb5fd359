"""DET006: host nondeterminism inside what a day replays.

A simulated day is a fixed program of device work, replayed from a CUDA
graph on the card (``engine/runner.py``) and re-run eagerly on every rank
of a mesh: any host value that enters it — a clock reading, an environment
variable, an object's ``id()``, a ``hash()`` (salted per process for
strings), the iteration order of a ``set``, a stdlib ``random`` draw —
makes the day differ from run to run, from rank to rank, or between the
captured graph and the eager loop. Flagged inside a replayed function:

  * calls to ``time.*``, ``datetime.*``, ``uuid.*``, ``random.*``,
    ``os.urandom``, ``os.getenv``/``os.getenvb``, ``secrets.*``;
  * reads of ``os.environ``;
  * the builtins ``id()`` and ``hash()``;
  * iteration over a ``set`` (a ``set(...)`` call, a set literal or
    comprehension, or a name whose every assignment is one), in ``for``
    loops and comprehensions.

A replayed function is every function of ``engine/day.py``,
``engine/topology.py``, ``core/{rng,disease,transmission,interventions,
interactions,exchange}.py``, ``kernels/interactions/*.py`` and
``api/observables.py`` (the observables update inside the loop); every
function named ``day_step``, ``*_day``/``run_days`` or ``*_kernel``; and
every function passed to ``DayRunner(...)``, the runner that captures a
day loop into a CUDA graph.
"""

from __future__ import annotations

import ast
import re

_REPLAYED_MODULES = (
    "engine/day.py", "engine/topology.py", "core/rng.py", "core/disease.py",
    "core/transmission.py", "core/interventions.py", "core/interactions.py",
    "core/exchange.py", "kernels/interactions/ops.py", "kernels/interactions/kernel.py",
    "kernels/interactions/ref.py", "api/observables.py",
)
_NAME_PATTERNS = re.compile(r"(^day_step$|^run_days$|_day$|^kernel$|_kernel$)")
_CLOCK_PREFIXES = ("time.", "datetime.", "uuid.", "random.", "secrets.")
_CLOCK_EXACT = {"os.urandom", "os.getenv", "os.getenvb", "random"}


def _captured_names(ctx) -> set:
    """Names of functions passed to ``DayRunner(...)`` in this module."""
    names = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            f = node.func
            callee = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if callee == "DayRunner" and node.args and isinstance(node.args[0], ast.Name):
                names.add(node.args[0].id)
    return names


def _is_set_expr(node: ast.AST, env: dict) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.Name) and env.get(node.id):
        return all(isinstance(v, (ast.Set, ast.SetComp)) or isinstance(v, ast.Call)
                   and isinstance(v.func, ast.Name) and v.func.id in ("set", "frozenset")
                   for v in env[node.id])
    return False


class HostNondetRule:
    code = "DET006"
    description = ("host nondeterminism (clock, environment, id/hash, set order, "
                   "random) inside what a day replays")

    def check(self, ctx):
        if ctx.tree is None:
            return
        whole = ctx.endswith(*_REPLAYED_MODULES)
        captured = _captured_names(ctx)
        seen = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            name = getattr(fn, "name", "<lambda>")
            if not (whole or _NAME_PATTERNS.search(name) or name in captured):
                continue
            yield from self._check_replayed(ctx, fn, name, seen)

    def _check_replayed(self, ctx, fn, name, seen):
        env = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                env.setdefault(node.targets[0].id, []).append(node.value)
        for node in ast.walk(fn):
            if id(node) in seen:  # a nested function of a replayed one
                continue
            msg = None
            if isinstance(node, ast.Call):
                resolved = ctx.imports.resolve(node.func)
                if resolved and (resolved in _CLOCK_EXACT
                                 or resolved.startswith(_CLOCK_PREFIXES)):
                    msg = f"'{resolved}()'"
                elif isinstance(node.func, ast.Name) and node.func.id in ("id", "hash") \
                        and node.func.id not in ctx.imports.aliases:
                    msg = f"'{node.func.id}()' (differs per process)"
            elif isinstance(node, ast.Attribute) and node.attr == "environ" \
                    and ctx.imports.resolve(node) == "os.environ":
                msg = "'os.environ'"
            elif isinstance(node, ast.For) and _is_set_expr(node.iter, env):
                msg = "iteration over a set (hash-seed dependent order; sort first)"
            elif isinstance(node, ast.comprehension) and _is_set_expr(node.iter, env):
                msg = "iteration over a set (hash-seed dependent order; sort first)"
            if msg is not None:
                seen.add(id(node))
                yield ctx.finding(self.code, node, f"{msg} inside replayed '{name}': the "
                                  "day would differ from run to run or rank to rank")
