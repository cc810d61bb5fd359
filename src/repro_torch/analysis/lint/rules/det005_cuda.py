"""DET005: the CUDA kernels and their launchers keep the bitwise contract.

The reference's DET005 (Pallas output refs written only under ``pl.when``,
flushing undefined VMEM) encodes one class: a kernel whose result depends
on something other than its inputs. On Hopper that class has four forms,
each checked here:

  * **uninitialised outputs** — a launcher module (one that builds or loads
    a kernel library: it imports ``repro_torch.kernels.build`` or
    ``ctypes``) allocates with ``torch.empty``/``empty_like``/
    ``empty_strided``/``Tensor.new_empty``: what the kernel leaves unwritten
    is whatever the allocator held. Zero it (``torch.zeros``) or, where the
    kernel writes every element, say which kernel does in a pragma;
  * **float atomics** (``*.cu``) — ``atomicAdd``/``Sub``/``Exch``/``Max``/
    ``Min`` on a ``float``/``double``/``__half``/``__nv_bfloat16`` address or
    value, or an ``atomicCAS`` loop over float bits (``__float_as_uint``
    and kin nearby): the order of the additions, and so the rounding,
    changes from run to run. Integer atomics are exact and allowed;
  * **fast-math intrinsics** (``*.cu``) — ``__expf``, ``__logf``,
    ``__fdividef``, ``__powf``, ``__sinf`` and kin are approximations whose
    results differ from the plain version's ``exp``/``log``;
  * **compile flags** — a fast-math flag (``--use_fast_math``,
    ``--ftz=true``, ``--prec-div=false``, ``--prec-sqrt=false``,
    ``--fmad=true``) in a ``*FLAGS*`` assignment or a build call, and a
    ``repro_torch.kernels.build.build`` call whose flags lack
    ``--fmad=false``: contracting ``a * b + c`` into one FMA rounds once
    where the plain version rounds twice.
"""

from __future__ import annotations

import ast
import re

_FAST_INTRINSICS = re.compile(
    r"\b(__expf|__exp10f|__logf|__log2f|__log10f|__fdividef|__powf|__sinf|__cosf|"
    r"__tanf|__sincosf)\s*\(")
_ATOMIC = re.compile(r"\batomic(Add|Sub|Exch|Max|Min)(_block|_system)?\s*\(")
_CAS = re.compile(r"\batomicCAS(_block|_system)?\s*\(")
_FLOAT_BITS = re.compile(
    r"\b__(float_as_u?int|u?int_as_float|double_as_longlong|longlong_as_double|"
    r"half_as_u?short|u?short_as_half|bfloat16_as_u?short|u?short_as_bfloat16)\s*\(")
_FLOAT_TYPES = r"(?:float|double|__half|half|__half2|__nv_bfloat16|__nv_bfloat162|nv_bfloat16)"
_FLOAT_DECL = re.compile(
    rf"\b{_FLOAT_TYPES}\b(?:\s*(?:const|__restrict__|volatile)\b|\s*[*&])*\s*(\w+)")
_FLOAT_LITERAL = re.compile(r"(?<![\w.])(\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?f\b|"
                            r"(?<![\w.])\d+\.\d*(?:[eE][-+]?\d+)?(?!\w)|"
                            rf"\(\s*{_FLOAT_TYPES}\s*\)")
_FAST_MATH_SWITCHES = ("--use_fast_math", "-use_fast_math", "--ftz=true", "-ftz=true",
               "--prec-div=false", "-prec-div=false", "--prec-sqrt=false",
               "-prec-sqrt=false", "--fmad=true", "-fmad=true", "-ffast-math")
_UNINITIALISED = {"torch.empty", "torch.empty_like", "torch.empty_strided"}
_BUILD = "repro_torch.kernels.build.build"


def _code_only(source: str) -> list:
    """The source's lines with comments and string literals blanked (line
    numbers kept)."""
    i, n, buf = 0, len(source), []
    mode = None  # None, "line", "block", '"', "'"
    while i < n:
        c = source[i]
        nxt = source[i + 1] if i + 1 < n else ""
        if mode is None:
            if c == "/" and nxt == "/":
                mode, i = "line", i + 2
                buf.append("  ")
                continue
            if c == "/" and nxt == "*":
                mode, i = "block", i + 2
                buf.append("  ")
                continue
            if c in "\"'":
                mode = c
            buf.append(c)
        elif mode == "line":
            if c == "\n":
                mode = None
                buf.append(c)
            else:
                buf.append(" ")
        elif mode == "block":
            if c == "*" and nxt == "/":
                mode, i = None, i + 2
                buf.append("  ")
                continue
            buf.append("\n" if c == "\n" else " ")
        else:  # inside a string or char literal
            if c == "\\":
                buf.append("  ")
                i += 2
                continue
            if c == mode:
                mode = None
                buf.append(c)
            else:
                buf.append("\n" if c == "\n" else " ")
        i += 1
    return "".join(buf).split("\n")


def _call_args(text: str, start: int) -> list:
    """The top-level comma-separated arguments of the call whose ``(`` is at
    ``text[start]``."""
    depth, args, cur = 0, [], []
    for c in text[start:]:
        if c in "([{":
            depth += 1
            if depth == 1:
                continue
        elif c in ")]}":
            depth -= 1
            if depth == 0:
                args.append("".join(cur).strip())
                return args
        elif c == "," and depth == 1:
            args.append("".join(cur).strip())
            cur = []
            continue
        cur.append(c)
    return args


def _base_name(expr: str):
    """The identifier an address expression points into: ``&acc[i]`` ->
    ``acc``, ``a.edges + s`` -> ``edges``."""
    m = re.match(r"[\s&(]*(?:\(\s*[\w\s*]+\)\s*)?([\w.>-]+)", expr)
    if not m:
        return None
    return re.split(r"\.|->", m.group(1))[-1]


def _flag_strings(ctx, tree):
    """The string constants that can reach ``nvcc``: those in the value of an
    assignment to a ``*FLAGS*`` name, and those passed to
    ``repro_torch.kernels.build.build``."""
    for node in ast.walk(tree):
        values = []
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if any(isinstance(t, ast.Name) and "FLAGS" in t.id.upper() for t in targets):
                values = [node.value]
        elif isinstance(node, ast.Call) and ctx.imports.resolve(node.func) == _BUILD:
            values = node.args[1:]
        for v in values:
            for c in ast.walk(v):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    yield c


class CudaDeterminismRule:
    code = "DET005"
    description = ("CUDA: float atomics, fast-math intrinsics or flags, builds "
                   "without --fmad=false, kernel outputs allocated uninitialised")

    def check(self, ctx):
        if ctx.language == "cuda":
            yield from self._check_cuda(ctx)
        else:
            yield from self._check_python(ctx)

    # -- CUDA sources -----------------------------------------------------
    def _check_cuda(self, ctx):
        lines = _code_only(ctx.source)
        text = "\n".join(lines)
        floats = {m.group(1) for m in _FLOAT_DECL.finditer(text)}
        line_of = lambda pos: text.count("\n", 0, pos) + 1
        for m in _FAST_INTRINSICS.finditer(text):
            yield ctx.finding(self.code, (line_of(m.start()), 0),
                              f"fast-math intrinsic {m.group(1)}(): an approximation the "
                              "plain version does not make — use the correctly rounded "
                              "function")
        for m in _ATOMIC.finditer(text):
            args = _call_args(text, m.end() - 1)
            addr = args[0] if args else ""
            val = args[1] if len(args) > 1 else ""
            base = _base_name(addr)
            if (re.search(rf"\(\s*(?:const\s+)?{_FLOAT_TYPES}\s*\*", addr)
                    or base in floats or _FLOAT_LITERAL.search(val)
                    or val.strip() in floats):
                yield ctx.finding(self.code, (line_of(m.start()), 0),
                                  f"float atomic{m.group(1)} on '{base}': the order of "
                                  "the updates, and so the rounding, varies from run to "
                                  "run — reduce in a fixed order")
        for m in _CAS.finditer(text):
            ln = line_of(m.start())
            near = "\n".join(lines[max(0, ln - 20):ln + 20])
            if _FLOAT_BITS.search(near):
                yield ctx.finding(self.code, (ln, 0),
                                  "atomicCAS loop over float bits: a float atomic in "
                                  "disguise, with a run-to-run order of updates")

    # -- Python launchers and flags ----------------------------------------
    def _check_python(self, ctx):
        tree = ctx.tree
        for node in _flag_strings(ctx, tree):
            if node.value.strip() in _FAST_MATH_SWITCHES:
                yield ctx.finding(self.code, node, f"fast-math compile flag "
                                  f"'{node.value.strip()}': results would differ from the "
                                  "plain version's")
        launcher = any(
            isinstance(n, ast.Import) and any(a.name in ("ctypes", "repro_torch.kernels.build")
                                              for a in n.names)
            or isinstance(n, ast.ImportFrom) and n.level == 0
            and (n.module == "repro_torch.kernels.build"
                 or n.module == "repro_torch.kernels" and any(a.name == "build"
                                                              for a in n.names))
            for n in ast.walk(tree))
        module_values = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                module_values[node.targets[0].id] = node.value
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.imports.resolve(node.func)
            if launcher and (name in _UNINITIALISED or isinstance(node.func, ast.Attribute)
                             and node.func.attr == "new_empty"):
                yield ctx.finding(self.code, node, "kernel launcher allocates an "
                                  "uninitialised buffer: zero it (torch.zeros) or name the "
                                  "kernel that writes every element in a pragma")
            if name == _BUILD and len(node.args) > 1:
                flags = node.args[1]
                if isinstance(flags, ast.Name):
                    flags = module_values.get(flags.id, flags)
                if not any(isinstance(c, ast.Constant) and c.value == "--fmad=false"
                           for c in ast.walk(flags)):
                    yield ctx.finding(self.code, node, "kernel build without "
                                      "'--fmad=false': nvcc contracts a * b + c into one "
                                      "FMA, which rounds once where the plain version "
                                      "rounds twice")
