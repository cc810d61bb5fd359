"""detlint engine for the port: file walking, import resolution, pragmas,
baselines (the reference's ``repro.analysis.lint.engine``, carried over
with its behaviour, plus CUDA sources).

The port's bitwise contract (one seed => identical results from run to run,
on every layout, kernel against plain version; ROADMAP North star) rests on
coding invariants: every draw through the counter RNG, pinned dtypes, wide
integer sums across collectives, no float atomics and no FP contraction in
the kernels, no host nondeterminism in what a day replays. Each rule in
:mod:`repro_torch.analysis.lint.rules` encodes one of them as a named,
suppressible check. This module owns everything around the rules:

  * **ModuleContext** — one file: for Python its AST, source lines and an
    import-alias map that resolves ``F.pad`` -> ``torch.nn.functional.pad``;
    for a CUDA source (``*.cu``, ``*.cuh``) its lines alone (``tree`` is
    None and ``language`` is ``"cuda"``); and the RNG stream registry
    scraped from ``core/rng.py``.
  * **pragmas** — ``# detlint: ignore[DET001]`` (``// detlint: ...`` in a
    CUDA source) on the flagged line, or on a comment-only line directly
    above it, suppresses a finding; ``detlint: skip-file`` skips the file.
  * **baseline** — a JSON multiset of finding keys; findings present in
    the baseline are reported as suppressed, anything new fails the run.
    Keys are line-number-free (rule + path + message), so unrelated edits
    do not churn the baseline. The port's tree needs none.
  * **run_lint / render** — the driver the CLI and the tests share.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from collections import Counter
from typing import Iterable, Optional, Sequence

PRAGMA_RE = re.compile(r"detlint:\s*ignore\[([A-Za-z0-9*,\s]+)\]")
SKIP_FILE_RE = re.compile(r"detlint:\s*skip-file")

#: Directories never linted (golden-bad corpora live in lint_corpus).
DEFAULT_EXCLUDES = ("__pycache__", "lint_corpus", ".git", "build")

#: Module suffix treated as the RNG stream registry (DET001's sanctioned
#: home for raw randomness, DET002's source of declared stream ids).
RNG_MODULE_SUFFIX = "core/rng.py"

PYTHON_SUFFIXES = (".py",)
CUDA_SUFFIXES = (".cu", ".cuh")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str  # "DET003"
    path: str  # posix path as given to the linter
    line: int  # 1-based
    col: int  # 0-based
    message: str

    def key(self) -> str:
        """Baseline key: stable under line renumbering."""
        return f"{self.rule}::{self.path}::{self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LintConfig:
    """Knobs shared by the CLI and the test harness."""

    select: Optional[Sequence[str]] = None  # rule codes to run; None = all
    excludes: Sequence[str] = DEFAULT_EXCLUDES
    rng_module_suffix: str = RNG_MODULE_SUFFIX
    #: Explicit stream registry {NAME: value}; None = scrape it from any
    #: scanned file matching ``rng_module_suffix``.
    streams: Optional[dict] = None
    #: Per-directory rule relaxation: ``(path_prefix, rule_codes)`` pairs.
    #: A finding whose (posix) path starts with a prefix and whose rule is
    #: in that prefix's codes is dropped entirely — unlike pragmas it
    #: never appears as suppressed.
    relax: Sequence[tuple] = ()

    def relaxed(self, path: str, rule: str) -> bool:
        p = path.replace(os.sep, "/")
        for prefix, codes in self.relax:
            if p.startswith(prefix.replace(os.sep, "/").rstrip("/")):
                if "*" in codes or rule in codes:
                    return True
        return False


class ImportMap:
    """Alias -> canonical dotted module map for one module.

    ``import torch.distributed as dist`` binds dist -> torch.distributed;
    ``from repro_torch.core import rng`` binds rng -> repro_torch.core.rng.
    Plain ``import torch.nn`` binds the top name (torch -> torch), which
    dotted resolution completes.
    """

    def __init__(self, tree: ast.AST):
        self.aliases: dict = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.aliases[a.asname] = a.name
                    else:
                        top = a.name.split(".")[0]
                        self.aliases[top] = top
            elif isinstance(node, ast.ImportFrom):
                if node.level or not node.module:
                    continue  # relative imports stay unresolved
                for a in node.names:
                    self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name for a Name/Attribute chain, or None if
        the chain roots in a local variable rather than an import."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.aliases.get(node.id)
        if base is None:
            return None
        return ".".join([base] + parts[::-1])


def parse_stream_registry(tree: ast.AST) -> dict:
    """Module-level ``NAME = <int>`` (or ``NAME = np.uint32(<int>)``)
    assignments -> {NAME: int}: the declared streams of ``core/rng.py``.
    Private mixing constants (underscore names) are not streams."""
    streams: dict = {}
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt, v = node.targets[0], node.value
        if not (isinstance(tgt, ast.Name) and tgt.id.isupper()) or tgt.id.startswith("_"):
            continue
        if (isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute)
                and v.func.attr in ("uint32", "int32", "uint64") and v.args):
            v = v.args[0]
        if isinstance(v, ast.Constant) and type(v.value) is int:
            streams[tgt.id] = v.value
    return streams


def _scan_python_comments(source: str) -> list:
    """(line, comment text, comment-only line?) for every Python comment."""
    out = []
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError):  # pragma: no cover - malformed tail
        toks = []
    lines = source.splitlines()
    for tok in toks:
        if tok.type == tokenize.COMMENT:
            line = tok.start[0]
            text = lines[line - 1].strip() if line <= len(lines) else ""
            out.append((line, tok.string, text.startswith("#")))
    return out


def _scan_cuda_comments(lines: list) -> list:
    """(line, comment text, comment-only line?) for every ``//`` comment."""
    out = []
    for i, text in enumerate(lines, 1):
        pos = text.find("//")
        if pos >= 0:
            out.append((i, text[pos:], not text[:pos].strip()))
    return out


class ModuleContext:
    """Everything a rule needs about one source file."""

    def __init__(self, path: str, source: str, config: LintConfig,
                 streams: Optional[dict] = None):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.language = "cuda" if path.endswith(CUDA_SUFFIXES) else "python"
        self.tree = ast.parse(source, filename=path) if self.language == "python" else None
        self.imports = ImportMap(self.tree) if self.tree is not None else None
        self.config = config
        self.streams = streams if streams is not None else {}
        self.is_rng_module = False
        self.skip_file = False
        self._pragmas: dict = {}  # line -> set of rule codes (or {"*"})
        self._scan_pragmas()

    def _scan_pragmas(self):
        comments = (_scan_python_comments(self.source) if self.language == "python"
                    else _scan_cuda_comments(self.lines))
        comment_only: dict = {}  # line -> codes, for "applies to next line"
        for line, text, alone in comments:
            if SKIP_FILE_RE.search(text):
                self.skip_file = True
            m = PRAGMA_RE.search(text)
            if not m:
                continue
            codes = {c.strip().upper() for c in m.group(1).split(",") if c.strip()}
            if alone:
                comment_only[line] = codes
            else:
                self._pragmas.setdefault(line, set()).update(codes)
        # A pragma on its own comment line covers the next source line,
        # skipping blank lines and continuation comment lines (so a
        # multi-line justification between the pragma and the code works).
        lead = "#" if self.language == "python" else "//"
        for line, codes in comment_only.items():
            nxt = line + 1
            while nxt <= len(self.lines):
                stripped = self.lines[nxt - 1].strip()
                if not stripped or stripped.startswith(lead):
                    nxt += 1
                else:
                    break
            self._pragmas.setdefault(nxt, set()).update(codes)

    def suppressed(self, rule: str, line: int) -> bool:
        codes = self._pragmas.get(line, ())
        return "*" in codes or rule in codes

    def finding(self, rule: str, node, message: str) -> Finding:
        """A finding at an AST node, or at a ``(line, col)`` pair (CUDA)."""
        if isinstance(node, tuple):
            line, col = node
        else:
            line, col = getattr(node, "lineno", 1), getattr(node, "col_offset", 0)
        return Finding(rule=rule, path=self.path, line=line, col=col, message=message)

    def endswith(self, *suffixes: str) -> bool:
        """Whether the file's posix path ends with one of ``suffixes``."""
        return self.path.endswith(suffixes)


# ---------------------------------------------------------------------------
# shared semantic helpers (used by DET004)
# ---------------------------------------------------------------------------

_BOOL_DTYPE_NAMES = {"bool", "bool_"}


def _is_bool_dtype_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Name) and node.id in _BOOL_DTYPE_NAMES:
        return True
    return isinstance(node, ast.Attribute) and node.attr in _BOOL_DTYPE_NAMES


def local_assignments(fn: ast.AST) -> dict:
    """name -> [assigned value exprs] for single-Name targets anywhere in
    ``fn``'s subtree (closures included). A name is only classified by
    :func:`is_boolish` if *every* visible assignment agrees."""
    env: dict = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            env.setdefault(node.targets[0].id, []).append(node.value)
    return env


def is_boolish(node: ast.AST, env: dict, _stack: frozenset = frozenset()) -> bool:
    """Conservative "this expression is a boolean mask" classifier.

    True for comparisons, ``&``/``|``/``^`` chains with a boolish side,
    ``~``/``not``, ``.bool()``, ``.to(torch.bool)``, bool-dtype
    constructors, ``torch.logical_*``/``isnan``/``isfinite``, and names
    whose every visible assignment is boolish. A bool mask's sum is bounded
    by the shard width, so no width of accumulator can overflow on it.
    """
    if isinstance(node, (ast.Compare, ast.BoolOp)):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.Invert, ast.Not)):
        return is_boolish(node.operand, env, _stack)
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return is_boolish(node.left, env, _stack) or is_boolish(node.right, env, _stack)
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "bool" and not node.args:
            return True
        if isinstance(f, ast.Attribute) and f.attr in ("to", "type", "astype") and node.args:
            return _is_bool_dtype_expr(node.args[0])
        if isinstance(f, ast.Attribute) and f.attr in ("zeros", "ones", "full", "empty"):
            return any(kw.arg == "dtype" and _is_bool_dtype_expr(kw.value)
                       for kw in node.keywords)
        if isinstance(f, ast.Attribute) and f.attr in ("logical_and", "logical_or",
                                                       "logical_not", "logical_xor",
                                                       "isnan", "isinf", "isfinite",
                                                       "eq", "ne", "lt", "le", "gt", "ge"):
            return True
    if isinstance(node, ast.Name):
        if node.id in _stack:
            return False  # self-reference inside an |/& chain
        vals = env.get(node.id)
        if vals:
            sub = _stack | {node.id}
            return all(is_boolish(v, env, sub) for v in vals)
    return False


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def load_baseline(path: Optional[str]) -> Counter:
    """Baseline JSON -> multiset of finding keys. Missing/None = empty."""
    if not path or not os.path.exists(path):
        return Counter()
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "suppress" not in data:
        raise ValueError(f"{path}: not a detlint baseline "
                         "(expected {'version': 1, 'suppress': {...}})")
    return Counter({k: int(v) for k, v in data["suppress"].items()})


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    counts = Counter(f.key() for f in findings)
    with open(path, "w") as f:
        json.dump({"version": 1, "suppress": dict(sorted(counts.items()))},
                  f, indent=2, sort_keys=True)
        f.write("\n")


def apply_baseline(findings: Sequence[Finding], baseline: Counter):
    """Split findings into (new, suppressed) against the baseline multiset."""
    budget = Counter(baseline)
    new, suppressed = [], []
    for f in findings:
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
            suppressed.append(f)
        else:
            new.append(f)
    return new, suppressed


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def iter_source_files(paths: Sequence[str], excludes: Sequence[str]):
    """The Python and CUDA sources under ``paths`` (files are taken as
    given), in a stable order."""
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in excludes and not d.startswith("."))
            for name in sorted(files):
                if name.endswith(PYTHON_SUFFIXES + CUDA_SUFFIXES):
                    yield os.path.join(root, name)


def run_lint(paths: Sequence[str], config: Optional[LintConfig] = None):
    """Lint ``paths`` (files or directories). Returns (findings, errors):
    findings sorted by (path, line, rule), errors a list of
    ``path: reason`` strings for unreadable or unparseable files."""
    from repro_torch.analysis.lint.rules import all_rules

    config = config or LintConfig()
    rules = [r for r in all_rules() if config.select is None or r.code in config.select]

    files = list(iter_source_files(paths, tuple(config.excludes)))
    sources: dict = {}
    errors: list = []
    for path in files:
        try:
            with open(path, encoding="utf-8") as f:
                sources[path] = f.read()
        except (OSError, UnicodeDecodeError) as e:
            errors.append(f"{path}: {e}")

    # Pass 1: locate the stream registry among the scanned files (unless
    # the config supplies one) so DET002 can cross-check call sites.
    registry_paths = [p for p in sources
                      if p.replace(os.sep, "/").endswith(config.rng_module_suffix)]
    streams = config.streams
    if streams is None:
        streams = {}
        for p in registry_paths:
            try:
                streams.update(parse_stream_registry(ast.parse(sources[p])))
            except SyntaxError:
                pass

    findings: list = []
    for path in files:
        if path not in sources:
            continue
        try:
            ctx = ModuleContext(path.replace(os.sep, "/"), sources[path], config,
                                streams=streams)
        except SyntaxError as e:
            errors.append(f"{path}: syntax error: {e}")
            continue
        ctx.is_rng_module = path in registry_paths
        if ctx.skip_file:
            continue
        for rule in rules:
            for f in rule.check(ctx):
                if ctx.suppressed(f.rule, f.line) or config.relaxed(f.path, f.rule):
                    continue
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, errors


def render_console(new: Sequence[Finding], suppressed: Sequence[Finding],
                   errors: Sequence[str]) -> str:
    out = [f"{f.path}:{f.line}:{f.col + 1}: {f.rule} {f.message}" for f in new]
    out += [f"error: {e}" for e in errors]
    by_rule = Counter(f.rule for f in new)
    summary = ", ".join(f"{r}×{n}" for r, n in sorted(by_rule.items()))
    tail = f"detlint: {len(new)} finding(s)"
    if summary:
        tail += f" ({summary})"
    if suppressed:
        tail += f", {len(suppressed)} baseline-suppressed"
    out.append(tail)
    return "\n".join(out)


def render_json(new: Sequence[Finding], suppressed: Sequence[Finding],
                errors: Sequence[str]) -> dict:
    """The machine-readable report (the reference's schema)."""
    return {
        "version": 1,
        "tool": "detlint",
        "findings": [f.to_dict() for f in new],
        "suppressed": [f.to_dict() for f in suppressed],
        "errors": list(errors),
        "counts": dict(Counter(f.rule for f in new)),
        "exit_code": 1 if (new or errors) else 0,
    }
