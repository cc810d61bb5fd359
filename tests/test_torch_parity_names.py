"""Every top-level name of the reference's epidemic side, of its models, of
its LM tooling, its data and its kernels has a counterpart in the port.

For each module of ``repro`` under ``core/``, ``engine/``, ``serve/``,
``api/``, ``runtime/``, ``checkpoint/``, ``configs/``, ``models/``,
``optim/``, ``launch/``, ``analysis/``, ``data/`` and ``kernels/`` (and
each of ``kernels/``'s subpackages), the
module of the same path in ``repro_torch`` must define every public
top-level name the reference's defines: functions, classes and assigned
constants, and in a package's ``__init__.py`` also the names it re-exports
with ``from ... import``. Both sides are read with ``ast``: nothing is
imported, so no JAX.

A name that the port keeps in another module is listed in ``MOVED`` with
that module, which must define it. A name whose work the port routes to
another of its functions is listed in ``ROUTED`` with that function, which
must exist, and the reason. The only module allowed to be missing is
``core/compat.py``, a JAX ``shard_map`` shim with nothing to port.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = os.path.join(ROOT, "src", "repro"), os.path.join(ROOT, "src", "repro_torch")
PACKAGES = ("core", "engine", "serve", "api", "runtime", "checkpoint", "configs", "models",
            "optim", "launch", "analysis", "data", "kernels")
#: Packages whose subpackages are covered too (``analysis/lint/`` is the
#: port's own determinism rules, not a counterpart of the reference's).
RECURSIVE = ("kernels",)

#: Modules with no counterpart, and why.
MISSING_MODULES = {"core/compat.py": "a JAX shard_map shim (ROADMAP queue 1 item 9's note)"}
#: Names still queued in ROADMAP queue 1, by module (none: the port is whole).
QUEUED: dict = {}
#: Names the port defines in another module than the reference's, by
#: reference module: {name: the port's module}.
MOVED = {
    "analysis/hlo.py": {"find_f64": "analysis/dispatch.py",
                        "assert_no_f64": "analysis/dispatch.py",
                        "collective_count": "analysis/dispatch.py",
                        "recompile_sentinel": "analysis/capture.py"},
}

_BY_ROUTE = ("the port runs the reference's backends jnp, scan and compact as pallas-compact "
             "(api/spec.py ROUTES; ROADMAP queue 3, differences by design)")
_COMPACT = "kernels/interactions/ops.py:interactions_compact_edges"
#: The interaction backends by the reference's names (its ``ops.py``,
#: re-exported by its ``__init__.py``): {name: (the port's "module:function"
#: that does the work, why)}.
_BACKENDS = {
    "interactions_auto": ("kernels/interactions/ops.py:interactions_auto_edges",
                          "the dispatch by backend name, with the edge count: " + _BY_ROUTE),
    "interactions_blocked_jnp": (_COMPACT, _BY_ROUTE),
    "interactions_blocked_scan": (_COMPACT, _BY_ROUTE),
    "interactions_compact": (_COMPACT, _BY_ROUTE),
    "interactions_pallas": ("kernels/interactions/ops.py:interactions_padded",
                            "backend pallas, the padded schedule (api/spec.py ROUTES)"),
}
#: Names whose work the port does in another function, by reference module.
ROUTED = {
    "kernels/interactions/__init__.py": _BACKENDS,
    "kernels/interactions/ops.py": {
        **_BACKENDS,
        "interactions_pallas_compact": (_COMPACT, "backend pallas-compact without the edge "
                                        "count, which the port's pass always returns"),
    },
    "kernels/interactions/kernel.py": {
        "interactions_pallas_call": ("kernels/interactions/kernel.py:interactions_padded_cuda",
                                     "the Pallas launcher of the padded pass: the port "
                                     "launches its CUDA kernel (csrc/interactions.cu)"),
        "interactions_pallas_compact_call": (
            "kernels/interactions/kernel.py:interactions_compact_cuda",
            "the Pallas launcher of the compacted pass: the port launches its CUDA kernel "
            "(csrc/interactions.cu)"),
    },
    "kernels/flash_attention/kernel.py": {
        "flash_attention_bhsd": ("kernels/flash_attention/kernel.py:flash_attention_bhsd_cuda",
                                 "the Pallas launcher: the port launches its CUDA kernels "
                                 "(csrc/flash_attention.cu)"),
    },
}


def _names(path: str) -> set:
    """Public top-level names a module defines (and, for an ``__init__.py``,
    re-exports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    init = os.path.basename(path) == "__init__.py"
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif init and isinstance(node, ast.ImportFrom):
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def _modules():
    def files(pkg):
        top = os.path.join(REF, pkg)
        if pkg not in RECURSIVE:
            return [os.path.join(top, f) for f in os.listdir(top)]
        return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs]

    return sorted(os.path.relpath(f, REF) for pkg in PACKAGES for f in files(pkg)
                  if f.endswith(".py"))


@pytest.mark.parametrize("module", _modules())
def test_port_has_every_reference_name(module):
    port = os.path.join(PORT, module)
    if module in MISSING_MODULES:
        assert not os.path.exists(port), f"{module} exists now: drop it from MISSING_MODULES"
        return
    assert os.path.exists(port), f"the port has no {module}"
    queued = QUEUED.get(module, {})
    moved = MOVED.get(module, {})
    routed = ROUTED.get(module, {})
    for name, where in moved.items():
        assert name in _names(os.path.join(PORT, where)), f"{module}:{name} is not in {where}"
    for name, (target, why) in routed.items():
        where, fn = target.split(":")
        assert fn in _names(os.path.join(PORT, where)), f"{module}:{name} routes to no {target}"
    missing = _names(os.path.join(REF, module)) - _names(port) - set(moved)
    allowed = set(queued) | set(routed)
    assert missing <= allowed, f"{module}: no counterpart for {sorted(missing - allowed)}"
    # an allowed name that the port now has must leave the allow-list
    assert not allowed - missing, \
        f"{module}: {sorted(allowed - missing)} exist now: drop them from QUEUED or ROUTED"


def test_the_allow_list_names_roadmap_items():
    roadmap = open(os.path.join(ROOT, "ROADMAP.md")).read()
    for module, why in MISSING_MODULES.items():
        assert "ROADMAP queue 1 item" in why, module
        assert os.path.basename(module) in roadmap, f"ROADMAP does not queue {module}"
    for names in QUEUED.values():
        for name, why in names.items():
            assert name in roadmap, f"{name} is allowed missing but ROADMAP does not queue it"
            assert why.startswith("ROADMAP queue 1 item")
    for names in ROUTED.values():
        for name, (_, why) in names.items():
            assert name in roadmap, f"{name} is routed but ROADMAP does not name it"
            assert why
