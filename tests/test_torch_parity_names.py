"""Every top-level name of the reference's epidemic side, of its models and
of its LM tooling has a counterpart in the port.

For each module of ``repro`` under ``core/``, ``engine/``, ``serve/``,
``api/``, ``runtime/``, ``checkpoint/``, ``configs/``, ``models/``,
``optim/``, ``launch/`` and ``analysis/``, the
module of the same path in ``repro_torch`` must define every public
top-level name the reference's defines: functions, classes and assigned
constants, and in a package's ``__init__.py`` also the names it re-exports
with ``from ... import``. Both sides are read with ``ast``: nothing is
imported, so no JAX.

A name that the port keeps in another module is listed in ``MOVED`` with
that module, which must define it. The only module allowed to be missing is
``core/compat.py``, a JAX ``shard_map`` shim with nothing to port.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = os.path.join(ROOT, "src", "repro"), os.path.join(ROOT, "src", "repro_torch")
PACKAGES = ("core", "engine", "serve", "api", "runtime", "checkpoint", "configs", "models",
            "optim", "launch", "analysis")

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
    return sorted(f"{pkg}/{f}" for pkg in PACKAGES
                  for f in os.listdir(os.path.join(REF, pkg)) if f.endswith(".py"))


@pytest.mark.parametrize("module", _modules())
def test_port_has_every_reference_name(module):
    port = os.path.join(PORT, module)
    if module in MISSING_MODULES:
        assert not os.path.exists(port), f"{module} exists now: drop it from MISSING_MODULES"
        return
    assert os.path.exists(port), f"the port has no {module}"
    queued = QUEUED.get(module, {})
    moved = MOVED.get(module, {})
    for name, where in moved.items():
        assert name in _names(os.path.join(PORT, where)), f"{module}:{name} is not in {where}"
    missing = _names(os.path.join(REF, module)) - _names(port) - set(moved)
    assert missing <= set(queued), \
        f"{module}: no counterpart for {sorted(missing - set(queued))}"
    # an allowed name that the port now has must leave the allow-list
    assert not set(queued) - missing, \
        f"{module}: {sorted(set(queued) - missing)} exist now: drop them from QUEUED"


def test_the_allow_list_names_roadmap_items():
    roadmap = open(os.path.join(ROOT, "ROADMAP.md")).read()
    for module, why in MISSING_MODULES.items():
        assert "ROADMAP queue 1 item" in why, module
        assert os.path.basename(module) in roadmap, f"ROADMAP does not queue {module}"
    for names in QUEUED.values():
        for name, why in names.items():
            assert name in roadmap, f"{name} is allowed missing but ROADMAP does not queue it"
            assert why.startswith("ROADMAP queue 1 item")
