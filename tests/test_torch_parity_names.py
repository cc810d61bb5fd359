"""Every top-level name of the reference's epidemic side and of its models
has a counterpart in the port.

For each module of ``repro`` under ``core/``, ``engine/``, ``serve/``,
``api/``, ``runtime/``, ``checkpoint/``, ``configs/``, ``models/``,
``optim/`` and ``launch/``, the
module of the same path in ``repro_torch`` must define every public
top-level name the reference's defines: functions, classes and assigned
constants, and in a package's ``__init__.py`` also the names it re-exports
with ``from ... import``. Both sides are read with ``ast``: nothing is
imported, so no JAX.

The only names allowed to be missing are listed below, each with the
ROADMAP item that still queues it (LM tooling), and ``core/compat.py``, a
JAX ``shard_map`` shim with nothing to port.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = os.path.join(ROOT, "src", "repro"), os.path.join(ROOT, "src", "repro_torch")
PACKAGES = ("core", "engine", "serve", "api", "runtime", "checkpoint", "configs", "models",
            "optim", "launch")

TOOLING = "ROADMAP queue 1 item 9 (LM tooling)"
#: Modules with no counterpart, and why.
MISSING_MODULES = {"core/compat.py": "a JAX shard_map shim (ROADMAP queue 1 item 9's note)",
                   "launch/dryrun.py": TOOLING}
#: Names still queued in ROADMAP queue 1, by module.
QUEUED = {
    "configs/__init__.py": {n: TOOLING for n in (
        "DECODE_32K", "LONG_500K", "PREFILL_32K", "TRAIN_4K", "get_shape", "list_archs",
        "supports_shape")},
    "configs/base.py": {"supports_shape": TOOLING},
    "launch/steps.py": {"abstract_opt_state": TOOLING},
    "models/attention.py": {"cache_entry_struct": TOOLING},
    "models/base.py": {"abstract_params": TOOLING},
    "models/model.py": {"abstract_params": TOOLING},
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
    missing = _names(os.path.join(REF, module)) - _names(port)
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
