"""detlint for the port — the determinism static-analysis pass over
``src/repro_torch`` and ``chip_smoke.py`` (the reference's
``repro.analysis.lint``, its engine carried over, its rules rewritten for
torch and CUDA).

Level 1 (this package): an AST rule engine (plus a line scanner for CUDA
sources) encoding the port's bitwise contract as six named DET rules, with
inline ``# detlint: ignore[RULE]`` pragmas, an optional baseline, and
console + JSON output. ``python -m repro_torch.analysis.lint src/repro_torch
chip_smoke.py`` must exit 0 with no baseline. Level 2 is
:mod:`repro_torch.analysis.dispatch` (``find_f64``, ``assert_no_f64``,
``collective_count``) and :mod:`repro_torch.analysis.capture`
(``recompile_sentinel``).
"""

from repro_torch.analysis.lint.engine import (  # noqa: F401
    Finding,
    LintConfig,
    apply_baseline,
    load_baseline,
    render_console,
    render_json,
    run_lint,
    write_baseline,
)
from repro_torch.analysis.lint.rules import all_rules, rule_catalog  # noqa: F401
