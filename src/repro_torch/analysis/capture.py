"""The zero-rebuild check of the serving tier's steady state.

The port's counterpart of the reference's ``repro.analysis.hlo``
``recompile_sentinel``, under the same name. The reference watches a jitted
function's XLA cache; the port's warm executables are
:class:`repro_torch.engine.runner.DayRunner` builds — on the card a captured
CUDA graph per input signature, on the CPU the eager loop's signature
record — so the sentinel watches a runner's count of builds
(:meth:`DayRunner.cache_size`). ``hlo.py``'s other level-2 helpers
(``find_f64``, ``assert_no_f64``, ``collective_count``) are
:mod:`repro_torch.analysis.dispatch`; its HLO readers (``collective_bytes``,
``measure_compiled``) serve the LM tooling (ROADMAP queue 1 item 7).
"""

from __future__ import annotations


class recompile_sentinel:
    """Context manager asserting a runner builds nothing (no capture on the
    card) inside the ``with`` block::

        runner = core.runner_fn(days)
        runner(params, state)             # warm up: the one capture
        with recompile_sentinel(runner):
            for _ in range(n):            # steady state: replays only
                state = runner(params, state)[0]

    A growing count means some argument is changing shape, dtype, device or
    structure between calls — each rebuild is a fresh capture (seconds of
    host work and a new memory pool on the card) where a replay was due."""

    def __init__(self, runner, allow: int = 0):
        self._fn = runner
        self._allow = int(allow)
        self._before = 0

    def _size(self) -> int:
        return int(self._fn.cache_size())

    def __enter__(self):
        self._before = self._size()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        grew = self._size() - self._before
        if grew > self._allow:
            raise AssertionError(
                f"recompile sentinel: runner cache grew by {grew} "
                f"(allowed {self._allow}) — an argument is changing "
                f"shape/dtype/structure between calls"
            )
        return False
