"""Global unroll-mode switch for roofline accounting (the reference's
``repro/models/unroll.py``).

The reference's dry run compiles 1- and 2-layer variants with every
structural loop unrolled, since XLA's cost analysis counts a while-loop
body once. The port already walks layers and attention chunks in Python,
so the switch changes no number it computes; the dry run reads it.
"""

from __future__ import annotations

import contextlib

_MODE = [False]


def enabled() -> bool:
    return _MODE[0]


@contextlib.contextmanager
def unroll_mode():
    old = _MODE[0]
    _MODE[0] = True
    try:
        yield
    finally:
        _MODE[0] = old
