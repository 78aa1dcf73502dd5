"""The part of ``repro.core.attribution`` the serve engine uses: exact
chip-time accumulation as integers.  The attribution waterfall itself is
not ported yet.

Every finite float is an integer multiple of 2**-1074 (the subnormal
quantum), so chip-times are stored as plain ints scaled by 2**_SHIFT —
integer addition is exact, and converts losslessly to
``Fraction(x, 1 << _SHIFT)`` at the read sites.
"""
from __future__ import annotations

_SHIFT = 1074


def _exact(x: float) -> int:
    """``x`` as an integer scaled by ``2**_SHIFT`` (exact for any finite
    float: the denominator of ``as_integer_ratio`` is a power of two no
    larger than ``2**_SHIFT``)."""
    p, q = x.as_integer_ratio()
    return p << (_SHIFT + 1 - q.bit_length())
