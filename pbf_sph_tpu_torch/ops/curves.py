"""Morton (Z-order) curve primitives.

Semantics match the reference's shared host/device header
(reference `src/curves.h:17-88`): 3D cell coordinates of up to 10 bits per
axis interleave into a 30-bit Morton code with bit masks 0x09249249.

Written with plain operators so the same functions run on torch int32
tensors, on NumPy arrays, and fold on Python ints.  In-box coordinates are
< 1024, so every shift stays below 2^31 in int32.  Inputs must be
non-negative and < 1024; out-of-range handling is the caller's job (the
reference relies on size_t wraparound producing codes >= the grid-table size,
which then get skipped — see `src/ocl/oclsph_kernel.h:56`; we represent that
case explicitly with an INVALID sentinel).
"""

from __future__ import annotations

MORTON_BITS_PER_AXIS = 10
MORTON_MAX_COORD = (1 << MORTON_BITS_PER_AXIS) - 1  # 1023


def _spread_bits(v):
    """Spread the low 10 bits of v so consecutive bits are 3 apart
    (reference `src/curves.h:72-76` fold chain)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _collapse_bits(v):
    """Inverse of _spread_bits (reference `uninterleave`, `src/curves.h:46-59`)."""
    ret = v & 0x1
    ret |= (v & 0x8) >> 2
    ret |= (v & 0x40) >> 4
    ret |= (v & 0x200) >> 6
    ret |= (v & 0x1000) >> 8
    ret |= (v & 0x8000) >> 10
    ret |= (v & 0x40000) >> 12
    ret |= (v & 0x200000) >> 14
    ret |= (v & 0x1000000) >> 16
    ret |= (v & 0x8000000) >> 18
    return ret


def morton_encode3(x, y, z):
    """zCurveGridIndexAtCoord (reference `src/curves.h:72-88`)."""
    return _spread_bits(x) | (_spread_bits(y) << 1) | (_spread_bits(z) << 2)


def morton_decode3(code):
    """coordAtZCurveGridIndex{0,1,2} (reference `src/curves.h:61-65`)."""
    x = _collapse_bits(code & 0x9249249)
    y = _collapse_bits((code >> 1) & 0x9249249)
    z = _collapse_bits((code >> 2) & 0x9249249)
    return x, y, z


def index3d(x, y, z, x_max, y_max, z_max):
    """Row-major (z fastest) linear index (reference `src/curves.h:17-19`)."""
    return x * y_max * z_max + y * z_max + z


def to3d(index, x_max, y_max, z_max):
    """Inverse of index3d (reference `src/curves.h:21-37`)."""
    x = index // (y_max * z_max)
    y = (index - x * y_max * z_max) // z_max
    z = index - x * y_max * z_max - y * z_max
    return x, y, z
