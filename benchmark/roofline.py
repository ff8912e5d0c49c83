"""The yardstick of the kernels' roofline shares: the card's peaks and
the work each measured operation needs, counted from its shapes and
independent of how the program implements it.

A field element is 16 limbs of 16 bits stored as int32: 64 bytes.  A
BN254 Montgomery product is counted as 136 32-bit multiply-adds (8 x 8
word products, 8 x 8 for the reduction, 8 for the quotient digits).
"""

from __future__ import annotations

import math

ELEMENT_BYTES = 64
MULADDS_PER_PRODUCT = 136
# published: H100 SXM HBM3 bandwidth at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
# derived, not published: 132 SMs x 64 32-bit integer multiply-adds a
# cycle x 1.98 GHz boost clock
PEAK_MULADDS_PER_S = 16.75e12


def least_seconds(bytes_moved: float, products: float) -> tuple[float, str]:
    """The least time the card could take, and which bound sets it."""
    mem = bytes_moved / PEAK_BYTES_PER_S
    ops = products * MULADDS_PER_PRODUCT / PEAK_MULADDS_PER_S
    return (mem, "memory") if mem >= ops else (ops, "integer multiply-adds")


def ntt_many_work(count: int, n: int, shifted: bool) -> tuple[float, float]:
    """(bytes, field products) of ``count`` transforms of n points, on a
    coset when ``shifted``: each input read once, each output written
    once, the shift's powers read once; (n / 2) log2 n butterfly products
    a transform, and n more for the shift."""
    bytes_moved = 2 * count * n * ELEMENT_BYTES + (n * ELEMENT_BYTES if shifted else 0)
    products = count * (n // 2 * int(math.log2(n)) + (n if shifted else 0))
    return bytes_moved, products


def mont_mul_work(rows: int, n: int) -> tuple[float, float]:
    """(bytes, field products) of a (rows, n) array times one broadcast
    row of n: both operands read once, the result written once."""
    return (2 * rows * n + n) * ELEMENT_BYTES, rows * n


def share_percent(bytes_moved: float, products: float, seconds: float) -> tuple[float, str]:
    least, bound = least_seconds(bytes_moved, products)
    return 100.0 * least / seconds, bound
