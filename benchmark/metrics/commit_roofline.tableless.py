"""The tableless commitments' share of their roofline in the traced run's
profiled proof: 100 x the least time ``roofline.least_seconds`` allows
for the work every ``commit`` span under ``prove`` with ``tables`` 0
states, over the sum of those spans' device seconds.

The work is the MSM's without window tables, whatever computes it: for
a span of ``polys`` commitments over ``points`` SRS points, with
windows of c bits (W = ceil(254 / c) of them), each commitment does W x
points mixed affine additions of 11 Montgomery products (every window
sums the bare points into its own 2^c buckets), the W bucket sets'
weighted sums (24 products a bucket), and the Horner fold of the W
window sums: W x c doublings of 8 products and W complete additions of
12; it reads each scalar once and each point's two coordinates once a
window (64 B an element).  c comes from this reader's own copy
(``window``) of the window model the program used when this metric was
written (c = 10, W = 26 at 2^22 points), so a later change of the
program's window cannot move the yardstick.  One proof (n = 1).  None
where the program records no such spans or its spans carry no work.
The ``msm.horner`` spans are logged."""

import math

from benchmark import roofline

SCALAR_BITS = 254
MULS_PER_ROW = 11         # RCB 2015/1060 algorithm 8, mixed addition
MULS_PER_BUCKET = 24      # two complete additions (12 products each)
MULS_PER_DOUBLING = 8     # RCB 2015/1060 algorithm 9 (a = 0)
MULS_PER_ADD = 12         # RCB 2015/1060 algorithm 7


def window(n: int) -> int:
    """The c in 6..16 with c + log2 n <= 32 that minimises
    ceil(254 / c) * (n + 2^c (log2 n + 2)), the first on a tie."""
    lg = max(1, math.ceil(math.log2(max(n, 2))))
    best, best_cost = 8, None
    for c in range(6, 17):
        if c + lg > 32:
            continue
        cost = -(-SCALAR_BITS // c) * (n + (1 << c) * (lg + 2))
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def work(polys: int, points: int) -> tuple[float, float]:
    """(bytes, Montgomery products) of ``polys`` tableless commitments
    over ``points`` points."""
    c = window(points)
    w = -(-SCALAR_BITS // c)
    products = polys * (MULS_PER_ROW * w * points
                        + MULS_PER_BUCKET * w * (1 << c)
                        + MULS_PER_DOUBLING * w * c + MULS_PER_ADD * w)
    return polys * points * (1 + 2 * w) * roofline.ELEMENT_BYTES, products


def read(ctx):
    from halo2_aes_tpu_torch.utils import timers

    last_tree = getattr(timers, "last_tree", None)
    tree = last_tree("prove") if last_tree else None
    if tree is None:
        return None
    spans = [r for r in tree.spans if r.name == "commit"
             and r.attrs.get("tables") == 0]
    if not spans or any(key not in r.attrs for r in spans
                        for key in ("polys", "points")):
        return None
    seconds = sum(r.device_seconds for r in spans)
    if seconds <= 0:
        return None
    least = sum(roofline.least_seconds(*work(r.attrs["polys"], r.attrs["points"]))[0]
                for r in spans)
    horner = [r for r in tree.spans if r.name == "msm.horner"]
    ctx.log(f"commit (tables 0): {len(spans)} spans, "
            f"{sum(r.attrs['polys'] for r in spans)} polys, {seconds:.4f} s on the "
            f"device, {least:.4f} s at the roofline; msm.horner: {len(horner)} spans, "
            f"windows {sorted({r.attrs.get('windows') for r in horner})}, c "
            f"{sorted({r.attrs.get('c') for r in horner})}, "
            f"{sum(r.device_seconds for r in horner):.4f} s on the device")
    return 100.0 * least / seconds
