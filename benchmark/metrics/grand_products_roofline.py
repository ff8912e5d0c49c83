"""The grand products' z columns' share of their roofline in the traced
run's profiled proof: 100 x the least time ``roofline.least_seconds``
allows for the work every ``grand_products.lookup`` and
``grand_products.perm`` span states (its ``polys`` input columns read
and the z column written, 64 B an element each once, over ``rows``
rows; its ``muls`` Montgomery products a row as the argument states
them: 7 a lookup row, 4c + 4 a row of a permutation chunk of c
columns), over the sum of those spans' device seconds.  The work is the
argument's, whatever computes it (K6 or the eager scans).  One proof
(n = 1).  None where the program records no such spans or its spans
carry no work."""

from benchmark import roofline

NAMES = ("grand_products.lookup", "grand_products.perm")


def read(ctx):
    from halo2_aes_tpu_torch.utils import timers

    last_tree = getattr(timers, "last_tree", None)
    tree = last_tree("prove") if last_tree else None
    if tree is None:
        return None
    spans = [r for r in tree.spans if r.name in NAMES]
    if not spans or any(key not in r.attrs for r in spans
                        for key in ("muls", "polys", "rows")):
        return None
    seconds = sum(r.device_seconds for r in spans)
    if seconds <= 0:
        return None
    least = sum(roofline.least_seconds(
        (r.attrs["polys"] + 1) * r.attrs["rows"] * roofline.ELEMENT_BYTES,
        r.attrs["muls"] * r.attrs["rows"])[0] for r in spans)
    ctx.log(f"grand_products: {len(spans)} spans, fused "
            f"{sorted({r.attrs.get('fused') for r in spans})}, {seconds:.4f} s "
            f"on the device, {least:.4f} s at the roofline")
    return 100.0 * least / seconds
