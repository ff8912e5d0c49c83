"""Seconds of the grand-product phase a proof (the permutation and
lookup z columns and the random poly, closed by y), median over the
window's proofs, from the challenge marks of ``trace.phase_prove``."""

import statistics


def read(ctx):
    vals = [p["grand_products"] for p in ctx.phases or [] if "grand_products" in p]
    return statistics.median(vals) if vals else None
