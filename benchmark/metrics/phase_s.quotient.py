"""Seconds of the quotient phase a proof (x squeezed after the quotient
pieces), median over the window's proofs, from the challenge marks of
``trace.phase_prove``."""

import statistics


def read(ctx):
    vals = [p["quotient"] for p in ctx.phases or [] if "quotient" in p]
    return statistics.median(vals) if vals else None
