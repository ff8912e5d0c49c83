"""Share of one profiled proof's wall time in which no operation ran on
the card: 100 (1 - busy / wall), busy the union of the device events'
intervals."""


def read(ctx):
    prof = ctx.profile
    if not prof or prof["wall_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
