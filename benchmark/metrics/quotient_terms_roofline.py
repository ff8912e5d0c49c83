"""The quotient's constraint terms' share of their roofline in the traced
run's profiled proof: 100 x the least time ``roofline.least_seconds``
allows for the work every ``quotient.terms`` span states (its ``muls``
Montgomery products a row, as ``protocol.constraint_terms`` states
them with the Horner fold and the Z_H division, over ``rows`` rows; its
``polys`` evaluated polys read and the result written, 64 B an element
each once), over the sum of those spans' device seconds.  The work is
the constraint system's, whatever evaluates it (K4 or the eager fold).
One proof (n = 1).  None where the program records no spans or its
spans carry no work."""

from benchmark import roofline


def read(ctx):
    from halo2_aes_tpu_torch.utils import timers

    last_tree = getattr(timers, "last_tree", None)
    tree = last_tree("prove") if last_tree else None
    if tree is None:
        return None
    spans = [r for r in tree.spans if r.name == "quotient.terms"]
    if not spans or any(key not in r.attrs for r in spans
                        for key in ("muls", "polys", "rows")):
        return None
    seconds = sum(r.device_seconds for r in spans)
    if seconds <= 0:
        return None
    least = sum(roofline.least_seconds(
        (r.attrs["polys"] + 1) * r.attrs["rows"] * roofline.ELEMENT_BYTES,
        r.attrs["muls"] * r.attrs["rows"])[0] for r in spans)
    ctx.log(f"quotient.terms: {len(spans)} spans, fused "
            f"{[r.attrs.get('fused') for r in spans]}, {seconds:.4f} s on the "
            f"device, {least:.4f} s at the roofline")
    return 100.0 * least / seconds
