"""Device seconds of the permuted lookup pairs' construction in the
traced run's profiled proof: the sum of the ``lookup.pairs`` spans under
its ``prove`` span (one a batched construction of every lookup's pairs,
or one a lookup where they are built one at a time), each the time
between its two CUDA events.  One proof (n = 1).  None where the program
records no such spans.  The spans' ``streamed`` attribute (1: one lookup
at a time) is logged."""


def read(ctx):
    from halo2_aes_tpu_torch.utils import timers

    last_tree = getattr(timers, "last_tree", None)
    tree = last_tree("prove") if last_tree else None
    if tree is None:
        return None
    spans = [r for r in tree.spans if r.name == "lookup.pairs"]
    if not spans:
        return None
    seconds = sum(r.device_seconds for r in spans)
    ctx.log(f"lookup.pairs: {len(spans)} spans, streamed "
            f"{sorted({r.attrs.get('streamed') for r in spans})}, lookups "
            f"{sum(r.attrs.get('lookups', 0) for r in spans)}, {seconds:.4f} s "
            f"on the device")
    return seconds
