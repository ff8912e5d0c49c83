"""Device seconds of the grand-product phase of the traced run's
profiled proof: the prover's ``grand_products`` span (gamma squeezed to
y squeezed: the permutation and lookup z columns, the random poly and
their commitments), the time between its two CUDA events, with no
synchronise in it.  One proof (n = 1).  None where the program records
no spans."""


def read(ctx):
    from halo2_aes_tpu_torch.utils import timers

    last_tree = getattr(timers, "last_tree", None)
    tree = last_tree("prove") if last_tree else None
    if tree is None:
        return None
    s = [r.device_seconds for r in tree.spans
         if r.name == "grand_products" and r.parent == tree.root.id]
    return s[0] if s else None
