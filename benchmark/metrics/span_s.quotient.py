"""Device seconds of the quotient phase of the traced run's profiled
proof: the prover's ``quotient`` span (y squeezed to x squeezed), the
time between its two CUDA events, with no synchronise in it.  One proof
(n = 1), where ``phase_s.quotient`` is a median over the window's
proofs synchronised at each challenge.  None where the program records
no spans."""


def read(ctx):
    from halo2_aes_tpu_torch.utils import timers

    last_tree = getattr(timers, "last_tree", None)
    tree = last_tree("prove") if last_tree else None
    if tree is None:
        return None
    s = [r.device_seconds for r in tree.spans
         if r.name == "quotient" and r.parent == tree.root.id]
    return s[0] if s else None
