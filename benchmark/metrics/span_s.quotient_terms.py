"""Device seconds of the quotient's constraint terms in the traced run's
profiled proof: the sum of the prover's ``quotient.terms`` spans, one a
sub-coset (the Horner fold of the constraint terms and the Z_H
division), each the time between its two CUDA events.  One proof
(n = 1).  None where the program records no spans."""


def read(ctx):
    from halo2_aes_tpu_torch.utils import timers

    last_tree = getattr(timers, "last_tree", None)
    tree = last_tree("prove") if last_tree else None
    if tree is None:
        return None
    s = [r.device_seconds for r in tree.spans if r.name == "quotient.terms"]
    return sum(s) if s else None
