"""Device seconds of the commitments in the traced run's profiled proof:
the sum of the ``commit`` spans under its ``prove`` span (one a call of
``keygen.commit_many`` or ``commit_affine``: the MSMs and their affine
conversion), each the time between its two CUDA events.  One proof
(n = 1).  None where the program records no spans."""


def read(ctx):
    from halo2_aes_tpu_torch.utils import timers

    last_tree = getattr(timers, "last_tree", None)
    tree = last_tree("prove") if last_tree else None
    if tree is None:
        return None
    s = [r.device_seconds for r in tree.spans if r.name == "commit"]
    return sum(s) if s else None
