"""Device seconds of the witness of the traced run's profiled proof: the
sum of the ``witness.*`` root spans (``witness.build_pool``, the batched
AES trace, and ``witness.assemble_values``, the gather into columns)
recorded just before its ``prove`` span, each the time between its two
CUDA events.  One proof (n = 1).  None where the program records no
spans."""


def read(ctx):
    from halo2_aes_tpu_torch.utils import timers

    last_tree = getattr(timers, "last_tree", None)
    tree = last_tree("prove") if last_tree else None
    if tree is None:
        return None
    s = [r.device_seconds for r in tree.before if r.name.startswith("witness.")]
    return sum(s) if s else None
