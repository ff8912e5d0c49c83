"""K2's share of its roofline as the traced run's profiled proof runs
it: 100 x the least time ``roofline.ntt_many_work`` allows for every
outermost ``ntt`` span of the proof (its count, 2^log_n and shift, the
transform asked for, whatever implements it), over the sum of those
spans' device seconds (each the time between its two CUDA events, at
least the call's device work).  One proof (n = 1).  None where the
program records no spans."""

from benchmark import roofline


def read(ctx):
    from halo2_aes_tpu_torch.utils import timers

    last_tree = getattr(timers, "last_tree", None)
    tree = last_tree("prove") if last_tree else None
    if tree is None:
        return None
    by_id = {r.id: r for r in tree.spans}

    def outermost(r):
        p = by_id.get(r.parent)
        while p is not None:
            if p.name == "ntt":
                return False
            p = by_id.get(p.parent)
        return True

    calls = [r for r in tree.spans if r.name == "ntt" and outermost(r)]
    seconds = sum(r.device_seconds for r in calls)
    if not calls or seconds <= 0:
        return None
    least = sum(roofline.least_seconds(*roofline.ntt_many_work(
        r.attrs["count"], 1 << r.attrs["log_n"], r.attrs["shifted"]))[0]
        for r in calls)
    ctx.log(f"ntt in proof: {len(calls)} calls, {seconds:.4f} s on the device, "
            f"{least:.4f} s at the roofline")
    return 100.0 * least / seconds
