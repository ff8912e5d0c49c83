"""K2's share of its roofline: one ``ntt_many`` of 45 polys of 2^k
points on a coset (the shape of the quotient's sub-coset transforms at
the configuration's k), timed with CUDA events after a warm-up, against
the least time ``roofline.ntt_many_work`` allows.

The time is not read from the proof's trace: it is CUDA events (the
device's own clock) around standalone calls on random canonical data,
made after the window and the profiled proof."""

import torch

from benchmark import roofline

COUNT = 45
CALLS = 5


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    from halo2_aes_tpu_torch.ops import field as F
    from halo2_aes_tpu_torch.ops.ntt import domain, ntt_many

    k = ctx.config["k"]
    n = 1 << k
    g = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    flat = torch.randint(0, 1 << 16, (COUNT * n, 16), generator=g, device=ctx.device,
                         dtype=torch.int32)
    flat[:, 15] &= 0x1FFF                       # canonical: below 2^253 < p
    shift = F.powers_table(F.FR, 7, n, ctx.device)
    dom = domain(F.FR, k)
    ntt_many(dom, flat, COUNT, inverse=False, shift_pows=shift)
    torch.cuda.synchronize(ctx.device)
    times = []
    for _ in range(CALLS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        ntt_many(dom, flat, COUNT, inverse=False, shift_pows=shift)
        b.record()
        torch.cuda.synchronize(ctx.device)
        times.append(a.elapsed_time(b) / 1e3)
    seconds = sorted(times)[CALLS // 2]
    share, bound = roofline.share_percent(*roofline.ntt_many_work(COUNT, n, True), seconds)
    ctx.log(f"ntt_many {COUNT} x 2^{k}: {seconds * 1e3:.3f} ms, bound by {bound}")
    return share
