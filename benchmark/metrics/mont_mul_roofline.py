"""K1's share of its roofline: ``field.mont_mul`` of a (45, 2^k) array
by one broadcast row of 2^k (the quotient's products at the
configuration's k), timed with CUDA events after a warm-up, against the
least time ``roofline.mont_mul_work`` allows.

The time is not read from the proof's trace: it is CUDA events (the
device's own clock) around standalone calls on random canonical data,
made after the window and the profiled proof."""

import torch

from benchmark import roofline

ROWS = 45
CALLS = 21


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    from halo2_aes_tpu_torch.ops import field as F

    n = 1 << ctx.config["k"]
    g = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    a = torch.randint(0, 1 << 16, (ROWS, n, 16), generator=g, device=ctx.device,
                      dtype=torch.int32)
    b = torch.randint(0, 1 << 16, (n, 16), generator=g, device=ctx.device,
                      dtype=torch.int32)
    a[..., 15] &= 0x1FFF
    b[..., 15] &= 0x1FFF
    F.mont_mul(F.FR, a, b)
    torch.cuda.synchronize(ctx.device)
    times = []
    for _ in range(CALLS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        F.mont_mul(F.FR, a, b)
        e.record()
        torch.cuda.synchronize(ctx.device)
        times.append(s.elapsed_time(e) / 1e3)
    seconds = sorted(times)[CALLS // 2]
    share, bound = roofline.share_percent(*roofline.mont_mul_work(ROWS, n), seconds)
    ctx.log(f"mont_mul ({ROWS}, 2^{ctx.config['k']}) x row: {seconds * 1e3:.3f} ms, "
            f"bound by {bound}")
    return share
