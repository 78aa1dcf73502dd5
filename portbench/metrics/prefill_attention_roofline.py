"""Flash attention of the prefills inside the traced span: its bound over
the device time of the kernels below, %.  Per layer and prompt of s
tokens: 4 hq hd s (s + 1) / 2 flops; q, k, v read and o written once."""
from portbench import flops, readers

# the kernels whose device time does this work
KERNELS = ("flash_fwd_tc", "flash_fwd")


def read(run):
    ops = readers.serve_ops(run, "prefill", traced=True)
    if not ops:
        return None
    dm = run.dims
    bound = sum(flops.bound_s(
        4.0 * dm.hq * dm.hd * flops.visible_pairs(s),
        flops.BF16 * s * dm.hd * (2 * dm.hq + 2 * dm.hkv))
        for op in ops for s in op.lengths)
    return readers.roofline(run, dm.layers * bound, KERNELS)
