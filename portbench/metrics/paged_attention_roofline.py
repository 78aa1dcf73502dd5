"""Paged attention of the decode steps inside the traced span: its bound
over the device time of the kernels below, %.  Per layer and step:
each live row's K and V read once over its length, its query read and
its output written; 4 hq hd flops a key."""
from portbench import flops, readers

# the kernels whose device time does this work
KERNELS = ("paged_split",)


def read(run):
    ops = readers.serve_ops(run, "decode", traced=True)
    if not ops:
        return None
    dm = run.dims
    per_layer = [flops.bound_s(
        4.0 * dm.hq * dm.hd * sum(op.lengths),
        flops.kv_bytes(dm, sum(op.lengths)) / dm.layers
        + 2.0 * flops.BF16 * len(op.lengths) * dm.hq * dm.hd)
        for op in ops]
    return readers.roofline(run, dm.layers * sum(per_layer), KERNELS)
