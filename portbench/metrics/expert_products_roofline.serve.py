"""The experts' grouped products of the prefills and decode steps inside
the traced span: their bound over the device time of the kernels
below, %.  Per MoE layer, the three products over the rows routed: a
prefill's s x top_k (the capacity's drops not taken off) through the
experts s tokens are expected to touch; a decode step's every slot x
top_k (the inactive slots route too) through the experts its live
rows and one inactive row are expected to touch."""
from portbench import flops, readers

# the kernels whose device time does this work
KERNELS = ("gmm_tc", "grouped_matmul")


def read(run):
    dm = run.dims
    pre = readers.serve_ops(run, "prefill", traced=True)
    dec = readers.serve_ops(run, "decode", traced=True)
    if pre is None or dec is None or not dm.moe or not (pre or dec):
        return None
    width = run.mix["engine"]["n_slots"]
    s = sum(readers.gmm_products_s(dm, n * dm.top_k,
                                   flops.live_experts(dm, n))
            for op in pre for n in op.lengths)
    s += sum(readers.gmm_products_s(
        dm, width * dm.top_k,
        flops.live_experts(dm, flops.routed_rows(len(op.lengths), width)))
        for op in dec)
    return readers.roofline(run, readers.moe_layers(dm) * s, KERNELS)
