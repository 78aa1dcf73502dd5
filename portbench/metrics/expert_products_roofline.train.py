"""The experts' grouped products of the train steps inside the traced
span: their bound over the device time of the kernels below, %.  Per
MoE layer and step: the three products forward twice (remat's
recompute) and once backward (dX and dW), over b x s x top_k routed
rows (the capacity's drops not taken off) and every expert."""
from portbench import readers

# the kernels whose device time does this work
KERNELS = ("gmm_tc", "grouped_matmul", "gmm_bwd_tc", "gmm_bwd_cc")


def read(run):
    spans = readers.train_spans_in_trace(run)
    dm = run.dims
    if not spans or not dm.moe:
        return None
    a = run.mix["batch"] * run.mix["seq"] * dm.top_k
    per_step = readers.moe_layers(dm) * (
        2.0 * readers.gmm_products_s(dm, a, dm.experts)
        + readers.gmm_products_s(dm, a, dm.experts, backward=True))
    return readers.roofline(run, per_step * len(spans), KERNELS)
