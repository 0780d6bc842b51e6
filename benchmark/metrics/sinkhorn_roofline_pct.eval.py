"""For every Sinkhorn op call in the traced sub-window: the least time of
the problems it solves, from the cost's shape and the iterations the call
asks for (its recorded arguments ``(cost, w1, w2, reg, iters, route)``;
the configured iterations where the trace does not record them;
``roofline.sinkhorn_bound``), over the device time of the kernels under
it; summed over the calls."""

from benchmark.roofline import sinkhorn_bound

OP = "fewshot_vit_tpu_torch::sinkhorn_pallas"
ITERS = 4  # the op's argument that holds the iterations


def read(run):
    if run.kind != "eval" or run.trace is None:
        return None
    least = spent = 0.0
    for call in run.trace.op_calls:
        if call.name != OP or not call.dims:
            continue
        asked = call.concrete[ITERS] if len(call.concrete) > ITERS else ""
        iters = int(float(asked)) if asked else run.extra.get("solver_iters")
        if not iters:
            continue
        b, n1, n2 = call.dims[0]
        least += sinkhorn_bound(b, n1, n2, int(iters))[0] * 1e-3
        spent += call.device_s
    return 100.0 * least / spent if spent > 0 else None
