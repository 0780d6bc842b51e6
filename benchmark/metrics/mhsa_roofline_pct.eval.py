"""For every fused-MHSA op call in the traced sub-window: the least time of
the attention it computes, from its inputs' shapes and dtype
(``roofline.bound``), over the device time of the kernels under it; summed
over the calls."""

from benchmark.roofline import bound

OP = "fewshot_vit_tpu_torch::fused_mhsa"
DTYPES = {"c10::BFloat16": "bfloat16", "c10::Half": "float16", "float": "float32"}


def read(run):
    if run.kind != "eval" or run.trace is None:
        return None
    least = spent = 0.0
    for call in run.trace.op_calls:
        if call.name != OP or not call.dims or call.types[0] not in DTYPES:
            continue
        b, h, t, hd = call.dims[0]
        least += bound(b, h, t, hd, DTYPES[call.types[0]])[0] * 1e-3
        spent += call.device_s
    return 100.0 * least / spent if spent > 0 else None
