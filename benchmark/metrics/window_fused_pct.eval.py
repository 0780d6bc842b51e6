"""Share of Swin's attended windows that the window kernel computed: the
program's ``encoder.windows_fused`` over its ``encoder.windows``, both
summed over the ``encoder.window_attn`` spans, in percent; 0 where no window
was fused."""

from benchmark.metrics._program_trace import _spans


def read(run):
    attn = _spans(run, "eval", "encoder.window_attn")
    windows = sum(s["counts"].get("encoder.windows", 0) for s in attn)
    if not windows:
        return None
    return 100.0 * sum(s["counts"].get("encoder.windows_fused", 0) for s in attn) / windows
