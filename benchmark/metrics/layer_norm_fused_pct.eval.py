"""Share of the elements the encoder's LayerNorms normalised that the
LayerNorm kernel normalised: the program's ``encoder.norm_elems_fused`` over
its ``encoder.norm_elems``, both summed over the ``encoder.norm`` spans, in
percent; 0 where none was fused, None without the spans."""

from benchmark.metrics._program_trace import _spans


def read(run):
    norms = _spans(run, "eval", "encoder.norm")
    elems = sum(s["counts"].get("encoder.norm_elems", 0) for s in norms)
    if not elems:
        return None
    return 100.0 * sum(s["counts"].get("encoder.norm_elems_fused", 0) for s in norms) / elems
