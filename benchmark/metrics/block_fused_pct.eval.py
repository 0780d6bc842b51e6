"""Share of NesT's attended blocks that the block kernel computed: the
program's ``encoder.blocks_fused`` over its ``encoder.blocks``, both summed
over the ``encoder.block_attn`` spans, in percent; 0 where no block was
fused, None where no block was attended or where the program does not count
fused blocks (a tree before the block kernel), or without the spans."""

from benchmark.metrics._program_trace import _spans


def read(run):
    attn = _spans(run, "eval", "encoder.block_attn")
    blocks = sum(s["counts"].get("encoder.blocks", 0) for s in attn)
    if not blocks or not any("encoder.blocks_fused" in s["counts"] for s in attn):
        return None
    return 100.0 * sum(s["counts"].get("encoder.blocks_fused", 0) for s in attn) / blocks
