"""Host synchronisations the program caused per step: its ``host_syncs``
counter under its ``train.step`` span (blocking copies, ``.item()``,
``.cpu()``, as ``torch.cuda.set_sync_debug_mode`` reports them)."""

from benchmark.metrics._program_trace import per_occurrence


def read(run):
    return per_occurrence(run, "train", "host_syncs", "train.step")
