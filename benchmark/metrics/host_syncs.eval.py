"""Host synchronisations the program caused per batch: its ``host_syncs``
counter under its ``eval.batch`` span (blocking copies, ``.item()``,
``.cpu()``, as ``torch.cuda.set_sync_debug_mode`` reports them)."""

from benchmark.metrics._program_trace import per_occurrence


def read(run):
    return per_occurrence(run, "eval", "host_syncs", "eval.batch")
