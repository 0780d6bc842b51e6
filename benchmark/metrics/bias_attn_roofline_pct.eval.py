"""The least time of LeViT's biased attention over the device time of the
program's ``encoder.bias_attn`` spans, which hold that same work
(``roofline_levit.bias_attention_bound`` from the configuration's widths:
the projections and the attention, the span's input and output and its
weights). None where the ``encoder.attn_scores`` counted under the spans
differs from the scores the cell's shapes give (``images_per_batch`` images
a batch, ``reference/levit.py::scores_per_image`` an image): a program that
skips work reads nothing."""

from benchmark.metrics._program_trace import _spans
from benchmark.reference.levit import attentions, scores_per_image
from benchmark.roofline_levit import bias_attention_bound


def read(run):
    attn = _spans(run, "eval", "encoder.bias_attn")
    batches = _spans(run, "eval", "eval.batch")
    cfg, per_batch = run.extra.get("encoder_args"), run.extra.get("images_per_batch")
    if not attn or not batches or cfg is None or not per_batch:
        return None
    spent = sum(s["device_ms"] for s in attn)
    scores = sum(s["counts"].get("encoder.attn_scores", 0) for s in attn)
    forwards = len(attn) / len(attentions(cfg))
    images = forwards * per_batch
    if spent <= 0 or forwards != len(batches) or scores != images * scores_per_image(cfg):
        return None
    return 100.0 * bias_attention_bound(cfg, images, forwards, run.extra["dtype"]) / spent
