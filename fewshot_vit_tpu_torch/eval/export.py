"""Encoder export (counterpart: ``fewshot_vit_tpu/eval/export.py``): not
ported yet. ``python -m fewshot_vit_tpu_torch.eval.export`` refuses by name,
as the trainers refuse ``mesh:`` and the eval CLI ``--int8``."""

from __future__ import annotations

from ..train.runner import AUXILIARIES


def main(argv=None) -> None:
    raise NotImplementedError(f"'eval.export' (the encoder as torch.export) {AUXILIARIES}")


if __name__ == "__main__":
    main()
