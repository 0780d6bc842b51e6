"""The port's twins of the repository's accelerator gates under ``tools/``:
``precision_check`` (bf16 against fp32 mean accuracy on the bench's
configuration) and ``learning_probe`` (the four training phases must give
real few-shot transfer on disjoint novel classes). Run each as
``python -m fewshot_vit_tpu_torch.tools.<name>``."""
