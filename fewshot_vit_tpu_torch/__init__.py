"""fewshot_vit_tpu_torch — the PyTorch/CUDA port of ``fewshot_vit_tpu``.

The JAX package stays the reference; this package mirrors its module layout
(``core``, ``data``, ``ops``, ``kernels``, ``models``, ``heads``, ``eval``,
``train``, ``checkpoint``) so each module's counterpart is found under the same path.
It imports ``torch``, numpy and scipy, never ``jax``/``flax`` or the JAX
package. The Pallas TPU kernels become CUDA C++ kernels for Hopper
(``sm_90a``) under ``csrc/``, built with ``nvcc`` at first use.

Ported so far:

  * slice 1, the SUN-M episodic eval: synthetic/miniImageNet arrays, the
    episode sampler, ``MetaBaseline`` over ``visformer_micro_80`` with BN
    folding, bf16 activations and the fused-MHSA kernel (``csrc/mhsa.cu``);
  * slice 2, the SUN-D episodic eval: ``DeepEMD`` over the same encoder in
    grid and fcn modes, EMD logits, SFC prototype refinement, and the
    Sinkhorn kernel (``csrc/sinkhorn.cu``) behind ``solver: sinkhorn_pallas``;
  * slice 3: both kernels redesigned for Hopper (a tensor-core MHSA route, a
    packed Sinkhorn route);
  * slice 4, the two meta-tuning trainers: ``train.meta_tune`` (SUN-M) and
    ``train.meta_tune_emd`` (SUN-D, with the Sinkhorn kernel in the training
    forward), training-mode Visformer (batch-statistics BN, dropout,
    drop-path), optimizer recipes on ``torch.optim``, checkpoints and resume;
  * slice 5, the first two training phases: ``train.pretrain`` (teacher CE
    with the device-side augmentation zoo, SAM, EMA, chunked staging) and
    ``train.sun`` (SUN meta-training: a frozen token-label teacher, whose
    stage-2 attention runs through the fused-MHSA kernel in every step,
    labels the student's patches);
  * slice 6: reference ``.pth`` and checkpoint loading in both eval CLIs,
    ``--sauc`` and the rest of the datasets;
  * slice 7, the rest of the encoder zoo (NesT, Swin, LeViT, LV-ViT, DeiT,
    ResNet-18/50, ResNet-12 and its DropBlock variant, ConvNet-4), each
    family's flax and reference ``.pth`` key rule, and the LeViT and
    ResNet-12 BN folds; the zoo runs no custom kernel, as in JAX;
  * slice 8: ``solver: exact`` (the C++ transportation simplex, host side,
    ``native/``), the research heads (``token-label-ep``, ``-ep-rw``,
    ``-ep-cr``, ``-v2``, ``meta-token``, ``-v2``, ``-v3``) with their metric
    functions and the ``utils`` names, attention capture in Visformer, NesT
    and Swin, ``eval.visualize`` (``--real-attn``) and the trainers'
    ``visualize_datasets`` grids;
  * slice 9: ``eval.run --int8`` (``models/quant.py``: int8 weights and
    activations, int32 products through ``torch._int_mm``), ``eval.export``
    (``torch.export`` programs that call both kernels as the custom ops
    ``fewshot_vit_tpu_torch::fused_mhsa`` / ``::sinkhorn_pallas``),
    ``core/watchdog.py`` and the trainers' ``--profile-dir``.

Entry points (``models.make``, ``eval.episodic.evaluate``/``encode_dataset``,
``eval.emd_eval.evaluate_emd``, and ``python -m fewshot_vit_tpu_torch.X`` for
X in ``eval.run``, ``eval.run_emd``, ``eval.visualize``, ``eval.export``,
``train.pretrain``, ``train.sun``, ``train.meta_tune``, ``train.meta_tune_emd``) run on ``device="cuda"`` unless told
``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"
