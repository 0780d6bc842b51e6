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
    labels the student's patches).

Entry points (``models.make``, ``eval.episodic.evaluate``/``encode_dataset``,
``eval.emd_eval.evaluate_emd``, and ``python -m fewshot_vit_tpu_torch.X`` for
X in ``eval.run``, ``eval.run_emd``, ``train.pretrain``, ``train.sun``,
``train.meta_tune``, ``train.meta_tune_emd``) run on ``device="cuda"`` unless told
``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"
