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
    Sinkhorn kernel (``csrc/sinkhorn.cu``) behind ``solver: sinkhorn_pallas``.

Entry points (``models.make``, ``eval.episodic.evaluate``/``encode_dataset``,
``eval.emd_eval.evaluate_emd``, ``python -m fewshot_vit_tpu_torch.eval.run``
and ``python -m fewshot_vit_tpu_torch.eval.run_emd``) run on
``device="cuda"`` unless told ``device="cpu"``; without a card they raise.
"""

__version__ = "0.1.0"
