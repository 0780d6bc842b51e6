#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fewshot_vit_tpu_torch``) on one GPU.

Phases, in order; any failure exits non-zero:
  1. require CUDA;
  2. print the card's name and power limit (nvidia-smi);
  3. build every CUDA kernel of the port from ``csrc/`` (one nvcc per source,
     all started together) and load it;
  4. hold each kernel against its plain PyTorch version on the card, the
     bare launch of each route writing an output pre-filled with NaN and
     the op (the path every caller takes) beside it, every route asserted:
     fused MHSA in fp32
     and bf16 at the SUN-M shape and at a short and a long case, more bf16
     shapes through the tensor-core route, and a neighbour check (only heads
     0, 2, 4 computed: heads 1, 3, 5 must stay NaN); Sinkhorn in fp32 at the
     SUN-D grid and fcn shapes, a ragged case, the kernel's N limit, the
     packed route's edges (odd batch, N = 16, 17, 32, 33) and 0 and 1
     iterations;
  5. SUN-M: 5-way 1-shot 15-query episodic eval, MetaBaseline over
     visformer_micro_80 at full width and depth, seeded weights, BN folded,
     bf16, fused attention on, on the synthetic 20 x 600 dataset resident on
     the card; the MHSA launch count must be 2 per episode batch, all on the
     tensor-core route. Then the same episodes in fp32 (TF32 off) and in
     bf16, fused-kernel path against plain-attention path;
  6. SUN-D: DeepEMD over the same encoder (BN unfolded, as the JAX SUN-D eval
     runs it), ``solver: sinkhorn_pallas``, bf16 encoder, fp32 EMD: 1-shot
     grid (1 Sinkhorn launch on the packed route and 2 MHSA launches on the
     tensor-core route per episode batch), then fp32 with
     the kernel against ``sinkhorn_detached`` on the same episodes; 1-shot
     fcn (N = 25); one batch of 5-shot grid with SFC (20 steps);
  7. time both paths (episodes/s in turns: the default routes, the old
     routes forced, the kernel's alternative) and each kernel in turns (old
     route, new route), its plain version and, for MHSA,
     ``scaled_dot_product_attention`` (a yardstick only) beside the bound;
  8. SUN-D meta-tuning (``train.meta_tune_emd``'s own functions): the
     geometry of ``configs/sund_mini_visformer_1shot.yaml`` (grid, 5-way
     1-shot 15-query, ``bs`` 2, fp32) with ``solver: sinkhorn_pallas``, 4
     optimizer steps, then a validation epoch as the trainer runs it. One
     Sinkhorn launch per training episode, all on the packed route, no MHSA
     launch in training although ``use_pallas_attn`` is on, finite losses,
     every parameter moved, every BN statistic bit-identical. Then the first
     step's loss and gradients with the kernel against ``sinkhorn_detached``
     from the same weights, episode and grid ratios;
  9. SUN-M meta-tuning (``train.loop.make_meta_tune_epoch``): the geometry of
     ``configs/meta_tune_mini_visformer_1shot.yaml`` (10-way 1-shot 5-query,
     8 episodes a step, drop-path 0.5), 10 steps in bf16 and 4 in fp32, one
     ``evaluate`` pass after each, ``freeze_bn`` both ways, and two seeded
     runs whose losses must be bit-identical;
 10. time both trainers in turns; run both trainer CLIs for two epochs on a
     small synthetic config in a temporary directory, then resume them;
 11. phase-1 pretraining (``train.loop.make_pretrain_epoch``): the geometry
     of ``configs/pretrain_mini_visformer.yaml`` (a synthetic split at
     miniImageNet train geometry, 64 classes x 600 at 84x84, ``protocol:
     raw``, resident on the card; batch 512, cropaug, AdamW 5e-4 scaled by
     batch with cosine warmup, drop-path 0.5, ``use_pallas_attn``) in fp32
     and bf16, then one SAM and one EMA run; no MHSA launch in training; the
     validation CE epoch and ``fs_eval`` with 2 MHSA launches per forward,
     on the general route in fp32 and the tensor-core route in bf16;
 12. phase-2 SUN (``train.loop.make_sun_epoch``): the teacher assembled from
     the checkpoint phase 11 saved, the dual view, batch 512, 2 MHSA
     launches per step (general route with an fp32 teacher, tensor-core
     route with ``teacher_dtype: bfloat16``); then one step with the
     kernel teacher against the plain-attention teacher, fp32, TF32 off:
     soft labels, loss and every gradient;
 13. the pretrain -> SUN -> meta-tune CLI chain on a small synthetic config,
     closed by both eval CLIs: ``eval.run`` with ``load:`` on meta-tune's
     ``max-va``, ``eval.run_emd`` (``sinkhorn_pallas``, grid) with
     ``load_encoder:`` on SUN's; no random-weights warning, both kernels
     launched;
 14. the eval CLI from a reference-format ``.pth`` (``model_sd`` with
     ``num_batches_tracked`` buffers, and SUN-D's ``params`` / ``module.``
     layout) of a seeded MetaBaseline at full width: the loaded state dict
     equals the source tensor for tensor; ``--fold-bn --bf16`` over 2000
     episodes of the 20 x 600 split prints the accuracy that in-process
     ``evaluate`` gives on the same episodes, with 2 MHSA launches per
     8-episode batch on the tensor-core route; fp32 takes the general route;
 15. ``--sauc``, 2000 2-way episodes in bf16 (launches counted), and the fp32
     kernel path against the plain-attention path (mean |dAUC| <= 0.005);
 16. the new loaders: a tiered-ImageNet-format split (160 test classes x 100
     images at 84x84, ``resize_crop`` to 80) and a CIFAR-FS-format split (20
     classes x 600 PNGs at 32x32, resized to 80, CIFAR stats), each scored by
     ``eval.run`` from the ``.pth``; without PIL on the machine, the tiered
     split at 80x80 and ``protocol: raw`` only, and the script says so;
 17. (run right after phase 12, while its split is resident) the encoder
     zoo's pretraining at the configs' geometry on phase 11's resident split (batch 512, cropaug, AdamW 5e-4 scaled by batch, cosine
     warmup): ``nest_micro_v2_gpsa``, ``swin_micro_resembed_80``,
     ``levit_micro_80`` (drop-path 0.5) and ``lvvit_micro_80`` at full
     width, 3 steps in fp32 and 3 in bf16 each: finite losses, every
     parameter and BN statistic moved, no kernel launched; steps/s and peak
     memory; a checkpoint per family;
 18. ``eval.run`` over each of them, ``load_encoder:`` on its checkpoint, 400
     episodes bf16, accuracies equal to in-process ``evaluate``; LeViT's
     ``--fold-bn`` against unfolded in fp32 on the same episodes;
 19. ``configs/meta_tune_im800_resnet18.yaml``'s geometry: MetaBaseline over
     ``resnet18`` from a reference-format ``.pth`` (loaded tensor for tensor),
     ``freeze_bn``, 5-way 1-shot 15-query, 4 episodes a step, SGD 1e-3, 4
     steps: BN statistics unchanged, parameters moved;
 20. every other registered encoder at full width, one batch of 640 images
     at its own input size in fp32 and bf16: finite, the JAX package's
     shapes, fp32 ms per batch; a reference-format ``.pth`` round trip per
     family. No zoo path launches either kernel, as no zoo encoder reaches
     a Pallas kernel in the JAX package;
 21. (after phase 16) ``solver: exact``: the ``eval.run_emd`` CLI from a
     DeepEMD checkpoint this phase writes, the geometry of
     ``configs/sund_mini_visformer_1shot.yaml`` (grid, 13 nodes), 104
     1-shot episodes, bf16 encoder, 8 a batch: the host-solver warning, 2
     MHSA launches a batch and no Sinkhorn launch; the same episodes with
     ``sinkhorn_pallas`` in process; accuracies, episodes/s and the host
     solver's seconds. Then, fp32 with TF32 off, the exact flows of one
     batch's 3,000 problems meet both marginals to 1e-6 and cost no more
     than the Sinkhorn kernel's flows plus 1e-6; the kernel attention path
     against plain attention under exact over 64 episodes (the accuracy
     rule); one ``meta_tune_emd`` step with exact, fp32, ``bs`` 2: finite
     loss, every parameter moved, BN statistics untouched;
 22. the 7 research heads (``token-label-ep``, ``-ep-rw``, ``-ep-cr``,
     ``-v2``, ``meta-token``, ``-v2``, ``-v3``) at full width over the
     synthetic 20 x 600 split, 5-way 1- and 5-shot, 15 queries, 4 episodes
     a forward, bf16 and fp32: JAX's output shapes, finite, ms per forward,
     2 MHSA launches per encoder call (meta-token encodes twice); then the
     fp32 kernel attention path against plain attention on 4 batches per
     (head, shot), the main logits' accuracy (``compute_acc_kshots`` for
     meta-token, top-1 of ``y`` per image for ``-v2``) under the accuracy
     rule;
 23. ``eval.visualize`` with ``--n 16`` from the phase-14 ``.pth`` in both
     modes (2 MHSA launches a run, fp32), and ``--real-attn`` over the NesT
     and Swin checkpoints of phase 17 (run right after phase 18): 16 JPGs,
     maps in [0, 1], the card's maps within 1e-3 of the CPU port's from the
     same weights and images; one pretrain CLI epoch with
     ``visualize_datasets: true`` writes JAX's four PNG names;
 24. (after phase 23, from the phase-14 ``.pth``) int8: each kind of int8
     layer at the eval CLI's batch of 640 images (the stem's 3x3/s2 with K
     padded from 27 to 32, a 3x3 with K 1152, the grouped 3x3, a 2x2/s2
     patch embed, qkv, the K 2048 1x1) gives an int32 ``torch._int_mm``
     result EQUAL to a float64 product of the same int8 operands; then the
     ``eval.run --int8`` CLI with and without ``--bf16`` beside ``--fold-bn``
     in both dtypes, 400 1-shot episodes each: accuracies equal to
     in-process ``evaluate`` of the head built as the CLI builds it,
     episodes/s, 2 MHSA launches a batch (tensor-core route in bf16,
     general in fp32) and 2 for ``--int8``'s calibration forward,
     |acc(int8) - acc(folded fp32)| < 0.08 (JAX's gate);
 25. ``eval.export`` through its CLI: the episode scorer (``--fold-bn
     --bf16`` and fp32, 8 episodes a call, and an fp32 one traced on the CPU
     with ``--platforms cpu,cuda``), the encoder (batch 128), and the EMD
     scorer at ``sund_mini_visformer_1shot.yaml``'s geometry with ``solver:
     sinkhorn_pallas``, 1-shot and 5-shot with SFC at the 5-shot config's
     ``sfc_*`` (20 of its 100 steps): export seconds, ``.pt2`` MB, graph nodes; no kernel launched
     while tracing;
 26. every artifact loaded and called in ONE fresh process that imports
     only torch and ``fewshot_vit_tpu_torch.kernels`` (for the two ops), on
     seeded uint8 episodes: ms per call and the launches counted inside each
     call (fused MHSA 2 per encoder forward, Sinkhorn 1 per EMD call and 0
     for SFC's inner flows); held against the in-process forward (fp32
     logits within 1e-4; bf16 and 5-shot SFC by the accuracy rule), and the
     ``cpu,cuda`` artifact moved to the card against the one traced there;
 27. the pretrain CLI for 2 epochs with ``--profile-dir``: a Chrome trace of
     epoch 2 with CUDA kernel events;
 28. both kernels re-timed through their custom ops at the PERF table's
     shapes: events around 20 calls, the device work alone (calls queued
     behind a sleeping kernel) for the op and the bare launch, and the
     host's dispatch time a call;
 29. (after phase 28, from the phase-14 ``.pth``) the mesh, one rank a
     process, launched from here with ``python -m torch.distributed.run``:
     this process exports the fp32 scorer with ``--data-shards 2`` and
     starts one NCCL rank (``mesh: {data: 1}``: an all-reduce, then a SUN
     step); while it runs, this process makes the one-rank twin of each
     mesh path (``eval.run --fold-bn --bf16`` and ``eval.run_emd`` 1-shot
     grid bf16 over the same episodes, the SUN-D and SUN steps), then times
     ``evaluate`` alone on the card;
 30. two gloo ranks on cuda:0 (two ranks cannot share a card over NCCL):
     which collectives gloo takes with CUDA tensors; ``eval.run --mesh-data
     2`` (256 episodes) and ``eval.run_emd --mesh-data 2`` (64 episodes),
     every rank returning the whole result, held to the one-rank run by the
     accuracy rule; ``evaluate(mesh=)``'s episodes/s; one ``meta_tune_emd``
     step (``bs`` 2, one episode a rank, fp32); the 2-shard scorer served by
     both ranks against phase 26's unsharded artifact (fp32, 1e-4); one SUN
     step of 512 images (256 a rank, global BN statistics, the dual view
     and drop-path drawn for the whole batch, fp32 teacher, SGD) with host
     clocks around its collectives. Launches counted in each rank: fused
     MHSA 2 per encoder forward a rank (the same batches as one rank, half
     the episodes), Sinkhorn 1 per EMD batch and 1 per training episode a
     rank;
 31. the trainer steps of both groups held to the one-rank ones by the
     trainer rules (loss 1e-4, parameters 2e-5, BN statistics 1e-5; the
     stem within 2e-5 or 1e-2 of its update's max-abs, the stem rule);
 32. (after phase 31) the bench entry (``fewshot_vit_tpu_torch.bench``, the
     protocol of the repository's ``bench.py``: 1024 5-way 1-shot episodes,
     128 a batch, bf16, BN folded, a warm pass, then the timed one) and its
     ``--int8``: one JSON line each with 2 MHSA launches per batch on the
     tensor-core route (32; ``--int8`` 2 more for its calibration forward);
     the timed pass's episodes again with the general route forced and with
     plain attention, held by the bf16 rule;
 33. ``tools.precision_check`` at JAX's settings (512 episodes, fp32 64 a
     batch on the MHSA kernel's general route, bf16 128 on its tensor-core
     route): acc_fp32 > 0.3 and abs_diff <= 0.005, JAX's gate;
 34. ``tools.learning_probe`` at JAX's depth (CE pretrain, SUN,
     Meta-Baseline tune, SUN-D EMD tune at 12/8/3/2 epochs, 200 episodes;
     the 5-shot SFC evaluation over ``LPROBE_5SHOT_EPISODES``), gated by
     ``TestLearningQuality``'s asserts, no kernel launched (as in JAX); then
     the trained weights re-scored with each kernel against its plain path
     in fp32 by the accuracy rule (p3 with the fused MHSA, p4 1-shot with
     ``sinkhorn_pallas``);
 35. ``graft_entry.entry()``'s forward on the card and
     ``python -m fewshot_vit_tpu_torch.graft_entry --n 2``
     (``dryrun_multichip(2)``: two ranks on cuda:0 over gloo, the five
     patterns): five ok lines;
 36. the ``model`` axis: two gloo ranks on cuda:0 under ``mesh: {data: 1,
     model: 2}`` each run the SUN step and the pretrain step of 512 images
     (fp32, SGD) with column-parallel wide layers, held to one rank's steps
     by the trainer rules bound to the update; MHSA launches per rank.
     The rank processes of 35 and 36 run beside phases 33-34;
 37. print the ``training``, ``eval_clis``, ``slice8``, ``slice9``,
     ``slice10``, ``slice11`` and kernels' JSON lines, then the result line.

Run from the root of a checkout:  python3 chip_smoke.py [--profile DIR]
(the ranks of phases 30-31 and 36 run this file with ``--mesh-rank DIR``).
(``--profile DIR`` also writes torch.profiler tables of one SUN-M and one
SUN-D grid episode batch, of one training step of each trainer, and of one
pretrain step of the slowest zoo family.)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

WAY, SHOT, QUERY = 5, 1, 15
EP_PER_BATCH = 128          # the bench configuration
N_EPISODES = 256            # main-path run: 2 episode batches
N_TIMED = 1024              # episodes/s run: 8 episode batches
SUND_EP_PER_BATCH = 8       # SUN-D: 8 * 80 images * 13 patches = 8,320 encoder images
SUND_EPISODES = 64          # SUN-D grid run: 8 episode batches
SUND_FCN_EPISODES = 32
SUND_TIMED = 32
# the SUN-D eval CLI's lr and batch at 20 of its 100 steps; the export phase
# runs the 5-shot config's lr and batch at 20 steps too (SFC5_KW)
SFC_KW = {"steps": 20, "lr": 100.0, "batch_size": 4}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}  # dense bf16 tensor / fp32 non-tensor
# special-function units: 16 exp2/log2 results per clock per SM on compute
# capability 9.0 (NVIDIA's arithmetic-throughput table), 132 SMs at the
# 1.98 GHz boost clock
SFU_PER_S = 132 * 16 * 1.98e9
TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}
SINKHORN_TOL = 1e-4
ENCODER = "visformer_micro_80"
# the geometry of configs/sund_mini_visformer_1shot.yaml, on the kernel's solver
SUND_TRAIN = {"way": 5, "shot": 1, "query": 15, "bs": 2, "lr": 5e-4, "step_size": 10,
              "gamma": 0.5, "max_epoch": 100, "temperature": 12.5, "solver_iters": 100,
              "deepemd": "grid", "patch_list": [2, 3], "patch_ratio": 2.0, "image_size": 80,
              "solver": "sinkhorn_pallas"}
SUND_TRAIN_STEPS = 4        # 8 training episodes of 80 images * 13 patches
SUND_VAL_EPISODES = 64      # cached validation, 16 episodes a batch as the trainer groups them
# the geometry of configs/meta_tune_mini_visformer_1shot.yaml
SUNM_TRAIN = {"n_train_way": 10, "n_train_shot": 1, "n_train_query": 5, "ep_per_batch": 8,
              "n_way": 5, "n_shot": 1, "n_query": 15, "max_epoch": 100, "optimizer": "sgd",
              "optimizer_args": {"lr": 1e-3, "weight_decay": 5e-4, "gamma": 0.5,
                                 "milestones": [20, 40, 60, 80]}}
SUNM_STEPS = {"torch.bfloat16": 10, "torch.float32": 4}
SUNM_VAL_EPISODES = 64
# the geometry of configs/pretrain_mini_visformer.yaml and sun_mini_visformer.yaml
PRE_TRAIN = {"batch_size": 512, "max_epoch": 300, "optimizer": "adamw",
             "optimizer_args": {"lr": 5e-4, "scale_lr_by_batch": True, "weight_decay": 0.05,
                                "schedule": "cosine", "warmup_epochs": 5}}
MINI_TRAIN = {"n_classes": 64, "n_per_class": 600, "image_size": 84, "seed": 5}
PRE_STEPS = 4               # a counted run of each dtype; the timed runs take as many
SUN_KW = {"soft_k": 5, "bg_tokens": 10, "token_weight": 0.5}
SUN_STEPS = 3
FS_EPISODES = 16            # fs_eval: 2 episode batches of 8 per shot
CLI_EPISODES = 2000         # the eval CLI's default protocol, 8 episodes a batch
CLI_EP_PER_BATCH = 8
CLI_FP32_EPISODES = 400
CHAIN_EVAL_EPISODES = 200
LOADER_EPISODES = 1000
# tiered-ImageNet's test split has 160 classes (about 1,300 images each: cut to
# 100 here); CIFAR-FS's test split is 20 classes x 600 images at 32x32
TIERED_TEST = {"n_classes": 160, "n_per_class": 100, "seed": 7}
CIFAR_TEST = {"n_classes": 20, "n_per_class": 600, "image_size": 32, "seed": 8}
# the encoder zoo: (encoder, its config's encoder_args, the config) of phase 17
ZOO_PRETRAIN = (("nest_micro_v2_gpsa", {}, "pretrain_mini_nest.yaml"),
                ("swin_micro_resembed_80", {}, "pretrain_tiered_swin.yaml"),
                ("levit_micro_80", {"drop_path_rate": 0.5}, "pretrain_mini_levit.yaml"),
                ("lvvit_micro_80", {}, "pretrain_mini_lvvit.yaml"))
ZOO_PRE_STEPS = 3           # a counted run of each dtype, then a timed run of as many
ZOO_EVAL_EPISODES = 400
# the geometry of configs/meta_tune_im800_resnet18.yaml
ZOO_META = {"way": 5, "shot": 1, "query": 15, "ep_per_batch": 4, "max_epoch": 50,
            "optimizer": "sgd", "optimizer_args": {"lr": 1e-3, "weight_decay": 1e-4}}
ZOO_META_STEPS = 4
ZOO_BATCH = 640             # one eval-CLI batch: 8 episodes x 80 images
# every other registered encoder -> (input edge, dense map shape, pooled width),
# the JAX package's output shapes (jax.eval_shape of its apply)
ZOO_SHAPES = {
    "nest_nano_80": (80, (5, 5, 384), 384),
    "nest_micro_80": (80, (5, 5, 512), 512),
    "nest_micro_resembed_80": (80, (5, 5, 512), 512),
    "nest_micro_resembed_2x_80": (80, (10, 10, 512), 512),
    "nest_micro_resembed_ada_80": (80, (5, 5, 512), 512),
    "nest_micro_v2_rel_80": (80, (5, 5, 512), 512),
    "nest_12m_v3": (80, (5, 5, 512), 512),
    "swin_nano_patch4_window5_80": (96, (3, 3, 512), 512),  # built for 96 px
    "swin_micro_v2_resembed_ada_80": (80, (5, 5, 576), 576),
    "deit_tiny_patch16_224": (224, (14, 14, 192), 192),
    "deit_small_patch16_224": (224, (14, 14, 384), 384),
    "deit_base_patch16_224": (224, (14, 14, 768), 768),
    "deit_nano_patch16_224": (224, (14, 14, 224), 224),
    "deit_nano_patch6_84": (84, (14, 14, 224), 224),
    "deit_micro_patch6_84": (84, (14, 14, 272), 272),
    "resnet50": (80, (3, 3, 2048), 2048),
    "resnet12": (80, (5, 5, 512), 512),
    "resnet12-wide": (80, (5, 5, 640), 640),
    "resnet12-drop": (80, (10, 10, 640), 640),
    "convnet4": (80, (5, 5, 64), 1600),
}
# one name per family for the reference-format .pth round trip
ZOO_PTH = ("nest_micro_v2_rel_80", "swin_micro_v2_resembed_ada_80", "levit_micro_80",
           "lvvit_micro_80", "deit_small_patch16_224", "resnet50", "resnet18", "resnet12-wide",
           "resnet12-drop", "convnet4")
# LeViT's first subsample adds a constant to the token stream that the next
# subsample's BN-normed q and kv remove: its output bias has a true gradient
# of 0, so an optimizer step may leave it where it was
ZOO_STATIC = {"levit_micro_80": ("encoder.blocks.2.proj.1.bn.bias",)}
# slice 8: solver exact, the research heads, the visualization paths
EXACT_EPISODES = 104        # the run_emd CLI with solver exact, bf16, 8 episodes a batch
EXACT_CHECK_EPISODES = 64   # fp32 kernel vs plain attention under solver exact
EXACT_PROBLEMS = 2000       # exact against Sinkhorn flows: at least this many problems
HEAD_NAMES = ("token-label-ep", "token-label-ep-rw", "token-label-ep-cr", "token-label-v2",
              "meta-token", "meta-token-v2", "meta-token-v3")
HEAD_E = 4                  # episodes a forward (ep-cr's attention: 1.6 GB in fp32)
HEAD_BATCHES = 4            # forwards per (head, shot) in the fp32 kernel-vs-plain check
VIS_N = 16
VIS_DATA = {"n_classes": 4, "n_per_class": 8, "image_size": 80, "seed": 9}


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _zero_counts(*wrappers) -> None:
    """Set every launch count of the kernels' wrappers to 0, per route too."""
    for w in wrappers:
        w.launches = 0
        for route in w.route_launches:
            w.route_launches[route] = 0


def _time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(b, h, t, hd, dtype):
    """Least time for one attention call: q, k, v read once and o written once
    over the memory rate, or 4*T*T*hd flops per (b, h) over the peak rate for
    the dtype, whichever is larger."""
    import torch

    elem = torch.empty((), dtype=dtype).element_size()
    bytes_ = 4 * b * h * t * hd * elem
    flops = 4 * b * h * t * t * hd
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def _sinkhorn_bound(b, n1, n2, iters):
    """Least time for one Sinkhorn call: cost, w1, w2 read once and the flow
    written once over the memory rate, or the larger of its exp/log count over
    the special-function rate and its other fp32 operations (add, max,
    subtract, sum per element per half-round) over the fp32 rate."""
    bytes_ = 4 * b * (2 * n1 * n2 + n1 + n2)
    sfu = b * (iters * (2 * n1 * n2 + n1 + n2) + n1 * n2 + n1 + n2)
    flops = b * iters * 2 * n1 * n2 * 4
    by_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    by_ops = max(sfu / SFU_PER_S, flops / PEAK_FLOPS["torch.float32"]) * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def _ot_problem(b, n1, n2, gen, dev):
    """Costs 1 - cos in [0, 2] and normalized marginals, as DeepEMD hands them over."""
    import torch

    from fewshot_vit_tpu_torch.ops.emd import normalize_weights

    cost = 2.0 * torch.rand(b, n1, n2, generator=gen, device=dev)
    w1 = normalize_weights(torch.rand(b, n1, generator=gen, device=dev))
    w2 = normalize_weights(torch.rand(b, n2, generator=gen, device=dev))
    return cost, w1, w2


def _max_err(got, want) -> float:
    """max |got - want| in fp32, a NaN counting as infinite."""
    return (got.float() - want.float()).abs().max().nan_to_num(float("inf")).item()


def _check_mhsa(gen, dev, b_main):
    """Phase 4, fused MHSA: kernel vs plain version, every case through heads
    split out of a packed qkv tensor. The bare launch writes a (B, T, H, hd)
    view that starts as NaN, so an unwritten element cannot pass; the op,
    called beside it, allocates its own output. Returns max|d| per case."""
    import torch

    from fewshot_vit_tpu_torch.kernels import attention as mhsa_mod
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa, fused_mhsa_reference

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("stage2", b_main, 6, 100, 42, (f32, bf16)), ("short", b_main, 6, 25, 85, (f32, bf16)),
             # the SUN teacher's and the pretrain validation's shape: batch 512
             ("sun teacher", PRE_TRAIN["batch_size"], 6, 100, 42, (f32, bf16)),
             ("long", 64, 4, 512, 128, (f32, bf16)),
             # bf16 only: the tensor-core route's edges
             ("one token", 3, 1, 1, 1, (bf16,)), ("odd", 2, 3, 33, 97, (bf16,)),
             ("t64 hd48", 32, 4, 64, 48, (bf16,)), ("limit", 4, 2, 128, 128, (bf16,)),
             ("beyond", 4, 2, 129, 64, (bf16,))]
    errs = {}
    for name, b, h, t, hd, dtypes in cases:
        for dtype in dtypes:
            route = "tensor_core" if dtype == bf16 and t <= 128 else "general"
            qkv = torch.randn(b, t, 3, h, hd, generator=gen, device=dev).to(dtype)
            q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
            out = torch.full((b, t, h, hd), float("nan"), dtype=dtype, device=dev)
            before = dict(fused_mhsa.route_launches)
            mhsa_mod._launch(q, k, v, out.transpose(1, 2), hd ** -0.5, None)
            got = fused_mhsa(q, k, v, hd ** -0.5)
            want = fused_mhsa_reference(q, k, v, hd ** -0.5)
            torch.cuda.synchronize()
            if fused_mhsa.route_launches[route] != before[route] + 2:
                _fail(f"fused_mhsa {name} {dtype}: expected two launches (bare, op) on the "
                      f"{route} route, counts went {before} -> {fused_mhsa.route_launches}")
            err = max(_max_err(o, want) for o in (out.transpose(1, 2), got))
            errs[(name, str(dtype))] = err
            ok = err <= TOL[str(dtype)]
            print(f"kernel vs plain {name} ({b},{h},{t},{hd}) {dtype}: "
                  f"max|d|={err:.3e} tol={TOL[str(dtype)]:g} {'ok' if ok else 'FAIL'}; "
                  f"{route} route")
            if not ok:
                _fail(f"fused_mhsa disagrees with its plain version at {name} {dtype}")
            if route == "tensor_core":  # the general route on the same inputs
                out.fill_(float("nan"))
                mhsa_mod._launch(q, k, v, out.transpose(1, 2), hd ** -0.5, "general")
                got = fused_mhsa(q, k, v, hd ** -0.5, route="general")
                err = max(_max_err(o, want) for o in (out.transpose(1, 2), got))
                if not err <= TOL[str(dtype)]:
                    _fail(f"fused_mhsa (general route forced) disagrees at {name}: {err:.3e}")
            del qkv, q, k, v, out, got, want

    # neighbour check at the stage-2 shape: only heads 0, 2, 4 are computed,
    # through views; the columns of heads 1, 3, 5 lie between theirs in every
    # token row of the output and must still be NaN
    b, h, t, hd = b_main, 6, 100, 42
    qkv = torch.randn(b, t, 3, h, hd, generator=gen, device=dev).to(bf16)
    q, k, v = (x.transpose(1, 2)[:, ::2] for x in qkv.unbind(2))
    out = torch.full((b, t, h, hd), float("nan"), dtype=bf16, device=dev)
    before = fused_mhsa.route_launches["tensor_core"]
    mhsa_mod._launch(q, k, v, out.transpose(1, 2)[:, ::2], hd ** -0.5, None)
    got = fused_mhsa(q, k, v, hd ** -0.5)
    want = fused_mhsa_reference(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    err = max(_max_err(o, want) for o in (out.transpose(1, 2)[:, ::2], got))
    untouched = bool(out[:, :, 1::2].isnan().all())
    print(f"neighbour check ({b},{h},{t},{hd}) bf16, heads 0, 2, 4 computed: max|d|={err:.3e}, "
          f"heads 1, 3, 5 still NaN: {untouched}")
    if fused_mhsa.route_launches["tensor_core"] != before + 2:
        _fail("the neighbour check did not take the tensor-core route")
    if not err <= TOL[str(bf16)] or not untouched:
        _fail("fused_mhsa wrote outside the heads it was given, or disagrees on them")
    return errs


def _check_sinkhorn(gen, dev):
    """Phase 4, Sinkhorn: kernel vs plain version, the bare launch into a
    NaN-filled output and the op beside it; returns max|d| per case."""
    import torch

    from fewshot_vit_tpu_torch.kernels import sinkhorn as sk_mod
    from fewshot_vit_tpu_torch.kernels.sinkhorn import (
        MAX_NODES,
        sinkhorn_pallas,
        sinkhorn_reference,
    )

    b_main = SUND_EP_PER_BATCH * WAY * QUERY * WAY  # (query, prototype) pairs per batch
    errs = {}
    cases = (("grid", (b_main, 13, 13), 100), ("fcn", (b_main, 25, 25), 100),
             ("ragged", (5, 9, 13), 100), ("limit", (64, MAX_NODES, MAX_NODES), 100),
             # one SUN-D training episode: 75 queries x 5 prototypes
             ("train episode", (WAY * QUERY * WAY, 13, 13), 100),
             ("sfc inner", (160, 13, 13), 100), ("odd batch", (b_main + 1, 13, 13), 100),
             ("half-warp full", (5, 16, 16), 100), ("mixed", (5, 17, 9), 100),
             ("warp full", (5, 32, 32), 100), ("beyond packed", (5, 33, 33), 100),
             ("no rounds", (7, 13, 13), 0), ("one round", (7, 25, 13), 1))
    for name, (b, n1, n2), iters in cases:
        cost, w1, w2 = _ot_problem(b, n1, n2, gen, dev)
        route = "packed" if max(n1, n2) <= 32 else "general"
        before = dict(sinkhorn_pallas.route_launches)
        bare = torch.full_like(cost, float("nan"))
        sk_mod._launch(cost, w1, w2, bare, 0.05, iters, None)
        got = sinkhorn_pallas(cost, w1, w2, iters=iters)
        want = sinkhorn_reference(cost, w1, w2, iters=iters)
        torch.cuda.synchronize()
        if sinkhorn_pallas.route_launches[route] != before[route] + 2:
            _fail(f"sinkhorn_pallas {name}: expected two launches (bare, op) on the {route} "
                  f"route, counts went {before} -> {sinkhorn_pallas.route_launches}")
        err = max(_max_err(bare, want), _max_err(got, want))
        row = (got.sum(-1) - w1).abs().max().item()
        col = (got.sum(-2) - w2).abs().max().item()
        errs[name] = err
        ok = err <= SINKHORN_TOL
        print(f"kernel vs plain sinkhorn {name} ({b},{n1},{n2}) iters {iters}: max|d|={err:.3e} "
              f"tol={SINKHORN_TOL:g} {'ok' if ok else 'FAIL'}; kernel marginal error "
              f"rows {row:.3e}, columns {col:.3e}; {route} route")
        if not ok:
            _fail(f"sinkhorn_pallas disagrees with its plain version at {name}")
        if route == "packed":  # the general route on the same problem
            bare.fill_(float("nan"))
            sk_mod._launch(cost, w1, w2, bare, 0.05, iters, "general")
            got = sinkhorn_pallas(cost, w1, w2, iters=iters, route="general")
            err = max(_max_err(bare, want), _max_err(got, want))
            if not err <= SINKHORN_TOL:
                _fail(f"sinkhorn_pallas (general route forced) disagrees at {name}: {err:.3e}")
    return errs


def _run_sund(dev, ds, images_dev, tag, gen, profile, card):
    """Phases 6 and 7 for SUN-D; returns the Sinkhorn kernel's JSON entry."""
    import torch

    from fewshot_vit_tpu_torch.core.registry import models
    from fewshot_vit_tpu_torch.eval.emd_eval import evaluate_emd, sample_emd_episode_indices
    from fewshot_vit_tpu_torch.heads import deepemd as _deepemd  # noqa: F401
    from fewshot_vit_tpu_torch.kernels import attention as mhsa_mod
    from fewshot_vit_tpu_torch.kernels import sinkhorn as sinkhorn_mod
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas, sinkhorn_reference

    def head_for(dtype, solver):
        return models.make("deepemd", encoder="visformer_micro_80",
                           encoder_args={"use_pallas_attn": True}, solver=solver,
                           dtype=dtype, device=dev, seed=0)

    def run(head, n, mode="grid", shot=SHOT, indices=None, seed=1):
        return evaluate_emd(head, ds, way=WAY, shot=shot, query=QUERY, n_episodes=n,
                            ep_per_batch=SUND_EP_PER_BATCH, mode=mode, indices=indices,
                            sfc_kw=SFC_KW, images_dev=images_dev, seed=seed, device=dev)

    def counted(label, head, n, mode="grid", shot=SHOT):
        n_batches = math.ceil(n / SUND_EP_PER_BATCH)
        _zero_counts(fused_mhsa, sinkhorn_pallas)
        t0 = time.perf_counter()
        acc, ci, accs = run(head, n, mode, shot)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mhsa, sk = fused_mhsa.launches, sinkhorn_pallas.launches
        routes = {"fused_mhsa": dict(fused_mhsa.route_launches),
                  "sinkhorn_pallas": dict(sinkhorn_pallas.route_launches)}
        print(f"SUN-D {label}: {n} episodes, acc={acc * 100:.2f} +- {ci * 100:.2f} %, "
              f"sinkhorn_pallas launches={sk}, fused_mhsa launches={mhsa} "
              f"({n_batches} batches), by route {routes}, {wall:.2f} s")
        if sk != n_batches or mhsa != 2 * n_batches:
            _fail(f"SUN-D {label}: expected {n_batches} sinkhorn_pallas and "
                  f"{2 * n_batches} fused_mhsa launches, counted {sk} and {mhsa}")
        if routes != {"fused_mhsa": {"general": 0, "tensor_core": mhsa},
                      "sinkhorn_pallas": {"general": 0, "packed": sk}}:
            _fail(f"SUN-D {label}: launches left the tensor-core and packed routes: {routes}")
        if accs.shape != (n,) or not ((accs >= 0) & (accs <= 1)).all():
            _fail(f"SUN-D {label}: episode accuracies malformed: shape {accs.shape}")
        return sk, wall

    main_head = head_for(torch.bfloat16, "sinkhorn_pallas")
    launches, _ = counted("1-shot grid bf16", main_head, SUND_EPISODES)
    route_launches = dict(sinkhorn_pallas.route_launches)

    idx = sample_emd_episode_indices(ds, SUND_EPISODES, WAY, SHOT + QUERY, 2)
    _, _, accs_k = run(head_for(torch.float32, "sinkhorn_pallas"), SUND_EPISODES, indices=idx)
    _, _, accs_p = run(head_for(torch.float32, "sinkhorn_detached"), SUND_EPISODES, indices=idx)
    differ = float((accs_k != accs_p).mean())
    mean_d = float(abs(accs_k - accs_p).mean())
    print(f"SUN-D fp32 (TF32 off) sinkhorn_pallas vs sinkhorn_detached: episodes "
          f"differing={differ:.4f}, mean|dacc|={mean_d:.5f}, acc {accs_k.mean():.4f} vs "
          f"{accs_p.mean():.4f}")
    if differ > 0.01 or mean_d > 0.005:
        _fail("SUN-D fp32 kernel path and plain path disagree")

    counted("1-shot fcn bf16 (N = 25)", main_head, SUND_FCN_EPISODES, mode="fcn")
    _, wall = counted("5-shot grid bf16 with SFC", main_head, SUND_EP_PER_BATCH, shot=5)
    print(f"timing {tag}: SUN-D 5-shot grid with SFC ({SFC_KW['steps']} steps, inner "
          f"flows on torch ops): {wall:.2f} s for one batch of {SUND_EP_PER_BATCH} episodes")

    detached_head = head_for(torch.bfloat16, "sinkhorn_detached")
    eps = {"sinkhorn_pallas": [], "old routes": [], "sinkhorn_detached": []}
    for solver in ("sinkhorn_pallas", "old routes", "sinkhorn_detached", "sinkhorn_detached",
                   "old routes", "sinkhorn_pallas"):
        head = detached_head if solver == "sinkhorn_detached" else main_head
        old = "general" if solver == "old routes" else None
        with mhsa_mod.force_route(old), sinkhorn_mod.force_route(old):
            run(head, SUND_EP_PER_BATCH, seed=3)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(head, SUND_TIMED, seed=4)
            eps[solver].append(SUND_TIMED / (time.perf_counter() - t0))
    print(f"timing {tag}: SUN-D 1-shot grid bf16 episodes/s, sinkhorn_pallas: "
          f"{eps['sinkhorn_pallas']}; sinkhorn_detached: {eps['sinkhorn_detached']}; "
          f"sinkhorn_pallas with both kernels' general routes forced: {eps['old routes']} "
          f"({SUND_TIMED} episodes at ep_per_batch {SUND_EP_PER_BATCH})")

    b_main = SUND_EP_PER_BATCH * WAY * QUERY * WAY
    b_sfc = SUND_EP_PER_BATCH * SFC_KW["batch_size"] * WAY  # SFC's inner call at 5-shot
    entry = None
    b_train = WAY * QUERY * WAY  # one training episode's (query, prototype) pairs
    for name, b, n in (("grid", b_main, 13), ("fcn", b_main, 25), ("sfc inner", b_sfc, 13),
                       ("train episode", b_train, 13)):
        cost, w1, w2 = _ot_problem(b, n, n, gen, dev)
        route = sinkhorn_mod.sinkhorn_route(n, n)
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            with sinkhorn_mod.force_route("general" if which == "old" else None):
                times[which].append(_time_ms(lambda: sinkhorn_pallas(cost, w1, w2)))
        ms, prev_ms = sum(times["new"]) / 2, sum(times["old"]) / 2
        plain_ms = _time_ms(lambda: sinkhorn_reference(cost, w1, w2), reps=5, warm=1)
        bound_ms, bound_by = _sinkhorn_bound(b, n, n, 100)
        print(f"timing {tag}: sinkhorn_pallas {name} ({b},{n},{n}) iters 100: kernel "
              f"{ms:.4f} ms ({route} route; {times['new']}), general route {prev_ms:.4f} ms "
              f"({times['old']}), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
              f"kernel/bound {ms / bound_ms:.2f}")
        if name == "grid":  # the main path's shape
            entry = {"kernel_route": route, "ms": ms, "prev_ms": prev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
        if name == "train episode":
            train_entry = {"shape": [b, n, n], "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by}
        if name in ("grid", "fcn") and not ms < prev_ms:
            _fail(f"the packed sinkhorn_pallas ({ms:.4f} ms) is not faster than the general "
                  f"route ({prev_ms:.4f} ms) at {name}")

    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(main_head, SUND_EP_PER_BATCH, seed=5)
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=60)
        with open(os.path.join(profile, "profile_sund_grid.txt"), "w") as f:
            f.write(f"{card}\n{table}\n")
        print("\n".join(table.splitlines()[:25]))
    return {"name": "sinkhorn_pallas", "route": "cuda",
            "source": "fewshot_vit_tpu_torch/csrc/sinkhorn.cu",
            "replaces": "fewshot_vit_tpu/kernels/sinkhorn.py:71",
            "launches": launches, "route_launches": route_launches, **entry,
            "library_ms": None, "train_episode": train_entry}


def _state_copy(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _is_bn_stat(key: str) -> bool:
    return key.endswith("running_mean") or key.endswith("running_var")


def _check_moved(label, module, before, bn_frozen, static=()):
    """Every parameter changed (but those in ``static``, whose true gradient
    is 0); every BN running statistic bit-identical when ``bn_frozen``,
    changed otherwise."""
    import torch

    params = {k for k, _ in module.named_parameters()}
    for k, v in module.state_dict().items():
        same = torch.equal(v, before[k])
        if k in params and same and k not in static:
            _fail(f"{label}: parameter {k} did not change")
        if _is_bn_stat(k) and same != bn_frozen:
            _fail(f"{label}: BN statistic {k} {'changed' if bn_frozen else 'did not change'}")


def _profile_to(path, card, fn):
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=60)
    with open(path, "w") as f:
        f.write(f"{card}\n{table}\n")
    print("\n".join(table.splitlines()[:25]))


def _train_sund(dev, ds, images_dev, val_ds, tag, profile, card):
    """Phase 8 and its share of phase 10. Returns (training entry, launch counts)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from fewshot_vit_tpu_torch.core import rng as rng_mod
    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import models
    from fewshot_vit_tpu_torch.data.patches import draw_grid_ratios
    from fewshot_vit_tpu_torch.data.sampler import EpisodeSampler
    from fewshot_vit_tpu_torch.eval.emd_eval import evaluate_emd, sample_emd_episode_indices
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.train import meta_tune_emd as tt
    from fewshot_vit_tpu_torch.train.loop import metrics_mean
    from fewshot_vit_tpu_torch.train.state import TrainState

    c = SUND_TRAIN
    way, shot, query, bs = c["way"], c["shot"], c["query"], c["bs"]
    labels = torch.arange(way, device=dev).repeat(query)

    def make(solver, dtype=torch.float32):
        head = models.make("deepemd", encoder=ENCODER, encoder_args={"use_pallas_attn": True},
                           temperature=c["temperature"], solver_iters=c["solver_iters"],
                           solver=solver, dtype=dtype, device=dev, seed=0)
        fn = tt.make_emd_episode_fn(
            head, way, shot, query,
            tt.make_patch_fn(c["deepemd"], c["patch_list"], c["patch_ratio"], c["image_size"],
                             train=True),
            ds.mean, ds.std, sfc=False, train=True)
        state = TrainState(head, tt.build_sund_optimizer(Config(c), head.parameters()))
        return head, fn, state, tt.make_emd_epoch_fn(fn, labels, bs)

    def draw_idx(steps, epoch):
        sampler = EpisodeSampler(ds.labels, steps, way, shot + query, bs)
        rng = rng_mod.np_rng(0, epoch)
        idx = np.stack([tt.interleaved(sampler.batch(rng), bs, way, shot + query)
                        for _ in range(steps)]).astype(np.int64)
        return torch.from_numpy(idx).to(dev)

    # the slice's main path: 4 optimizer steps, then the trainer's validation
    head, fn, state, epoch_fn = make(c["solver"])
    before = _state_copy(head)
    idx = draw_idx(SUND_TRAIN_STEPS, 1)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(fused_mhsa, sinkhorn_pallas)
    state.optimizer.set_epoch(0)
    t0 = time.perf_counter()
    m = epoch_fn(state, images_dev, idx, (0, 1))
    losses = m["loss"].cpu().numpy()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    train_counts = {"fused_mhsa": dict(fused_mhsa.route_launches),
                    "sinkhorn_pallas": dict(sinkhorn_pallas.route_launches)}
    n_train = SUND_TRAIN_STEPS * bs
    print(f"SUN-D meta-tuning fp32 {c['solver']}: {SUND_TRAIN_STEPS} steps of bs {bs} "
          f"({way}-way {shot}-shot {query}-query grid, {way * (shot + query) * 13} patch images "
          f"an episode), losses {losses.tolist()}, acc {metrics_mean(m)['acc']:.4f}, launches "
          f"{train_counts}, {wall:.2f} s, peak memory {peak:.2f} GiB")
    if not np.isfinite(losses).all():
        _fail(f"SUN-D meta-tuning: a loss is not finite: {losses}")
    if train_counts != {"fused_mhsa": {"general": 0, "tensor_core": 0},
                        "sinkhorn_pallas": {"general": 0, "packed": n_train}}:
        _fail(f"SUN-D meta-tuning: expected {n_train} packed Sinkhorn launches (one per "
              f"training episode) and no MHSA launch, counted {train_counts}")
    _check_moved("SUN-D meta-tuning", head, before, bn_frozen=True)

    val_idx = sample_emd_episode_indices(val_ds, SUND_VAL_EPISODES, way, shot + query, seed=0)
    val_images = torch.from_numpy(val_ds.images).to(dev)

    def validate(h):
        h.eval()
        return evaluate_emd(h, val_ds, way=way, shot=shot, query=query, ep_per_batch=16,
                            mode=c["deepemd"], cached=True, indices=val_idx,
                            patch_list=c["patch_list"], patch_ratio=c["patch_ratio"],
                            image_size=c["image_size"], images_dev=val_images, seed=0,
                            device=dev)

    va, ci, accs = validate(head)
    torch.cuda.synchronize()
    total = {"fused_mhsa": dict(fused_mhsa.route_launches),
             "sinkhorn_pallas": dict(sinkhorn_pallas.route_launches)}
    n_val_batches = math.ceil(SUND_VAL_EPISODES / 16)
    n_enc_batches = math.ceil(len(val_ds) / 128)  # the node cache encodes 128 images a batch
    # fp32 attention takes the kernel's general route (the tensor-core one is bf16);
    # one launch per stage-2 block (T = 100) and encoder batch
    n_attn = len(head.encoder.stage2)
    val_counts = {"fused_mhsa": total["fused_mhsa"]["general"],
                  "sinkhorn_pallas": total["sinkhorn_pallas"]["packed"] - n_train}
    print(f"SUN-D validation after training (cached, fp32): {SUND_VAL_EPISODES} episodes, "
          f"acc={va * 100:.2f} +- {ci * 100:.2f} %, launches in validation {val_counts}")
    if (val_counts != {"fused_mhsa": n_attn * n_enc_batches, "sinkhorn_pallas": n_val_batches}
            or total["fused_mhsa"]["tensor_core"] or total["sinkhorn_pallas"]["general"]):
        _fail(f"SUN-D validation: expected {n_attn * n_enc_batches} MHSA and {n_val_batches} "
              f"Sinkhorn launches on the general and packed routes, counted {total}")
    if accs.shape != (SUND_VAL_EPISODES,) or not ((accs >= 0) & (accs <= 1)).all():
        _fail(f"SUN-D validation: episode accuracies malformed: shape {accs.shape}")
    if not (fused_mhsa.launches and sinkhorn_pallas.launches):
        _fail("the SUN-D trainer's path (training steps + validation) missed a kernel")

    # kernel path against plain path, under grad: the first step's first
    # episode from the same weights, indices and injected grid ratios
    ep = images_dev[idx[0, 0]][None]
    ratios = draw_grid_ratios(torch.Generator(device=dev).manual_seed(7),
                              way * (shot + query), len(c["patch_list"]))
    out = {}
    for solver in ("sinkhorn_pallas", "sinkhorn_detached"):
        h, f, _, _ = make(solver)
        loss = F.cross_entropy(f(ep, [0], ratios=ratios)[0].float(), labels)
        loss.backward()
        out[solver] = (loss.item(), {k: p.grad for k, p in h.named_parameters()})
        del h, f, loss
    (loss_k, grads_k), (loss_p, grads_p) = out["sinkhorn_pallas"], out["sinkhorn_detached"]
    worst, worst_key = 0.0, None
    for k, g in grads_p.items():
        rel = ((grads_k[k] - g).abs().max() / g.abs().max()).item()
        if not rel <= worst:  # also catches NaN
            worst, worst_key = rel, k
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    print(f"SUN-D training step fp32 (TF32 off), sinkhorn_pallas vs sinkhorn_detached under "
          f"grad: loss {loss_k:.6f} vs {loss_p:.6f} (rel {rel_loss:.2e}, tol 1e-4), worst "
          f"gradient max|d|/max|g| {worst:.2e} at {worst_key} (tol 1e-3, "
          f"{len(grads_p)} tensors)")
    if not rel_loss <= 1e-4 or not worst <= 1e-3:
        _fail("SUN-D training: the kernel path and the plain path disagree under grad")
    del out, grads_k, grads_p
    torch.cuda.empty_cache()

    # timings, in turns: episodes/s of training with each solver (fp32), then bf16
    timed_steps = 2
    eps = {"sinkhorn_pallas": [], "sinkhorn_detached": []}
    runs = {s: make(s) for s in eps}
    for solver in ("sinkhorn_pallas", "sinkhorn_detached", "sinkhorn_detached",
                   "sinkhorn_pallas"):
        _, _, st, ef = runs[solver]
        ef(st, images_dev, draw_idx(1, 2), (0, 2))  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ef(st, images_dev, draw_idx(timed_steps, 3), (0, 3))["loss"].cpu()
        eps[solver].append(timed_steps * bs / (time.perf_counter() - t0))
    del runs
    torch.cuda.empty_cache()
    _, _, st16, ef16 = make("sinkhorn_pallas", torch.bfloat16)
    ef16(st16, images_dev, draw_idx(1, 2), (0, 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss16 = ef16(st16, images_dev, draw_idx(timed_steps, 3), (0, 3))["loss"].cpu().numpy()
    eps_bf16 = timed_steps * bs / (time.perf_counter() - t0)
    if not np.isfinite(loss16).all():
        _fail(f"SUN-D meta-tuning bf16: a loss is not finite: {loss16}")
    print(f"timing {tag}: SUN-D meta-tuning episodes/s (bs {bs}, {timed_steps} steps a run), "
          f"fp32 sinkhorn_pallas: {eps['sinkhorn_pallas']}; fp32 sinkhorn_detached: "
          f"{eps['sinkhorn_detached']}; bf16 encoder sinkhorn_pallas: {eps_bf16:.3f}")
    if profile:
        _profile_to(os.path.join(profile, "profile_train_sund.txt"), card,
                    lambda: epoch_fn(state, images_dev, draw_idx(1, 4), (0, 4)))
    entry = {"sund_train_episodes_per_s": {**eps, "sinkhorn_pallas_bf16": eps_bf16},
             "sund_train_peak_gib": peak, "sund_train_losses": losses.tolist(),
             "sund_val_acc": va}
    return entry, {"sund_meta_tune": train_counts, "sund_validation": val_counts}


def _train_sunm(dev, ds, images_dev, val_ds, tag, profile, card):
    """Phase 9 and its share of phase 10. Returns (training entry, launch counts)."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.core import rng as rng_mod
    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import models
    from fewshot_vit_tpu_torch.data.sampler import EpisodeSampler
    from fewshot_vit_tpu_torch.eval.episodic import evaluate
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.train.loop import make_meta_tune_epoch
    from fewshot_vit_tpu_torch.train.runner import build_optimizer
    from fewshot_vit_tpu_torch.train.state import TrainState

    c = SUNM_TRAIN
    way, shot, query, epb = c["n_train_way"], c["n_train_shot"], c["n_train_query"], c["ep_per_batch"]
    val_images = torch.from_numpy(val_ds.images).to(dev)

    def make(dtype, drop_path=0.5, seed=0):
        head = models.make("meta-baseline", encoder=ENCODER,
                           encoder_args={"drop_path_rate": drop_path, "use_pallas_attn": True},
                           dtype=dtype, device=dev, seed=seed)
        return head, TrainState(head, build_optimizer(Config(c), head.parameters()))

    def draw_idx(steps, epoch):
        sampler = EpisodeSampler(ds.labels, steps, way, shot + query, epb)
        idx = np.stack(list(sampler.epoch(rng_mod.np_rng(0, epoch)))).astype(np.int64)
        return torch.from_numpy(idx).to(dev)

    def run(state, steps, epoch, freeze_bn=False):
        fn = make_meta_tune_epoch(way, shot, query, epb, freeze_bn=freeze_bn,
                                  mean=ds.mean, std=ds.std)
        state.optimizer.set_epoch(0)
        return fn(state, images_dev, draw_idx(steps, epoch), (0, epoch))

    counts, entry = {}, {}
    n_val_batches = math.ceil(SUNM_VAL_EPISODES / epb)
    for dtype in (torch.bfloat16, torch.float32):
        steps = SUNM_STEPS[str(dtype)]
        head, state = make(dtype)
        before = _state_copy(head)
        _zero_counts(fused_mhsa, sinkhorn_pallas)
        t0 = time.perf_counter()
        losses = run(state, steps, 1)["loss"].cpu().numpy()
        wall = time.perf_counter() - t0
        if fused_mhsa.launches or sinkhorn_pallas.launches:
            _fail(f"SUN-M meta-tuning {dtype}: a training step launched a kernel: "
                  f"{fused_mhsa.route_launches} {sinkhorn_pallas.route_launches}")
        print(f"SUN-M meta-tuning {dtype}: {steps} steps of {epb} episodes ({way}-way {shot}-shot "
              f"{query}-query, {epb * way * (shot + query)} images a step, drop-path 0.5), "
              f"losses {losses.tolist()}, temp {head.temp.item():.6f}, {wall:.2f} s with warm-up")
        if not np.isfinite(losses).all():
            _fail(f"SUN-M meta-tuning {dtype}: a loss is not finite: {losses}")
        _check_moved(f"SUN-M meta-tuning {dtype}", head, before, bn_frozen=False)  # temp too
        head.eval()
        acc, ci, accs = evaluate(head, val_ds, n_episodes=SUNM_VAL_EPISODES, way=c["n_way"],
                                 shot=c["n_shot"], query=c["n_query"], ep_per_batch=epb, seed=0,
                                 images_dev=val_images, device=dev)
        torch.cuda.synchronize()
        routes = dict(fused_mhsa.route_launches)
        n_mhsa = len(head.encoder.stage2) * n_val_batches  # per stage-2 block and eval batch
        want = ({"general": 0, "tensor_core": n_mhsa} if dtype == torch.bfloat16
                else {"general": n_mhsa, "tensor_core": 0})
        print(f"SUN-M validation after training {dtype}: {SUNM_VAL_EPISODES} episodes, "
              f"acc={acc * 100:.2f} +- {ci * 100:.2f} %, fused_mhsa launches {routes}")
        if routes != want or sinkhorn_pallas.launches:
            _fail(f"SUN-M validation {dtype}: expected fused_mhsa launches {want}, got {routes}")
        if accs.shape != (SUNM_VAL_EPISODES,) or not ((accs >= 0) & (accs <= 1)).all():
            _fail(f"SUN-M validation {dtype}: episode accuracies malformed")
        counts[f"sunm_meta_tune_{str(dtype).split('.')[1]}"] = {"fused_mhsa": 0, "sinkhorn_pallas": 0}
        counts[f"sunm_validation_{str(dtype).split('.')[1]}"] = {"fused_mhsa": routes,
                                                                 "sinkhorn_pallas": 0}
        entry[f"sunm_val_acc_{str(dtype).split('.')[1]}"] = acc
        del head, state

    head, state = make(torch.bfloat16)
    before = _state_copy(head)
    losses = run(state, 2, 1, freeze_bn=True)["loss"].cpu().numpy()
    _check_moved("SUN-M meta-tuning, freeze_bn", head, before, bn_frozen=True)
    print(f"SUN-M meta-tuning bf16 with freeze_bn: losses {losses.tolist()}, every BN "
          f"statistic bit-identical, every parameter moved")

    # determinism of the port's generators: same seed, same indices -> same
    # losses, bit for bit; without drop-path as the plainest case, then with
    # it, where every step's masks come from the (seed, epoch, step) generator
    cudnn_det, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, True
    for drop_path in (0.0, 0.5):
        a = run(make(torch.float32, drop_path)[1], 3, 1)["loss"].cpu().numpy()
        b = run(make(torch.float32, drop_path)[1], 3, 1)["loss"].cpu().numpy()
        print(f"SUN-M meta-tuning fp32, drop-path {drop_path}, two runs from one seed: "
              f"losses {a.tolist()} and {b.tolist()}")
        if not np.array_equal(a, b):
            _fail(f"SUN-M meta-tuning is not deterministic at drop-path {drop_path}")
    other = run(make(torch.float32, 0.5)[1], 3, 2)["loss"].cpu().numpy()
    if np.array_equal(other, a):
        _fail("another epoch key gave the same losses: the generators are not keyed")
    torch.backends.cudnn.deterministic = cudnn_det

    # timings, in turns
    timed = 6
    rate = {"torch.bfloat16": [], "torch.float32": []}
    states = {str(d): make(d)[1] for d in (torch.bfloat16, torch.float32)}
    for name in ("torch.bfloat16", "torch.float32", "torch.float32", "torch.bfloat16"):
        run(states[name], 1, 2)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(states[name], timed, 3)["loss"].cpu()
        rate[name].append(timed / (time.perf_counter() - t0))
    print(f"timing {tag}: SUN-M meta-tuning steps/s ({epb} episodes, "
          f"{epb * way * (shot + query)} images a step; {timed} steps a run), bf16: "
          f"{rate['torch.bfloat16']}; fp32 (TF32 off): {rate['torch.float32']}; "
          f"episodes/s = {epb} x steps/s")
    if profile:
        _profile_to(os.path.join(profile, "profile_train_sunm.txt"), card,
                    lambda: run(states["torch.bfloat16"], 1, 4))
    entry.update({"sunm_train_steps_per_s": {"bf16": rate["torch.bfloat16"],
                                             "fp32": rate["torch.float32"]},
                  "sunm_episodes_per_step": epb})
    return entry, counts


_CLI_COMMON = """
train_dataset: synthetic
train_dataset_args: {n_classes: 12, n_per_class: 30, image_size: 80}
val_dataset: synthetic
val_dataset_args: {n_classes: 10, n_per_class: 25, image_size: 80, seed: 3}
max_epoch: %d
resume: %s
"""
_CLI_SUNM = _CLI_COMMON + """
model: meta-baseline
model_args: {encoder: visformer_micro_80, dtype: bf16,
             encoder_args: {drop_path_rate: 0.5, use_pallas_attn: true}}
n_way: 5
n_shot: 1
n_query: 5
n_train_way: 6
n_train_query: 5
ep_per_batch: 4
train_batches: 3
optimizer: sgd
optimizer_args: {lr: 1.e-3, weight_decay: 5.e-4, milestones: [1], gamma: 0.5}
val_episodes: 16
"""
_CLI_SUND = _CLI_COMMON + """
model_args: {encoder: visformer_micro_80, encoder_args: {use_pallas_attn: true}}
deepemd: grid
patch_list: [2, 3]
patch_ratio: 2
solver: sinkhorn_pallas
way: 5
shot: 1
query: 5
bs: 2
train_batches: 2
lr: 5.e-4
step_size: 1
gamma: 0.5
val_episode: 16
test_episode: 16
"""


def _run_clis(tag):
    """Phase 10: both trainer CLIs through ``parse_args`` + ``main`` on the
    card, two epochs into a temporary --save-root, then a third with
    ``resume: true``."""
    import tempfile

    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.train import meta_tune, meta_tune_emd
    from fewshot_vit_tpu_torch.train.runner import parse_args

    with tempfile.TemporaryDirectory() as tmp:
        for name, module, text in (("sunm", meta_tune, _CLI_SUNM), ("sund", meta_tune_emd, _CLI_SUND)):
            cfg = os.path.join(tmp, f"{name}.yaml")
            argv = ["--config", cfg, "--save-root", os.path.join(tmp, "save"), "--name", name]
            run_dir = os.path.join(tmp, "save", name)
            with open(cfg, "w") as f:
                f.write(text % (2, "false"))
            _zero_counts(fused_mhsa, sinkhorn_pallas)
            t0 = time.perf_counter()
            state = module.main(*parse_args(f"chip_smoke {name}", argv))
            wall = time.perf_counter() - t0
            with open(cfg, "w") as f:
                f.write(text % (3, "true"))
            resumed = module.main(*parse_args(f"chip_smoke {name}", argv))
            with open(os.path.join(run_dir, "log.txt")) as f:
                log = f.read()
            made = sorted(os.listdir(run_dir))
            print(f"CLI {name} {tag}: 2 epochs in {wall:.1f} s, then resumed for epoch 3; "
                  f"steps {state.step} -> {resumed.step}; wrote {made}; launches "
                  f"fused_mhsa={fused_mhsa.launches} sinkhorn_pallas={sinkhorn_pallas.launches}")
            need = ["epoch-last", "log.txt", "max-va", "metrics.jsonl", "resume"]
            if name == "sund":
                need.append("results.txt")
            if any(n not in made for n in need):
                _fail(f"CLI {name}: expected {need} in the run directory, found {made}")
            if ("resumed full train state from epoch 2" not in log or "\nepoch 3 " not in log
                    or log.count("\nepoch 2 ") != 1):
                _fail(f"CLI {name}: the resumed run did not start at epoch 3")
            if resumed.step != state.step * 3 // 2:
                _fail(f"CLI {name}: step count {resumed.step} after resume, from {state.step}")
            if not fused_mhsa.launches or (name == "sund" and not sinkhorn_pallas.launches):
                _fail(f"CLI {name}: its run launched no kernel")


def _steps_idx(n, steps, epoch, dev):
    """The first ``steps`` batches of the pretrain/SUN epoch draw (seed 0)."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.core import rng as rng_mod
    from fewshot_vit_tpu_torch.train.loop import batch_indices

    idx = batch_indices(n, PRE_TRAIN["batch_size"], rng_mod.np_rng(0, epoch))[:steps]
    return torch.from_numpy(idx.astype(np.int64)).to(dev)


def _expect_counts(label, mhsa_route, n_mhsa, n_sinkhorn=0):
    """The launches since the last zeroing: ``n_mhsa`` fused-MHSA launches
    on ``mhsa_route``, ``n_sinkhorn`` packed Sinkhorn launches, no other."""
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas

    return _check_launches(label, {"fused_mhsa": dict(fused_mhsa.route_launches),
                                   "sinkhorn_pallas": dict(sinkhorn_pallas.route_launches)},
                           mhsa_route, n_mhsa, n_sinkhorn)


def _check_launches(label, counts, mhsa_route, n_mhsa, n_sinkhorn=0):
    """``counts`` (by kernel and route) must be ``n_mhsa`` fused-MHSA
    launches on ``mhsa_route`` and ``n_sinkhorn`` packed Sinkhorn launches,
    no other."""
    return _check_counts(label, counts, {
        "fused_mhsa": {r: (n_mhsa if r == mhsa_route else 0) for r in ("general", "tensor_core")},
        "sinkhorn_pallas": {"general": 0, "packed": n_sinkhorn}})


def _check_counts(label, counts, want):
    if counts != want:
        _fail(f"{label}: expected launches {want}, counted {counts}")
    return counts


def _train_pretrain(dev, mini, images_dev, labels_dev, val_ds, fs_ds, fs_images, tag, profile,
                    card, ckpt_dir):
    """Phase 11. Returns (training entry, launch counts)."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.checkpoint.io import save_variables
    from fewshot_vit_tpu_torch.core import rng as rng_mod
    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import models
    from fewshot_vit_tpu_torch.data.augment import make_cropaug_fn
    from fewshot_vit_tpu_torch.heads import classifier as _classifier  # noqa: F401
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.train.loop import (
        batch_indices,
        eval_metrics,
        make_eval_ce_epoch,
        make_pretrain_epoch,
    )
    from fewshot_vit_tpu_torch.train.runner import build_optimizer, fs_eval
    from fewshot_vit_tpu_torch.train.state import TrainState

    bs = PRE_TRAIN["batch_size"]
    cropaug = make_cropaug_fn(mini.mean, mini.std, out_size=80)

    def make(dtype, ema=False):
        model = models.make("classifier", encoder=ENCODER,
                            encoder_args={"drop_path_rate": 0.5, "use_pallas_attn": True},
                            classifier_args={"n_classes": mini.n_classes}, dtype=dtype,
                            device=dev, seed=0)
        state = TrainState(model, build_optimizer(Config(PRE_TRAIN), model.parameters(), bs),
                           ema=ema)
        state.optimizer.set_epoch(6)  # past the warmup
        return model, state

    def run(state, steps, epoch, **kw):
        fn = make_pretrain_epoch(cropaug, mini.mean, mini.std, **kw)
        return fn(state, images_dev, labels_dev, _steps_idx(len(mini), steps, epoch, dev),
                  (0, epoch))

    vidx = batch_indices(len(val_ds), bs, rng_mod.np_rng(0, 0), drop_last=False)
    vidx = torch.from_numpy(vidx.astype(np.int64)).to(dev)
    val_images = torch.from_numpy(val_ds.images).to(dev)
    val_labels = torch.from_numpy(val_ds.labels.astype(np.int64)).to(dev)
    eval_fn = make_eval_ce_epoch(mini.mean, mini.std, n_valid=len(val_ds))
    counts, entry = {}, {"pretrain_peak_gib": {}, "pretrain_losses": {}, "pretrain_val": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        route = "general" if dtype == torch.float32 else "tensor_core"
        model, state = make(dtype)
        before = _state_copy(model)
        _zero_counts(fused_mhsa, sinkhorn_pallas)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = run(state, PRE_STEPS, 1)["loss"].cpu().numpy()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts[f"pretrain_train_{name}"] = _expect_counts(f"pretrain {name} training", route, 0)
        print(f"pretrain {name}: {PRE_STEPS} steps of {bs} images (cropaug, drop-path 0.5, "
              f"{mini.n_classes} classes), losses {losses.tolist()}, {wall:.2f} s with warm-up, "
              f"peak memory {peak:.2f} GiB; fused_mhsa launches in training 0")
        if not np.isfinite(losses).all():
            _fail(f"pretrain {name}: a loss is not finite: {losses}")
        _check_moved(f"pretrain {name}", model, before, bn_frozen=False)

        _zero_counts(fused_mhsa, sinkhorn_pallas)
        vm = eval_metrics(eval_fn(model, val_images, val_labels, vidx))
        n_ce = 2 * len(vidx)  # 2 stage-2 blocks per validation forward
        counts[f"pretrain_val_ce_{name}"] = _expect_counts(f"pretrain {name} val CE", route, n_ce)
        _zero_counts(fused_mhsa, sinkhorn_pallas)
        fm = fs_eval(model.encoder, fs_ds, n_episodes=FS_EPISODES, images_dev=fs_images)
        n_fs = 2 * 2 * math.ceil(FS_EPISODES / 8)  # 2 blocks x 2 shots x episode batches
        counts[f"pretrain_fs_eval_{name}"] = _expect_counts(f"pretrain {name} fs_eval", route, n_fs)
        print(f"pretrain {name} validation: CE loss {vm['loss']:.4f} acc {vm['acc']:.4f} over "
              f"{len(val_ds)} images ({len(vidx)} forwards, the last one cycled and masked), "
              f"fs_eval {fm}; fused_mhsa launches {n_ce} + {n_fs}, all on the {route} route")
        if not (math.isfinite(vm["loss"]) and 0 <= vm["acc"] <= 1):
            _fail(f"pretrain {name}: validation CE malformed: {vm}")
        entry["pretrain_peak_gib"][name] = peak
        entry["pretrain_losses"][name] = losses.tolist()
        entry["pretrain_val"][name] = {**vm, **fm}
        if dtype == torch.float32:  # the teacher of phase 12
            save_variables(ckpt_dir, model.state_dict(),
                           {"model": "classifier", "n_classes": mini.n_classes,
                            "encoder": ENCODER})
        del model, state
        torch.cuda.empty_cache()

    # SAM (two passes a step) and EMA, fp32 as the configs run them
    model, state = make(torch.float32)
    before = _state_copy(model)
    _zero_counts(fused_mhsa, sinkhorn_pallas)
    t0 = time.perf_counter()
    sam = run(state, 3, 2, sam_rho=0.05)["loss"].cpu().numpy()
    sam_s = (time.perf_counter() - t0) / 3
    _check_moved("pretrain SAM", model, before, bn_frozen=False)
    model, state = make(torch.float32, ema=True)
    ema_before = {k: v.clone() for k, v in state.ema_params.items()}
    ema = run(state, 3, 2, ema_decay=0.9997)["loss"].cpu().numpy()
    moved = sum(not torch.equal(v, ema_before[k]) for k, v in state.ema_params.items())
    apart = sum(not torch.equal(v, p) for (k, v), p in
                zip(state.ema_params.items(), model.parameters()))
    counts["pretrain_train_sam_ema"] = _expect_counts("pretrain SAM and EMA training", "general", 0)
    print(f"pretrain fp32 SAM (rho 0.05): 3 steps, losses {sam.tolist()}, {sam_s:.3f} s a step "
          f"with warm-up; EMA 0.9997: losses {ema.tolist()}, {moved} of {len(ema_before)} "
          f"shadow tensors moved, {apart} apart from the parameters")
    if not (np.isfinite(sam).all() and np.isfinite(ema).all()) or moved < len(ema_before) // 2:
        _fail("pretrain SAM/EMA: a loss is not finite or the EMA shadow did not move")
    del model, state
    torch.cuda.empty_cache()

    # timings, in turns
    rate = {"float32": [], "bfloat16": []}
    states = {"float32": make(torch.float32)[1], "bfloat16": make(torch.bfloat16)[1]}
    for name in ("float32", "bfloat16", "bfloat16", "float32"):
        run(states[name], 1, 3)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(states[name], PRE_STEPS, 4)["loss"].cpu()
        rate[name].append(PRE_STEPS / (time.perf_counter() - t0))
    print(f"timing {tag}: pretrain steps/s ({bs} images a step, cropaug, {PRE_STEPS} steps a "
          f"run), fp32 (TF32 off): {rate['float32']}; bf16: {rate['bfloat16']}")
    if profile:
        _profile_to(os.path.join(profile, "profile_train_pretrain.txt"), card,
                    lambda: run(states["float32"], 1, 5)["loss"].cpu())
    entry["pretrain_steps_per_s"] = rate
    del states
    torch.cuda.empty_cache()
    return entry, counts


def _train_sun(dev, mini, images_dev, labels_dev, tag, profile, card, ckpt_dir):
    """Phase 12. Returns (training entry, launch counts)."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.checkpoint.io import load_variables
    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import models
    from fewshot_vit_tpu_torch.core.rng import torch_generator
    from fewshot_vit_tpu_torch.data.augment import make_dual_view_fn
    from fewshot_vit_tpu_torch.heads import token_label as _token_label  # noqa: F401
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.train.loop import make_sun_epoch
    from fewshot_vit_tpu_torch.train.runner import build_optimizer
    from fewshot_vit_tpu_torch.train.state import TrainState
    from fewshot_vit_tpu_torch.train.steps import sun_loss, sun_targets
    from fewshot_vit_tpu_torch.train.sun import assemble_teacher_variables

    bs = PRE_TRAIN["batch_size"]
    ck, _ = load_variables(ckpt_dir, map_location=dev)
    dual = make_dual_view_fn(mini.mean, mini.std, out_size=80)

    def token_label(dtype, fused=True, seed=0):
        m = models.make("token-label", encoder=ENCODER,
                        encoder_args={"drop_path_rate": 0.5, "use_pallas_attn": fused},
                        classifier_args={"n_classes": mini.n_classes}, dtype=dtype, device=dev,
                        seed=seed)
        return assemble_teacher_variables(m, ck)

    def make(dtype, teacher_dtype):
        student = token_label(dtype)
        teacher = token_label(teacher_dtype, seed=1).requires_grad_(False).eval()
        state = TrainState(student, build_optimizer(Config(PRE_TRAIN), student.parameters(), bs))
        state.optimizer.set_epoch(6)
        return student, teacher, state

    epoch_fn = make_sun_epoch(dual, mini.mean, mini.std, **SUN_KW)

    def run(state, teacher, steps, epoch):
        return epoch_fn(state, teacher, images_dev, labels_dev,
                        _steps_idx(len(mini), steps, epoch, dev), (0, epoch))

    counts, entry = {}, {"sun_peak_gib": {}, "sun_losses": {}}
    for teacher_dtype in (torch.float32, torch.bfloat16):
        name = f"teacher_{str(teacher_dtype).split('.')[1]}"
        route = "general" if teacher_dtype == torch.float32 else "tensor_core"
        student, teacher, state = make(torch.float32, teacher_dtype)
        before, t_before = _state_copy(student), _state_copy(teacher)
        _zero_counts(fused_mhsa, sinkhorn_pallas)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ms = run(state, teacher, SUN_STEPS, 1)
        m = {k: v.cpu().numpy() for k, v in ms.items()}
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts[f"sun_train_{name}"] = _expect_counts(f"SUN {name}", route, 2 * SUN_STEPS)
        print(f"SUN fp32 student, {name}: {SUN_STEPS} steps of {bs} images (dual view), losses "
              f"{m['loss'].tolist()} (cls {m['cls_loss'].tolist()}, token "
              f"{m['token_loss'].tolist()}), {wall:.2f} s with warm-up, peak memory "
              f"{peak:.2f} GiB; fused_mhsa launches {2 * SUN_STEPS} (2 a step, the teacher's "
              f"stage-2 blocks), all on the {route} route")
        if not all(np.isfinite(v).all() for v in m.values()):
            _fail(f"SUN {name}: a metric is not finite: {m}")
        _check_moved(f"SUN {name} student", student, before, bn_frozen=False)
        if any(not torch.equal(v, t_before[k]) for k, v in teacher.state_dict().items()):
            _fail(f"SUN {name}: the frozen teacher changed")
        entry["sun_peak_gib"][name] = peak
        entry["sun_losses"][name] = m["loss"].tolist()
        del student, teacher, state
        torch.cuda.empty_cache()

    # the kernel teacher against the plain-attention teacher on one step, fp32
    # (TF32 off): the same views, student weights and masks
    student = token_label(torch.float32)
    kernel_t = token_label(torch.float32, seed=1).requires_grad_(False)
    plain_t = token_label(torch.float32, fused=False, seed=1).requires_grad_(False)
    idx = _steps_idx(len(mini), 1, 7, dev)[0]
    xs, xw = dual(images_dev[idx], torch_generator(dev, 0, 7, 0, 7))
    labels = labels_dev[idx]
    _zero_counts(fused_mhsa, sinkhorn_pallas)
    soft_k = sun_targets(kernel_t, xw, soft_k=SUN_KW["soft_k"], bg_tokens=SUN_KW["bg_tokens"])
    _expect_counts("SUN kernel-teacher check", "general", 2)
    soft_p = sun_targets(plain_t, xw, soft_k=SUN_KW["soft_k"], bg_tokens=SUN_KW["bg_tokens"])
    _expect_counts("SUN plain-teacher check", "general", 2)
    differ = float((soft_k != soft_p).any(-1).float().mean())
    out = {}
    for which, soft in (("kernel", soft_k), ("plain", soft_p)):
        student.zero_grad(set_to_none=True)
        loss = sun_loss(student, xs, labels, soft, (0, 7, 0), SUN_KW["token_weight"])[0]
        loss.backward()
        out[which] = (loss.item(), {k: p.grad.clone() for k, p in student.named_parameters()})
    (loss_k, grads_k), (loss_p, grads_p) = out["kernel"], out["plain"]
    worst, worst_key = 0.0, None
    for k, g in grads_p.items():
        rel = ((grads_k[k] - g).abs().max() / g.abs().max()).item()
        if not rel <= worst:
            worst, worst_key = rel, k
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    print(f"SUN step fp32 (TF32 off), kernel teacher vs plain-attention teacher: soft labels "
          f"differ on {differ * 100:.4f}% of {soft_k.shape[0] * soft_k.shape[1]} tokens (limit "
          f"0.1%); loss {loss_k:.6f} vs {loss_p:.6f} (rel {rel_loss:.2e}, tol 1e-4); worst "
          f"gradient max|d|/max|g| {worst:.2e} at {worst_key} (tol 1e-3, {len(grads_p)} tensors)")
    if not (differ <= 1e-3 and rel_loss <= 1e-4 and worst <= 1e-3):
        _fail("SUN: the kernel teacher and the plain teacher disagree")
    entry["sun_kernel_vs_plain"] = {"soft_label_share_differing": differ,
                                    "loss_rel": rel_loss, "worst_grad_rel": worst}
    del student, kernel_t, plain_t, out, grads_k, grads_p
    torch.cuda.empty_cache()

    # timings, in turns: fp32 student and teacher, then bf16 student and teacher
    rate = {"float32": [], "bfloat16": []}
    runs = {"float32": make(torch.float32, torch.float32),
            "bfloat16": make(torch.bfloat16, torch.bfloat16)}
    for name in ("float32", "bfloat16", "bfloat16", "float32"):
        _, teacher, state = runs[name]
        run(state, teacher, 1, 3)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(state, teacher, SUN_STEPS, 4)["loss"].cpu()
        rate[name].append(SUN_STEPS / (time.perf_counter() - t0))
    print(f"timing {tag}: SUN steps/s ({bs} images a step, dual view, {SUN_STEPS} steps a run), "
          f"fp32 student and teacher (TF32 off): {rate['float32']}; bf16 student and teacher: "
          f"{rate['bfloat16']}")
    if profile:
        _, teacher, state = runs["float32"]
        _profile_to(os.path.join(profile, "profile_train_sun.txt"), card,
                    lambda: run(state, teacher, 1, 5)["loss"].cpu())
    entry["sun_steps_per_s"] = rate
    del runs
    torch.cuda.empty_cache()
    return entry, counts


_CLI_CHAIN_DATA = """
train_dataset: synthetic
train_dataset_args: {n_classes: 12, n_per_class: 30, image_size: 84}
fs_dataset: synthetic
fs_dataset_args: {n_classes: 10, n_per_class: 25, image_size: 80, seed: 3}
batch_size: 120
max_epoch: 2
image_size: 80
eval_fs_epoch: 1
eval_fs_episodes: 16
optimizer: adamw
optimizer_args: {lr: 5.e-4, weight_decay: 0.05, schedule: cosine, warmup_epochs: 1}
"""
_CLI_PRETRAIN = _CLI_CHAIN_DATA + """
val_dataset: synthetic
val_dataset_args: {n_classes: 12, n_per_class: 10, image_size: 80, seed: 1}
model: classifier
model_args: {encoder: visformer_micro_80,
             encoder_args: {drop_path_rate: 0.5, use_pallas_attn: true}}
augment: cropaug
"""
_CLI_SUN = _CLI_CHAIN_DATA + """
model: token-label
model_args: {encoder: visformer_micro_80,
             encoder_args: {drop_path_rate: 0.5, use_pallas_attn: true}}
teacher_dtype: bfloat16
load: %s
"""
_CLI_META = """
train_dataset: synthetic
train_dataset_args: {n_classes: 12, n_per_class: 30, image_size: 80}
val_dataset: synthetic
val_dataset_args: {n_classes: 10, n_per_class: 25, image_size: 80, seed: 3}
model: meta-baseline
model_args: {encoder: visformer_micro_80, encoder_args: {use_pallas_attn: true}}
load_encoder: %s
n_way: 5
n_shot: 1
n_query: 5
ep_per_batch: 4
train_batches: 3
max_epoch: 1
optimizer: sgd
optimizer_args: {lr: 1.e-3, weight_decay: 5.e-4, milestones: [1], gamma: 0.5}
val_episodes: 16
"""


def _cli(module, argv):
    """``module.main(argv)`` with its standard output captured and echoed;
    returns (main's result, the text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = module.main(argv)
    text = buf.getvalue()
    print(text, end="")
    return out, text


def _write_cfg(tmp, name, data):
    from fewshot_vit_tpu_torch.core.config import Config

    path = os.path.join(tmp, f"{name}.yaml")
    Config(data).dump_yaml(path)
    return path


def _mhsa_per_forward() -> int:
    """Fused-MHSA launches per encoder forward: one per stage-2 block (T =
    100); stage 3 (T = 25) stays on the einsum path."""
    from fewshot_vit_tpu_torch.models.visformer import _VARIANTS

    return _VARIANTS[ENCODER]["depth"][1]


def _close_chain(tmp, tag, dev):
    """Phase 13's end: both eval CLIs score the chain's checkpoints."""
    import torch

    from fewshot_vit_tpu_torch.eval import run as eval_run
    from fewshot_vit_tpu_torch.eval import run_emd
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas

    fs = {"n_classes": 10, "n_per_class": 25, "image_size": 80, "seed": 3}
    enc = {"encoder": ENCODER, "encoder_args": {"use_pallas_attn": True}}
    run_cfg = _write_cfg(tmp, "eval_chain", {
        "dataset": "synthetic", "dataset_args": fs, "encoder": ENCODER, "model_args": enc,
        "load": os.path.join(tmp, "meta_tune", "max-va")})
    emd_cfg = _write_cfg(tmp, "eval_emd_chain", {
        "val_dataset": "synthetic", "val_dataset_args": fs, "deepemd": "grid",
        "solver": "sinkhorn_pallas", "model_args": enc,
        "load_encoder": os.path.join(tmp, "sun", "max-va")})
    n_batches = math.ceil(CHAIN_EVAL_EPISODES / CLI_EP_PER_BATCH)
    out = {}
    for label, module, argv, n_sk in (
            ("eval.run load: meta_tune/max-va", eval_run, ["--config", run_cfg], 0),
            ("eval.run_emd load_encoder: sun/max-va", run_emd,
             ["--config", emd_cfg, "--ep-per-batch", str(CLI_EP_PER_BATCH)], n_batches)):
        _zero_counts(fused_mhsa, sinkhorn_pallas)
        t0 = time.perf_counter()
        accs, text = _cli(module, argv + ["--episodes", str(CHAIN_EVAL_EPISODES), "--bf16",
                                          "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if "WARNING" in text:
            _fail(f"CLI chain {label}: scored random weights")
        if accs.shape != (CHAIN_EVAL_EPISODES,) or not ((accs >= 0) & (accs <= 1)).all():
            _fail(f"CLI chain {label}: episode accuracies malformed: shape {accs.shape}")
        out[label] = _expect_counts(f"CLI chain {label}", "tensor_core",
                                    _mhsa_per_forward() * n_batches, n_sk)
        print(f"CLI chain {tag} {label}: {CHAIN_EVAL_EPISODES} episodes bf16 in {wall:.1f} s, "
              f"launches {out[label]}")
    return out


def _run_cli_chain(tag, dev):
    """Phase 13: ``train.pretrain`` -> ``train.sun`` (``load:`` its max-va) ->
    ``train.meta_tune`` (``load_encoder:`` SUN's max-va), through
    ``parse_args`` + ``main`` on the card in a temporary --save-root; then
    both eval CLIs score the result. Returns the eval CLIs' launch counts."""
    import tempfile

    import torch

    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.train import meta_tune, pretrain, sun
    from fewshot_vit_tpu_torch.train.runner import parse_args

    with tempfile.TemporaryDirectory() as tmp:
        prev = None
        for name, module, text in (("pretrain", pretrain, _CLI_PRETRAIN), ("sun", sun, _CLI_SUN),
                                   ("meta_tune", meta_tune, _CLI_META)):
            cfg = os.path.join(tmp, f"{name}.yaml")
            with open(cfg, "w") as f:
                f.write(text % prev if prev else text)
            _zero_counts(fused_mhsa, sinkhorn_pallas)
            t0 = time.perf_counter()
            state = module.main(*parse_args(f"chip_smoke {name}",
                                            ["--config", cfg, "--save-root", tmp, "--name", name]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run_dir = os.path.join(tmp, name)
            with open(os.path.join(run_dir, "log.txt")) as f:
                last = [ln for ln in f.read().splitlines() if ln.startswith("epoch ")][-1]
            print(f"CLI chain {tag} {name}: {state.step} steps in {wall:.1f} s; "
                  f"{last}; fused_mhsa launches {dict(fused_mhsa.route_launches)}")
            prev = os.path.join(run_dir, "max-va")
            if not os.path.isfile(os.path.join(prev, "arrays.pt")):
                _fail(f"CLI chain {name}: no max-va checkpoint in {sorted(os.listdir(run_dir))}")
            if not fused_mhsa.launches:
                _fail(f"CLI chain {name}: its run launched no fused_mhsa kernel")
            if name == "sun" and not fused_mhsa.route_launches["tensor_core"]:
                _fail("CLI chain sun: the bf16 teacher never took the tensor-core route")
            if "WARNING" in open(os.path.join(run_dir, "log.txt")).read():
                _fail(f"CLI chain {name}: started from random weights")
        return _close_chain(tmp, tag, dev)


def _eval_from_pth(dev, tmp, tag):
    """Phases 14 and 15. Returns (entry, launch counts per path, the .pth)."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import datasets, models
    from fewshot_vit_tpu_torch.core.rng import DEFAULT_SEED
    from fewshot_vit_tpu_torch.data.staging import upload_images
    from fewshot_vit_tpu_torch.eval import run as eval_run
    from fewshot_vit_tpu_torch.eval.episodic import evaluate
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.models.fold import fold_encoder_in_head

    # a seeded head with non-trivial BN statistics and temperature, so a
    # load that dropped any of them would show, written as the reference does
    src = models.make("meta-baseline", encoder=ENCODER, encoder_args={"use_pallas_attn": True},
                      device=dev, seed=1)
    gen = torch.Generator(device=dev).manual_seed(11)
    with torch.no_grad():
        for name, buf in src.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=gen)
        src.temp.fill_(12.5)
    sd = {k: v.detach().cpu() for k, v in src.state_dict().items()}
    del src
    tracked = {k[: -len("running_mean")] + "num_batches_tracked": torch.tensor(300)
               for k in sd if k.endswith("running_mean")}
    pth = os.path.join(tmp, "max-va.pth")
    torch.save({"model": "meta-baseline", "model_args": {"encoder": ENCODER},
                "model_sd": {**sd, **tracked}}, pth)
    sund_pth = os.path.join(tmp, "max_acc.pth")
    torch.save({"params": {"module." + k: v for k, v in sd.items()}}, sund_pth)
    data = {"n_classes": 20, "n_per_class": 600, "image_size": 80, "seed": 0}
    cfg = {"dataset": "synthetic", "dataset_args": data, "encoder": ENCODER,
           "model_args": {"encoder_args": {"use_pallas_attn": True}}, "load": pth}
    cfg_sund = dict(cfg, load=sund_pth)
    for label, c, dtype in (("model_sd + num_batches_tracked", cfg, torch.bfloat16),
                            ("SUN-D params + module.", cfg_sund, torch.float32)):
        got = eval_run.load_model_for_eval(Config(c), dtype, dev).state_dict()
        if sorted(got) != sorted(sd) or not all(torch.equal(got[k].cpu(), v)
                                                for k, v in sd.items()):
            _fail(f"the state dict loaded from the {label} .pth differs from the source")
    print(f"eval CLI: both .pth layouts ({len(sd)} tensors, {len(tracked)} num_batches_tracked "
          f"buffers dropped) load into the source state dict, tensor for tensor")

    ds = datasets.make("synthetic", **data)
    images_dev = upload_images(ds.images, dev)
    path = _write_cfg(tmp, "eval_pth", cfg)
    n_batches = math.ceil(CLI_EPISODES / CLI_EP_PER_BATCH)
    counts, entry = {}, {}

    # phase 14: --fold-bn --bf16, 2000 episodes, against in-process evaluate
    _zero_counts(fused_mhsa, sinkhorn_pallas)
    t0 = time.perf_counter()
    accs, text = _cli(eval_run, ["--config", path, "--episodes", str(CLI_EPISODES), "--fold-bn",
                                 "--bf16", "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per = _mhsa_per_forward()
    counts["eval_cli_pth_bf16"] = _expect_counts("eval CLI from .pth, bf16", "tensor_core",
                                                 per * n_batches)
    head = fold_encoder_in_head(eval_run.load_model_for_eval(Config(cfg), torch.bfloat16, dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m, h, want = evaluate(head, ds, n_episodes=CLI_EPISODES, ep_per_batch=CLI_EP_PER_BATCH,
                          seed=DEFAULT_SEED, images_dev=images_dev, device=dev)
    eps = CLI_EPISODES / (time.perf_counter() - t0)
    line = f"test epoch 1: acc={m * 100:.2f} +- {h * 100:.2f} (%)"
    print(f"eval CLI {tag} load: .pth, --fold-bn --bf16, {CLI_EPISODES} episodes: wall "
          f"{wall:.2f} s (dataset, model, load, fold, upload, eval); in-process evaluate of the "
          f"same head and episodes: {eps:.1f} episodes/s, '{line}'; launches "
          f"{counts['eval_cli_pth_bf16']}")
    if line not in text or not np.array_equal(accs, want):
        _fail("the eval CLI from .pth and in-process evaluate disagree")
    entry.update({"cli_pth_bf16_wall_s": wall, "evaluate_epb8_bf16_episodes_per_s": eps,
                  "cli_pth_bf16_acc": m})

    path32 = _write_cfg(tmp, "eval_sund_pth", cfg_sund)
    n32 = math.ceil(CLI_FP32_EPISODES / CLI_EP_PER_BATCH)
    _zero_counts(fused_mhsa, sinkhorn_pallas)
    t0 = time.perf_counter()
    _cli(eval_run, ["--config", path32, "--episodes", str(CLI_FP32_EPISODES), "--fold-bn",
                    "--device", str(dev)])
    torch.cuda.synchronize()
    counts["eval_cli_sund_pth_fp32"] = _expect_counts("eval CLI from the SUN-D .pth, fp32",
                                                      "general", per * n32)
    print(f"eval CLI {tag} load: SUN-D .pth, --fold-bn fp32 (TF32 off), {CLI_FP32_EPISODES} "
          f"episodes: wall {time.perf_counter() - t0:.2f} s; launches "
          f"{counts['eval_cli_sund_pth_fp32']}")

    # phase 15: --sauc, on synthetic-local: an untrained encoder ranks its
    # queries far from perfectly there, so per-episode AUCs spread and the
    # kernel path against the plain path is a real comparison (on the easy
    # synthetic split both saturate at 1)
    del head, images_dev
    cfg = dict(cfg, dataset="synthetic-local")
    ds = datasets.make("synthetic-local", **data)
    images_dev = upload_images(ds.images, dev)
    path = _write_cfg(tmp, "eval_sauc", cfg)
    _zero_counts(fused_mhsa, sinkhorn_pallas)
    t0 = time.perf_counter()
    aucs, text = _cli(eval_run, ["--config", path, "--sauc", "--episodes", str(CLI_EPISODES),
                                 "--fold-bn", "--bf16", "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["sauc_bf16"] = _expect_counts("--sauc bf16", "tensor_core", per * n_batches)
    if aucs.shape != (CLI_EPISODES,) or not ((aucs >= 0) & (aucs <= 1)).all():
        _fail(f"--sauc: per-episode AUCs malformed: shape {aucs.shape}")
    head = fold_encoder_in_head(eval_run.load_model_for_eval(Config(cfg), torch.bfloat16, dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, want = eval_run.sauc_eval(head, ds, CLI_EPISODES, 1, images_dev=images_dev, device=dev)
    sauc_eps = CLI_EPISODES / (time.perf_counter() - t0)
    if not np.array_equal(aucs, want):
        _fail("--sauc: the CLI and in-process sauc_eval disagree")
    cfg_plain = dict(cfg, model_args={"encoder_args": {"use_pallas_attn": False}})
    a = {}
    for which, c in (("kernel", cfg), ("plain", cfg_plain)):
        hd = fold_encoder_in_head(eval_run.load_model_for_eval(Config(c), torch.float32, dev))
        a[which] = eval_run.sauc_eval(hd, ds, CLI_EPISODES, 1, images_dev=images_dev,
                                      device=dev)[2]
        del hd
    mean_d = float(np.abs(a["kernel"] - a["plain"]).mean())
    print(f"--sauc {tag}: {CLI_EPISODES} 2-way episodes bf16 on synthetic-local: wall "
          f"{wall:.2f} s, in-process {sauc_eps:.1f} episodes/s, mean AUC {aucs.mean():.4f} "
          f"(per-episode std {aucs.std():.4f}), equal to the CLI's; launches "
          f"{counts['sauc_bf16']}; fp32 (TF32 off) kernel path vs plain path: mean|dAUC|="
          f"{mean_d:.2e} (limit 0.005), mean AUC {a['kernel'].mean():.4f} vs "
          f"{a['plain'].mean():.4f}")
    if not mean_d <= 0.005:
        _fail("--sauc: the fp32 kernel path and the plain path disagree")
    entry.update({"sauc_bf16_wall_s": wall, "sauc_bf16_episodes_per_s": sauc_eps,
                  "sauc_fp32_kernel_vs_plain_mean_abs_d": mean_d})
    del head, images_dev
    torch.cuda.empty_cache()
    return entry, counts, pth


def _loaders(dev, tmp, pth, tag):
    """Phase 16. Returns (entry, launch counts per path)."""
    import importlib.util
    import pickle
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import datasets
    from fewshot_vit_tpu_torch.core.rng import DEFAULT_SEED
    from fewshot_vit_tpu_torch.data.staging import upload_images
    from fewshot_vit_tpu_torch.data.transforms import CIFAR_MEAN, CIFAR_STD
    from fewshot_vit_tpu_torch.eval import run as eval_run
    from fewshot_vit_tpu_torch.eval.episodic import evaluate
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.models.fold import fold_encoder_in_head

    has_pil = importlib.util.find_spec("PIL") is not None
    if has_pil:
        print("PIL on this machine: yes")
    else:
        print("PIL on this machine: NO. The PIL loaders (cifar-fs, image-folder, fc100, cub) "
              "and resize_crop are left to the CPU tests; the tiered split runs at 80x80 with "
              "protocol raw")
    splits = {}  # name -> (loader arguments, what is on disk)
    size = 84 if has_pil else 80
    root = os.path.join(tmp, "tiered")
    os.makedirs(root)
    src = datasets.make("synthetic", image_size=size, **TIERED_TEST)
    np.savez(os.path.join(root, "test_images.npz"), images=src.images[..., ::-1])  # stored BGR
    with open(os.path.join(root, "test_labels.pkl"), "wb") as f:
        pickle.dump({"labels": src.labels.tolist()}, f)
    protocol = "resize_crop" if has_pil else "raw"
    splits["tiered-imagenet"] = (
        {"root_path": root, "split": "test", "image_size": 80, "protocol": protocol},
        f"{len(src.images)} images at {size}x{size} ({src.images.nbytes / 2 ** 20:.0f} MiB "
        f"uint8), {protocol}")
    if not has_pil:
        want_raw = src.images
    del src
    if has_pil:
        from PIL import Image

        cifar = datasets.make("synthetic", **CIFAR_TEST)
        root = os.path.join(tmp, "cifar")

        def write(i):
            d = os.path.join(root, "meta-test", f"class{cifar.labels[i]:02d}")
            Image.fromarray(cifar.images[i]).save(os.path.join(d, f"{i:05d}.png"))

        for c in range(CIFAR_TEST["n_classes"]):
            os.makedirs(os.path.join(root, "meta-test", f"class{c:02d}"))
        with ThreadPoolExecutor(max_workers=8) as pool:
            list(pool.map(write, range(len(cifar.images))))
        splits["cifar-fs"] = ({"root_path": root, "split": "test", "image_size": 80},
                              f"{len(cifar.images)} PNGs at 32x32, resize")
        del cifar

    entry, counts = {"pil": has_pil}, {}
    n_batches = math.ceil(LOADER_EPISODES / CLI_EP_PER_BATCH)
    made = {}  # the split the eval CLI loads, kept: each split is read once

    def make_once(name, **kw):
        t0 = time.perf_counter()
        made[name] = datasets.__class__.make(datasets, name, **kw)
        made[name + "_s"] = time.perf_counter() - t0
        return made[name]

    for name, (args, desc) in splits.items():
        cfg = {"dataset": name, "dataset_args": args, "encoder": ENCODER,
               "model_args": {"encoder_args": {"use_pallas_attn": True}}, "load": pth}
        path = _write_cfg(tmp, f"eval_{name}", cfg)
        _zero_counts(fused_mhsa, sinkhorn_pallas)
        t0 = time.perf_counter()
        datasets.make = make_once
        try:
            accs, _ = _cli(eval_run, ["--config", path, "--episodes", str(LOADER_EPISODES),
                                      "--fold-bn", "--bf16", "--device", str(dev)])
        finally:
            del datasets.make
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ds, load_s = made.pop(name), made.pop(name + "_s")
        n_cls = TIERED_TEST["n_classes"] if name == "tiered-imagenet" else CIFAR_TEST["n_classes"]
        if ds.images.shape[1:] != (80, 80, 3) or ds.n_classes != n_cls:
            _fail(f"{name}: loaded {ds.images.shape}, {ds.n_classes} classes")
        if name == "cifar-fs" and not (np.array_equal(ds.mean, CIFAR_MEAN)
                                       and np.array_equal(ds.std, CIFAR_STD)):
            _fail("cifar-fs: not the CIFAR normalization stats")
        if name == "tiered-imagenet" and not has_pil and not np.array_equal(ds.images, want_raw):
            _fail("tiered-imagenet raw: the BGR -> RGB flip did not restore the images")
        counts[f"eval_cli_{name}"] = _expect_counts(f"eval CLI on {name}", "tensor_core",
                                                    _mhsa_per_forward() * n_batches)
        if accs.shape != (LOADER_EPISODES,) or not ((accs >= 0) & (accs <= 1)).all():
            _fail(f"eval CLI on {name}: episode accuracies malformed")
        head = fold_encoder_in_head(eval_run.load_model_for_eval(Config(cfg), torch.bfloat16,
                                                                 dev))
        images_dev = upload_images(ds.images, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, want = evaluate(head, ds, n_episodes=LOADER_EPISODES,
                              ep_per_batch=CLI_EP_PER_BATCH, seed=DEFAULT_SEED,
                              images_dev=images_dev, device=dev)
        eps = LOADER_EPISODES / (time.perf_counter() - t0)
        if not np.array_equal(accs, want):
            _fail(f"eval CLI on {name} and in-process evaluate disagree")
        print(f"loader {tag} {name} ({desc}, to 80x80): load {load_s:.2f} s; eval CLI "
              f"{LOADER_EPISODES} episodes --fold-bn --bf16: wall {wall:.2f} s (the load "
              f"included); in-process "
              f"evaluate of the same episodes {eps:.1f} episodes/s; launches "
              f"{counts[f'eval_cli_{name}']}")
        entry[name] = {"load_s": load_s, "cli_wall_s": wall, "episodes_per_s": eps}
        del ds, head, images_dev
    return entry, counts


def _zoo_pretrain(dev, mini, images_dev, labels_dev, tag, profile, card, tmp):
    """Phase 17. Returns (training entry, launch counts, checkpoint per family)."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.checkpoint.io import save_variables
    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import models
    from fewshot_vit_tpu_torch.data.augment import make_cropaug_fn
    from fewshot_vit_tpu_torch.heads import classifier as _classifier  # noqa: F401
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.train.loop import make_pretrain_epoch
    from fewshot_vit_tpu_torch.train.runner import build_optimizer
    from fewshot_vit_tpu_torch.train.state import TrainState

    bs = PRE_TRAIN["batch_size"]
    fn = make_pretrain_epoch(make_cropaug_fn(mini.mean, mini.std, out_size=80), mini.mean,
                             mini.std)

    def make(name, args, dtype):
        model = models.make("classifier", encoder=name, encoder_args=dict(args),
                            classifier_args={"n_classes": mini.n_classes}, dtype=dtype,
                            device=dev, seed=0)
        state = TrainState(model, build_optimizer(Config(PRE_TRAIN), model.parameters(), bs))
        state.optimizer.set_epoch(6)  # past the warmup
        return model, state

    def run(state, steps, epoch):
        return fn(state, images_dev, labels_dev, _steps_idx(len(mini), steps, epoch, dev),
                  (0, epoch))["loss"].cpu().numpy()

    entry, counts, ckpts = {}, {}, {}
    for name, args, config in ZOO_PRETRAIN:
        e = entry[name] = {"config": f"configs/{config}", "steps_per_s": {}, "peak_gib": {},
                           "losses": {}}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            model, state = make(name, args, dtype)
            before = _state_copy(model)
            n_bn = sum(_is_bn_stat(k) for k in before)
            _zero_counts(fused_mhsa, sinkhorn_pallas)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            losses = run(state, ZOO_PRE_STEPS, 1)
            warm = time.perf_counter() - t0
            if not np.isfinite(losses).all():
                _fail(f"zoo pretrain {name} {dn}: a loss is not finite: {losses}")
            _check_moved(f"zoo pretrain {name} {dn}", model, before, bn_frozen=False,
                         static=ZOO_STATIC.get(name, ()))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(state, ZOO_PRE_STEPS, 2)
            rate = ZOO_PRE_STEPS / (time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            counts[f"zoo_pretrain_{name}_{dn}"] = _expect_counts(
                f"zoo pretrain {name} {dn}", "general", 0)
            print(f"zoo pretrain {tag} {name} {dn} (configs/{config}: {bs} images a step, "
                  f"cropaug, encoder_args {args}): losses {losses.tolist()} ({warm:.2f} s with "
                  f"warm-up), then {rate:.3f} steps/s over {ZOO_PRE_STEPS} steps, peak memory "
                  f"{peak:.2f} GiB; every parameter and {n_bn} BN statistics moved; kernel "
                  f"launches 0")
            e["steps_per_s"][dn], e["peak_gib"][dn], e["losses"][dn] = rate, peak, losses.tolist()
            if dtype == torch.float32:  # phase 18's weights
                ckpts[name] = os.path.join(tmp, f"zoo_{name}")
                save_variables(ckpts[name], model.state_dict(),
                               {"model": "classifier", "n_classes": mini.n_classes,
                                "encoder": name})
            del model, state
            torch.cuda.empty_cache()
    slowest = min(entry, key=lambda n: entry[n]["steps_per_s"]["float32"])
    if profile:
        _, state = make(slowest, dict(ZOO_PRETRAIN[[z[0] for z in ZOO_PRETRAIN].index(slowest)][1]),
                        torch.float32)
        run(state, 1, 3)
        _profile_to(os.path.join(profile, "profile_train_zoo_pretrain.txt"), card,
                    lambda: run(state, 1, 4))
        del state
        torch.cuda.empty_cache()
    return {"zoo_pretrain": entry, "zoo_pretrain_slowest": slowest}, counts, ckpts


def _zoo_eval(dev, ds, images_dev, ckpts, tag, tmp):
    """Phase 18. Returns (entry, launch counts per path)."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.rng import DEFAULT_SEED
    from fewshot_vit_tpu_torch.eval import run as eval_run
    from fewshot_vit_tpu_torch.eval.episodic import evaluate
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas

    data = {"n_classes": 20, "n_per_class": 600, "image_size": 80, "seed": 0}
    entry, counts = {}, {}
    for name, args, _ in ZOO_PRETRAIN:
        cfg = {"dataset": "synthetic", "dataset_args": data, "encoder": name,
               "model_args": {"encoder_args": args}, "load_encoder": ckpts[name]}
        path = _write_cfg(tmp, f"zoo_eval_{name}", cfg)
        _zero_counts(fused_mhsa, sinkhorn_pallas)
        t0 = time.perf_counter()
        accs, text = _cli(eval_run, ["--config", path, "--episodes", str(ZOO_EVAL_EPISODES),
                                     "--bf16", "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[f"zoo_eval_cli_{name}"] = _expect_counts(f"zoo eval CLI {name}", "general", 0)
        if "WARNING" in text or accs.shape != (ZOO_EVAL_EPISODES,):
            _fail(f"zoo eval CLI {name}: random weights or malformed accuracies")
        head = eval_run.load_model_for_eval(Config(cfg), torch.bfloat16, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, _, want = evaluate(head, ds, n_episodes=ZOO_EVAL_EPISODES,
                              ep_per_batch=CLI_EP_PER_BATCH, seed=DEFAULT_SEED,
                              images_dev=images_dev, device=dev)
        eps = ZOO_EVAL_EPISODES / (time.perf_counter() - t0)
        if not np.array_equal(accs, want):
            _fail(f"zoo eval CLI {name} and in-process evaluate disagree")
        print(f"zoo eval CLI {tag} {name}, load_encoder: its phase-17 checkpoint, "
              f"{ZOO_EVAL_EPISODES} episodes bf16: wall {wall:.2f} s, acc {m:.4f}; in-process "
              f"evaluate of the same head and episodes {eps:.1f} episodes/s, accuracies equal; "
              f"kernel launches 0")
        entry[name] = {"cli_wall_s": wall, "episodes_per_s": eps, "acc": m}
        del head
        if name != "levit_micro_80":
            continue
        accs = {}
        for fold in (True, False):
            _zero_counts(fused_mhsa, sinkhorn_pallas)
            accs[fold], _ = _cli(eval_run, ["--config", path, "--episodes",
                                            str(ZOO_EVAL_EPISODES), "--device", str(dev)]
                                 + (["--fold-bn"] if fold else []))
            counts[f"zoo_eval_cli_{name}_fp32_{'fold' if fold else 'unfolded'}"] = \
                _expect_counts(f"zoo eval CLI {name} fp32", "general", 0)
        differ = float((accs[True] != accs[False]).mean())
        mean_d = float(np.abs(accs[True] - accs[False]).mean())
        print(f"zoo eval CLI {name} fp32 (TF32 off), --fold-bn vs unfolded, the same "
              f"{ZOO_EVAL_EPISODES} episodes: episodes differing={differ:.4f}, "
              f"mean|dacc|={mean_d:.5f} (limits 0.01, 0.005)")
        if differ > 0.01 or mean_d > 0.005:
            _fail("LeViT --fold-bn and unfolded disagree")
        entry[name].update({"fold_vs_unfolded_fp32_differing": differ,
                            "fold_vs_unfolded_fp32_mean_abs_d": mean_d})
    torch.cuda.empty_cache()
    return entry, counts


def _reference_sd(module):
    """A module's state dict on the CPU as the reference saves it: plus each
    BN's ``num_batches_tracked`` and the static index and mask buffers."""
    import torch

    from fewshot_vit_tpu_torch.checkpoint.reference import _BUFFERS

    sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    out = dict(sd)
    for k in sd:
        if k.endswith("running_var"):
            out[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(300)
    for name, buf in module.named_buffers():
        if name.endswith(_BUFFERS) and name not in out and buf is not None:
            out[name] = buf.detach().cpu()
    return sd, out


def _zoo_meta_tune(dev, ds, images_dev, tag, tmp):
    """Phase 19. Returns (training entry, launch counts)."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.core import rng as rng_mod
    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import models
    from fewshot_vit_tpu_torch.data.sampler import EpisodeSampler
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.train.loop import make_meta_tune_epoch
    from fewshot_vit_tpu_torch.train.runner import build_optimizer, load_encoder_from_checkpoint
    from fewshot_vit_tpu_torch.train.state import TrainState

    c = ZOO_META
    way, shot, query, epb = c["way"], c["shot"], c["query"], c["ep_per_batch"]
    # a seeded ResNet-18 with non-trivial BN statistics, written as the
    # reference's classifier pretraining writes it
    src = models.make("resnet18", device=dev, seed=3)
    gen = torch.Generator(device=dev).manual_seed(12)
    with torch.no_grad():
        for name, buf in src.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=gen)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=gen)
    sd, file_sd = _reference_sd(src)
    del src
    pth = os.path.join(tmp, "resnet18_im800.pth")
    torch.save({"model": "classifier", "model_args": {"encoder": "resnet18"},
                "model_sd": {**{f"encoder.{k}": v for k, v in file_sd.items()},
                             "classifier.linear.weight": torch.zeros(800, 512),
                             "classifier.linear.bias": torch.zeros(800)}}, pth)
    head = models.make("meta-baseline", encoder="resnet18", device=dev, seed=0)
    load_encoder_from_checkpoint(pth, head.encoder, "resnet18")
    got = head.encoder.state_dict()
    if sorted(got) != sorted(sd) or not all(torch.equal(got[k].cpu(), v) for k, v in sd.items()):
        _fail("resnet18: the encoder loaded from the reference .pth differs from the source")
    state = TrainState(head, build_optimizer(Config(c), head.parameters()))
    state.optimizer.set_epoch(0)
    sampler = EpisodeSampler(ds.labels, ZOO_META_STEPS, way, shot + query, epb)
    idx = np.stack(list(sampler.epoch(rng_mod.np_rng(0, 1)))).astype(np.int64)
    fn = make_meta_tune_epoch(way, shot, query, epb, freeze_bn=True, mean=ds.mean, std=ds.std)
    before = _state_copy(head)
    _zero_counts(fused_mhsa, sinkhorn_pallas)
    t0 = time.perf_counter()
    losses = fn(state, images_dev, torch.from_numpy(idx).to(dev), (0, 1))["loss"].cpu().numpy()
    wall = time.perf_counter() - t0
    counts = {"zoo_meta_tune_resnet18": _expect_counts("resnet18 meta-tune", "general", 0)}
    if not np.isfinite(losses).all():
        _fail(f"resnet18 meta-tune: a loss is not finite: {losses}")
    _check_moved("resnet18 meta-tune, freeze_bn", head, before, bn_frozen=True)
    print(f"zoo meta-tune {tag} resnet18 (configs/meta_tune_im800_resnet18.yaml's geometry): "
          f"load_encoder: a reference .pth ({len(file_sd)} tensors with "
          f"{len(file_sd) - len(sd)} num_batches_tracked, and a classifier) loaded tensor for "
          f"tensor; freeze_bn, {way}-way {shot}-shot {query}-query, {epb} episodes a step, "
          f"SGD 1e-3: {ZOO_META_STEPS} steps, losses {losses.tolist()}, {wall:.2f} s with "
          f"warm-up; every BN statistic bit-identical, every parameter moved; kernel launches 0")
    del head, state
    torch.cuda.empty_cache()
    return {"zoo_meta_tune_resnet18": {"losses": losses.tolist(), "wall_s": wall}}, counts


def _zoo_forward(dev, tag, tmp):
    """Phase 20. Returns (entry, launch counts per path)."""
    import torch

    from fewshot_vit_tpu_torch.core.registry import models
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.train.runner import load_encoder_from_checkpoint

    gen = torch.Generator(device=dev).manual_seed(21)
    entry, counts = {}, {}
    for name, (size, dense_shape, width) in ZOO_SHAPES.items():
        x = torch.randn(ZOO_BATCH, size, size, 3, generator=gen, device=dev)
        e = entry[name] = {}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            enc = models.make(name, dtype=dtype, device=dev, seed=0)
            _zero_counts(fused_mhsa, sinkhorn_pallas)
            with torch.inference_mode():
                dense, pooled = enc(x)
                if dtype == torch.float32:
                    e["fp32_ms"] = _time_ms(lambda: enc(x), reps=2, warm=1)
            counts[f"zoo_forward_{name}_{dn}"] = _expect_counts(f"zoo forward {name}", "general",
                                                                0)
            if (tuple(dense.shape) != (ZOO_BATCH, *dense_shape)
                    or tuple(pooled.shape) != (ZOO_BATCH, width)):
                _fail(f"zoo forward {name} {dn}: shapes {tuple(dense.shape)} "
                      f"{tuple(pooled.shape)}, the JAX package's {dense_shape} {width}")
            if not (torch.isfinite(dense).all() and torch.isfinite(pooled).all()):
                _fail(f"zoo forward {name} {dn}: an output is not finite")
            del enc, dense, pooled
        print(f"zoo forward {tag} {name}: {ZOO_BATCH} images at {size}x{size}, fp32 and bf16 "
              f"finite, dense {dense_shape}, pooled {width} as the JAX package's; fp32 "
              f"{e['fp32_ms']:.2f} ms a batch; kernel launches 0")
        del x
        torch.cuda.empty_cache()
    for name in ZOO_PTH:
        src = models.make(name, device=dev, seed=1)
        sd, file_sd = _reference_sd(src)
        del src
        path = os.path.join(tmp, f"zoo_{name}.pth")
        torch.save({"model": "classifier",
                    "model_sd": {f"encoder.{k}": v for k, v in file_sd.items()}}, path)
        enc = load_encoder_from_checkpoint(path, models.make(name, device=dev, seed=2), name)
        got = enc.state_dict()
        if sorted(got) != sorted(sd) or not all(torch.equal(got[k].cpu(), v)
                                                for k, v in sd.items()):
            _fail(f"zoo .pth {name}: the loaded state dict differs from the source")
        print(f"zoo .pth {name}: {len(file_sd)} tensors with {len(file_sd) - len(sd)} reference "
              f"buffers loaded through its key rule, tensor for tensor")
        del enc
        os.remove(path)
    torch.cuda.empty_cache()
    return entry, counts


def _exact_emd(dev, ds, images_dev, tag, tmp):
    """Phase 21: ``solver: exact``. The run_emd CLI from a checkpoint this
    phase writes, then the same episodes with sinkhorn_pallas in process;
    exact against Sinkhorn flows on the batch's problems; the kernel
    attention path against plain attention under exact; one meta_tune_emd
    step with exact. Returns (entry, launch counts per path)."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.checkpoint.io import save_variables
    from fewshot_vit_tpu_torch.core import rng as rng_mod
    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import models
    from fewshot_vit_tpu_torch.data.sampler import EpisodeSampler
    from fewshot_vit_tpu_torch.eval import run_emd
    from fewshot_vit_tpu_torch.eval.emd_eval import evaluate_emd, sample_emd_episode_indices
    from fewshot_vit_tpu_torch.heads import deepemd
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.train import meta_tune_emd as tt
    from fewshot_vit_tpu_torch.train.state import TrainState

    def head_for(dtype, solver, fused=True, seed=2):
        return models.make("deepemd", encoder=ENCODER, encoder_args={"use_pallas_attn": fused},
                           solver=solver, dtype=dtype, device=dev, seed=seed)

    ckpt = os.path.join(tmp, "sund_exact")
    save_variables(ckpt, head_for(torch.float32, "exact").state_dict(),
                   {"model": "deepemd", "encoder": ENCODER})
    data = {"n_classes": 20, "n_per_class": 600, "image_size": 80, "seed": 0}
    cfg = _write_cfg(tmp, "run_emd_exact", {
        "val_dataset": "synthetic", "val_dataset_args": data, "deepemd": "grid",
        "patch_list": [2, 3], "patch_ratio": 2.0, "temperature": 12.5, "solver": "exact",
        "model_args": {"encoder": ENCODER, "encoder_args": {"use_pallas_attn": True}},
        "load": ckpt})
    n_batches = math.ceil(EXACT_EPISODES / CLI_EP_PER_BATCH)
    eval_wall = []
    orig_eval = run_emd.evaluate_emd

    def timed_eval(*a, **k):
        t = time.perf_counter()
        out = orig_eval(*a, **k)
        torch.cuda.synchronize()
        eval_wall.append(time.perf_counter() - t)
        return out

    run_emd.evaluate_emd = timed_eval
    host0 = deepemd.exact_flows.host_seconds
    _zero_counts(fused_mhsa, sinkhorn_pallas)
    t0 = time.perf_counter()
    try:
        accs_x, text = _cli(run_emd, ["--config", cfg, "--episodes", str(EXACT_EPISODES),
                                      "--ep-per-batch", str(CLI_EP_PER_BATCH), "--bf16",
                                      "--device", str(dev)])
    finally:
        run_emd.evaluate_emd = orig_eval
    cli_wall = time.perf_counter() - t0
    host_s = deepemd.exact_flows.host_seconds - host0
    counts = {"run_emd_cli_exact": _expect_counts("run_emd CLI solver exact", "tensor_core",
                                                  _mhsa_per_forward() * n_batches, 0)}
    if (run_emd.EXACT_ON_CARD in text) != (dev.type == "cuda") or "weights are random" in text:
        _fail("run_emd CLI solver exact: the host-solver warning is missing on the card (or "
              "printed off it), or the weights are random")
    if accs_x.shape != (EXACT_EPISODES,) or not ((accs_x >= 0) & (accs_x <= 1)).all():
        _fail(f"run_emd CLI solver exact: episode accuracies malformed: shape {accs_x.shape}")

    sk_head = head_for(torch.bfloat16, "sinkhorn_pallas")
    sk_head.load_state_dict(torch.load(os.path.join(ckpt, "arrays.pt"), map_location=dev))
    _zero_counts(fused_mhsa, sinkhorn_pallas)
    t0 = time.perf_counter()
    _, _, accs_s = evaluate_emd(sk_head, ds, n_episodes=EXACT_EPISODES,
                                ep_per_batch=CLI_EP_PER_BATCH, images_dev=images_dev, device=dev)
    torch.cuda.synchronize()
    sk_wall = time.perf_counter() - t0
    counts["emd_sinkhorn_beside_exact"] = _expect_counts(
        "sinkhorn_pallas beside exact", "tensor_core", _mhsa_per_forward() * n_batches,
        n_batches)
    del sk_head
    eps_x, eps_s = EXACT_EPISODES / eval_wall[0], EXACT_EPISODES / sk_wall
    print(f"solver exact {tag}: run_emd CLI {EXACT_EPISODES} episodes bf16 acc "
          f"{accs_x.mean():.4f}, {eps_x:.2f} episodes/s ({eval_wall[0]:.2f} s eval, "
          f"{cli_wall:.2f} s CLI), {host_s:.2f} s in the host solver; sinkhorn_pallas on the "
          f"same episodes acc {accs_s.mean():.4f}, {eps_s:.2f} episodes/s; launches {counts}")

    # fp32, TF32 off: exact flows against the Sinkhorn kernel's on the batch's
    # problems, then the kernel attention path against plain attention
    problems = []
    orig_flows = deepemd.exact_flows

    def recording(cost, w1, w2):
        if not problems:
            problems.append((cost.detach().clone(), w1.detach().clone(), w2.detach().clone()))
        return orig_flows(cost, w1, w2)

    idx = sample_emd_episode_indices(ds, EXACT_CHECK_EPISODES, WAY, SHOT + QUERY, 7)
    accs = {}
    # exact_flows adds to the attribute of whatever the module's name holds
    recording.host_seconds = orig_flows.host_seconds
    deepemd.exact_flows = recording
    try:
        for fused in (True, False):
            _, _, accs[fused] = evaluate_emd(head_for(torch.float32, "exact", fused), ds,
                                             indices=idx, ep_per_batch=CLI_EP_PER_BATCH,
                                             images_dev=images_dev, device=dev)
    finally:
        deepemd.exact_flows = orig_flows
        orig_flows.host_seconds = recording.host_seconds
    differ = float((accs[True] != accs[False]).mean())
    mean_d = float(abs(accs[True] - accs[False]).mean())
    cost, w1, w2 = problems[0]
    n1, n2 = cost.shape[-2:]
    cost, w1, w2 = cost.reshape(-1, n1, n2), w1.reshape(-1, n1), w2.reshape(-1, n2)
    flow = orig_flows(cost, w1, w2).double()
    sk = sinkhorn_pallas(cost, w1, w2).double()
    row = (flow.sum(-1) - w1.double()).abs().max().item()
    col = (flow.sum(-2) - w2.double() * (w1.double().sum(-1, keepdim=True)
                                        / w2.double().sum(-1, keepdim=True))).abs().max().item()
    excess = ((flow - sk) * cost.double()).sum((-2, -1)).max().item()
    print(f"solver exact {tag}: {cost.shape[0]} problems of one fp32 batch: marginals met to "
          f"{row:.2e} (rows) / {col:.2e} (columns), objective minus Sinkhorn's at most "
          f"{excess:.2e}; fp32 (TF32 off) kernel attention vs plain attention under exact: "
          f"episodes differing={differ:.4f}, mean|dacc|={mean_d:.5f}, acc "
          f"{accs[True].mean():.4f} vs {accs[False].mean():.4f}")
    if cost.shape[0] < EXACT_PROBLEMS or row > 1e-6 or col > 1e-6 or excess > 1e-6:
        _fail("solver exact: a flow misses a marginal, or costs more than Sinkhorn's")
    if differ > 0.01 or mean_d > 0.005:
        _fail("solver exact: fp32 kernel attention path and plain path disagree")

    # one meta_tune_emd step, fp32, bs 2
    c = dict(SUND_TRAIN, solver="exact")
    head = head_for(torch.float32, "exact", seed=4)
    labels = torch.arange(WAY, device=dev).repeat(QUERY)
    fn = tt.make_emd_episode_fn(head, WAY, SHOT, QUERY,
                                tt.make_patch_fn("grid", c["patch_list"], c["patch_ratio"], 80,
                                                 train=True),
                                ds.mean, ds.std, sfc=False, train=True)
    state = TrainState(head, tt.build_sund_optimizer(Config(c), head.parameters()))
    before = _state_copy(head)
    sampler = EpisodeSampler(ds.labels, 1, WAY, SHOT + QUERY, c["bs"])
    step_idx = torch.from_numpy(tt.interleaved(sampler.batch(rng_mod.np_rng(0, 9)), c["bs"],
                                               WAY, SHOT + QUERY)[None].astype(np.int64)).to(dev)
    _zero_counts(fused_mhsa, sinkhorn_pallas)
    state.optimizer.set_epoch(0)
    t0 = time.perf_counter()
    m = tt.make_emd_epoch_fn(fn, labels, c["bs"])(state, images_dev, step_idx, (0, 1))
    loss = m["loss"].cpu().numpy()
    step_s = time.perf_counter() - t0
    counts["meta_tune_emd_exact_step"] = _expect_counts("meta_tune_emd exact step", "general", 0)
    print(f"solver exact {tag}: one meta_tune_emd step, fp32, bs {c['bs']}: loss "
          f"{loss.tolist()} in {step_s:.2f} s")
    if not np.isfinite(loss).all():
        _fail(f"meta_tune_emd solver exact: the loss is not finite: {loss}")
    _check_moved("meta_tune_emd solver exact", head, before, bn_frozen=True)
    return {"episodes": EXACT_EPISODES, "acc_exact": float(accs_x.mean()),
            "acc_sinkhorn_pallas": float(accs_s.mean()), "episodes_per_s_exact": eps_x,
            "episodes_per_s_sinkhorn_pallas": eps_s, "host_solver_s": host_s,
            "cli_wall_s": cli_wall, "problems_checked": int(cost.shape[0]),
            "marginal_err": max(row, col), "objective_minus_sinkhorn_max": excess,
            "kernel_vs_plain_differ": differ, "kernel_vs_plain_mean_dacc": mean_d,
            "train_step_loss": loss.tolist(), "train_step_s": step_s}, counts


def _research_heads(dev, ds, images_dev, tag):
    """Phase 22: the 7 research heads at full width, 5-way 1- and 5-shot,
    15 queries, ``HEAD_E`` episodes a forward, fp32 and bf16: JAX's shapes,
    finite outputs, ms per forward, MHSA launches per encoder call; then the
    fp32 kernel attention path against plain attention. Returns (entry,
    launch counts per path)."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch import heads as _heads  # noqa: F401
    from fewshot_vit_tpu_torch.core.registry import models
    from fewshot_vit_tpu_torch.data.transforms import normalize
    from fewshot_vit_tpu_torch.eval.episodic import sample_episode_indices
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.ops.metric import compute_acc_kshots

    q_all = WAY * QUERY
    label = torch.arange(WAY, device=dev).repeat_interleave(QUERY)
    indices = {shot: sample_episode_indices(ds, HEAD_E * HEAD_BATCHES, WAY, shot + QUERY,
                                            HEAD_E, seed=5 + shot) for shot in (1, 5)}

    def make(name, dtype, fused):
        kw = {"classifier_args": {"n_classes": ds.n_classes}} if name == "token-label-v2" else {}
        return models.make(name, encoder=ENCODER, encoder_args={"use_pallas_attn": fused},
                           dtype=dtype, device=dev, seed=3, **kw)

    def batch(shot, b):
        idx = torch.from_numpy(indices[shot][b].astype(np.int64)).to(dev)
        x = normalize(images_dev[idx], ds.mean, ds.std).reshape(HEAD_E, WAY, shot + QUERY,
                                                                80, 80, 3)
        return x[:, :, :shot], x[:, :, shot:]

    def call(head, name, xs, xq):
        if name == "token-label-v2":
            return head(torch.cat([xs.reshape(-1, 80, 80, 3), xq.reshape(-1, 80, 80, 3)]))
        if name.startswith("meta-token"):
            return head(xs, xq)
        return head(xs, xq.reshape(HEAD_E, q_all, 80, 80, 3))

    def shapes(name, shot, c):
        if name == "token-label-v2":
            b = HEAD_E * WAY * (shot + QUERY)
            return [(b, 5, 5, 128), (b, ds.n_classes), (b, c), (b, 5, 5, c)]
        if name.startswith("meta-token"):
            return [(HEAD_E, q_all, WAY * shot), (HEAD_E, q_all, WAY)]
        return [(HEAD_E, q_all, WAY)] * {"token-label-ep-rw": 4}.get(name, 2)

    def calls(name):
        return 2 if name.startswith("meta-token") else 1

    def main_acc(name, out, shot):
        """Per-episode accuracy of the main logits (per image top-1 for v2)."""
        if name == "token-label-v2":
            return out[1].float().argmax(-1)
        if name.startswith("meta-token"):
            return torch.stack([compute_acc_kshots(out[0][e].float(), label, shot)
                                for e in range(HEAD_E)])
        return (out[0].float().argmax(-1) == label).float().mean(-1)

    entry, counts = {}, {}
    with torch.inference_mode():
        for dtype, route in ((torch.bfloat16, "tensor_core"), (torch.float32, "general")):
            dname = str(dtype).split(".")[1]
            heads = {name: make(name, dtype, True) for name in HEAD_NAMES}
            _zero_counts(fused_mhsa, sinkhorn_pallas)
            n_calls = 0
            for name, head in heads.items():
                for shot in (1, 5):
                    out = call(head, name, *batch(shot, 0))
                    n_calls += calls(name)
                    got = [tuple(o.shape) for o in out]
                    want = shapes(name, shot, head.encoder.out_dim)
                    if got != want:
                        _fail(f"{name} {dname} {shot}-shot: output shapes {got}, expected {want}")
                    if not all(torch.isfinite(o).all() for o in out):
                        _fail(f"{name} {dname} {shot}-shot: an output is not finite")
            torch.cuda.synchronize()
            counts[f"research_heads_{dname}"] = _expect_counts(
                f"research heads {dname}", route, _mhsa_per_forward() * n_calls)
            for name, head in heads.items():
                for shot in (1, 5):
                    xs, xq = batch(shot, 0)
                    entry.setdefault(name, {})[f"ms_{dname}_{shot}shot"] = _time_ms(
                        lambda: call(head, name, xs, xq), reps=10, warm=2)
            del heads
            torch.cuda.empty_cache()
        print(f"research heads {tag}: {len(HEAD_NAMES)} heads x 1/5-shot x bf16/fp32, "
              f"{HEAD_E} episodes of {WAY}-way {QUERY}-query a forward, JAX's shapes, finite; "
              f"launches {counts}; ms per forward {json.dumps(entry)}")

        differ, total, mean_d, worst = 0, 0, [], {}
        for name in HEAD_NAMES:
            k_head, p_head = make(name, torch.float32, True), make(name, torch.float32, False)
            for shot in (1, 5):
                for b in range(HEAD_BATCHES):
                    xs, xq = batch(shot, b)
                    a = main_acc(name, call(k_head, name, xs, xq), shot)
                    c = main_acc(name, call(p_head, name, xs, xq), shot)
                    d = (a != c).float()
                    differ += int(d.sum())
                    total += d.numel()
                    if name != "token-label-v2":
                        mean_d.append(float((a - c).abs().mean()))
                    worst[name] = worst.get(name, 0) + int(d.sum())
            del k_head, p_head
            torch.cuda.empty_cache()
    share, mean_dacc = differ / total, float(np.mean(mean_d))
    print(f"research heads {tag}: fp32 (TF32 off) kernel attention vs plain attention, "
          f"{total} episodes (images for token-label-v2): differing={share:.4f}, "
          f"mean|dacc|={mean_dacc:.5f}; differing by head {worst}")
    if share > 0.01 or mean_dacc > 0.005:
        _fail("research heads: fp32 kernel attention path and plain path disagree")
    entry["kernel_vs_plain"] = {"differ": share, "mean_dacc": mean_dacc, "n": total}
    return entry, counts


def _visualize(dev, tmp, tag, label, cfg_extra, real_modes, n_mhsa):
    """``eval.visualize`` on the card and on the CPU from the same weights:
    ``VIS_N`` JPGs, maps in [0, 1], the card's fp32 maps within 1e-3 of the
    CPU port's, ``n_mhsa`` fused-MHSA launches a run. Returns (entry, counts)."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.eval import visualize
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas

    cfg = _write_cfg(tmp, f"vis_{label}", {"dataset": "synthetic", "dataset_args": VIS_DATA,
                                           **cfg_extra})
    entry, counts = {}, {}
    for real in real_modes:
        mode = "real_attn" if real else "synthesized"
        out = os.path.join(tmp, f"vis_{label}_{mode}")
        argv = ["--config", cfg, "--n", str(VIS_N)] + (["--real-attn"] if real else [])
        _zero_counts(fused_mhsa, sinkhorn_pallas)
        t0 = time.perf_counter()
        maps, _ = _cli(visualize, argv + ["--out", out, "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[f"visualize_{label}_{mode}"] = _expect_counts(f"visualize {label} {mode}",
                                                             "general", n_mhsa)
        cpu_maps, _ = _cli(visualize, argv + ["--out", out + "_cpu", "--device", "cpu"])
        jpgs = sorted(f for f in os.listdir(out) if f.endswith(".jpg"))
        err = float(np.abs(maps - cpu_maps).max())
        print(f"visualize {tag} {label} {mode}: {len(jpgs)} JPGs in {wall:.2f} s, maps "
              f"{maps.shape} in [{maps.min():.3f}, {maps.max():.3f}], card vs CPU max|d| "
              f"{err:.2e}, launches {counts[f'visualize_{label}_{mode}']}")
        if len(jpgs) != VIS_N or maps.min() < 0.0 or maps.max() > 1.0 or err > 1e-3:
            _fail(f"visualize {label} {mode}: {len(jpgs)} JPGs, maps in [{maps.min()}, "
                  f"{maps.max()}], card vs CPU {err}")
        entry[mode] = {"wall_s": wall, "card_vs_cpu_max_abs": err, "shape": list(maps.shape)}
    return entry, counts


def _visualize_pretrain_cli(tmp, tag):
    """One pretrain CLI epoch with ``visualize_datasets: true``: JAX's PNG names."""
    import torch

    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.train import pretrain
    from fewshot_vit_tpu_torch.train.runner import parse_args

    cfg = os.path.join(tmp, "pretrain_vis.yaml")
    with open(cfg, "w") as f:
        f.write(_CLI_PRETRAIN.replace("max_epoch: 2", "max_epoch: 1")
                + "visualize_datasets: true\n")
    _zero_counts(fused_mhsa, sinkhorn_pallas)
    t0 = time.perf_counter()
    pretrain.main(*parse_args("chip_smoke pretrain", ["--config", cfg, "--save-root", tmp,
                                                      "--name", "pretrain_vis"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pngs = sorted(f for f in os.listdir(os.path.join(tmp, "pretrain_vis")) if f.endswith(".png"))
    want = ["visualize_fs_dataset.png", "visualize_train_aug.png",
            "visualize_train_dataset.png", "visualize_val_dataset.png"]
    print(f"visualize {tag}: pretrain CLI, 1 epoch with visualize_datasets in {wall:.1f} s: "
          f"{pngs}; fused_mhsa launches {dict(fused_mhsa.route_launches)}")
    if pngs != want:
        _fail(f"pretrain CLI visualize_datasets: wrote {pngs}, expected {want}")
    return {"wall_s": wall, "pngs": pngs}, {
        "pretrain_cli_visualize_datasets": {"fused_mhsa": dict(fused_mhsa.route_launches),
                                            "sinkhorn_pallas": dict(sinkhorn_pallas.route_launches)}}


INT8_EPISODES = 400         # each --int8 / --fold-bn eval CLI, 1-shot, 8 episodes a batch
EXPORT_EPB = 8              # episodes per episode-scorer artifact call
EXPORT_BATCHES = 4          # episode batches scored through each scorer artifact
EXPORT_EMD_EPB = {1: 8, 5: 1}  # episodes per EMD artifact call (5-shot: 20 SFC steps a call)
EXPORT_ENCODER_BATCH = 128
# sund_mini_visformer_5shot.yaml's sfc_*, 20 of its 100 steps (as phase 6 runs them)
SFC5_KW = {"sfc_lr": 0.1, "sfc_update_step": 20, "sfc_bs": 4}
PR8_MS = {"fused_mhsa (10240*6,100,42) bfloat16": 1.3517, "fused_mhsa (512*6,100,42) bfloat16": 0.0835,
          "fused_mhsa (512*6,100,42) float32": 0.6923, "sinkhorn_pallas (3000,13,13)": 0.0611}

# A fresh process that imports only torch and the port's kernels module (for
# the two ops), loads each exported artifact, calls it on saved uint8 inputs
# and reports ms per call and the kernel launches counted inside the call.
_SERVE = r'''
import json, sys, time
import torch
from torch.export.passes import move_to_device_pass
import fewshot_vit_tpu_torch.kernels as K

spec = json.load(open(sys.argv[1]))
torch.backends.cuda.matmul.allow_tf32 = False  # as the in-process forwards run
torch.backends.cudnn.allow_tf32 = False
dev = torch.device(spec["device"])
sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
report = {}
for a in spec["artifacts"]:
    t0 = time.perf_counter()
    ep = torch.export.load(a["path"])
    if a["move"]:
        ep = move_to_device_pass(ep, dev)
    prog = ep.module()
    load_s = time.perf_counter() - t0
    batches = [[t.to(dev) for t in b] for b in torch.load(a["inputs"])]
    outs, ms = [], []
    with torch.no_grad():
        if a["warm"]:
            prog(*batches[0])
        for batch in batches:
            for w in (K.fused_mhsa, K.sinkhorn_pallas):
                w.launches = 0
                w.route_launches = {r: 0 for r in w.route_launches}
            sync()
            t0 = time.perf_counter()
            outs.append(prog(*batch).cpu())
            ms.append((time.perf_counter() - t0) * 1e3)
            launches = {"fused_mhsa": dict(K.fused_mhsa.route_launches),
                        "sinkhorn_pallas": dict(K.sinkhorn_pallas.route_launches)}
    torch.save(outs, a["out"])
    report[a["name"]] = {"load_s": load_s, "ms_per_call": ms, "launches_last_call": launches,
                         "mods": sorted(m for m in sys.modules if m.startswith("fewshot"))}
print(json.dumps(report))
'''


def _device_ms(fn, reps: int = 20) -> float:
    """ms per call of the device work alone: the calls are queued behind a
    sleeping kernel, so the events around them time the card, not the host's
    dispatch."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s at 1.98 GHz: time to queue every call
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(fn, reps: int = 200) -> float:
    """Host microseconds per call to queue ``fn`` (no synchronization inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _retime_ops(dev, tag):
    """Phase 28: both kernels through their custom ops at the PERF table's
    shapes: events around 20 op calls (the way every earlier phase times
    them), the device work alone (calls queued behind a sleep) for the op and
    for the bare launch without the op's dispatch, and the host's dispatch
    time per op call."""
    import torch

    from fewshot_vit_tpu_torch.kernels import attention as mhsa_mod
    from fewshot_vit_tpu_torch.kernels import sinkhorn as sk_mod

    gen = torch.Generator(device=dev).manual_seed(28)
    rows = {}
    h, t, hd = 6, 100, 42
    for b, dtype in ((EP_PER_BATCH * WAY * (SHOT + QUERY), torch.bfloat16),
                     (PRE_TRAIN["batch_size"], torch.bfloat16),
                     (PRE_TRAIN["batch_size"], torch.float32)):
        qkv = torch.randn(b, t, 3, h, hd, generator=gen, device=dev).to(dtype)
        q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
        out = mhsa_mod._token_major(q)
        op = lambda: mhsa_mod.fused_mhsa(q, k, v, hd ** -0.5)  # noqa: E731
        bare = lambda: mhsa_mod._launch(q, k, v, out, hd ** -0.5, None)  # noqa: E731
        rows[f"fused_mhsa ({b}*{h},{t},{hd}) {str(dtype).split('.')[1]}"] = {
            "op_ms": _time_ms(op), "op_device_ms": _device_ms(op),
            "launch_device_ms": _device_ms(bare), "op_host_us": _host_us(op),
            "launch_host_us": _host_us(bare), "route": mhsa_mod.mhsa_route(q)}
        del qkv, q, k, v, out
    for b, n in ((3000, 13), (3000, 25), (160, 13), (WAY * QUERY * WAY, 13)):
        cost, w1, w2 = _ot_problem(b, n, n, gen, dev)
        out = torch.empty_like(cost)
        op = lambda: sk_mod.sinkhorn_pallas(cost, w1, w2)  # noqa: E731
        bare = lambda: sk_mod._launch(cost, w1, w2, out, 0.05, 100, None)  # noqa: E731
        rows[f"sinkhorn_pallas ({b},{n},{n})"] = {
            "op_ms": _time_ms(op), "op_device_ms": _device_ms(op),
            "launch_device_ms": _device_ms(bare), "op_host_us": _host_us(op),
            "launch_host_us": _host_us(bare), "route": sk_mod.sinkhorn_route(n, n)}
    for name, r in rows.items():
        r["pr8_ms"] = PR8_MS.get(name)
        r["host_bound"] = r["op_ms"] > 1.2 * r["op_device_ms"]
        print(f"timing {tag}: {name} through the op: {r['op_ms']:.4f} ms per call (events "
              f"around 20 calls), device work {r['op_device_ms']:.4f} ms (bare launch "
              f"{r['launch_device_ms']:.4f}), host dispatch {r['op_host_us']:.1f} us a call "
              f"(bare launch {r['launch_host_us']:.1f})"
              f"{', host-bound' if r['host_bound'] else ''}; {r['route']} route; PR 8: "
              f"{r['pr8_ms']}")
    return rows


def _int8_products(dev, tag):
    """Phase 24a: each kind of int8 layer of the encoder at the eval CLI's
    batch (640 images): the int32 result of ``torch._int_mm`` (after im2col
    for the convs) must EQUAL a float64 product of the same int8 operands."""
    import torch
    import torch.nn.functional as F

    from fewshot_vit_tpu_torch.models import quant

    gen = torch.Generator(device=dev).manual_seed(24)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=gen, device=dev,  # noqa: E731
                                  dtype=torch.int64).to(torch.int8)
    b = ZOO_BATCH
    convs = (("stem conv1 3x3/s2, K 27 padded to 32", (b, 80, 80, 3), (64, 3, 3, 3), 2, 1, 1),
             ("stem conv3 3x3, K 1152", (b, 40, 40, 128), (128, 128, 3, 3), 1, 1, 1),
             ("stage-1 grouped 3x3, g 8, K 288", (b, 20, 20, 256), (256, 32, 3, 3), 1, 1, 8),
             ("patch embed 2x2/s2, K 512", (b, 20, 20, 128), (256, 128, 2, 2), 2, 0, 1))
    dense = (("stage-2 qkv, K 256, N 756", (b * 100, 256), (756, 256)),
             ("stage-3 MLP conv3, K 2048", (b * 25, 2048), (512, 2048)))
    out = {}
    for name, xs, ws, st, pad, g in convs:
        q, w = i8(*xs), i8(*ws)
        y = torch.cat(list(quant.conv_int32_chunks(q, w, st, pad, g)))
        want = F.conv2d(q.permute(0, 3, 1, 2).double(), w.double(), None, st, pad, 1, g)
        out[name] = bool(y.dtype == torch.int32 and torch.equal(y.double(), want.permute(0, 2, 3, 1)))
        del q, w, y, want
    for name, xs, ws in dense:
        q, w = i8(*xs), i8(*ws)
        y = quant.int8_matmul(q, w)
        out[name] = bool(y.dtype == torch.int32 and torch.equal(y.double(), q.double() @ w.double().T))
        del q, w, y
    torch.cuda.empty_cache()
    print(f"int8 {tag}: int32 products equal to float64 on every layer kind: {out}")
    if not all(out.values()):
        _fail(f"an int8 product differs from float64: {out}")
    return out


def _int8_cli(dev, tmp, pth, tag):
    """Phase 24b: ``eval.run --int8`` with and without ``--bf16`` beside
    ``--fold-bn`` in both dtypes, on the same 400 episodes from the phase-14
    ``.pth``; the CLI's accuracies equal in-process ``evaluate`` of the head
    built as the CLI builds it, episodes/s from that run; 2 MHSA launches a
    batch; |acc(int8) - acc(folded fp32)| < 0.08 (JAX's gate)."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import datasets
    from fewshot_vit_tpu_torch.core.rng import DEFAULT_SEED
    from fewshot_vit_tpu_torch.data.staging import upload_images
    from fewshot_vit_tpu_torch.eval import run as eval_run
    from fewshot_vit_tpu_torch.eval.episodic import evaluate
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.models.fold import fold_encoder_in_head
    from fewshot_vit_tpu_torch.models.quant import quantize_encoder_in_head

    data = {"n_classes": 20, "n_per_class": 600, "image_size": 80, "seed": 0}
    cfg = {"dataset": "synthetic", "dataset_args": data, "encoder": ENCODER,
           "model_args": {"encoder_args": {"use_pallas_attn": True}}, "load": pth}
    path = _write_cfg(tmp, "eval_int8", cfg)
    ds = datasets.make("synthetic", **data)
    images_dev = upload_images(ds.images, dev)
    n_batches = math.ceil(INT8_EPISODES / CLI_EP_PER_BATCH)
    per = _mhsa_per_forward()
    entry, counts, accs_all = {}, {}, {}
    for label, flags, dtype, route in (
            ("int8_bf16", ["--int8", "--bf16"], torch.bfloat16, "tensor_core"),
            ("int8_fp32", ["--int8"], torch.float32, "general"),
            ("fold_bf16", ["--fold-bn", "--bf16"], torch.bfloat16, "tensor_core"),
            ("fold_fp32", ["--fold-bn"], torch.float32, "general")):
        _zero_counts(fused_mhsa, sinkhorn_pallas)
        t0 = time.perf_counter()
        accs, _ = _cli(eval_run, ["--config", path, "--episodes", str(INT8_EPISODES),
                                  "--device", str(dev)] + flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # --int8 runs one more encoder forward: the calibration batch
        counts[f"eval_cli_{label}"] = _expect_counts(
            f"eval CLI {label}", route, per * (n_batches + ("int8" in label)))
        head = eval_run.load_model_for_eval(Config(cfg), dtype, dev)
        head = (quantize_encoder_in_head(head, eval_run.calibration_images(ds, dev))
                if "int8" in label else fold_encoder_in_head(head))
        evaluate(head, ds, n_episodes=CLI_EP_PER_BATCH, seed=3, images_dev=images_dev,
                 device=dev)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, want = evaluate(head, ds, n_episodes=INT8_EPISODES, ep_per_batch=CLI_EP_PER_BATCH,
                              seed=DEFAULT_SEED, images_dev=images_dev, device=dev)
        eps = INT8_EPISODES / (time.perf_counter() - t0)
        if not np.array_equal(accs, want):
            _fail(f"eval CLI {label}: the CLI and in-process evaluate disagree")
        accs_all[label] = accs
        entry[label] = {"acc": float(accs.mean()), "episodes_per_s": eps, "cli_wall_s": wall}
        print(f"int8 {tag}: eval CLI {' '.join(flags)}, {INT8_EPISODES} episodes: acc "
              f"{accs.mean():.4f}, in-process {eps:.1f} episodes/s at {CLI_EP_PER_BATCH} a batch, "
              f"CLI wall {wall:.2f} s; launches {counts[f'eval_cli_{label}']}")
        del head
    for label in ("int8_bf16", "int8_fp32"):
        d = abs(entry[label]["acc"] - entry["fold_fp32"]["acc"])
        entry[label]["abs_d_acc_vs_fold_fp32"] = d
        if not d < 0.08:
            _fail(f"{label}: |acc - acc(folded fp32)| = {d:.4f}, JAX's gate is 0.08")
    if not entry["fold_fp32"]["acc"] > 0.7:
        _fail(f"the folded fp32 protocol is degenerate: acc {entry['fold_fp32']['acc']:.4f}")
    del images_dev
    torch.cuda.empty_cache()
    return entry, counts


def _emd_cfg(pth, shot):
    cfg = {"test_dataset": "synthetic",
           "test_dataset_args": {"n_classes": 20, "n_per_class": 600, "image_size": 80, "seed": 0},
           "model_args": {"encoder": ENCODER, "encoder_args": {"use_pallas_attn": True}},
           "load_encoder": pth, "deepemd": "grid", "patch_list": [2, 3], "patch_ratio": 2,
           "temperature": 12.5, "solver": "sinkhorn_pallas", "image_size": 80}
    return {**cfg, **SFC5_KW} if shot > 1 else cfg


def _export_artifacts(dev, tmp, pth, tag):
    """Phases 25-26: ``eval.export`` from the phase-14 ``.pth`` (the episode
    scorer in bf16 and fp32 BN folded, one traced on the CPU for ``cpu,cuda``,
    the encoder, the EMD scorer 1- and 5-shot with ``sinkhorn_pallas``),
    each loaded and called in a fresh process that imports only torch and
    the kernels module, held against the in-process forward: fp32 logits
    within 1e-4, bf16 and 5-shot SFC by the accuracy rule; the kernels'
    launches counted inside each artifact call."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import datasets, models
    from fewshot_vit_tpu_torch.core.rng import DEFAULT_SEED
    from fewshot_vit_tpu_torch.data.staging import upload_images
    from fewshot_vit_tpu_torch.data.transforms import normalize
    from fewshot_vit_tpu_torch.eval import export as export_mod
    from fewshot_vit_tpu_torch.eval import run as eval_run
    from fewshot_vit_tpu_torch.eval.emd_eval import sample_emd_episode_indices
    from fewshot_vit_tpu_torch.eval.episodic import sample_episode_indices
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.models.fold import fold_encoder_in_head
    from fewshot_vit_tpu_torch.ops.episodes import make_nk_label, split_shot_query
    from fewshot_vit_tpu_torch.ops.metric import per_episode_acc
    from fewshot_vit_tpu_torch.train.meta_tune_emd import make_emd_episode_fn, make_patch_fn
    from fewshot_vit_tpu_torch.train.runner import resolve_checkpoint

    data = {"n_classes": 20, "n_per_class": 600, "image_size": 80, "seed": 0}
    cfg = {"dataset": "synthetic", "dataset_args": data, "encoder": ENCODER,
           "model_args": {"encoder_args": {"use_pallas_attn": True}}, "load": pth}
    meta_path = _write_cfg(tmp, "export_meta", cfg)
    emd_paths = {s: _write_cfg(tmp, f"export_emd{s}", _emd_cfg(pth, s)) for s in (1, 5)}
    ds = datasets.make("synthetic", **data)
    images_dev = upload_images(ds.images, dev)
    per = _mhsa_per_forward()

    # the inputs: seeded episodes of the synthetic split, uint8
    idx = sample_episode_indices(ds, EXPORT_EPB * EXPORT_BATCHES, WAY, SHOT + QUERY,
                                 EXPORT_EPB, 25)
    scorer_in = [split_shot_query(images_dev[torch.from_numpy(i.astype(np.int64)).to(dev)],
                                  WAY, SHOT, QUERY, EXPORT_EPB) for i in idx]
    enc_in = images_dev[:EXPORT_ENCODER_BATCH]
    emd_in = {}
    for s, e in EXPORT_EMD_EPB.items():
        ei = sample_emd_episode_indices(ds, e, WAY, s + QUERY, seed=26)
        emd_in[s] = images_dev[torch.from_numpy(ei.astype(np.int64)).to(dev)]

    arts = (("scorer_bf16", meta_path, ["--fold-bn", "--bf16", "--ep-per-batch", str(EXPORT_EPB)]),
            ("scorer_fp32", meta_path, ["--fold-bn", "--ep-per-batch", str(EXPORT_EPB)]),
            ("scorer_fp32_cpu_cuda", meta_path, ["--fold-bn", "--ep-per-batch", str(EXPORT_EPB),
                                                 "--platforms", "cpu,cuda"]),
            ("encoder_fp32", meta_path, ["--encoder-only", "--batch", str(EXPORT_ENCODER_BATCH)]),
            ("emd_1shot", emd_paths[1], ["--emd", "--shot", "1",
                                         "--ep-per-batch", str(EXPORT_EMD_EPB[1])]),
            ("emd_5shot", emd_paths[5], ["--emd", "--shot", "5",
                                         "--ep-per-batch", str(EXPORT_EMD_EPB[5])]))
    entry, spec = {}, []
    for name, path, flags in arts:
        out = os.path.join(tmp, f"{name}.pt2")
        _zero_counts(fused_mhsa, sinkhorn_pallas)
        t0 = time.perf_counter()
        ep, text = _cli(export_mod, ["--config", path, "--out", out, "--device", str(dev)] + flags)
        export_s = time.perf_counter() - t0
        if fused_mhsa.launches or sinkhorn_pallas.launches:
            _fail(f"exporting {name} launched a kernel: tracing must not run one")
        if "exported " not in text:
            _fail(f"eval.export {name}: no 'exported' line")
        nodes = sum(len(list(g.graph.nodes)) for g in ep.graph_module.modules()
                    if isinstance(g, torch.fx.GraphModule))
        entry[name] = {"export_s": export_s, "mb": os.path.getsize(out) / 1e6,
                       "nodes": len(list(ep.graph.nodes)), "nodes_with_scan_bodies": nodes}
        inputs = (scorer_in if name.startswith("scorer") else
                  [(enc_in,)] if name.startswith("encoder") else [(emd_in[int(name[4])],)])
        in_path = os.path.join(tmp, f"{name}_in.pt")
        torch.save([[t.cpu() for t in batch] for batch in inputs], in_path)
        # every call but the 5-shot one's (SFC's steps) follows a warm call
        spec.append({"name": name, "path": out, "inputs": in_path, "warm": name != "emd_5shot",
                     "move": name.endswith("cpu_cuda"),
                     "out": os.path.join(tmp, f"{name}_out.pt")})
        del ep
    spec_path = os.path.join(tmp, "serve.json")
    with open(spec_path, "w") as f:
        json.dump({"device": str(dev), "artifacts": spec}, f)
    serve_py = os.path.join(tmp, "serve.py")
    with open(serve_py, "w") as f:
        f.write(_SERVE)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, serve_py, spec_path], capture_output=True, text=True,
                          env=env, timeout=600)
    serve_s = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stderr[-4000:])
        _fail(f"the fresh serving process failed (exit {proc.returncode})")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"export {tag}: the fresh serving process ran in {serve_s:.1f} s, modules of the port "
          f"it imported: {report['scorer_bf16']['mods']}")

    # the in-process forwards on the same inputs
    want = {}
    with torch.no_grad():
        for dtype, key in ((torch.bfloat16, "scorer_bf16"), (torch.float32, "scorer_fp32")):
            head = fold_encoder_in_head(eval_run.load_model_for_eval(Config(cfg), dtype, dev))
            want[key] = [head(normalize(xs, ds.mean, ds.std), normalize(xq, ds.mean, ds.std)).cpu()
                         for xs, xq in scorer_in]
        want["scorer_fp32_cpu_cuda"] = want["scorer_fp32"]
        head = eval_run.load_model_for_eval(Config(cfg), torch.float32, dev)
        want["encoder_fp32"] = [head.encoder(normalize(enc_in, ds.mean, ds.std))[1].cpu()]
        del head
        for s in (1, 5):
            c = Config(_emd_cfg(pth, s))
            emd = models.make("deepemd", encoder=ENCODER,
                              encoder_args={"use_pallas_attn": True}, solver="sinkhorn_pallas",
                              temperature=12.5, device=dev, seed=DEFAULT_SEED)
            resolve_checkpoint(c, emd, ENCODER)
            sfc_kw = {"steps": SFC5_KW["sfc_update_step"], "lr": SFC5_KW["sfc_lr"],
                      "batch_size": SFC5_KW["sfc_bs"]}
            fn = make_emd_episode_fn(emd, WAY, s, QUERY, make_patch_fn("grid", [2, 3], 2.0, 80,
                                                                       False),
                                     ds.mean, ds.std, sfc=s > 1, sfc_kw=sfc_kw, seed=0)
            _zero_counts(fused_mhsa, sinkhorn_pallas)
            t0 = time.perf_counter()
            want[f"emd_{s}shot"] = [fn(emd_in[s], list(range(EXPORT_EMD_EPB[s]))).cpu()]
            torch.cuda.synchronize()
            entry[f"emd_{s}shot"]["in_process_ms"] = (time.perf_counter() - t0) * 1e3
            print(f"export {tag}: the in-process EMD {s}-shot forward of "
                  f"{EXPORT_EMD_EPB[s]} episodes: {entry[f'emd_{s}shot']['in_process_ms']:.1f} ms")
            del emd
    counts, failed = {}, []
    for name, _, _ in arts:
        got = torch.load(os.path.join(tmp, f"{name}_out.pt"))
        r = report[name]
        g, w = torch.cat(got), torch.cat(want[name])
        err = (g - w).abs().max().item()
        e = entry[name]
        e.update({"ms_per_call": r["ms_per_call"], "load_s": r["load_s"], "max_abs_d": err,
                  "launches_per_call": r["launches_last_call"]})
        n_mhsa = sum(r["launches_last_call"]["fused_mhsa"].values())
        n_sk = sum(r["launches_last_call"]["sinkhorn_pallas"].values())
        expect_mhsa = per  # one encoder forward per call
        expect_sk = 1 if name.startswith("emd") else 0
        counts[f"export_{name}"] = r["launches_last_call"]
        if n_mhsa != expect_mhsa or n_sk != expect_sk:
            failed.append(f"artifact {name}: expected {expect_mhsa} fused_mhsa and {expect_sk} "
                          f"sinkhorn_pallas launches a call, counted {r['launches_last_call']}")
        if name in ("scorer_bf16", "emd_5shot"):
            lab = (make_nk_label(WAY, QUERY, g.shape[0]).to(g.device) if name.startswith("scorer")
                   else torch.arange(WAY).repeat(QUERY)[None].expand(g.shape[0], -1))
            a, b = per_episode_acc(g, lab).numpy(), per_episode_acc(w, lab).numpy()
            differ, mean_d = float((a != b).mean()), float(abs(a - b).mean())
            e.update({"episodes_differing": differ, "mean_abs_d_acc": mean_d,
                      "acc": float(a.mean())})
            ok = differ <= 0.01 and mean_d <= 0.005
        else:
            ok = err <= 1e-4
        print(f"export {tag}: {name}: {e['export_s']:.1f} s to export, {e['mb']:.1f} MB, "
              f"{e['nodes']} graph nodes ({e['nodes_with_scan_bodies']} with scan bodies); "
              f"in a fresh process ms per call {[round(x, 2) for x in e['ms_per_call']]}, "
              f"launches a call {r['launches_last_call']}; against the in-process forward "
              f"max|d|={err:.3e}" + (f", episodes differing {e['episodes_differing']:.4f}, "
                                     f"mean|dacc| {e['mean_abs_d_acc']:.5f}"
                                     if "episodes_differing" in e else " (tol 1e-4)")
              + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"artifact {name} disagrees with the in-process forward")
    if failed:
        _fail("; ".join(failed))
    d = max((torch.cat(torch.load(os.path.join(tmp, "scorer_fp32_cpu_cuda_out.pt")))
             - torch.cat(torch.load(os.path.join(tmp, "scorer_fp32_out.pt")))).abs().max().item(),
            0.0)
    entry["cpu_cuda_vs_cuda_max_abs_d"] = d
    print(f"export {tag}: the cpu,cuda artifact traced on the CPU and moved to the card against "
          f"the one traced on the card: max|d|={d:.3e} (tol 1e-4)")
    if not d <= 1e-4:
        _fail("the artifact traced on the CPU and the one traced on the card disagree")
    entry["serve_process_s"] = serve_s
    del images_dev
    torch.cuda.empty_cache()
    return entry, counts


def _profile_dir_phase(tmp, tag):
    """Phase 27: the pretrain CLI for 2 epochs with ``--profile-dir``: a
    Chrome trace of epoch 2 holding CUDA kernel events."""
    import torch

    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.train import pretrain
    from fewshot_vit_tpu_torch.train.runner import parse_args

    cfg = os.path.join(tmp, "pretrain_profile.yaml")
    with open(cfg, "w") as f:
        f.write(_CLI_PRETRAIN)
    prof_dir = os.path.join(tmp, "profile")
    _zero_counts(fused_mhsa, sinkhorn_pallas)
    t0 = time.perf_counter()
    pretrain.main(*parse_args("chip_smoke pretrain", [
        "--config", cfg, "--save-root", tmp, "--name", "pretrain_profile",
        "--profile-dir", prof_dir]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    traces = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
    if traces != ["epoch2.trace.json"]:
        _fail(f"--profile-dir wrote {traces}, expected ['epoch2.trace.json']")
    path = os.path.join(prof_dir, traces[0])
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    cats = {}
    for ev in events:
        cats[ev.get("cat")] = cats.get(ev.get("cat"), 0) + 1
    kernels = cats.get("kernel", 0)
    print(f"--profile-dir {tag}: pretrain CLI, 2 epochs in {wall:.1f} s; {path}: "
          f"{os.path.getsize(path) / 1e6:.1f} MB, {len(events)} events, {kernels} CUDA kernel "
          f"events, {cats.get('cpu_op', 0)} CPU op events")
    if not kernels:
        _fail("the --profile-dir trace holds no CUDA kernel event")
    return {"wall_s": wall, "trace_mb": os.path.getsize(path) / 1e6, "events": len(events),
            "kernel_events": kernels}, {
        "pretrain_cli_profile_dir": {"fused_mhsa": dict(fused_mhsa.route_launches),
                                     "sinkhorn_pallas": dict(sinkhorn_pallas.route_launches)}}


# --- slice 10: the mesh, ranks launched from here -----------------------------------------
MESH_EPISODES = 256         # eval.run --mesh-data 2, 8 a batch: 4 episodes a rank a batch
MESH_EMD_EPISODES = 64      # eval.run_emd --mesh-data 2, 1-shot grid, 8 a batch
MESH_SUND_DATA = {"n_classes": 20, "n_per_class": 40, "image_size": 80, "seed": 3}
MESH_SUN_DATA = {"n_classes": 64, "n_per_class": 8, "image_size": 84, "seed": 5}  # one batch
MESH_SUN_OPT = {"optimizer": "sgd", "optimizer_args": {"lr": 0.05}}
MESH_TIMEOUT_S = 300


def _mesh_eval_cfg(pth):
    return {"dataset": "synthetic",
            "dataset_args": {"n_classes": 20, "n_per_class": 600, "image_size": 80, "seed": 0},
            "encoder": ENCODER, "model_args": {"encoder_args": {"use_pallas_attn": True}},
            "load": pth}


def _counted(fn):
    """(fn(), seconds, the launches it made by kernel and route)."""
    import torch

    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas

    _zero_counts(fused_mhsa, sinkhorn_pallas)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {
        "fused_mhsa": dict(fused_mhsa.route_launches),
        "sinkhorn_pallas": dict(sinkhorn_pallas.route_launches)}


def _mesh_eval_timing(dev, pth, mesh):
    """Episodes/s of ``evaluate`` (``--fold-bn --bf16``, as the CLI builds
    the head) over ``MESH_EPISODES``, after a warm batch."""
    import torch

    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import datasets
    from fewshot_vit_tpu_torch.data.staging import upload_images
    from fewshot_vit_tpu_torch.eval import run as eval_run
    from fewshot_vit_tpu_torch.eval.episodic import evaluate
    from fewshot_vit_tpu_torch.models.fold import fold_encoder_in_head

    cfg = _mesh_eval_cfg(pth)
    ds = datasets.make("synthetic", **cfg["dataset_args"])
    images = upload_images(ds.images, dev)
    head = fold_encoder_in_head(eval_run.load_model_for_eval(Config(cfg), torch.bfloat16, dev))
    kw = dict(ep_per_batch=CLI_EP_PER_BATCH, images_dev=images, device=dev, mesh=mesh)
    evaluate(head, ds, n_episodes=CLI_EP_PER_BATCH, seed=3, **kw)
    _, secs, _ = _counted(lambda: evaluate(head, ds, n_episodes=MESH_EPISODES, seed=4, **kw))
    return MESH_EPISODES / secs


def _mesh_sund_step(dev, mesh):
    """One ``meta_tune_emd`` step at ``SUND_TRAIN``'s geometry (fp32, ``bs``
    2, ``sinkhorn_pallas``) from seeded weights: (state dict before, after,
    loss, seconds, launches)."""
    import numpy as np
    import torch

    from fewshot_vit_tpu_torch.core import rng as rng_mod
    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import datasets, models
    from fewshot_vit_tpu_torch.data.sampler import EpisodeSampler
    from fewshot_vit_tpu_torch.train import meta_tune_emd as tt
    from fewshot_vit_tpu_torch.train.state import TrainState

    c = SUND_TRAIN
    way, shot, query, bs = c["way"], c["shot"], c["query"], c["bs"]
    ds = datasets.make("synthetic", **MESH_SUND_DATA)
    head = models.make("deepemd", encoder=ENCODER, encoder_args={"use_pallas_attn": True},
                       temperature=c["temperature"], solver_iters=c["solver_iters"],
                       solver=c["solver"], device=dev, seed=0)
    fn = tt.make_emd_episode_fn(head, way, shot, query,
                                tt.make_patch_fn(c["deepemd"], c["patch_list"], c["patch_ratio"],
                                                 c["image_size"], train=True),
                                ds.mean, ds.std, sfc=False, train=True)
    state = TrainState(head, tt.build_sund_optimizer(Config(c), head.parameters()))
    start = _state_copy(head)
    epoch = tt.make_emd_epoch_fn(fn, torch.arange(way, device=dev).repeat(query), bs, mesh=mesh)
    sampler = EpisodeSampler(ds.labels, 1, way, shot + query, bs)
    idx = tt.interleaved(sampler.batch(rng_mod.np_rng(0, 1)), bs, way, shot + query)
    idx = torch.from_numpy(idx[None].astype(np.int64)).to(dev)
    images = torch.from_numpy(ds.images).to(dev)
    m, secs, counts = _counted(lambda: epoch(state, images, idx, (0, 1)))
    return start, state.variables, float(m["loss"][0]), secs, counts


def _mesh_sun_step(dev, mesh):
    """One SUN step (``train.loop.make_sun_epoch``) of batch 512, the dual
    view, drop-path 0.5, an fp32 teacher, SGD, seeded weights: (state dict
    before, after (the full layout), loss, seconds, launches, ``again``, the
    student's column-parallel layers under a ``model`` axis). ``again(clocked)``
    runs one more step of the same batch and returns (seconds, collective
    seconds, collectives): a warm step, with host clocks around each
    collective (synchronized) when ``clocked``."""
    import torch

    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import datasets, models
    from fewshot_vit_tpu_torch.data.augment import make_dual_view_fn
    from fewshot_vit_tpu_torch.heads import token_label as _token_label  # noqa: F401
    from fewshot_vit_tpu_torch.parallel import mesh as pmesh
    from fewshot_vit_tpu_torch.train.loop import make_sun_epoch
    from fewshot_vit_tpu_torch.train.runner import build_optimizer
    from fewshot_vit_tpu_torch.train.state import TrainState

    mini = datasets.make("synthetic", **MESH_SUN_DATA)

    def token_label(seed):
        return models.make("token-label", encoder=ENCODER,
                           encoder_args={"drop_path_rate": 0.5, "use_pallas_attn": True},
                           classifier_args={"n_classes": mini.n_classes}, device=dev, seed=seed)

    student, teacher = token_label(0), token_label(1).requires_grad_(False).eval()
    start = _state_copy(student)
    # the model axis: column-parallel wide layers, before the optimizer sees them
    sliced = pmesh.param_shardings(mesh, student) if mesh is not None else []
    state = TrainState(student, build_optimizer(Config(MESH_SUN_OPT), student.parameters()))
    epoch = make_sun_epoch(make_dual_view_fn(mini.mean, mini.std, out_size=80), mini.mean,
                           mini.std, **SUN_KW)
    images = torch.from_numpy(mini.images).to(dev)
    labels = torch.from_numpy(mini.labels.astype("int64")).to(dev)
    idx = _steps_idx(len(mini), 1, 1, dev)
    plain = (pmesh.reduce_sum_, pmesh._gather_flat)
    spent = [0.0, 0]

    def clocked(fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return out
        return timed

    def step(clock):
        spent[:] = [0.0, 0]
        if clock:
            pmesh.reduce_sum_, pmesh._gather_flat = map(clocked, plain)
        try:
            with pmesh.use_mesh(mesh):
                return _counted(lambda: epoch(state, teacher, images, labels, idx, (0, 1)))
        finally:
            pmesh.reduce_sum_, pmesh._gather_flat = plain

    m, secs, counts = step(False)
    after = {k: v.detach().clone() for k, v in state.variables.items()}

    def again(clock):
        _, secs, _ = step(clock)
        return secs, spent[0], spent[1]

    return start, after, float(m["loss"][0]), secs, counts, again, sliced


def _gloo_cuda_probe(dev):
    """Which collectives gloo takes with tensors on the card."""
    import torch
    import torch.distributed as dist

    world, out = dist.get_world_size(), {}
    x = torch.ones(4, device=dev)
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
            ("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)],
                                                   x)),
            ("all_gather_into_tensor",
             lambda: dist.all_gather_into_tensor(torch.empty(world * 4, device=dev), x))):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError) as e:  # the probe records what the backend refuses
            out[name] = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return out


def _mesh_rank(job_dir) -> int:
    """One rank of a slice-10 group (``python -m torch.distributed.run ...
    chip_smoke.py --mesh-rank DIR``): the spec's phases through the entry
    points under the mesh, launches counted in this rank, results written
    to ``DIR/rank<r>.json`` (and rank 0's state dicts and outputs)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fewshot_vit_tpu_torch.eval import export as export_mod
    from fewshot_vit_tpu_torch.eval import run as eval_run
    from fewshot_vit_tpu_torch.eval import run_emd
    from fewshot_vit_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(job_dir, "spec.json")) as f:
        spec = json.load(f)
    rank, t_start = int(os.environ["RANK"]), time.perf_counter()
    axes = {"data": spec["data"], **({"model": spec["model"]} if spec.get("model") else {})}
    mesh = pmesh.make_mesh(axes, spec["device"])
    dev = mesh.device
    out = {"rank": rank, "backend": mesh.backend, "device": str(dev),
           "describe": mesh.describe()}
    save = (lambda obj, name: torch.save(obj, os.path.join(job_dir, name))) if rank == 0 else (
        lambda obj, name: None)
    if mesh.size("model") > 1:  # slice 11, phase 36: the model axis
        return _model_axis_rank(job_dir, mesh, out, save, t_start)
    if spec["data"] == 1:  # NCCL, one rank: a collective on the default group, then SUN
        x = torch.ones(2, device=dev)
        dist.all_reduce(x)
        out["all_reduce_ok"] = bool((x == 1).all())
    else:
        out["gloo_cuda_probe"] = _gloo_cuda_probe(dev)
        mesh2 = ["--mesh-data", str(spec["data"]), "--device", spec["device"]]
        accs, secs, counts = _counted(lambda: eval_run.main(
            ["--config", spec["eval_cfg"], "--episodes", str(MESH_EPISODES), "--fold-bn",
             "--bf16"] + mesh2))
        out["eval_bf16"] = {"accs": accs.tolist(), "s": secs, "launches": counts,
                            "episodes_per_s": _mesh_eval_timing(dev, spec["pth"], mesh)}
        accs, secs, counts = _counted(lambda: run_emd.main(
            ["--config", spec["emd_cfg"], "--shot", "1", "--episodes", str(MESH_EMD_EPISODES),
             "--ep-per-batch", str(CLI_EP_PER_BATCH), "--bf16"] + mesh2))
        out["run_emd_bf16"] = {"accs": accs.tolist(), "s": secs, "launches": counts}
        _, sd, loss, secs, counts = _mesh_sund_step(dev, mesh)
        save(sd, "sund.pt")
        out["sund_step"] = {"loss": loss, "s": secs, "launches": counts}
        outs, ms, counts = _serve_calls(dev, spec["artifact"], spec["serve_inputs"], mesh)
        save(torch.cat([o.cpu() for o in outs]), "serve.pt")
        out["serve"] = {"ms_per_call": ms, "launches": counts}
    _, sd, loss, secs, counts, again, _ = _mesh_sun_step(dev, mesh)
    save(sd, "sun.pt")
    out["sun_step"] = {"loss": loss, "s": secs, "launches": counts}
    if spec["data"] > 1:  # the NCCL rank shares the card with the one-rank runs: not timed
        warm_s = again(False)[0]
        clocked_s, coll_s, n_coll = again(True)
        out["sun_step"].update({"warm_s": warm_s, "clocked_s": clocked_s,
                                "collectives_s": coll_s, "collectives": n_coll})
    out["rank_s"] = time.perf_counter() - t_start
    with open(os.path.join(job_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _serve_calls(dev, path, inputs, mesh):
    """``eval.export.serve`` of the artifact at ``path`` over the batches
    saved at ``inputs``, after one warm call: (outputs, ms per call, the
    last call's launches)."""
    import torch

    from fewshot_vit_tpu_torch.eval import export as export_mod

    ep = export_mod.load_exported(path, device=str(dev), mesh=mesh)
    batches = [[t.to(dev) for t in b] for b in torch.load(inputs)]
    with torch.no_grad():
        export_mod.serve(ep, *batches[0], mesh=mesh)
        calls = [_counted(lambda: export_mod.serve(ep, *b, mesh=mesh)) for b in batches]
    return [c[0] for c in calls], [c[1] * 1e3 for c in calls], calls[-1][2]


def _launch_group(job_dir, nproc, spec):
    """Start ``nproc`` ranks of ``_mesh_rank`` on this card with
    ``torch.distributed.run`` (not waited for)."""
    import socket

    os.makedirs(job_dir, exist_ok=True)
    with open(os.path.join(job_dir, "spec.json"), "w") as f:
        json.dump(spec, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
           "--master-addr", "127.0.0.1", "--master-port", str(port),
           os.path.abspath(__file__), "--mesh-rank", job_dir]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
               OMP_NUM_THREADS="1")
    # output to a file: a group may run while nothing reads it
    with open(os.path.join(job_dir, "log.txt"), "w") as log:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                                start_new_session=True)


def _wait_group(proc, job_dir, nproc, label):
    try:
        proc.wait(timeout=MESH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _stop([proc])
        _fail(f"{label}: the ranks outlived {MESH_TIMEOUT_S} s")
    with open(os.path.join(job_dir, "log.txt")) as f:
        text = f.read()
    if proc.returncode != 0:
        print(text[-6000:])
        _fail(f"{label}: torch.distributed.run exited {proc.returncode}")
    outs = []
    for r in range(nproc):
        with open(os.path.join(job_dir, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs, text


STATE_RULES = {"param": 2e-5, "stem": float("inf"), "bn_stat": 1e-5}  # ROADMAP section 3
ROUNDING = 2e-8  # about two fp32 ulps of a weight of 0.1 (7.5e-9 each)


def _hold_state(label, got, want, start, loss_got, loss_want):
    """The trainer rules of ROADMAP section 3 between two state dicts after
    one step from ``start``, each bound to the step's own update so that a
    state left unchanged or a step that lost a rank's share fails: loss
    1e-4; for each kind (the parameters, the stem's parameters, the BN
    statistics) max|d| within its limit, the smaller of its rule in
    ``STATE_RULES`` (the stem has none: the stem rule, 1e-2 of its update)
    and 1e-2 of the kind's largest update, but not below ``ROUNDING``; and
    the largest update of each kind of parameter at least 10 times its
    limit. Returns the differences, updates and limits."""
    err, upd, seen = (dict.fromkeys(STATE_RULES, 0.0) for _ in range(3))
    for k, w in want.items():
        if not w.numel():
            continue
        kind = "bn_stat" if _is_bn_stat(k) else "stem" if ".stem." in f".{k}" else "param"
        w = w.float()
        err[kind] = max(err[kind], (got[k].float() - w).abs().max().item())
        upd[kind] = max(upd[kind], (w - start[k].float().cpu()).abs().max().item())
        seen[kind] = 1.0
    d = {"loss": abs(loss_got - loss_want)}
    ok, parts = d["loss"] <= 1e-4, [f"|dloss|={d['loss']:.3e} (tol 1e-4)"]
    for kind, rule in STATE_RULES.items():
        lim = max(min(rule, 1e-2 * upd[kind]), ROUNDING)
        d.update({kind: err[kind], f"{kind}_update": upd[kind], f"{kind}_limit": lim})
        ok = ok and err[kind] <= lim
        parts.append(f"{kind} max|d|={err[kind]:.3e} (limit {lim:.3e}), max|update|="
                     f"{upd[kind]:.3e}")
        if kind != "bn_stat" and seen[kind] and upd[kind] < 10 * lim:
            ok = False
            parts.append(f"{kind}: the update is not 10 times the limit, so the check cannot "
                         "tell the step from no step")
    print(f"{label}: {', '.join(parts)} {'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"{label} disagrees")
    return d


def _acc_rule(label, a, b):
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    differ, mean_d = float((a != b).mean()), float(abs(a - b).mean())
    print(f"{label}: {len(a)} episodes, differing={differ:.4f}, mean|dacc|={mean_d:.5f}, "
          f"acc {a.mean():.4f} vs {b.mean():.4f}")
    if a.shape != b.shape or differ > 0.01 or mean_d > 0.005:
        _fail(f"{label}: the accuracy rule fails")
    return {"episodes_differing": differ, "mean_abs_d_acc": mean_d}


def _slice10(dev, tmp, pth, tag):
    """Phases 29-31: the mesh on the card. One NCCL rank runs the SUN step
    under ``mesh: {data: 1}`` while this process makes the one-rank runs;
    then two gloo ranks on cuda:0 run ``eval.run --mesh-data 2``,
    ``eval.run_emd --mesh-data 2``, a SUN-D step (one episode a rank), the
    2-shard scorer artifact and a SUN step (256 images a rank). Each is held
    to this process's one-rank run of the same work; launches are counted
    in each rank; the one-rank times are taken with nothing else on the
    card."""
    import torch

    from fewshot_vit_tpu_torch.eval import export as export_mod
    from fewshot_vit_tpu_torch.eval import run as eval_run
    from fewshot_vit_tpu_torch.eval import run_emd

    t_start = time.perf_counter()
    per = _mhsa_per_forward()
    eval_cfg = _write_cfg(tmp, "mesh_eval", _mesh_eval_cfg(pth))
    emd_cfg = _write_cfg(tmp, "mesh_emd", _emd_cfg(pth, 1))
    art = os.path.join(tmp, "scorer_fp32_2shard.pt2")
    t0 = time.perf_counter()
    _cli(export_mod, ["--config", eval_cfg, "--out", art, "--fold-bn", "--ep-per-batch",
                      str(EXPORT_EPB), "--data-shards", "2", "--device", str(dev)])
    export_s = time.perf_counter() - t0

    spec = {"eval_cfg": eval_cfg, "emd_cfg": emd_cfg, "pth": pth, "artifact": art,
            "serve_inputs": os.path.join(tmp, "scorer_fp32_in.pt"), "device": dev.type}
    gloo_dir, nccl_dir = os.path.join(tmp, "mesh_gloo"), os.path.join(tmp, "mesh_nccl")
    # the NCCL rank runs while this process makes the one-rank runs that are
    # compared, not timed; then this process times evaluate, a warm SUN step
    # and the unsharded scorer alone on the card
    t0 = time.perf_counter()
    proc = _launch_group(nccl_dir, 1, {**spec, "data": 1})
    one = {}
    (accs, _), secs, counts = _counted(lambda: _cli(eval_run, [
        "--config", eval_cfg, "--episodes", str(MESH_EPISODES), "--fold-bn", "--bf16",
        "--device", str(dev)]))
    one["eval_bf16"] = {"accs": accs.tolist(), "s": secs, "launches": counts}
    (accs, _), secs, counts = _counted(lambda: _cli(run_emd, [
        "--config", emd_cfg, "--shot", "1", "--episodes", str(MESH_EMD_EPISODES),
        "--ep-per-batch", str(CLI_EP_PER_BATCH), "--bf16", "--device", str(dev)]))
    one["run_emd_bf16"] = {"accs": accs.tolist(), "s": secs, "launches": counts}
    sund_start, sund_sd, sund_loss, _, _ = _mesh_sund_step(dev, None)
    sun_start, sun_sd, sun_loss, sun_s, _, sun_again, _ = _mesh_sun_step(dev, None)
    nccl, _ = _wait_group(proc, nccl_dir, 1, "the NCCL rank")
    nccl_s = time.perf_counter() - t0
    one["eval_bf16"]["episodes_per_s"] = _mesh_eval_timing(dev, pth, None)
    sun_warm_s = sun_again(False)[0]
    _, one_serve_ms, _ = _serve_calls(dev, os.path.join(tmp, "scorer_fp32.pt2"),
                                      spec["serve_inputs"], None)
    del sun_again
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks, text = _wait_group(_launch_group(gloo_dir, 2, {**spec, "data": 2}), gloo_dir, 2,
                              "the gloo group")
    gloo_s = time.perf_counter() - t0
    print("\n".join(ln for ln in text.splitlines() if "acc=" in ln))

    entry = {"phases_s": None, "export_2shard_s": export_s, "gloo_group_s": gloo_s,
             "nccl_group_s": nccl_s}
    launches = {}
    for r in ranks:
        if r["backend"] != "gloo" or r["device"] != "cuda:0":
            _fail(f"gloo rank {r['rank']}: backend {r['backend']} on {r['device']}")
        print(f"mesh {tag}: rank {r['rank']}: {r['describe']}; gloo with cuda:0 tensors: "
              f"{r['gloo_cuda_probe']}")
    routes = lambda n, route: {r: (n if r == route else 0) for r in ("general", "tensor_core")}
    n_eval = MESH_EPISODES // CLI_EP_PER_BATCH
    n_emd = MESH_EMD_EPISODES // CLI_EP_PER_BATCH
    expect = {  # per rank: the same batches as one rank, half the episodes in each
        "eval_bf16": {"fused_mhsa": routes(per * n_eval, "tensor_core"),
                      "sinkhorn_pallas": {"general": 0, "packed": 0}},
        "run_emd_bf16": {"fused_mhsa": routes(per * n_emd, "tensor_core"),
                         "sinkhorn_pallas": {"general": 0, "packed": n_emd}},
        "sund_step": {"fused_mhsa": routes(0, "general"),
                      "sinkhorn_pallas": {"general": 0, "packed": 1}},
        "sun_step": {"fused_mhsa": routes(per, "general"),
                     "sinkhorn_pallas": {"general": 0, "packed": 0}},
        "serve": {"fused_mhsa": routes(per, "general"),
                  "sinkhorn_pallas": {"general": 0, "packed": 0}},
    }
    for name, want in expect.items():
        got = [r[name]["launches"] for r in ranks]
        launches[f"mesh2_{name}"] = {f"rank{i}": c for i, c in enumerate(got)}
        if any(g != want for g in got):
            _fail(f"mesh {name}: expected {want} launches on each rank, counted {got}")
    if one["eval_bf16"]["launches"] != expect["eval_bf16"]:
        _fail(f"one-rank eval.run: {one['eval_bf16']['launches']}")
    launches["nccl1_sun_step"] = {"rank0": nccl[0]["sun_step"]["launches"]}
    if nccl[0]["sun_step"]["launches"] != expect["sun_step"]:
        _fail(f"the NCCL rank's SUN step: {nccl[0]['sun_step']['launches']}")
    if nccl[0]["backend"] != "nccl" or not nccl[0]["all_reduce_ok"]:
        _fail(f"the NCCL rank: backend {nccl[0]['backend']}, all_reduce {nccl[0]['all_reduce_ok']}")

    # every rank returns the whole result; held to the one-rank run
    for name in ("eval_bf16", "run_emd_bf16"):
        if ranks[0][name]["accs"] != ranks[1][name]["accs"]:
            _fail(f"mesh {name}: the ranks returned different accuracies")
        entry[name] = _acc_rule(f"mesh {tag}: {name} two gloo ranks vs one rank",
                                ranks[0][name]["accs"], one[name]["accs"])
        entry[name].update({"two_rank_cli_s": ranks[0][name]["s"], "one_rank_cli_s": one[name]["s"]})
    entry["eval_bf16"]["identical"] = ranks[0]["eval_bf16"]["accs"] == one["eval_bf16"]["accs"]
    entry["eval_bf16"]["episodes_per_s"] = {
        "two_gloo_ranks": [r["eval_bf16"]["episodes_per_s"] for r in ranks],
        "one_rank": one["eval_bf16"]["episodes_per_s"]}
    print(f"timing {tag}: evaluate --fold-bn bf16, {MESH_EPISODES} episodes, 8 a batch: two gloo "
          f"ranks on one card {entry['eval_bf16']['episodes_per_s']['two_gloo_ranks']} "
          f"episodes/s, one rank {one['eval_bf16']['episodes_per_s']:.1f} episodes/s (two ranks "
          f"sharing a card measure correctness, not scaling)")
    load = lambda name, d: torch.load(os.path.join(d, name), map_location="cpu")
    cpu = lambda sd: {k: v.cpu() for k, v in sd.items()}
    entry["sund_step"] = _hold_state(f"mesh {tag}: SUN-D step, two gloo ranks vs one rank",
                                     load("sund.pt", gloo_dir), cpu(sund_sd), sund_start,
                                     ranks[0]["sund_step"]["loss"], sund_loss)
    entry["sun_step"] = _hold_state(f"mesh {tag}: SUN step, two gloo ranks vs one rank",
                                    load("sun.pt", gloo_dir), cpu(sun_sd), sun_start,
                                    ranks[0]["sun_step"]["loss"], sun_loss)
    entry["sun_step_nccl"] = _hold_state(f"mesh {tag}: SUN step, one NCCL rank under mesh "
                                         f"{{data: 1}} vs no mesh", load("sun.pt", nccl_dir),
                                         cpu(sun_sd), sun_start, nccl[0]["sun_step"]["loss"],
                                         sun_loss)
    s2 = ranks[0]["sun_step"]
    entry["sun_step"].update({k: s2[k] for k in ("s", "warm_s", "clocked_s", "collectives_s",
                                                  "collectives")})
    entry["sun_step"].update({"one_rank_s": sun_s, "one_rank_warm_s": sun_warm_s})
    entry["sun_step_nccl"]["s"] = nccl[0]["sun_step"]["s"]
    print(f"timing {tag}: SUN step of 512 images, the second (warm) step: two gloo ranks "
          f"{s2['warm_s']:.3f} s, one rank with no mesh, alone on the card, {sun_warm_s:.3f} s; "
          f"a third step of the two ranks with host clocks around each of its "
          f"{s2['collectives']} collectives (synchronized): {s2['clocked_s']:.3f} s, "
          f"{s2['collectives_s']:.3f} s of it in collectives; first steps, warm-up included: "
          f"two gloo ranks {s2['s']:.3f} s, one rank {sun_s:.3f} s, one NCCL rank "
          f"{nccl[0]['sun_step']['s']:.3f} s (beside the one-rank runs)")
    got = load("serve.pt", gloo_dir)
    want = torch.cat(torch.load(os.path.join(tmp, "scorer_fp32_out.pt")))
    err = (got - want).abs().max().item()
    entry["serve"] = {"max_abs_d": err, "ms_per_call_rank0": ranks[0]["serve"]["ms_per_call"],
                      "ms_per_call_unsharded_one_rank": one_serve_ms}
    print(f"mesh {tag}: the 2-shard scorer served by two gloo ranks against the unsharded "
          f"artifact: max|d|={err:.3e} (tol 1e-4, the fp32 artifact rule); warm ms per call, "
          f"rank 0 of two sharing the card "
          f"{[round(x, 2) for x in ranks[0]['serve']['ms_per_call']]}, the unsharded artifact "
          f"served by one process alone on the card {[round(x, 2) for x in one_serve_ms]}")
    if not err <= 1e-4:
        _fail("the 2-shard scorer disagrees with the unsharded artifact")
    entry["gloo_cuda_probe"] = ranks[0]["gloo_cuda_probe"]
    entry["rank_s"] = [r["rank_s"] for r in ranks] + [nccl[0]["rank_s"]]
    entry["phases_s"] = time.perf_counter() - t_start
    print(f"slice 10 phases (29-31) {tag}: {entry['phases_s']:.1f} s (export {export_s:.1f}, "
          f"the NCCL rank beside the one-rank runs {nccl_s:.1f}, gloo group {gloo_s:.1f})")
    return entry, launches


# --- slice 11: the programs outside the package, the model axis ------------------------------
LPROBE_5SHOT_EPISODES = 32  # phase 34's 5-shot SFC evaluation (host-bound): 2 groups of 16
LPROBE_RESCORE_EPISODES = 200  # the probe's own count: the trained weights re-scored
MODEL_AXIS = {"data": 1, "model": 2}


def _bf16_rule(label, accs_tc, accs_gen, accs_plain):
    """Phase 5's bf16 rule on the same episodes: the tensor-core route
    against the general route and against plain attention may differ on the
    share of episodes where the general route and plain attention differ,
    plus 1%; mean |dacc| at most 0.005."""
    pairs = {}
    for name, a, b in (("tensor-core vs general route", accs_tc, accs_gen),
                       ("tensor-core route vs plain path", accs_tc, accs_plain),
                       ("general route vs plain path", accs_gen, accs_plain)):
        pairs[name] = {"episodes_differing": float((a != b).mean()),
                       "mean_abs_d_acc": float(abs(a - b).mean())}
        print(f"{label} bf16 {name}: {len(a)} episodes, differing="
              f"{pairs[name]['episodes_differing']:.4f}, mean|dacc|="
              f"{pairs[name]['mean_abs_d_acc']:.5f}, acc {a.mean():.4f} vs {b.mean():.4f}")
    allowed = pairs["general route vs plain path"]["episodes_differing"] + 0.01
    for name in ("tensor-core vs general route", "tensor-core route vs plain path"):
        if pairs[name]["episodes_differing"] > allowed or pairs[name]["mean_abs_d_acc"] > 0.005:
            _fail(f"{label} bf16 {name}: {pairs[name]} (allowed share {allowed:.4f}, "
                  f"mean|dacc| 0.005)")
    return pairs


def _bench_phase(dev, tag):
    """Phase 32: the bench entry's protocol in this process (``bench.run``,
    whose result dict ``bench.measure`` returns), the headline and
    ``--int8``, one JSON line each; the MHSA launches counted (2 per
    128-episode batch over the warm and the timed pass, tensor-core route;
    ``--int8`` adds its calibration forward); then the timed pass's
    episodes with the general route forced and with plain attention, held by
    the bf16 rule."""
    from fewshot_vit_tpu_torch import bench
    from fewshot_vit_tpu_torch.kernels import attention as mhsa_mod

    per = _mhsa_per_forward()
    n_batches = 2 * math.ceil(bench.N_EPISODES / bench.EP_PER_BATCH)  # warm + timed
    out, launches, accs_tc = {}, {}, None
    for int8 in (False, True):
        (result, accs), secs, counts = _counted(lambda: bench.run(int8=int8, device=dev))
        print(json.dumps(result))
        print(f"bench {tag}: {result['metric']} = {result['value']} {result['unit']}, "
              f"vs_baseline {result['vs_baseline']} ({secs:.1f} s with the split, the fold"
              f"{' and the calibration' if int8 else ''} and the warm pass); acc "
              f"{accs.mean():.4f}")
        label = "bench_int8" if int8 else "bench"
        launches[label] = _check_launches(label, counts, "tensor_core",
                                          per * n_batches + (per if int8 else 0))
        out[label] = {**result, "s": secs, "acc": float(accs.mean())}
        if not int8:
            accs_tc = accs
    ds = bench.bench_split()
    with mhsa_mod.force_route("general"):
        general, accs_gen = bench.run(device=dev, dataset=ds)
    plain, accs_plain = bench.run(device=dev, dataset=ds,
                                  make_head=lambda: bench.bench_head(use_pallas_attn=False))
    out["general_route_value"], out["plain_value"] = general["value"], plain["value"]
    print(f"timing {tag}: the bench's protocol, episodes/s: tensor-core route "
          f"{out['bench']['value']}, general route forced {general['value']}, plain attention "
          f"{plain['value']}, int8 {out['bench_int8']['value']}")
    out["bf16_rule"] = _bf16_rule(f"bench {tag}: the timed pass", accs_tc, accs_gen, accs_plain)
    return out, launches


def _precision_phase(dev, tag):
    """Phase 33: ``tools.precision_check`` at JAX's settings (512 episodes,
    fp32 64 a batch, bf16 128), gated as ``TestPrecisionParity``:
    acc_fp32 > 0.3 and abs_diff <= 0.005; the launches per route (fp32
    takes the MHSA kernel's general route, bf16 its tensor-core route)."""
    from fewshot_vit_tpu_torch.tools import precision_check

    res, secs, counts = _counted(lambda: precision_check.run(device=dev))
    print(json.dumps(res))
    per, n = _mhsa_per_forward(), res["n_episodes"]
    want = {"fused_mhsa": {"general": per * math.ceil(n / 64),
                           "tensor_core": per * math.ceil(n / 128)},
            "sinkhorn_pallas": {"general": 0, "packed": 0}}
    print(f"precision {tag}: {secs:.1f} s, launches by route {counts}")
    _check_counts("precision_check", counts, want)
    if not (res["acc_fp32"] > 0.3 and res["abs_diff"] <= 0.005):
        _fail(f"precision_check: acc_fp32 > 0.3 and abs_diff <= 0.005 do not hold: {res}")
    return {**res, "s": secs}, {"precision_check": counts}


LEARNING_GATES = (  # tests/test_cli_integration.py::TestLearningQuality, unchanged
    ("p0 < 0.45", lambda d: d["p0"] < 0.45),
    ("p1 > 0.70", lambda d: d["p1"] > 0.70),
    ("p2 >= p1 - 0.045", lambda d: d["p2"] >= d["p1"] - 0.045),
    ("p2 > 0.80", lambda d: d["p2"] > 0.80),
    ("p3 > 0.75", lambda d: d["p3"] > 0.75),
    ("p3 > p0 + 0.35", lambda d: d["p3"] > d["p0"] + 0.35),
    ("p4_1shot >= p2 - 0.03", lambda d: d["p4_1shot"] >= d["p2"] - 0.03),
    ("p4_5shot > p4_1shot + 0.03", lambda d: d["p4_5shot"] > d["p4_1shot"] + 0.03),
)


def _learning_phase(dev, tmp, tag):
    """Phase 34: ``tools.learning_probe.run`` at JAX's depth (12/8/3/2
    epochs, 200 episodes, seed 12345; the 5-shot SFC evaluation cut to
    ``LPROBE_5SHOT_EPISODES``), gated by ``TestLearningQuality``'s asserts;
    no kernel launched (einsum attention, ``sinkhorn_detached``, as in
    JAX). Then the trained weights re-scored with each kernel against its
    plain path, fp32, TF32 off, by the accuracy rule: p3's ``max-va`` with
    ``use_pallas_attn: true`` against the einsum path, p4's ``max-va``
    1-shot with ``solver: sinkhorn_pallas`` against ``sinkhorn_detached``.
    The plain re-scores must give the probe's own p3 and p4_1shot."""
    from fewshot_vit_tpu_torch.checkpoint.io import load_model
    from fewshot_vit_tpu_torch.data.staging import upload_images
    from fewshot_vit_tpu_torch.tools import learning_probe as lp

    save_root = os.path.join(tmp, "lprobe")
    res, secs, counts = _counted(lambda: lp.run(
        save_root, n_episodes_5shot=LPROBE_5SHOT_EPISODES, device=dev))
    print(json.dumps(res))
    print(f"learning probe {tag}: {secs:.1f} s (5-shot SFC over {LPROBE_5SHOT_EPISODES} of the "
          f"{LPROBE_RESCORE_EPISODES} episodes)")
    launches = {"learning_probe": _check_launches("learning_probe", counts, "general", 0)}
    failed = [name for name, gate in LEARNING_GATES if not gate(res)]
    if failed:
        _fail(f"learning probe: {failed} do not hold: {res}")
    out = {**res, "s": secs, "p4_5shot_episodes": LPROBE_5SHOT_EPISODES}

    test_ds = lp.novel_split()
    images = upload_images(test_ds.images, dev)
    n = LPROBE_RESCORE_EPISODES
    p3, p4 = (os.path.join(save_root, run, "max-va") for run in ("lp_p3", "lp_p4"))
    for name, score, kernel_kw, plain_mean, route, n_mhsa, n_sk in (
            ("p3_kernel", lambda h: lp.meta_baseline_accs(h, test_ds, n, images),
             {"encoder_args": {"use_pallas_attn": True}}, res["p3"], "general",
             _mhsa_per_forward() * math.ceil(n / 8), 0),
            ("p4_kernel", lambda h: lp.emd_accs(h, test_ds, 1, n, images),
             {"solver": "sinkhorn_pallas"}, res["p4_1shot"], "general", 0,
             math.ceil(n / lp.EMD_GROUP))):
        ckpt = p3 if name == "p3_kernel" else p4
        plain = score(load_model(ckpt, device=dev))
        kernel, _, counts = _counted(lambda: score(load_model(ckpt, device=dev, **kernel_kw)))
        launches[f"learning_{name}"] = _check_launches(name, counts, route, n_mhsa, n_sk)
        out[name] = _acc_rule(f"learning {tag}: {name[:2]}'s max-va with {kernel_kw} vs the "
                              f"plain path (fp32, TF32 off)", kernel, plain)
        out[name]["reproduced"] = round(float(plain.mean()), 4) == plain_mean
        if not out[name]["reproduced"]:
            _fail(f"{name}: the plain re-score {plain.mean():.4f} is not the probe's "
                  f"{plain_mean}")
    return out, launches


def _start_dryrun(tmp):
    """Phase 35's ``python -m fewshot_vit_tpu_torch.graft_entry --n 2``
    (``dryrun_multichip(2)``: two ranks sharing cuda:0 over gloo), started
    in a session of its own, its output in a file: (process, log path)."""
    log = os.path.join(tmp, "dryrun.txt")
    root = os.path.dirname(os.path.abspath(__file__))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fewshot_vit_tpu_torch.graft_entry", "--n", "2"],
            stdout=f, stderr=subprocess.STDOUT, cwd=root, start_new_session=True,
            env=dict(os.environ, PYTHONPATH=root))
    return proc, log


def _graft_entry_phase(dev, tag, dryrun):
    """Phase 35: ``graft_entry.entry()``'s forward on the card, and the
    dryrun ``_start_dryrun`` started: exit 0 and five ok lines."""
    import torch

    from fewshot_vit_tpu_torch import graft_entry

    fn, (module, x_shot, x_query) = graft_entry.entry()
    logits, secs, counts = _counted(lambda: fn(module, x_shot, x_query))
    if tuple(logits.shape) != (1, 75, 5) or not torch.isfinite(logits).all():
        _fail(f"graft_entry.entry: logits {tuple(logits.shape)}, finite "
              f"{bool(torch.isfinite(logits).all())}")
    # the flagship head leaves use_pallas_attn at its default (off), as JAX's entry does
    launches = {"graft_entry": _check_launches("graft_entry.entry", counts, "general", 0)}
    proc, log = dryrun
    try:
        rc = proc.wait(timeout=MESH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _fail(f"dryrun_multichip(2) outlived {MESH_TIMEOUT_S} s")
    with open(log) as f:
        text = f.read()
    ok = [ln for ln in text.splitlines() if ln.startswith("dryrun_multichip ok")]
    print("\n".join(ok))
    print(f"graft entry {tag}: entry forward {secs * 1e3:.1f} ms (first call); "
          f"dryrun_multichip(2) on {dev} exit {rc}, beside phases 33-34")
    if rc != 0 or len(ok) != 5:
        _fail(f"dryrun_multichip(2) exited {rc} with {len(ok)} ok lines:\n{text[-3000:]}")
    return {"entry_ms": secs * 1e3, "ok_lines": ok}, launches


def _mesh_pretrain_step(dev, mesh):
    """One pretrain step (``train.loop.make_pretrain_epoch``) of batch 512,
    cropaug, drop-path 0.5, SGD, seeded weights, fp32: (state dict before,
    after (the full layout), loss, seconds, launches, the column-parallel
    layers under a ``model`` axis)."""
    import torch

    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.core.registry import datasets, models
    from fewshot_vit_tpu_torch.data.augment import make_cropaug_fn
    from fewshot_vit_tpu_torch.heads import classifier as _classifier  # noqa: F401
    from fewshot_vit_tpu_torch.parallel import mesh as pmesh
    from fewshot_vit_tpu_torch.train.loop import make_pretrain_epoch
    from fewshot_vit_tpu_torch.train.runner import build_optimizer
    from fewshot_vit_tpu_torch.train.state import TrainState

    mini = datasets.make("synthetic", **MESH_SUN_DATA)
    model = models.make("classifier", encoder=ENCODER,
                        encoder_args={"drop_path_rate": 0.5, "use_pallas_attn": True},
                        classifier_args={"n_classes": mini.n_classes}, device=dev, seed=0)
    start = _state_copy(model)
    sliced = pmesh.param_shardings(mesh, model) if mesh is not None else []
    state = TrainState(model, build_optimizer(Config(MESH_SUN_OPT), model.parameters()))
    epoch = make_pretrain_epoch(make_cropaug_fn(mini.mean, mini.std, out_size=80), mini.mean,
                                mini.std)
    images = torch.from_numpy(mini.images).to(dev)
    labels = torch.from_numpy(mini.labels.astype("int64")).to(dev)
    idx = _steps_idx(len(mini), 1, 1, dev)
    with pmesh.use_mesh(mesh):
        m, secs, counts = _counted(lambda: epoch(state, images, labels, idx, (0, 1)))
    after = {k: v.detach().clone() for k, v in state.variables.items()}
    return start, after, float(m["loss"][0]), secs, counts, sliced


def _model_axis_rank(job_dir, mesh, out, save, t_start) -> int:
    """A rank of phase 36's group (``mesh: {data: 1, model: 2}``): the SUN
    step and the pretrain step of 512 images with column-parallel wide
    layers; rank 0 saves the full-layout state after each."""
    import torch.distributed as dist

    for name, step in (("sun_step", lambda: _mesh_sun_step(mesh.device, mesh)),
                       ("pretrain_step", lambda: _mesh_pretrain_step(mesh.device, mesh))):
        res = step()
        _, sd, loss, secs, counts = res[:5]
        save(sd, f"{name}.pt")
        out[name] = {"loss": loss, "s": secs, "launches": counts, "sliced": len(res[-1]),
                     "qkv_sliced": "encoder.stage2.0.attn.qkv" in res[-1]}
        del res, sd
    out["rank_s"] = time.perf_counter() - t_start
    with open(os.path.join(job_dir, f"rank{out['rank']}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _model_axis(dev, tag, group):
    """Phase 36 (ROADMAP item j): two gloo ranks sharing cuda:0 under
    ``mesh: {data: 1, model: 2}`` (``group``: the launched process and its
    directory), each running the SUN step and the pretrain step of 512
    images at full width (fp32, SGD), the wide layers column-parallel
    (stage 2's ``qkv`` among them); each held to one rank's step by
    ``_hold_state``'s rule, bound to its update; the MHSA launches counted
    per rank (the SUN teacher's 2 a step, general route; none in the
    pretrain step)."""
    import torch

    sun_start, sun_sd, sun_loss, sun_s, _, again, _ = _mesh_sun_step(dev, None)
    del again
    pre_start, pre_sd, pre_loss, pre_s, pre_counts, _ = _mesh_pretrain_step(dev, None)
    torch.cuda.empty_cache()
    proc, job = group
    ranks, _ = _wait_group(proc, job, 2, "the model-axis group")
    per = _mhsa_per_forward()
    launches = {"model1_pretrain_step": _check_launches("one-rank pretrain step", pre_counts,
                                                        "general", 0)}
    for r in ranks:
        if r["backend"] != "gloo" or r["device"] != str(dev):
            _fail(f"model-axis rank {r['rank']}: backend {r['backend']} on {r['device']}")
        if not (r["sun_step"]["qkv_sliced"] and r["pretrain_step"]["qkv_sliced"]):
            _fail(f"model-axis rank {r['rank']}: stage 2's qkv is not column-parallel")
        print(f"model axis {tag}: rank {r['rank']}: {r['describe']}; column-parallel layers: "
              f"SUN {r['sun_step']['sliced']}, pretrain {r['pretrain_step']['sliced']}")
    for name, n in (("sun_step", per), ("pretrain_step", 0)):
        got = [r[name]["launches"] for r in ranks]
        launches[f"model2_{name}"] = {f"rank{i}": c for i, c in enumerate(got)}
        for i, c in enumerate(got):
            _check_launches(f"model axis {name}, rank {i}", c, "general", n)
    load = lambda name: torch.load(os.path.join(job, name), map_location="cpu")
    cpu = lambda sd: {k: v.cpu() for k, v in sd.items()}
    entry = {}
    for name, sd, start, loss, one_s in (("sun_step", sun_sd, sun_start, sun_loss, sun_s),
                                         ("pretrain_step", pre_sd, pre_start, pre_loss, pre_s)):
        entry[name] = _hold_state(
            f"model axis {tag}: {name}, two gloo ranks under {MODEL_AXIS} vs one rank",
            load(f"{name}.pt"), cpu(sd), start, ranks[0][name]["loss"], loss)
        entry[name].update({"s_ranks": [r[name]["s"] for r in ranks], "one_rank_s": one_s,
                            "sliced": ranks[0][name]["sliced"]})
    print(f"model axis {tag}: first steps, warm-up included: SUN two ranks "
          f"{entry['sun_step']['s_ranks']} s, one rank {sun_s:.3f} s; pretrain two ranks "
          f"{entry['pretrain_step']['s_ranks']} s, one rank {pre_s:.3f} s (the ranks ran beside "
          f"phases 33-34: they measure correctness, not speed)")
    return entry, launches


def _stop(procs):
    """Kill every process of each session in ``procs`` that is still running."""
    import signal

    for p in procs:
        if p.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def _slice11(dev, tmp, tag):
    """Phases 32-36: the bench entry, the two gates, the graft entry points and
    the model axis. The rank processes of phases 35-36 start once the timed
    bench is done and run beside phases 33-34. Returns (the slice11 JSON
    entry, launches by path)."""
    import torch

    t_start, entry, launches = time.perf_counter(), {}, {}

    def phase(name, fn):
        t0 = time.perf_counter()
        entry[name], counts = fn()
        entry[name]["phase_s"] = time.perf_counter() - t0
        launches.update(counts)
        torch.cuda.empty_cache()

    phase("bench", lambda: _bench_phase(dev, tag))
    job = os.path.join(tmp, "mesh_model")
    group = (_launch_group(job, 2, {**MODEL_AXIS, "device": dev.type}), job)
    dryrun = _start_dryrun(tmp)
    try:
        phase("precision", lambda: _precision_phase(dev, tag))
        phase("learning", lambda: _learning_phase(dev, tmp, tag))
        phase("graft_entry", lambda: _graft_entry_phase(dev, tag, dryrun))
        phase("model_axis", lambda: _model_axis(dev, tag, group))
    finally:
        _stop([group[0], dryrun[0]])
    entry["phases_s"] = time.perf_counter() - t_start
    print(f"slice 11 phases (32-36) {tag}: {entry['phases_s']:.1f} s ("
          + ", ".join(f"{k} {v['phase_s']:.1f}" for k, v in entry.items()
                      if isinstance(v, dict)) + ")")
    return entry, launches


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", default=None, help="write a profiler table here")
    p.add_argument("--mesh-rank", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.mesh_rank:  # one rank of a slice-10 group
        return _mesh_rank(args.mesh_rank)

    # phase 1
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fewshot_vit_tpu_torch.core.registry import datasets, models
    from fewshot_vit_tpu_torch.data import datasets as _datasets  # noqa: F401
    from fewshot_vit_tpu_torch.eval.episodic import evaluate, sample_episode_indices
    from fewshot_vit_tpu_torch.heads import meta_baseline as _heads  # noqa: F401
    from fewshot_vit_tpu_torch.kernels import build
    from fewshot_vit_tpu_torch.kernels import attention as mhsa_mod
    from fewshot_vit_tpu_torch.kernels.attention import (
        attention_core,
        fused_mhsa,
        fused_mhsa_reference,
    )
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas
    from fewshot_vit_tpu_torch.models.fold import fold_encoder_in_head

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())

    # phase 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    tag = f"[{card}]"
    t_lap = [time.perf_counter()]

    def lap(phases):  # wall seconds of a block of phases, for cutting depth to the budget
        now = time.perf_counter()
        print(f"phases {phases} {tag}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    # phase 3
    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {sorted(logs) or 'up to date'} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in build.ptxas_summary(log):
            print(f"  ptxas {name}: {line}")

    # phase 4: kernel vs plain version
    b_main = EP_PER_BATCH * WAY * (SHOT + QUERY)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = _check_mhsa(gen, dev, b_main)
    sinkhorn_errs = _check_sinkhorn(gen, dev)

    # phase 5: SUN-M
    t0 = time.perf_counter()
    ds = datasets.make("synthetic", n_classes=20, n_per_class=600, image_size=80, seed=0)
    images_dev = torch.from_numpy(ds.images).to(dev)
    print(f"dataset: synthetic {ds.images.shape} uint8 on the card "
          f"({time.perf_counter() - t0:.1f} s)")

    def head_for(dtype, fused):
        head = models.make("meta-baseline", encoder="visformer_micro_80",
                           encoder_args={"use_pallas_attn": fused}, dtype=dtype,
                           device=dev, seed=0)
        return fold_encoder_in_head(head)

    def run(head, n, seed=None, indices=None):
        return evaluate(head, ds, n_episodes=n, way=WAY, shot=SHOT, query=QUERY,
                        ep_per_batch=EP_PER_BATCH, seed=seed, images_dev=images_dev,
                        indices=indices, device=dev)

    main_head = head_for(torch.bfloat16, True)
    n_batches = math.ceil(N_EPISODES / EP_PER_BATCH)
    _zero_counts(fused_mhsa, sinkhorn_pallas)
    acc, ci, accs = run(main_head, N_EPISODES, seed=1)
    torch.cuda.synchronize()
    launches, routes = fused_mhsa.launches, dict(fused_mhsa.route_launches)
    if sinkhorn_pallas.launches:
        _fail("the SUN-M path launched the Sinkhorn kernel")
    print(f"main path bf16: {N_EPISODES} episodes, acc={acc * 100:.2f} +- {ci * 100:.2f} %, "
          f"fused_mhsa launches={launches} ({n_batches} batches), by route {routes}")
    if launches != 2 * n_batches:
        _fail(f"expected {2 * n_batches} fused_mhsa launches, counted {launches}")
    if routes != {"general": 0, "tensor_core": launches}:
        _fail(f"the main path's fused_mhsa launches left the tensor-core route: {routes}")
    if accs.shape != (N_EPISODES,) or not ((accs >= 0) & (accs <= 1)).all():
        _fail(f"episode accuracies malformed: shape {accs.shape}")

    idx = sample_episode_indices(ds, N_EPISODES, WAY, SHOT + QUERY, EP_PER_BATCH, 1)
    _, _, accs_k = run(head_for(torch.float32, True), N_EPISODES, indices=idx)
    _, _, accs_p = run(head_for(torch.float32, False), N_EPISODES, indices=idx)
    differ = float((accs_k != accs_p).mean())
    mean_d = float(abs(accs_k - accs_p).mean())
    print(f"fp32 (TF32 off) kernel path vs plain path: episodes differing={differ:.4f}, "
          f"mean|dacc|={mean_d:.5f}, acc {accs_k.mean():.4f} vs {accs_p.mean():.4f}; "
          f"bf16 main path acc {accs.mean():.4f}")
    if differ > 0.01 or mean_d > 0.005:
        _fail("fp32 kernel path and plain path disagree")

    # bf16, same episodes, three paths: tensor-core route, general route,
    # plain attention. In bf16 any two of them round differently, and a
    # borderline query flips in a few percent of the episodes whichever pair
    # is taken (the general route against the plain path too), so the share
    # of differing episodes is held to what that older pair shows plus 1%,
    # and the mean accuracy difference to the fp32 check's 0.005.
    plain_head = head_for(torch.bfloat16, False)
    _, _, accs_k = run(main_head, N_EPISODES, indices=idx)
    with mhsa_mod.force_route("general"):
        _, _, accs_o = run(main_head, N_EPISODES, indices=idx)
    _, _, accs_p = run(plain_head, N_EPISODES, indices=idx)
    _bf16_rule("main path", accs_k, accs_o, accs_p)

    # phase 7, SUN-M: timings, in turns; "old" forces the general route
    eps = {"fused": [], "old": [], "plain": []}
    for which in ("fused", "old", "plain", "plain", "old", "fused"):
        head = plain_head if which == "plain" else main_head
        with mhsa_mod.force_route("general" if which == "old" else None):
            run(head, EP_PER_BATCH, seed=3)  # warm this head's shapes
            t0 = time.perf_counter()
            run(head, N_TIMED, seed=2)
            eps[which].append(N_TIMED / (time.perf_counter() - t0))
    print(f"timing {tag}: main path bf16 episodes/s, fused-kernel attention: "
          f"{eps['fused']}; plain attention: {eps['plain']}; fused-kernel attention with the "
          f"general route forced: {eps['old']} "
          f"({N_TIMED} episodes at ep_per_batch {EP_PER_BATCH})")

    kernels, sun_teacher = [], {}
    h, t, hd = 6, 100, 42
    for shape, b, dtype in (("stage2", b_main, torch.bfloat16), ("stage2", b_main, torch.float32),
                            ("sun teacher", PRE_TRAIN["batch_size"], torch.float32),
                            ("sun teacher", PRE_TRAIN["batch_size"], torch.bfloat16)):
        qkv = torch.randn(b, t, 3, h, hd, generator=gen, device=dev).to(dtype)
        q, k, v = qkv.unbind(2)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        scale = hd ** -0.5
        route = mhsa_mod.mhsa_route(qt)
        times = {"old": [], "new": [], "sdpa": []}
        for which in ("old", "new", "sdpa", "sdpa", "new", "old"):
            if which == "sdpa":
                times[which].append(_time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, scale=scale)))
            else:
                with mhsa_mod.force_route("general" if which == "old" else None):
                    times[which].append(_time_ms(lambda: attention_core(q, k, v, scale)))
        ms, prev_ms, lib_ms = (sum(times[w]) / 2 for w in ("new", "old", "sdpa"))
        plain_ms = _time_ms(lambda: fused_mhsa_reference(qt, kt, vt, scale))
        bound_ms, bound_by = _bound(b, h, t, hd, dtype)
        print(f"timing {tag}: fused_mhsa {shape} ({b},{h},{t},{hd}) {dtype}: kernel {ms:.4f} ms "
              f"({route} route; {times['new']}), general route {prev_ms:.4f} ms ({times['old']}), "
              f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms ({times['sdpa']}), "
              f"bound {bound_ms:.4f} ms ({bound_by}); kernel/bound {ms / bound_ms:.2f}")
        if shape == "sun teacher":  # the SUN teacher's and pretrain validation's shape
            sun_teacher[str(dtype).split(".")[1]] = {
                "kernel_route": route, "max_abs_err": errs[(shape, str(dtype))], "ms": ms,
                "general_route_ms": prev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms}
        elif dtype == torch.bfloat16:  # the main path's dtype
            if not (ms < lib_ms and ms < prev_ms):
                _fail(f"the tensor-core fused_mhsa ({ms:.3f} ms) is not faster than sdpa "
                      f"({lib_ms:.3f} ms) and the general route ({prev_ms:.3f} ms)")
            kernels.append({
                "name": "fused_mhsa", "route": "cuda",
                "source": "fewshot_vit_tpu_torch/csrc/mhsa.cu",
                "replaces": "fewshot_vit_tpu/kernels/attention.py:54",
                "launches": launches, "kernel_route": route, "route_launches": routes,
                "max_abs_err": errs[("stage2", str(dtype))],
                "ms": ms, "prev_ms": prev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
            })
        del qkv, q, k, v, qt, kt, vt
    kernels[0]["sun_teacher"] = {"shape": [PRE_TRAIN["batch_size"] * h, t, hd], **sun_teacher}

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(main_head, EP_PER_BATCH, seed=4)
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=60)
        with open(os.path.join(args.profile, "profile_main_path.txt"), "w") as f:
            f.write(f"{card}\n{table}\n")
        print("\n".join(table.splitlines()[:25]))
    del main_head, plain_head, head
    torch.cuda.empty_cache()
    lap("1-5 and 7 (SUN-M)")

    sinkhorn = _run_sund(dev, ds, images_dev, tag, gen, args.profile, card)
    kernels.append({**sinkhorn, "max_abs_err": sinkhorn_errs["grid"],
                    "max_abs_err_train_shape": sinkhorn_errs["train episode"]})
    torch.cuda.empty_cache()
    lap("6-7 (SUN-D)")

    # phases 8-10: the two trainers
    val_ds = datasets.make("synthetic", n_classes=20, n_per_class=40, image_size=80, seed=3)
    training, train_launches = _train_sund(dev, ds, images_dev, val_ds, tag, args.profile, card)
    torch.cuda.empty_cache()
    sunm, sunm_launches = _train_sunm(dev, ds, images_dev, val_ds, tag, args.profile, card)
    training.update(sunm)
    train_launches.update(sunm_launches)
    torch.cuda.empty_cache()
    _run_clis(tag)
    lap("8-10 (meta-tuning, the CLIs)")

    # phases 11-13: pretraining and SUN on a split at miniImageNet train geometry
    import tempfile

    import numpy as np

    t0 = time.perf_counter()
    mini = datasets.make("synthetic", **MINI_TRAIN)
    mini_dev = torch.from_numpy(mini.images).to(dev)
    mini_labels = torch.from_numpy(mini.labels.astype(np.int64)).to(dev)
    print(f"dataset: synthetic {mini.images.shape} uint8 ({mini.images.nbytes / 2 ** 20:.0f} MiB) "
          f"on the card, kept at 84x84 as protocol raw keeps it ({time.perf_counter() - t0:.1f} s)")
    pre_val = datasets.make("synthetic", n_classes=64, n_per_class=20, image_size=80, seed=6)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "pretrain")
        pre, pre_counts = _train_pretrain(dev, mini, mini_dev, mini_labels, pre_val, ds,
                                          images_dev, tag, args.profile, card, ckpt)
        sun, sun_counts = _train_sun(dev, mini, mini_dev, mini_labels, tag, args.profile, card,
                                     ckpt)
        lap("11-13 (pretrain, SUN)")
        # phases 17-18: the encoder zoo on the same resident split
        zoo, zoo_launches, zoo_ckpts = _zoo_pretrain(dev, mini, mini_dev, mini_labels, tag,
                                                     args.profile, card, tmp)
        del mini_dev, mini_labels
        torch.cuda.empty_cache()
        zoo_eval, counts = _zoo_eval(dev, ds, images_dev, zoo_ckpts, tag, tmp)
        zoo_launches.update(counts)
        # phase 23's zoo half: --real-attn over the NesT and Swin checkpoints
        slice8, slice8_launches = {"visualize": {}}, {}
        t8 = time.perf_counter()
        for name in ("nest_micro_v2_gpsa", "swin_micro_resembed_80"):
            slice8["visualize"][name], counts = _visualize(
                dev, tmp, tag, name, {"encoder": name, "load_encoder": zoo_ckpts[name]},
                (True,), 0)
            slice8_launches.update(counts)
        slice8_s = time.perf_counter() - t8
        # phases 19-20: the ResNet-18 meta-tune from a .pth, every other encoder
        meta, counts = _zoo_meta_tune(dev, ds, images_dev, tag, tmp)
        zoo.update(meta)
        zoo_launches.update(counts)
        zoo["zoo_forward"], counts = _zoo_forward(dev, tag, tmp)
        zoo_launches.update(counts)
        lap("17-20 (the zoo)")
    training.update(pre)
    training.update(sun)
    training.update(zoo)
    train_launches.update(pre_counts)
    train_launches.update(sun_counts)
    eval_launches = _run_cli_chain(tag, dev)

    # phases 14-16: the eval CLIs from a reference .pth, --sauc, the loaders
    with tempfile.TemporaryDirectory() as tmp:
        clis, counts, pth = _eval_from_pth(dev, tmp, tag)
        eval_launches.update(counts)
        clis["loaders"], counts = _loaders(dev, tmp, pth, tag)
        eval_launches.update(counts)
        lap("14-16 (the CLI chain, the eval CLIs, the loaders)")
        # phases 21-23: solver exact, the research heads, the visualization paths
        t8 = time.perf_counter()
        slice8["exact"], counts = _exact_emd(dev, ds, images_dev, tag, tmp)
        slice8_launches.update(counts)
        slice8["research_heads"], counts = _research_heads(dev, ds, images_dev, tag)
        slice8_launches.update(counts)
        slice8["visualize"][ENCODER], counts = _visualize(
            dev, tmp, tag, ENCODER, {"encoder": ENCODER, "load": pth, "model_args": {
                "encoder_args": {"use_pallas_attn": True}}}, (False, True), _mhsa_per_forward())
        slice8_launches.update(counts)
        slice8["visualize"]["pretrain_cli"], counts = _visualize_pretrain_cli(tmp, tag)
        slice8_launches.update(counts)
        slice8["phases_s"] = slice8_s + time.perf_counter() - t8
        print(f"slice 8 phases (21-23) {tag}: {slice8['phases_s']:.1f} s")
        # phases 24-28: int8, the exported artifacts, --profile-dir, the ops re-timed
        t9 = time.perf_counter()
        slice9, slice9_launches = {"int8_products": _int8_products(dev, tag)}, {}
        slice9["int8_cli"], counts = _int8_cli(dev, tmp, pth, tag)
        slice9_launches.update(counts)
        slice9["export"], counts = _export_artifacts(dev, tmp, pth, tag)
        slice9_launches.update(counts)
        slice9["profile_dir"], counts = _profile_dir_phase(tmp, tag)
        slice9_launches.update(counts)
        slice9["ops_retimed"] = _retime_ops(dev, tag)
        slice9["phases_s"] = time.perf_counter() - t9
        print(f"slice 9 phases (24-28) {tag}: {slice9['phases_s']:.1f} s")
        # phases 29-31: the mesh
        slice10, slice10_launches = _slice10(dev, tmp, pth, tag)
        # phases 32-36: the bench entry, the two gates, the graft entry points, the model axis
        slice11, slice11_launches = _slice11(dev, tmp, tag)
    for entry in kernels:
        entry["train_launches"] = {
            path: (c[entry["name"]] if isinstance(c[entry["name"]], int)
                   else sum(c[entry["name"]].values()))
            for path, c in train_launches.items()}
        entry["eval_cli_launches"] = {path: sum(c[entry["name"]].values())
                                      for path, c in eval_launches.items()}
        # the encoder zoo reaches no kernel, in either package
        entry["zoo_launches"] = {path: sum(c[entry["name"]].values())
                                 for path, c in zoo_launches.items()}
        entry["slice8_launches"] = {path: sum(c[entry["name"]].values())
                                    for path, c in slice8_launches.items()}
        entry["slice9_launches"] = {path: sum(c[entry["name"]].values())
                                    for path, c in slice9_launches.items()}
        # per rank: the mesh paths launch both kernels on every rank
        entry["slice10_launches"] = {path: {r: sum(c[entry["name"]].values())
                                            for r, c in per_rank.items()}
                                     for path, per_rank in slice10_launches.items()}
        # phase 36's paths per rank, the others in this process
        entry["slice11_launches"] = {
            path: ({r: sum(rc[entry["name"]].values()) for r, rc in c.items()}
                   if path.startswith("model2_") else sum(c[entry["name"]].values()))
            for path, c in slice11_launches.items()}
    clis["zoo"] = zoo_eval
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"training": training, "card": card}))
    print(json.dumps({"eval_clis": clis, "card": card}))
    print(json.dumps({"slice8": slice8, "card": card}))
    print(json.dumps({"slice9": slice9, "card": card}))
    print(json.dumps({"slice10": slice10, "card": card}))
    print(json.dumps({"slice11": slice11, "card": card}))

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
