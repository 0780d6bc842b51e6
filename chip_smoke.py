#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fewshot_vit_tpu_torch``) on one GPU.

Phases, in order; any failure exits non-zero:
  1. require CUDA;
  2. print the card's name and power limit (nvidia-smi);
  3. build every CUDA kernel of the port from ``csrc/`` (one nvcc per source,
     all started together) and load it;
  4. hold each kernel against its plain PyTorch version on the card, every
     output pre-filled with NaN and every route asserted: fused MHSA in fp32
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
     fcn (N = 25); one batch of 5-shot grid with SFC;
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
 13. the pretrain -> SUN -> meta-tune CLI chain on a small synthetic config;
 14. print the ``training`` and the kernels' JSON lines, then the result line.

Run from the root of a checkout:  python3 chip_smoke.py [--profile DIR]
(``--profile DIR`` also writes torch.profiler tables of one SUN-M and one
SUN-D grid episode batch, and of one training step of each trainer.)
"""

from __future__ import annotations

import argparse
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
SFC_KW = {"steps": 100, "lr": 100.0, "batch_size": 4}  # the SUN-D eval CLI's defaults
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


def _check_mhsa(gen, dev, b_main):
    """Phase 4, fused MHSA: kernel vs plain version, every case through heads
    split out of a packed qkv tensor and an output written through a
    (B, T, H, hd) view, as attention_core hands them over; the output starts
    as NaN so an unwritten element cannot pass. Returns max|d| per case."""
    import torch

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
            got = fused_mhsa(q, k, v, hd ** -0.5, out=out.transpose(1, 2))
            want = fused_mhsa_reference(q, k, v, hd ** -0.5)
            torch.cuda.synchronize()
            if fused_mhsa.route_launches[route] != before[route] + 1:
                _fail(f"fused_mhsa {name} {dtype}: expected one launch on the {route} route, "
                      f"counts went {before} -> {fused_mhsa.route_launches}")
            err = (got.float() - want.float()).abs().max().nan_to_num(float("inf")).item()
            errs[(name, str(dtype))] = err
            ok = err <= TOL[str(dtype)]
            print(f"kernel vs plain {name} ({b},{h},{t},{hd}) {dtype}: "
                  f"max|d|={err:.3e} tol={TOL[str(dtype)]:g} {'ok' if ok else 'FAIL'}; "
                  f"{route} route")
            if not ok:
                _fail(f"fused_mhsa disagrees with its plain version at {name} {dtype}")
            if route == "tensor_core":  # the general route on the same inputs
                out.fill_(float("nan"))
                got = fused_mhsa(q, k, v, hd ** -0.5, out=out.transpose(1, 2), route="general")
                err = (got.float() - want.float()).abs().max().nan_to_num(float("inf")).item()
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
    got = fused_mhsa(q, k, v, hd ** -0.5, out=out.transpose(1, 2)[:, ::2])
    want = fused_mhsa_reference(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().nan_to_num(float("inf")).item()
    untouched = bool(out[:, :, 1::2].isnan().all())
    print(f"neighbour check ({b},{h},{t},{hd}) bf16, heads 0, 2, 4 computed: max|d|={err:.3e}, "
          f"heads 1, 3, 5 still NaN: {untouched}")
    if fused_mhsa.route_launches["tensor_core"] != before + 1:
        _fail("the neighbour check did not take the tensor-core route")
    if not err <= TOL[str(bf16)] or not untouched:
        _fail("fused_mhsa wrote outside the heads it was given, or disagrees on them")
    return errs


def _check_sinkhorn(gen, dev):
    """Phase 4, Sinkhorn: kernel vs plain version; returns max|d| per case."""
    import torch

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
        got = sinkhorn_pallas(cost, w1, w2, iters=iters, out=torch.full_like(cost, float("nan")))
        want = sinkhorn_reference(cost, w1, w2, iters=iters)
        torch.cuda.synchronize()
        if sinkhorn_pallas.route_launches[route] != before[route] + 1:
            _fail(f"sinkhorn_pallas {name}: expected one launch on the {route} route, "
                  f"counts went {before} -> {sinkhorn_pallas.route_launches}")
        err = (got - want).abs().max().nan_to_num(float("inf")).item()
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
            got = sinkhorn_pallas(cost, w1, w2, iters=iters, route="general",
                                  out=torch.full_like(cost, float("nan")))
            err = (got - want).abs().max().nan_to_num(float("inf")).item()
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


def _check_moved(label, module, before, bn_frozen):
    """Every parameter changed; every BN running statistic bit-identical when
    ``bn_frozen``, changed otherwise."""
    import torch

    params = {k for k, _ in module.named_parameters()}
    for k, v in module.state_dict().items():
        same = torch.equal(v, before[k])
        if k in params and same:
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


def _expect_routes(label, route, n):
    """The fused_mhsa launches since the last zeroing: ``n`` on ``route``, none
    elsewhere, and no Sinkhorn launch."""
    from fewshot_vit_tpu_torch.kernels.attention import fused_mhsa
    from fewshot_vit_tpu_torch.kernels.sinkhorn import sinkhorn_pallas

    counts = {"fused_mhsa": dict(fused_mhsa.route_launches),
              "sinkhorn_pallas": dict(sinkhorn_pallas.route_launches)}
    want = {"fused_mhsa": {r: (n if r == route else 0) for r in ("general", "tensor_core")},
            "sinkhorn_pallas": {"general": 0, "packed": 0}}
    if counts != want:
        _fail(f"{label}: expected {n} fused_mhsa launches on the {route} route and no other "
              f"launch, counted {counts}")
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
        counts[f"pretrain_train_{name}"] = _expect_routes(f"pretrain {name} training", route, 0)
        print(f"pretrain {name}: {PRE_STEPS} steps of {bs} images (cropaug, drop-path 0.5, "
              f"{mini.n_classes} classes), losses {losses.tolist()}, {wall:.2f} s with warm-up, "
              f"peak memory {peak:.2f} GiB; fused_mhsa launches in training 0")
        if not np.isfinite(losses).all():
            _fail(f"pretrain {name}: a loss is not finite: {losses}")
        _check_moved(f"pretrain {name}", model, before, bn_frozen=False)

        _zero_counts(fused_mhsa, sinkhorn_pallas)
        vm = eval_metrics(eval_fn(model, val_images, val_labels, vidx))
        n_ce = 2 * len(vidx)  # 2 stage-2 blocks per validation forward
        counts[f"pretrain_val_ce_{name}"] = _expect_routes(f"pretrain {name} val CE", route, n_ce)
        _zero_counts(fused_mhsa, sinkhorn_pallas)
        fm = fs_eval(model.encoder, fs_ds, n_episodes=FS_EPISODES, images_dev=fs_images)
        n_fs = 2 * 2 * math.ceil(FS_EPISODES / 8)  # 2 blocks x 2 shots x episode batches
        counts[f"pretrain_fs_eval_{name}"] = _expect_routes(f"pretrain {name} fs_eval", route, n_fs)
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
    counts["pretrain_train_sam_ema"] = _expect_routes("pretrain SAM and EMA training", "general", 0)
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
        counts[f"sun_train_{name}"] = _expect_routes(f"SUN {name}", route, 2 * SUN_STEPS)
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
    _expect_routes("SUN kernel-teacher check", "general", 2)
    soft_p = sun_targets(plain_t, xw, soft_k=SUN_KW["soft_k"], bg_tokens=SUN_KW["bg_tokens"])
    _expect_routes("SUN plain-teacher check", "general", 2)
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


def _run_cli_chain(tag):
    """Phase 13: ``train.pretrain`` -> ``train.sun`` (``load:`` its max-va) ->
    ``train.meta_tune`` (``load_encoder:`` SUN's max-va), through
    ``parse_args`` + ``main`` on the card in a temporary --save-root."""
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", default=None, help="write a profiler table here")
    args = p.parse_args()

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
    pairs = {}
    for label, a, b in (("tensor-core vs general route", accs_k, accs_o),
                        ("tensor-core route vs plain path", accs_k, accs_p),
                        ("general route vs plain path", accs_o, accs_p)):
        pairs[label] = (float((a != b).mean()), float(abs(a - b).mean()))
        print(f"bf16 {label}: episodes differing={pairs[label][0]:.4f}, "
              f"mean|dacc|={pairs[label][1]:.5f}, acc {a.mean():.4f} vs {b.mean():.4f}")
    allowed = pairs["general route vs plain path"][0] + 0.01
    for label in ("tensor-core vs general route", "tensor-core route vs plain path"):
        differ, mean_d = pairs[label]
        if differ > allowed or mean_d > 0.005:
            _fail(f"bf16 {label}: {differ:.4f} of the episodes differ (allowed {allowed:.4f}), "
                  f"mean|dacc| {mean_d:.5f} (allowed 0.005)")

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

    sinkhorn = _run_sund(dev, ds, images_dev, tag, gen, args.profile, card)
    kernels.append({**sinkhorn, "max_abs_err": sinkhorn_errs["grid"],
                    "max_abs_err_train_shape": sinkhorn_errs["train episode"]})
    torch.cuda.empty_cache()

    # phases 8-10: the two trainers
    val_ds = datasets.make("synthetic", n_classes=20, n_per_class=40, image_size=80, seed=3)
    training, train_launches = _train_sund(dev, ds, images_dev, val_ds, tag, args.profile, card)
    torch.cuda.empty_cache()
    sunm, sunm_launches = _train_sunm(dev, ds, images_dev, val_ds, tag, args.profile, card)
    training.update(sunm)
    train_launches.update(sunm_launches)
    torch.cuda.empty_cache()
    _run_clis(tag)

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
    training.update(pre)
    training.update(sun)
    train_launches.update(pre_counts)
    train_launches.update(sun_counts)
    del mini_dev, mini_labels
    torch.cuda.empty_cache()
    _run_cli_chain(tag)
    for entry in kernels:
        entry["train_launches"] = {
            path: (c[entry["name"]] if isinstance(c[entry["name"]], int)
                   else sum(c[entry["name"]].values()))
            for path, c in train_launches.items()}
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"training": training, "card": card}))

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
