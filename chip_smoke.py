#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fewshot_vit_tpu_torch``) on one GPU.

Phases, in order; any failure exits non-zero:
  1. require CUDA;
  2. print the card's name and power limit (nvidia-smi);
  3. build every CUDA kernel of the port from ``csrc/`` (one nvcc per source,
     all started together) and load it;
  4. hold each kernel against its plain PyTorch version on the card, in fp32
     and bf16, at the main path's shape and at a short and a long case;
  5. drive the main path through the port's entry points: SUN-M 5-way 1-shot
     15-query episodic eval, MetaBaseline over visformer_micro_80 at full
     width and depth, seeded weights, BN folded, bf16, fused attention on,
     on the synthetic 20 x 600 dataset resident on the card; the kernel's
     launch count must be 2 per episode batch. Then the same episodes in fp32
     (TF32 off), fused-kernel path against plain-attention path;
  6. time the main path (episodes/s) and the kernel, its plain version and
     ``scaled_dot_product_attention`` (a yardstick only) beside the bound;
  7. print the kernels' JSON line, then the result line.

Run from the root of a checkout:  python3 chip_smoke.py [--profile DIR]
(``--profile DIR`` also writes a torch.profiler table of one episode batch.)
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
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}  # dense bf16 tensor / fp32 non-tensor
TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", default=None, help="write a profiler table here")
    args = p.parse_args()

    # phase 1
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
    from fewshot_vit_tpu_torch.kernels.attention import (
        attention_core,
        fused_mhsa,
        fused_mhsa_reference,
    )
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # phase 4: kernel vs plain version, shapes of the main path and two more
    b_main = EP_PER_BATCH * WAY * (SHOT + QUERY)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    cases = [("stage2", b_main, 6, 100, 42), ("short", b_main, 6, 25, 85),
             ("long", 64, 4, 512, 128)]
    for name, b, h, t, hd in cases:
        for dtype in (torch.float32, torch.bfloat16):
            # heads split out of a packed qkv tensor and the output written
            # through a (B, T, H, hd) view, as attention_core hands them over;
            # the output starts as NaN so an unwritten element cannot pass
            qkv = torch.randn(b, t, 3, h, hd, generator=gen, device=dev).to(dtype)
            q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
            out = torch.full((b, t, h, hd), float("nan"), dtype=dtype, device=dev)
            got = fused_mhsa(q, k, v, hd ** -0.5, out=out.transpose(1, 2))
            want = fused_mhsa_reference(q, k, v, hd ** -0.5)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().nan_to_num(float("inf")).item()
            errs[(name, str(dtype))] = err
            ok = err <= TOL[str(dtype)]
            print(f"kernel vs plain {name} ({b},{h},{t},{hd}) {dtype}: "
                  f"max|d|={err:.3e} tol={TOL[str(dtype)]:g} {'ok' if ok else 'FAIL'}")
            if not ok:
                _fail(f"fused_mhsa disagrees with its plain version at {name} {dtype}")
            del qkv, q, k, v, out, got, want
    torch.cuda.synchronize()

    # phase 5: the main path
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
    fused_mhsa.launches = 0
    acc, ci, accs = run(main_head, N_EPISODES, seed=1)
    torch.cuda.synchronize()
    launches = fused_mhsa.launches
    print(f"main path bf16: {N_EPISODES} episodes, acc={acc * 100:.2f} +- {ci * 100:.2f} %, "
          f"fused_mhsa launches={launches} ({n_batches} batches)")
    if launches != 2 * n_batches:
        _fail(f"expected {2 * n_batches} fused_mhsa launches, counted {launches}")
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

    # phase 6: timings
    plain_head = head_for(torch.bfloat16, False)
    eps = {"fused": [], "plain": []}
    for which in ("fused", "plain", "plain", "fused"):
        head = main_head if which == "fused" else plain_head
        run(head, EP_PER_BATCH, seed=3)  # warm this head's shapes
        t0 = time.perf_counter()
        run(head, N_TIMED, seed=2)
        eps[which].append(N_TIMED / (time.perf_counter() - t0))
    print(f"timing {tag}: main path bf16 episodes/s, fused-kernel attention: "
          f"{eps['fused']}; plain attention: {eps['plain']} "
          f"({N_TIMED} episodes at ep_per_batch {EP_PER_BATCH})")

    kernels = []
    b, h, t, hd = b_main, 6, 100, 42
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.randn(b, t, 3, h, hd, generator=gen, device=dev).to(dtype)
        q, k, v = qkv.unbind(2)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        scale = hd ** -0.5
        ms = _time_ms(lambda: attention_core(q, k, v, scale))
        plain_ms = _time_ms(lambda: fused_mhsa_reference(qt, kt, vt, scale))
        lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, scale=scale))
        bound_ms, bound_by = _bound(b, h, t, hd, dtype)
        print(f"timing {tag}: fused_mhsa ({b},{h},{t},{hd}) {dtype}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}); kernel/bound {ms / bound_ms:.2f}")
        if dtype == torch.bfloat16:  # the main path's dtype
            kernels.append({
                "name": "fused_mhsa", "route": "cuda",
                "source": "fewshot_vit_tpu_torch/csrc/mhsa.cu",
                "replaces": "fewshot_vit_tpu/kernels/attention.py:54",
                "launches": launches,
                "max_abs_err": errs[("stage2", str(dtype))],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
            })
        del qkv, q, k, v, qt, kt, vt

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(main_head, EP_PER_BATCH, seed=4)
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        with open(os.path.join(args.profile, "profile_main_path.txt"), "w") as f:
            f.write(f"{card}\n{table}\n")
        print("\n".join(table.splitlines()[:25]))

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
