"""Check and time the hand-written kernels alone on one card, route against route.

    python -m fewshot_vit_tpu_torch.kernels.bench [--reps 20] [--batch 10240]

Builds ``csrc/*.cu``, prints what ``ptxas -v`` says of every kernel (registers,
spills, shared memory), holds each route of ``fused_mhsa`` and
``sinkhorn_pallas`` against its plain version at the eval's shapes with the
output pre-filled with NaN, and times them in turns (old, new, new, old) with
CUDA events, ``scaled_dot_product_attention`` beside the MHSA as a yardstick.
``chip_smoke.py`` makes the same measurements inside its full run; this is the
short loop for working on a kernel. Every line names the card and its power
limit.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from . import build
from .attention import fused_mhsa, fused_mhsa_reference
from .sinkhorn import sinkhorn_pallas, sinkhorn_reference


def time_ms(fn, reps: int, warm: int = 3) -> float:
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


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--batch", type=int, default=10240, help="images per MHSA call")
    p.add_argument("--ptxas", action="store_true", help="print every kernel's ptxas line")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernels.bench needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card)
    logs = build.build()
    for name, log in logs.items():
        lines = build.ptxas_summary(log)
        spills = [x for x in lines if "spill" in x]
        print(f"ptxas {name}: {len(lines)} lines, {len(spills)} with spills")
        for line in (lines if args.ptxas else spills):
            print("  " + line)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)

    b, h, t, hd = args.batch, 6, 100, 42
    qkv = torch.randn(b, t, 3, h, hd, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    scale = hd ** -0.5
    want = fused_mhsa_reference(q, k, v, scale).float()
    for route in ("general", "tensor_core"):
        out = torch.full((b, t, h, hd), float("nan"), dtype=torch.bfloat16, device=dev)
        got = fused_mhsa(q, k, v, scale, out=out.transpose(1, 2), route=route)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().nan_to_num(float("inf")).item()
        print(f"[{card}] fused_mhsa ({b},{h},{t},{hd}) bf16 {route}: max|d|={err:.3e}")
    del want
    out = torch.empty((b, t, h, hd), dtype=torch.bfloat16, device=dev).transpose(1, 2)
    ms = {"general": [], "tensor_core": [], "sdpa": []}
    for route in ("general", "tensor_core", "sdpa", "sdpa", "tensor_core", "general"):
        if route == "sdpa":
            fn = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale)  # noqa: E731
        else:
            fn = lambda: fused_mhsa(q, k, v, scale, out=out, route=route)  # noqa: E731
        ms[route].append(time_ms(fn, args.reps))
    print(f"[{card}] fused_mhsa ({b},{h},{t},{hd}) bf16 ms per call: {ms}")
    del qkv, q, k, v, out

    from ..ops.emd import normalize_weights

    for bsz, n in ((3000, 13), (3000, 25), (160, 13)):
        cost = 2.0 * torch.rand(bsz, n, n, generator=gen, device=dev)
        w1 = normalize_weights(torch.rand(bsz, n, generator=gen, device=dev))
        w2 = normalize_weights(torch.rand(bsz, n, generator=gen, device=dev))
        want = sinkhorn_reference(cost, w1, w2)
        ms = {"general": [], "packed": []}
        for route in ms:
            got = sinkhorn_pallas(cost, w1, w2, route=route,
                                  out=torch.full_like(cost, float("nan")))
            torch.cuda.synchronize()
            err = (got - want).abs().max().nan_to_num(float("inf")).item()
            print(f"[{card}] sinkhorn_pallas ({bsz},{n},{n}) {route}: max|d|={err:.3e}")
        for route in ("general", "packed", "packed", "general"):
            ms[route].append(
                time_ms(lambda: sinkhorn_pallas(cost, w1, w2, route=route), args.reps))
        print(f"[{card}] sinkhorn_pallas ({bsz},{n},{n}) iters 100 ms per call: {ms}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
