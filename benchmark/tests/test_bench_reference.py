"""The benchmark's plain reference against the measured program at a tiny
size on the CPU: the encoder, the Meta-Baseline logits, the grid patches,
the Sinkhorn flows and DeepEMD logits, every RandAugment operation and the
dual view with injected draws, and one SUN step."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import inputs
from benchmark.drivers.common import encoder_args
from benchmark.drivers.sun_train import make_draws
from benchmark.reference import augment as ref_aug
from benchmark.reference import heads as ref_heads
from benchmark.reference.visformer import Encoder, param_shapes
from benchmark.tests.tiny import SIZES

from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.data import augment as port_aug
from fewshot_vit_tpu_torch.data.patches import grid_patches
from fewshot_vit_tpu_torch.heads import deepemd, meta_baseline  # noqa: F401  (registers)
from fewshot_vit_tpu_torch.ops.emd import sinkhorn

CPU = torch.device("cpu")
ENC = encoder_args({"encoder_args": {
    "img_size": 80, "init_channels": 64, "embed_dim": 256, "depth": [4, 2, 3], "num_heads": 6,
    "mlp_ratio": 4.0, "group": 8, "attn_stage": "011", "spatial_conv": "100", "qkv_bias": False,
    "embed_norm": True,
    **json.loads((SIZES / "episodic_eval.json").read_text())["config"]["encoder_args"]}})
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


def tiny_weights(seed: int, extra=None):
    shapes = {f"encoder.{k}": v for k, v in param_shapes(ENC).items()}
    shapes.update(extra or {})
    params = inputs.weights(shapes, seed, CPU)
    images = inputs.split(4, 8, ENC["img_size"], seed, CPU)
    enc = {k[8:]: v for k, v in params.items() if k.startswith("encoder.")}
    inputs.calibrate(enc, ENC, ref_heads.normalize(images, MEAN, STD))
    return params, images


def test_param_shapes_are_the_programs_state_dict():
    head = models.make("meta-baseline", encoder="visformer_micro_80", device="cpu", seed=0)
    full = encoder_args({"encoder_args": {"img_size": 80, "init_channels": 64, "embed_dim": 256,
                                          "depth": [4, 2, 3], "num_heads": 6, "mlp_ratio": 4.0,
                                          "group": 8, "attn_stage": "011", "spatial_conv": "100"}})
    want = {k: tuple(v.shape) for k, v in head.state_dict().items()}
    got = {f"encoder.{k}": v for k, v in param_shapes(full).items()}
    got["temp"] = ()
    assert got == want


@pytest.mark.parametrize("dtype", ["float32"])
def test_encoder_and_cosine_logits_match_the_program(dtype):
    params, images = tiny_weights(3, {"temp": ()})
    head = models.make("meta-baseline", encoder="visformer_micro_80", encoder_args=dict(ENC),
                       device="cpu", seed=0)
    head.load_state_dict(params, strict=True)
    x = ref_heads.normalize(images[:20], MEAN, STD)
    enc = Encoder({k[8:]: v for k, v in params.items() if k.startswith("encoder.")}, ENC)
    with torch.no_grad():
        dense, pooled = head.encoder(x)
        r_dense, r_pooled = enc(x)
        assert torch.allclose(dense, r_dense, atol=1e-4, rtol=1e-4)
        assert torch.allclose(pooled, r_pooled, atol=1e-5, rtol=1e-4)
        xs, xq = x[:10].reshape(2, 5, 1, *x.shape[1:]), x[10:].reshape(2, 5, *x.shape[1:])
        got = head(xs, xq)
        f = r_pooled.reshape(4, 5, -1)
        want = ref_heads.cosine_logits(f[2:], f[:2], params["temp"])
    assert torch.allclose(got, want, atol=1e-4)


def test_grid_patches_match_the_program():
    images = inputs.split(2, 3, 80, 5, CPU)
    got = grid_patches(images, (2, 3), 2.0, 80)
    want = ref_heads.grid_patches(images, (2, 3), 2.0, 80)
    assert got.shape == want.shape == (6, 13, 80, 80, 3)
    # the program builds its weights in float32, the reference in float64:
    # pixels up to 255 agree to a few float32 ulps
    assert float((got - want).abs().max()) < 5e-3


def test_sinkhorn_and_emd_logits_match_the_program():
    g = torch.Generator().manual_seed(0)
    proto = torch.randn(2, 5, 13, 32, generator=g)
    query = torch.randn(2, 15, 13, 32, generator=g)
    got = deepemd.emd_logits(proto, query, 12.5, solver_reg=0.05, solver_iters=100)
    want = ref_heads.emd_logits(proto, query, 12.5, 0.05, 100)
    assert float((got.double() - want).abs().max()) < 1e-4
    cost = torch.rand(6, 13, 13, generator=g) * 2
    w1 = torch.rand(6, 13, generator=g) + 0.1
    w2 = torch.rand(6, 13, generator=g) + 0.1
    w1, w2 = w1 * 13 / w1.sum(-1, keepdim=True), w2 * 13 / w2.sum(-1, keepdim=True)
    flow = sinkhorn(cost, w1, w2, 0.05, 100)
    ref = ref_heads.sinkhorn(cost.double(), w1.double(), w2.double(), 0.05, 100)
    assert float((flow.double() - ref).abs().max()) < 1e-5 * float(ref.abs().max()) + 1e-6


@pytest.mark.parametrize("op", range(len(ref_aug.OPS)))
def test_rand_augment_ops_match_the_program(op):
    g = torch.Generator().manual_seed(op)
    x = torch.floor(torch.rand(4, 24, 24, 3, generator=g) * 256)
    mag = torch.tensor([9.0, 3.5, 10.0, 0.0])
    sign = torch.tensor([1.0, -1.0, -1.0, 1.0])
    got = port_aug.ra_apply(op, x, mag, sign)
    want = ref_aug.rand_augment_op(op, x.double(), mag, sign)
    assert float((got.double() - want).abs().max()) < 1e-3, ref_aug.OPS[op]


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_dual_view_matches_the_program(seed):
    images = inputs.split(2, 4, 36, seed, CPU)
    draws = make_draws(seed, 0, 8, 32, CPU)
    strong, weak = port_aug.make_dual_view_fn(MEAN, STD, out_size=32)(images, None, draws=draws)
    r_strong, r_weak = ref_aug.dual_view(images, draws, MEAN, STD, 32)
    std = torch.tensor(STD, dtype=torch.float64)
    for got, want in ((weak, r_weak), (strong, r_strong)):
        # in pixel levels; a value on a threshold (solarize, posterize,
        # grayscale's rounding) may land on either side in float32 and float64
        levels = ((got.double() - want) * std * 255).abs()
        assert float((levels > 1e-3).double().mean()) < 1e-3
        assert float(levels.max()) < 32


def test_one_sun_step_matches_the_program():
    from benchmark.core import execute
    from benchmark.tests.tiny import tiny_spec

    spec = tiny_spec("sun_train_fp32")
    spec["limits"] = {"loss_gap": 1e-4, "grad_gap": 1e-4, "update_gap": 5e-3}
    out = execute(spec, CPU, 77, 0.05, False, 0.0)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("epoch", [1, 2, 3, 6, 7, 100, 800, 801, 900])
def test_learning_rate_schedule_matches_the_program(epoch):
    from benchmark.reference.sun import cosine_lr
    from fewshot_vit_tpu_torch.train.optim import timm_cosine_schedule

    program = timm_cosine_schedule(5e-4, 800, 5, warmup_lr=1e-6).at(epoch - 1)
    assert abs(program - cosine_lr(epoch, 5e-4, 800, 5, 1e-6)) < 1e-15
