"""Tests of the port that need the card: the CUDA fused-MHSA and Sinkhorn
kernels against their plain versions, and the encoder's fused-attention and
the DeepEMD head's kernel paths against their plain paths. They import neither JAX nor the JAX package, so they run on a machine
that has only PyTorch:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from fewshot_vit_tpu_torch.heads.deepemd import emd_logits
from fewshot_vit_tpu_torch.kernels import attention as tk
from fewshot_vit_tpu_torch.kernels import sinkhorn as tks
from fewshot_vit_tpu_torch.models.visformer import Visformer
from fewshot_vit_tpu_torch.ops.emd import normalize_weights

from .torch_port_helpers import SMALL_VISFORMER, cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.cuda


def _qkv(shape, seed, device, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(64, 6, 100, 42), (32, 6, 25, 85), (4, 2, 512, 128),
                                   (3, 1, 1, 1), (2, 3, 33, 97), (8, 4, 64, 48),
                                   (4, 2, 128, 128), (4, 2, 129, 64)])
def test_kernel_matches_plain(cuda_device, dtype, tol, shape):  # noqa: F811
    q, k, v = _qkv(shape, 6, cuda_device, dtype)
    scale = shape[-1] ** -0.5
    route = "tensor_core" if dtype == torch.bfloat16 and shape[2] <= 128 else "general"
    assert tk.mhsa_route(q) == route
    before, before_route = tk.fused_mhsa.launches, tk.fused_mhsa.route_launches[route]
    # the bare launch into a NaN-filled output: an element it does not write fails
    bare = torch.full_like(q, float("nan"))
    tk._launch(q, k, v, bare, scale, None)
    got = tk.fused_mhsa(q, k, v, scale)  # the op
    torch.cuda.synchronize()
    assert tk.fused_mhsa.launches == before + 2
    assert tk.fused_mhsa.route_launches[route] == before_route + 2
    want = tk.fused_mhsa_reference(q, k, v, scale)
    for out in (bare, got):
        assert out.dtype == dtype
        assert (out.float() - want.float()).abs().max().nan_to_num(float("inf")).item() <= tol


@pytest.mark.parametrize("shape", [(64, 100, 6, 42), (16, 25, 6, 85), (3, 1, 1, 1),
                                   (2, 33, 3, 97), (8, 64, 4, 48), (4, 128, 2, 128)])
def test_tensor_core_route_on_packed_views(cuda_device, shape):  # noqa: F811
    """bf16 heads split out of a packed qkv tensor, the bare launch of each
    route writing a (B, T, H, hd) view pre-filled with NaN, and the op on
    the same views with the route forced. 2e-2: one bf16 ulp of outputs up
    to ~3, plus the probabilities' bf16 rounding."""
    b, t, h, hd = shape
    rng = np.random.default_rng(t + hd)
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3, h, hd)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    want = tk.fused_mhsa_reference(q, k, v, hd ** -0.5).float()
    for route in ("tensor_core", "general"):
        out = torch.full((b, t, h, hd), float("nan"), dtype=torch.bfloat16, device=cuda_device)
        before = dict(tk.fused_mhsa.route_launches)
        tk._launch(q, k, v, out.transpose(1, 2), hd ** -0.5, route)
        with tk.force_route(route if route == "general" else None):
            got = tk.fused_mhsa(q, k, v, hd ** -0.5)
        torch.cuda.synchronize()
        after = tk.fused_mhsa.route_launches
        assert after[route] == before[route] + 2 and sum(after.values()) == sum(before.values()) + 2
        for o in (out.transpose(1, 2), got):
            assert (o.float() - want).abs().max().nan_to_num(float("inf")).item() <= 2e-2


def test_kernel_leaves_neighbouring_heads_alone(cuda_device):  # noqa: F811
    """Only heads 0, 2, 4 are computed, through views, by the bare launch;
    the columns of heads 1, 3, 5 lie between theirs in every output row and
    must stay NaN. The op on the same views agrees."""
    b, t, h, hd = 64, 100, 6, 42
    qkv = torch.randn(b, t, 3, h, hd, device=cuda_device).to(torch.bfloat16)
    q, k, v = (x.transpose(1, 2)[:, ::2] for x in qkv.unbind(2))
    out = torch.full((b, t, h, hd), float("nan"), dtype=torch.bfloat16, device=cuda_device)
    before = tk.fused_mhsa.route_launches["tensor_core"]
    tk._launch(q, k, v, out.transpose(1, 2)[:, ::2], hd ** -0.5, None)
    got = tk.fused_mhsa(q, k, v, hd ** -0.5)
    torch.cuda.synchronize()
    assert tk.fused_mhsa.route_launches["tensor_core"] == before + 2
    want = tk.fused_mhsa_reference(q, k, v, hd ** -0.5).float()
    for o in (out.transpose(1, 2)[:, ::2], got):
        assert (o.float() - want).abs().max().nan_to_num(float("inf")).item() <= 2e-2
    assert out[:, :, 1::2].isnan().all()
    assert not out[:, :, ::2].isnan().any()


def test_forced_routes_are_counted_or_refused(cuda_device):  # noqa: F811
    q, k, v = _qkv((2, 3, 40, 32), 7, cuda_device, torch.bfloat16)
    before = dict(tk.fused_mhsa.route_launches)
    tk.fused_mhsa(q, k, v, 1.0)
    tk.fused_mhsa(q, k, v, 1.0, route="general")
    with tk.force_route("general"):
        tk.fused_mhsa(q, k, v, 1.0)
    after = tk.fused_mhsa.route_launches
    assert after["tensor_core"] == before["tensor_core"] + 1
    assert after["general"] == before["general"] + 2
    with pytest.raises(ValueError, match="tensor-core route"):
        tk.fused_mhsa(q.float(), k.float(), v.float(), 1.0, route="tensor_core")
    cost, w1, w2 = _ot_problem(6, 13, 13, seed=1, device=cuda_device)
    before = dict(tks.sinkhorn_pallas.route_launches)
    tks.sinkhorn_pallas(cost, w1, w2)
    tks.sinkhorn_pallas(cost, w1, w2, route="general")
    after = tks.sinkhorn_pallas.route_launches
    assert after["packed"] == before["packed"] + 1 and after["general"] == before["general"] + 1
    cost, w1, w2 = _ot_problem(2, 33, 33, seed=1, device=cuda_device)
    with pytest.raises(ValueError, match="packed route"):
        tks.sinkhorn_pallas(cost, w1, w2, route="packed")


def test_kernel_reads_strided_views(cuda_device):  # noqa: F811
    b, t, h, hd = 16, 100, 6, 42
    qkv = torch.randn(b, t, 3, h, hd, device=cuda_device)
    q, k, v = qkv.unbind(2)
    got = tk.attention_core(q, k, v, hd ** -0.5)
    want = tk.fused_mhsa_reference(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), hd ** -0.5).transpose(1, 2)
    assert (got - want).abs().max().item() <= 1e-4


def test_kernel_rejects_what_it_cannot_take(cuda_device):  # noqa: F811
    q = torch.zeros(1, 1, 513, 16, device=cuda_device)
    with pytest.raises(ValueError):
        tk.fused_mhsa(q, q, q, 1.0)
    h = torch.zeros(1, 1, 8, 16, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError):
        tk.fused_mhsa(h, h, h, 1.0)
    w = torch.zeros(1, 1, 8, 16, device=cuda_device).transpose(2, 3)
    with pytest.raises(ValueError):
        tk.fused_mhsa(w, w, w, 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_fused_path_matches_plain(cuda_device, dtype):  # noqa: F811
    """Stage 2 (T=100) runs the kernel once per block. fp32 with TF32 off:
    1e-4. In bf16 the plain path is another function (it rounds scores and
    softmax to bf16), so both bf16 paths are held against the fp32 plain
    features: the kernel path may be off by at most twice what the plain bf16
    path is off, plus 1e-2."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 80, 80, 3))
                         .astype(np.float32)).to(cuda_device)
    plain32 = Visformer(**SMALL_VISFORMER, device=cuda_device, seed=1)
    plain = Visformer(**SMALL_VISFORMER, dtype=dtype, device=cuda_device, seed=1)
    fused = Visformer(**SMALL_VISFORMER, use_pallas_attn=True, dtype=dtype,
                      device=cuda_device, seed=1)
    route = "general" if dtype == torch.float32 else "tensor_core"
    before = tk.fused_mhsa.launches, tk.fused_mhsa.route_launches[route]
    with torch.no_grad():
        got, want, ref = fused(x), plain(x), plain32(x)
    torch.cuda.synchronize()
    assert tk.fused_mhsa.launches == before[0] + SMALL_VISFORMER["depth"][1]
    assert tk.fused_mhsa.route_launches[route] == before[1] + SMALL_VISFORMER["depth"][1]
    for a, b, r in zip(got, want, ref):
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        else:
            off_plain = (b.float() - r).abs().max().item()
            assert (a.float() - r).abs().max().item() <= 2 * off_plain + 1e-2


def _ot_problem(b, n1, n2, seed, device):
    rng = np.random.default_rng(seed)
    cost = torch.from_numpy(rng.uniform(0, 1, (b, n1, n2)).astype(np.float32)).to(device)
    w1, w2 = (normalize_weights(torch.from_numpy(rng.uniform(0, 1, (b, n)).astype(np.float32)))
              .to(device) for n in (n1, n2))
    return cost, w1, w2


@pytest.mark.parametrize("shape,iters", [((3000, 13, 13), 100), ((300, 25, 25), 100),
                                         ((5, 9, 13), 100), ((7, 64, 64), 100),
                                         ((4, 1, 33), 10), ((2, 38, 38), 0),
                                         ((160, 13, 13), 100), ((3001, 13, 13), 100),
                                         ((5, 16, 16), 100), ((5, 17, 9), 100),
                                         ((5, 32, 32), 100), ((5, 33, 33), 100),
                                         ((7, 13, 13), 0), ((7, 25, 13), 1)])
@pytest.mark.parametrize("forced", [None, "general"])
def test_sinkhorn_kernel_matches_plain(cuda_device, shape, iters, forced):  # noqa: F811
    cost, w1, w2 = _ot_problem(*shape, seed=sum(shape), device=cuda_device)
    route = forced or ("packed" if max(shape[1:]) <= 32 else "general")
    assert forced or tks.sinkhorn_route(*shape[1:]) == route
    before, before_route = tks.sinkhorn_pallas.launches, tks.sinkhorn_pallas.route_launches[route]
    # the bare launch into a NaN-filled output: an element it does not write fails
    bare = torch.full_like(cost, float("nan"))
    tks._launch(cost, w1, w2, bare, 0.05, iters, forced)
    got = tks.sinkhorn_pallas(cost, w1, w2, iters=iters, route=forced)  # the op
    torch.cuda.synchronize()
    assert tks.sinkhorn_pallas.launches == before + 2
    assert tks.sinkhorn_pallas.route_launches[route] == before_route + 2
    want = tks.sinkhorn_reference(cost, w1, w2, iters=iters)
    assert not got.requires_grad
    for out in (bare, got):
        assert (out - want).abs().max().nan_to_num(float("inf")).item() <= 1e-4


def test_sinkhorn_kernel_rejects_what_it_cannot_take(cuda_device):  # noqa: F811
    cost, w1, w2 = _ot_problem(2, 65, 9, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match="<= 64"):
        tks.sinkhorn_pallas(cost, w1, w2)
    cost, w1, w2 = _ot_problem(2, 9, 9, seed=0, device=cuda_device)
    with pytest.raises(ValueError):
        tks.sinkhorn_pallas(cost.double(), w1.double(), w2.double())
    with pytest.raises(ValueError):
        tks.sinkhorn_pallas(cost.transpose(1, 2), w1, w2)
    with pytest.raises(ValueError):
        tks.sinkhorn_pallas(cost, w1[:1], w2)


def test_head_kernel_path_matches_plain(cuda_device):  # noqa: F811
    rng = np.random.default_rng(3)
    proto, query = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda_device)
                    for s in ((8, 5, 13, 64), (8, 75, 13, 64)))
    before = tks.sinkhorn_pallas.launches
    got = emd_logits(proto, query, solver_impl="pallas")
    assert tks.sinkhorn_pallas.launches == before + 1
    torch.testing.assert_close(got, emd_logits(proto, query), rtol=1e-4, atol=1e-4)


def _sund_training_episode(device, solver, images, ratios):
    """One SUN-D training episode (grid, 3-way 1-shot 2-query) of a narrow
    DeepEMD on the card: loss and every gradient, from seed-0 weights."""
    from fewshot_vit_tpu_torch.heads.deepemd import make_deepemd
    from fewshot_vit_tpu_torch.train.meta_tune_emd import make_emd_episode_fn, make_patch_fn

    way, shot, query = 3, 1, 2
    head = make_deepemd(encoder_args=dict(SMALL_VISFORMER, use_pallas_attn=True), solver=solver,
                        device=device, seed=0)
    fn = make_emd_episode_fn(head, way, shot, query,
                             make_patch_fn("grid", [2, 3], 2.0, 80, train=True),
                             (0.5, 0.5, 0.5), (0.25, 0.25, 0.25), sfc=False, train=True)
    logits = fn(images[None], [0], ratios=ratios)[0].float()
    loss = torch.nn.functional.cross_entropy(
        logits, torch.arange(way, device=device).repeat(query))
    loss.backward()
    return loss.item(), {k: p.grad for k, p in head.named_parameters()}


def test_sund_training_episode_kernel_path_matches_plain(cuda_device):  # noqa: F811
    """The Sinkhorn kernel where its result feeds a backward pass: loss within
    1e-4 relative and every gradient within 1e-3 of its own max-abs of the
    ``sinkhorn_detached`` run from the same weights, images and ratios; one
    packed-route launch, and no MHSA launch although ``use_pallas_attn`` is
    on (training attention takes the einsum path)."""
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (9, 80, 80, 3)).astype(np.uint8)).to(cuda_device)
    ratios = torch.from_numpy(rng.uniform(1, 3, (9, 2)).astype(np.float32)).to(cuda_device)
    mhsa, packed = tk.fused_mhsa.launches, tks.sinkhorn_pallas.route_launches["packed"]
    loss_k, grads_k = _sund_training_episode(cuda_device, "sinkhorn_pallas", images, ratios)
    assert tks.sinkhorn_pallas.route_launches["packed"] == packed + 1
    loss_p, grads_p = _sund_training_episode(cuda_device, "sinkhorn_detached", images, ratios)
    assert tks.sinkhorn_pallas.route_launches["packed"] == packed + 1
    assert tk.fused_mhsa.launches == mhsa
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
    for k, g in grads_p.items():
        assert torch.isfinite(grads_k[k]).all(), k
        assert (grads_k[k] - g).abs().max().item() <= 1e-3 * g.abs().max().item() + 1e-7, k


def test_per_image_grid_patches_on_the_card_match_the_cpu(cuda_device):  # noqa: F811
    """The batched interpolation matrices are built on the device; same
    formula, same float32: within 1e-2 on the 0-255 scale of the CPU result
    (the tolerance of the per-image path against JAX)."""
    from fewshot_vit_tpu_torch.data.patches import draw_grid_ratios, grid_patches

    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(0, 256, (16, 80, 80, 3)).astype(np.uint8))
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    ratios = draw_grid_ratios(gen, 16, 2)
    assert ratios.device == cuda_device and ratios.min() >= 1 and ratios.max() < 3
    got = grid_patches(images.to(cuda_device), (2, 3), ratios, 80)
    want = grid_patches(images, (2, 3), ratios.cpu(), 80)
    assert got.shape == (16, 13, 80, 80, 3)
    assert (got.cpu() - want).abs().max().item() <= 1e-2


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_soft_labels_on_the_card_match_the_cpu(cuda_device, kind):  # noqa: F811
    """The stable sort breaks ties toward the lower index on the card too:
    bit-identical to the CPU labels, integer-valued (tied) logits included."""
    from fewshot_vit_tpu_torch.ops.token_label import generate_soft_label

    rng = np.random.default_rng(0)
    x = (rng.normal(0, 2, (64, 25, 64)) if kind == "normal"
         else rng.integers(-2, 3, (64, 25, 64))).astype(np.float32)
    want = generate_soft_label(torch.from_numpy(x))
    got = generate_soft_label(torch.from_numpy(x).to(cuda_device))
    assert torch.equal(got.cpu(), want)


def test_augmentation_on_the_card_matches_the_cpu(cuda_device):  # noqa: F811
    """Every op with the same injected draws: pixel ops within 1e-4 (the
    integer-valued ones exactly), the shift-based geometric ops within 1e-3."""
    from fewshot_vit_tpu_torch.data import augment as ta

    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (6, 24, 24, 3))
                         .astype(np.float32))
    mag = torch.tensor([0.0, 3.3, 9.0, 9.6, 10.0, 7.2])
    sign = torch.tensor([1.0, -1, 1, -1, -1, 1])
    for op, name in enumerate(ta.RA_OPS):
        want = ta.ra_apply(op, x, mag, sign)
        got = ta.ra_apply(op, x.to(cuda_device), mag.to(cuda_device), sign.to(cuda_device)).cpu()
        exact = name in ("Equalize", "Posterize", "Solarize", "Invert")
        torch.testing.assert_close(got, want, rtol=0, atol=0 if exact else 1e-3, msg=name)
    sigma = torch.tensor([0.1, 0.5, 1.0, 1.5, 1.99, 0.3])
    apply = torch.ones(6, dtype=torch.bool)
    torch.testing.assert_close(
        ta.gaussian_blur(None, x.to(cuda_device), apply=apply, sigma=sigma).cpu(),
        ta.gaussian_blur(None, x, apply=apply, sigma=sigma), rtol=0, atol=1e-4)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    u8 = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (8, 28, 28, 3))
                          .astype(np.uint8)).to(cuda_device)
    strong, weak = ta.make_dual_view_fn(out_size=24)(u8, g)
    assert strong.shape == weak.shape == (8, 24, 24, 3) and strong.is_cuda
    assert torch.isfinite(strong).all() and torch.isfinite(weak).all()


@pytest.mark.parametrize("teacher_dtype,route", [(torch.float32, "general"),
                                                 (torch.bfloat16, "tensor_core")])
def test_sun_step_teacher_launches_the_kernel(cuda_device, teacher_dtype, route):  # noqa: F811
    """One SUN step on the card: the frozen teacher's stage-2 attention goes
    through the kernel (one launch per block, on the route of its dtype), the
    training-mode student's does not."""
    from fewshot_vit_tpu_torch.heads.token_label import TokenLabel
    from fewshot_vit_tpu_torch.train.optim import make_optimizer
    from fewshot_vit_tpu_torch.train.state import TrainState
    from fewshot_vit_tpu_torch.train.steps import make_sun_step

    def model(dtype):
        enc = Visformer(**SMALL_VISFORMER, use_pallas_attn=True, dtype=dtype, device=cuda_device)
        return TokenLabel(enc, 6, dtype).to(cuda_device)

    student, teacher = model(torch.float32), model(teacher_dtype).requires_grad_(False)
    state = TrainState(student, make_optimizer(student.parameters(), "sgd", lr=1e-2))
    imgs = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (8, 80, 80, 3))
                            .astype(np.uint8)).to(cuda_device)
    labels = torch.arange(8, device=cuda_device) % 6
    before = dict(tk.fused_mhsa.route_launches)
    m = make_sun_step()(state, teacher, imgs, imgs, labels, (0, 1, 0))
    after = tk.fused_mhsa.route_launches
    n = len(teacher.encoder.stage2)
    assert {r: after[r] - before[r] for r in after} == {
        r: (n if r == route else 0) for r in after}
    assert all(torch.isfinite(v) for v in m.values())


def test_exact_flows_on_cuda_tensors_come_back_to_the_card(cuda_device):  # noqa: F811
    """``solver_impl='exact'``: the simplex runs on the host and the flows
    come back on the input's device; no Sinkhorn kernel is launched, and
    the logits equal those of the same problem on the CPU."""
    from fewshot_vit_tpu_torch.heads.deepemd import exact_flows

    rng = np.random.default_rng(11)
    proto = torch.from_numpy(rng.normal(size=(2, 5, 13, 32)).astype(np.float32))
    query = torch.from_numpy(rng.normal(size=(2, 15, 13, 32)).astype(np.float32))
    cost = torch.rand(4, 13, 13, generator=torch.Generator().manual_seed(0))
    w = normalize_weights(torch.rand(4, 13, generator=torch.Generator().manual_seed(1)) + 0.1)
    flow = exact_flows(cost.to(cuda_device), w.to(cuda_device), w.to(cuda_device))
    assert flow.device == cuda_device and flow.dtype == torch.float32
    torch.testing.assert_close(flow.cpu(), exact_flows(cost, w, w), rtol=0, atol=0)
    n = tks.sinkhorn_pallas.launches
    got = emd_logits(proto.to(cuda_device), query.to(cuda_device), solver_impl="exact")
    assert got.device == cuda_device and tks.sinkhorn_pallas.launches == n
    torch.testing.assert_close(got.cpu(), emd_logits(proto, query, solver_impl="exact"),
                               rtol=1e-4, atol=1e-4)


def test_capture_on_the_card_leaves_the_mhsa_launches(cuda_device):  # noqa: F811
    """``--real-attn`` on a fused-attention Visformer: 1 launch per forward
    (one stage-2 block here) inside the capture as outside, stage 3
    captured, the same outputs."""
    from fewshot_vit_tpu_torch.eval.visualize import real_attention_maps
    from fewshot_vit_tpu_torch.models.common import capture_attention

    enc = Visformer(**SMALL_VISFORMER, use_pallas_attn=True, device=cuda_device)
    x = torch.randn(4, 80, 80, 3, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    with torch.no_grad():
        n = tk.fused_mhsa.launches
        plain = enc(x)
        assert tk.fused_mhsa.launches == n + 1
        with capture_attention() as found:
            cap = enc(x)
        assert tk.fused_mhsa.launches == n + 2 and len(found) == 1
        maps = real_attention_maps(enc, x)
    assert tk.fused_mhsa.launches == n + 3
    assert maps.shape == (4, 5, 5) and 0.0 <= maps.min() and maps.max() <= 1.0
    for a, b in zip(plain, cap):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m,k,n", [(5, 27, 64), (640 * 100, 256, 756), (3000, 2048, 512)])
def test_int8_matmul_equals_float64_on_the_card(cuda_device, m, k, n):  # noqa: F811
    """``torch._int_mm`` with the port's padding (M to 17, K and N to
    multiples of 8) gives the exact int32 product."""
    from fewshot_vit_tpu_torch.models.quant import int8_matmul

    g = torch.Generator(device=cuda_device).manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=g, device=cuda_device).to(torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=cuda_device).to(torch.int8)
    y = int8_matmul(a, w)
    assert y.dtype == torch.int32 and y.shape == (m, n)
    assert torch.equal(y.double(), a.double() @ w.double().T)


@pytest.mark.parametrize("k,stride,pad,groups,cin,cout", [(3, 2, 1, 1, 3, 64), (3, 1, 1, 8, 256, 256),
                                                        (2, 2, 0, 1, 128, 256)])
def test_int8_conv_equals_float64_on_the_card(cuda_device, k, stride, pad, groups, cin, cout):  # noqa: F811
    import torch.nn.functional as F

    from fewshot_vit_tpu_torch.models import quant

    g = torch.Generator(device=cuda_device).manual_seed(cin)
    q = torch.randint(-127, 128, (8, 20, 20, cin), generator=g, device=cuda_device).to(torch.int8)
    w = torch.randint(-127, 128, (cout, cin // groups, k, k), generator=g,
                      device=cuda_device).to(torch.int8)
    y = torch.cat(list(quant.conv_int32_chunks(q, w, stride, pad, groups)))
    want = F.conv2d(q.permute(0, 3, 1, 2).double(), w.double(), None, stride, pad, 1, groups)
    assert torch.equal(y.double(), want.permute(0, 2, 3, 1))


def test_custom_ops_on_the_card(cuda_device):  # noqa: F811
    q, k, v = _qkv((4, 6, 100, 42), 9, cuda_device, torch.bfloat16)
    torch.library.opcheck(tk.mhsa_op, (q, k, v, 42 ** -0.5, ""))
    cost = 2.0 * torch.rand(50, 13, 13, device=cuda_device)
    w1 = normalize_weights(torch.rand(50, 13, device=cuda_device))
    w2 = normalize_weights(torch.rand(50, 13, device=cuda_device))
    torch.library.opcheck(tks.sinkhorn_op, (cost, w1, w2, 0.05, 100, ""))


def test_exported_encoder_on_the_card_launches_the_kernel(cuda_device, tmp_path):  # noqa: F811
    """An encoder artifact traced on the card, and one traced on the CPU and
    moved there, launch the fused-MHSA kernel inside the call (one stage-2
    block: one launch) and equal the live forward."""
    from fewshot_vit_tpu_torch.data.transforms import normalize
    from fewshot_vit_tpu_torch.eval import export

    enc = Visformer(**SMALL_VISFORMER, use_pallas_attn=True, device=cuda_device)
    imgs = torch.randint(0, 256, (4, 80, 80, 3), dtype=torch.uint8, device=cuda_device)
    with torch.no_grad():
        live = enc(normalize(imgs))[1]
    for platforms in (("cuda",), ("cpu", "cuda")):
        path = str(tmp_path / f"{len(platforms)}.pt2")
        export.save_exported(export.export_encoder(enc, image_size=80, batch=4,
                                                   platforms=platforms), path)
        prog = export.load_exported(path, device="cuda").module()
        before = tk.fused_mhsa.launches
        with torch.no_grad():
            got = prog(imgs)
        torch.cuda.synchronize()
        assert tk.fused_mhsa.launches == before + 1
        torch.testing.assert_close(got, live, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not for cpu"):
        export.load_exported(str(tmp_path / "1.pt2"), device="cpu")
