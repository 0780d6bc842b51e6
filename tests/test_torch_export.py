"""Port parity, serving export: ``eval/export.py`` (``torch.export``)
against ``fewshot_vit_tpu/eval/export.py`` (``jax.export``).

The artifacts take uint8 images, carry the weights and the dataset's
normalization, and call the two kernels as the custom ops
``fewshot_vit_tpu_torch::fused_mhsa`` / ``::sinkhorn_pallas`` (their plain
versions on CPU tensors). Each is held to the live port forward and to JAX's
deserialized artifact on the same inputs; SFC, traced without autograd
(``sfc_refine_explicit``), to ``sfc_refine`` and to JAX's artifact with
JAX's shuffles injected."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fewshot_vit_tpu.eval import export as j_export
from fewshot_vit_tpu.heads.deepemd import DeepEMD as JDeepEMD
from fewshot_vit_tpu.heads.meta_baseline import MetaBaseline as JMetaBaseline
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.train.meta_tune_emd import make_patch_fn as j_patch_fn
from fewshot_vit_tpu_torch.checkpoint import load_flax
from fewshot_vit_tpu_torch.data.transforms import normalize
from fewshot_vit_tpu_torch.eval import export
from fewshot_vit_tpu_torch.heads.deepemd import (
    DeepEMD as TDeepEMD,
    emd_logits,
    sfc_grad,
    sfc_refine,
    sfc_refine_explicit,
)
from fewshot_vit_tpu_torch.heads.meta_baseline import MetaBaseline as TMetaBaseline
from fewshot_vit_tpu_torch.kernels import attention, sinkhorn
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.ops import emd as ops_emd
from fewshot_vit_tpu_torch.ops.emd import SCAN_UNROLL, normalize_weights, sinkhorn_scan
from fewshot_vit_tpu_torch.train.meta_tune_emd import make_emd_episode_fn, make_patch_fn

from .torch_port_helpers import SMALL_VISFORMER, numpy_tree, randomize_bn

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAY, SHOT, QUERY, IMG, EPB = 3, 2, 4, 80, 2
STATS = ((0.4, 0.5, 0.6), (0.2, 0.25, 0.3))
# the port's artifacts against JAX's (fp32 on the CPU), both packages'
# summation orders: logits (|x| up to 12.5) measured 5.7e-6 (scorer), 3.8e-6
# (EMD 1-shot), 2.9e-6 (2-shot SFC); the encoder's pooled embedding (|x| up to
# 26.5) 1.1e-5, 4.3e-7 of its largest entry
JAX_TOL = 1e-5
EMB_RTOL = 1e-6  # of the embedding's largest entry


def _u8(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.fixture(scope="module")
def meta():
    jhead = JMetaBaseline(encoder=JVisformer(**SMALL_VISFORMER))
    variables = randomize_bn(numpy_tree(jhead.init(
        jax.random.key(0), jnp.zeros((1, WAY, SHOT, IMG, IMG, 3)),
        jnp.zeros((1, WAY * QUERY, IMG, IMG, 3)))))
    variables["params"]["temp"] = np.asarray(12.0, np.float32)
    thead = load_flax(TMetaBaseline(TVisformer(**SMALL_VISFORMER, use_pallas_attn=True,
                                               device="cpu")), variables)
    return jhead, variables, thead


@pytest.fixture(scope="module")
def emd():
    jhead = JDeepEMD(encoder=JVisformer(**SMALL_VISFORMER), solver_iters=20)
    variables = randomize_bn(numpy_tree(jhead.init(jax.random.key(4),
                                                   jnp.zeros((1, IMG, IMG, 3)))))
    thead = load_flax(TDeepEMD(TVisformer(**SMALL_VISFORMER, use_pallas_attn=True, device="cpu"),
                               solver_iters=20, solver="sinkhorn_pallas"), variables)
    return jhead, variables, thead


def test_episode_scorer_round_trip_and_jax(meta, tmp_path):
    jhead, variables, thead = meta
    kw = dict(way=WAY, shot=SHOT, query=QUERY, image_size=IMG, ep_per_batch=EPB,
              mean=STATS[0], std=STATS[1])
    ep = export.export_episode_scorer(thead, **kw)
    assert any("fewshot_vit_tpu_torch.fused_mhsa" in str(n.target) for n in ep.graph.nodes)
    path = str(tmp_path / "scorer.pt2")
    export.save_exported(ep, path)
    loaded = export.load_exported(path, device="cpu")
    xs, xq = _u8(0, EPB, WAY, SHOT, IMG, IMG, 3), _u8(1, EPB, WAY * QUERY, IMG, IMG, 3)
    with torch.no_grad():
        got = loaded.module()(torch.from_numpy(xs), torch.from_numpy(xq))
        live = thead(normalize(torch.from_numpy(xs), *STATS), normalize(torch.from_numpy(xq),
                                                                        *STATS))
    assert got.shape == (EPB, WAY * QUERY, WAY) and got.dtype == torch.float32
    torch.testing.assert_close(got, live, rtol=0, atol=0)
    jpath = str(tmp_path / "scorer.stablehlo")
    j_export.save_exported(j_export.export_episode_scorer(jhead, variables, **kw), jpath)
    want = np.asarray(j_export.load_exported(jpath).call(xs, xq))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_TOL)
    with pytest.raises(Exception):
        loaded.module()(torch.from_numpy(xs[:1]), torch.from_numpy(xq))  # episode batch


def test_encoder_export_matches_live_and_jax(meta, tmp_path):
    jhead, variables, thead = meta
    ep = export.export_encoder(thead.encoder, image_size=IMG, batch=4)
    path = str(tmp_path / "encoder.pt2")
    export.save_exported(ep, path)
    imgs = _u8(2, 4, IMG, IMG, 3)
    with torch.no_grad():
        got = export.load_exported(path, device="cpu").module()(torch.from_numpy(imgs))
        live = thead.encoder(normalize(torch.from_numpy(imgs)))[1]
    torch.testing.assert_close(got, live, rtol=0, atol=0)
    enc_vars = {c: t["encoder"] for c, t in variables.items() if "encoder" in t}
    want = np.asarray(j_export.export_encoder(jhead.encoder, enc_vars, image_size=IMG,
                                              batch=4).call(imgs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EMB_RTOL * np.abs(want).max())


def _jax_perms(seed, epb, steps, n_support):
    """The shuffles JAX's EMD artifact bakes: per episode key e of
    split(key(seed), E), split(key_e, 3)[1] is SFC's key, each step's perm a
    permutation from split(that key, steps)."""
    keys = jax.random.split(jax.random.key(seed), epb)
    out = []
    for k in keys:
        k2 = jax.random.split(k, 3)[1]
        out.append([np.asarray(jax.random.permutation(s, n_support))
                    for s in jax.random.split(k2, steps)])
    return torch.from_numpy(np.asarray(out, np.int64))


@pytest.mark.parametrize("shot", [1, 2])
def test_emd_scorer_matches_live_and_jax(emd, shot, tmp_path):
    """1-shot grid, and 2-shot SFC at the wiring setting of JAX's test
    (steps 3, lr 0.5, batch 4) with JAX's shuffles injected."""
    jhead, variables, thead = emd
    sfc_kw = {"steps": 3, "lr": 0.5, "batch_size": 4}
    epb = 2 if shot == 1 else 1
    perms = _jax_perms(3, epb, 3, WAY * shot) if shot > 1 else None
    kw = dict(way=WAY, shot=shot, query=2, image_size=IMG, ep_per_batch=epb, sfc_kw=sfc_kw,
              mean=STATS[0], std=STATS[1])
    ep = export.export_emd_episode_scorer(thead, patch_fn=make_patch_fn("grid", [2, 3], 2.0,
                                                                         IMG, False),
                                          perms=perms, **kw)
    path = str(tmp_path / "emd.pt2")
    export.save_exported(ep, path)
    imgs = _u8(5 + shot, epb, WAY * (shot + 2), IMG, IMG, 3)
    with torch.no_grad():
        got = export.load_exported(path, device="cpu").module()(torch.from_numpy(imgs))
        fn = make_emd_episode_fn(thead, WAY, shot, 2, make_patch_fn("grid", [2, 3], 2.0, IMG,
                                                                    False),
                                 *STATS, sfc=shot > 1, sfc_kw=sfc_kw)
        live = fn(torch.from_numpy(imgs), list(range(epb)), perms=perms)
    assert got.shape == (epb, WAY * 2, WAY)
    # 1-shot: the same ops; 2-shot: closed-form against autograd gradients,
    # measured 0 here (8.8e-8 relative on one gradient, test below)
    torch.testing.assert_close(got, live, rtol=0, atol=0 if shot == 1 else 1e-5)
    jexp = j_export.export_emd_episode_scorer(
        jhead, variables, patch_fn=j_patch_fn("grid", [2, 3], 9, 2.0, IMG, False), seed=3, **kw)
    want = np.asarray(jexp.call(imgs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_TOL)


def test_exact_solver_is_refused_as_jax_refuses_its_host_callback(emd):
    from fewshot_vit_tpu.heads.deepemd import exact_flows as j_exact_flows

    _, _, thead = emd
    exact = TDeepEMD(thead.encoder, solver="exact")
    with pytest.raises(NotImplementedError, match="host"):
        export.export_emd_episode_scorer(exact, way=WAY, shot=1, query=2, image_size=IMG,
                                         patch_fn=make_patch_fn("fcn", [2, 3], 2.0, IMG, False))
    spec = jax.ShapeDtypeStruct((2, 3, 3), jnp.float32)
    w = jax.ShapeDtypeStruct((2, 3), jnp.float32)
    with pytest.raises(NotImplementedError, match="host_callbacks"):
        jax.export.export(jax.jit(j_exact_flows))(spec, w, w)


def _sfc_problem(seed=0, e=2, way=5, shot=5, n=9, c=16):
    g = torch.Generator().manual_seed(seed)
    proto = torch.randn(e, way, n, c, generator=g)
    support = torch.randn(e, way * shot, n, c, generator=g)
    return proto, support


@pytest.mark.parametrize("iters", [0, 3, SCAN_UNROLL, 20, 27])
def test_sinkhorn_scan_equals_the_loop(iters):
    """The scan runs SCAN_UNROLL iterations a step and the rest after it:
    the same ops in the same order as the Python loop, so the same bits;
    exported, it is one scan node however many iterations."""
    rng = np.random.default_rng(iters)
    cost = torch.from_numpy(rng.uniform(0, 1, (6, 9, 13)).astype(np.float32))
    w1, w2 = (normalize_weights(torch.from_numpy(rng.uniform(0, 1, (6, n)).astype(np.float32)))
              for n in (9, 13))
    want = ops_emd.sinkhorn(cost, w1, w2, iters=iters)
    assert torch.equal(sinkhorn_scan(cost, w1, w2, iters=iters), want)

    class M(torch.nn.Module):
        def forward(self, c, a, b):
            return ops_emd.sinkhorn(c, a, b, iters=iters)

    ep = torch.export.export(M(), (cost, w1, w2))
    scans = [n for n in ep.graph.nodes if n.op == "call_function" and "scan" in str(n.target)]
    assert len(scans) == (iters >= SCAN_UNROLL)
    torch.testing.assert_close(ep.module()(cost, w1, w2), want, rtol=0, atol=0)


def test_explicit_sfc_gradient_matches_autograd():
    proto, support = _sfc_problem()
    batch = support[:, :4]
    labels = torch.tensor([[0, 1, 2, 3], [4, 0, 1, 2]])
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    p = proto.clone().requires_grad_(True)
    ce = -F.log_softmax(emd_logits(p, batch), -1).gather(-1, labels[..., None]).squeeze(-1)
    (want,) = torch.autograd.grad(((ce * mask).sum(-1) / mask.sum()).sum(), p)
    got = sfc_grad(proto, batch, labels, mask)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()  # measured 8.8e-8


def test_explicit_sfc_refine_matches_sfc_refine():
    """The same perms, mini-batches, masks and momentum: 4 steps of 5-way
    5-shot SFC at the eval's lr 100, 25 supports in 7 mini-batches of 4
    (the last wraps)."""
    proto, support = _sfc_problem(1)
    kw = dict(episode_ids=[0, 1], steps=4, lr=100.0, batch_size=4)
    want = sfc_refine(proto, support, 5, 5, **kw)
    got = sfc_refine_explicit(proto, support, 5, 5, **kw)
    # measured 2.9e-7: the gradient's rounding, amplified by lr 100 over 28 updates
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    with pytest.raises(ValueError, match="cosine"):
        sfc_refine_explicit(proto, support, 5, 5, metric="l2", **kw)


def _cfg(tmp_path, text):
    path = tmp_path / "export.yaml"
    path.write_text("dataset: synthetic\n"
                    "dataset_args: {n_classes: 4, n_per_class: 8, image_size: 80, seed: 0}\n"
                    "encoder: visformer_micro_80\n"
                    "model_args: {encoder_args: {init_channels: 16, embed_dim: 96, "
                    "depth: [1, 1, 1], use_pallas_attn: true}}\n" + text)
    return str(path)


@pytest.mark.parametrize("flags,kind,platforms", [
    (["--fold-bn"], "episode scorer", "cpu"),
    (["--encoder-only", "--batch", "4"], "encoder", "cpu"),
    (["--platforms", "cpu"], "episode scorer", "cpu"),
    (["--platforms", "cpu,cuda"], "episode scorer", "cpu,cuda"),
])
def test_cli(tmp_path, capsys, flags, kind, platforms):
    out = str(tmp_path / "a.pt2")
    ep = export.main(["--config", _cfg(tmp_path, ""), "--out", out, "--way", "2", "--shot", "1",
                      "--query", "2", "--device", "cpu"] + flags)
    text = capsys.readouterr().out
    assert f"exported {kind} [{platforms}] x1 device(s) -> {out} (" in text
    assert "MB)" in text and ep.platforms == tuple(platforms.split(","))
    loaded = export.load_exported(out, device="cpu")
    with torch.no_grad():
        if kind == "encoder":
            y = loaded.module()(torch.from_numpy(_u8(3, 4, IMG, IMG, 3)))
            assert y.shape == (4, 192)
        else:
            y = loaded.module()(torch.from_numpy(_u8(3, 1, 2, 1, IMG, IMG, 3)),
                                torch.from_numpy(_u8(4, 1, 4, IMG, IMG, 3)))
            assert y.shape == (1, 4, 2) and torch.isfinite(y).all()


def test_cli_emd_and_refusals(tmp_path, capsys):
    cfg = _cfg(tmp_path, "test_dataset: synthetic\n"
               "test_dataset_args: {n_classes: 4, n_per_class: 8, image_size: 80, seed: 0}\n"
               "deepemd: grid\npatch_list: [2, 3]\npatch_ratio: 2\nsolver: sinkhorn_pallas\n"
               "solver_iters: 10\n")
    out = str(tmp_path / "emd.pt2")
    export.main(["--config", cfg, "--out", out, "--emd", "--way", "2", "--shot", "1",
                 "--query", "2", "--device", "cpu"])
    assert "exported EMD episode scorer [cpu]" in capsys.readouterr().out
    with torch.no_grad():
        y = export.load_exported(out, device="cpu").module()(
            torch.from_numpy(_u8(8, 1, 6, IMG, IMG, 3)))
    assert y.shape == (1, 4, 2) and torch.isfinite(y).all()
    with pytest.raises(ValueError, match="ep_per_batch=1 must divide over data_shards=2"):
        export.main(["--config", cfg, "--out", out, "--data-shards", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="exported for .*cpu.*not for cuda"):
        export.load_exported(out, device="cuda")


def test_cli_notes_a_dataset_it_cannot_load(tmp_path, capsys):
    cfg = tmp_path / "missing.yaml"
    cfg.write_text("dataset: mini-imagenet\n"
                   f"dataset_args: {{root_path: {tmp_path / 'nowhere'}}}\n"
                   "encoder: visformer_micro_80\n"
                   "model_args: {encoder_args: {init_channels: 16, embed_dim: 96, "
                   "depth: [1, 1, 1]}}\n")
    export.main(["--config", str(cfg), "--out", str(tmp_path / "a.pt2"), "--encoder-only",
                 "--batch", "2", "--device", "cpu"])
    assert "note: dataset not loadable" in capsys.readouterr().out


_FRESH = r"""
import json, sys
import torch
try:
    torch.export.load(sys.argv[1])
    print(json.dumps({"without_ops": "loaded"}))
except Exception as e:
    without = type(e).__name__
import fewshot_vit_tpu_torch.kernels
prog = torch.export.load(sys.argv[1]).module()
x = torch.zeros((4, 80, 80, 3), dtype=torch.uint8)
with torch.no_grad():
    y = prog(x)
print(json.dumps({"without_ops": without, "shape": list(y.shape),
                  "modules": sorted(m for m in sys.modules if m.startswith("fewshot"))}))
"""


def test_fresh_process_loads_and_calls_with_the_kernels_module_only(meta, tmp_path):
    _, _, thead = meta
    path = str(tmp_path / "encoder.pt2")
    export.save_exported(export.export_encoder(thead.encoder, image_size=IMG, batch=4), path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _FRESH, path], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["without_ops"] != "loaded"  # an unregistered op fails the load
    assert out["shape"] == [4, 192]
    assert all(m == "fewshot_vit_tpu_torch" or m.startswith(("fewshot_vit_tpu_torch.kernels",
                                                             "fewshot_vit_tpu_torch.ops"))
               for m in out["modules"]), out["modules"]


def test_opcheck_both_ops():
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 10, 3, 3, 8, generator=g)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    torch.library.opcheck(attention.mhsa_op, (q, k, v, 0.35, ""))
    cost = torch.rand(5, 13, 9, generator=g)
    w1 = normalize_weights(torch.rand(5, 13, generator=g))
    w2 = normalize_weights(torch.rand(5, 9, generator=g))
    torch.library.opcheck(sinkhorn.sinkhorn_op, (cost, w1, w2, 0.05, 100, ""))
    # the op's CPU implementation is the plain version, and counts nothing
    before = (attention.fused_mhsa.launches, sinkhorn.sinkhorn_pallas.launches)
    torch.testing.assert_close(attention.fused_mhsa(q, k, v, 0.35),
                               attention.fused_mhsa_reference(q, k, v, 0.35), rtol=0, atol=0)
    torch.testing.assert_close(sinkhorn.sinkhorn_pallas(cost, w1, w2),
                               sinkhorn.sinkhorn_reference(cost, w1, w2), rtol=0, atol=0)
    assert (attention.fused_mhsa.launches, sinkhorn.sinkhorn_pallas.launches) == before
