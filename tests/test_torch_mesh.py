"""The mesh library and the evals over it (``parallel/mesh.py``), on two gloo
ranks: CPU processes started with torchrun's environment
(``torch_port_helpers.launch_ranks``), each group with a free port of its
own and a 120 s limit.

  * global BN statistics: a training-mode BN over two ranks' blocks against
    one process over the whole batch and against flax's BN (forward, input
    and parameter gradients, running statistics), within 1e-5, the BN rule
    of ``ROADMAP.md`` section 3;
  * ``evaluate(mesh=)`` and ``eval.run --mesh-data 2`` (plain and
    ``--fold-bn``): per-episode accuracies bit-identical to JAX's
    ``evaluate`` on the same episodes, on every rank; ``--mesh-data`` with
    ``--cached`` / ``--sauc`` or with another world size refused with JAX's
    words;
  * ``eval.run_emd --mesh-data 2``: the 1-shot grid protocol bit-identical
    to JAX's; a 2-shot SFC batch bit-identical to the port's one-process run
    (the shuffles are ``sfc_perms`` of the global episode index, so the
    grouping does not show; the single-process SFC tests hold the port to
    JAX with JAX's shuffles injected);
  * ``eval.export --data-shards 2``: the scorer, the encoder and the EMD
    scorer served by two ranks equal the unsharded artifact (JAX's rtol
    1e-5, atol 1e-6); the indivisible batch refused with JAX's words; an
    N-shard artifact refused outside a mesh of N ranks;
  * ``init_distributed``: a no-op returning 1 for one process, and a
    ``tcp://`` rendezvous of two ranks from explicit arguments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fewshot_vit_tpu.data.datasets import synthetic as j_synthetic
from fewshot_vit_tpu.eval.emd_eval import (
    group_episode_indices as j_group,
    make_emd_eval_run_fn as j_run_fn,
)
from fewshot_vit_tpu.eval.episodic import evaluate as j_evaluate
from fewshot_vit_tpu.heads.deepemd import DeepEMD as JDeepEMD
from fewshot_vit_tpu.heads.meta_baseline import MetaBaseline as JMetaBaseline
from fewshot_vit_tpu.models.common import BatchNorm as JBatchNorm
from fewshot_vit_tpu.models.visformer import Visformer as JVisformer
from fewshot_vit_tpu.train.meta_tune_emd import (
    make_emd_episode_fn as j_episode_fn,
    make_patch_fn as j_patch_fn,
)
from fewshot_vit_tpu_torch.checkpoint import from_flax, save_variables
from fewshot_vit_tpu_torch.core.rng import DEFAULT_SEED
from fewshot_vit_tpu_torch.data.datasets import synthetic
from fewshot_vit_tpu_torch.eval import export, run, run_emd
from fewshot_vit_tpu_torch.eval.emd_eval import sample_emd_episode_indices
from fewshot_vit_tpu_torch.eval.episodic import sample_episode_indices
from fewshot_vit_tpu_torch.heads.deepemd import DeepEMD as TDeepEMD
from fewshot_vit_tpu_torch.heads.meta_baseline import MetaBaseline as TMetaBaseline
from fewshot_vit_tpu_torch.models.visformer import Visformer as TVisformer
from fewshot_vit_tpu_torch.parallel import mesh as pmesh
from fewshot_vit_tpu_torch.train.meta_tune_emd import make_patch_fn

from .test_torch_train_mode import _bn_pair
from .test_torch_zoo import draw_variables
from .torch_port_helpers import bn_over, launch_ranks, rank_outputs, wait_ranks

torch.set_num_threads(1)
TINY = dict(img_size=32, init_channels=8, embed_dim=48, depth=(1, 1, 1), num_heads=6)
ENC_ARGS = "{img_size: 32, init_channels: 8, embed_dim: 48, depth: [1, 1, 1]}"
NAME = "visformer_micro_80"
DATA = dict(n_classes=6, n_per_class=20, image_size=32, seed=2)
DATA_YAML = "{n_classes: 6, n_per_class: 20, image_size: 32, seed: 2}"
N_EP = 16  # two batches of the CLI's 8 episodes
WAY, QUERY, EPB = 3, 2, 4  # the artifacts' and the EMD CLI's episodes
EMD_EP, EMD_EPB = 4, 2
SFC = {"steps": 2, "lr": 100.0, "batch_size": 4}


def _artifacts(tmp, head_sd):
    """The three artifacts, unsharded (returned, with inputs) and 2-shard
    (written to ``tmp``)."""
    head = TMetaBaseline(TVisformer(**TINY, device="cpu"))
    head.load_state_dict(head_sd)
    emd = TDeepEMD(TVisformer(**TINY, device="cpu"), solver="sinkhorn_pallas", solver_iters=20)
    emd.encoder.load_state_dict(head.encoder.state_dict())
    rng = np.random.default_rng(4)
    u8 = lambda *s: torch.from_numpy(rng.integers(0, 256, s).astype(np.uint8))
    makers = {
        "scorer": (lambda **kw: export.export_episode_scorer(
            head, way=WAY, shot=1, query=QUERY, image_size=32, ep_per_batch=EPB, **kw),
            (u8(EPB, WAY, 1, 32, 32, 3), u8(EPB, WAY * QUERY, 32, 32, 3))),
        "encoder": (lambda **kw: export.export_encoder(head.encoder, image_size=32, batch=8,
                                                       **kw), (u8(8, 32, 32, 3),)),
        "emd": (lambda **kw: export.export_emd_episode_scorer(
            emd, way=WAY, shot=2, query=QUERY, image_size=32, sfc_kw=SFC, ep_per_batch=2,
            patch_fn=make_patch_fn("grid", [2, 3], 2.0, 32, False), **kw),
            (u8(2, WAY * (2 + QUERY), 32, 32, 3),)),
    }
    want, inputs = {}, {}
    for name, (make, x) in makers.items():
        export.save_exported(make(data_shards=2), str(tmp / f"{name}.pt2"))
        with torch.no_grad():
            want[name] = make().module()(*x)
        inputs[name] = x
    return want, inputs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Write the weights, configs and artifacts; start the three groups;
    compute JAX's results and the port's one-process ones while they run."""
    tmp = tmp_path_factory.mktemp("mesh")
    jhead = JMetaBaseline(encoder=JVisformer(**TINY))
    v = draw_variables(jhead, np.zeros((1, 2, 1, 32, 32, 3), np.float32),
                       np.zeros((1, 2, 32, 32, 3), np.float32), seed=1)
    v["params"]["temp"] = np.asarray(10.0, np.float32)
    sd = from_flax(v)
    save_variables(str(tmp / "head"), sd, {"model": "meta-baseline", "encoder": NAME})

    rng = np.random.default_rng(0)
    bn_x = rng.normal(1.0, 2.0, (8, 3, 3, 6)).astype(np.float32)
    bn_g = rng.normal(0.0, 1.0, bn_x.shape).astype(np.float32)
    bn_vars, bn_port = _bn_pair(bn_x)
    ds = synthetic(**DATA)
    indices = sample_episode_indices(ds, N_EP, 5, 16, 8, seed=5)  # the CLI's geometry
    want_art, art_inputs = _artifacts(tmp, sd)
    torch.save({"bn_state": bn_port.state_dict(), "bn_x": torch.from_numpy(bn_x),
                "bn_g": torch.from_numpy(bn_g), "encoder": TINY, "head": sd, "data": DATA,
                "indices": indices, "n_ep": N_EP, "way": 5, "query": 15, "epb": 8,
                "artifacts": art_inputs}, tmp / "lib.pt")

    cfg = tmp / "eval.yaml"
    cfg.write_text(f"dataset: synthetic\ndataset_args: {DATA_YAML}\nimage_size: 32\n"
                   f"encoder: {NAME}\n"
                   f"model_args: {{encoder_args: {ENC_ARGS}}}\nload: {tmp / 'head'}\n")
    emd_cfg = tmp / "emd.yaml"
    emd_cfg.write_text(f"test_dataset: synthetic\ntest_dataset_args: {DATA_YAML}\n"
                       f"deepemd: grid\nway: {WAY}\nquery: {QUERY}\nimage_size: 32\n"
                       "solver: sinkhorn_pallas\nsfc_update_step: 2\n"
                       f"model_args: {{encoder: {NAME}, encoder_args: {ENC_ARGS}}}\n"
                       f"load_encoder: {tmp / 'head'}\n")
    run_argv = ["--config", str(cfg), "--episodes", str(N_EP), "--device", "cpu"]
    emd_argv = lambda shot, n: ["--config", str(emd_cfg), "--shot", str(shot), "--episodes",
                                str(n), "--ep-per-batch", str(EMD_EPB), "--device", "cpu"]
    mesh2 = ["--mesh-data", "2"]
    torch.save({"run": ("run", run_argv + mesh2),
                "run_fold": ("run", run_argv + mesh2 + ["--fold-bn"]),
                "emd_grid": ("run_emd", emd_argv(1, EMD_EP) + mesh2),
                "emd_sfc": ("run_emd", emd_argv(2, EMD_EPB) + mesh2)}, tmp / "eval_clis.pt")

    groups = {"lib": launch_ranks("lib", tmp, 2), "eval_clis": launch_ranks("eval_clis", tmp, 2),
              "tcp": launch_ranks("tcp", tmp, 2, env_vars=False)}
    try:
        jds = j_synthetic(**DATA)
        jax_out = {"cli": np.asarray(j_evaluate(jhead, v, jds, n_episodes=N_EP, ep_per_batch=8,
                                                seed=DEFAULT_SEED)[2]),
                   "lib": np.asarray(j_evaluate(jhead, v, jds, n_episodes=N_EP,
                                                ep_per_batch=8, indices=indices)[2])}
        y, vjp, mut = jax.vjp(lambda x: JBatchNorm().apply(bn_vars, x, True,
                                                           mutable=["batch_stats"]),
                              jnp.asarray(bn_x), has_aux=True)
        jax_out["bn"] = {"y": np.asarray(y), "dx": np.asarray(vjp(jnp.asarray(bn_g))[0]),
                         "mean": np.asarray(mut["batch_stats"]["bn"]["mean"]),
                         "var": np.asarray(mut["batch_stats"]["bn"]["var"])}
        jemd = JDeepEMD(encoder=JVisformer(**TINY), solver_iters=20)
        jvars = {"params": {"encoder": v["params"]["encoder"]},
                 "batch_stats": {"encoder": v["batch_stats"]["encoder"]}}
        idx = sample_emd_episode_indices(ds, EMD_EP, WAY, 1 + QUERY, DEFAULT_SEED)
        ep_fn = j_episode_fn(jemd, WAY, 1, QUERY, j_patch_fn("grid", [2, 3], 9, 2.0, 32, False),
                             jds.mean, jds.std, sfc=False)
        jax_out["emd_grid"] = np.asarray(j_run_fn(ep_fn, jnp.tile(jnp.arange(WAY), QUERY))(
            jvars, jnp.asarray(jds.images), jnp.asarray(j_group(idx, EMD_EPB)),
            jax.random.key(0)))[:EMD_EP]
        one = {"bn": bn_over(None, bn_port.state_dict(), torch.from_numpy(bn_x),
                             torch.from_numpy(bn_g)),
               "emd_sfc": run_emd.main(emd_argv(2, EMD_EPB))}
    finally:
        stdout = {g: wait_ranks(p) for g, p in groups.items()}
    out = {g: rank_outputs(g, tmp, 2) for g in groups}
    return dict(tmp=tmp, jax=jax_out, one=one, out=out, stdout=stdout, want_art=want_art,
                cfg=str(cfg), emd_cfg=str(emd_cfg))


def test_global_bn_equals_one_process_and_flax(ranks):
    """Two ranks' blocks of an (8, 3, 3, 6) batch: outputs and input
    gradients, concatenated, equal one process over the whole batch and
    flax's BN (its vjp); the parameter gradients summed over the ranks
    equal the whole batch's; both ranks update the running statistics with
    the global batch's."""
    ranks_bn = [o["bn"] for o in ranks["out"]["lib"]]
    one, want = ranks["one"]["bn"], ranks["jax"]["bn"]
    for k in ("y", "dx"):
        got = torch.cat([r[k] for r in ranks_bn]).numpy()
        np.testing.assert_allclose(got, one[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got, want[k], rtol=0, atol=1e-5, err_msg=k)
    for k in ("dw", "db"):
        np.testing.assert_allclose(sum(r[k] for r in ranks_bn).numpy(), one[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    for r in ranks_bn:
        for k in ("mean", "var"):
            np.testing.assert_allclose(r[k].numpy(), one[k].numpy(), rtol=0, atol=1e-5)
            np.testing.assert_allclose(r[k].numpy(), want[k], rtol=0, atol=1e-5)


def test_evaluate_mesh_bit_identical_to_jax(ranks):
    """``evaluate(mesh=)`` over an explicit index matrix (two batches of 8
    5-way 15-query episodes, four a rank, drawn from another seed than the
    CLI's): every rank returns JAX's per-episode accuracies in global
    order."""
    want = ranks["jax"]["lib"]
    assert want.shape == (N_EP,) and len(set(want.tolist())) > 1
    for out in ranks["out"]["lib"]:
        np.testing.assert_array_equal(out["evaluate"], want)


@pytest.mark.parametrize("name", ["run", "run_fold"])
def test_eval_run_mesh_data_bit_identical_to_jax(ranks, name):
    """``eval.run --mesh-data 2`` (unfolded and ``--fold-bn``) on two ranks:
    every rank returns JAX's per-episode accuracies; rank 0 alone prints."""
    want = ranks["jax"]["cli"]
    assert want.shape == (N_EP,) and 0 < want.mean() < 1
    for out in ranks["out"]["eval_clis"]:
        np.testing.assert_array_equal(out[name], want)
    out0, out1 = ranks["stdout"]["eval_clis"]
    assert out0.count("test epoch 1: acc=") == 2 and out1.strip() == ""


def test_run_emd_mesh_data_grid_bit_identical_to_jax(ranks):
    want = ranks["jax"]["emd_grid"]
    assert want.shape == (EMD_EP,)
    for out in ranks["out"]["eval_clis"]:
        np.testing.assert_array_equal(out["emd_grid"], want)
    assert ranks["stdout"]["eval_clis"][0].count("3-way 1-shot (grid): acc=") == 1


def test_run_emd_mesh_data_sfc_equals_one_process(ranks):
    """A 2-shot SFC batch of 2 episodes, one a rank: the shuffles are those
    of the global episode indices, so the accuracies are the one-process
    run's, bit for bit."""
    for out in ranks["out"]["eval_clis"]:
        np.testing.assert_array_equal(out["emd_sfc"], ranks["one"]["emd_sfc"])


def test_mesh_data_refusals_with_jax_words(ranks):
    argv = ["--config", ranks["cfg"], "--episodes", "8", "--device", "cpu"]
    for flag in ("--cached", "--sauc"):
        with pytest.raises(SystemExit):
            run.main(argv + ["--mesh-data", "2", flag])
    with pytest.raises(ValueError, match=r"mesh \{'data': 2\} needs 2 devices, have 1"):
        run.main(argv + ["--mesh-data", "2"])  # one process
    with pytest.raises(SystemExit):
        run_emd.main(["--config", ranks["emd_cfg"], "--ep-per-batch", "3", "--mesh-data", "2",
                      "--device", "cpu"])


@pytest.mark.parametrize("name", ["scorer", "encoder", "emd"])
def test_sharded_artifacts_served_by_two_ranks_equal_unsharded(ranks, name):
    """Each rank runs its block through the custom ops and gathers the
    rest: the full result, on both ranks, equals the unsharded artifact's."""
    want = ranks["want_art"][name]
    for out in ranks["out"]["lib"]:
        got = out["serve"][name]
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_sharded_artifact_needs_its_mesh_and_divisible_batches(ranks):
    path = str(ranks["tmp"] / "scorer.pt2")
    with pytest.raises(ValueError, match="2-shard artifact: it serves under a mesh of 2 data"):
        export.load_exported(path, device="cpu")
    head = TMetaBaseline(TVisformer(**TINY, device="cpu"))
    with pytest.raises(ValueError, match="ep_per_batch=3 must divide over data_shards=2"):
        export.export_episode_scorer(head, way=2, shot=1, query=2, image_size=32,
                                     ep_per_batch=3, data_shards=2)
    with pytest.raises(ValueError, match="batch=3 must divide over data_shards=2"):
        export.export_encoder(head.encoder, image_size=32, batch=3, data_shards=2)


def test_export_cli_data_shards(ranks, capsys):
    """``--data-shards 2`` exports from one process and records the shards."""
    out = str(ranks["tmp"] / "cli2.pt2")
    export.main(["--config", ranks["cfg"], "--out", out, "--way", "2", "--query", "2",
                 "--ep-per-batch", "2", "--data-shards", "2", "--device", "cpu"])
    assert "x2 device(s)" in capsys.readouterr().out
    extra = {"data_shards": ""}
    torch.export.load(out, extra_files=extra)
    assert extra["data_shards"] == "2"


def test_init_distributed_noop_and_tcp(ranks):
    assert pmesh.init_distributed() == 1 and pmesh.world_size() == 1
    assert pmesh.is_main_process()
    for rank, out in enumerate(ranks["out"]["tcp"]):
        assert out["world"] == 2 and out["again"] == 2 and out["backend"] == "gloo"
        assert out["gather"].tolist() == [0.0, 1.0]


def test_make_mesh_on_one_process():
    """One process: a size-1 mesh is pure single-device work (no groups, no
    sliced layer); a larger one raises with JAX's words; the axes are
    ``data`` and ``model``, ``data`` first. Without ``device``, the mesh and
    the group take the card, as every entry point does, and raise where
    there is none."""
    mesh = pmesh.make_mesh({"data": 1}, "cpu")
    assert mesh.groups == {"data": None, "model": None} and mesh.block(8) == slice(0, 8)
    assert pmesh.replicated(mesh) == slice(None) and pmesh.batch_sharding(mesh, 8) == slice(0, 8)
    assert pmesh.episode_shardings(mesh, 4) == (slice(0, 4), slice(0, 4))
    assert pmesh.param_shardings(mesh, TVisformer(**TINY, device="cpu")) == []
    with pytest.raises(ValueError, match=r"mesh \{'data': 1, 'model': 2\} needs 2 devices, have 1"):
        pmesh.make_mesh({"data": 1, "model": 2}, "cpu")
    with pytest.raises(ValueError, match="the port's mesh has the axes"):
        pmesh.make_mesh({"batch": 1}, "cpu")
    with pytest.raises(ValueError, match="'data' axis comes first"):
        pmesh.make_mesh({"model": 1, "data": 1}, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.make_mesh({"data": 1})
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.init_distributed("127.0.0.1:1", 2, 0)
        assert not dist.is_initialized()
