"""The port stands alone: no module of ``fewshot_vit_tpu_torch`` nor
``chip_smoke.py`` imports JAX, flax or the JAX package, and the entry points
that default to the card raise without one."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.data.datasets import synthetic
from fewshot_vit_tpu_torch.eval import emd_eval, episodic, run, run_emd
from fewshot_vit_tpu_torch.heads import classifier, deepemd, meta_baseline, token_label
from fewshot_vit_tpu_torch.models.visformer import Visformer
from fewshot_vit_tpu_torch.train import meta_tune, meta_tune_emd, pretrain, runner, sun

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fewshot_vit_tpu")


def _port_files():
    return sorted((ROOT / "fewshot_vit_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_scan_covers_the_port():
    names = {p.name for p in _port_files()}
    assert {"chip_smoke.py", "visformer.py", "attention.py", "episodic.py", "sinkhorn.py",
            "deepemd.py", "patches.py", "emd_eval.py", "run_emd.py", "meta_tune_emd.py",
            # the training slice
            "meta_tune.py", "optim.py", "state.py", "steps.py", "loop.py", "runner.py",
            "io.py", "staging.py", "augment.py", "log.py", "config.py",
            # the pretrain and SUN slice
            "pretrain.py", "sun.py", "sam.py", "classifier.py", "token_label.py",
            # checkpoints, the eval CLIs' loading, the datasets
            "reference.py", "from_flax.py", "run.py", "metric.py", "datasets.py",
            "transforms.py",
            # the rest of the encoder zoo
            "nest.py", "swin.py", "levit.py", "lvvit.py", "deit.py", "resnet.py",
            "resnet12.py", "convnet4.py", "fold.py",
            # solver: exact, the research heads, the visualization paths
            "emd.py", "meta_token.py", "visualize.py",
            # int8, the export, the watchdog
            "quant.py", "export.py", "watchdog.py",
            # the mesh
            "mesh.py"} <= names
    assert (ROOT / "fewshot_vit_tpu_torch" / "parallel" / "__init__.py") in _port_files()
    assert (ROOT / "fewshot_vit_tpu_torch" / "native" / "emd_solver.cpp").is_file()
    assert (ROOT / "fewshot_vit_tpu_torch" / "utils" / "__init__.py") in _port_files()
    assert len([p for p in _port_files() if p.name == "token_label.py"]) == 2  # ops and heads


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]  # exact top-level name: fewshot_vit_tpu_torch is allowed
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_default_device_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = synthetic(n_classes=5, n_per_class=2, image_size=80)
    enc = models.make("visformer_micro_80", device="cpu")
    head = meta_baseline.MetaBaseline(enc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        models.make("visformer_micro_80")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        models.make("meta-baseline", encoder="visformer_micro_80")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        episodic.evaluate(head, ds, n_episodes=1, ep_per_batch=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        episodic.encode_dataset(enc, ds)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        episodic.evaluate_cached(enc, ds, n_episodes=1, ep_per_batch=1,
                                 feats=torch.zeros(len(ds), 512))
    cfg = tmp_path / "c.yaml"
    cfg.write_text("dataset: synthetic\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--config", str(cfg)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        models.make("deepemd", encoder="visformer_micro_80")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        emd_eval.evaluate_emd(deepemd.DeepEMD(enc), ds, n_episodes=1, way=2, query=1)
    cfg.write_text("val_dataset: synthetic\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_emd.main(["--config", str(cfg)])
    # the two trainers: --device defaults to cuda and main raises before any work
    cfg.write_text("train_dataset: synthetic\n")
    for trainer in (meta_tune, meta_tune_emd, pretrain, sun):
        cfg_, args = runner.parse_args("x", ["--config", str(cfg), "--save-root", str(tmp_path)])
        assert args.device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer.main(cfg_, args)
    assert not any(p.is_dir() for p in tmp_path.iterdir())  # no run directory was made


ENC_ARGS = dict(use_pallas_attn=True, init_channels=16, embed_dim=96, depth=(1, 1, 1))


def _checkpoints(tmp_path, model, **kw):
    """A seeded head saved twice: as a port directory and as a reference
    ``.pth`` (SUN-D's ``params`` layout with ``module.`` prefixes)."""
    head = models.make(model, encoder="visformer_micro_80", encoder_args=ENC_ARGS,
                       device="cpu", seed=3, **kw)
    from fewshot_vit_tpu_torch.checkpoint import save_variables

    save_variables(str(tmp_path / "max-va"), head.state_dict(), {"model": model})
    torch.save({"params": {"module." + k: v for k, v in head.state_dict().items()}},
               str(tmp_path / "max_acc.pth"))
    return head


def test_cli_runs_on_cpu_and_refuses_checkpoints(tmp_path, capsys):
    """Seeded (with a warning), then ``load:`` a directory and the same
    weights as a ``.pth``: equal accuracies, with ``--int8`` too. A
    checkpoint of another width is refused, with ``--int8`` too (the weights
    load before they are quantized)."""
    cfg = tmp_path / "c.yaml"
    text = ("dataset: synthetic\n"
            "dataset_args: {n_classes: 5, n_per_class: 16, image_size: 80}\n"
            "encoder: visformer_micro_80\n"
            "model_args: {encoder_args: {use_pallas_attn: true, init_channels: 16,\n"
            "                            embed_dim: 96, depth: [1, 1, 1]}}\n")
    cfg.write_text(text)
    run.main(["--config", str(cfg), "--episodes", "1", "--fold-bn", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "test epoch 1: acc=" in out and "WARNING: no 'load'" in out
    _checkpoints(tmp_path, "meta-baseline")
    accs = {}
    for name in ("max-va", "max_acc.pth"):
        cfg.write_text(text + f"load: {tmp_path / name}\n")
        accs[name] = run.main(["--config", str(cfg), "--episodes", "8", "--fold-bn",
                               "--device", "cpu"])
        assert "WARNING" not in capsys.readouterr().out
    np.testing.assert_array_equal(accs["max-va"], accs["max_acc.pth"])
    int8 = run.main(["--config", str(cfg), "--episodes", "8", "--int8", "--device", "cpu"])
    assert int8.shape == (8,) and ((int8 >= 0) & (int8 <= 1)).all()
    cfg.write_text(text.replace("embed_dim: 96", "embed_dim: 48") + f"load: {tmp_path / 'max_acc.pth'}\n")
    with pytest.raises(ValueError, match="shape mismatch"):
        run.main(["--config", str(cfg), "--device", "cpu"])
    with pytest.raises(ValueError, match="shape mismatch"):
        run.main(["--config", str(cfg), "--int8", "--device", "cpu"])


@pytest.mark.parametrize("mode", ["grid", "fcn"])
def test_sund_cli_runs_on_cpu_and_refuses_checkpoints(tmp_path, capsys, mode):
    """Seeded, then ``load_encoder:`` a MetaBaseline directory and ``load:``
    the same encoder as a SUN-D ``.pth``: equal accuracies. A ``.pth``
    carrying a pretrain ``fc`` the eval head does not hold is refused."""
    cfg = tmp_path / "c.yaml"
    text = ("val_dataset: synthetic\n"
            "val_dataset_args: {n_classes: 5, n_per_class: 4, image_size: 80}\n"
            f"deepemd: {mode}\n"
            "way: 3\nquery: 1\nsolver: sinkhorn_pallas\nsolver_iters: 20\n"
            "model_args: {encoder: visformer_micro_80,\n"
            "             encoder_args: {use_pallas_attn: true, init_channels: 16,\n"
            "                            embed_dim: 96, depth: [1, 1, 1]}}\n")
    cfg.write_text(text)
    argv = ["--config", str(cfg), "--episodes", "2", "--ep-per-batch", "2", "--device", "cpu"]
    run_emd.main(argv)
    out = capsys.readouterr().out
    assert f"3-way 1-shot ({mode}): acc=" in out and "WARNING: no 'load'" in out
    _checkpoints(tmp_path, "meta-baseline")
    cfg.write_text(text + f"load_encoder: {tmp_path / 'max-va'}\n")
    from_dir = run_emd.main(argv)
    emd = _checkpoints(tmp_path, "deepemd")  # encoder entries only: the same encoder
    cfg.write_text(text + f"load: {tmp_path / 'max_acc.pth'}\n")
    from_pth = run_emd.main(argv)
    assert "WARNING" not in capsys.readouterr().out
    np.testing.assert_array_equal(from_dir, from_pth)
    torch.save({"params": dict(emd.state_dict(), **{"fc.weight": torch.zeros(4, 192),
                                                    "fc.bias": torch.zeros(4)})},
               str(tmp_path / "max_acc.pth"))
    with pytest.raises(ValueError, match="unconsumed torch tensors.*fc.bias"):
        run_emd.main(argv)


def test_entry_points_default_to_cuda():
    import inspect

    for fn in (episodic.evaluate, episodic.encode_dataset, episodic.evaluate_cached,
               meta_baseline.make_meta_baseline, deepemd.make_deepemd,
               emd_eval.evaluate_emd, classifier.make_classifier,
               token_label.make_token_label):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(Visformer).parameters["device"].default == "cuda"


def test_native_solver_builds_only_under_build():
    """``native/emd.py`` compiles its own copy of the simplex into
    ``build/native/`` at the root of the checkout, never into the JAX
    package's ``native/`` directory."""
    from fewshot_vit_tpu_torch.native import emd

    assert emd.SRC == ROOT / "fewshot_vit_tpu_torch" / "native" / "emd_solver.cpp"
    assert emd.BUILD_DIR == ROOT / "build" / "native" and emd.LIB.parent == emd.BUILD_DIR
    src = (ROOT / "fewshot_vit_tpu_torch" / "native" / "emd.py").read_text()
    assert "fewshot_vit_tpu/native" not in src.replace("``fewshot_vit_tpu/native/emd.py``", "")


def test_new_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from fewshot_vit_tpu_torch.eval import visualize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "c.yaml"
    cfg.write_text("dataset: synthetic\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        visualize.main(["--config", str(cfg), "--out", str(tmp_path / "v")])
    for name in ("meta-token", "token-label-ep"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.make(name, encoder="visformer_micro_80")
    assert not (tmp_path / "v").exists()
    from fewshot_vit_tpu_torch.eval import export

    for flags in ([], ["--platforms", "cuda"]):  # a card artifact is traced on the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export.main(["--config", str(cfg), "--out", str(tmp_path / "a.pt2")] + flags)
    assert not (tmp_path / "a.pt2").exists()


def test_the_rest_of_the_auxiliaries_refuse_by_name(tmp_path):
    """The mesh is ported: ``mesh:`` builds a ``parallel.Mesh`` when the
    world size is its size and refuses any other with JAX's words (one
    process here: only a size-1 mesh runs), ``distributed:`` is a no-op for
    one process, ``--mesh-data`` and ``eval.export --data-shards`` take the
    same checks; ``visualize_datasets:``, ``--int8`` and ``eval.export`` no
    longer refuse."""
    from fewshot_vit_tpu_torch.core.config import Config
    from fewshot_vit_tpu_torch.eval import export
    from fewshot_vit_tpu_torch.parallel.mesh import init_distributed

    with pytest.raises(ValueError, match=r"mesh \{'data': 4\} needs 4 devices, have 1"):
        runner.mesh_from_cfg(Config({"mesh": {"data": 4}}), "cpu")
    mesh = runner.mesh_from_cfg(Config({"mesh": {"data": 1, "model": 1}}), "cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device == torch.device("cpu")
    assert runner.mesh_from_cfg(Config({"visualize_datasets": True}), "cpu") is None
    assert init_distributed() == 1
    cfg = tmp_path / "c.yaml"
    cfg.write_text("dataset: synthetic\n")
    with pytest.raises(ValueError, match=r"mesh \{'data': 2\} needs 2 devices, have 1"):
        run.main(["--config", str(cfg), "--device", "cpu", "--mesh-data", "2"])
    with pytest.raises(ValueError, match="ep_per_batch=1 must divide over data_shards=2"):
        export.main(["--config", str(cfg), "--out", str(tmp_path / "a.pt2"), "--data-shards", "2",
                     "--device", "cpu"])
    assert not (tmp_path / "a.pt2").exists()
