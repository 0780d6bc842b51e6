"""The port stands alone: no module of ``fewshot_vit_tpu_torch`` nor
``chip_smoke.py`` imports JAX, flax or the JAX package, and the entry points
that default to the card raise without one."""

import ast
import pathlib

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
            "pretrain.py", "sun.py", "sam.py", "classifier.py", "token_label.py"} <= names
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


def test_cli_runs_on_cpu_and_refuses_checkpoints(tmp_path, capsys):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(
        "dataset: synthetic\n"
        "dataset_args: {n_classes: 5, n_per_class: 16, image_size: 80}\n"
        "encoder: visformer_micro_80\n"
        "model_args: {encoder_args: {use_pallas_attn: true, init_channels: 16,\n"
        "                            embed_dim: 96, depth: [1, 1, 1]}}\n")
    run.main(["--config", str(cfg), "--episodes", "1", "--fold-bn", "--device", "cpu"])
    assert "test epoch 1: acc=" in capsys.readouterr().out
    cfg.write_text("dataset: synthetic\nload: ./materials/max-va-1shot.pth\n")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run.main(["--config", str(cfg), "--device", "cpu"])


@pytest.mark.parametrize("mode", ["grid", "fcn"])
def test_sund_cli_runs_on_cpu_and_refuses_checkpoints(tmp_path, capsys, mode):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(
        "val_dataset: synthetic\n"
        "val_dataset_args: {n_classes: 5, n_per_class: 4, image_size: 80}\n"
        f"deepemd: {mode}\n"
        "way: 3\nquery: 1\nsolver: sinkhorn_pallas\nsolver_iters: 20\n"
        "model_args: {encoder: visformer_micro_80,\n"
        "             encoder_args: {use_pallas_attn: true, init_channels: 16,\n"
        "                            embed_dim: 96, depth: [1, 1, 1]}}\n")
    run_emd.main(["--config", str(cfg), "--episodes", "2", "--ep-per-batch", "2",
                  "--device", "cpu"])
    assert f"3-way 1-shot ({mode}): acc=" in capsys.readouterr().out
    cfg.write_text("val_dataset: synthetic\nload_encoder: ./save/sun_mini-imagenet/max-va\n")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_emd.main(["--config", str(cfg), "--device", "cpu"])


def test_entry_points_default_to_cuda():
    import inspect

    for fn in (episodic.evaluate, episodic.encode_dataset, episodic.evaluate_cached,
               meta_baseline.make_meta_baseline, deepemd.make_deepemd,
               emd_eval.evaluate_emd, classifier.make_classifier,
               token_label.make_token_label):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(Visformer).parameters["device"].default == "cuda"
