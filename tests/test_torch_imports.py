"""The port stands alone: no module of ``fewshot_vit_tpu_torch`` nor
``chip_smoke.py`` imports JAX, flax or the JAX package, and the entry points
that default to the card raise without one."""

import ast
import pathlib

import pytest
import torch

from fewshot_vit_tpu_torch.core.registry import models
from fewshot_vit_tpu_torch.data.datasets import synthetic
from fewshot_vit_tpu_torch.eval import episodic, run
from fewshot_vit_tpu_torch.heads import meta_baseline  # noqa: F401  (registers the heads)
from fewshot_vit_tpu_torch.models.visformer import Visformer

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
    assert {"chip_smoke.py", "visformer.py", "attention.py", "episodic.py"} <= names


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


def test_entry_points_default_to_cuda():
    import inspect

    for fn in (episodic.evaluate, episodic.encode_dataset, episodic.evaluate_cached,
               meta_baseline.make_meta_baseline):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(Visformer).parameters["device"].default == "cuda"
