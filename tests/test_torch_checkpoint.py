"""The port's checkpoint format: save / has / load bit for bit, the atomic
swap's crash window, ``CheckpointPolicy``'s three kinds of directories, the
encoder loader over a directory and a reference ``.pth``, and the train
state's round trip."""

import json
import os

import pytest
import torch

from fewshot_vit_tpu_torch.checkpoint import (
    CheckpointPolicy,
    has_checkpoint,
    load_variables,
    save_variables,
)
from fewshot_vit_tpu_torch.core.config import Config, load_config
from fewshot_vit_tpu_torch.core.log import Averager, RunLogger, Timer, compute_n_params, time_str
from fewshot_vit_tpu_torch.heads.meta_baseline import MetaBaseline
from fewshot_vit_tpu_torch.models.resnet12 import ResNet12
from fewshot_vit_tpu_torch.models.visformer import Visformer
from fewshot_vit_tpu_torch.train.optim import make_optimizer
from fewshot_vit_tpu_torch.train.runner import load_encoder_from_checkpoint
from fewshot_vit_tpu_torch.train.state import TrainState

TINY = dict(img_size=32, init_channels=8, embed_dim=48, depth=(1, 1, 1), num_heads=6)


def _head(seed):
    return MetaBaseline(Visformer(**TINY, device="cpu", seed=seed))


def test_save_has_load_bit_for_bit(tmp_path):
    head = _head(1)
    with torch.no_grad():
        head.encoder.norm.bn.running_mean.normal_()
    path = str(tmp_path / "ckpt")
    assert not has_checkpoint(path)
    with pytest.raises(FileNotFoundError):
        load_variables(path)
    save_variables(path, head.state_dict(), {"model": "meta-baseline", "epoch": 3})
    assert has_checkpoint(path) and sorted(os.listdir(path)) == ["arrays.pt", "meta.json"]
    saved, meta = load_variables(path)
    assert meta == {"model": "meta-baseline", "epoch": 3}
    fresh = _head(2)
    assert not torch.equal(fresh.encoder.pos_embed1, head.encoder.pos_embed1)
    fresh.load_state_dict(saved, strict=True)
    for (k, a), (_, b) in zip(fresh.state_dict().items(), head.state_dict().items()):
        assert torch.equal(a, b), k
    assert not os.path.exists(path + ".tmp") and not os.path.exists(path + ".old")


def test_interrupted_swap_is_recovered(tmp_path):
    path = str(tmp_path / "resume")
    save_variables(path, {"w": torch.ones(2)}, {"epoch": 1})
    os.rename(path, path + ".old")  # a crash between the two renames
    assert has_checkpoint(path)
    saved, meta = load_variables(path)
    assert meta["epoch"] == 1 and torch.equal(saved["w"], torch.ones(2))
    save_variables(path, {"w": torch.zeros(2)}, {"epoch": 2})  # promotes .old back first
    saved, meta = load_variables(path)
    assert meta["epoch"] == 2 and not saved["w"].any() and not os.path.exists(path + ".old")


def test_checkpoint_policy_directories(tmp_path):
    policy = CheckpointPolicy(str(tmp_path), save_epoch=2)
    for epoch, va in ((1, 0.5), (2, 0.4), (3, 0.7), (4, 0.6)):
        policy.on_epoch(epoch, {"w": torch.full((1,), float(epoch))}, {"model": "deepemd"}, va=va)
    assert sorted(os.listdir(tmp_path)) == ["epoch-2", "epoch-4", "epoch-last", "max-va"]
    assert load_variables(str(tmp_path / "epoch-last"))[1]["epoch"] == 4
    best, meta = load_variables(str(tmp_path / "max-va"))
    assert meta == {"model": "deepemd", "epoch": 3, "val_acc": 0.7} and best["w"].item() == 3.0
    # a resumed run does not overwrite the best checkpoint with a worse epoch
    again = CheckpointPolicy(str(tmp_path))
    assert again.best_va == 0.7
    again.on_epoch(5, {"w": torch.zeros(1)}, {}, va=0.65)
    assert load_variables(str(tmp_path / "max-va"))[1]["epoch"] == 3
    assert not (tmp_path / "epoch-5").exists()


def test_load_encoder_from_checkpoint_and_pth_refusal(tmp_path):
    """A directory and a reference ``.pth`` load (head entries dropped); a
    ``.pth`` with an entry the encoder does not hold, or one named for an
    encoder family without a key rule, is refused."""
    head = _head(3)
    save_variables(str(tmp_path / "max-va"), head.state_dict(), {})
    enc = Visformer(**TINY, device="cpu", seed=4)
    load_encoder_from_checkpoint(str(tmp_path / "max-va"), enc)  # head keys and temp dropped
    assert torch.equal(enc.pos_embed2, head.encoder.pos_embed2)
    save_variables(str(tmp_path / "bare"), enc.state_dict(), {})
    enc2 = Visformer(**TINY, device="cpu", seed=5)
    load_encoder_from_checkpoint(str(tmp_path / "bare"), enc2)
    assert torch.equal(enc2.stem.conv1.weight, enc.stem.conv1.weight)
    sd = dict(head.state_dict(), **{"classifier.linear.weight": torch.ones(3, 96)})
    torch.save({"model": "classifier", "model_sd": sd}, str(tmp_path / "teacher.pth"))
    enc3 = load_encoder_from_checkpoint(str(tmp_path / "teacher.pth"),
                                        Visformer(**TINY, device="cpu", seed=6),
                                        "visformer_micro_80")
    for k, v in head.encoder.state_dict().items():
        assert torch.equal(enc3.state_dict()[k], v), k
    saved, meta = load_variables(str(tmp_path / "teacher.pth"))
    assert meta == {"model": "classifier"} and torch.equal(saved["temp"], head.temp.detach())
    bad = {k: v for k, v in sd.items() if k.startswith("encoder.")}
    bad["encoder.extra.weight"] = torch.zeros(1)
    torch.save(bad, str(tmp_path / "bad.pth"))
    with pytest.raises(ValueError, match="unconsumed torch tensors"):
        load_encoder_from_checkpoint(str(tmp_path / "bad.pth"), enc)
    # a ResNet-12 teacher's .pth loads through its family's rule
    res = ResNet12(channels=(4, 8, 8, 8), device="cpu", seed=1)
    torch.save({"model": "classifier", "model_sd": {
        **{f"encoder.{k}": v for k, v in res.state_dict().items()},
        "encoder.layer1.bn1.num_batches_tracked": torch.tensor(3),
        "classifier.linear.weight": torch.ones(3, 8)}}, str(tmp_path / "resnet12.pth"))
    res2 = load_encoder_from_checkpoint(str(tmp_path / "resnet12.pth"),
                                        ResNet12(channels=(4, 8, 8, 8), device="cpu", seed=2),
                                        "resnet12")
    for k, v in res.state_dict().items():
        assert torch.equal(res2.state_dict()[k], v), k


def test_train_state_round_trip_with_ema(tmp_path):
    head = _head(6)
    state = TrainState(head, make_optimizer(head.parameters(), "sgd", lr=0.1), ema=True)
    loss = head.encoder(torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(0)))[1]
    loss.sum().backward()
    state.optimizer.step()
    state.step = 1
    state.ema_update(0.5)
    name, p = "encoder.pos_embed1", head.encoder.pos_embed1
    assert not torch.equal(state.ema_params[name], p)  # halfway between old and new
    save_variables(str(tmp_path / "resume"), state.state_dict(), {"epoch": 1})
    saved, _ = load_variables(str(tmp_path / "resume"))
    other = _head(7)
    restored = TrainState(other, make_optimizer(other.parameters(), "sgd", lr=0.1), ema=True)
    restored.load_state_dict(saved)
    assert restored.step == 1
    assert torch.equal(restored.ema_params[name], state.ema_params[name])
    for (k, a), (_, b) in zip(other.state_dict().items(), head.state_dict().items()):
        assert torch.equal(a, b), k
    buf = lambda s: next(iter(s.optimizer.state_dict()["state"].values()))["momentum_buffer"]
    assert torch.equal(buf(restored), buf(state))
    assert sorted(state.variables) == sorted(head.state_dict())


def test_config_and_logging_helpers(tmp_path, capsys):
    cfg = Config({"a": {"b": 1}, "c": 2})
    new = cfg.updated({"a.b": 5, "a.d.e": 6, "f": 7})
    assert new.to_dict() == {"a": {"b": 5, "d": {"e": 6}}, "c": 2, "f": 7}
    assert cfg.get("a.b") == 1  # the original is untouched
    with pytest.raises(ValueError, match="scalar"):
        cfg.updated({"c.x": 1})
    new.dump_yaml(str(tmp_path / "c.yaml"))
    assert load_config(str(tmp_path / "c.yaml")).to_dict() == new.to_dict()
    assert load_config(str(tmp_path / "c.yaml"), {"c": 9}).get("c") == 9

    logger = RunLogger(str(tmp_path / "run"))
    logger.log("hello")
    logger.metrics(3, loss=torch.tensor(0.5), acc=1)
    assert "hello" in capsys.readouterr().out
    assert (tmp_path / "run" / "log.txt").read_text() == "hello\n"
    rec = json.loads((tmp_path / "run" / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 0.5 and rec["acc"] == 1.0
    avg = Averager()
    avg.add(1.0)
    avg.add(3.0, 3)
    assert avg.item() == 2.5 and Timer().t() >= 0
    assert [time_str(t) for t in (5, 90, 7200)] == ["5.0s", "1.5m", "2.0h"]
    head = _head(0)
    n = sum(p.numel() for p in head.parameters())
    assert compute_n_params(head, return_str=False) == n
    assert compute_n_params(head) == f"{n / 1e3:.1f}K"
