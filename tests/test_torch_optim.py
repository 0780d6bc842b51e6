"""Port parity, optimizers and schedules: each per-epoch schedule against the
JAX package's optax schedule evaluated at every step, ``build_optimizer``
branch by branch, and five steps of each recipe on the same random gradients
against the optax chain."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fewshot_vit_tpu.core.config import load_config as j_load_config
from fewshot_vit_tpu.train import optim as jo
from fewshot_vit_tpu.train.meta_tune_emd import build_sund_optimizer as j_sund_optimizer
from fewshot_vit_tpu.train.runner import build_optimizer as j_build_optimizer
from fewshot_vit_tpu_torch.core.config import Config, load_config
from fewshot_vit_tpu_torch.train import optim as to
from fewshot_vit_tpu_torch.train.meta_tune_emd import build_sund_optimizer
from fewshot_vit_tpu_torch.train.runner import build_optimizer, model_dtype

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPE, EPOCHS = 3, 12  # steps per epoch, epochs compared
SHAPES = {"w": (4, 3), "b": (4,), "k": (2, 3, 3, 2), "temp": ()}


def _jax_lrs(sched):
    """The optax schedule at every step of EPOCHS epochs, (EPOCHS, SPE) float32."""
    return np.asarray([float(sched(s)) for s in range(SPE * EPOCHS)],
                      np.float32).reshape(EPOCHS, SPE)


def _check_schedule(port_sched, jax_sched, maxulp=0):
    want = _jax_lrs(jax_sched)
    assert (want == want[:, :1]).all()  # constant within an epoch
    got = np.asarray([port_sched.at(e) for e in range(EPOCHS)], np.float32)
    if maxulp:
        np.testing.assert_array_max_ulp(got, want[:, 0], maxulp=maxulp)
    else:
        np.testing.assert_array_equal(got, want[:, 0])  # exact in fp32


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "configs", "meta_tune_*.yaml"))),
                         ids=os.path.basename)
def test_meta_tune_config_schedules_match_jax(path):
    jcfg, cfg = j_load_config(path), load_config(path)
    params = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    # the optax chain hides its schedule: rebuild it the way build_optimizer does
    oargs = dict(jcfg.get("optimizer_args", {}) or {})
    opt = build_optimizer(cfg, [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES.values()])
    j_build_optimizer(jcfg, params, SPE)  # the JAX branch is taken without error
    if oargs.get("milestones"):
        warm = int(oargs.get("warmup_epochs", 0))
        gamma = float(oargs.get("gamma", 0.1))
        if warm:
            want = jo.timm_multistep_schedule(float(oargs["lr"]), SPE, int(jcfg.get("max_epoch")),
                                              oargs["milestones"], gamma=gamma, warmup_epochs=warm,
                                              warmup_lr=float(oargs.get("warmup_lr", 1e-5)))
        else:
            want = jo.multistep_schedule(float(oargs["lr"]), SPE, oargs["milestones"], gamma=gamma)
        _check_schedule(opt.schedule, want)
    else:
        assert opt.schedule is None and opt.lr == float(oargs.get("lr", 1e-3))


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "configs", "sund_*.yaml"))),
                         ids=os.path.basename)
def test_sund_config_schedules_match_jax(path):
    jcfg, cfg = j_load_config(path), load_config(path)
    step, epochs = int(jcfg.get("step_size", 10)), int(jcfg.get("max_epoch", 100))
    want = jo.multistep_schedule(float(jcfg.get("lr", 5e-4)), SPE,
                                 list(range(step, epochs + 1, step)),
                                 gamma=float(jcfg.get("gamma", 0.5)))
    opt = build_sund_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])
    _check_schedule(opt.schedule, want)
    assert len(opt.schedule) == epochs + 1 and opt.zero_nan
    group = opt.optimizer.param_groups[0]
    assert group["nesterov"] and group["momentum"] == 0.9 and group["weight_decay"] == 5e-4


@pytest.mark.parametrize("kw", [dict(warmup_epochs=0), dict(warmup_epochs=3, warmup_lr=1e-6),
                                dict(warmup_epochs=2, lr_min=1e-5)])
def test_cosine_schedule_matches_jax(kw):
    _check_schedule(to.timm_cosine_schedule(2e-3, 10, **kw),
                    jo.timm_cosine_schedule(2e-3, SPE, 10, **kw))


@pytest.mark.parametrize("gamma,milestones", [(0.1, [2, 5, 9]), (0.5, [1]), (0.3, [])])
def test_multistep_schedules_match_jax(gamma, milestones):
    if milestones:
        # exact for the configs' gamma 0.5; for a gamma that is no power of
        # two XLA rounds the product of factors another way: within 1 ulp
        _check_schedule(to.multistep_schedule(1e-3, milestones, gamma),
                        jo.multistep_schedule(1e-3, SPE, milestones, gamma),
                        maxulp=0 if gamma == 0.5 else 1)
    else:
        assert to.multistep_schedule(1e-3, milestones, gamma) == [np.float32(1e-3)]
    _check_schedule(to.timm_multistep_schedule(1e-3, 10, milestones or [4], gamma, 3, 1e-5),
                    jo.timm_multistep_schedule(1e-3, SPE, 10, milestones or [4], gamma, 3, 1e-5))


def test_epoch_schedule_last_value_persists():
    sched = to.EpochSchedule([3.0, 2.0, 1.0])
    assert [sched.at(e) for e in (0, 1, 2, 3, 99)] == [3.0, 2.0, 1.0, 1.0, 1.0]


@pytest.mark.parametrize("cfg,kind,sched_len", [
    ({"optimizer": "sgd", "optimizer_args": {"lr": 0.01}}, torch.optim.SGD, None),
    ({"optimizer": "sgd", "optimizer_args": {"lr": 0.01, "milestones": [2, 4], "gamma": 0.5}},
     torch.optim.SGD, 5),
    ({"optimizer": "sgd", "max_epoch": 6,
      "optimizer_args": {"lr": 0.01, "milestones": [2], "warmup_epochs": 3}}, torch.optim.SGD, 8),
    ({"optimizer": "adamw", "max_epoch": 6, "optimizer_args": {"lr": 0.01, "weight_decay": 0.05}},
     torch.optim.AdamW, 8),
    ({"optimizer": "adam", "optimizer_args": {"lr": 0.01, "schedule": "none"}},
     torch.optim.Adam, None),
    ({"optimizer": "sam", "max_epoch": 4,
      "optimizer_args": {"base": "adamw", "sam_rho": 0.05, "lr": 1e-3, "schedule": "cosine",
                         "warmup_epochs": 1}}, torch.optim.AdamW, 6),
    ({"optimizer": "sam", "optimizer_args": {"lr": 0.1}}, torch.optim.SGD, None),
])
def test_build_optimizer_branches(cfg, kind, sched_len):
    params = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES.values()]
    opt = build_optimizer(Config(cfg), params)
    assert type(opt.optimizer) is kind
    assert (opt.schedule is None) if sched_len is None else len(opt.schedule) == sched_len
    assert opt.params == params
    if kind is torch.optim.SGD:
        assert opt.optimizer.param_groups[0]["momentum"] == 0.9
    j_build_optimizer(j_load_cfg(cfg), {k: jnp.zeros(s) for k, s in SHAPES.items()}, SPE)


def j_load_cfg(data):
    from fewshot_vit_tpu.core.config import Config as JConfig

    return JConfig(data)


def test_build_optimizer_scale_lr_mask_decay_and_unknown():
    params = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES.values()]
    opt = build_optimizer(Config({"optimizer": "adamw", "max_epoch": 2, "optimizer_args": {
        "lr": 1e-3, "scale_lr_by_batch": True, "schedule": "none", "weight_decay": 0.1,
        "mask_decay": True, "grad_clip": 1.0}}), params, batch_size=1024)
    assert opt.lr == pytest.approx(2e-3) and opt.grad_clip == 1.0
    decayed, plain = opt.optimizer.param_groups
    assert [tuple(p.shape) for p in decayed["params"]] == [(4, 3), (2, 3, 3, 2)]
    assert decayed["weight_decay"] == 0.1 and plain["weight_decay"] == 0.0
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer(Config({"optimizer": "lamb"}), params)
    assert model_dtype(Config({"model_args": {"dtype": "bf16"}})) is torch.bfloat16
    with pytest.raises(ValueError, match="expected one of"):
        model_dtype(Config({"model_args": {"dtype": "fp8"}}))


def test_zero_nan_tensor_zeroes_the_whole_tensor():
    g = torch.tensor([[1.0, float("nan")], [3.0, 4.0]])
    assert not to.zero_nan_tensor(g).any()
    clean = torch.tensor([1.0, float("inf")])
    assert torch.equal(to.zero_nan_tensor(clean), clean)
    np.testing.assert_array_equal(to.zero_nan_tensor(g).numpy(),
                                  np.asarray(jo.zero_nan_tensor(jnp.asarray(g.numpy()))))


def _grads(step, nan_in=None):
    rng = np.random.default_rng(100 + step)
    out = {k: np.asarray(rng.normal(size=s) * 3, np.float32) for k, s in SHAPES.items()}
    if nan_in is not None:
        out[nan_in] = out[nan_in].copy()
        out[nan_in].reshape(-1)[0] = np.nan
    return out


def _run_both(port_opt_fn, tx, nan_step=None, set_epochs=None):
    rng = np.random.default_rng(7)
    init = {k: np.asarray(rng.normal(size=s), np.float32) for k, s in SHAPES.items()}
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = tx.init(j_params)
    t_params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in init.items()}
    opt = port_opt_fn(list(t_params.values()))
    for step in range(5):
        grads = _grads(step, "k" if step == nan_step else None)
        updates, j_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                     j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        if set_epochs:
            opt.set_epoch(step // set_epochs)
        for k, p in t_params.items():
            p.grad = torch.tensor(grads[k])
        opt.step()
        for k, p in t_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j_params[k]),
                                       rtol=0, atol=1e-6, err_msg=f"{k} at step {step}")


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("extra", [{}, {"grad_clip": 0.5}, {"mask_decay": True}],
                         ids=["plain", "grad_clip", "mask_decay"])
def test_five_steps_of_each_recipe_match_optax(name, extra):
    """Within 1e-6 absolute on parameters of order 1, lr 0.01, gradients of
    order 3; ``grad_clip`` 0.5 is far below the gradients' norm, so it acts."""
    kw = dict(lr=0.01, weight_decay=0.05, **extra)
    j_params = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    _run_both(lambda ps: to.make_optimizer(ps, name, **kw),
              jo.make_optimizer(j_params, name, **kw))


def test_scheduled_sgd_matches_optax_across_a_milestone():
    sched_j = jo.multistep_schedule(0.05, 2, [1, 2], 0.5)  # 2 steps per epoch
    j_params = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    _run_both(lambda ps: to.make_optimizer(ps, "sgd", lr=0.05, weight_decay=5e-4,
                                           schedule=to.multistep_schedule(0.05, [1, 2], 0.5)),
              jo.make_optimizer(j_params, "sgd", lr=0.05, weight_decay=5e-4, schedule=sched_j),
              set_epochs=2)


def test_sund_nesterov_with_the_nan_rule_matches_optax():
    """A NaN planted in one tensor at step 2: that tensor's gradient is zeroed
    whole (weight decay and momentum still move it), the others are untouched."""
    cfg = {"lr": 0.02, "step_size": 1, "gamma": 0.5, "max_epoch": 3, "weight_decay": 5e-4}
    _run_both(lambda ps: build_sund_optimizer(Config(cfg), ps),
              j_sund_optimizer(j_load_cfg(cfg), 2), nan_step=2, set_epochs=2)
