"""The reference's ``utils`` names in one place (counterpart:
``fewshot_vit_tpu/utils/__init__.py``): the functions live in their
functional homes (``core``, ``ops``, ``train``) and are re-exported here
under the familiar names. The JAX package's ``epoch_key`` / ``root_key``
(PRNG keys) have ``core.rng.torch_generator`` as their counterpart."""

from ..core.log import Averager, RunLogger, Timer, compute_n_params, time_str
from ..core.rng import DEFAULT_SEED, np_rng, torch_generator
from ..ops.episodes import make_nk_label, split_shot_query
from ..ops.metric import (
    compute_acc,
    compute_acc_kshots,
    compute_logits,
    compute_logits_kshot,
    compute_logits_local_kshot,
    l2_normalize,
    mean_confidence_interval,
    roc_auc,
    softmax_kl_loss,
)
from ..train.optim import make_optimizer, zero_nan_grads
from ..train.state import ema_update

__all__ = [
    "Averager", "RunLogger", "Timer", "compute_n_params", "time_str",
    "DEFAULT_SEED", "np_rng", "torch_generator",
    "make_nk_label", "split_shot_query",
    "compute_acc", "compute_acc_kshots", "compute_logits",
    "compute_logits_kshot", "compute_logits_local_kshot", "l2_normalize",
    "mean_confidence_interval", "roc_auc", "softmax_kl_loss",
    "make_optimizer", "zero_nan_grads", "ema_update",
]
