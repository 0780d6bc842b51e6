"""Multi-process parallelism over ``torch.distributed`` (counterpart:
``fewshot_vit_tpu/parallel``): the mesh, its slicing rules and its
collectives."""

from .mesh import (
    Mesh,
    barrier,
    batch_sharding,
    episode_shardings,
    init_distributed,
    is_main_process,
    make_mesh,
    param_shardings,
    replicated,
    use_mesh,
)

__all__ = [
    "Mesh",
    "barrier",
    "batch_sharding",
    "episode_shardings",
    "init_distributed",
    "is_main_process",
    "make_mesh",
    "param_shardings",
    "replicated",
    "use_mesh",
]
