"""Model export for serving (counterpart: ``fewshot_vit_tpu/eval/export.py``),
as ``torch.export`` programs.

The eval forward is traced once into an ``ExportedProgram`` with the
weights baked in and uint8 normalization included; a serving process loads
the ``.pt2`` file and calls it with no model code. The hand-written
kernels are the ops ``fewshot_vit_tpu_torch::fused_mhsa``,
``::sinkhorn_pallas`` and ``::window_attention`` (``kernels/``): the program
calls them by name, so the serving process imports
``fewshot_vit_tpu_torch.kernels`` to register them
(``load_exported`` does), and each op picks its implementation from the
tensors' device when the program runs: the CUDA kernel on the card, the
plain version on the CPU. Without the registrations loading raises.

Three artifacts, with the JAX package's signatures and contract (uint8 in,
float32 out):

* **episode scorer**: ``(x_shot (E, way, shot, H, W, 3), x_query (E,
  way*query, H, W, 3)) -> (E, way*query, way)`` cosine logits;
* **EMD episode scorer** (``--emd``): ``images (E, way*(shot+query), H, W,
  3)`` in the interleaved layout -> ``(E, way*query, way)`` EMD logits, patch
  pipeline, encoder, SFC (shot > 1, written without autograd:
  ``heads/deepemd.py::sfc_refine_explicit``) and the matching in one
  program. The SFC shuffles of episode e are ``sfc_perms`` of ``seed`` and
  e, baked in (JAX bakes its key): the same logits at every call;
* **encoder**: ``images (B, H, W, 3) -> (B, C)`` pooled embeddings.

``platforms`` is the counterpart of JAX's multi-platform export: ``("cpu",
"cuda")`` traces on the CPU and ``load_exported(..., device="cuda")`` moves
the program to the card (``move_to_device_pass``); a single platform traces
on that device and loads only there. ``solver: exact`` is refused, as
JAX's export refuses its host callback.

``data_shards=N`` builds an N-rank artifact, exportable from one process
(JAX's ``AbstractMesh`` export): the program takes the whole batch and a
0-d ``shard`` index, and scores only that shard's contiguous block of the
episode (or batch) axis, with that block's baked SFC shuffles and crops.
``serve`` runs it under a mesh of N ``data`` ranks, each rank its own
block through the custom ops, and gathers the full result on every rank;
``load_exported`` refuses an N-shard artifact outside such a mesh, as JAX's
needs its N devices. The artifact records ``data_shards`` in its
``extra_files``.

CLI::

  python -m fewshot_vit_tpu_torch.eval.export --config C.yaml --out scorer.pt2 \\
      --shot 1 [--encoder-only | --emd] [--platforms cpu,cuda] [--data-shards N] \\
      [--device cpu]

Serving side (imports torch and the kernels' registrations only)::

  import torch, fewshot_vit_tpu_torch.kernels
  prog = torch.export.load("scorer.pt2").module()    # traced on that device
  logits = prog(x_shot_u8, x_query_u8)
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from ..data.transforms import MEAN, STD, normalize

PLATFORMS = ("cpu", "cuda")


def _trace_device(platforms: Optional[Sequence[str]], module: nn.Module) -> Tuple[
        torch.device, Tuple[str, ...]]:
    """(device to trace on, platforms recorded in the artifact): the module's
    device without ``platforms``; the CPU when the CPU is among them."""
    if not platforms:
        dev = next(module.parameters()).device
        return dev, (dev.type,)
    plats = tuple(dict.fromkeys(str(p).lower() for p in platforms))
    for p in plats:
        if p not in PLATFORMS:
            raise ValueError(f"platform {p!r}: expected some of {PLATFORMS}")
    return resolve_device("cpu" if "cpu" in plats else "cuda"), plats


def _check_shards(n: int, data_shards: int, what: str) -> None:
    if data_shards and n % data_shards:
        raise ValueError(f"{what}={n} must divide over data_shards={data_shards}")


def _block(x: torch.Tensor, shards: int, shard: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Block ``shard`` of ``shards`` contiguous blocks of ``x`` along ``dim``."""
    shape = x.shape
    x = x.reshape(*shape[:dim], shards, shape[dim] // shards, *shape[dim + 1:])
    return torch.index_select(x, dim, shard.reshape(1)).squeeze(dim)


def _on(module: nn.Module, dev: torch.device) -> nn.Module:
    """``module`` if it lives on ``dev``, else a copy moved there (the
    caller's module stays where it is)."""
    if next(module.parameters()).device == dev:
        return module
    return copy.deepcopy(module).to(dev)


def _export(module: nn.Module, example: Tuple[torch.Tensor, ...], dev: torch.device,
            platforms: Tuple[str, ...], data_shards: int = 0) -> torch.export.ExportedProgram:
    module.eval()
    if data_shards:
        example = example + (torch.zeros((), dtype=torch.int64),)
    with torch.no_grad():
        ep = torch.export.export(module, tuple(x.to(dev) for x in example))
    ep.platforms = platforms  # read by save_exported
    ep.traced_on = dev.type
    ep.data_shards = data_shards
    return ep


def _u8(*shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.uint8)


class _EpisodeScorer(nn.Module):
    def __init__(self, head, mean, std, shards: int = 0):
        super().__init__()
        self.head, self.mean, self.std, self.shards = head, mean, std, shards

    def forward(self, x_shot, x_query, shard=None):
        if self.shards:
            x_shot, x_query = (_block(x, self.shards, shard) for x in (x_shot, x_query))
        return self.head(normalize(x_shot, self.mean, self.std),
                         normalize(x_query, self.mean, self.std))


class _Encoder(nn.Module):
    def __init__(self, encoder, mean, std, shards: int = 0):
        super().__init__()
        self.encoder, self.mean, self.std, self.shards = encoder, mean, std, shards

    def forward(self, images, shard=None):
        if self.shards:
            images = _block(images, self.shards, shard)
        return self.encoder(normalize(images, self.mean, self.std))[1].float()


class _EmdEpisodeScorer(nn.Module):
    def __init__(self, head, episode_fn, n_episodes: int, perms, draws, seed: int,
                 shards: int = 0):
        super().__init__()
        self.head, self.shards = head, shards
        self.episode_fn, self.n_episodes, self.draws, self.seed = episode_fn, n_episodes, draws, seed
        self.register_buffer("perms", perms)

    def forward(self, images, shard=None):
        perms, draws, n = self.perms, dict(self.draws), self.n_episodes
        if self.shards:  # this shard's episodes, with their shuffles and crops
            images = _block(images, self.shards, shard)
            n //= self.shards
            if perms is not None:
                perms = _block(perms, self.shards, shard)
            if "uniforms" in draws:
                draws["uniforms"] = _block(draws["uniforms"], self.shards, shard, dim=2)
        return self.episode_fn(images, list(range(n)), key=(self.seed, 0), perms=perms,
                               **draws)


def export_episode_scorer(head, *, way: int, shot: int, query: int, image_size: int,
                          ep_per_batch: int = 1, mean=MEAN, std=STD,
                          platforms: Optional[Sequence[str]] = None,
                          data_shards: int = 0) -> torch.export.ExportedProgram:
    """Export the episodic decision function of ``head`` (a MetaBaseline)
    with its weights baked in: ``x_shot (E, way, shot, H, W, 3)`` and
    ``x_query (E, way*query, H, W, 3)`` uint8, normalized with the stats
    captured here, -> ``(E, way*query, way)`` float32 cosine logits, the
    forward ``eval.episodic.evaluate`` runs per episode batch. ``data_shards``:
    an N-rank artifact (``serve``), ``ep_per_batch % N == 0``."""
    _check_shards(ep_per_batch, data_shards, "ep_per_batch")
    dev, plats = _trace_device(platforms, head)
    example = (_u8(ep_per_batch, way, shot, image_size, image_size, 3),
               _u8(ep_per_batch, way * query, image_size, image_size, 3))
    return _export(_EpisodeScorer(_on(head, dev), mean, std, data_shards), example, dev, plats,
                   data_shards)


def export_encoder(encoder, *, image_size: int, batch: int = 128, mean=MEAN, std=STD,
                   platforms: Optional[Sequence[str]] = None,
                   data_shards: int = 0) -> torch.export.ExportedProgram:
    """Export ``uint8 images (B, H, W, 3) -> (B, C)`` float32 pooled
    embeddings; ``data_shards``: an N-rank artifact, ``batch % N == 0``."""
    _check_shards(batch, data_shards, "batch")
    dev, plats = _trace_device(platforms, encoder)
    return _export(_Encoder(_on(encoder, dev), mean, std, data_shards),
                   (_u8(batch, image_size, image_size, 3),), dev, plats, data_shards)


def export_emd_episode_scorer(head, *, way: int, shot: int, query: int, image_size: int,
                              patch_fn, sfc_kw=None, ep_per_batch: int = 1, mean=MEAN,
                              std=STD, platforms: Optional[Sequence[str]] = None,
                              data_shards: int = 0, seed: int = 0,
                              perms: Optional[torch.Tensor] = None,
                              draws: Optional[dict] = None) -> torch.export.ExportedProgram:
    """Export the SUN-D DeepEMD episodic decision function of ``head``:
    ``images (E, way*(shot+query), H, W, 3)`` uint8, interleaved (index
    ``t*way + w`` is class w, item t; items below ``shot`` are supports) ->
    ``(E, way*query, way)`` float32 EMD logits, the eval-mode forward of
    ``train.meta_tune_emd.make_emd_episode_fn``.

    For shot > 1 the SFC shuffles are ``perms`` (E, steps, way*shot) when
    given, else ``sfc_perms(range(E), steps, way*shot, seed)``, baked as a
    buffer. ``draws`` (the patch function's ``ratios=`` / ``uniforms=``)
    are baked the same way, as a ``sampling`` artifact's crops must be.
    ``data_shards``: an N-rank artifact, ``ep_per_batch % N == 0``; each
    shard takes its episodes' shuffles and crops."""
    _check_shards(ep_per_batch, data_shards, "ep_per_batch")
    if head.solver == "exact":
        raise NotImplementedError(
            "solver 'exact' runs the C++ simplex on the host, which an exported program "
            "cannot call (JAX's export refuses its host callback the same way); export "
            "with solver 'sinkhorn_pallas' or 'sinkhorn_detached'")
    from ..heads.deepemd import sfc_perms
    from ..train.meta_tune_emd import make_emd_episode_fn

    sfc_kw = dict(sfc_kw or {})
    if shot > 1 and perms is None:
        perms = sfc_perms(range(ep_per_batch), int(sfc_kw.get("steps", 100)), way * shot, seed)
    dev, plats = _trace_device(platforms, head)
    head = _on(head, dev)
    ep_fn = make_emd_episode_fn(head, way, shot, query, patch_fn, mean, std, sfc=shot > 1,
                                sfc_kw=sfc_kw, seed=seed, explicit_sfc=True)
    module = _EmdEpisodeScorer(head, ep_fn, ep_per_batch, perms, dict(draws or {}), seed,
                               data_shards)
    example = (_u8(ep_per_batch, way * (shot + query), image_size, image_size, 3),)
    return _export(module, example, dev, plats, data_shards)


def save_exported(exported: torch.export.ExportedProgram, path: str) -> None:
    """Write the program to a ``.pt2`` file with its platforms and shards."""
    extra = {"platforms": ",".join(exported.platforms), "traced_on": exported.traced_on,
             "data_shards": str(getattr(exported, "data_shards", 0))}
    torch.export.save(exported, path, extra_files=extra)


def load_exported(path: str, device="cuda", mesh=None) -> torch.export.ExportedProgram:
    """Load a ``.pt2`` written by ``save_exported`` for ``device``.

    Registers the kernels' ops first (imports ``fewshot_vit_tpu_torch.
    kernels``). A program traced on another device than ``device`` is moved
    there when ``device`` is among its platforms, and refused otherwise:
    a CPU-only artifact never serves a request for the card. An N-shard
    artifact loads only under ``mesh``, a ``parallel.Mesh`` of N ``data``
    ranks, and is called through ``serve``."""
    from .. import kernels  # noqa: F401  (registers the two ops)

    extra = {"platforms": "", "traced_on": "", "data_shards": ""}
    ep = torch.export.load(path, extra_files=extra)
    shards = int(extra["data_shards"] or 0)
    have = mesh.size("data") if mesh is not None else 0
    if shards and have != shards:
        raise ValueError(f"{path} is a {shards}-shard artifact: it serves under a mesh of "
                         f"{shards} data ranks, have {have or 'no mesh'}")
    plats = tuple(p for p in extra["platforms"].split(",") if p)
    if torch.device(device).type not in plats:
        raise ValueError(f"{path} was exported for {plats}, not for {torch.device(device).type}")
    dev = resolve_device(device)
    if dev.type != extra["traced_on"]:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, dev)
    ep.platforms, ep.traced_on, ep.data_shards = plats, extra["traced_on"], shards
    return ep


def serve(exported: torch.export.ExportedProgram, *inputs: torch.Tensor, mesh=None):
    """Call a loaded artifact. An N-shard one runs this rank's block of the
    leading axis of ``inputs`` (the whole batch, the same on every rank)
    and returns every rank's blocks gathered in order: the unsharded
    artifact's result, on every rank. The callable module is built at the
    first call and kept on ``exported``."""
    module = getattr(exported, "served_module", None)
    if module is None:
        module = exported.served_module = exported.module()
    shards = getattr(exported, "data_shards", 0)
    if not shards:
        return module(*inputs)
    shard = torch.tensor(mesh.index("data"), device=inputs[0].device)
    return mesh.gather(module(*inputs, shard))


def main(argv=None) -> torch.export.ExportedProgram:
    """Run the CLI; returns the program it wrote."""
    p = argparse.ArgumentParser(description="export a serving artifact (torch.export)")
    p.add_argument("--config", required=True, help="eval config (same schema as eval.run)")
    p.add_argument("--out", required=True, help="output artifact path (.pt2)")
    p.add_argument("--way", type=int, default=5)
    p.add_argument("--shot", type=int, default=1)
    p.add_argument("--query", type=int, default=15)
    p.add_argument("--ep-per-batch", type=int, default=1)
    p.add_argument("--encoder-only", action="store_true",
                   help="export images->embeddings instead of the episode scorer")
    p.add_argument("--emd", action="store_true",
                   help="export the SUN-D DeepEMD episode scorer instead (config uses "
                        "the eval.run_emd schema: deepemd, patch_list, temperature, ...)")
    p.add_argument("--batch", type=int, default=128,
                   help="encoder artifact batch size (--encoder-only)")
    p.add_argument("--platforms", default="",
                   help="comma list, e.g. 'cpu,cuda' for an artifact traced on the CPU "
                        "that also serves on the card (default: --device)")
    p.add_argument("--data-shards", type=int, default=0,
                   help="build an N-rank artifact: episode/batch axis sharded over an N-way "
                        "data mesh (exportable from one process; served by eval.export.serve)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 encoder compute inside the artifact")
    p.add_argument("--fold-bn", action="store_true",
                   help="fold frozen-stats BNs into the baked weights (exact; "
                        "models/fold.py; supported encoder families only)")
    p.add_argument("--device", default="cuda",
                   help="device to load the weights and trace on when --platforms is empty")
    args = p.parse_args(argv)
    if args.encoder_only:  # before anything is built, as the export functions check it
        _check_shards(args.batch, args.data_shards, "batch")
    else:
        _check_shards(args.ep_per_batch, args.data_shards, "ep_per_batch")

    from ..core import rng as rng_mod
    from ..core.config import load_config
    from ..core.registry import datasets, models
    from ..data import datasets as _datasets  # noqa: F401  (registers the datasets)
    from ..heads import deepemd as _deepemd  # noqa: F401  (registers the heads)
    from ..train.runner import resolve_checkpoint
    from .run import load_model_for_eval

    platforms = [s for s in args.platforms.split(",") if s]
    # the weights load where the program is traced
    dev = _trace_device(platforms, None)[0] if platforms else resolve_device(args.device)
    cfg = load_config(args.config)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.emd:
        if args.fold_bn:
            p.error("--fold-bn is not supported with --emd (the DeepEMD head keeps its "
                    "own encoder wrapper)")
        enc_name = cfg.get("model_args.encoder", "visformer_micro_80")
        head = models.make(
            "deepemd", encoder=enc_name,
            encoder_args=dict(cfg.get("model_args.encoder_args", {}) or {}),
            temperature=float(cfg.get("temperature", 12.5)),
            solver_reg=float(cfg.get("solver_reg", 0.05)),
            solver_iters=int(cfg.get("solver_iters", 100)),
            solver=cfg.get("solver", "sinkhorn_detached"),
            feature_pyramid=cfg.get("feature_pyramid"),
            dtype=dtype, device=dev, seed=rng_mod.DEFAULT_SEED)
        resolve_checkpoint(cfg, head, enc_name)
    else:
        head = load_model_for_eval(cfg, dtype=dtype, device=dev)
        if args.fold_bn:
            from ..models.fold import fold_encoder_in_head

            head = fold_encoder_in_head(head)
    # the dataset stats are baked into the artifact's normalize; export does
    # not otherwise need the data, so a dataset that cannot be loaded falls
    # back to the ImageNet stats (every loader but cifar-fs uses them)
    ds_key = "test_dataset" if cfg.get("test_dataset") else "dataset"
    try:
        ds = datasets.make(cfg.get(ds_key, "mini-imagenet"),
                           **dict(cfg.get(ds_key + "_args", {}) or {}))
        ds_mean, ds_std = ds.mean, ds.std
    except (FileNotFoundError, OSError) as e:
        print(f"note: dataset not loadable ({e}); baking default "
              f"ImageNet mean/std into the artifact")
        ds_mean, ds_std = MEAN, STD
    img = int(cfg.get("image_size", 80))
    if args.emd:
        from ..train.meta_tune_emd import make_patch_fn

        mode = cfg.get("deepemd", "grid")
        patch_fn = make_patch_fn(mode, cfg.get("patch_list", [2, 3]),
                                 float(cfg.get("patch_ratio", 2.0)), img, False,
                                 int(cfg.get("num_patch", 9)))
        draws = {}
        if mode == "sampling":  # the crops are fixed at export, as JAX's baked key fixes them
            from ..core.rng import torch_generator

            n_images = args.ep_per_batch * args.way * (args.shot + args.query)
            draws["uniforms"] = torch.rand(int(cfg.get("num_patch", 9)), 4, n_images,
                                           generator=torch_generator("cpu", 0, 0, 1))
        # the standalone eval's SFC learning rate is 100, as eval.run_emd's
        sfc_kw = {"steps": int(cfg.get("sfc_update_step", 100)),
                  "lr": float(cfg.get("sfc_lr", 100.0)),
                  "batch_size": int(cfg.get("sfc_bs", 4))}
        exp = export_emd_episode_scorer(
            head, way=args.way, shot=args.shot, query=args.query, image_size=img,
            patch_fn=patch_fn, sfc_kw=sfc_kw, ep_per_batch=args.ep_per_batch,
            mean=ds_mean, std=ds_std, platforms=platforms, draws=draws,
            data_shards=args.data_shards)
    elif args.encoder_only:
        exp = export_encoder(head.encoder, image_size=img, batch=args.batch,
                             mean=ds_mean, std=ds_std, platforms=platforms,
                             data_shards=args.data_shards)
    else:
        exp = export_episode_scorer(head, way=args.way, shot=args.shot, query=args.query,
                                    image_size=img, ep_per_batch=args.ep_per_batch,
                                    mean=ds_mean, std=ds_std, platforms=platforms,
                                    data_shards=args.data_shards)
    save_exported(exp, args.out)
    kind = ("EMD episode scorer" if args.emd
            else "encoder" if args.encoder_only else "episode scorer")
    print(f"exported {kind} [{','.join(exp.platforms)}] x{max(1, args.data_shards)} device(s) -> "
          f"{args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")
    return exp


if __name__ == "__main__":
    main()
