"""Shared command-line plumbing (port of weclip_tpu/cli/common.py): logging,
the work-dir layout, config and flag parsing.

The flags are the JAX package's, so command lines carry over, plus
``--device`` (default ``cuda``).  ``--mesh N`` runs on N ranks in all, one
process per card started by ``torchrun --nproc_per_node N``: N /
``mesh.model_parallel`` data ranks, each a model group of
``mesh.model_parallel`` (parallel/mesh.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import logging
import os
import sys

from weclip_tpu_torch.core.config import Config, coco_config, load_config


def setup_logger(filename: str | None = None):
    """INFO to stdout, and to ``filename`` where given (rank 0 of a
    ``torchrun`` run only); replaces the handlers an earlier call added."""
    fmt = logging.Formatter("%(asctime)s - %(filename)s - %(levelname)s: %(message)s")
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in [h for h in root.handlers if getattr(h, "_weclip_cli", False)]:
        root.removeHandler(h)
        h.close()
    handlers = [logging.StreamHandler(sys.stdout)]
    if filename and int(os.environ.get("RANK", "0")) == 0:   # one log file a run
        handlers.append(logging.FileHandler(filename, mode="w"))
    for h in handlers:
        h.setFormatter(fmt)
        h._weclip_cli = True
        root.addHandler(h)


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device to run on (default: the CUDA card)")


def train_parser(default_config: str | None = None) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=default_config, type=str)
    p.add_argument("--work_dir", default=None, type=str)
    p.add_argument("--radius", default=None, type=int)
    p.add_argument("--crop_size", default=None, type=int)
    p.add_argument("--max_iters", default=None, type=int)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--precision", default=None, choices=["bfloat16", "float32"])
    p.add_argument("--profile", default=None, type=str, metavar="START:END",
                   help="trace these steps with torch.profiler into work_dir/profile")
    p.add_argument("--decoded_cache", default=None, type=str, metavar="DIR",
                   help="pre-decoded .npy image/label cache directory "
                        "(the first epoch decodes and fills it)")
    add_device_arg(p)
    return p


def eval_parser(default_config: str | None = None) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=default_config, type=str)
    p.add_argument("--work_dir", default="results", type=str)
    p.add_argument("--bkg_score", default=0.45, type=float,
                   help="inert: the reference parses it and never reads it "
                        "(background is pow(1 - max_cam, bg_exponent)); kept "
                        "so command lines carry over")
    p.add_argument("--resize_long", default=512, type=int)
    p.add_argument("--eval_set", default="val", type=str)
    p.add_argument("--model_path", default=None, type=str,
                   help="checkpoint directory (its latest step) or one step_N "
                        "directory: the port's or the JAX package's Orbax ones")
    p.add_argument("--crf_impl", default="native", choices=["native", "jax"],
                   help="dense-CRF backend: 'native' is the exact permutohedral "
                        "lattice on the host; 'jax' (the JAX package's name, so "
                        "command lines carry over) is the approximate mean field "
                        "on the device (refine/crf.py::mean_field_crf)")
    p.add_argument("--crf_stride", default=4, type=int,
                   help="bilateral subsampling stride of the on-device mean field")
    p.add_argument("--crf", action="store_true",
                   help="dense-CRF post-processing of the msc logits, scored as "
                        "'crf segs score'")
    p.add_argument("--max_images", default=None, type=int)
    p.add_argument("--precision", default=None, choices=["bfloat16", "float32"])
    p.add_argument("--save_preds", action="store_true",
                   help="write per-image prediction PNGs (ids and the VOC "
                        "palette) under prediction/ and prediction_cmap/")
    p.add_argument("--save_logits", action="store_true",
                   help="write per-image {segs, msc_segs} npys under logit/")
    add_mesh_arg(p)
    add_device_arg(p)
    return p


def add_mesh_arg(p: argparse.ArgumentParser):
    p.add_argument("--mesh", default=-1, type=int,
                   help="ranks in all (-1 or 0: every process of the run): N > 1 "
                        "needs N processes, started by torchrun --nproc_per_node N, "
                        "and is a (data, model) mesh whose model width is "
                        "cfg.mesh.model_parallel (so it must divide N); "
                        "eval.batch_images is per data rank")


def build_eval_mesh(args, cfg: Config):
    """The mesh of ``--mesh`` and this rank's device: ``--mesh`` /
    ``cfg.mesh.model_parallel`` data ranks (parallel/mesh.py::make_mesh,
    which starts the process group under ``torchrun`` and raises
    ``ValueError`` when the run has another number of processes).  Raises
    ``SystemExit`` when ``--mesh`` is not a multiple of the model width.
    Shard the frozen tree over it with ``meshlib.shard_model``."""
    from weclip_tpu_torch.parallel import mesh as meshlib
    model = max(cfg.mesh.model_parallel, 1)
    total = getattr(args, "mesh", -1)
    data = -1
    if total not in (-1, 0, None):
        if total % model:
            raise SystemExit(
                f"--mesh {total} is not a multiple of cfg.mesh.model_parallel="
                f"{model}; pass a total rank count divisible by the "
                f"tensor-parallel width (or set mesh.model_parallel in the config)")
        data = total // model
    mesh = meshlib.make_mesh(data, model)
    return mesh, meshlib.local_device(args.device)


def with_precision(cfg: Config, name: str | None) -> Config:
    """``cfg`` with its compute dtype set to ``name`` where given."""
    if not name:
        return cfg
    return dataclasses.replace(
        cfg, precision=dataclasses.replace(cfg.precision, compute_dtype=name))


def apply_train_args(cfg: Config, args) -> Config:
    ds = cfg.dataset
    tr = cfg.train
    # parser defaults are None: an explicit 0 is an override
    if args.crop_size is not None:
        ds = dataclasses.replace(ds, crop_size=args.crop_size)
    if getattr(args, "decoded_cache", None):
        ds = dataclasses.replace(ds, decoded_cache_dir=args.decoded_cache)
    if args.radius is not None:
        tr = dataclasses.replace(tr, radius=args.radius)
    if args.max_iters is not None:
        tr = dataclasses.replace(tr, max_iters=args.max_iters)
    wd = cfg.work_dir
    if args.work_dir:
        wd = dataclasses.replace(wd, dir=args.work_dir)
    cfg = with_precision(cfg, args.precision)
    # timestamped checkpoint dirs; --resume reuses the newest run dir that
    # holds a checkpoint (a fresh timestamp would restart from scratch)
    ts = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M")
    if getattr(args, "resume", False):
        base = os.path.join(wd.dir, wd.ckpt_dir)
        if os.path.isdir(base):
            runs = sorted(
                d for d in os.listdir(base)
                if os.path.isdir(os.path.join(base, d))
                and any(s.startswith("step_")
                        for s in os.listdir(os.path.join(base, d))))
            if runs:
                ts = runs[-1]
    wd = dataclasses.replace(wd, ckpt_dir=os.path.join(wd.ckpt_dir, ts))
    return dataclasses.replace(cfg, dataset=ds, train=tr, work_dir=wd)


def load_train_config(args, dataset: str) -> Config:
    """The config of ``--config`` (default: the reference VOC or COCO
    setup) with the flags applied; makes the checkpoint dir and logs to a
    timestamped file in the work dir."""
    base = coco_config() if dataset == "coco" else Config()
    cfg = load_config(args.config) if args.config else base
    cfg = apply_train_args(cfg, args)
    os.makedirs(os.path.join(cfg.work_dir.dir, cfg.work_dir.ckpt_dir), exist_ok=True)
    setup_logger(os.path.join(
        cfg.work_dir.dir, datetime.datetime.now().strftime("%Y-%m-%d-%H-%M") + ".log"))
    return cfg


def load_eval_config(args, dataset: str) -> Config:
    """The config of ``--config`` (default: the reference VOC or COCO
    setup) with ``--precision`` applied."""
    base = coco_config() if dataset == "coco" else Config()
    cfg = load_config(args.config) if args.config else base
    return with_precision(cfg, args.precision)


def parse_profile(spec: str | None):
    """``--profile START:END`` -> (start, end), or None."""
    return tuple(int(x) for x in spec.split(":")) if spec else None
