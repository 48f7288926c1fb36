"""CoMer functional benchmark, the port of tools/comer_benchmark.py: does the
ViT-CoMer branch *help*, not merely train?

A small fully supervised synthetic segmentation task whose classes are
defined by LOCAL TEXTURE (oriented sinusoidal gratings inside geometric
shapes).  A frozen *random* ViT embeds patches through one fixed linear
projection, nearly classless for texture, while CoMer's conv stem and MRFP
multi-scale convs see exactly this structure.  Both arms share the frozen
backbone, the fuse/decoder heads' initial weights, the data stream, the
seeds and the optimizer; they differ only in ``cfg.comer.enabled``.  If
CTI/MRFP add representational power, the CoMer arm wins held-out mIoU.

The protocol is the JAX tool's: the same numpy data generator (a seed gives
the same images and labels bit for bit), the same tiny config and CoMer
dims, ``train/seg_step.py`` under the fp32 policy, held-out evaluation on a
disjoint generator (``seed + 999``) by a single-scale seg argmax streamed
into one confusion histogram, scored by ``evalx/metrics.scores``.  The
weights come from torch generators seeded by ``--seed``, so per-seed values
differ from the JAX tool's and the two are compared by their means.  The
fuse head's channel dropout draws a new mask each step from (seed + 1,
step), as the JAX tool's key seed + 1 folded with the step does, from
torch's generator.

Run (the card by default):

    python -m weclip_tpu_torch.tools.comer_benchmark [--steps 300]
        [--eval_n 16] [--batch 4] [--seed 0] [--seeds 1] [--device cuda]

On the card the run is repeatable (fp32 matmuls, cuDNN's deterministic
convolution algorithms).

Prints one JSON line {"comer_miou": ..., "plain_miou": ..., "delta": ...}
(the JAX tool's keys), and a line per seed first when ``--seeds`` > 1.
On the card the CoMer arm's CTI cross-attention runs K6 and K3-rect at
head width 128 (256 / 2 heads) and the ViT's attention K1/K2 at 32.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.config import ClipConfig, ComerConfig, Config, ParConfig
from weclip_tpu_torch.evalx import metrics
from weclip_tpu_torch.models import weclip
from weclip_tpu_torch.models.clip import vit
from weclip_tpu_torch.ops.resize import resize_bilinear
from weclip_tpu_torch.train import seg_step


def make_texture_example(rng: np.random.Generator, px: int, num_classes: int):
    """One image: grey-noise background (class 0) + 1-3 shape regions,
    each filled with its class's oriented grating (class c gets angle
    c*pi/C and a distinct frequency) — segmentable from local texture."""
    img = rng.normal(0.0, 0.15, (px, px, 3)).astype(np.float32)
    label = np.zeros((px, px), np.int32)
    yy, xx = np.mgrid[0:px, 0:px].astype(np.float32)
    for _ in range(int(rng.integers(1, 4))):
        c = int(rng.integers(1, num_classes))
        ang = np.pi * c / num_classes
        freq = 0.25 + 0.15 * c
        cx, cy = rng.uniform(px * 0.2, px * 0.8, 2)
        r = rng.uniform(px * 0.12, px * 0.3)
        if rng.random() < 0.5:
            mask = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r * 0.8)
        else:
            mask = (xx - cx) ** 2 + (yy - cy) ** 2 < r ** 2
        tex = np.sin(freq * (np.cos(ang) * xx + np.sin(ang) * yy))
        for ch in range(3):
            img[..., ch] = np.where(mask, 0.8 * tex + 0.1 * ch, img[..., ch])
        label = np.where(mask, c, label)
    return img.transpose(2, 0, 1), label


def tiny_config(crop: int = 64, num_classes: int = 6) -> Config:
    """The tests' tiny config (tests/tiny.py): a 12-layer ViT of width 64
    with 2 heads (head width 32), the default 256-wide heads, PAR at (1, 2)."""
    cfg = Config()
    return dataclasses.replace(
        cfg,
        dataset=dataclasses.replace(cfg.dataset, crop_size=crop, num_classes=num_classes),
        clip=ClipConfig(patch_size=16, vision_width=64, vision_layers=12, vision_heads=2,
                        embed_dim=32, context_length=16, vocab_size=128,
                        transformer_width=32, transformer_heads=2, transformer_layers=2),
        par=ParConfig(dilations=(1, 2), num_iter=4),
    )


def arm_config(comer: bool) -> Config:
    """An arm's config: the tiny config, with the tests' small CoMer dims
    (tests/test_comer.py::small_comer_cfg) in the CoMer arm."""
    cfg = tiny_config()
    if comer:
        cfg = dataclasses.replace(cfg, comer=ComerConfig(
            enabled=True, stem_width=8, pyramid_dims=(16, 16, 16),
            mrfp_dilations=(1, 2), cti_heads=2, interaction_indexes=(2, 5)))
    return cfg


def _batch(cfg: Config, imgs, pos, device) -> weclip.Batch:
    b = len(imgs)
    g = cfg.dataset.crop_size // cfg.clip.patch_size
    return weclip.Batch(
        img=torch.from_numpy(np.stack(imgs)).to(device), pos_emb=pos,
        valid=torch.ones((b, g * g + 1), dtype=torch.bool, device=device),
        gh=torch.full((b,), g, dtype=torch.int32, device=device),
        gw=torch.full((b,), g, dtype=torch.int32, device=device),
        present_mask=torch.ones((b, cfg.dataset.num_classes - 1), dtype=torch.bool,
                                device=device))


def run_arm(comer: bool, steps: int, batch: int, eval_n: int, seed: int,
            device: str = "cuda", frozen: Optional[Dict] = None,
            params: Optional[Dict] = None, dropout: bool = True
            ) -> Tuple[float, List[float]]:
    """Train one arm ``steps`` steps and score it on ``eval_n`` held-out
    images; returns (mIoU, per-step losses).  ``frozen``/``params``: start
    from these trees instead of the ones seeded by ``seed`` (the tests carry
    the JAX package's in); ``dropout=False`` turns the fuse head's dropout
    off."""
    cfg = arm_config(comer)
    crop, k = cfg.dataset.crop_size, cfg.dataset.num_classes
    g = crop // cfg.clip.patch_size
    policy = precision.FP32
    if frozen is None:
        frozen = weclip.random_frozen_state(cfg, seed=seed, device=device)
    else:
        frozen = weclip.tree_to(frozen, device)
    pos = vit.build_pos_emb(frozen["visual"], g, g)[None]
    state = seg_step.create_seg_train_state(torch.Generator().manual_seed(seed), cfg,
                                            device, params=params)
    fn = seg_step.make_seg_train_step(cfg, policy)

    rng = np.random.default_rng(seed + 123)
    losses = []
    for _ in range(steps):
        imgs, labels = zip(*(make_texture_example(rng, crop, k) for _ in range(batch)))
        state, met = fn(state, frozen, _batch(cfg, imgs, pos, device),
                        torch.from_numpy(np.stack(labels)).to(device),
                        seed + 1 if dropout else None)
        losses.append(float(met.loss))

    # held-out eval: single-scale seg argmax, streamed into one confusion
    # histogram (eval data from a DISJOINT generator seed)
    erng = np.random.default_rng(seed + 999)
    hist = np.zeros((k, k), np.float64)
    done = 0
    with torch.no_grad():
        while done < eval_n:
            imgs, labels = zip(*(make_texture_example(erng, crop, k) for _ in range(batch)))
            _, head_out, _, _ = weclip.backbone_and_heads(
                state.params, frozen, _batch(cfg, imgs, pos, device), cfg, policy,
                with_attn=False)
            seg_grid = head_out.seg.reshape(batch, g, g, -1).permute(0, 3, 1, 2)
            preds = resize_bilinear(seg_grid, crop, crop).argmax(dim=1).cpu().numpy()
            for p, lab in zip(preds, labels):
                hist += np.bincount(k * lab.reshape(-1) + p.reshape(-1),
                                    minlength=k * k).reshape(k, k)
            done += batch
    return metrics.scores(hist)["miou"], losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--eval_n", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1,
                    help="number of seeds (single-seed deltas sit inside "
                         "seed noise on this task; >=3 for a claim)")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("comer_benchmark: no CUDA device (pass --device cpu)")
        precision.strict_matmul()
        # cuDNN's default algorithms for the CoMer arm's convolutions sum
        # their weight gradients in an order that varies from run to run:
        # two runs of one seed part within the first few dozen steps and end
        # apart by several points of mIoU.  The deterministic ones repeat a
        # run.
        torch.backends.cudnn.deterministic = True

    plain, comer, plain_fl, comer_fl = [], [], [], []
    for s in range(args.seed, args.seed + args.seeds):
        pm, pl = run_arm(False, args.steps, args.batch, args.eval_n, s, args.device)
        cm, cl = run_arm(True, args.steps, args.batch, args.eval_n, s, args.device)
        plain.append(float(pm))
        comer.append(float(cm))
        plain_fl.append(float(np.mean(pl[-10:])))
        comer_fl.append(float(np.mean(cl[-10:])))
        if args.seeds > 1:
            print(json.dumps({"seed": s, "plain_miou": round(pm, 4),
                              "comer_miou": round(cm, 4)}), flush=True)
    out = {
        "task": "synthetic_texture_seg",
        "steps": args.steps,
        "seeds": args.seeds,
        "plain_miou": round(float(np.mean(plain)), 4),
        "comer_miou": round(float(np.mean(comer)), 4),
        "delta": round(float(np.mean(comer) - np.mean(plain)), 4),
        "plain_std": round(float(np.std(plain)), 4),
        "comer_std": round(float(np.std(comer)), 4),
        "plain_final_loss": round(float(np.mean(plain_fl)), 4),
        "comer_final_loss": round(float(np.mean(comer_fl)), 4),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
