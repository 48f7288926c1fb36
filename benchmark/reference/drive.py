"""The plain reference, driven as the cells drive the program.

Plain fp32 PyTorch (bf16 where the configuration states bf16 products, as
the program rounds them), TF32 off, no hand-written kernel: the modules of
this folder are a frozen copy of the port's plain math, each product routed
through ``precision`` so that ``precision.lower_precision()`` can run the
whole reference one step lower (the control).

It takes what the benchmark made (the CLIP state dict, the class features,
the trainable values, the raw pool images and labels, the seed) and works
out everything the program derives from them again: the parameter trees,
the loader's order and augmentations, the batches, the class buckets, the
evaluation canvases and positional embeddings.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark import towers
from benchmark.reference import compaction, engine, optimizer, precision, step, transforms
from benchmark.reference import vit, weclip
from benchmark.reference.config import Config, from_dict


# -- state --------------------------------------------------------------------

def frozen_state(sd, fg, bg, cfg: Config, tower: str = "openai_clip",
                 published: dict = None) -> Dict:
    """The frozen tree: the vision tree of ``tower`` (its module of
    ``reference/towers/``, kept under ``visual["tower"]``) from the state
    dict and the configuration's ``published`` sizes, the logit scale and
    the class features.  A caller that names no tower, as the port's
    patch-14 tests, gets OpenAI's."""
    module = towers.load(tower, reference=True)
    visual = module.tree(sd, cfg.clip, published)
    visual["tower"] = module
    return {"visual": visual, "logit_scale": sd["logit_scale"].float(), "fg_text": fg.float(),
            "bg_text": bg.float()}


def _fill(tree, values, prefix=""):
    if isinstance(tree, dict):
        return {k: _fill(v, values, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fill(v, values, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return values[prefix.rstrip("/")].detach().clone().float()


def trainable(cfg: Config, values: Dict[str, torch.Tensor]) -> Dict:
    """The trainable tree of this copy's layout, each leaf ``values[path]``."""
    shapes = weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return _fill(shapes, values)


# -- training -----------------------------------------------------------------

def loader_items(seed: int, n: int, batch: int, k: int):
    """The (indices, item seeds) of batch ``k`` of the training stream: a
    permutation of the pool from ``numpy.random.default_rng(seed)``, and
    each item's augmentation seed from (seed, batch, slot)."""
    per_epoch = n // batch
    epoch, j = divmod(k, per_epoch)
    rng = np.random.default_rng(seed)
    for _ in range(epoch + 1):
        order = rng.permutation(n)
    idx = order[j * batch:(j + 1) * batch]
    seeds = [((seed * (2 ** 64) + k) * (2 ** 16)) + slot for slot in range(batch)]
    return idx, seeds


def class_set(label: np.ndarray, num_fg: int) -> np.ndarray:
    """Classes of a label map: ids 1..num_fg, minus one."""
    ids = np.unique(np.asarray(label).astype(np.int64))
    ids = ids[(ids >= 1) & (ids <= num_fg)] - 1
    mask = np.zeros(num_fg, bool)
    mask[ids] = True
    return mask


def augment(img: np.ndarray, cfg: Config, item_seed: int) -> np.ndarray:
    """Random rescale, flip and crop, then normalization: (3, crop, crop)."""
    rng = random.Random(item_seed)
    ds = cfg.dataset
    image = transforms.random_scaling(np.asarray(img), ds.rescale_range, rng=rng)
    image = transforms.random_fliplr(image, rng=rng)
    image, _ = transforms.random_crop(image, ds.crop_size, ignore_index=ds.ignore_index,
                                      rng=rng)
    image = transforms.normalize_img(image, np.asarray(ds.mean, np.float32),
                                     np.asarray(ds.std, np.float32))
    return np.transpose(image, (2, 0, 1)).astype(np.float32)


def train_batch(cfg: Config, pool: List[Dict], seed: int, k: int, pe_table, device):
    """Batch ``k`` of the stream: (host images, present masks, Batch,
    cls_idx, cls_active)."""
    b = cfg.train.samples_per_gpu
    idx, seeds = loader_items(seed, len(pool), b, k)
    imgs = np.stack([augment(pool[i]["img_raw"], cfg, s) for i, s in zip(idx, seeds)])
    num_fg = cfg.dataset.num_classes - 1
    present = np.stack([class_set(pool[i]["label"], num_fg) for i in idx])
    g = cfg.dataset.crop_size // cfg.clip.patch_size
    pos = torch.from_numpy(vit.pos_emb_host(pe_table, g, g, g, g))[None].to(device)
    batch = weclip.Batch(
        img=torch.from_numpy(np.ascontiguousarray(imgs)).to(device), pos_emb=pos,
        valid=torch.ones((b, g * g + 1), dtype=torch.bool, device=device),
        gh=torch.full((b,), g, device=device), gw=torch.full((b,), g, device=device),
        present_mask=torch.from_numpy(present).to(device))
    buckets = tuple(x for x in (4, 8, 16) if x < num_fg) + (num_fg,)
    ci, ca = compaction.compact_classes(present, compaction.pick_bucket(present, buckets))
    return imgs, present, batch, torch.from_numpy(ci).to(device), torch.from_numpy(ca).to(device)


def train_readings(cfg_dict: dict, sd, fg, bg, values, pool, steps: int, device,
                   follow: Dict = None) -> Dict:
    """``steps`` training steps from the benchmark's values on the stream's
    first batches: each step's loss, forward outputs (``seg`` logits, the
    walk's ``refined`` CAMs, the pseudo ``labels``), the chain's start
    (GradCAM's ``cams``, the last block's head-mean map ``attn_last``), its PAR
    scores ``par`` and the bucket's label table ``lut``, each
    leaf's first gradient (as AdamW holds it after one step) and its change
    after ``steps`` steps, and the batches' images and class sets.

    ``follow`` (another run's readings): train against its pseudo labels,
    and make ``tail_par`` PAR scores from its ``refined`` CAMs with this
    chain's tail, so that the steps follow that run past the chain, whose argmax
    and box thresholds part two runs at rounding's distance.  ``cfg_dict``
    is the configuration's ``work.config_dict``: its ``tower`` and
    ``published`` sizes go to ``frozen_state``."""
    cfg = from_dict(cfg_dict)
    pc = cfg.precision
    policy = precision.make_policy(pc.compute_dtype, pc.param_dtype, pc.softmax_dtype)
    frozen = frozen_state(sd, fg, bg, cfg, cfg_dict["tower"], cfg_dict["published"])
    params = trainable(cfg, values)
    leaves = step.param_leaves(params)
    start = [t.detach().clone() for t in leaves]
    for t in leaves:
        t.requires_grad_(True)
    opt, sched = optimizer.make_optimizer(leaves, cfg.optimizer, cfg.train.max_iters)
    state = step.TrainState(params, opt, sched, 0)
    step_fn = step.make_train_step(cfg, policy)
    pe = frozen["visual"]["positional_embedding"].float().cpu().numpy()
    out = {k: [] for k in ("loss", "images", "present", "seg", "refined", "labels",
                           "par", "tail_par", "lut", "cams", "attn_last")}
    for k in range(steps):
        imgs, present, batch, ci, ca = train_batch(cfg, pool, cfg.train.seed, k, pe, device)
        keep = {}
        pseudo = None
        if follow is not None:
            keep["follow"] = follow["refined"][k]
            pseudo = follow["labels"][k].to(device)
        state, m = step_fn(state, frozen, batch, cfg.train.seed + 1, ci, ca, pseudo, keep)
        fwd = keep["out"]
        out["loss"].append(float(m.loss))
        out["images"].append(imgs)
        out["present"].append(present)
        out["seg"].append(fwd.seg.detach().clone())
        out["refined"].append(fwd.cams_refined.detach().clone())
        out["labels"].append(fwd.cam_labels.detach().clone())
        out["cams"].append(keep["cams"])
        out["attn_last"].append(keep["attn_last"])
        out["par"].append(keep["par"])
        out["lut"].append(keep["lut"])
        if "tail_par" in keep:
            out["tail_par"].append(keep["tail_par"])
        if k == 0:
            beta1 = cfg.optimizer.betas[0]
            out["grad"] = [float(opt.state[t]["exp_avg"].norm()) / (1 - beta1) for t in leaves]
    out["change"] = [float((t.detach() - s).norm()) for t, s in zip(leaves, start)]
    return out


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _paths(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


# -- evaluation ----------------------------------------------------------------

def make_prep(cfg: Config, max_ori: int):
    """The evaluation canvases (scale 1, scale 2, output) and grids."""
    patch, rl = cfg.clip.patch_size, cfg.eval.resize_long
    up = lambda x, m: ((x + m - 1) // m) * m
    c1 = up(rl, patch)
    c2 = up(int(rl * cfg.eval.scales[1]) + patch, patch)
    return {"c1": c1, "c2": c2, "co": up(max_ori, 8), "g1": c1 // patch, "g2": c2 // patch}


class _Prep:
    def __init__(self, d, rl):
        self.canvas_in1, self.canvas_in2, self.canvas_out = d["c1"], d["c2"], d["co"]
        self.grid1, self.grid2, self.resize_long = d["g1"], d["g2"], rl


def eval_batch(cfg: Config, prep: _Prep, examples: Sequence[Dict], pe_table, device):
    """The device inputs of one batch: (sb1, sb2, sizes, labels, presents,
    cls_idx, cls_active)."""
    patch, rl, s2 = cfg.clip.patch_size, prep.resize_long, cfg.eval.scales[1]
    b, co = len(examples), prep.canvas_out
    img = np.zeros((b, co, co, 3), np.uint8)
    lab = np.full((b, co, co), 255, np.uint8)
    rows, pres, cols1, cols2 = [], [], [], []

    def pe_valid(h, w, canvas):
        gh, gw, g = h // patch, w // patch, canvas // patch
        pe = torch.from_numpy(vit.pos_emb_host(pe_table, gh, gw, g, g)).to(device)
        valid = torch.from_numpy(vit.grid_valid_mask(gh, gw, g, g)).to(device)
        return pe, valid, gh, gw

    num_fg = cfg.dataset.num_classes - 1
    for j, ex in enumerate(examples):
        oh, ow = ex["img_raw"].shape[:2]
        r = rl / max(oh, ow)
        h1, w1 = int(oh * r), int(ow * r)
        h2, w2 = int(h1 * s2), int(w1 * s2)
        cols1.append(pe_valid(h1, w1, prep.canvas_in1))
        cols2.append(pe_valid(h2, w2, prep.canvas_in2))
        rows.append((oh, ow, h1, w1, h2, w2))
        img[j, :oh, :ow] = ex["img_raw"]
        lab[j, :oh, :ow] = ex["label"]
        pres.append(class_set(ex["label"], num_fg))
    img_d = torch.from_numpy(img).to(device)
    dev = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=device)

    def stack(cols, w_px):
        pe, valid, gh, gw = zip(*cols)
        return engine.ScaleBatch(img_d, torch.stack(pe), torch.stack(valid), dev(gh),
                                 dev(gw), dev(w_px))

    sb1 = stack(cols1, [r[3] for r in rows])
    sb2 = stack(cols2, [r[5] for r in rows])
    sizes = engine.EvalSizes(*dev(np.asarray(rows).T).unbind(0))
    pres = np.stack(pres)
    buckets = tuple(x for x in (4, 8) if x < num_fg) + (num_fg,)
    ci, ca = compaction.compact_classes(pres, compaction.pick_bucket(pres, buckets))
    return (sb1, sb2, sizes, torch.from_numpy(lab).to(device),
            torch.from_numpy(pres).to(device), dev(ci), torch.from_numpy(ca).to(device))


@torch.no_grad()
def eval_outputs(cfg_dict: dict, sd, fg, bg, values, batches: Sequence[Sequence[Dict]],
                 with_cam: bool, max_ori: int, device,
                 follow: Sequence[torch.Tensor] = None) -> List[Dict]:
    """Per batch of examples: the scale-1 logits (single and flip-averaged),
    the scale-2 flip-averaged logits, the msc logits at the output canvas,
    and with the CAM chain GradCAM's ``cams``, the last block's head-mean map
    ``attn_last`` and the token ``valid`` mask, the walk's ``refined``
    CAMs, the PAR scores (B, 1 + MC, Co, Co), the bucket's label table (B,
    1 + MC), the ``labels`` and, where ``follow`` gives another run's
    refined CAMs a batch, the ``tail_par`` PAR scores this chain's tail
    makes from them.  ``cfg_dict`` is the configuration's
    ``work.config_dict``: its ``tower`` and ``published`` sizes go to
    ``frozen_state``, which takes OpenAI's where it names none."""
    cfg = from_dict(cfg_dict)
    policy = precision.make_policy(cfg.precision.compute_dtype)
    frozen = frozen_state(sd, fg, bg, cfg, cfg_dict.get("tower", "openai_clip"),
                          cfg_dict.get("published"))
    params = trainable(cfg, values)
    prep = _Prep(make_prep(cfg, max_ori), cfg.eval.resize_long)
    pe = frozen["visual"]["positional_embedding"].float().cpu().numpy()
    scale2 = engine.make_eval_scale2(cfg, policy, prep=prep)
    msc = engine.make_msc_logits(cfg, prep=prep)
    out = []
    for i, examples in enumerate(batches):
        sb1, sb2, sizes, labels, pres, ci, ca = eval_batch(cfg, prep, examples, pe, device)
        scale1 = engine.make_eval_scale1(cfg, policy, with_cam=with_cam,
                                         max_classes=ci.shape[1], prep=prep)
        keep = {"follow": None if follow is None else follow[i]}
        seg1, avg1, cam_labels = scale1(params, frozen, sb1, pres, sizes, ci, ca, keep)
        avg2 = scale2(params, frozen, sb2, pres, sizes)
        rec = {"seg_single": seg1, "seg_avg1": avg1, "seg_avg2": avg2,
               "msc": msc(avg1, avg2, sizes), "sizes": sizes, "cam_labels": cam_labels}
        rec.update({k: v for k, v in keep.items() if k != "follow"})
        out.append(rec)
    return out
