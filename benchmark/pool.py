"""A seeded pool of synthetic VOC images, written as a decoded-cache VOC tree.

Every seed gives the same mix: the pool's images take the listed sizes in
equal shares, in a seeded order, and each holds 1 to 3 foreground classes
drawn from the seed as rectangles of their own colour and texture, edged
by a 3-pixel ignore band, on a textured background.  The images are made on
the device in one pass per size and copied to the host.

The tree holds, as ``VOCBase`` reads it: ``<root>/decoded/<name>.npy`` (the
uint8 image) and ``<name>_lab.npy`` (its label), ``<root>/lists/<split>.txt``
and ``cls_labels_onehot.npy``; no JPEG, so no image is decoded.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np


def make_pool(seed: int, n: int, sizes: Sequence[Sequence[int]],
              classes: Sequence[int], num_fg: int, device) -> List[Dict]:
    """``n`` examples {name, img_raw (H, W, 3) uint8, label (H, W) uint8,
    present_mask (num_fg,) bool}."""
    import torch
    rng = np.random.default_rng([int(seed) % (2 ** 63), 17])
    order = rng.permutation(np.arange(n) % len(sizes))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    out: List[Dict] = [None] * n
    for si, (h, w) in enumerate(sizes):
        idx = np.flatnonzero(order == si)
        # background: a colour ramp plus noise; regions: their own colour
        noise = torch.rand((len(idx), h, w, 3), generator=gen, device=device)
        base = torch.rand((len(idx), 1, 1, 3), generator=gen, device=device)
        ramp = torch.linspace(0, 1, w, device=device)[None, None, :, None]
        imgs = 255 * (0.5 * base + 0.3 * ramp * base.flip(-1) + 0.2 * noise)
        labels = np.zeros((len(idx), h, w), np.uint8)
        present = np.zeros((len(idx), num_fg), bool)
        for j in range(len(idx)):
            k = int(rng.integers(classes[0], classes[1] + 1))
            ids = rng.choice(num_fg, size=k, replace=False)
            for c in ids:
                rh, rw = int(rng.integers(h // 5, h // 2)), int(rng.integers(w // 5, w // 2))
                y0, x0 = int(rng.integers(0, h - rh)), int(rng.integers(0, w - rw))
                labels[j, y0:y0 + rh, x0:x0 + rw] = 255
                labels[j, y0 + 3:y0 + rh - 3, x0 + 3:x0 + rw - 3] = c + 1
                colour = torch.as_tensor(rng.random(3) * 255, dtype=torch.float32,
                                         device=device)
                imgs[j, y0:y0 + rh, x0:x0 + rw] = (0.7 * colour
                                                   + 0.3 * 255 * noise[j, y0:y0 + rh,
                                                                       x0:x0 + rw])
            ids_left = np.unique(labels[j])
            ids_left = ids_left[(ids_left > 0) & (ids_left <= num_fg)] - 1
            present[j, ids_left] = True
        host = imgs.clamp(0, 255).to(torch.uint8).cpu().numpy()
        for j, i in enumerate(idx):
            out[i] = {"name": f"syn_{i:04d}", "img_raw": host[j], "label": labels[j],
                      "present_mask": present[j]}
    return out


def write_tree(root: str, pool: List[Dict], lists: Dict[str, List[str]]) -> Dict[str, str]:
    """The decoded-cache VOC tree of ``pool`` under ``root`` with the name
    lists ``lists`` ({split: names}); returns the dataset settings that
    point the port at it."""
    cache = os.path.join(root, "decoded")
    names = os.path.join(root, "lists")
    os.makedirs(cache, exist_ok=True)
    os.makedirs(names, exist_ok=True)
    onehot = {}
    for ex in pool:
        np.save(os.path.join(cache, ex["name"] + ".npy"), ex["img_raw"])
        np.save(os.path.join(cache, ex["name"] + "_lab.npy"), ex["label"])
        onehot[ex["name"]] = ex["present_mask"].astype(np.float32)
    np.save(os.path.join(names, "cls_labels_onehot.npy"), onehot)
    for split, items in lists.items():
        with open(os.path.join(names, split + ".txt"), "w") as f:
            f.write("\n".join(items))
    return {"root_dir": root, "name_list_dir": names, "decoded_cache_dir": cache}
