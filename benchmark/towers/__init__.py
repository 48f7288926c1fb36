"""Vision towers, a module each (``<tower>.py``), found by the name in a
configuration file's ``tower`` key: what the benchmark draws and counts of
one CLIP image tower.  The tower's plain math is the module of the same
name under ``reference/towers/``.  A new tower is those two files and a
configuration that names it; no other file of the benchmark changes.

A tower module provides:

- ``state_dict(seed, clip, published, device)``: the tower's seeded fp32
  weights in the key layout of its published checkpoint, under
  ``visual.*``, made on ``device`` in a few large draws
  (``weights.flat_normal`` from ``weights.generator(seed, 1, device)``);
- ``block_products(clip, published, rows, length)``: the matrix products of
  one block, each ``(m, k, n)`` (an m x k input times a k x n weight), in
  the order the block runs them, for ``rows`` rows of ``length`` tokens.
  ``work.py`` counts the blocks' forward and GradCAM's input gradients from
  this list; the attention core, the patch embedding, the image projection
  and the heads it counts itself.

``clip`` is the configuration's ``config.clip``: the sizes every tower has
(``vision_width``, ``vision_layers``, ``vision_heads``, ``patch_size``,
``embed_dim``).  ``published`` is the file's ``published`` block, from
which a tower reads the sizes that only it has.  A tower's name is a module
name: letters, digits and ``_``.

``load`` is the one lookup of a tower, for its draws and counts here and for
its plain math under ``reference/towers/``.
"""

from __future__ import annotations

import importlib
import re

NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def load(name: str, reference: bool = False):
    """The module of tower ``name``: ``towers/<name>.py`` (what the benchmark
    draws and counts) or, with ``reference``, ``reference/towers/<name>.py``
    (its plain math)."""
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"tower {name!r}: not a module name")
    package = "benchmark.reference.towers" if reference else __name__
    return importlib.import_module(f"{package}.{name}")
