"""The plain math of each vision tower, a module each (``<tower>.py``),
named as its twin under ``benchmark/towers/`` and the configuration's
``tower`` key: float32 plain ``torch`` routed through ``precision`` (so the
control can run it one step lower), importing nothing of the port.

A tower module provides:

- ``tree(sd, clip, published)``: the parameter tree of the tower's state
  dict ``sd``, with its blocks stacked on a leading axis under ``blocks``
  and its positional table under ``positional_embedding`` (the two keys the
  shared code reads); ``clip`` is this folder's ``ClipConfig``;
- ``embed(params, img, pos_emb, valid, grid, cfg, policy)``: the tokens
  entering the first block, fp32: the patch embedding, the class token, the
  positions, then what the tower applies before its blocks, invalid tokens
  zeroed;
- ``block_forward(p, x, n_heads, valid, grid, policy, want_attn)``: one
  block ``p`` on tokens ``x``; (tokens out, head-mean attention (B, L, L)
  or None);
- ``tap(p, x)``: GradCAM's tap of block ``p`` on its input ``x``, the
  tensor whose gradient weights the CAMs;
- ``block_from_tap(p, x_in, a, n_heads, valid, grid, policy)``: the block
  on input ``x_in`` with its tap given as ``a`` (so the gradient reaches
  ``a``); (tokens out, head-mean attention), the attention differentiable;
- ``out(params, x, pool)``: the image feature of the last block's tokens
  ``x``: what the tower applies after its blocks, ``pool`` (WeCLIP's masked
  mean over the valid patch tokens) and the image projection.

``grid`` is the token grid (rows, columns) of the padded canvas, for a
tower whose blocks place tokens on it.  ``benchmark.towers.load(name,
reference=True)`` finds a module here.
"""
