"""OpenAI CLIP checkpoint -> the port's parameter trees (port of
weclip_tpu/models/clip/loader.py).

Reads a TorchScript archive or a plain state dict, strips ``module.``
prefixes, infers the ViT architecture from the tensor shapes and upcasts
every tensor to fp32 (OpenAI ships fp16; the precision policy rounds at
compute time).  The trees are the port's stacked layout, the one
``convert.py`` produces from the JAX package's: ``visual`` and ``text``
with their transformer blocks stacked on a leading axis, and
``logit_scale``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from weclip_tpu_torch.core.config import ClipConfig
from weclip_tpu_torch.models.clip.vit import tree_map


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The checkpoint's tensors as fp32 CPU tensors, ``module.`` stripped:
    a TorchScript archive first, then a plain ``torch.load``."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except Exception:
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().to("cpu", torch.float32)
    return out


def infer_config(sd: Dict[str, Any], base: Optional[ClipConfig] = None) -> ClipConfig:
    """The architecture from the tensor shapes; heads are width / 64."""
    base = base or ClipConfig()
    conv = sd["visual.conv1.weight"]
    vision_layers = len([k for k in sd if k.startswith("visual.")
                         and k.endswith(".attn.in_proj_weight")])
    tw = sd["ln_final.weight"].shape[0]
    tlayers = len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")})
    return dataclasses.replace(
        base,
        vision_width=conv.shape[0], vision_layers=vision_layers,
        vision_heads=conv.shape[0] // 64, patch_size=conv.shape[-1],
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=tw, transformer_heads=tw // 64,
        transformer_layers=tlayers,
    )


def _block_params(sd: Dict[str, torch.Tensor], prefix: str, n: int) -> Dict[str, Any]:
    def stack(name):
        return torch.stack([sd[f"{prefix}.{i}.{name}"] for i in range(n)])
    return {
        "ln_1": {"g": stack("ln_1.weight"), "b": stack("ln_1.bias")},
        "attn": {"in_w": stack("attn.in_proj_weight"),
                 "in_b": stack("attn.in_proj_bias"),
                 "out_w": stack("attn.out_proj.weight"),
                 "out_b": stack("attn.out_proj.bias")},
        "ln_2": {"g": stack("ln_2.weight"), "b": stack("ln_2.bias")},
        "mlp": {"fc_w": stack("mlp.c_fc.weight"), "fc_b": stack("mlp.c_fc.bias"),
                "proj_w": stack("mlp.c_proj.weight"),
                "proj_b": stack("mlp.c_proj.bias")},
    }


def params_from_state_dict(sd: Dict[str, torch.Tensor],
                           cfg: ClipConfig) -> Dict[str, Any]:
    visual = {
        "conv1_w": sd["visual.conv1.weight"],
        "class_embedding": sd["visual.class_embedding"],
        "positional_embedding": sd["visual.positional_embedding"],
        "ln_pre": {"g": sd["visual.ln_pre.weight"], "b": sd["visual.ln_pre.bias"]},
        "blocks": _block_params(sd, "visual.transformer.resblocks", cfg.vision_layers),
        "ln_post": {"g": sd["visual.ln_post.weight"], "b": sd["visual.ln_post.bias"]},
        "proj": sd["visual.proj"],
    }
    text = {
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "blocks": _block_params(sd, "transformer.resblocks", cfg.transformer_layers),
        "ln_final": {"g": sd["ln_final.weight"], "b": sd["ln_final.bias"]},
        "text_projection": sd["text_projection"],
    }
    return {"visual": visual, "text": text,
            "logit_scale": sd["logit_scale"].reshape(()).float()}


# Published OpenAI checkpoint URLs; the sha256 of each file is the
# second-to-last path segment.  Only the ViT entries load here.
MODEL_URLS = {
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L/14@336px": "https://openaipublic.azureedge.net/clip/models/3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}


def available_models():
    """Names ``download_checkpoint`` accepts."""
    return list(MODEL_URLS)


def is_fetchable(path: str) -> bool:
    """True when ``path`` names a downloadable checkpoint: a MODEL_URLS key
    or an http(s) URL."""
    return bool(path) and (path in MODEL_URLS
                           or path.startswith(("http://", "https://")))


def _file_sha256(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_checkpoint(name_or_url: str, root: Optional[str] = None,
                        expected_sha256: Optional[str] = None) -> str:
    """Fetch a checkpoint, verified by sha256; returns its local path.

    ``name_or_url``: a MODEL_URLS key or a URL.  OpenAI's URLs carry their
    digest as the second-to-last path segment and are always verified;
    another URL is verified against ``expected_sha256`` where one is given,
    else used unverified with a warning.  An existing file whose digest
    matches (any existing file, when unverified) is reused without a
    download; a download that fails the check is deleted and raises."""
    import hashlib
    import logging
    import urllib.request

    url = MODEL_URLS.get(name_or_url, name_or_url)
    root = root or os.path.expanduser("~/.cache/weclip_tpu")
    os.makedirs(root, exist_ok=True)
    target = os.path.join(root, os.path.basename(url))
    digest = expected_sha256
    if digest is None and url in MODEL_URLS.values():
        digest = url.split("/")[-2]
    if digest is None:
        logging.getLogger("weclip_tpu_torch").warning(
            "no sha256 provided for checkpoint URL %s — the download will "
            "NOT be verified (set ClipConfig.pretrained_sha256)", url)
    if os.path.isfile(target) and (digest is None or _file_sha256(target) == digest):
        return target
    tmp = target + ".part"
    h = hashlib.sha256()
    with urllib.request.urlopen(url) as src, open(tmp, "wb") as out:
        while True:
            buf = src.read(1 << 20)
            if not buf:
                break
            h.update(buf)
            out.write(buf)
    if digest is not None and h.hexdigest() != digest:
        os.remove(tmp)
        raise RuntimeError(
            f"checkpoint download from {url} failed sha256 verification "
            f"(got {h.hexdigest()}, expected {digest})")
    os.replace(tmp, target)
    return target


def load_clip(path: str, base: Optional[ClipConfig] = None,
              download_root: Optional[str] = None,
              expected_sha256: Optional[str] = None,
              device="cpu") -> Tuple[Dict[str, Any], ClipConfig]:
    """(params on ``device``, the inferred ClipConfig).  ``path`` is a local
    file, a MODEL_URLS name or an http(s) URL (the last two are fetched by
    ``download_checkpoint``)."""
    if is_fetchable(path):
        path = download_checkpoint(path, root=download_root,
                                   expected_sha256=expected_sha256)
    elif not os.path.exists(path):
        raise FileNotFoundError(
            f"CLIP checkpoint {path!r} not found (pass a local file, a "
            f"model name from {available_models()}, or a URL)")
    sd = load_torch_state_dict(path)
    cfg = infer_config(sd, base)
    params = params_from_state_dict(sd, cfg)
    return tree_map(lambda t: t.to(device), params), cfg


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_preprocess(image: np.ndarray, n_px: int = 224) -> np.ndarray:
    """CLIP's own input transform: bicubic short-side resize, center crop,
    CLIP-statistics normalization.  WeCLIP's pipelines normalize with
    ImageNet statistics instead; this serves zero-shot probing.

    image: (H, W, 3) uint8 RGB -> (3, n_px, n_px) float32."""
    from PIL import Image
    im = Image.fromarray(image)
    w, h = im.size
    scale = n_px / min(w, h)
    im = im.resize((max(n_px, int(round(w * scale))),
                    max(n_px, int(round(h * scale)))), Image.BICUBIC)
    w, h = im.size
    left, top = (w - n_px) // 2, (h - n_px) // 2
    im = im.crop((left, top, left + n_px, top + n_px))
    arr = np.asarray(im, np.float32) / 255.0
    arr = (arr - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)
    return arr.transpose(2, 0, 1)
