"""The CAM methods (port of weclip_tpu/cam/variants.py).

Every method maps block 11's ln_1 activations (and, for the gradient
methods, the gradient of each class's probability at them) to one map per
class, then ReLU and min-max over the valid patches:

- grad_cam:       w_c = mean_p g[p, c]
- grad_cam_pp:    GradCAM++ alpha-weighted ReLU gradients
- xgrad_cam:      w_c = sum_p g[p,c] * a[p,c] / sum_p a[p,c]
- layer_cam:      cam_p = sum_c ReLU(g[p,c]) * a[p,c]
- eigen_cam:      projection on the first right-singular vector of a
- eigen_grad_cam: the same on g * a
- score_cam:      channel weights from the probabilities of activation-
                  masked forwards
- ablation_cam:   channel weights from the probability drop of each
                  channel zeroed

The gradient methods take every class's gradient from one backward over
the class bucket expanded onto the batch (cam/gradcam.py::acts_and_grads;
on CUDA, K1 forward and K3 backward).  The perturbation methods run block
11 forward only, in chunks of 32 channels.  A singular vector's sign is
arbitrary, and LAPACK and cuSOLVER may pick different ones: the eigen
methods' maps are defined up to that sign before the ReLU.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from weclip_tpu_torch.cam.gradcam import _image_text_probs, _minmax_valid, acts_and_grads
from weclip_tpu_torch.core import precision
from weclip_tpu_torch.core.config import ClipConfig
from weclip_tpu_torch.models.clip import vit

GRADIENT_METHODS = ("grad_cam", "grad_cam_pp", "xgrad_cam", "layer_cam",
                    "eigen_cam", "eigen_grad_cam")
METHODS = GRADIENT_METHODS + ("score_cam", "ablation_cam")


def _pe(x11: torch.Tensor, num_patches: Optional[int]) -> int:
    """End of the CLS + patch block: 1 + P (P = L - 1 by default)."""
    return 1 + (num_patches if num_patches is not None else x11.shape[0] - 1)


def _finish(cam: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """ReLU, then min-max over the valid patches: (C, P)."""
    return _minmax_valid(torch.relu(cam), valid[1:].bool()[None])


def grad_cam(acts, grads, valid):
    pm = valid[1:].float()
    w = (grads[:, 1:] * pm[None, :, None]).sum(dim=1) / pm.sum().clamp_min(1.0)
    return w @ acts[1:].T


def grad_cam_pp(acts, grads, valid):
    """alpha = g^2 / (2 g^2 + (sum_p a) g^3 + 1e-6), zero where g == 0;
    w = sum_p ReLU(g) * alpha."""
    g = grads[:, 1:]
    a = acts[1:][None]
    pm = valid[1:].float()[None, :, None]
    g2, g3 = g * g, g * g * g
    sum_a = (a * pm).sum(dim=1, keepdim=True)
    denom = 2.0 * g2 + sum_a * g3 + 1e-6
    alpha = torch.where(g != 0.0, g2 / denom, torch.zeros_like(g))
    w = (alpha * torch.relu(g) * pm).sum(dim=1)
    return w @ acts[1:].T


def xgrad_cam(acts, grads, valid):
    a = acts[1:][None]
    pm = valid[1:].float()[None, :, None]
    w = (grads[:, 1:] * a * pm).sum(dim=1) / ((a * pm).sum(dim=1) + 1e-7)
    return w @ acts[1:].T


def layer_cam(acts, grads, valid):
    return (torch.relu(grads[:, 1:]) * acts[1:][None]).sum(dim=-1)


def _first_right_singular_projection(a: torch.Tensor) -> torch.Tensor:
    """(..., P, D) -> (..., P): ``a`` centred over P, projected on its first
    right-singular vector."""
    a = a - a.mean(dim=-2, keepdim=True)
    vh = torch.linalg.svd(a, full_matrices=False).Vh
    return (a @ vh[..., 0, :, None])[..., 0]


def eigen_cam(acts, grads, valid):
    """Gradient-free: the same map for every class."""
    proj = _first_right_singular_projection(acts[1:] * valid[1:].float()[:, None])
    return proj[None].expand(grads.shape[0], proj.shape[0])


def eigen_grad_cam(acts, grads, valid):
    a = acts[1:][None] * grads[:, 1:] * valid[1:].float()[None, :, None]
    return _first_right_singular_projection(a)


_WEIGHTED: Dict[str, Callable] = {
    "grad_cam": grad_cam,
    "grad_cam_pp": grad_cam_pp,
    "xgrad_cam": xgrad_cam,
    "layer_cam": layer_cam,
    "eigen_cam": eigen_cam,
    "eigen_grad_cam": eigen_grad_cam,
}


def raw_maps(method: str, visual_params, logit_scale, x11, text_features, text_mask,
             valid, class_idx, cfg: ClipConfig,
             policy: precision.Policy = precision.DEFAULT,
             num_patches: Optional[int] = None,
             top_channels: Optional[int] = None) -> torch.Tensor:
    """A method's maps (C, P) before the ReLU and min-max (arguments as
    ``cam_single``'s)."""
    if method in _PERTURBATION:
        return _PERTURBATION[method](visual_params, logit_scale, x11, text_features,
                                     text_mask, valid, class_idx, cfg, policy,
                                     top_channels, num_patches)
    if method not in _WEIGHTED:
        raise ValueError(f"unknown CAM method {method!r}; one of {METHODS}")
    a0, grads, _, _ = acts_and_grads(visual_params, logit_scale, x11[None],
                                     text_features, text_mask[None], valid[None],
                                     class_idx[None], cfg, policy)
    pe = _pe(x11, num_patches)
    return _WEIGHTED[method](a0[0, :pe].float(), grads[0, :, :pe].float(), valid[:pe])


def cam_single(method: str, visual_params, logit_scale, x11, text_features,
               text_mask, valid, class_idx, cfg: ClipConfig,
               policy: precision.Policy = precision.DEFAULT,
               num_patches: Optional[int] = None,
               top_channels: Optional[int] = None) -> torch.Tensor:
    """CAMs (C, P) of one image by ``method``: x11 (L, D) block 11's input
    tokens, text_mask (T,), valid (L,), class_idx (C,).  ``num_patches``: the
    grid's patch count P when x11 is longer than 1 + P.  ``top_channels``:
    the perturbation methods score only the top-k channels by activation
    energy (default: all)."""
    maps = raw_maps(method, visual_params, logit_scale, x11, text_features, text_mask,
                    valid, class_idx, cfg, policy, num_patches, top_channels)
    return _finish(maps, valid[:_pe(x11, num_patches)])


def _perturb_setup(visual_params, logit_scale, x11, text_features, text_mask,
                   valid, cfg, policy, top_channels):
    """ln_1 activations (L, D), the channels to score, and the re-scoring
    function: (K, L, D) activations -> (K, T) probabilities."""
    block11 = vit.block_params(visual_params["blocks"], cfg.vision_layers - 1)
    p = {"ln_post": visual_params["ln_post"], "proj": visual_params["proj"],
         "logit_scale": logit_scale}
    a0 = vit.layer_norm(x11, block11["ln_1"]["g"], block11["ln_1"]["b"])
    if top_channels is None:
        chans = torch.arange(a0.shape[1], device=a0.device)
    else:
        energy = a0[1:].abs().sum(dim=0)
        chans = torch.argsort(-energy, stable=True)[:top_channels]

    def probs_of(a):
        k = a.shape[0]
        rows = lambda t: t[None].expand(k, *t.shape).contiguous()
        x_out, _ = vit.block_forward_from_ln1(block11, rows(x11), a, cfg.vision_heads,
                                              valid=rows(valid), policy=policy)
        return _image_text_probs(p, x_out, text_features, rows(text_mask), rows(valid))

    return a0, chans, probs_of


def _chunked_scores(probs_of, make_inputs, chans: torch.Tensor,
                    chunk: int = 32) -> torch.Tensor:
    """(K, T) probabilities of the perturbed inputs, ``chunk`` channels a
    forward."""
    return torch.cat([probs_of(make_inputs(chans[s:s + chunk]))
                      for s in range(0, chans.shape[0], chunk)])


@torch.no_grad()
def _score_maps(visual_params, logit_scale, x11, text_features, text_mask, valid,
                class_idx, cfg, policy, top_channels, num_patches) -> torch.Tensor:
    a0, chans, probs_of = _perturb_setup(visual_params, logit_scale, x11, text_features,
                                         text_mask, valid, cfg, policy, top_channels)
    vmask = valid.bool()[:, None]
    big = 3.4e38

    def masked(ch):
        m = a0[:, ch].float()                                    # (L, K)
        mmin = torch.where(vmask, m, torch.full_like(m, big)).amin(dim=0)
        mmax = torch.where(vmask, m, torch.full_like(m, -big)).amax(dim=0)
        m = (m - mmin) / (mmax - mmin + 1e-7)
        return a0[None] * m.T[:, :, None]                        # (K, L, D)

    scores = _chunked_scores(probs_of, masked, chans)            # (K, T)
    w = torch.softmax(scores[:, class_idx], dim=0)               # (K, C)
    pe = _pe(x11, num_patches)
    return w.T @ a0[1:pe][:, chans].float().T


@torch.no_grad()
def _ablation_maps(visual_params, logit_scale, x11, text_features, text_mask, valid,
                   class_idx, cfg, policy, top_channels, num_patches) -> torch.Tensor:
    a0, chans, probs_of = _perturb_setup(visual_params, logit_scale, x11, text_features,
                                         text_mask, valid, cfg, policy, top_channels)
    base = probs_of(a0[None])[0]                                 # (T,)

    def ablated(ch):
        mask = torch.ones((ch.shape[0], a0.shape[1]), device=a0.device)
        mask[torch.arange(ch.shape[0], device=a0.device), ch] = 0.0
        return a0[None] * mask[:, None, :]

    abl = _chunked_scores(probs_of, ablated, chans)              # (K, T)
    w = ((base[None] - abl) / (base[None] + 1e-7))[:, class_idx]
    pe = _pe(x11, num_patches)
    return w.T @ a0[1:pe][:, chans].float().T


_PERTURBATION: Dict[str, Callable] = {"score_cam": _score_maps,
                                      "ablation_cam": _ablation_maps}


def score_cam(visual_params, logit_scale, x11, text_features, text_mask, valid,
              class_idx, cfg: ClipConfig, policy: precision.Policy = precision.DEFAULT,
              top_channels: Optional[int] = None,
              num_patches: Optional[int] = None) -> torch.Tensor:
    """ScoreCAM in block 11's ln_1 activation space: each channel, min-max
    normalized over the valid tokens, masks the activations; the class
    probabilities of those forwards, softmaxed over the channels, weight
    the channels."""
    return cam_single("score_cam", visual_params, logit_scale, x11, text_features,
                      text_mask, valid, class_idx, cfg, policy, num_patches, top_channels)


def ablation_cam(visual_params, logit_scale, x11, text_features, text_mask, valid,
                 class_idx, cfg: ClipConfig, policy: precision.Policy = precision.DEFAULT,
                 top_channels: Optional[int] = None,
                 num_patches: Optional[int] = None) -> torch.Tensor:
    """AblationCAM in block 11's ln_1 activation space: a channel's weight
    is (p - p with the channel zeroed) / p."""
    return cam_single("ablation_cam", visual_params, logit_scale, x11, text_features,
                      text_mask, valid, class_idx, cfg, policy, num_patches, top_channels)
