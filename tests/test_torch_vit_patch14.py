"""The port at patch 14 (CLIP ViT-L/14's patch), held to the benchmark's plain
reference (``benchmark/reference/``, plain torch) on seeded random weights
(``benchmark/weights.py``, OpenAI's key layout, a 16 x 16 positional grid
as ViT-L/14's 224-pixel input gives).

A small patch-14 tower runs on the CPU under the fp32 policy: width 128,
2 heads of 64, 6 layers (5 frozen blocks with their maps, GradCAM through
the sixth).  Held to the reference: one training step at crop 56 (4 x 4
tokens: the forward, the chain, the loss and every leaf's gradient), one
msc-flip batch with the CAM chain on canvases of 70 pixels (5 x 5 tokens,
not a multiple of 16), and the positional embedding interpolated from
16 x 16 to odd grids.  The same step and batch with the tower in bf16 fail
the tolerances, so they are tight enough to see a precision step.  The test
marked ``cuda`` replays the frozen forward of ViT-L/14 at its published
widths (23 captured blocks, width 1024, 16 heads) at 1370 tokens, bit-equal
to eager; run it there with
``python -m pytest --noconftest -m cuda tests/test_torch_vit_patch14.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import check, weights
from benchmark.reference import compaction as ref_compaction
from benchmark.reference import drive
from benchmark.reference import precision as ref_precision
from benchmark.reference import step as ref_step
from benchmark.reference import vit as ref_vit
from benchmark.reference import weclip as ref_weclip
from tests import torch_support  # noqa: F401
from weclip_tpu_torch.core import config as tconfig
from weclip_tpu_torch.core import precision
from weclip_tpu_torch.evalx.runner import Evaluator, make_prep
from weclip_tpu_torch.models import weclip
from weclip_tpu_torch.models.clip import graphs, vit
from weclip_tpu_torch.models.clip.loader import params_from_state_dict
from weclip_tpu_torch.train import step as step_mod
from weclip_tpu_torch.train.trainer import make_batcher

SEED = 4_294_967_311          # above 32 bits, as the benchmark's seeds are
CROP = 56                     # 4 x 14
RESIZE_LONG = MAX_ORI = 70    # canvases of 70 pixels: 5 x 14

# Tolerances of the fp32 program against the fp32 reference.  Both run the
# same plain math on the CPU and agree bit for bit with torch 2.x's CPU
# kernels; another build or thread count may sum in another order, which
# parts fp32 results by about 1e-6 of the largest value after six blocks
# and a backward.  1e-4 leaves a hundred times that, and stays far below
# what a bf16 tower (8 mantissa bits, 4e-3 a rounding) gives: 4e-3 on the
# step's logits, 7e-2 on the worst gradient, 1e-2 on the CAMs, the map and
# the evaluation logits.
TOL = {
    "seg": 1e-4,        # step-1 logits, widest gap over the largest
    "loss": 1e-4,       # relative gap of the step's loss
    "grad": 1e-4,       # each leaf's widest gradient gap over its largest
    "cam": 1e-4,        # GradCAM's CAMs, norm of the gap over the norm
    "attn_map": 1e-4,   # the last block's head-mean map, widest gap over the largest
    "par": 1e-4,        # PAR's scores on the same walk output
    "logits": 1e-4,     # scale-1 (single, flip-averaged) and scale-0.75 logits
    "msc_gap": 1e-4,    # msc logit of the program's class below the best
    "par_label": 1e-5,  # PAR score of the program's label below the best:
                        # 0 unless two scores tie within rounding
}


def cfg_dict(compute_dtype="float32"):
    """The small patch-14 configuration, in the benchmark's layout."""
    return {
        "dataset": {"name": "voc", "num_classes": 6, "crop_size": CROP,
                    "rescale_range": [0.5, 2.0], "ignore_index": 255,
                    "mean": [123.675, 116.28, 103.53], "std": [58.395, 57.12, 57.375]},
        "train": {"samples_per_gpu": 2, "max_iters": 100, "seed": 3,
                  "seg_trans_start_iter": 50, "attn_loss_weight": 0.1, "radius": 8},
        "optimizer": {"warmup_iter": 2},
        "clip": {"embedding_dim": 32, "in_channels": 128, "patch_size": 14,
                 "vision_width": 128, "vision_layers": 6, "vision_heads": 2,
                 "embed_dim": 32},
        "cam": {"attn_fuse_layers": 3, "seg_trans_layers": 2},
        "par": {"dilations": [1, 2], "num_iter": 4},
        "eval": {"resize_long": RESIZE_LONG, "scales": [1.0, 0.75], "use_flip": True,
                 "batch_images": 3},
        "precision": {"compute_dtype": compute_dtype, "param_dtype": "float32",
                      "softmax_dtype": "float32", "head_dtype": "float32"},
        "comer": {"enabled": False},
    }


def program_state(d):
    """The port's Config, frozen state and trainable tree from the
    benchmark's seeded weights, with the weights the reference reads."""
    cfg = tconfig.from_dict(d)
    num_fg = cfg.dataset.num_classes - 1
    sd = weights.clip_state_dict(SEED, d["clip"], "cpu")
    fg, bg = weights.class_features(SEED, num_fg, 25, cfg.clip.embed_dim, "cpu")
    visual = params_from_state_dict(
        sd, dataclasses.replace(cfg.clip, transformer_layers=1))["visual"]
    frozen = weclip.build_frozen_state(visual, sd["logit_scale"], fg, bg, "cpu")
    layout = weclip.init_trainable_params(torch.Generator().manual_seed(0), cfg, "cpu")
    values = weights.trainable_values(
        SEED, [(p, tuple(t.shape)) for p, t in weights.leaf_paths(layout)], "cpu")
    return cfg, frozen, weights.fill_tree(layout, values), (sd, fg, bg, values)


def rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / float(b.abs().max())


def rel_l2(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm()) / float(b.norm())


@pytest.fixture
def kept(monkeypatch):
    """GradCAM's CAMs and map, PAR's scores and the walk's output, as the
    port's chain produces them."""
    got = {"cams": [], "attn_last": [], "par": [], "refined": []}
    gradcam_batch, par_refine, chain = (weclip.gradcam_batch, weclip.par_refine_auto,
                                        weclip.pseudo_label_chain)

    def gradcam_kept(*a, **k):
        cam = gradcam_batch(*a, **k)
        got["cams"].append(cam.cams.detach().clone())
        got["attn_last"].append(cam.attn_last.detach().clone())
        return cam

    def par_kept(*a, **k):
        scores = par_refine(*a, **k)
        got["par"].append(scores.clone())
        return scores

    def chain_kept(*a, **k):
        labels, refined = chain(*a, **k)
        got["refined"].append(refined.clone())
        return labels, refined

    monkeypatch.setattr(weclip, "gradcam_batch", gradcam_kept)
    monkeypatch.setattr(weclip, "par_refine_auto", par_kept)
    monkeypatch.setattr(weclip, "pseudo_label_chain", chain_kept)
    return got


# -- one training step ---------------------------------------------------------

def host_batch(num_fg, b=2):
    rng = np.random.default_rng(7)
    img = rng.normal(size=(b, 3, CROP, CROP)).astype(np.float32)
    present = np.zeros((b, num_fg), bool)
    present[0, [0, 3]] = present[1, 2] = True
    return {"img": img, "present_mask": present}


def train_gaps(compute_dtype, kept):
    """One training step of the port (tower in ``compute_dtype``) and of
    the fp32 reference on the same batch; the reference trains on the
    port's pseudo labels and runs its chain's tail on the port's walk
    output, as the benchmark's check does.  Returns each number's gap."""
    d = cfg_dict(compute_dtype)
    cfg, frozen, params, (sd, fg, bg, values) = program_state(d)
    num_fg = cfg.dataset.num_classes - 1
    host = host_batch(num_fg)
    batch, ci, ca = make_batcher(cfg, frozen, "cpu")(host)
    state = step_mod.create_train_state(None, cfg, "cpu", params=params)
    outs = []
    forward_train = weclip.forward_train

    def forward_kept(*a, **k):
        outs.append(forward_train(*a, **k))
        return outs[-1]

    weclip.forward_train = forward_kept
    try:
        state, m = step_mod.make_train_step(cfg, precision.make_policy(compute_dtype))(
            state, frozen, batch, rng=11, cls_idx=ci, cls_active=ca)
    finally:
        weclip.forward_train = forward_train
    fwd = outs[0]

    rd = cfg_dict("float32")
    rcfg = drive.from_dict(rd)
    rfrozen = drive.frozen_state(sd, fg, bg, rcfg)
    rstate = ref_step.create_train_state(None, rcfg, "cpu",
                                         params=drive.trainable(rcfg, values))
    g = CROP // 14
    pe = rfrozen["visual"]["positional_embedding"].numpy()
    rbatch = ref_weclip.Batch(
        img=torch.from_numpy(host["img"]),
        pos_emb=torch.from_numpy(ref_vit.pos_emb_host(pe, g, g, g, g))[None],
        valid=torch.ones((2, g * g + 1), dtype=torch.bool), gh=torch.full((2,), g),
        gw=torch.full((2,), g), present_mask=torch.from_numpy(host["present_mask"]))
    rci, rca = ref_compaction.compact_classes(
        host["present_mask"], ref_compaction.pick_bucket(host["present_mask"], (4, num_fg)))
    keep = {"follow": kept["refined"][0]}
    rstate, rm = ref_step.make_train_step(rcfg, ref_precision.make_policy("float32"))(
        rstate, rfrozen, rbatch, 11, torch.from_numpy(rci), torch.from_numpy(rca),
        pseudo=fwd.cam_labels.detach(), keep=keep)
    assert torch.equal(ci, torch.from_numpy(rci)) and torch.equal(ca, torch.from_numpy(rca))

    leaves = step_mod.param_leaves(state.params)
    rleaves = ref_step.param_leaves(rstate.params)
    norms = [float(t.grad.norm()) for t in rleaves]
    med = float(np.median(norms))
    # leaves whose gradient is rounding alone (a key's bias under the
    # softmax) are left out, as the benchmark's check leaves them out
    grad = max(rel(p.grad, r.grad) for p, r, n in zip(leaves, rleaves, norms)
               if n >= 1e-3 * med)
    return {"seg": rel(fwd.seg, keep["out"].seg),
            "loss": abs(float(m.loss) - float(rm.loss)) / abs(float(rm.loss)),
            "grad": grad,
            "cam": rel_l2(kept["cams"][0], keep["cams"]),
            "attn_map": rel(kept["attn_last"][0], keep["attn_last"]),
            "par": rel(kept["par"][0], keep["tail_par"])}


def test_training_step_matches_the_reference_at_patch_14(kept):
    gaps = train_gaps("float32", kept)
    for k, v in gaps.items():
        assert v <= TOL[k], (k, v, gaps)


def test_a_bf16_tower_fails_the_training_tolerances(kept):
    gaps = train_gaps("bfloat16", kept)
    assert any(v > TOL[k] for k, v in gaps.items()), gaps
    assert gaps["seg"] > 10 * TOL["seg"], gaps


# -- one msc-flip batch with the CAM chain ----------------------------------------

def examples(num_fg):
    """Three labelled images whose scale-1 and scale-0.75 canvases (70
    pixels) are no multiple of 16, with ragged valid grids."""
    rng = np.random.default_rng(5)
    out = []
    for j, (h, w) in enumerate([(52, 70), (70, 47), (70, 70)]):
        label = np.zeros((h, w), np.uint8)
        ids = [1 + j, 3 + (j % 2)]
        label[h // 4:3 * h // 4, :w // 2] = ids[0]
        label[:h // 3, w // 2:] = ids[1]
        label[-3:, -3:] = 255
        present = np.zeros(num_fg, bool)
        present[[i - 1 for i in ids]] = True
        out.append({"name": f"im{j}", "img_raw": rng.integers(0, 256, (h, w, 3), np.uint8),
                    "label": label, "present_mask": present})
    return out


def eval_numbers(compute_dtype, kept):
    """The benchmark's evaluation numbers (``benchmark/check.py``) of one
    msc-flip batch of the port (tower in ``compute_dtype``) against the
    fp32 reference, which runs its chain's tail on the port's walk output."""
    d = cfg_dict(compute_dtype)
    cfg, frozen, params, (sd, fg, bg, values) = program_state(d)
    prep = make_prep(cfg, max_ori=MAX_ORI, resize_long=cfg.eval.resize_long)
    assert (prep.canvas_in1, prep.canvas_in2, prep.grid1, prep.grid2) == (70, 70, 5, 5)
    pe = frozen["visual"]["positional_embedding"].float().numpy()
    ev = Evaluator(cfg, prep, pe, policy=precision.make_policy(compute_dtype),
                   device="cpu")
    exs = examples(cfg.dataset.num_classes - 1)
    sb1, sb2, sizes, labels, presents, ci, ca = ev.build_batch(exs)
    with torch.no_grad():
        seg_single, seg_avg1, cam_labels = ev.scale1_for(ci.shape[1])(
            params, frozen, sb1, presents, sizes, ci, ca)
        seg_avg2 = ev.scale2(params, frozen, sb2, presents, sizes)
        hists = tuple(torch.zeros((6, 6), dtype=torch.int64) for _ in range(3))
        _, pred_msc, _ = ev.combine(seg_single, seg_avg1, seg_avg2, cam_labels, labels,
                                    sizes, hists)
    prog = {"seg_single": seg_single, "seg_avg1": seg_avg1, "seg_avg2": seg_avg2,
            "cam_labels": cam_labels, "pred_msc": pred_msc, "cams": kept["cams"][0],
            "attn_last": kept["attn_last"][0], "par": kept["par"][0]}
    ref = drive.eval_outputs(cfg_dict("float32"), sd, fg, bg, values, [exs], True, MAX_ORI,
                             "cpu", follow=[kept["refined"][0]])
    return check.eval_numbers([prog], ref, 14, True)


def test_msc_flip_batch_matches_the_reference_at_patch_14(kept):
    numbers = eval_numbers("float32", kept)
    assert set(numbers) == {"logits", "msc_gap", "cam", "attn_map", "par", "par_label"}
    for k, v in numbers.items():
        assert v <= TOL[k], (k, v, numbers)


def test_a_bf16_tower_fails_the_evaluation_tolerances(kept):
    numbers = eval_numbers("bfloat16", kept)
    assert numbers["logits"] > 10 * TOL["logits"], numbers
    assert numbers["attn_map"] > TOL["attn_map"], numbers


# -- the crop and the patch grid ------------------------------------------------

def refusals(cfg):
    from weclip_tpu_torch.train import seg_step
    frozen = weclip.random_frozen_state(cfg, seed=0)
    return {"make_batcher": lambda: make_batcher(cfg, frozen, "cpu"),
            "make_train_step": lambda: step_mod.make_train_step(cfg, precision.FP32),
            "make_seg_train_step": lambda: seg_step.make_seg_train_step(cfg, precision.FP32),
            "crop_grid": lambda: tconfig.crop_grid(cfg)}


@pytest.mark.parametrize("where", ["make_batcher", "make_train_step", "make_seg_train_step",
                                   "crop_grid"])
def test_a_crop_off_the_patch_grid_is_refused(where):
    """WeCLIP's crop of 320 on ViT-L/14's patch of 14: 22 patches and 12
    pixels left over, which the grid would cut off without a word."""
    d = cfg_dict()
    d["dataset"]["crop_size"] = 320
    with pytest.raises(ValueError, match=r"crop_size 320 .*patch_size 14.*308 or 322"):
        refusals(tconfig.from_dict(d))[where]()
    d["dataset"]["crop_size"] = 322
    assert tconfig.crop_grid(tconfig.from_dict(d)) == 23


def test_the_vitl14_yaml_is_weclips_voc_setup_at_crop_322():
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "configs" / "voc_vitl14.yaml"
    cfg = tconfig.load_config(str(path))
    c = cfg.clip
    assert (c.patch_size, c.vision_width, c.vision_layers, c.vision_heads, c.embed_dim,
            c.in_channels, c.transformer_width, c.transformer_heads) == (
        14, 1024, 24, 16, 768, 1024, 768, 12)
    assert cfg.dataset.crop_size == 322 and tconfig.crop_grid(cfg) == 23
    assert c.pretrained_path.endswith("ViT-L-14.pt")
    voc = tconfig.load_config(str(path.parent / "voc.yaml"))
    assert dataclasses.replace(cfg, clip=voc.clip, work_dir=voc.work_dir,
                               dataset=dataclasses.replace(cfg.dataset, crop_size=320)) == voc


# -- the positional embedding ----------------------------------------------------

@pytest.mark.parametrize("gh,gw,pad", [(5, 7, 7), (37, 37, 37), (23, 23, 23), (27, 35, 37)])
def test_positional_embedding_interpolates_16_by_16_to_odd_grids(gh, gw, pad):
    """ViT-L/14's 16 x 16 table resampled onto grids of any parity: the
    port's host and device forms against the reference, and the grid against
    torch's own bilinear resize (half-pixel centres, no antialiasing: the
    grids here only grow, and 27 of 16 has none to apply)."""
    d = cfg_dict()
    sd = weights.clip_state_dict(SEED, d["clip"], "cpu")
    table = sd["visual.positional_embedding"]
    assert table.shape == (16 * 16 + 1, 128)
    host = vit.pos_emb_host(table.numpy(), gh, gw, pad, pad)
    np.testing.assert_allclose(host, ref_vit.pos_emb_host(table.numpy(), gh, gw, pad, pad),
                               rtol=0, atol=1e-6)
    dev = vit.build_pos_emb({"positional_embedding": table}, gh, gw, pad, pad)
    np.testing.assert_allclose(dev.numpy(), host, rtol=0, atol=1e-5)
    grid = torch.nn.functional.interpolate(
        table[1:].reshape(1, 16, 16, -1).permute(0, 3, 1, 2), size=(gh, gw),
        mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    got = host[1:].reshape(pad, pad, -1)
    np.testing.assert_allclose(got[:gh, :gw], grid.numpy(), rtol=0, atol=1e-5)
    assert not got[gh:].any() and not got[:, gw:].any()
    np.testing.assert_array_equal(host[0], table[0].numpy())


# -- on the card ------------------------------------------------------------------

@pytest.fixture(scope="module")
def vitl14():
    """CLIP ViT-L/14 at its published widths, seeded, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tconfig.ClipConfig(patch_size=14, vision_width=1024, vision_layers=24,
                             vision_heads=16, embed_dim=768, in_channels=1024)
    sd = weights.clip_state_dict(SEED, {"vision_width": 1024, "vision_layers": 24,
                                        "patch_size": 14, "embed_dim": 768}, "cuda")
    visual = params_from_state_dict(
        sd, dataclasses.replace(cfg, transformer_layers=1))["visual"]
    return cfg, vit.tree_map(lambda t: t.to("cuda"), visual)


@pytest.mark.cuda
def test_vitl14_replay_is_bit_equal_to_eager_at_1370_tokens(vitl14, monkeypatch):
    """Evaluation's scale 1 at ViT-L/14: 16 rows on a 518-pixel canvas (37 x
    37 patches and CLS, 1370 tokens), each image valid on its own grid,
    maps exported for the first 8 rows through 23 blocks."""
    cfg, params = vitl14
    cache = graphs.ForwardGraphs("test_graph_vitl14")
    monkeypatch.setattr(vit, "FROZEN_GRAPHS", cache)
    pol = precision.make_policy("bfloat16")
    b, side, n = 16, 518, 37
    for call in range(4):
        g = torch.Generator(device="cuda").manual_seed(call)
        img = torch.randn((b, 3, side, side), generator=g, device="cuda")
        pe = torch.randn((b, 1 + n * n, 1024), generator=g, device="cuda") * 0.02
        grid = torch.zeros((b, n, n), dtype=torch.bool, device="cuda")
        grid[:, :26 + call, :37] = True
        valid = torch.cat([torch.ones((b, 1), dtype=torch.bool, device="cuda"),
                           grid.reshape(b, -1)], dim=1)
        got = vit.vision_forward_frozen(params, img, pe, valid, cfg, policy=pol,
                                        attn_rows=8)
        want = vit._forward_frozen(params, img, pe, valid, cfg, pol, True, 8)
        torch.cuda.synchronize()
        assert got.layer_tokens.shape == (23, b, 1370, 1024)
        assert got.layer_attn.shape == (23, 8, 1370, 1370)
        assert torch.equal(got.layer_tokens, want.layer_tokens), call
        assert torch.equal(got.layer_attn, want.layer_attn), call
        del got, want
    assert cache.states()[0][1] == "graph"
