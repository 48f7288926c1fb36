"""The port's dataset evaluation (weclip_tpu_torch/evalx/runner.py::
Evaluator.run, engine.make_eval_combine) against the JAX package's
Evaluator.run at a tiny size (width 64, 2 heads, 4 layers, resize_long 96),
the same weights (convert.py) and the same three labelled examples under
the fp32 policy, two images a batch, so the last batch is padded.

The histograms must be equal, or differ on at most 0.1% of the counted
pixels, each of whose two largest msc logits lie within 1e-4; the saved
prediction PNGs equal; the saved logits within 1e-4."""

import dataclasses
import os

import numpy as np
import pytest
from PIL import Image

import jax

from tests import tiny
from tests import torch_support  # noqa: F401
from weclip_tpu.core import precision as jprec
from weclip_tpu.evalx import runner as jrunner
from weclip_tpu.models import weclip as jweclip
from weclip_tpu_torch import convert
from weclip_tpu_torch.core import config as tconfig
from weclip_tpu_torch.core import precision as tprec
from weclip_tpu_torch.evalx import runner as trunner

LOGIT_TOL = 1e-4
SIZES = [(40, 56), (56, 36), (30, 50)]
PRESENT = [(0, 4), (1,), (2, 3, 4)]


def _examples(num_fg):
    rng = np.random.default_rng(4)
    out = []
    for i, ((oh, ow), ids) in enumerate(zip(SIZES, PRESENT)):
        present = np.zeros(num_fg, bool)
        present[list(ids)] = True
        label = rng.choice([0] + [c + 1 for c in ids], (oh, ow)).astype(np.int32)
        label[: oh // 5] = 255
        out.append({"name": f"img{i}",
                    "img_raw": rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8),
                    "label": label, "present_mask": present})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' Evaluator.run over the three examples, saving
    predictions and logits."""
    cfg = tiny.tiny_config(num_classes=6)
    cfg = dataclasses.replace(
        cfg, clip=tiny.tiny_clip_config(layers=4),
        eval=dataclasses.replace(cfg.eval, resize_long=96, batch_images=2))
    tcfg = tconfig.from_dict(dataclasses.asdict(cfg))
    frozen, _ = tiny.tiny_frozen(cfg)
    params = jweclip.init_trainable_params(jax.random.PRNGKey(1), cfg)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tfrozen, tparams = convert.frozen_from_jax(np_tree(frozen)), convert.params_from_jax(
        np_tree(params))
    pe = np.asarray(frozen["visual"]["positional_embedding"])
    max_ori = max(max(s) for s in SIZES)
    examples = _examples(cfg.dataset.num_classes - 1)
    out = {"examples": examples, "tcfg": tcfg, "tparams": tparams, "tfrozen": tfrozen,
           "pe": pe, "max_ori": max_ori, "jcfg": cfg, "jparams": params, "jfrozen": frozen}
    for name, mod, prec, c, p, f, kw in (
            ("jax", jrunner, jprec.FP32, cfg, params, frozen, {}),
            ("torch", trunner, tprec.FP32, tcfg, tparams, tfrozen, {"device": "cpu"})):
        d = tmp_path_factory.mktemp(name)
        ev = mod.Evaluator(c, mod.make_prep(c, max_ori, 96), pe, policy=prec, **kw)
        res = ev.run(p, f, examples, save_dir=str(d / "pred"), logits_dir=str(d / "logits"),
                     return_hists=True)
        out[name] = (res, d)
    return out


def _counted(examples):
    return sum(int(((ex["label"] >= 0) & (ex["label"] < 6)).sum()) for ex in examples)


def test_eval_run_histograms_match_jax(runs):
    """Histograms seg, msc_seg and cam, and their scores; every counted
    pixel of the ragged tail's padding left out."""
    (jres, _), (tres, tdir) = runs["jax"], runs["torch"]
    n = _counted(runs["examples"])
    for key in ("seg", "msc_seg", "cam"):
        got, want = tres["hists"][key], np.asarray(jres["hists"][key]).astype(np.int64)
        assert got.dtype == np.int64 and int(got.sum()) == n, key
        diff = int(np.abs(got - want).sum()) // 2
        assert diff <= 0.001 * n, (key, diff)
        if diff:
            # each differing pixel is a near tie of the two largest logits
            assert key == "msc_seg", key
            for ex in runs["examples"]:
                lg = np.load(os.path.join(tdir, "logits", "logit", ex["name"] + ".npy"),
                             allow_pickle=True).item()["msc_segs"][0]
                top2 = np.sort(lg, axis=0)[-2:]
                pred = np.asarray(Image.open(os.path.join(
                    runs["jax"][1], "pred", "prediction", ex["name"] + ".png")))
                off = pred != lg.argmax(0)
                assert np.all(top2[1][off] - top2[0][off] <= LOGIT_TOL)
        for s in ("pAcc", "mAcc", "miou"):
            np.testing.assert_allclose(tres[key][s], jres[key][s], rtol=1e-6,
                                       atol=1e-6 if diff else 0, err_msg=f"{key} {s}")
    assert tres["seg"]["miou"] == tres["seg"]["miou"]     # not NaN


def test_eval_run_saves_match_jax(runs):
    """The prediction PNGs (ids and palette) equal; the logit npys (the
    scale-1 grid cropped to the image's grid, the msc logits at the image's
    size) within 1e-4."""
    (_, jdir), (_, tdir) = runs["jax"], runs["torch"]
    for ex in runs["examples"]:
        oh, ow = ex["label"].shape
        for sub in ("prediction", "prediction_cmap"):
            a = np.asarray(Image.open(tdir / "pred" / sub / (ex["name"] + ".png")))
            b = np.asarray(Image.open(jdir / "pred" / sub / (ex["name"] + ".png")))
            assert a.shape[:2] == (oh, ow)
            np.testing.assert_array_equal(a, b, err_msg=f"{sub} {ex['name']}")
        a, b = (np.load(d / "logits" / "logit" / (ex["name"] + ".npy"),
                        allow_pickle=True).item() for d in (tdir, jdir))
        assert a["msc_segs"].shape == (1, 6, oh, ow)
        for key in ("segs", "msc_segs"):
            assert a[key].shape == b[key].shape, key
            np.testing.assert_allclose(a[key], b[key], rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                       err_msg=key)


def test_eval_run_options(runs, monkeypatch):
    """``max_images`` and explicit process sharding (the local shard's
    histograms, which sum to the whole), ``with_cam=False`` (no cam
    scores), and ``crf=True`` (the exact lattice): its ``crf_seg``
    histogram equal to JAX's, every labelled pixel counted."""
    tcfg, tparams, tfrozen = runs["tcfg"], runs["tparams"], runs["tfrozen"]
    examples = runs["examples"]
    ev = trunner.Evaluator(tcfg, trunner.make_prep(tcfg, runs["max_ori"], 96), runs["pe"],
                           policy=tprec.FP32, device="cpu")
    one = ev.run(tparams, tfrozen, examples, max_images=1, return_hists=True)
    assert int(one["hists"]["seg"].sum()) == _counted(examples[:1])
    full = runs["torch"][0]["hists"]
    shards = [ev.run(tparams, tfrozen, examples, return_hists=True, process_index=i,
                     process_count=2)["hists"] for i in range(2)]
    assert int(shards[1]["seg"].sum()) == _counted(examples[1:2])
    for key in ("seg", "msc_seg", "cam"):
        np.testing.assert_array_equal(shards[0][key] + shards[1][key], full[key])
    with pytest.raises(ValueError):
        ev.run(tparams, tfrozen, examples, process_index=0)
    from weclip_tpu.evalx import metrics as jmetrics
    jhists, orig = [], jmetrics.scores
    monkeypatch.setattr(jmetrics, "scores", lambda h: jhists.append(np.asarray(h)) or orig(h))
    jev = jrunner.Evaluator(runs["jcfg"], jrunner.make_prep(runs["jcfg"], runs["max_ori"], 96),
                            runs["pe"], policy=jprec.FP32)
    jres = jev.run(runs["jparams"], runs["jfrozen"], examples, crf=True)
    tres = ev.run(tparams, tfrozen, examples, crf=True, return_hists=True)
    got = tres["hists"]["crf_seg"]
    assert got.dtype == np.int64 and int(got.sum()) == _counted(examples)
    np.testing.assert_array_equal(got, jhists[3].astype(np.int64))  # seg, msc, cam, crf
    assert tres["crf_seg"]["miou"] == jres["crf_seg"]["miou"]
    seg_only = trunner.Evaluator(tcfg, ev.prep, runs["pe"], policy=tprec.FP32,
                                 with_cam=False, device="cpu")
    res = seg_only.run(tparams, tfrozen, examples, max_images=2, return_hists=True)
    assert "cam" not in res and "cam" not in res["hists"]
