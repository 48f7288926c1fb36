"""The port's dense CRF (weclip_tpu_torch/refine/crf.py) against the JAX
package's (weclip_tpu/refine/crf.py) on the CPU.

- the native lattice (``permutohedral_filter``, ``DenseCRF``,
  ``crf_inference``, ``crf_inference_label``) on the cases of
  tests/test_crf.py: the same source built with the same flags, so within
  1e-6;
- ``mean_field_crf`` against ``mean_field_crf_jax`` on both bilateral
  strategies (the windowed one forced with ``dense_max_points=0``), fp32
  probabilities within 1e-5 and equal argmax, the edge rows of the
  reference's wrap rule included; K7's plain twin against a brute-force
  statement of that rule and against the halo form csrc/crf.cu computes;
  a numpy model of K7's split-TF32 sum against float64;
- ``Evaluator.run(crf=True)`` for ``native`` and for ``jax`` at each of the
  three strategy picks, and ``WeCLIPPipeline.segment(crf=True)``, against
  the JAX package on tiny models with the same weights (fp32)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import tiny
from tests import torch_support  # noqa: F401
from weclip_tpu.core import precision as jprec
from weclip_tpu.core.config import CrfConfig as JCrfConfig
from weclip_tpu.evalx import metrics as jmetrics
from weclip_tpu.evalx import runner as jrunner
from weclip_tpu.models import weclip as jweclip
from weclip_tpu.refine import crf as jcrf
from weclip_tpu_torch import convert
from weclip_tpu_torch.core import config as tconfig
from weclip_tpu_torch.core import precision as tprec
from weclip_tpu_torch.evalx import runner as trunner
from weclip_tpu_torch.refine import crf as tcrf
from weclip_tpu_torch.refine import crf_kernels

LATTICE_TOL = 1e-6
MF_TOL = 1e-5


def _synthetic_case(rng, h=40, w=40, c=3):
    """tests/test_crf.py's two-region image with noisy unaries."""
    img = np.zeros((h, w, 3), np.uint8)
    img[:, : w // 2] = (200, 30, 30)
    img[:, w // 2:] = (30, 30, 200)
    gt = np.zeros((h, w), np.int64)
    gt[:, w // 2:] = 1
    probs = np.full((c, h, w), 0.05, np.float32)
    for lab in range(2):
        probs[lab][gt == lab] = 0.8
    noise = rng.random((h, w)) < 0.15
    flip = probs[0].copy()
    probs[0][noise] = probs[1][noise]
    probs[1][noise] = flip[noise]
    probs /= probs.sum(0, keepdims=True)
    return img, probs, gt


def _lattice_case(name):
    rng = np.random.default_rng(0)
    if name == "filter_2d":
        args = (rng.uniform(0, 6, (300, 2)).astype(np.float32),
                rng.standard_normal((300, 4)).astype(np.float32))
        return args, (lambda m: m.permutohedral_filter(*args))
    if name == "filter_5d":
        args = (rng.uniform(0, 4, (200, 5)).astype(np.float32),
                rng.standard_normal((200, 2)).astype(np.float32))
        return args, (lambda m: m.permutohedral_filter(*args))
    img, probs, _ = _synthetic_case(rng)
    if name == "dense_crf":
        return None, (lambda m: m.DenseCRF(iter_max=10, pos_xy_std=3, pos_w=3, bi_xy_std=16,
                                           bi_rgb_std=5, bi_w=4)(img, probs))
    if name == "dense_crf_reference_params":
        return None, (lambda m: m.DenseCRF.from_config(JCrfConfig())(img, probs))
    if name == "crf_inference":
        return None, (lambda m: m.crf_inference(img, probs, t=5, labels=3))
    labels = probs.argmax(0).astype(np.int64)
    return None, (lambda m: m.crf_inference_label(img, labels, t=5, n_labels=3))


@pytest.mark.parametrize("name", ["filter_2d", "filter_5d", "dense_crf",
                                  "dense_crf_reference_params", "crf_inference",
                                  "crf_inference_label"])
def test_native_lattice_matches_jax(name):
    """The port's own copy of permutohedral.cc, built into
    weclip_tpu_torch/_build, gives the JAX package's numbers."""
    _, fn = _lattice_case(name)
    got, want = fn(tcrf), fn(jcrf)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=LATTICE_TOL)
    from weclip_tpu_torch.native import build
    assert build.lib_path().parent.name == "_build" and build.lib_path().exists()


def _mf_inputs(h, w, c, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    # a smooth two-region image, so the bilateral term matters
    img[: h // 2, : w // 3] = (220, 40, 40)
    probs = rng.random((c, h, w)).astype(np.float32) + 0.1
    probs[0, : h // 2, : w // 3] += 1.0
    probs /= probs.sum(0, keepdims=True)
    return probs, img.transpose(2, 0, 1).astype(np.float32)


@pytest.mark.parametrize("h, w, c, stride, dense_max, bi_xy", [
    (40, 40, 3, 4, 4096, 64.0),      # dense: 100 points, the reference sigmas
    (37, 45, 4, 2, 4096, 16.0),      # dense, odd sizes
    (48, 40, 5, 4, 0, 16.0),         # windowed, r = 8 on a 12 x 10 grid (wraps)
    (40, 52, 4, 2, 0, 6.0),          # windowed, r = 6 on 20 x 26
])
def test_mean_field_crf_matches_jax(h, w, c, stride, dense_max, bi_xy):
    """mean_field_crf on one image and on a batch of two against
    mean_field_crf_jax (fp32): probabilities within 1e-5, argmax equal."""
    cfg = dict(iter_max=4, bi_xy_std=bi_xy)
    ins = [_mf_inputs(h, w, c, s) for s in (1, 2)]
    want = [np.asarray(jcrf.mean_field_crf_jax(
        jnp.asarray(p), jnp.asarray(im), JCrfConfig(**cfg), bi_stride=stride,
        dense_max_points=dense_max)) for p, im in ins]
    one = tcrf.mean_field_crf(torch.from_numpy(ins[0][0]), torch.from_numpy(ins[0][1]),
                              tconfig.CrfConfig(**cfg), bi_stride=stride,
                              dense_max_points=dense_max).numpy()
    batch = tcrf.mean_field_crf(torch.from_numpy(np.stack([p for p, _ in ins])),
                                torch.from_numpy(np.stack([im for _, im in ins])),
                                tconfig.CrfConfig(**cfg), bi_stride=stride,
                                dense_max_points=dense_max).numpy()
    for got, ref in ((one, want[0]), (batch[0], want[0]), (batch[1], want[1])):
        np.testing.assert_allclose(got, ref, rtol=0, atol=MF_TOL)
        np.testing.assert_array_equal(got.argmax(0), ref.argmax(0))


def test_window_message_keeps_the_reference_wrap_rule():
    """K7's plain twin reads the rolled neighbour (y - dy, x - dx) mod the
    grid but masks by (y + dy, x + dx), as mean_field_crf_jax does: equal to
    a brute-force statement of that rule everywhere, equal to the true
    window in the interior and different from it within r of an edge."""
    rng = np.random.default_rng(5)
    hs, ws, r, sig = 12, 12, 3, 2.0
    q = rng.random((1, 2, hs, ws)).astype(np.float32)
    img = (rng.random((1, 3, hs, ws)) * 3).astype(np.float32)
    acc, norm = crf_kernels.window_message_plain(torch.from_numpy(q), torch.from_numpy(img),
                                                 sig, r)
    rule, true = np.zeros((2, hs, ws)), np.zeros((2, hs, ws))
    rule_n = np.zeros((hs, ws))
    for y in range(hs):
        for x in range(ws):
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    if 0 <= y + dy < hs and 0 <= x + dx < ws:
                        sy, sx = (y - dy) % hs, (x - dx) % ws
                        k = np.exp(-0.5 * ((dy * dy + dx * dx) / sig ** 2
                                           + ((img[0, :, y, x] - img[0, :, sy, sx]) ** 2).sum()))
                        rule[:, y, x] += k * q[0, :, sy, sx]
                        rule_n[y, x] += k
                        ty, tx = y + dy, x + dx
                        kt = np.exp(-0.5 * ((dy * dy + dx * dx) / sig ** 2
                                            + ((img[0, :, y, x] - img[0, :, ty, tx]) ** 2).sum()))
                        true[:, y, x] += kt * q[0, :, ty, tx]
    np.testing.assert_allclose(acc[0].numpy(), rule, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(norm[0, 0].numpy(), rule_n, rtol=1e-5, atol=1e-5)
    inner = (slice(None), slice(r, hs - r), slice(r, ws - r))
    np.testing.assert_allclose(acc[0].numpy()[inner], true[inner], rtol=1e-5, atol=1e-5)
    assert np.abs(acc[0].numpy() - true).max() > 0.1


def _halo_window_sum(q, img, sig, r, tile=(8, 32)):
    """K7's window sum in the virtual-coordinate form csrc/crf.cu takes, in
    float64: for each tile of output pixels, the halo [y0 - r, y1 + r] x
    [x0 - r, x1 + r] read with modular addressing (source row sy_v holds
    row sy_v mod hs), and a pair (y, sy_v) counted iff |y - sy_v| <= r and
    2y - hs < sy_v <= 2y, columns alike."""
    c, hs, ws = q.shape
    acc, norm = np.zeros((c, hs, ws)), np.zeros((hs, ws))
    q, img = q.astype(np.float64), img.astype(np.float64)
    for y0 in range(0, hs, tile[0]):
        for x0 in range(0, ws, tile[1]):
            ys, xs = np.arange(y0, min(y0 + tile[0], hs)), np.arange(x0, min(x0 + tile[1], ws))
            vy = np.arange(ys[0] - r, ys[-1] + r + 1)
            vx = np.arange(xs[0] - r, xs[-1] + r + 1)
            hq = q[:, vy % hs][:, :, vx % ws]
            hi = img[:, vy % hs][:, :, vx % ws]
            my = ((np.abs(ys[:, None] - vy) <= r) & (vy > 2 * ys[:, None] - hs)
                  & (vy <= 2 * ys[:, None]))
            mx = ((np.abs(xs[:, None] - vx) <= r) & (vx > 2 * xs[:, None] - ws)
                  & (vx <= 2 * xs[:, None]))
            dist2 = (((ys[:, None] - vy) ** 2)[:, None, :, None]
                     + ((xs[:, None] - vx) ** 2)[None, :, None, :]) / sig ** 2
            pix = img[:, ys][:, :, xs]
            cd2 = ((pix[:, :, :, None, None] - hi[:, None, None]) ** 2).sum(0)
            k = np.exp(-0.5 * (dist2 + cd2)) * (my[:, None, :, None] & mx[None, :, None, :])
            acc[:, ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] = np.einsum("yxab,cab->cyx", k, hq)
            norm[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] = k.sum((2, 3))
    return acc, norm


@pytest.mark.parametrize("hs,ws,r", [(12, 12, 0), (12, 12, 3), (12, 12, 13), (9, 13, 4),
                                     (7, 11, 12), (15, 9, 2), (17, 40, 20)])
def test_halo_rule_matches_the_plain_twin(hs, ws, r):
    """The index arithmetic of K7 (csrc/crf.cu) where there is no card: its
    virtual-coordinate halo with modular reads and pair mask
    (``_halo_window_sum``, tiles of 8 x 32 pixels) equals K7's plain twin,
    the reference's offset loop, within 1e-6 of each output's largest, at r
    0, r past the grid and on non-square odd grids.  Both sum in float64
    (the twin given float64 tensors): in fp32 the twin's own rounding over
    a 41 x 41 window reaches 1.9e-6."""
    rng = np.random.default_rng(hs * 100 + ws + r)
    q = rng.random((3, hs, ws)).astype(np.float32)
    img = (rng.random((3, hs, ws)) * 2).astype(np.float32)
    acc, norm = _halo_window_sum(q, img, 2.5, r)
    ref_acc, ref_norm = crf_kernels.window_message_plain(
        torch.from_numpy(q[None]).double(), torch.from_numpy(img[None]).double(), 2.5, r)
    for got, ref in ((acc, ref_acc[0].numpy()), (norm, ref_norm[0, 0].numpy())):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


KAPPA = np.float32(0.72134752044448170)   # log2(e) / 2


def _ex2_weights(pix, src, dy, dx, r, sig2):
    """K7's weights as csrc/crf.cu forms them in fp32, for pixels (3, P)
    and sources (3, S) at offsets dy, dx (P, S): 2^(kappa / sig^2 (-dy^2)
    - kappa / sig^2 dx^2 - kappa cd2), 0 past the window."""
    cs = np.float32(KAPPA / np.float32(sig2))
    ey = -(dy ** 2).astype(np.float32) * cs
    ex = (dx ** 2).astype(np.float32) * cs
    cd2 = ((pix[:, :, None] - src[:, None, :]) ** 2).sum(0, dtype=np.float32)
    w = np.exp2(((ey - ex) - KAPPA * cd2).astype(np.float32))
    return np.where((np.abs(dy) <= r) & (np.abs(dx) <= r), w, 0).astype(np.float32)


def test_split_tf32_window_sum_error():
    """K7's sum as csrc/crf.cu takes it, modelled in numpy at a COCO-like
    window (81 channels and the ones column, r 32, sig 16, a 72 x 72 grid
    cut from COCO's 160 x 160 at stride 4): one warp's two m16 tiles (4 rows
    x 8 columns) over their halo, each k-step of 8 sources three TF32
    products of split operands (lo B_hi, hi B_hi, hi B_lo), each addition
    truncated as the tensor cores do, into a fresh accumulator, then added
    to the fp32 total rounded to nearest.  Against float64 on the same fp32
    weights, the message and the normalizer stay within 2e-6 of each
    output's largest, a fifth of the card's 1e-5 tolerance against the fp32
    twin (measured 1.17e-6 and 7.1e-7), and within 1.5 times strict fp32's
    own distance from float64 (1.24e-6 and 8.4e-7): the fp32 sum of 612
    k-steps, not the products, sets the error."""
    from tests.test_torch_attention import _tf32, _toward_zero
    rng = np.random.default_rng(81)
    hs = ws = 72
    r, sig, c = 32, 16.0, 81
    q = rng.random((c, hs, ws)).astype(np.float32)
    q /= q.sum(0, keepdims=True)
    img = (rng.random((3, hs, ws)) * 2).astype(np.float32)
    bq = np.concatenate([q, np.ones((1, hs, ws), np.float32)])   # the ones column
    y0, x0, big_r = 34, 32, 32                                    # R: r rounded up to 4
    pys, pxs = np.repeat(np.arange(y0, y0 + 4), 8), np.tile(np.arange(x0, x0 + 8), 4)
    pix = img[:, pys, pxs]
    f64 = lambda a: a.astype(np.float64)
    total = np.zeros((32, c + 1), np.float32)
    strict = np.zeros((32, c + 1), np.float32)
    exact = np.zeros((32, c + 1))
    for sy in range(y0 - r, y0 + 3 + r + 1):
        for k0 in range(x0 - big_r, x0 + 8 + big_r, 8):
            sx = np.arange(k0, k0 + 8)
            dy = np.broadcast_to((pys - sy)[:, None], (32, 8))
            w = _ex2_weights(pix, img[:, sy % hs, sx % ws], dy, pxs[:, None] - sx, r, sig * sig)
            b = bq[:, sy % hs, sx % ws].T                      # (8 sources, c + 1)
            ah, bh = _tf32(w), _tf32(b)
            al, bl = _tf32(w - ah), _tf32(b - bh)
            part = np.zeros_like(total)
            for x, y in ((al, bh), (ah, bh), (ah, bl)):
                part = _toward_zero(f64(part) + f64(x) @ f64(y))
            total = (total + part).astype(np.float32)
            strict = (strict + w @ b).astype(np.float32)
            exact += f64(w) @ f64(b)
    scale = np.abs(exact).max(0)
    err = (np.abs(f64(total) - exact) / scale).max(0)
    strict_err = (np.abs(f64(strict) - exact) / scale).max(0)
    assert err[:c].max() <= 2e-6 and err[c] <= 2e-6, (err[:c].max(), err[c])
    assert err[:c].max() <= 1.5 * strict_err[:c].max(), (err[:c].max(), strict_err[:c].max())
    assert err[c] <= 1.5 * strict_err[c], (err[c], strict_err[c])


# ---------------------------------------------------------------------------
# Evaluator.run(crf=True) and WeCLIPPipeline.segment(crf=True)
# ---------------------------------------------------------------------------

# the output canvas is 136: stride 4 gives 34^2 = 1156 points (dense,
# batched), 2 gives 4624 (dense, one image at a time), 1 gives 18496
# (windowed, K7's twin; bi_xy_std 3 keeps its window at r = 6)
SIZES = [(136, 120), (100, 130), (90, 70)]
PRESENT = [(0, 4), (1,), (2, 3, 4)]
CRF = dict(iter_max=3, bi_xy_std=3.0)


def _examples(num_fg):
    rng = np.random.default_rng(7)
    out = []
    for i, ((oh, ow), ids) in enumerate(zip(SIZES, PRESENT)):
        present = np.zeros(num_fg, bool)
        present[list(ids)] = True
        label = rng.choice([0] + [c + 1 for c in ids], (oh, ow)).astype(np.int32)
        label[: oh // 6] = 255
        img = rng.integers(0, 256, (oh, ow, 3)).astype(np.uint8)
        img[oh // 3:, : ow // 2] = (30, 160, 60)
        out.append({"name": f"img{i}", "img_raw": img, "label": label,
                    "present_mask": present})
    return out


@pytest.fixture(scope="module")
def models():
    """The JAX and the port's tiny configs, weights and examples."""
    cfg = tiny.tiny_config(num_classes=6)
    cfg = dataclasses.replace(
        cfg, clip=tiny.tiny_clip_config(layers=4),
        eval=dataclasses.replace(cfg.eval, resize_long=96, batch_images=2,
                                 crf=JCrfConfig(**CRF)))
    tcfg = tconfig.from_dict(dataclasses.asdict(cfg))
    frozen, clip_params = tiny.tiny_frozen(cfg)
    params = jweclip.init_trainable_params(jax.random.PRNGKey(1), cfg)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"cfg": cfg, "tcfg": tcfg, "frozen": frozen, "params": params,
            "clip_params": clip_params,
            "tfrozen": convert.frozen_from_jax(np_tree(frozen)),
            "tparams": convert.params_from_jax(np_tree(params)),
            "pe": np.asarray(frozen["visual"]["positional_embedding"]),
            "examples": _examples(cfg.dataset.num_classes - 1)}


@pytest.mark.parametrize("impl, stride", [("native", 4), ("jax", 4), ("jax", 2),
                                          ("jax", 1)])
def test_eval_run_crf_matches_jax(models, monkeypatch, impl, stride):
    """crf_seg histograms equal to JAX's (int64, every labelled pixel
    counted), at each of the jax implementation's three strategy picks."""
    m = models
    max_ori = max(max(s) for s in SIZES)
    jhists, orig = [], jmetrics.scores
    monkeypatch.setattr(jmetrics, "scores", lambda h: jhists.append(np.asarray(h)) or orig(h))
    jev = jrunner.Evaluator(m["cfg"], jrunner.make_prep(m["cfg"], max_ori, 96), m["pe"],
                            policy=jprec.FP32, with_cam=False)
    jres = jev.run(m["params"], m["frozen"], m["examples"], crf=True, crf_impl=impl,
                   crf_stride=stride)
    tev = trunner.Evaluator(m["tcfg"], trunner.make_prep(m["tcfg"], max_ori, 96), m["pe"],
                            policy=tprec.FP32, with_cam=False, device="cpu")
    assert tev.prep.canvas_out == 136
    tres = tev.run(m["tparams"], m["tfrozen"], m["examples"], crf=True, crf_impl=impl,
                   crf_stride=stride, return_hists=True)
    got = tres["hists"]["crf_seg"]
    n = sum(int(((ex["label"] >= 0) & (ex["label"] < 6)).sum()) for ex in m["examples"])
    assert got.dtype == np.int64 and int(got.sum()) == n
    np.testing.assert_array_equal(got, jhists[2].astype(np.int64))   # seg, msc, crf
    np.testing.assert_array_equal(tres["hists"]["msc_seg"], jhists[1].astype(np.int64))
    assert tres["crf_seg"]["miou"] == pytest.approx(jres["crf_seg"]["miou"], abs=1e-12)


def test_segment_crf_matches_jax(models):
    """WeCLIPPipeline.segment(crf=True) (the exact lattice on the host)
    gives JAX's labels on the same weights."""
    from weclip_tpu.api import WeCLIPPipeline as JPipeline
    from weclip_tpu_torch.api import WeCLIPPipeline as TPipeline
    m = models
    jpipe = JPipeline(m["cfg"], precision_name="float32")
    jpipe.frozen, jpipe.params, jpipe.clip_params = m["frozen"], m["params"], m["clip_params"]
    tpipe = TPipeline(m["tcfg"], precision_name="float32", device="cpu",
                      weights={"params": m["tparams"], "frozen": m["tfrozen"]})
    img = m["examples"][1]["img_raw"]
    got = tpipe.segment(img, crf=True)
    assert got.dtype == np.int32 and got.shape == img.shape[:2]
    np.testing.assert_array_equal(got, jpipe.segment(img, crf=True))


def test_native_build_writes_only_build_dir_and_raises_on_failure(tmp_path, monkeypatch):
    """native/build.py compiles into its build directory, named by a hash
    of source and flags, never into the source tree; a failing compile
    raises with the compiler's output."""
    from weclip_tpu_torch.native import build
    src_dir = set(os.listdir(os.path.dirname(build.__file__)))
    assert not any(n.endswith(".so") for n in src_dir)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS + ["-DNOT_A_FLAG=1"])
    path = build.build()
    assert path.parent == tmp_path / "b" and path.name.startswith("libpermutohedral_")
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS + ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="g\\+\\+ permutohedral.cc failed"):
        build.build()
