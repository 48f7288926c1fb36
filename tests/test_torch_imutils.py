"""The port's image helpers (weclip_tpu_torch/utils/imutils.py) against the
JAX package's on seeded numpy inputs: ``denormalize_img``, ``make_grid``
and ``tensorboard_label`` equal; the renderers that resize
(``tensorboard_image``, ``tensorboard_edge``, ``tensorboard_attn``,
``tensorboard_attn2``) within 1 of uint8, because the two bilinear resizes
may round a value apart at a colour-map step.  Each renderer runs with
matplotlib's colour maps and with the closed-form jet that stands in where
matplotlib does not import."""

import sys

import numpy as np
import pytest

from weclip_tpu.utils import imutils as jim
from weclip_tpu_torch.utils import imutils as tim


@pytest.fixture(params=["matplotlib", "closed_form"])
def cmap_branch(request, monkeypatch):
    if request.param == "closed_form":
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    return request.param


def _close(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()) <= 1


def _images(b=3, h=40, w=52, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 3, h, w)).astype(np.float32)


def test_denormalize_img_matches_jax():
    x = _images() * 2
    np.testing.assert_array_equal(tim.denormalize_img(x[0]), jim.denormalize_img(x[0]))
    np.testing.assert_array_equal(tim.denormalize_img(x), jim.denormalize_img(x))


@pytest.mark.parametrize("b,nrow,padding", [(1, 2, 2), (3, 2, 2), (5, 4, 0), (4, 1, 3)])
def test_make_grid_matches_jax(b, nrow, padding):
    imgs = np.random.default_rng(b).integers(0, 256, (b, 3, 9, 11)).astype(np.uint8)
    got = tim.make_grid(imgs, nrow, padding)
    np.testing.assert_array_equal(got, jim.make_grid(imgs, nrow, padding))


@pytest.mark.parametrize("shape", [(2, 17, 23), (17, 23)])
def test_tensorboard_label_matches_jax(shape):
    lab = np.random.default_rng(1).integers(0, 21, shape)
    lab[..., 0, :] = 255
    np.testing.assert_array_equal(tim.tensorboard_label(lab), jim.tensorboard_label(lab))


def test_tensorboard_image_matches_jax(cmap_branch):
    imgs = _images()
    cam = np.random.default_rng(2).uniform(0, 1, (3, 4, 5, 7)).astype(np.float32)
    for got, want in zip(tim.tensorboard_image(imgs, cam), jim.tensorboard_image(imgs, cam)):
        _close(got, want)


def test_tensorboard_edge_matches_jax(cmap_branch):
    edge = np.random.default_rng(3).uniform(0, 1, (3, 1, 10, 12)).astype(np.float32)
    _close(tim.tensorboard_edge(edge, size=(48, 40)),
           jim.tensorboard_edge(edge, size=(48, 40)))


def _attns(n=5, b=2, g=6, seed=4):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, b, g * g, g * g)).astype(np.float32)
    return list(a / a.sum(-1, keepdims=True))


@pytest.mark.parametrize("n_pix", [0.0, 0.5])
def test_tensorboard_attn_matches_jax(cmap_branch, n_pix):
    attns = _attns()
    _close(tim.tensorboard_attn(attns, (32, 32), n_pix),
           jim.tensorboard_attn(attns, (32, 32), n_pix))


@pytest.mark.parametrize("with_attn_pred", [True, False])
def test_tensorboard_attn2_matches_jax(cmap_branch, with_attn_pred):
    attns = _attns()
    got = tim.tensorboard_attn2(attns, (24, 24), with_attn_pred=with_attn_pred)
    want = jim.tensorboard_attn2(attns, (24, 24), with_attn_pred=with_attn_pred)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        _close(g, w)


def test_closed_form_branch_is_the_one_taken_without_matplotlib(monkeypatch):
    """Hiding matplotlib changes the colours (the closed-form jet is not
    viridis), so the two branches above are both exercised."""
    x = np.linspace(0, 1, 11, dtype=np.float32)
    with_mpl = tim._apply_cmap(x, "viridis")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    without = tim._apply_cmap(x, "viridis")
    assert not np.allclose(with_mpl, without)
    np.testing.assert_array_equal(without, jim._apply_cmap(x, "viridis"))
