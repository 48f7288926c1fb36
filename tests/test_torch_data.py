"""The port's data pipeline (weclip_tpu_torch/data/*) against the JAX
package's (weclip_tpu/data/*) on synthetic VOC and COCO trees written to
tmp_path: every transform and dataset item equal under the same
``random.Random`` seed, and PrefetchLoader batches equal in order."""

import dataclasses
import os
import random
import time

import numpy as np
import pytest
from PIL import Image

from tests import torch_support  # noqa: F401
from tests.test_coco_data import make_fake_coco
from weclip_tpu.core.config import DatasetConfig as JDatasetConfig
from weclip_tpu.data import coco as jcoco
from weclip_tpu.data import loader as jloader
from weclip_tpu.data import transforms as jtr
from weclip_tpu.data import voc as jvoc
from weclip_tpu_torch.core.config import DatasetConfig as TDatasetConfig
from weclip_tpu_torch.data import coco as tcoco
from weclip_tpu_torch.data import loader as tloader
from weclip_tpu_torch.data import transforms as ttr
from weclip_tpu_torch.data import voc as tvoc

NAMES = [f"img{i:02d}" for i in range(10)]


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """A VOC tree of 10 images of mixed sizes with 1-3 classes each, and
    the two packages' dataset configs for it."""
    root = tmp_path_factory.mktemp("voc")
    for sub in ("JPEGImages", "SegmentationClassAug", "lists", "Annotations"):
        (root / sub).mkdir()
    r = np.random.default_rng(0)
    cls_labels = {}
    for i, n in enumerate(NAMES):
        h, w = 40 + 6 * i, 70 - 3 * i
        Image.fromarray(r.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{n}.jpg")
        lab = np.zeros((h, w), np.uint8)
        ids = r.choice(20, 1 + i % 3, replace=False) + 1
        for j, c in enumerate(ids):
            lab[4 + 8 * j:12 + 8 * j, 3:3 + w // 2] = c
        lab[-3:] = 255
        Image.fromarray(lab, mode="L").save(root / "SegmentationClassAug" / f"{n}.png")
        onehot = np.zeros(20, np.float32)
        onehot[ids - 1] = 1
        cls_labels[n] = onehot
    np.save(root / "lists" / "cls_labels_onehot.npy", cls_labels)
    for split, names in (("train_aug", NAMES), ("val", NAMES[:4])):
        (root / "lists" / f"{split}.txt").write_text("\n".join(names))
    (root / "Annotations" / "a.xml").write_text(
        "<annotation><filename>a.jpg</filename>"
        "<object><name>dog</name></object><object><name>person</name></object>"
        "<object><name>unicorn</name></object></annotation>")
    kw = dict(root_dir=str(root), name_list_dir=str(root / "lists"), crop_size=48)
    return root, JDatasetConfig(**kw), TDatasetConfig(**kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transforms_match_jax(seed):
    """Each transform on uint8 and float images, with and without a label,
    from one seed: the same output and the same draws left in the rng."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (37, 51, 3)).astype(np.uint8)
    lab = rng.integers(0, 4, (37, 51)).astype(np.uint8)
    lab[:5] = 255
    np.testing.assert_array_equal(ttr.normalize_img(img), jtr.normalize_img(img))
    for im in (img, img.astype(np.float32)):
        for a, b in zip(ttr.rescale(im, 0.7, lab), jtr.rescale(im, 0.7, lab)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    calls = [
        lambda m, r: m.random_scaling(img, (0.5, 2.0), rng=r),
        lambda m, r: m.random_scaling(img, (0.5, 2.0), label=lab, rng=r),
        lambda m, r: m.random_fliplr(img, rng=r),
        lambda m, r: m.random_fliplr(img, lab, rng=r),
        lambda m, r: m.random_crop(img, 48, rng=r),
        lambda m, r: m.random_crop(img, 32, label=lab, rng=r),
        lambda m, r: m.random_crop(img.astype(np.float32), 64, label=lab, rng=r),
        lambda m, r: m.PhotoMetricDistortion()(img, rng=r),
    ]
    for i, call in enumerate(calls):
        for trial in range(4):
            rt, rj = random.Random(seed * 100 + trial), random.Random(seed * 100 + trial)
            got, want = call(ttr, rt), call(jtr, rj)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype, i
                np.testing.assert_array_equal(a, b, err_msg=f"call {i}")
            assert rt.random() == rj.random(), f"call {i} drew differently"


def test_voc_datasets_match_jax(voc):
    """VOCClsDataset.get_example under one seed, VOCSegDataset items (val
    and test stages), the class sets and the annotation reader."""
    root, jcfg, tcfg = voc
    jds, tds = jvoc.VOCClsDataset(jcfg, seed=3), tvoc.VOCClsDataset(tcfg, seed=3)
    assert len(tds) == len(jds) == len(NAMES)
    for idx in range(len(NAMES)):
        _assert_items_equal(tds.get_example(idx, random.Random(idx)),
                            jds.get_example(idx, random.Random(idx)))
    _assert_items_equal(tds[1], jds[1])          # the datasets' own rng
    for stage in ("val", "test"):
        jseg = jvoc.VOCSegDataset(jcfg, "val", stage=stage)
        tseg = tvoc.VOCSegDataset(tcfg, "val", stage=stage)
        for idx in range(len(tseg)):
            _assert_items_equal(tseg[idx], jseg[idx])
    lab = np.array([[0, 3, 255], [21, 7, 3]], np.uint8)
    np.testing.assert_array_equal(tvoc.class_set_from_label(lab, 20),
                                  jvoc.class_set_from_label(lab, 20))
    assert not tvoc.class_set_from_label(np.zeros((2, 2)), 20).any()
    xml = str(root / "Annotations" / "a.xml")
    np.testing.assert_array_equal(tvoc.classes_from_xml(xml), jvoc.classes_from_xml(xml))
    assert tvoc.CLASS_NAMES_VOC == __import__(
        "weclip_tpu.models.clip.prompts", fromlist=["x"]).CLASS_NAMES_VOC


def test_voc_decoded_cache_matches_jax(voc, tmp_path):
    """With a decoded-image cache the second read comes from the cache and
    equals the JAX package's."""
    _, jcfg, tcfg = voc
    cache = str(tmp_path / "cache")
    tds = tvoc.VOCSegDataset(dataclasses.replace(tcfg, decoded_cache_dir=cache))
    jds = jvoc.VOCSegDataset(jcfg)
    first = tds[2]
    assert os.path.exists(os.path.join(cache, NAMES[2] + ".npy"))
    _assert_items_equal(tds[2], first)
    _assert_items_equal(first, jds[2])


def test_voc_decoded_cache_needs_no_pil(voc, tmp_path, monkeypatch):
    """A tree already in the decoded cache reads with PIL unimportable
    (images and labels: the evaluation datasets' items), equal to the JAX
    package's items.  The training augmentation's rescale still uses PIL."""
    import sys
    _, jcfg, tcfg = voc
    cfg = dataclasses.replace(tcfg, decoded_cache_dir=str(tmp_path / "cache"))
    filled = [tvoc.VOCSegDataset(cfg, "val")[i] for i in range(4)]
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401
    seg = tvoc.VOCSegDataset(cfg, "val")
    for i in range(4):
        _assert_items_equal(seg[i], filled[i])
    assert seg.read_label(NAMES[3]).shape == seg.read_image(NAMES[3]).shape[:2]
    monkeypatch.undo()
    for i in range(4):
        _assert_items_equal(filled[i], jvoc.VOCSegDataset(jcfg, "val")[i])


def test_coco_datasets_match_jax(tmp_path):
    """CocoClsDataset.get_example and CocoSegDataset items, a grayscale
    image among them, at 81 classes."""
    root = str(tmp_path)
    make_fake_coco(root)
    kw = dict(name="coco", root_dir=root, name_list_dir=f"{root}/lists", num_classes=81,
              crop_size=64)
    jcfg, tcfg = JDatasetConfig(**kw), TDatasetConfig(**kw)
    jds, tds = jcoco.CocoClsDataset(jcfg, "train"), tcoco.CocoClsDataset(tcfg, "train")
    for idx in range(len(tds)):
        _assert_items_equal(tds.get_example(idx, random.Random(7 + idx)),
                            jds.get_example(idx, random.Random(7 + idx)))
    jseg, tseg = jcoco.CocoSegDataset(jcfg, "val"), tcoco.CocoSegDataset(tcfg, "val")
    for idx in range(len(tseg)):
        _assert_items_equal(tseg[idx], jseg[idx])
    assert tseg[1]["img_raw"].shape[-1] == 3 and tseg[0]["present_mask"].shape == (80,)


@pytest.mark.parametrize("process", [(0, 1), (1, 2)])
def test_prefetch_loader_matches_jax(voc, process):
    """Seven batches of 3 (two epochs of the shard) from both loaders, two
    threads each, equal in order; ``start`` skips to the same batches."""
    _, jcfg, tcfg = voc
    pi, pc = process
    jl = jloader.PrefetchLoader(jvoc.VOCClsDataset(jcfg), 3, seed=5, num_threads=2,
                                process_index=pi, process_count=pc)
    tl = tloader.PrefetchLoader(tvoc.VOCClsDataset(tcfg), 3, seed=5, num_threads=2,
                                process_index=pi, process_count=pc)
    skipped = tloader.PrefetchLoader(tvoc.VOCClsDataset(tcfg), 3, seed=5, num_threads=2,
                                     process_index=pi, process_count=pc, start=4)
    try:
        want = [next(jl) for _ in range(7)]
        got = [next(tl) for _ in range(7)]
        for a, b in zip(got, want):
            _assert_items_equal(a, b)
        for b in want[4:]:
            _assert_items_equal(next(skipped), b)
    finally:
        for ld in (jl, tl, skipped):
            ld.close()
    assert got[0]["img"].shape == (3, 3, 48, 48)


def test_prefetch_loader_forwards_errors_and_closes():
    """A worker's exception is raised in the consumer; a loader whose shard
    is smaller than a batch is refused; after ``close`` every thread ends
    and iteration stops."""
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, idx):
            if idx == 2:
                raise KeyError("bad example")
            return {"x": np.full(2, idx)}

    ld = tloader.PrefetchLoader(Broken(), 2, shuffle=False)
    with pytest.raises(KeyError, match="bad example"):
        for _ in range(3):
            next(ld)
    with pytest.raises(ValueError):
        tloader.PrefetchLoader(Broken(), 3, process_index=0, process_count=2)
    ld = tloader.PrefetchLoader([{"x": np.arange(2) + i, "n": str(i)} for i in range(4)], 2,
                                shuffle=False)
    first = next(iter(ld))
    np.testing.assert_array_equal(first["x"], [[0, 1], [1, 2]])
    assert first["n"].tolist() == ["0", "1"]
    ld.close()
    assert list(iter(ld)) == []
    deadline = time.monotonic() + 5
    for t in ld._threads + [ld._feeder]:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
        assert not t.is_alive()


def test_trainer_reads_the_configured_dataset(voc, tmp_path):
    """train(dataset=None) builds the training split of ``cfg.dataset``
    (VOC here; COCO by name) and trains on it through the loader."""
    from tests import tiny
    from weclip_tpu_torch.core import config as tconfig
    from weclip_tpu_torch.models import weclip as tweclip
    from weclip_tpu_torch.train import trainer as ttrainer

    _, _, dcfg = voc
    cfg = dataclasses.replace(tiny.tiny_config(num_classes=21),
                              clip=tiny.tiny_clip_config(layers=4))
    cfg = tconfig.from_dict(dataclasses.asdict(cfg))
    cfg = dataclasses.replace(
        cfg, dataset=dataclasses.replace(dcfg, crop_size=64),
        precision=dataclasses.replace(cfg.precision, compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, samples_per_gpu=2),
        work_dir=dataclasses.replace(cfg.work_dir, dir=str(tmp_path / "work")))
    assert isinstance(ttrainer.build_dataset(cfg), tvoc.VOCClsDataset)
    state = ttrainer.train(cfg, max_steps=1, device="cpu",
                           frozen=tweclip.random_frozen_state(cfg, seed=0))
    assert state.step == 1
    make_fake_coco(str(tmp_path / "coco"))
    coco = dataclasses.replace(cfg, dataset=TDatasetConfig(
        name="coco", root_dir=str(tmp_path / "coco"),
        name_list_dir=str(tmp_path / "coco" / "lists"), num_classes=81),
        train=dataclasses.replace(cfg.train, split="train"))
    ds = ttrainer.build_dataset(coco)
    assert isinstance(ds, tcoco.CocoClsDataset) and len(ds) == 3
