"""The port's command-line entry points (weclip_tpu_torch/cli/*) on a synthetic
VOC tree, each ``main()`` called with an argv as a user would, beside the
JAX package's entry points on the same tree.  The config's
``clip.pretrained_path`` is a synthetic CLIP checkpoint in OpenAI's layout
(tests/test_torch_clip_text.py) and ``WECLIP_BPE_PATH`` the tiny merges
file, so both packages load the same frozen CLIP and encode the same
prompts.

- eval: JAX's ``train_voc`` trains 2 steps; JAX's and the port's
  ``eval_voc`` (``--mesh 1 --device cpu --precision float32``) evaluate
  that Orbax checkpoint, histograms held as tests/test_torch_eval_run.py
  holds them (equal, or at most 0.1% of the counted pixels apart);
- the port's ``train_voc``: ``scalars.jsonl`` steps [1, 2], a checkpoint
  at step 2, ``--resume`` continuing in that run dir;
- ``train_voc_seg`` and ``eval_seg``; ``generate_cams`` against JAX's
  within one fp16 step at 1.0 (2^-10); ``make_voc_labels`` equal to JAX's;
- ``--crf`` scored as JAX's; ``--mesh 2`` in one process raises the
  ``ValueError`` that names torchrun."""

import glob
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from tests import torch_support  # noqa: F401
from tests.test_tokenizer import make_tiny_vocab
from tests.test_torch_clip_text import TINY_VOCAB, write_clip_checkpoint

NAMES = [f"img{i:02d}" for i in range(32)]
FP16_STEP = 2.0 ** -10


class _Argv:
    """Swap sys.argv for a JAX entry point's main()."""

    def __init__(self, argv):
        self.argv = argv

    def __enter__(self):
        self.old, sys.argv = sys.argv, self.argv

    def __exit__(self, *exc):
        sys.argv = self.old


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    """A VOC tree of 32 images with class 3 (and class 8 in every third
    image), a synthetic CLIP checkpoint and merges file, and a tiny fp32
    config naming the checkpoint.  ``WECLIP_BPE_PATH`` names the merges file while
    the module runs."""
    root = tmp_path_factory.mktemp("voc_cli")
    for sub in ("JPEGImages", "SegmentationClassAug", "lists"):
        (root / sub).mkdir()
    r = np.random.default_rng(0)
    cls_labels = {}
    for i, n in enumerate(NAMES):
        Image.fromarray(r.integers(0, 255, (40, 60, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{n}.jpg")
        lab = np.zeros((40, 60), np.uint8)
        lab[5:20, 5:30] = 3
        onehot = np.zeros(20, np.float32)
        onehot[2] = 1
        if i % 3 == 0:
            lab[25:38, 35:58] = 8
            onehot[7] = 1
        lab[-2:] = 255
        Image.fromarray(lab, mode="L").save(root / "SegmentationClassAug" / f"{n}.png")
        cls_labels[n] = onehot
    np.save(root / "lists" / "cls_labels_onehot.npy", cls_labels)
    for split in ("train_aug", "train", "val"):
        names = NAMES if split == "train_aug" else NAMES[:4]
        (root / "lists" / f"{split}.txt").write_text("\n".join(names))
    ckpt = write_clip_checkpoint(root / "ViT-tiny.pt", vision_layers=4, vocab=TINY_VOCAB)
    cfg = root / "tiny.yaml"
    cfg.write_text(f"""
dataset:
  root_dir: {root}
  name_list_dir: {root}/lists
  crop_size: 64
  num_classes: 21
clip:
  pretrained_path: {ckpt}
  embedding_dim: 32
train:
  samples_per_gpu: 2
  max_iters: 2
  log_iters: 1
  eval_iters: 2
  ckpt_start_iter: 1
par:
  dilations: [1, 2]
  num_iter: 3
eval:
  batch_images: 2
precision:
  compute_dtype: float32
work_dir:
  dir: {root}/work
""")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WECLIP_BPE_PATH", make_tiny_vocab(root))
        yield root, str(cfg)


@pytest.fixture(scope="module")
def jax_run(voc_tree):
    """JAX's train_voc: 2 steps with a validation; its Orbax run dir."""
    from weclip_tpu.cli import train_voc
    root, cfg = voc_tree
    with _Argv(["train_voc", "--config", cfg]):
        train_voc.main()
    runs = sorted(glob.glob(str(root / "work" / "checkpoints" / "*")))
    assert runs
    return runs[-1]


def _capture_runs(monkeypatch, evaluator_cls, store):
    """Every ``Evaluator.run`` of the class also returns its histograms,
    kept in ``store``."""
    orig = evaluator_cls.run

    def run(self, *args, **kw):
        out = orig(self, *args, **dict(kw, return_hists=True))
        store.append(out)
        return out

    monkeypatch.setattr(evaluator_cls, "run", run)


def test_eval_voc_matches_jax(voc_tree, jax_run, monkeypatch, tmp_path):
    """Both eval entry points on JAX's checkpoint: equal histograms (or at most
    0.1% of the counted pixels apart), every labelled pixel counted, and
    the saved predictions and logits of the port."""
    from weclip_tpu.cli import eval_voc as jeval
    from weclip_tpu.evalx.runner import Evaluator as JEvaluator
    from weclip_tpu_torch.cli import eval_voc as teval
    from weclip_tpu_torch.evalx.runner import Evaluator as TEvaluator
    root, cfg = voc_tree
    jres, tres = [], []
    _capture_runs(monkeypatch, JEvaluator, jres)
    _capture_runs(monkeypatch, TEvaluator, tres)
    common = ["--config", cfg, "--model_path", jax_run, "--resize_long", "64",
              "--mesh", "1", "--precision", "float32", "--max_images", "4"]
    with _Argv(["eval_voc"] + common + ["--work_dir", str(tmp_path / "jax")]):
        jeval.main()
    out = str(tmp_path / "torch")
    scores = teval.main(common + ["--device", "cpu", "--work_dir", out, "--save_preds",
                                  "--save_logits"])
    assert {"seg", "msc_seg", "cam"} <= set(scores)
    (j,), (t,) = jres, tres
    labels = [np.asarray(Image.open(root / "SegmentationClassAug" / f"{n}.png"))
              for n in NAMES[:4]]
    n_px = sum(int((lab < 21).sum()) for lab in labels)
    for key in ("seg", "msc_seg", "cam"):
        got, want = t["hists"][key], np.asarray(j["hists"][key]).astype(np.int64)
        assert int(got.sum()) == n_px, key
        assert int(np.abs(got - want).sum()) // 2 <= 0.001 * n_px, key
    pred = np.asarray(Image.open(os.path.join(out, "prediction", "img00.png")))
    assert pred.shape == (40, 60)
    logit = np.load(os.path.join(out, "logit", "img00.npy"), allow_pickle=True).item()
    assert logit["msc_segs"].shape == (1, 21, 40, 60)


def test_train_voc_scalars_checkpoint_and_resume(voc_tree, tmp_path):
    """The port's train_voc: one scalars.jsonl record a logged step in
    JAX's record format, a checkpoint at step 2 in a timestamped run dir,
    then --resume continuing that run dir to step 4."""
    from weclip_tpu_torch.cli import train_voc
    from weclip_tpu_torch.train.checkpoint import latest_step
    _, cfg = voc_tree
    work = tmp_path / "work"
    args = ["--config", cfg, "--work_dir", str(work), "--device", "cpu"]
    state = train_voc.main(args)
    assert state.step == 2
    runs = glob.glob(str(work / "checkpoints" / "*"))
    assert len(runs) == 1 and latest_step(runs[0]) == 2
    assert glob.glob(str(work / "*.log"))
    jsonl = work / "tb_logger" / "scalars.jsonl"
    recs = [json.loads(x) for x in jsonl.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert set(r) == {"tag", "step", "time", "seg_loss", "attn_loss", "pseudo_mAcc",
                          "imgs_per_sec"} and r["tag"] == "train"
        assert np.isfinite(r["seg_loss"]) and np.isfinite(r["attn_loss"])
    train_voc.main(args + ["--resume", "--max_iters", "4"])
    assert glob.glob(str(work / "checkpoints" / "*")) == runs
    assert latest_step(runs[0]) == 4
    recs = [json.loads(x) for x in jsonl.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]


def test_train_voc_seg_and_eval_seg(voc_tree, tmp_path):
    """The seg variant trains 2 steps on ground truth, then eval_seg
    evaluates its checkpoint segmentation-only."""
    from weclip_tpu_torch.cli import eval_seg, train_voc_seg
    from weclip_tpu_torch.train.checkpoint import latest_step
    _, cfg = voc_tree
    work = tmp_path / "work_seg"
    state = train_voc_seg.main(["--config", cfg, "--work_dir", str(work), "--device", "cpu"])
    assert state.step == 2
    runs = glob.glob(str(work / "checkpoints" / "*"))
    assert len(runs) == 1 and latest_step(runs[0]) == 2
    scores = eval_seg.main(["--config", cfg, "--model_path", runs[0], "--resize_long", "64",
                            "--max_images", "2", "--mesh", "1", "--device", "cpu"])
    assert set(scores) == {"seg", "msc_seg"}
    assert 0.0 <= scores["msc_seg"]["pAcc"] <= 1.0


def test_generate_cams_matches_jax(voc_tree, tmp_path):
    """One npy per image: the present classes as keys and their refined
    CAMs at the original size in fp16, within one fp16 step at 1.0 of
    JAX's."""
    from weclip_tpu.cli import generate_cams as jgen
    from weclip_tpu_torch.cli import generate_cams as tgen
    _, cfg = voc_tree
    common = ["--config", cfg, "--split", "train", "--resize_long", "64", "--max_images", "3"]
    with _Argv(["generate_cams"] + common + ["--out", str(tmp_path / "jax")]):
        jgen.main()
    tgen.main(common + ["--out", str(tmp_path / "torch"), "--device", "cpu", "--mesh", "1"])
    assert sorted(os.listdir(tmp_path / "torch")) == [f"{n}.npy" for n in NAMES[:3]]
    for n in NAMES[:3]:
        got, want = (np.load(tmp_path / d / f"{n}.npy", allow_pickle=True).item()
                     for d in ("torch", "jax"))
        assert set(got) == {"keys", "attn_highres"}
        np.testing.assert_array_equal(got["keys"], want["keys"])
        assert 2 in got["keys"]
        assert got["attn_highres"].dtype == np.float16
        assert got["attn_highres"].shape == (len(got["keys"]), 40, 60)
        np.testing.assert_allclose(got["attn_highres"].astype(np.float32),
                                   want["attn_highres"].astype(np.float32),
                                   rtol=0, atol=FP16_STEP)


def test_make_voc_labels_matches_jax(voc_tree, tmp_path):
    from weclip_tpu.cli import make_voc_labels as jlab
    from weclip_tpu_torch.cli import make_voc_labels as tlab
    root, _ = voc_tree
    blobs = []
    for d in ("jax", "torch"):
        out = tmp_path / d
        out.mkdir()
        (out / "train.txt").write_text("\n".join(NAMES[:6]))
        argv = ["--root", str(root), "--name_list_dir", str(out), "--splits", "train,val"]
        if d == "jax":
            with _Argv(["make_voc_labels"] + argv):
                jlab.main()
        else:
            tlab.main(argv)
        blobs.append(np.load(out / "cls_labels_onehot.npy", allow_pickle=True).item())
    assert set(blobs[1]) == set(blobs[0]) == set(NAMES[:6])
    for n in blobs[0]:
        assert blobs[1][n].dtype == np.float32
        np.testing.assert_array_equal(blobs[1][n], blobs[0][n])


@pytest.mark.parametrize("flags", [["--crf"], ["--mesh", "2"], ["--mesh", "8"]])
def test_unported_eval_options_raise(voc_tree, jax_run, monkeypatch, tmp_path, flags):
    """``--crf`` runs: the port's and JAX's eval_voc on JAX's checkpoint give
    ``crf_seg`` histograms (the exact lattice on the host) as equal as the
    other histograms, every labelled pixel counted.  ``--mesh N > 1`` in one
    process raises the ValueError that names torchrun, before any work."""
    from weclip_tpu.evalx import metrics as jmetrics
    from weclip_tpu_torch.cli import eval_voc, generate_cams
    from weclip_tpu_torch.evalx.runner import Evaluator as TEvaluator
    root, cfg = voc_tree
    if flags[0] == "--mesh":
        with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
            eval_voc.main(["--config", cfg, "--device", "cpu"] + flags)
        with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
            generate_cams.main(["--config", cfg, "--device", "cpu"] + flags)
        return
    from weclip_tpu.cli import eval_voc as jeval
    jhists, tres = [], []
    orig_scores = jmetrics.scores
    monkeypatch.setattr(jmetrics, "scores",
                        lambda h: jhists.append(np.asarray(h)) or orig_scores(h))
    _capture_runs(monkeypatch, TEvaluator, tres)
    common = ["--config", cfg, "--model_path", jax_run, "--resize_long", "64",
              "--mesh", "1", "--precision", "float32", "--max_images", "3"] + flags
    with _Argv(["eval_voc"] + common + ["--work_dir", str(tmp_path / "jax")]):
        jeval.main()
    scores = eval_voc.main(common + ["--device", "cpu", "--work_dir", str(tmp_path)])
    assert {"seg", "msc_seg", "cam", "crf_seg"} <= set(scores)
    # JAX scores seg, msc_seg, cam, then crf_seg
    got, want = tres[0]["hists"]["crf_seg"], jhists[3].astype(np.int64)
    labels = [np.asarray(Image.open(root / "SegmentationClassAug" / f"{n}.png"))
              for n in NAMES[:3]]
    n_px = sum(int((lab < 21).sum()) for lab in labels)
    assert got.dtype == np.int64 and int(got.sum()) == int(want.sum()) == n_px
    assert int(np.abs(got - want).sum()) // 2 <= 0.001 * n_px


def test_meters_and_scalar_writer_match_jax(tmp_path):
    """AverageMeter's means and resets, and ScalarWriter's JSONL records
    (TensorBoard off on both sides), as the JAX package's."""
    from weclip_tpu.utils import meters as jmeters
    from weclip_tpu.utils import tb as jtb
    from weclip_tpu_torch.utils import meters as tmeters
    from weclip_tpu_torch.utils import tb as ttb
    jm, tm = jmeters.AverageMeter("a", "b"), tmeters.AverageMeter("a", "b")
    for vals in ({"a": 1.0, "b": 4}, {"a": 2.5}, {"b": np.float32(0.5)}):
        jm.add(vals)
        tm.add(vals)
    assert [tm.get("a"), tm.get("b"), tm.get("c")] == [jm.get("a"), jm.get("b"), jm.get("c")]
    assert tm.pop("a") == jm.pop("a") and tm.get("a") == jm.get("a") == 0.0
    recs = []
    for name, mod in (("jax", jtb), ("torch", ttb)):
        w = mod.ScalarWriter(str(tmp_path / name), use_tensorboard=False)
        w.add_scalars("train", {"seg_loss": 0.5, "imgs_per_sec": 3.0}, 7)
        w.close()
        recs.append(json.loads((tmp_path / name / "scalars.jsonl").read_text()))
    assert set(recs[1]) == set(recs[0])
    assert {k: v for k, v in recs[1].items() if k != "time"} == {
        k: v for k, v in recs[0].items() if k != "time"}
