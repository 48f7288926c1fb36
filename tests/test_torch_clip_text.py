"""The port's text side against the JAX package: the tokenizer (word split
with the standard library against JAX's ``regex`` pattern), ``encode_text``,
the prompt tables and ``build_text_features``, the CLIP checkpoint loader,
``build_frozen`` and ``coco_config``, on a seeded synthetic checkpoint in
OpenAI's key layout saved in fp16 and the synthetic merges file of
``tests/test_tokenizer.py::make_tiny_vocab``.

Tolerances: token ids, loaded trees and configs equal; text features and
``encode_text`` within 1e-5 (fp32); the frozen trees of ``build_frozen``
equal but for the text features (1e-5)."""

import dataclasses
import gzip
import hashlib
import io
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from tests import torch_support  # noqa: F401
from tests.test_tokenizer import make_tiny_vocab
from weclip_tpu.core import config as jconfig
from weclip_tpu.core import precision as jprec
from weclip_tpu.models.clip import loader as jloader
from weclip_tpu.models.clip import prompts as jprompts
from weclip_tpu.models.clip import tokenizer as jtok
from weclip_tpu.models.clip import vit as jvit
from weclip_tpu.ops import attention as jattn
from weclip_tpu.train import trainer as jtrainer
from weclip_tpu_torch import convert
from weclip_tpu_torch.core import config as tconfig
from weclip_tpu_torch.core import precision as tprec
from weclip_tpu_torch.models import weclip as tweclip
from weclip_tpu_torch.models.clip import loader as tloader
from weclip_tpu_torch.models.clip import prompts as tprompts
from weclip_tpu_torch.models.clip import tokenizer as ttok
from weclip_tpu_torch.models.clip import vit as tvit
from weclip_tpu_torch.ops import attention as tattn
from weclip_tpu_torch.train import trainer as ttrainer

TEXT_TOL = 1e-5
N_MERGES = 7
# 512 byte tokens + the tiny file's 7 merges + 2 specials
TINY_VOCAB = 512 + N_MERGES + 2


def clip_state_dict(seed: int = 0, vision_width: int = 128, vision_layers: int = 3,
                    patch: int = 16, grid: int = 14, text_width: int = 64,
                    text_layers: int = 2, context: int = 77, vocab: int = 528,
                    embed: int = 32):
    """A seeded random CLIP state dict in OpenAI's key layout and fp16
    (heads are width / 64, as the loader infers them)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    def ln(prefix, w):
        sd[prefix + ".weight"] = 1.0 + normal((w,), 0.1)
        sd[prefix + ".bias"] = normal((w,), 0.1)

    def blocks(prefix, w, layers):
        for i in range(layers):
            p = f"{prefix}.{i}."
            sd[p + "attn.in_proj_weight"] = normal((3 * w, w), w ** -0.5)
            sd[p + "attn.in_proj_bias"] = normal((3 * w,), 0.02)
            sd[p + "attn.out_proj.weight"] = normal((w, w), w ** -0.5)
            sd[p + "attn.out_proj.bias"] = normal((w,), 0.02)
            sd[p + "mlp.c_fc.weight"] = normal((4 * w, w), w ** -0.5)
            sd[p + "mlp.c_fc.bias"] = normal((4 * w,), 0.02)
            sd[p + "mlp.c_proj.weight"] = normal((w, 4 * w), (4 * w) ** -0.5)
            sd[p + "mlp.c_proj.bias"] = normal((w,), 0.02)
            ln(p + "ln_1", w)
            ln(p + "ln_2", w)

    vw, tw = vision_width, text_width
    sd["visual.class_embedding"] = normal((vw,), vw ** -0.5)
    sd["visual.positional_embedding"] = normal((grid * grid + 1, vw), vw ** -0.5)
    sd["visual.proj"] = normal((vw, embed), vw ** -0.5)
    sd["visual.conv1.weight"] = normal((vw, 3, patch, patch), (3 * patch * patch) ** -0.5)
    ln("visual.ln_pre", vw)
    blocks("visual.transformer.resblocks", vw, vision_layers)
    ln("visual.ln_post", vw)
    sd["positional_embedding"] = normal((context, tw), 0.01)
    sd["text_projection"] = normal((tw, embed), tw ** -0.5)
    sd["logit_scale"] = torch.tensor(float(np.log(1 / 0.07)))
    sd["token_embedding.weight"] = normal((vocab, tw), 0.02)
    blocks("transformer.resblocks", tw, text_layers)
    ln("ln_final", tw)
    return {k: v.half() for k, v in sd.items()}


def write_clip_checkpoint(path, seed: int = 0, prefix: str = "", **kw) -> str:
    torch.save({prefix + k: v for k, v in clip_state_dict(seed, **kw).items()}, path)
    return str(path)


def base_config(ckpt: str, num_classes: int = 21):
    """The JAX and the port's configs of a tiny setup on ``ckpt``."""
    cfg = jconfig.Config()
    cfg = dataclasses.replace(
        cfg,
        dataset=dataclasses.replace(cfg.dataset, num_classes=num_classes, crop_size=64),
        clip=dataclasses.replace(cfg.clip, pretrained_path=ckpt, embedding_dim=32,
                                 in_channels=128),
        par=jconfig.ParConfig(dilations=(1, 2), num_iter=4),
        eval=dataclasses.replace(cfg.eval, resize_long=64, batch_images=2))
    return cfg, tconfig.from_dict(dataclasses.asdict(cfg))


def assert_same_config(t, j):
    """The port's config equals the JAX one on every field it has."""
    td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
    assert td == {k: jd[k] for k in td}


def np_tree(t):
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t)


def assert_tree_close(got, want, tol=0.0, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            assert_tree_close(got[k], want[k], tol, f"{where}.{k}")
        return
    np.testing.assert_allclose(np_tree(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=where)


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    return make_tiny_vocab(tmp_path_factory.mktemp("bpe"))


@pytest.fixture(scope="module")
def toks(merges):
    return (jtok.Tokenizer(merges, n_merges=N_MERGES),
            ttok.Tokenizer(merges, n_merges=N_MERGES))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_clip_checkpoint(tmp_path_factory.mktemp("clip") / "ViT-tiny.pt",
                                 vocab=TINY_VOCAB)


TEXTS = [
    "hello lower", "a clean origami aeroplane.", "person with clothes,people,human",
    "Héllo Wörld çà", "数字 ½ ² ³ 十", "2024 and 1,000.5 apples", "x½y",
    "it's they're we've I'm you'll he'd don't", "rock &amp; roll &lt;3 &#39;s &amp;amp;",
    "  tabs\tand\nnew　lines  ", "<|startoftext|> hi <|endoftext|>",
    "ſ 'ſ <|ſtartoftext|>", "a\x1cb\x1d c", "ἀνθρώπινος ΣΊΣΥΦΟΣ", "naïve café ﬁne",
    "emoji 😀🎉!!", "İstanbul", "aͅb", "hairdrier,blowdrier", "",
]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_ids_match_jax(toks, text):
    """Word split, BPE and ids equal JAX's over unicode letters, digits,
    ½, accents, HTML entities, apostrophes, specials and whitespace."""
    jt, tt = toks
    assert ttok._clean(text) == jtok._clean(text)
    assert tt.encode(text) == jt.encode(text)
    np.testing.assert_array_equal(ttok.tokenize([text, "hello"], tt, 77),
                                  jtok.tokenize([text, "hello"], jt, 77))


# assigned code points only: a code point the installed unicodedata leaves
# unassigned may be a letter in the regex package's newer tables
@settings(max_examples=300, deadline=None)
@given(st.text(st.characters(blacklist_categories=("Cs", "Cn")), max_size=30))
def test_tokenizer_matches_jax_on_any_text(toks, text):
    jt, tt = toks
    assert tt.encode(text) == jt.encode(text)


def test_tokenizer_surface(toks, merges, monkeypatch):
    """bytes_to_unicode, decode, the context check and WECLIP_BPE_PATH."""
    jt, tt = toks
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()
    assert (tt.sot, tt.eot, len(tt.encoder)) == (jt.sot, jt.eot, TINY_VOCAB)
    ids = tt.encode("hello lower")
    assert tt.decode(ids) == jt.decode(ids)
    with pytest.raises(RuntimeError):
        ttok.tokenize(["hello " * 20], tt, context_length=8)
    monkeypatch.setenv("WECLIP_BPE_PATH", merges)
    assert ttok.default_bpe_path() == merges
    assert ttok.Tokenizer().encoder == jtok.Tokenizer().encoder


def test_mha_attn_bias_matches_jax():
    """The plain attention with an additive causal bias."""
    rng = np.random.default_rng(0)
    b, l, d = 2, 9, 32
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.2
         for s in ((3 * d, d), (3 * d,), (d, d), (d,))]
    ref = jattn.mha_with_weights(jnp.asarray(x), jattn.MhaParams(*map(jnp.asarray, w)),
                                 2, attn_bias=jvit.causal_bias(l), policy=jprec.FP32)
    got = tattn.mha_with_weights(torch.from_numpy(x),
                                 tattn.MhaParams(*map(torch.from_numpy, w)), 2,
                                 policy=tprec.FP32, attn_bias=tvit.causal_bias(l))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=TEXT_TOL, atol=TEXT_TOL)
    np.testing.assert_array_equal(tvit.causal_bias(5).numpy(), np.asarray(jvit.causal_bias(5)))


def test_load_clip_matches_jax(ckpt, tmp_path):
    """The same fp16 file (with DDP ``module.`` prefixes too): equal trees
    and configs; the visual tree equal to ``convert``'s of JAX's."""
    jparams, jcfg = jloader.load_clip(ckpt)
    tparams, tcfg = tloader.load_clip(ckpt)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.vision_width, tcfg.vision_layers, tcfg.vision_heads) == (128, 3, 2)
    assert (tcfg.transformer_heads, tcfg.context_length, tcfg.vocab_size) == (1, 77,
                                                                              TINY_VOCAB)
    assert_tree_close(tparams, jparams)
    assert tparams["text"]["blocks"]["attn"]["in_w"].dtype == torch.float32
    assert_tree_close(convert.visual_from_jax(np_tree(jparams["visual"])), jparams["visual"])
    prefixed = write_clip_checkpoint(tmp_path / "ddp.pt", prefix="module.",
                                     vocab=TINY_VOCAB)
    assert_tree_close(tloader.load_clip(prefixed)[0], jparams)
    with pytest.raises(FileNotFoundError):
        tloader.load_clip(str(tmp_path / "missing.pt"))
    assert tloader.available_models() == jloader.available_models()
    for path in ("ViT-B/16", "https://x/y.pt", "local.pt", ""):
        assert tloader.is_fetchable(path) == jloader.is_fetchable(path)


def test_encode_text_matches_jax(ckpt, toks):
    jparams, jcfg = jloader.load_clip(ckpt)
    tparams, tcfg = tloader.load_clip(ckpt)
    tokens = jtok.tokenize(["hello lower", "a clean origami person.", "",
                            "rock &amp; roll"], toks[0], 77)
    ref = jvit.encode_text(jparams["text"], jnp.asarray(tokens), jcfg)
    got = tvit.encode_text(tparams["text"], tokens, tcfg)
    assert got.shape == (4, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TEXT_TOL, atol=TEXT_TOL)


@pytest.mark.parametrize("dataset", ["voc", "coco"])
def test_build_text_features_matches_jax(ckpt, toks, dataset):
    """Both prompt tables, every class: (C, E) unit rows within 1e-5."""
    jparams, jcfg = jloader.load_clip(ckpt)
    tparams, tcfg = tloader.load_clip(ckpt)
    assert tprompts.class_tables(dataset) == jprompts.class_tables(dataset)
    ref = jprompts.build_text_features(dataset, jparams["text"], jcfg, toks[0])
    got = tprompts.build_text_features(dataset, tparams["text"], tcfg, toks[1])
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=TEXT_TOL, atol=TEXT_TOL)
        np.testing.assert_allclose(np.linalg.norm(g, axis=-1), 1.0, atol=1e-6)
    assert tweclip.NUM_BG[dataset] == len(jprompts.class_tables(dataset)[1])
    assert tprompts.CLASS_NAMES_VOC == jprompts.CLASS_NAMES_VOC
    assert tprompts.CLASS_NAMES_COCO == jprompts.CLASS_NAMES_COCO


def test_build_frozen_matches_jax(ckpt, merges, monkeypatch, caplog):
    """With the checkpoint: the clip config from its shapes, the frozen
    trees equal (text features within 1e-5); without it: the random state
    of the seed and JAX's warning."""
    monkeypatch.setenv("WECLIP_BPE_PATH", merges)
    jcfg, tcfg = base_config(ckpt)
    jfrozen, jclip, jcfg2 = jtrainer.build_frozen(jcfg)
    tfrozen, tclip, tcfg2 = ttrainer.build_frozen(tcfg, device="cpu")
    assert_same_config(tcfg2, jcfg2)
    assert tcfg2.clip.vision_width == 128 and tcfg2.clip.pretrained_path == ckpt
    want = np_tree(jfrozen)
    assert_tree_close(tfrozen["visual"], want["visual"])
    np.testing.assert_array_equal(tfrozen["logit_scale"].numpy(), want["logit_scale"])
    for k in ("fg_text", "bg_text"):
        np.testing.assert_allclose(tfrozen[k].numpy(), want[k], rtol=TEXT_TOL, atol=TEXT_TOL)
    assert tfrozen["fg_text"].shape == (20, 32) and tfrozen["bg_text"].shape == (25, 32)
    assert_tree_close(tclip["text"], np_tree(jclip["text"]))

    nocfg = dataclasses.replace(tcfg, clip=dataclasses.replace(
        tcfg.clip, pretrained_path=ckpt + ".absent"))
    with caplog.at_level("WARNING", logger="weclip_tpu_torch"):
        rfrozen, rclip, rcfg = ttrainer.build_frozen(nocfg, rng_seed=3, device="cpu")
    assert "random init" in caplog.text and rcfg == nocfg
    assert_tree_close(rfrozen, np_tree(tweclip.random_frozen_state(nocfg, seed=3)))
    assert set(rclip) == {"visual", "logit_scale"}


@pytest.mark.parametrize("kw", [{}, {"train": {"max_iters": 7}, "cam": {"bbox_threshold": 0.5},
                                     "dataset": {"crop_size": 448}}])
def test_coco_config_matches_jax(kw):
    assert_same_config(tconfig.coco_config(**kw), jconfig.coco_config(**kw))


def test_init_clip_params_shapes():
    """The random towers have the shapes of the loader's trees."""
    _, jcfg = base_config("")
    jcfg = dataclasses.replace(jcfg, clip=dataclasses.replace(
        jcfg.clip, vision_width=64, vision_heads=1, vision_layers=2, transformer_width=64,
        transformer_heads=1, transformer_layers=2, embed_dim=32, vocab_size=TINY_VOCAB))
    ref = jvit.init_clip_params(jax.random.PRNGKey(0), jcfg.clip)
    got = tvit.init_clip_params(torch.Generator().manual_seed(0),
                                tconfig.from_dict(dataclasses.asdict(jcfg)).clip)
    shapes = lambda t: ({k: shapes(v) for k, v in t.items()} if isinstance(t, dict)
                        else tuple(t.shape))
    assert shapes(got) == shapes(ref)
    np.testing.assert_allclose(float(got["logit_scale"]), float(ref["logit_scale"]), rtol=1e-7)


def test_download_checkpoint_reuses_verified_file(tmp_path, monkeypatch):
    """An existing file whose sha256 matches is returned without a fetch."""
    data = b"weights"
    digest = hashlib.sha256(data).hexdigest()
    (tmp_path / "w.pt").write_bytes(data)

    def no_fetch(url):
        raise AssertionError("fetched")

    monkeypatch.setattr("urllib.request.urlopen", no_fetch)
    got = tloader.download_checkpoint("https://example.invalid/w.pt", root=str(tmp_path),
                                      expected_sha256=digest)
    assert got == str(tmp_path / "w.pt")


def test_download_checkpoint_rejects_mismatch(tmp_path, monkeypatch):
    """A download whose sha256 differs raises and leaves no file; one that
    matches lands at the target."""
    monkeypatch.setattr("urllib.request.urlopen", lambda url: io.BytesIO(b"served"))
    with pytest.raises(RuntimeError, match="sha256"):
        tloader.download_checkpoint("https://example.invalid/w.pt", root=str(tmp_path),
                                    expected_sha256="0" * 64)
    assert not os.listdir(tmp_path)
    good = hashlib.sha256(b"served").hexdigest()
    path = tloader.download_checkpoint("https://example.invalid/w.pt", root=str(tmp_path),
                                       expected_sha256=good)
    assert open(path, "rb").read() == b"served"
    # an OpenAI name is verified against the digest in its URL
    with pytest.raises(RuntimeError, match="sha256"):
        tloader.download_checkpoint("ViT-B/16", root=str(tmp_path / "openai"))


def test_clip_preprocess_matches_jax():
    img = np.random.default_rng(0).integers(0, 255, (75, 100, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tloader.clip_preprocess(img, 32),
                                  jloader.clip_preprocess(img, 32))


def test_pipeline_loads_pretrained_path_like_jax(ckpt, merges, monkeypatch):
    """The repair of the ignored ``clip.pretrained_path``: given the same
    checkpoint file, the port's ``WeCLIPPipeline`` and JAX's build the same
    frozen trees (text features within 1e-5) and, on the same trained
    parameters, the same pseudo labels (fp32, CPU).  The labels are taken
    for class sets of 2-4 classes: with all 20 classes of a random model,
    near-tied class maps flip about 1.5% of the pixels between the two
    packages whichever package's text features the port is given."""
    from weclip_tpu import api as japi
    from weclip_tpu_torch.api import WeCLIPPipeline
    monkeypatch.setenv("WECLIP_BPE_PATH", merges)
    jcfg, tcfg = base_config(ckpt)
    jpipe = japi.WeCLIPPipeline(jcfg, precision_name="float32")
    tpipe = WeCLIPPipeline(tcfg, precision_name="float32", device="cpu")
    assert_same_config(tpipe.cfg, jpipe.cfg)
    want = np_tree(jpipe.frozen)
    assert_tree_close(tpipe.frozen["visual"], want["visual"])
    for k in ("fg_text", "bg_text"):
        np.testing.assert_allclose(tpipe.frozen[k].numpy(), want[k], rtol=TEXT_TOL,
                                   atol=TEXT_TOL)
    tpipe.params = convert.params_from_jax(np_tree(jpipe.params))
    im = np.random.default_rng(2).integers(0, 256, (48, 40, 3)).astype(np.uint8)
    for ids in ([0, 6, 14], [3, 11], [1, 7, 12, 19]):
        np.testing.assert_array_equal(tpipe.pseudo_label(im, class_ids=ids),
                                      jpipe.pseudo_label(im, class_ids=ids))
