"""Typed configuration: the dataclasses the ported inference and training
paths read.

An own copy of ``weclip_tpu/core/config.py`` (the port imports nothing of
the JAX package).  Field names and defaults are identical, so a bare
``Config()`` is the reference VOC setup and ``load_config`` overlays the same
YAML files.  The ``mesh`` section keeps the JAX package's fields: here
``data_parallel`` and ``model_parallel`` count ``torch.distributed`` ranks
(parallel/mesh.py);
``_apply`` ignores keys of sections this copy does not have.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class DatasetConfig:
    name: str = "voc"                      # "voc" | "coco"
    root_dir: str = ""
    name_list_dir: str = ""
    num_classes: int = 21                  # incl. background
    crop_size: int = 320
    resize_range: Tuple[int, int] = (512, 2048)
    rescale_range: Tuple[float, float] = (0.5, 2.0)
    ignore_index: int = 255
    # ImageNet statistics on 0..255 pixels
    mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    decoded_cache_dir: Optional[str] = None


@dataclass(frozen=True)
class TrainConfig:
    split: str = "train_aug"
    samples_per_gpu: int = 4               # per-step batch on one card
    max_iters: int = 30000
    eval_iters: int = 2000
    log_iters: int = 200
    seed: int = 1
    # iteration after which the learned decoder affinity gates the CLIP
    # attention fusion
    seg_trans_start_iter: int = 15000
    ckpt_start_iter: int = 26000
    attn_loss_weight: float = 0.1
    # radius of the affinity-label neighbourhood mask
    radius: int = 8


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 2e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.01
    head_lr_mult: float = 10.0             # the trainable heads run at 10x
    warmup_iter: int = 50
    warmup_ratio: float = 1e-6
    power: float = 1.0


@dataclass(frozen=True)
class ClipConfig:
    pretrained_path: str = ""
    pretrained_sha256: Optional[str] = None
    embedding_dim: int = 256
    in_channels: int = 768                 # ViT-B/16 token width
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    embed_dim: int = 512                   # joint text/image space
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    prompt_template: str = "a clean origami {}."


@dataclass(frozen=True)
class CamConfig:
    bbox_threshold: float = 0.4            # VOC; COCO uses 0.7
    attn_fuse_layers: int = 8              # last-k mean fusion
    seg_trans_layers: int = 6              # gated window, VOC; COCO 10
    sinkhorn_iters: int = 3                # 1 + 2 extra normalization rounds
    bg_exponent: float = 1.0               # (1-max cam)^p


@dataclass(frozen=True)
class ParConfig:
    dilations: Tuple[int, ...] = (1, 2, 4, 8, 12, 24)
    num_iter: int = 20
    w1: float = 0.3
    w2: float = 0.01


@dataclass(frozen=True)
class CrfConfig:
    iter_max: int = 10
    pos_xy_std: float = 3.0
    pos_w: float = 3.0
    bi_xy_std: float = 64.0
    bi_rgb_std: float = 5.0
    bi_w: float = 4.0


@dataclass(frozen=True)
class EvalConfig:
    split: str = "val"
    resize_long: int = 512
    scales: Tuple[float, ...] = (1.0, 0.75)
    use_flip: bool = True
    bkg_score: float = 0.45                # parsed but unused, as upstream
    batch_images: int = 8                  # images batched per TTA step
    crf: CrfConfig = field(default_factory=CrfConfig)


@dataclass(frozen=True)
class MeshConfig:
    # the JAX package's device mesh; here both widths count ranks
    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1                # -1 = the world / model_parallel
    model_parallel: int = 1                # ranks that split the frozen MLPs


@dataclass(frozen=True)
class PrecisionConfig:
    """bf16 matmul inputs with fp32 accumulation; LayerNorm/softmax fp32;
    the trainable heads run in fp32 (``head_dtype``)."""
    compute_dtype: str = "bfloat16"        # "bfloat16" | "float32"
    param_dtype: str = "float32"
    softmax_dtype: str = "float32"
    head_dtype: str = "float32"


@dataclass(frozen=True)
class ComerConfig:
    """ViT-CoMer branch: CNN pyramid, MRFP and CTI cross-attention."""
    enabled: bool = False
    stem_width: int = 64
    pyramid_dims: Tuple[int, int, int] = (128, 256, 256)   # C3, C4, C5
    mrfp_dilations: Tuple[int, ...] = (1, 2, 3)
    cti_heads: int = 4                     # head width 64 at embed 256
    interaction_indexes: Tuple[int, ...] = (2, 5, 8, 11)   # ViT blocks after which CTI runs


@dataclass(frozen=True)
class WorkDirConfig:
    dir: str = "work_dir_voc"
    ckpt_dir: str = "checkpoints"
    pred_dir: str = "predictions"
    tb_logger_dir: str = "tb_logger"


@dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    clip: ClipConfig = field(default_factory=ClipConfig)
    cam: CamConfig = field(default_factory=CamConfig)
    par: ParConfig = field(default_factory=ParConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    comer: ComerConfig = field(default_factory=ComerConfig)
    work_dir: WorkDirConfig = field(default_factory=WorkDirConfig)


def _apply(dc: Any, data: dict) -> Any:
    """Recursively overlay a plain dict onto a dataclass instance."""
    updates = {}
    for f in dataclasses.fields(dc):
        if f.name not in data:
            continue
        v = data[f.name]
        cur = getattr(dc, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            updates[f.name] = _apply(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
            updates[f.name] = tuple(v)
        elif isinstance(cur, float) and isinstance(v, (str, int)):
            # YAML 1.1 parses bare "1e-4" as a string
            updates[f.name] = float(v)
        elif isinstance(cur, int) and not isinstance(cur, bool) and isinstance(v, str):
            updates[f.name] = int(v)
        else:
            updates[f.name] = v
    return dataclasses.replace(dc, **updates)


def from_dict(data: dict) -> Config:
    """A Config from a nested dict (e.g. ``dataclasses.asdict`` of the JAX
    package's Config)."""
    return _apply(Config(), data)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Load a Config from YAML/JSON, then overlay ``overrides``."""
    cfg = Config()
    if path:
        with open(path) as f:
            text = f.read()
        try:
            import yaml
            data = yaml.safe_load(text)
        except ImportError:            # pragma: no cover
            data = json.loads(text)
        if data:
            cfg = _apply(cfg, data)
    if overrides:
        cfg = _apply(cfg, overrides)
    return cfg


def coco_config(**kw) -> Config:
    """The reference COCO setup: 81 classes, 80k steps with the learned
    affinity gating from step 40k, checkpoints every 10k past 40k (COCO
    trains without mid-training validation, so ``eval_iters`` only sets the
    save cadence), box threshold 0.7 and a seg-trans window of 10 layers.
    ``kw`` overlays nested dicts as ``load_config``'s overrides do."""
    cfg = Config()
    cfg = dataclasses.replace(
        cfg,
        dataset=dataclasses.replace(cfg.dataset, name="coco", num_classes=81),
        train=dataclasses.replace(
            cfg.train, max_iters=80000, seg_trans_start_iter=40000,
            ckpt_start_iter=40000, eval_iters=10000),
        cam=dataclasses.replace(cfg.cam, bbox_threshold=0.7, seg_trans_layers=10),
    )
    return _apply(cfg, kw) if kw else cfg
