"""Configuration of the PyTorch port: the model and train dataclasses and the
ImageNet normalize constants.

The port's own copy of ``lavender_tpu/config.py`` (``SwinConfig``,
``BertConfig``, ``ModelConfig``, ``SWIN_PRESETS``, ``TrainConfig``,
``TASK_TOK2ID``, ``DataConfig``, ``RunConfig``, ``inherit_ckpt_args``,
``load_run_config``) and of ``IMAGENET_MEAN/STD`` from
``lavender_tpu/data/transforms.py``: the port
imports nothing of the JAX package.  Field names and defaults are the
same, so a JAX config converts with ``dataclasses.asdict`` and a test
holds the two sets of defaults equal.  The fields that steer the JAX
package's routes steer the port's alike: ``SwinConfig.attn_impl``,
``remat`` and ``scan_blocks`` (``models/swin3d.py``), ``BertConfig.
remat``, ``fused_attn``, ``fused_ffn``, ``fused_attn_train`` and
``fused_ffn_train`` (``models/bert.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os.path as op
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
# row of ``LavenderModel.emb_task`` per task token
TASK_TOK2ID = {"vtm": 0, "mc": 1, "oe": 2, "cap": 3}


@dataclass(frozen=True)
class SwinConfig:
    """Video Swin 3D backbone (reference: visbackbone/swin_*.py)."""

    patch_size: Tuple[int, int, int] = (2, 4, 4)
    in_chans: int = 3
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: Tuple[int, int, int] = (8, 7, 7)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    # stochastic depth, spread linearly over all blocks (0 at the first)
    drop_path_rate: float = 0.2
    patch_norm: bool = True
    layer_norm_eps: float = 1e-5
    attn_impl: str = "auto"
    remat: bool = False
    scan_blocks: bool = True

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))


SWIN_PRESETS: Dict[str, SwinConfig] = {
    "tiny": SwinConfig(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "small": SwinConfig(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "base": SwinConfig(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "large": SwinConfig(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
    "large_384": SwinConfig(
        embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
        window_size=(8, 12, 12)),
    "violet": SwinConfig(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
}


@dataclass(frozen=True)
class BertConfig:
    """BERT text embeddings, fusion encoder and MLM head (bert-base-uncased)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    pad_token_id: int = 0
    remat: bool = False
    fused_ffn: bool = True
    fused_attn: bool = True
    # train route of the fusion encoder: the attention (K10a/K10b) and
    # attention-output (K11) kernels with in-kernel dropout, and the FFN
    # kernel (K12); False runs the module math
    fused_attn_train: bool = True
    fused_ffn_train: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class ModelConfig:
    """The whole LAVENDER model (reference: model.py LAVENDER_Base)."""

    swin: SwinConfig = field(default_factory=lambda: SWIN_PRESETS["base"])
    bert: BertConfig = field(default_factory=BertConfig)
    max_size_frame: int = 6
    max_size_patch: int = 14
    txt_backbone_embed_only: bool = True
    swinbert: bool = False
    num_task_tokens: int = 10
    enable_task_token: bool = False
    enable_prompt: bool = False
    dtype: str = "float32"

    @property
    def hidden_size(self) -> int:
        return self.bert.hidden_size


@dataclass
class TrainConfig:
    """Training hyper-parameters (reference: utils/args.py + agent.py)."""

    lr: float = 1.2e-5
    decay: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.98)
    vis_backbone_lr_mul: float = 1.0
    warmup_ratio: float = 0.1
    min_lr: float = 1e-8
    max_grad_norm: float = -1.0
    size_epoch: int = 20
    size_batch: int = 8
    seed: int = 88
    temp: float = 0.05
    p_mask: float = 0.15
    label_smoothing: float = 0.1
    max_iter: int = 0


@dataclass
class DataConfig:
    """Data pipeline config (reference: dataset.py / utils/args.py)."""

    data_dir: str = "./_datasets"
    dataset: str = ""
    task: str = ""
    size_img: int = 224
    size_frame: int = 5
    size_txt: int = 25
    size_option: int = 5
    size_vocab: int = -1
    img_transform: Tuple[str, ...] = ("img_center_crop",)
    mask_pos: str = "append"
    data_ratio: float = 1.0
    n_workers: int = 4
    vocab_path: str = ""  # WordPiece vocab.txt


@dataclass
class RunConfig:
    """Top-level run config = model + train + data + task wiring; the
    reference's ``_args/args_*.json`` key names through
    :func:`load_run_config`.  ``tp``: the tensor-parallel size, the model
    axis of ``parallel.mesh`` (the CLI splits its ranks into data shards
    of ``tp`` GPUs)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    task_type: str = "retrieval"
    path_ckpt: str = ""
    path_output: str = "./_snapshot"
    vis_backbone_size: str = "base"
    multi_clip_testing: bool = False
    tp: int = 1
    extra: Dict[str, Any] = field(default_factory=dict)


def _coerce(value: Any, typ: Any) -> Any:
    if typ is None:
        return value
    origin = getattr(typ, "__origin__", None)
    if origin in (tuple, Tuple) and isinstance(value, (list, tuple)):
        return tuple(value)
    return value


def inherit_ckpt_args(raw: Dict) -> Dict:
    """Inherit the model-architecture args of the checkpoint's training run
    (utils/args.py:245-293): when ``path_ckpt``'s directory holds an
    ``args.json``, its architecture keys override the recipe; eval-only
    runs (size_epoch == 0) also inherit the input shapes."""
    path_ckpt = raw.get("path_ckpt", "")
    if not path_ckpt:
        return raw
    training_args_path = op.join(op.dirname(path_ckpt), "args.json")
    if not op.exists(training_args_path):
        return raw
    with open(training_args_path) as f:
        training = json.load(f)
    to_update = ["vis_backbone_size", "swinbert", "txt_backbone_embed_only",
                 "swin", "bert", "max_size_frame", "max_size_patch",
                 "enable_task_token", "enable_prompt"]
    if int(raw.get("size_epoch", 20)) == 0:
        to_update += ["size_frame", "size_txt", "size_img", "img_transform"]
    out = dict(raw)
    for key in to_update:
        if key in training:
            out[key] = training[key]
    return out


def load_run_config(path_or_dict) -> RunConfig:
    """A RunConfig from a JSON file (or its dict) with the reference's arg
    names (``utils/args.py``), so its ``_args/*.json`` recipes run as
    they are; explicit ``swin`` / ``bert`` dicts override the preset."""
    if isinstance(path_or_dict, str):
        with open(path_or_dict) as f:
            raw = json.load(f)
    else:
        raw = dict(path_or_dict)
    raw = inherit_ckpt_args(raw)

    size = raw.get("vis_backbone_size", "base")
    size_img = int(raw.get("size_img", 224))
    preset = "large_384" if (size == "large" and size_img == 384) else size
    swin = SWIN_PRESETS.get(preset, SWIN_PRESETS["base"])
    if "swin" in raw:
        swin = dataclasses.replace(
            swin, **{k: _coerce(v, None) if not isinstance(v, list)
                     else tuple(v) for k, v in raw["swin"].items()})
    bert = BertConfig()
    if "bert" in raw:
        bert = dataclasses.replace(bert, **dict(raw["bert"]))
    model = ModelConfig(
        swin=swin,
        bert=bert,
        dtype=raw.get("dtype", "float32"),
        max_size_frame=int(raw.get("max_size_frame", 6)),
        max_size_patch=int(raw.get("max_size_patch", 14)),
        swinbert=bool(raw.get("swinbert", False)),
        txt_backbone_embed_only=bool(raw.get("txt_backbone_embed_only",
                                             True)),
        enable_task_token=bool(raw.get("enable_task_token", False)),
        enable_prompt=bool(raw.get("enable_prompt", False)),
    )
    train = TrainConfig(
        lr=float(raw.get("lr", 1.2e-5)),
        decay=float(raw.get("decay", 1e-3)),
        vis_backbone_lr_mul=float(raw.get("vis_backbone_lr_mul", 1.0)),
        max_grad_norm=float(raw.get("max_grad_norm", -1.0)),
        size_epoch=int(raw.get("size_epoch", 20)),
        size_batch=int(raw.get("size_batch", 8)),
        seed=int(raw.get("seed", 88)),
        temp=float(raw.get("temp", 0.05)),
        p_mask=float(raw.get("p_mask", 0.15)),
    )
    ds = raw.get("dataset", "")
    if isinstance(ds, (list, tuple)):
        ds = ds[0] if ds else ""
    data = DataConfig(
        data_dir=raw.get("data_dir", "./_datasets"),
        dataset=ds,
        task=raw.get("task", ""),
        size_img=size_img,
        size_frame=int(raw.get("size_frame", 5)),
        size_txt=int(raw.get("size_txt", 25)),
        size_option=int(raw.get("size_option", 5)),
        size_vocab=int(raw.get("size_vocab", -1)),
        img_transform=tuple(raw.get("img_transform", ["img_center_crop"])),
        mask_pos=raw.get("mask_pos", "append"),
        data_ratio=float(raw.get("data_ratio", 1.0)),
        vocab_path=raw.get("vocab_path", ""),
    )
    return RunConfig(
        model=model, train=train, data=data,
        task_type=raw.get("type", "retrieval"),
        path_ckpt=raw.get("path_ckpt", ""),
        path_output=raw.get("path_output", "./_snapshot"),
        vis_backbone_size=size,
        multi_clip_testing=bool(raw.get("multi_clip_testing", False)),
        tp=int(raw.get("tp", 1)),
    )
