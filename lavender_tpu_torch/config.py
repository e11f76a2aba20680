"""Configuration of the PyTorch port: the model and train dataclasses and the
ImageNet normalize constants.

The port's own copy of ``lavender_tpu/config.py`` (``SwinConfig``,
``BertConfig``, ``ModelConfig``, ``SWIN_PRESETS``, ``TrainConfig``,
``TASK_TOK2ID``, ``DataConfig``) and of ``IMAGENET_MEAN/STD`` from
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

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

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
