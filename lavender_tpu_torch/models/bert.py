"""BERT text embeddings, post-LN fusion encoder and MLM head (port of
lavender_tpu/models/bert.py).

Module and parameter names are HuggingFace's (``layer.3.attention.self.
query.weight``), the layout the reference checkpoints use.  Serving
(``eval()``): the attention sub-block is ``fused_bert_attn_block_kmask``
and the FFN sub-block is ``fused_ffn_post_ln``.  Training (``train()``),
as the JAX package routes it:

- ``BertConfig.fused_attn_train`` (default True): one qkv GEMM (plain
  torch, as JAX leaves it to XLA) -> ``fused_encoder_attention_train_lanes``
  (K10a, its backward K10b) -> ``fused_out_ln_train`` (K11); False: the
  module math with dropout, plain torch;
- ``BertConfig.fused_ffn_train`` (default False): ``fused_ffn_post_ln_train``
  (K12); False: the module math with dropout.

Each train kernel draws its own dropout seed from the step's generator
(``dropout.draw_seed``, an int64 [1] left on the device), in the model, so
the kernel path and ``plain_path()`` draw the same masks.  Embeddings and
the MLM head are plain torch.  Only key-padding masks ([B, 1, 1, L] from
``extended_attention_mask`` on a [B, L] mask) are taken; the full
[B, L, L] mask path is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lavender_tpu_torch.ops import layer_norm
from lavender_tpu_torch.ops._build import select
from lavender_tpu_torch.ops.dropout import draw_seed
from lavender_tpu_torch.ops.encoder_attention import (
    fused_bert_attn_block_kmask, fused_encoder_attention_train_lanes)
from lavender_tpu_torch.ops.fused_mlp import (
    fused_ffn_post_ln, fused_ffn_post_ln_train, fused_out_ln_train)


def extended_attention_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] (1 = attend, 0 = masked) -> additive [B, 1, 1, L] f32 with
    0 / finfo(f32).min (HF ``get_extended_attention_mask``)."""
    if mask.dim() != 2:
        raise NotImplementedError(
            "only [B, L] key-padding masks are ported; [B, L, L] masks "
            "(seq2seq, captioning) are not")
    ext = mask[:, None, None, :].float()
    return (1.0 - ext) * torch.finfo(torch.float32).min


def _ln(x, mod: nn.LayerNorm):
    return layer_norm(x, mod.weight, mod.bias, mod.eps)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout with its mask drawn from ``generator`` (the same
    generator state gives the same mask on both of chip_smoke's paths)."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings, then LayerNorm."""

    def __init__(self, config):
        super().__init__()
        H = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, H)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, H)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, H)
        self.LayerNorm = nn.LayerNorm(H, eps=config.layer_norm_eps)
        self.dropout_p = config.hidden_dropout_prob

    def forward(self, input_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        L = input_ids.shape[1]
        pos = torch.arange(L, device=input_ids.device)
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return dropout(_ln(x, self.LayerNorm), self.dropout_p, self.training,
                       generator)


class BertSelfAttention(nn.Module):
    def __init__(self, config):
        super().__init__()
        H = config.hidden_size
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(H, H)
        self.value = nn.Linear(H, H)


class BertSelfOutput(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps)


class BertAttention(nn.Module):
    """Self-attention + output projection + residual + post-LN: in serving
    one ``fused_bert_attn_block_kmask`` call (the JAX kmask serving
    branch); in training with ``fused_attn_train`` K10 + K11 (the JAX
    lanes train kernels), else the module math with attention-probability
    and hidden dropout (JAX ``_attend``'s XLA branch and
    ``BertSelfOutput``)."""

    def __init__(self, config):
        super().__init__()
        self.self = BertSelfAttention(config)
        self.output = BertSelfOutput(config)
        self.num_heads = config.num_attention_heads
        self.scale = float(config.hidden_size // self.num_heads) ** -0.5
        self.attn_dropout_p = config.attention_probs_dropout_prob
        self.hidden_dropout_p = config.hidden_dropout_prob
        self.fused_train = config.fused_attn_train

    def _fused_train_forward(self, x, attn_bias, generator):
        B, L, C = x.shape
        s, o = self.self, self.output
        w = torch.cat([s.query.weight, s.key.weight, s.value.weight])
        b = torch.cat([s.query.bias, s.key.bias, s.value.bias])
        q, k, v = F.linear(x, w, b).split(C, dim=-1)  # views of one slab
        ctx = select(fused_encoder_attention_train_lanes)(
            q, k, v, attn_bias[:, 0].expand(B, L, L),
            draw_seed(generator, x.device), self.scale,
            self.attn_dropout_p, self.num_heads)
        out, _ = select(fused_out_ln_train)(
            ctx.reshape(B * L, C), x.reshape(B * L, C), o.dense.weight,
            o.dense.bias, o.LayerNorm.weight, o.LayerNorm.bias,
            draw_seed(generator, x.device), o.LayerNorm.eps,
            self.hidden_dropout_p)
        return out.view(B, L, C)

    def _train_forward(self, x, attn_bias, generator):
        if self.fused_train:
            return self._fused_train_forward(x, attn_bias, generator)
        B, L, C = x.shape
        s, o = self.self, self.output

        def heads(t):
            return t.reshape(B, L, self.num_heads, -1).transpose(1, 2)

        q, k, v = heads(s.query(x)), heads(s.key(x)), heads(s.value(x))
        scores = (q @ k.transpose(-1, -2)) * self.scale + attn_bias
        p = torch.softmax(scores.float(), dim=-1)
        p = dropout(p, self.attn_dropout_p, True, generator)
        ctx = (p.to(v.dtype) @ v).transpose(1, 2).reshape(B, L, C)
        h = dropout(o.dense(ctx), self.hidden_dropout_p, True, generator)
        return _ln(h + x, o.LayerNorm)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        if attn_bias.dim() != 4 or attn_bias.shape[-2] != 1:
            raise NotImplementedError("only key-padding masks are ported")
        if self.training:
            return self._train_forward(x, attn_bias, generator)
        keep = attn_bias[:, 0, 0, :] >= -0.5
        s, o = self.self, self.output
        return select(fused_bert_attn_block_kmask)(
            x, s.query.weight, s.key.weight, s.value.weight, s.query.bias,
            s.key.bias, s.value.bias, o.dense.weight, o.dense.bias,
            o.LayerNorm.weight, o.LayerNorm.bias, keep, self.num_heads,
            self.scale, o.LayerNorm.eps)


class BertIntermediate(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.intermediate_size)


class BertOutput(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.dense = nn.Linear(config.intermediate_size, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps)


class BertLayer(nn.Module):
    """Post-LN layer: attention sub-block, then the FFN sub-block
    LN(x + fc2(GELU(fc1 x))), in serving as one ``fused_ffn_post_ln``
    call, in training as one ``fused_ffn_post_ln_train`` call with
    ``fused_ffn_train``, else as the module math with hidden dropout."""

    def __init__(self, config):
        super().__init__()
        self.attention = BertAttention(config)
        self.intermediate = BertIntermediate(config)
        self.output = BertOutput(config)
        self.dropout_p = config.hidden_dropout_prob
        self.fused_train = config.fused_ffn_train

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        x = self.attention(x, attn_bias, generator)
        i, o = self.intermediate.dense, self.output
        if self.training and self.fused_train:
            out, _ = select(fused_ffn_post_ln_train)(
                x.reshape(-1, x.shape[-1]), i.weight, i.bias, o.dense.weight,
                o.dense.bias, o.LayerNorm.weight, o.LayerNorm.bias,
                draw_seed(generator, x.device), o.LayerNorm.eps,
                self.dropout_p)
            return out.reshape(x.shape)
        if self.training:
            h = o.dense(F.gelu(i(x)))
            h = dropout(h, self.dropout_p, True, generator)
            return _ln(h + x, o.LayerNorm)
        out = select(fused_ffn_post_ln)(
            x.reshape(-1, x.shape[-1]), i.weight, i.bias, o.dense.weight,
            o.dense.bias, o.LayerNorm.weight, o.LayerNorm.bias,
            o.LayerNorm.eps)
        return out.reshape(x.shape)


class BertEncoder(nn.Module):
    """Stack of BertLayers (the fusion encoder ``trsfr``)."""

    def __init__(self, config):
        super().__init__()
        self.layer = nn.ModuleList(
            BertLayer(config) for _ in range(config.num_hidden_layers))

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        for layer in self.layer:
            x = layer(x, attn_bias, generator)
        return x


class BertPredictionHeadTransform(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps)


class BertLMPredictionHead(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.transform = BertPredictionHeadTransform(config)
        self.decoder = nn.Linear(config.hidden_size, config.vocab_size)


class BertMLMHead(nn.Module):
    """BertOnlyMLMHead: dense + GELU + LN, then the vocab decoder."""

    def __init__(self, config):
        super().__init__()
        self.predictions = BertLMPredictionHead(config)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.predictions.transform
        x = F.gelu(t.dense(x).float()).to(x.dtype)
        return self.predictions.decoder(_ln(x, t.LayerNorm))
