"""BERT text embeddings, post-LN fusion encoder and MLM head (port of
lavender_tpu/models/bert.py).

Module and parameter names are HuggingFace's (``layer.3.attention.self.
query.weight``), the layout the reference checkpoints use.  Serving
(``eval()``): the attention sub-block is ``fused_bert_attn_block_kmask``
(``BertConfig.fused_attn``) and the FFN sub-block is ``fused_ffn_post_ln``
(``fused_ffn``); with either off, the module math, as in JAX.  Training
(``train()``), as the JAX package routes it:

- ``BertConfig.fused_attn_train`` (default True): one qkv GEMM (plain
  torch, as JAX leaves it to XLA) -> ``fused_encoder_attention_train_lanes``
  (K10a, its backward K10b) -> ``fused_out_ln_train`` (K11); under
  ``LVT_ATTNLANES=0`` the heads route of JAX
  ``_attend``: the same qkv product taken as [B, nH, L, hd] views ->
  ``fused_encoder_attention_train`` (K13a, its backward K13b) -> K11;
  False: the module math with dropout, plain torch;
- ``BertConfig.fused_ffn_train`` (default False): ``fused_ffn_post_ln_train``
  (K12); False: the module math with dropout.

Each train kernel draws its own dropout seed from the step's generator
(``dropout.draw_seed``, an int64 [1] left on the device), in the model, so
the kernel path and ``plain_path()`` draw the same masks.
``BertConfig.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``), replaying its draws.  Embeddings and
the MLM head are plain torch.  Masks: a key-padding bias [B, 1, 1, L]
(``extended_attention_mask`` on a [B, L] mask) takes the serving kernel
``fused_bert_attn_block_kmask`` (K4), a full bias [B, 1, L, L] (on a
[B, L, L] mask: seq2seq, captioning) ``fused_bert_attn_block`` (K6), and
under ``LVT_KMASK=0`` a key-padding bias too, broadcast to [B, L, L]; both
train routes take either.  The two switches are read from the environment
at each call, as JAX reads them each time it traces (bert.py:173, :285).

Tensor parallelism (``parallel.mesh.tp_active()``, the weights sharded by
``mesh.shard_model``; JAX's ``_fused_backend_ok`` gates the kernels off
there, bert.py:30-45): every mode runs the Megatron split.  The attention:
q, k and v of this rank's heads from one ``F.linear`` over their local
rows (column-parallel, so that they stay views of one slab), the train
core K10a / K10b (``LVT_ATTNLANES=0``: K13a / K13b) at nH / tp heads with
the dropout stream's head offset, so that a rank draws what one process
draws for those heads; in ``eval()`` K10a at rate 0 under the key-padding
bias broadcast to [B, L, L]; with ``fused_attn_train`` off the module math,
its dropout drawn for all nH heads and sliced.  Then
``attention.output.dense`` (row-parallel: partials summed over the model
ranks, then the bias) -> hidden dropout (``dropout.row_keep`` from the
seed K11 would have drawn, or the module math's) -> residual -> LN.  The
FFN: ``intermediate.dense`` + GELU (column) -> ``output.dense`` (row) ->
dropout -> residual -> LN.  The KV cache holds this rank's heads.  The
word embeddings are vocab-parallel (a masked lookup of this rank's rows,
summed over the ranks), the MLM decoder column-parallel over the vocab,
gathered, the pad columns dropped.  K4, K5, K6, K11 and K12 do not run
under tp: each fuses a row-parallel product with the LN after its
all-reduce.  An attention whose heads do not divide tp stays whole.

Incremental decoding with a static KV cache, as the JAX package has it:
``BertEncoder.prefill`` runs the prefix (serving route) and returns each
layer's K/V in a cache preallocated to its full length; ``decode_step``
writes the new positions' K/V at a slot, in place, and attends over the
whole cache with the module math (the JAX decode is plain XLA too), the
FFN through K5.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lavender_tpu_torch.ops import _build, layer_norm
from lavender_tpu_torch.ops._build import select
from lavender_tpu_torch.ops.dropout import draw_seed, row_keep
from lavender_tpu_torch.ops.encoder_attention import (
    fused_bert_attn_block, fused_bert_attn_block_kmask,
    fused_encoder_attention_train, fused_encoder_attention_train_lanes)
from lavender_tpu_torch.ops.fused_mlp import (
    _dropout_residual_ln, fused_ffn_post_ln, fused_ffn_post_ln_train,
    fused_out_ln_train)
from lavender_tpu_torch.parallel import mesh

def extended_attention_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] or [B, Lq, Lk] (1 = attend, 0 = masked) -> additive
    [B, 1, 1, L] or [B, 1, Lq, Lk] f32 with 0 / finfo(f32).min (HF
    ``get_extended_attention_mask``)."""
    if mask.dim() == 2:
        ext = mask[:, None, None, :]
    elif mask.dim() == 3:
        ext = mask[:, None]
    else:
        raise ValueError(f"mask must be [B, L] or [B, Lq, Lk], got "
                         f"{tuple(mask.shape)}")
    return (1.0 - ext.float()) * torch.finfo(torch.float32).min


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
                generator: Optional[torch.Generator] = None, *,
                token_type_ids: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids [B, L]; positions 0..L-1 and token type 0 unless given
        (the KV-cache decode feeds positions (t-1, t))."""
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self._words(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return dropout(_ln(x, self.LayerNorm), self.dropout_p, self.training,
                       generator)

    def _words(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The word embeddings; vocab-parallel where the table is sharded:
        this rank's rows looked up (the others and the pad rows give 0),
        then summed over the model ranks."""
        w = self.word_embeddings.weight
        if not mesh.is_sharded(w):
            return self.word_embeddings(input_ids)
        per = w.shape[0]
        local = input_ids - mesh.model_rank() * per
        ok = (local >= 0) & (local < per)
        e = nn.functional.embedding(local.clamp(0, per - 1), w)
        return mesh.reduce_from_model(e * ok[..., None].to(e.dtype))


KVCache = Tuple[torch.Tensor, torch.Tensor]  # k, v: [B, nH, Lcache, hd]


class BertSelfAttention(nn.Module):
    def __init__(self, config):
        super().__init__()
        H = config.hidden_size
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(H, H)
        self.value = nn.Linear(H, H)
        self.num_heads = config.num_attention_heads
        self.head_dim = H // self.num_heads

    def heads(self, t: torch.Tensor) -> torch.Tensor:
        """[B, L, h * hd] -> [B, h, L, hd] (h: the heads this rank holds)."""
        B, L, C = t.shape
        return t.view(B, L, C // self.head_dim, self.head_dim).transpose(1, 2)

    def project(self, x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
        """q, k or v of ``x`` in heads layout (column-parallel under tp)."""
        return self.heads(mesh.column_parallel(x, lin.weight, lin.bias))

    def kv(self, x: torch.Tensor) -> KVCache:
        """K/V of ``x`` [B, L, C] in heads layout, for the cache prefill."""
        return self.project(x, self.key), self.project(x, self.value)

    def decode_step(self, x_new: torch.Tensor, cache: KVCache, slot: int,
                    attn_bias: torch.Tensor) -> torch.Tensor:
        """Write the K/V of ``x_new`` [B, n, C] into ``cache`` at positions
        slot..slot+n-1 (in place) and attend over the whole cache with
        ``attn_bias`` [B, 1, n, Lcache]: scores and softmax in f32, as the
        JAX ``_attend``'s XLA branch.  Returns [B, n, C]."""
        B, n, _ = x_new.shape
        ck, cv = cache
        q = self.project(x_new, self.query)
        ck[:, :, slot:slot + n] = self.project(x_new, self.key)
        cv[:, :, slot:slot + n] = self.project(x_new, self.value)
        s = (q.float() @ ck.float().transpose(-1, -2)) * self.head_dim ** -0.5
        p = torch.softmax(s + attn_bias.float(), dim=-1).to(cv.dtype)
        return (p @ cv).transpose(1, 2).reshape(B, n, -1)


class BertSelfOutput(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps)


class BertAttention(nn.Module):
    """Self-attention + output projection + residual + post-LN: in serving
    (with ``fused_attn``, the default) one ``fused_bert_attn_block_kmask``
    call under a key-padding bias (the JAX kmask serving branch; with
    ``LVT_KMASK=0`` the bias goes to the full-mask branch instead) or one
    ``fused_bert_attn_block`` call under a full [B, 1, L, L] bias (its
    full-mask branch); in training with ``fused_attn_train`` K10 + K11
    (the JAX lanes train kernels) or, under ``LVT_ATTNLANES=0``, q, k and v
    as heads views of one product -> K13 -> K11 (the JAX heads train
    kernel); else the module math, in training with attention-probability
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
        self.fused_serve = config.fused_attn
        self.fused_train = config.fused_attn_train

    def _fused_train_forward(self, x, attn_bias, generator):
        """One qkv product -> K10a / K10b (K13a / K13b under
        ``LVT_ATTNLANES=0``) -> K11.  Under tensor parallelism (also in
        ``eval()``, at rate 0) on this rank's heads, q, k and v from one
        ``F.linear`` over their local rows, the dropout stream offset by
        the first head; then the out-proj's partials summed, its bias, the
        hidden dropout with K11's bits from the seed it would have drawn,
        the residual and the LN."""
        B, L, C = x.shape
        s, o = self.self, self.output
        tp, train = mesh.tp_active(), self.training
        w = torch.cat([s.query.weight, s.key.weight, s.value.weight])
        b = torch.cat([s.query.bias, s.key.bias, s.value.bias])
        qkv = F.linear(mesh.copy_to_model(x) if mesh.is_sharded(s.query.weight)
                       else x, w, b)
        held = qkv.shape[-1] // 3 // s.head_dim
        heads = {"head0": mesh.head_offset(self.num_heads, held),
                 "heads_total": self.num_heads}
        mask = attn_bias[:, 0].expand(B, L, L)
        rate = self.attn_dropout_p if train else 0.0
        seed = (draw_seed(generator, x.device) if train else
                torch.zeros(1, dtype=torch.int64, device=x.device))
        # the JAX package's switch (lavender_tpu/models/bert.py:173), read
        # per call: the train attention in lanes (K10) or heads layout (K13)
        if os.environ.get("LVT_ATTNLANES", "1") == "1":
            q, k, v = qkv.split(held * s.head_dim, dim=-1)  # one slab's views
            ctx = select(fused_encoder_attention_train_lanes)(
                q, k, v, mask, seed, self.scale, rate, held, **heads)
        else:
            # [B, nH, L, hd] views of the slab, read in place
            q, k, v = qkv.view(B, L, 3, held, s.head_dim).permute(
                2, 0, 3, 1, 4)
            ctx = select(fused_encoder_attention_train)(
                q, k, v, mask, seed, self.scale, rate, **heads)
            ctx = ctx.transpose(1, 2)
        ctx, res = ctx.reshape(B * L, -1), x.reshape(B * L, C)
        ln, p = o.LayerNorm, self.hidden_dropout_p if train else 0.0
        if not tp:
            out, _ = select(fused_out_ln_train)(
                ctx, res, o.dense.weight, o.dense.bias, ln.weight, ln.bias,
                draw_seed(generator, x.device), ln.eps, p)
            return out.view(B, L, C)
        keep = (row_keep(draw_seed(generator, x.device), B * L, C, p)
                if train else None)
        return _dropout_residual_ln(mesh.row_parallel(ctx, o.dense), res,
                                    ln.weight, ln.bias, keep, ln.eps,
                                    p).view(B, L, C)

    def _module_forward(self, x, attn_bias, generator):
        """The module math (dropout in training only); under tp on this
        rank's heads, the attention dropout drawn for all of them and
        sliced to its own."""
        B, L, C = x.shape
        s, o = self.self, self.output
        q, k, v = (s.project(x, lin) for lin in (s.query, s.key, s.value))
        scores = (q @ k.transpose(-1, -2)) * self.scale + attn_bias
        p = torch.softmax(scores.float(), dim=-1)
        held, rate = q.shape[1], self.attn_dropout_p
        if self.training and rate > 0.0:  # ``dropout``'s draw over all heads
            keep = torch.rand((B, self.num_heads, L, L), generator=generator,
                              device=x.device) >= rate
            h0 = mesh.head_offset(self.num_heads, held)
            p = p * keep[:, h0:h0 + held].to(p.dtype) / (1.0 - rate)
        ctx = (p.to(v.dtype) @ v).transpose(1, 2).reshape(B, L, -1)
        h = dropout(mesh.row_parallel(ctx, o.dense), self.hidden_dropout_p,
                    self.training, generator)
        return _ln(h + x, o.LayerNorm)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """attn_bias: [B, 1, 1, L] (key padding) or [B, 1, L, L]."""
        B, L, _ = x.shape
        if attn_bias.dim() != 4 or tuple(attn_bias.shape[2:]) not in (
                (1, L), (L, L)):
            raise ValueError(f"attn_bias must be [B, 1, 1, {L}] or "
                             f"[B, 1, {L}, {L}], got {tuple(attn_bias.shape)}")
        if self.training and self.fused_train or (mesh.tp_active()
                                                  and not self.training):
            return self._fused_train_forward(x, attn_bias, generator)
        if self.training or not self.fused_serve:
            return self._module_forward(x, attn_bias, generator)
        s, o = self.self, self.output
        # JAX's (bert.py:285), read per call: a key-padding bias to K4, or
        # broadcast to the full-mask K6
        if (attn_bias.shape[2] == 1
                and os.environ.get("LVT_KMASK", "1") == "1"):
            op, mask = fused_bert_attn_block_kmask, attn_bias[:, 0, 0] >= -0.5
        else:
            op, mask = fused_bert_attn_block, attn_bias[:, 0].expand(B, L, L)
        return select(op)(
            x, s.query.weight, s.key.weight, s.value.weight, s.query.bias,
            s.key.bias, s.value.bias, o.dense.weight, o.dense.bias,
            o.LayerNorm.weight, o.LayerNorm.bias, mask, self.num_heads,
            self.scale, o.LayerNorm.eps)

    def kv(self, x: torch.Tensor) -> KVCache:
        return self.self.kv(x)

    def decode_step(self, x_new: torch.Tensor, cache: KVCache, slot: int,
                    attn_bias: torch.Tensor) -> torch.Tensor:
        """``BertSelfAttention.decode_step`` -> dense -> LN(+ x_new)."""
        o = self.output
        h = mesh.row_parallel(
            self.self.decode_step(x_new, cache, slot, attn_bias), o.dense)
        return _ln(h + x_new, o.LayerNorm)


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
    call with ``fused_ffn`` (the default), in training as one
    ``fused_ffn_post_ln_train`` call with ``fused_ffn_train``, else as the
    module math (with hidden dropout in training)."""

    def __init__(self, config):
        super().__init__()
        self.attention = BertAttention(config)
        self.intermediate = BertIntermediate(config)
        self.output = BertOutput(config)
        self.dropout_p = config.hidden_dropout_prob
        self.fused_serve = config.fused_ffn
        self.fused_train = config.fused_ffn_train

    def _module_ffn(self, x: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        """LN(x + dropout(fc2(GELU(fc1 x)))), dropout in training only."""
        i, o = self.intermediate.dense, self.output
        h = dropout(o.dense(F.gelu(i(x))), self.dropout_p, self.training,
                    generator)
        return _ln(h + x, o.LayerNorm)

    def _tp_ffn(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """The FFN on the tensor-parallel route: fc1 + GELU column-, fc2
        row-parallel, then the dropout (K12's bits from its seed with
        ``fused_ffn_train``, else the module math's), residual and LN."""
        i, o = self.intermediate.dense, self.output
        if self.training and self.fused_train:
            h = F.gelu(mesh.column_parallel(x, i.weight, i.bias).float())
            h = mesh.row_parallel(h.to(x.dtype), o.dense)
            keep = row_keep(draw_seed(generator, x.device),
                            x.numel() // x.shape[-1], x.shape[-1],
                            self.dropout_p).view(x.shape)
            return _dropout_residual_ln(h, x, o.LayerNorm.weight,
                                        o.LayerNorm.bias, keep,
                                        o.LayerNorm.eps, self.dropout_p)
        h = F.gelu(mesh.column_parallel(x, i.weight, i.bias))
        h = dropout(mesh.row_parallel(h, o.dense), self.dropout_p,
                    self.training, generator)
        return _ln(h + x, o.LayerNorm)

    def _serve_ffn(self, x: torch.Tensor) -> torch.Tensor:
        if mesh.tp_active():
            return self._tp_ffn(x, None)
        if not self.fused_serve:
            return self._module_ffn(x, None)
        i, o = self.intermediate.dense, self.output
        out = select(fused_ffn_post_ln)(
            x.reshape(-1, x.shape[-1]), i.weight, i.bias, o.dense.weight,
            o.dense.bias, o.LayerNorm.weight, o.LayerNorm.bias,
            o.LayerNorm.eps)
        return out.reshape(x.shape)

    def kv(self, x: torch.Tensor) -> KVCache:
        return self.attention.kv(x)

    def decode_step(self, x_new: torch.Tensor, cache: KVCache, slot: int,
                    attn_bias: torch.Tensor) -> torch.Tensor:
        return self._serve_ffn(
            self.attention.decode_step(x_new, cache, slot, attn_bias))

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        x = self.attention(x, attn_bias, generator)
        if mesh.tp_active():
            return self._tp_ffn(x, generator)
        if not self.training:
            return self._serve_ffn(x)
        i, o = self.intermediate.dense, self.output
        if self.fused_train:
            out, _ = select(fused_ffn_post_ln_train)(
                x.reshape(-1, x.shape[-1]), i.weight, i.bias, o.dense.weight,
                o.dense.bias, o.LayerNorm.weight, o.LayerNorm.bias,
                draw_seed(generator, x.device), o.LayerNorm.eps,
                self.dropout_p)
            return out.reshape(x.shape)
        return self._module_ffn(x, generator)


def _replayed(layer: nn.Module, x: torch.Tensor, attn_bias: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """``layer(x, attn_bias, generator)`` under ``checkpoint``, its random
    draws replayed by the recomputation: the layer draws from a copy of
    the generator's state taken before it ran (the dropout masks of the
    module math and the seeds of the train kernels alike), and the
    generator then advances as far as the first run took it, as it would
    without the checkpoint."""
    plain = _build.in_plain_path()
    state = None if generator is None else generator.get_state()
    runs = []

    def run(x, attn_bias):
        g = None
        if generator is not None:
            g = torch.Generator(generator.device)
            g.set_state(state)
        runs.append(g)
        with _build.plain_path(plain):
            return layer(x, attn_bias, g)

    out = checkpoint(run, x, attn_bias, use_reentrant=False,
                     preserve_rng_state=generator is None)
    if generator is not None:
        generator.set_state(runs[0].get_state())
    return out


class BertEncoder(nn.Module):
    """Stack of BertLayers (the fusion encoder ``trsfr``).  With
    ``BertConfig.remat`` a training forward under autograd recomputes
    each layer in the backward instead of storing its activations (JAX
    ``nn.remat`` per layer, bert.py:426)."""

    def __init__(self, config):
        super().__init__()
        self.layer = nn.ModuleList(
            BertLayer(config) for _ in range(config.num_hidden_layers))
        self.remat = config.remat

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        remat = self.remat and self.training and torch.is_grad_enabled()
        for layer in self.layer:
            x = (_replayed(layer, x, attn_bias, generator) if remat
                 else layer(x, attn_bias, generator))
        return x

    def prefill(self, x: torch.Tensor, attn_bias: torch.Tensor,
                cache_len: int) -> Tuple[torch.Tensor, List[KVCache]]:
        """Run the prefix x [B, Lp, C] through the stack (serving route);
        return its output and each layer's K/V cache [B, nH, cache_len, hd]
        with the prefix at slots [0, Lp) and zeros after."""
        caches = []
        Lp = x.shape[1]
        for layer in self.layer:
            k, v = layer.kv(x)
            ck = k.new_zeros(k.shape[:2] + (cache_len, k.shape[3]))
            cv = torch.zeros_like(ck)
            ck[:, :, :Lp], cv[:, :, :Lp] = k, v
            caches.append((ck, cv))
            x = layer(x, attn_bias)
        return x, caches

    def decode_step(self, x_new: torch.Tensor, caches: List[KVCache],
                    slot: int, attn_bias: torch.Tensor) -> torch.Tensor:
        """The new positions x_new [B, n, C] through every layer, each
        writing its K/V into its cache at ``slot`` (in place)."""
        for layer, cache in zip(self.layer, caches):
            x_new = layer.decode_step(x_new, cache, slot, attn_bias)
        return x_new


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
        dec = self.predictions.decoder
        if not mesh.is_sharded(dec.weight):
            return dec(_ln(x, t.LayerNorm))
        # vocab-parallel: this rank's columns, gathered, the pad dropped
        part = mesh.column_parallel(_ln(x, t.LayerNorm), dec.weight, dec.bias)
        return mesh.gather_from_model(part)[..., :dec.out_features]
