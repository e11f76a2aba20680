"""JAX params -> the port's state dict (the inverse of lavender_tpu/convert.py).

The JAX package names its flax modules after the reference's torch modules
with ``a.b.3.c`` written ``a/b_3/c`` and a few HuggingFace sub-paths
flattened (``convert._REWRITES``); its Swin stages stack block pairs on a
leading axis (``layers_i/blocks_scan/{a,b}``, ``convert.swin_to_scan_layout``).
``from_flax`` undoes all of it, so the result carries the reference's torch
names and loads with ``load_state_dict(strict=True)``:

* Dense ``kernel`` [in, out] -> ``weight`` [out, in];
* Conv ``kernel`` DHWIO -> ``weight`` OIDHW (the patch embed);
* LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
* ``blocks_scan/a`` [n_pairs, ...] -> ``blocks.{2k}``, ``b`` -> ``blocks.{2k+1}``.

Every leaf maps to exactly one key (a collision raises).

The reference's released ``.pt`` files load through the rest of this
module (port of ``lavender_tpu/convert.py``).  The port's keys ARE the
reference's torch keys, so ``convert_state_dict`` only drops the buffers
the models recompute (``relative_position_index``, ``attn_mask``,
``position_ids``), moves the MLM head's tied ``predictions.bias`` onto
``predictions.decoder.bias`` and renames the task heads' ``nn.Sequential``
indices (``fc.1`` / ``fc.3`` -> ``fc.fc1`` / ``fc.fc2``); then
``convert_lavender_checkpoint`` truncates ``emb_len`` / ``emb_pos``,
``merge_state_dict`` overlays the result on the model's own state dict
with the reference loader's shape tolerance, ``remap_swinbert_keys``
renames a SwinBERT checkpoint into LAVENDER's layout and
``inflate_swin2d_state_dict`` turns an ImageNet 2D Swin into the 3D one.
The JAX package's ``swin_to_scan_layout``, ``lavender_to_scan_layout`` and
``match_scan_layout`` have no counterpart: they exist because Flax stacks
block pairs for its ``scan``, and the port stacks nothing.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

# flattened HuggingFace sub-paths -> their torch module paths
_SEGMENTS = {
    "intermediate_dense": ("intermediate", "dense"),
    "output_dense": ("output", "dense"),
    "output_LayerNorm": ("output", "LayerNorm"),
    "transform_dense": ("predictions", "transform", "dense"),
    "transform_LayerNorm": ("predictions", "transform", "LayerNorm"),
    "decoder": ("predictions", "decoder"),
}
_INDEXED = re.compile(r"^(.+)_(\d+)$")  # flax "layers_0" = torch "layers.0"


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), np.asarray(v)


def _unscan(path: Tuple[str, ...], value: np.ndarray):
    """Split a scan-stacked ``blocks_scan/{a,b}`` leaf into per-block leaves."""
    if "blocks_scan" not in path:
        yield path, value
        return
    i = path.index("blocks_scan")
    side = {"a": 0, "b": 1}[path[i + 1]]
    for k in range(value.shape[0]):
        yield path[:i] + ("blocks", str(2 * k + side)) + path[i + 2:], value[k]


def _torch_key(path: Tuple[str, ...], value: np.ndarray):
    mods = []
    for seg in path[:-1]:
        if seg in _SEGMENTS:
            mods.extend(_SEGMENTS[seg])
            continue
        m = _INDEXED.match(seg)
        mods.extend((m.group(1), m.group(2)) if m else (seg,))
    name = path[-1]
    if name == "kernel":
        name = "weight"
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 5:
            value = value.transpose(4, 3, 0, 1, 2)
        else:
            raise ValueError(f"unexpected {value.ndim}-D kernel at "
                             f"{'/'.join(path)}")
    elif name in ("scale", "embedding"):
        name = "weight"
    return ".".join(mods + [name]), value


def from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Convert the JAX package's params (a nested dict of arrays) to the
    port's state dict (float32 leaves stay float32)."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        for p, v in _unscan(path, leaf):
            key, v = _torch_key(p, v)
            if key in out:
                raise ValueError(f"two JAX leaves map to {key}")
            out[key] = torch.from_numpy(np.array(v))  # owned, writable
    return out


# --------------------------------------------------------------------------
# Reference ``.pt`` state dicts -> the port's state dict.
# --------------------------------------------------------------------------

_DROP_PATTERNS = ("relative_position_index", "attn_mask", "position_ids")
# task heads' nn.Sequential(Dropout, Linear, ReLU, Linear): fc.1 / fc.3 ->
# MLPHead's fc1 / fc2 (JAX convert._REWRITES)
_HEAD_RENAMES = (
    (re.compile(r"(^|\.)(fc\w*)\.1\."), r"\1\2.fc1."),
    (re.compile(r"(^|\.)(fc\w*)\.3\."), r"\1\2.fc2."),
)


def to_numpy_state_dict(state_dict: Mapping[str, Any]
                        ) -> Dict[str, np.ndarray]:
    """Detach a torch state_dict to plain numpy arrays."""
    out = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def _tensor(v) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def convert_state_dict(state_dict: Mapping[str, Any],
                       strip_prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference (sub-)state dict -> the port's keys, torch tensors.

    ``strip_prefix`` selects and strips a key prefix (e.g.
    ``"bert.encoder."`` for the fusion encoder alone).  The MLM head's
    ``predictions.bias`` becomes ``predictions.decoder.bias`` where the
    latter is absent (the reference ties them, model.py:470)."""
    sd = dict(state_dict)
    for k in list(sd):
        if k.endswith("predictions.bias"):
            dec = k[: -len("bias")] + "decoder.bias"
            if dec not in sd:
                sd[dec] = sd[k]
            del sd[k]
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if strip_prefix:
            if not k.startswith(strip_prefix):
                continue
            k = k[len(strip_prefix):]
        if any(p in k for p in _DROP_PATTERNS):
            continue
        for pat, repl in _HEAD_RENAMES:
            k = pat.sub(repl, k)
        out[k] = _tensor(v)
    return out


def convert_lavender_checkpoint(state_dict: Mapping[str, Any],
                                max_size_frame: Optional[int] = None,
                                max_size_patch: Optional[int] = None
                                ) -> Dict[str, torch.Tensor]:
    """A full LAVENDER ``ckpt_violet_*.pt`` state dict -> the port's keys,
    ``enc_img.emb_len`` cut to ``max_size_frame`` frames and
    ``enc_img.emb_pos`` to 1 + ``max_size_patch``^2 positions where the
    checkpoint has more (model.py:406-429); where it has fewer,
    ``merge_state_dict`` copies them into the front of the init."""
    sd = convert_state_dict(state_dict)
    if max_size_frame is not None and "enc_img.emb_len" in sd:
        sd["enc_img.emb_len"] = sd["enc_img.emb_len"][:, :max_size_frame]
    if max_size_patch is not None and "enc_img.emb_pos" in sd:
        sd["enc_img.emb_pos"] = sd["enc_img.emb_pos"][
            :, :, :1 + max_size_patch ** 2]
    return sd


def merge_state_dict(init: Mapping[str, torch.Tensor],
                     loaded: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``loaded`` overlaid on ``init`` (the model's own state dict), the
    reference's tolerant loader (model.py:370-405, JAX ``merge_params``): a
    key absent from ``loaded`` keeps its init tensor; an equal shape takes
    the loaded tensor in the init's dtype and device; a loaded tensor of
    the same rank and no larger in any dimension goes into the front of a
    copy of the init (emb_len / emb_pos); any other shape keeps the init.
    Keys of ``loaded`` that ``init`` lacks are ignored.  Returns a new
    dict."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in init.items():
        if k not in loaded:
            out[k] = v
            continue
        lv = _tensor(loaded[k]).to(device=v.device, dtype=v.dtype)
        if lv.shape == v.shape:
            out[k] = lv.clone()
        elif lv.dim() == v.dim() and all(
                ls <= s for ls, s in zip(lv.shape, v.shape)):
            nv = v.detach().clone()
            nv[tuple(slice(0, s) for s in lv.shape)] = lv
            out[k] = nv
        else:
            out[k] = v
    return out


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Per-sample 4-tap cubic convolution weights (torch bicubic, A=-0.75)."""
    def conv1(x):
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def conv2(x):
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    return np.stack([conv2(t + 1), conv1(t), conv1(1 - t), conv2(2 - t)],
                    axis=-1)


def _bicubic_resize(grid: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bicubic resize of ``grid [..., H, W]`` as
    ``F.interpolate(mode="bicubic", align_corners=False)`` computes it
    (edge-clamped 4-tap cubic convolution), in f64."""
    def axis_resize(x, out_n):  # resample the last axis
        in_n = x.shape[-1]
        src = (np.arange(out_n) + 0.5) * (in_n / out_n) - 0.5
        i0 = np.floor(src).astype(np.int64)
        w = _cubic_weights(src - i0)  # [out_n, 4]
        taps = np.stack([np.clip(i0 + d - 1, 0, in_n - 1) for d in range(4)],
                        axis=-1)  # [out_n, 4]
        return np.einsum("...nk,nk->...n", x[..., taps], w)

    out = axis_resize(grid.astype(np.float64), out_w)
    out = axis_resize(np.swapaxes(out, -1, -2), out_h)
    return np.swapaxes(out, -1, -2).astype(grid.dtype)


def inflate_swin2d_state_dict(sd: Mapping[str, Any],
                              window_size: Tuple[int, int, int],
                              patch_size_t: int) -> Dict[str, np.ndarray]:
    """2D Swin -> 3D Video Swin weights (the reference's
    ``inflate_weights``, video_swin.py:482-533): ``patch_embed.proj.weight``
    [O, I, kh, kw] repeated over a new temporal axis of ``patch_size_t``
    and divided by it; each ``relative_position_bias_table`` [L1, nH]
    bicubic-resized to the 3D window's spatial extent where the sizes
    differ, then tiled ``2 * wd - 1`` times over the temporal offsets; the
    ``relative_position_index`` / ``attn_mask`` buffers dropped."""
    out = {}
    for k, v in to_numpy_state_dict(sd).items():
        if "relative_position_index" in k or "attn_mask" in k:
            continue
        out[k] = v
    pe = out.get("patch_embed.proj.weight")
    if pe is not None and pe.ndim == 4:
        out["patch_embed.proj.weight"] = (
            np.repeat(pe[:, :, None], patch_size_t, axis=2) / patch_size_t)
    wd, wh, ww = window_size
    th, tw = 2 * wh - 1, 2 * ww - 1
    for k in [k for k in out if "relative_position_bias_table" in k]:
        table = out[k]
        L1, nH = table.shape
        if L1 != th * tw:
            S1 = int(round(L1 ** 0.5))
            grid = table.T.reshape(nH, S1, S1)
            table = _bicubic_resize(grid, th, tw).reshape(nH, th * tw).T
        out[k] = np.tile(table, (2 * wd - 1, 1))
    return out


def convert_swin2d_checkpoint(sd: Mapping[str, Any], swin_cfg
                              ) -> Dict[str, torch.Tensor]:
    """An ImageNet 2D Swin checkpoint (its ``model`` state dict) -> the
    state dict of the port's ``VideoSwin3D`` by inflation
    (video_swin.py:571-645 takes this path under ``pretrained2d``)."""
    if isinstance(sd, dict) and "model" in sd and isinstance(
            sd["model"], dict):
        sd = sd["model"]
    inflated = inflate_swin2d_state_dict(
        sd, tuple(swin_cfg.window_size), int(swin_cfg.patch_size[0]))
    return convert_state_dict(inflated)


def remap_swinbert_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """SwinBERT checkpoint keys -> LAVENDER's (reference
    ``load_SwinBERT_weight``, model.py:431-473): ``swin.backbone`` ->
    ``enc_img.swin``; ``trans_encoder.bert.encoder`` -> ``trsfr``,
    ``.embeddings`` -> ``enc_txt.emb_txt``, ``.img_embedding`` ->
    ``enc_img.img_embedding``; ``trans_encoder.cls.`` -> ``fc_mtm.``;
    ``fc.`` -> ``enc_img.fc.``; every other key dropped.  The decoder bias
    is faked from the tied predictions bias (model.py:470)."""
    out: Dict[str, Any] = {}
    for key, val in sd.items():
        if "swin.backbone" in key:
            out[key.replace("swin.backbone", "enc_img.swin")] = val
        elif "trans_encoder.bert.encoder" in key:
            out[key.replace("trans_encoder.bert.encoder", "trsfr")] = val
        elif "trans_encoder.bert.embeddings" in key:
            out[key.replace("trans_encoder.bert.embeddings",
                            "enc_txt.emb_txt")] = val
        elif "trans_encoder.bert.img_embedding" in key:
            out[key.replace("trans_encoder.bert.img_embedding",
                            "enc_img.img_embedding")] = val
        elif key.startswith("trans_encoder.cls."):
            out[key.replace("trans_encoder.cls.", "fc_mtm.")] = val
        elif key.startswith("fc."):
            out[key.replace("fc.", "enc_img.fc.")] = val
    if ("fc_mtm.predictions.bias" in out
            and "fc_mtm.predictions.decoder.bias" not in out):
        out["fc_mtm.predictions.decoder.bias"] = out[
            "fc_mtm.predictions.bias"]
    return out


# remap_swinbert_keys' renames, port prefix -> SwinBERT prefix, in its order
_SWINBERT_NAMES = (
    ("enc_img.swin.", "swin.backbone."),
    ("trsfr.", "trans_encoder.bert.encoder."),
    ("enc_txt.emb_txt.", "trans_encoder.bert.embeddings."),
    ("enc_img.img_embedding.", "trans_encoder.bert.img_embedding."),
    ("fc_mtm.", "trans_encoder.cls."), ("enc_img.fc.", "fc."))


def swinbert_layout_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of ``remap_swinbert_keys``: a port state dict of a
    ``ModelConfig(swinbert=True)`` model in SwinBERT's key layout, the MLM
    decoder's bias written as the tied ``predictions.bias`` (which the
    remap fakes the decoder's from); keys the remap does not map (e.g.
    ``emb_task``) are left out."""
    out: Dict[str, Any] = {}
    for key, val in sd.items():
        for mine, theirs in _SWINBERT_NAMES:
            if key.startswith(mine):
                out[theirs + key[len(mine):]] = val
                break
    dec = "trans_encoder.cls.predictions.decoder.bias"
    if dec in out:
        out["trans_encoder.cls.predictions.bias"] = out.pop(dec)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pt`` file -> its state dict on the CPU (``torch.load`` with
    ``weights_only=True``): a ``state_dict`` entry is unwrapped with
    ``backbone.`` stripped from its keys, a ``model`` entry unwrapped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = {k.replace("backbone.", ""): v
              for k, v in sd["state_dict"].items()}
    elif isinstance(sd, dict) and "model" in sd and all(
            not hasattr(v, "shape") for v in [sd.get("model")]):
        sd = sd["model"]
    return {k: _tensor(v) for k, v in sd.items()}
