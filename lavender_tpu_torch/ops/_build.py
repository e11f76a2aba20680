"""Build, bind and launch the port's hand-written CUDA kernels.

The sources under ``lavender_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a``, one process per source, all at once, and linked into ONE shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use (never at import), writes into ``build/`` at the repository
root, and is keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is loaded as is.

The primitives bound here (the wgmma + TMA tile GEMM with its split-K
row-LN epilogue, with or without the hidden dropout, and its residual
epilogue scattering through a row index; row LayerNorm, with or without
its affine, optionally gathering its rows, in scalar or 16-byte-chunk
loads, attention core (on the tensor cores, the
packed slab or strided heads-layout q, k, v, with a per-head bias, a
per-window mask whose rows may be padded or a key-keep vector, with
dropout and the rows' log-sum-exp where asked; wgmma + TMA for the Swin
window core's lse with its bias) and its backwards (wgmma + TMA, with the
bias's gradient where there is a bias), both with optional dropout,
row permutation, and a probe of the dropout hash) are what the ports of
the TPU kernels are composed from, see ``swin_block_attn.py``,
``window_attention.py``, ``swin_core_attn.py``, ``wm_permute.py``,
``fused_mlp.py``, ``encoder_attention.py`` and ``dropout.py``; the uint8
patch embed (``patch_embed_u8.py``) is a kernel of its own.  Each launch goes on PyTorch's current stream,
allocates nothing inside the kernel (outputs come from ``torch.empty``
here) and raises if the C entry reports a CUDA error.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from lavender_tpu_torch.ops.dropout import threshold

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
# the heads-layout attention core's 12 element strides (host memory)
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# K1's four tile heights (host memory)
_INTS = ctypes.POINTER(ctypes.c_int)
# the entries that return a size, not a cudaError_t
_SIZES = ("lvt_swin_block_wm_scratch", "lvt_bert_attn_block_scratch",
          "lvt_ln_mlp_scratch", "lvt_swin_block_spatial_scratch")
# the dropout arguments of a kernel: seed pointer (null = no dropout), the
# keep threshold of the bits, the scale of the kept values
_DROP = [_P, _U, _F]
# the attention dropout's stream: the first head of the call and the heads
# in all (a tensor-parallel rank's own heads; 0: the call's)
_HEADS = [_I, _I]
_SIGNATURES = {
    "lvt_layernorm_bf16": [_P, _P, _P, _P, _I, _I, _F, _P, _P],
    "lvt_layernorm_rows_bf16": [_P, _P, _P, _P, _I, _I, _F, _P, _P],
    "lvt_attention_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                           *_DROP, _I, *_HEADS, _P],
    "lvt_attention_heads_bf16": [_P, _P, _P, _P, _STRIDES, _P, _I, _P, _I, _I,
                                 _I, _I, _F, *_DROP, *_HEADS, _P],
    "lvt_window_attention_bf16": [_P, _P, _P, _P, _STRIDES, _P, _I, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _F, _P],
    "lvt_attention_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _F, *_DROP, *_HEADS, _P, _P,
                               _P],
    "lvt_attention_heads_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _STRIDES, _I, _I, _I, _I, _I, _F,
                                     *_DROP, *_HEADS, _P, _P, _P],
    "lvt_attention_row_dot_bf16": [_P, _P, _STRIDES, _P, _I, _I, _I, _I, _P],
    "lvt_ffn_post_ln_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _F, _P],
    "lvt_gemm_tc_bf16": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I,
                         _I, _I, _I, _I, _I, _I, _P],
    "lvt_gemm_tc_scatter_bf16": [_P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _P],
    "lvt_gemm_tc_ln_bf16": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _F, _P],
    "lvt_gemm_tc_dropout_ln_bf16": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _F, *_DROP, _P],
    "lvt_swin_block_wm_scratch": [_I, _I, _I],
    "lvt_swin_block_wm_bf16": [_P] * 17 + [_I] * 6 + [_F, _F, _INTS, _P],
    "lvt_swin_block_spatial_scratch": [_I, _I, _I, _I],
    "lvt_swin_block_spatial_bf16": [_P] * 9 + [_I, _P, _I, _I] + [_P] * 7 + [
        ctypes.c_longlong, _P] + [_I] * 6 + [_F, _F] + [_I] * 6 + [_P],
    "lvt_ffn_dropout_ln_bf16": [_P] * 11 + [_I] * 5 + [_F, *_DROP, _P],
    "lvt_bert_attn_block_scratch": [_I, _I, _I],
    "lvt_ln_mlp_scratch": [_I, _I, _I, _I],
    "lvt_ln_mlp_bf16": [_P] * 8 + [ctypes.c_longlong, _P, _I, _I, _I, _F,
                                   _I, _I, _I, _I, _P],
    "lvt_bert_attn_block_bf16": [_P] * 14 + [_I] * 4 + [_F, _F, _I, _I, _I,
                                                       _P],
    "lvt_bert_attn_block_mask_bf16": [_P] * 12 + [_I, _P, _P] + [_I] * 4 + [
        _F, _F, _I, _I, _I, _P],
    "lvt_permute_rows": [_P, _P, _P, _I, _I, _I, _P],
    "lvt_patch_embed_u8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "lvt_dropout_bits": [_P, _P, _I, _I, _P],
}

# gemm_tc.cu's epilogues (lvt::GemmEpi)
_TC_BIAS, _TC_GELU, _TC_RESIDUAL, _TC_PARTIAL = 0, 1, 2, 3
# the H100 SXM's streaming multiprocessors: the launch plans fill them
H100_SMS = 132

_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): the "
        "CUDA kernels build only where the CUDA toolkit is installed")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sum(_sources(), []):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"liblvt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for their hash exists: one
    ``nvcc -c`` per source, all started together, then one link.

    nvcc's output (with ``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    log = []
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        objs = [Path(tmp) / f"{f.stem}.o" for f in cu]
        jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)]
                for f, o in zip(cu, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in jobs]
        results = [p.communicate() + (p.returncode,) for p in procs]
        tmp_so = Path(tmp) / so.name
        link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                "-o", str(tmp_so), *map(str, objs)]
        failed = [(cmd, err) for cmd, (_, err, rc) in zip(jobs, results)
                  if rc != 0]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            results.append((proc.stdout, proc.stderr, proc.returncode))
            jobs.append(link)
            if proc.returncode != 0:
                failed.append((link, proc.stderr))
        for cmd, (out, err, _) in zip(jobs, results):
            log.append(" ".join(cmd) + "\n" + out + err)
        so.with_suffix(".log").write_text("\n".join(log))
        if failed:
            cmd, err = failed[0]
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{err[-4000:]}")
        os.replace(tmp_so, so)  # atomic: a reader never sees half a file
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong if name in _SIZES else ctypes.c_int
        _lib = lib
    return _lib


def _cast(v, dtype: torch.dtype):
    """``v`` with its floating tensors (also inside tuples and the values
    of dicts, such as keyword arguments) cast to dtype."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype) if v.is_floating_point() else v
    if isinstance(v, (tuple, list)):
        return type(v)(_cast(e, dtype) for e in v)
    if isinstance(v, dict):
        return {k: _cast(e, dtype) for k, e in v.items()}
    return v


def autocast_inputs(*args):
    """``args`` as a ``custom_fwd(cast_inputs=...)`` Function takes them:
    under CUDA autocast their floating tensors (also inside tuples) in the
    autocast dtype, else as they are.  For the raw launches outside
    autograd (a model in ``eval()`` mode over f32 weights)."""
    if not torch.is_autocast_enabled("cuda"):
        return args
    return _cast(args, torch.get_autocast_dtype("cuda"))


class RecomputeVjp(torch.autograd.Function):
    """``launch(*args)`` forward; backward = autograd of ``plain(*args)``
    recomputed from the saved inputs (the JAX custom_vjps whose backward
    differentiates the kernel's reference)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, launch, plain, *args):
        ctx.plain = plain
        ctx.pos = [i for i, a in enumerate(args) if torch.is_tensor(a)]
        ctx.args = list(args)
        for i in ctx.pos:
            ctx.args[i] = None
        ctx.save_for_backward(*(args[i] for i in ctx.pos))
        return launch(*args)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        args, leaves = list(ctx.args), []
        for i, t in zip(ctx.pos, ctx.saved_tensors):
            if ctx.needs_input_grad[i + 2]:
                t = t.detach().requires_grad_(True)
                leaves.append((i, t))
            args[i] = t
        grads = [None] * len(args)
        with torch.enable_grad():
            out = ctx.plain(*args)
            got = torch.autograd.grad(out, [t for _, t in leaves],
                                      g.to(out.dtype), allow_unused=True)
        for (i, _), d in zip(leaves, got):
            grads[i] = d
        return (None, None, *grads)


class KernelOp:
    """Entry point of one ported TPU kernel.

    A CPU tensor goes to ``plain`` (the plain PyTorch version, which the
    CPU tests compare with the JAX package); any other tensor goes to the
    CUDA launch (``launch``), which runs the hand-written kernels or
    raises: there is no fallback.  ``launches`` counts the calls that
    launched.

    ``casts``: under CUDA autocast the kernel takes its floating inputs in
    the autocast dtype (its autograd Function is
    ``torch.amp.custom_fwd(cast_inputs=...)``); ``plain_as_launched`` then
    casts the same way, so that both paths see the same inputs.

    ``recompute_vjp``: ``_launch`` is a raw launch that autograd cannot see
    into; where autograd records the call (or autocast casts its inputs) it
    runs inside ``RecomputeVjp``, whose backward is autograd of ``plain``
    (takes positional arguments only)."""

    def __init__(self, name: str, plain: Callable, launch: Callable,
                 casts: bool = True, recompute_vjp: bool = False):
        self.name = name
        self.plain = plain
        self._launch = launch
        self.casts = casts
        self.recompute_vjp = recompute_vjp
        self.launches = 0
        self.__doc__ = plain.__doc__

    def __call__(self, x: torch.Tensor, *args, **kwargs):
        if x.is_cpu:
            return self.plain(x, *args, **kwargs)
        out = self.launch(x, *args, **kwargs)
        self.launches += 1
        return out

    def launch(self, *args, **kwargs):
        """The kernel path on these arguments, whatever their device."""
        if self.recompute_vjp and (needs_grad(*args)
                                   or torch.is_autocast_enabled("cuda")):
            if kwargs:
                raise TypeError(f"{self.name}: positional arguments only")
            return RecomputeVjp.apply(self._launch, self.plain, *args)
        return self._launch(*args, **kwargs)

    def plain_as_launched(self, *args, **kwargs):
        """``plain`` on the inputs the kernel would get (see ``casts``)."""
        if not (self.casts and torch.is_autocast_enabled("cuda")):
            return self.plain(*args, **kwargs)
        dt = torch.get_autocast_dtype("cuda")
        with torch.autocast("cuda", enabled=False):
            return self.plain(*_cast(args, dt), **_cast(kwargs, dt))


_plain_path = False


@contextlib.contextmanager
def plain_path(enabled: bool = True):
    """Inside this block the models call every kernel's plain PyTorch
    version, on any device: the reference path that ``chip_smoke.py``
    compares the kernel path with.  The wrappers themselves stay as they
    are (a CUDA tensor launches or raises).  ``enabled=False`` selects the
    kernels (a recomputation in the backward re-enters the choice of its
    forward, ``in_plain_path()``)."""
    global _plain_path
    prev, _plain_path = _plain_path, enabled
    try:
        yield
    finally:
        _plain_path = prev


def in_plain_path() -> bool:
    """Whether the models call the plain versions (inside ``plain_path()``)."""
    return _plain_path


def needs_grad(*args) -> bool:
    """Whether autograd records a call on these arguments (tensors among
    any others)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in args)


def select(op: KernelOp) -> Callable:
    """What a model calls for ``op``: the op, or its plain version inside
    ``plain_path()``."""
    return op.plain_as_launched if _plain_path else op


# --------------------------------------------------------------------------
# Launchers of the primitives (CUDA tensors only).
# --------------------------------------------------------------------------


def _check(t: torch.Tensor, what: str, ndim: int = 2):
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{what}: expected bfloat16, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim}-D, got {tuple(t.shape)}")
    if t.stride(-1) != 1 or t.data_ptr() % 16 != 0:
        raise ValueError(f"{what}: last dim must be contiguous and the data "
                         "16-byte aligned")
    if ndim == 2 and t.stride(0) % 8 != 0:
        raise ValueError(f"{what}: row stride must be a multiple of 8")


def _vec(t: Optional[torch.Tensor], n: int, what: str,
         optional: bool = True):
    """Pointer of a bf16 vector [n], or null for None where the kernel takes
    none (``optional``; otherwise None raises)."""
    if t is None:
        if not optional:
            raise ValueError(f"{what}: required, got None")
        return None
    _check(t, what, ndim=1)
    if t.shape[0] != n:
        raise ValueError(f"{what}: expected [{n}], got {tuple(t.shape)}")
    return t.data_ptr()


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    """The current stream of t's device, as the raw handle a C entry takes
    (without building a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _rows(rows: Optional[torch.Tensor], M: int, device, what: str):
    """Pointer of a row index (int32 [M], contiguous, on ``device``; a
    negative entry is a pad row: zeros where it gathers, dropped where it
    scatters)."""
    if rows is None:
        return None
    if (rows.dtype != torch.int32 or rows.device != device
            or not rows.is_contiguous() or tuple(rows.shape) != (M,)):
        raise ValueError(f"{what} rows: expected a contiguous int32 [{M}] "
                         f"on {device}")
    return rows.data_ptr()


def _dropout_args(seed: Optional[torch.Tensor], rate: float, device):
    """(seed pointer, threshold, scale) for a kernel; no dropout (null
    seed) at rate 0.  The seed is an int64 [1] on the data's device, read
    by the kernel (nothing syncs with the host)."""
    thresh = threshold(rate)
    if rate == 0.0:
        return None, 0, 1.0
    if (seed is None or seed.dtype != torch.int64 or seed.numel() != 1
            or seed.device != device):
        raise ValueError(f"dropout seed: expected an int64 [1] on {device}")
    return seed.data_ptr(), thresh, 1.0 / (1.0 - rate)


def dropout_bits(seed: torch.Tensor, n_stream: int,
                 n_index: int) -> torch.Tensor:
    """The kernels' dropout bits of every (stream, index) counter, as int64
    [n_stream, n_index] in [0, 2^32) (a probe for the tests)."""
    if seed.device.type != "cuda" or seed.dtype != torch.int64 or (
            seed.numel() != 1):
        raise ValueError("dropout_bits: seed must be a CUDA int64 [1]")
    out = torch.empty(n_stream, n_index, dtype=torch.int32,
                      device=seed.device)
    err = library().lvt_dropout_bits(seed.data_ptr(), out.data_ptr(),
                                     n_stream, n_index, _stream(seed))
    _raise_on(err, "lvt_dropout_bits")
    return out.to(torch.int64) & 0xFFFFFFFF


# the widest row of the row-resident primitives (the scalar and chunk LNs,
# the tile GEMM's row kernel): csrc/common.cuh kMaxRowC (Swin-L's stage 4
# runs C = 1536); wider rows raise
MAX_ROW_C = 2048


def layernorm(x: torch.Tensor, weight: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float,
              rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row LayerNorm of contiguous x [M, C], C <= MAX_ROW_C; ``weight`` and
    ``bias`` both None: the pure normalize (the serving fold cache's LN).
    ``rows`` (int32 [M'], indices into x's rows) gathers: out[m] =
    LN(x[rows[m]]), a zero row where rows[m] < 0."""
    _check(x, "layernorm x")
    if not x.is_contiguous() or x.shape[1] > MAX_ROW_C:
        raise ValueError(f"layernorm: x must be contiguous with C <= "
                         f"{MAX_ROW_C}")
    if (weight is None) != (bias is None):
        raise ValueError("layernorm: weight and bias are both given or both "
                         "None")
    M, C = x.shape
    if rows is not None:
        M = rows.shape[0]
    out = torch.empty(M, C, dtype=x.dtype, device=x.device)
    err = library().lvt_layernorm_bf16(
        x.data_ptr(), _vec(weight, C, "layernorm weight"),
        _vec(bias, C, "layernorm bias"), out.data_ptr(), M, C, float(eps),
        _rows(rows, M, x.device, "layernorm"), _stream(x))
    _raise_on(err, "lvt_layernorm_bf16")
    return out


def layernorm_rows(x: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], eps: float,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``layernorm`` on 16-byte chunks (``lvt_layernorm_rows_bf16``, the
    LN of K3, K9 and K14): x [M, C] contiguous, C a multiple of 8 and <=
    MAX_ROW_C, the affine (both or neither) contiguous and 16-byte aligned;
    ``rows`` gathers as ``layernorm``'s does."""
    _check(x, "layernorm_rows x")
    M, C = x.shape
    if not x.is_contiguous() or C % 8 or C > MAX_ROW_C:
        raise ValueError(f"layernorm_rows: x {tuple(x.shape)} must be "
                         f"contiguous with C % 8 == 0, C <= {MAX_ROW_C}")
    if (weight is None) != (bias is None):
        raise ValueError("layernorm_rows: weight and bias are both given or "
                         "both None")
    for t, what in ((weight, "weight"), (bias, "bias")):
        if t is not None:
            _tc_operand(t, (C,), x.device, f"layernorm_rows {what}")
    if rows is not None:
        M = rows.shape[0]
    out = torch.empty(M, C, dtype=x.dtype, device=x.device)
    err = library().lvt_layernorm_rows_bf16(
        x.data_ptr(), _ptr(weight), _ptr(bias), out.data_ptr(), M, C,
        float(eps), _rows(rows, M, x.device, "layernorm_rows"), _stream(x))
    _raise_on(err, "lvt_layernorm_rows_bf16")
    return out


def _attention_args(qkv, n_seq, n_tok, n_heads, bias, mask, what):
    """Checks shared by the attention core and its backward; returns
    (C, hd, nW)."""
    _check(qkv, f"{what} qkv")
    if not qkv.is_contiguous() or qkv.shape[0] != n_seq * n_tok:
        raise ValueError(f"{what}: qkv must be a contiguous "
                         f"[{n_seq * n_tok}, 3C] slab, got {tuple(qkv.shape)}")
    C = qkv.shape[1] // 3
    hd = C // n_heads
    if 3 * C != qkv.shape[1] or hd * n_heads != C or hd not in (16, 32, 64):
        raise ValueError(f"{what}: head dim {hd} unsupported (16/32/64)")
    n_win = 1
    for t, name, lead in ((bias, "bias", n_heads), (mask, "mask", None)):
        if t is None:
            continue
        _check(t, f"{what} {name}", ndim=3)
        if not t.is_contiguous() or tuple(t.shape[1:]) != (n_tok, n_tok) or (
                lead is not None and t.shape[0] != lead):
            raise ValueError(f"{what} {name}: bad shape {tuple(t.shape)}")
    if mask is not None:
        n_win = mask.shape[0]
        if n_seq % n_win != 0:
            raise ValueError(f"{what}: n_seq must be a multiple of nW")
    return C, hd, n_win


def _check_lse(lse, qkv, n_seq, n_heads, n_tok, what):
    if (lse.dtype != torch.float32 or lse.device != qkv.device
            or not lse.is_contiguous()
            or tuple(lse.shape) != (n_seq, n_heads, n_tok)):
        raise ValueError(f"{what} lse: expected contiguous f32 "
                         f"[{n_seq}, {n_heads}, {n_tok}]")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def attention_route(*, tensor_cores: bool = False, lse: bool = False,
                    keep: bool = False, bias: bool = False,
                    dropout: bool = False) -> str:
    """The core a packed-slab ``attention`` call runs on, from what it
    carries: "tensor_cores", where the caller selects them (K1, K4) or asks
    for lse (K10a: ``csrc/attention_fwd_tc.cu``; with a bias, K8a:
    ``csrc/attention_fwd_wgmma.cu``, as ``attention_fwd_plan`` sizes it).
    A call that does neither raises: the f32-pipe core that took such
    calls is gone, and a caller written for it is refused rather than
    moved silently.  Raises also on what the core does not take: dropout
    without lse or with a bias, a keep vector with lse, dropout or a
    bias."""
    if dropout and (not lse or bias):
        raise ValueError("attention: dropout needs lse and no bias (the "
                         "tensor-core route)")
    if not (tensor_cores or lse):
        raise ValueError("attention: the packed core runs on the tensor "
                         "cores; select them (tensor_cores=True) or ask "
                         "for lse")
    if keep and (lse or dropout or bias):
        raise ValueError("attention: the tensor cores take a keep vector "
                         "only without lse, dropout and bias")
    return "tensor_cores"


def attention(qkv: torch.Tensor, n_seq: int, n_tok: int, n_heads: int,
              scale: float, bias: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              keep: Optional[torch.Tensor] = None,
              lse: Optional[torch.Tensor] = None,
              seed: Optional[torch.Tensor] = None,
              rate: float = 0.0, tensor_cores: bool = False,
              head0: int = 0, heads_total: int = 0) -> torch.Tensor:
    """Attention core on the packed qkv slab [n_seq * n_tok, 3C].

    bias [nH, N, N], mask [nW, N, N] (sequence s uses window s % nW), keep
    [n_seq, N] bool or uint8 (0: the key is dropped for every query; a row
    with every key dropped is 0); all optional.  ``lse``, when given, is a
    contiguous f32 [n_seq, nH, N] that receives each query row's
    log-sum-exp of its scores (what ``attention_bwd`` takes).  At ``rate``
    > 0 the probabilities are dropped by the counter hash of ``seed`` (an
    int64 [1] on the device; ``dropout.attention_keep``) in the P.V sum
    only, the stream of (sequence s, head h) s * heads_total + head0 + h
    (``heads_total`` 0: n_heads; a tensor-parallel rank's own heads).  The
    core is the tensor cores', for a call with ``lse`` (K10a, K8a) or
    ``tensor_cores`` (K1, K4); ``attention_route`` refuses any other.  A
    call with ``lse`` and ``bias`` (K8a) runs on the wgmma + TMA forward
    (``csrc/attention_fwd_wgmma.cu``; ``attention_fwd_plan`` raises where
    it does not run), the others on ``csrc/attention_fwd_tc.cu``.  Returns
    [n_seq * n_tok, C]."""
    C, hd, n_win = _attention_args(qkv, n_seq, n_tok, n_heads, bias, mask,
                                   "attention")
    attention_route(tensor_cores=tensor_cores, lse=lse is not None,
                    keep=keep is not None, bias=bias is not None,
                    dropout=rate > 0.0)
    if lse is not None:
        _check_lse(lse, qkv, n_seq, n_heads, n_tok, "attention")
    keep_ptr = None
    if keep is not None:
        if keep.device != qkv.device or tuple(keep.shape) != (n_seq, n_tok):
            raise ValueError(f"attention keep: expected [{n_seq}, {n_tok}] on "
                             f"{qkv.device}, got {tuple(keep.shape)}")
        # a contiguous bool is read in place as its bytes (no copy)
        if keep.dtype == torch.bool and keep.is_contiguous():
            keep = keep.view(torch.uint8)
        else:
            keep = keep.to(torch.uint8).contiguous()
        if keep.data_ptr() % 4:
            keep = keep.clone()
        keep_ptr = keep.data_ptr()
    seed_ptr, thresh, drop_scale = _dropout_args(seed, rate, qkv.device)
    out = torch.empty(qkv.shape[0], C, dtype=qkv.dtype, device=qkv.device)
    if lse is not None and bias is not None:  # K8a: the wgmma forward
        e = qkv.element_size()
        attention_fwd_plan(
            n_seq, n_tok, n_heads, hd,
            _stepped((n_seq, n_heads, n_tok), (n_tok * 3 * C, hd, 3 * C),
                     (n_tok * C, hd, C)),
            (qkv.data_ptr(), qkv.data_ptr() + C * e,
             qkv.data_ptr() + 2 * C * e, out.data_ptr(), bias.data_ptr())
            + (() if mask is None else (mask.data_ptr(),)))
    err = library().lvt_attention_bf16(
        qkv.data_ptr(), out.data_ptr(), _ptr(bias), _ptr(mask), keep_ptr,
        _ptr(lse), n_seq, n_tok, n_heads, hd, n_win, float(scale), seed_ptr,
        thresh, drop_scale, int(tensor_cores), head0, heads_total,
        _stream(qkv))
    _raise_on(err, "lvt_attention_bf16")
    return out


def _heads_operands(ts, names, what):
    """Checks of heads-layout operands [S, nH, N, hd]: bf16 on the card,
    one shape, the head dim contiguous, 16-byte aligned, the other strides
    multiples of 8 (one pass of cheap attribute reads: the checks run on
    every launch)."""
    shape = ts[0].shape
    for t, name in zip(ts, names):
        st = t.stride()
        if not (t.is_cuda and t.dtype == torch.bfloat16 and len(st) == 4
                and t.shape == shape and st[3] == 1 and t.data_ptr() % 16 == 0
                and all(s % 8 == 0 or n == 1 for s, n in zip(st, shape[:3]))):
            raise ValueError(
                f"{what} {name}: expected a bf16 CUDA tensor of shape "
                f"{tuple(shape)}, the head dim contiguous and 16-byte "
                f"aligned, the other strides multiples of 8; got {t.dtype} "
                f"{tuple(t.shape)} strides {st} on {t.device}")
    if shape[3] not in (16, 32, 64):
        raise ValueError(f"{what}: head dim {shape[3]} unsupported "
                         "(16/32/64)")


def _heads_mask(mask: torch.Tensor, q: torch.Tensor, what: str):
    """Check of a heads-layout mask: a contiguous f32 [B, L, L] on q's
    device."""
    B, _, L, _ = q.shape
    if (mask.device != q.device or mask.dtype != torch.float32
            or not mask.is_contiguous() or tuple(mask.shape) != (B, L, L)):
        raise ValueError(f"{what} mask: expected a contiguous f32 "
                         f"[{B}, {L}, {L}] on {q.device}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")


def padded_rows(n: int, N: int, dtype: torch.dtype,
                device) -> torch.Tensor:
    """An uninitialised [n, N, N] view of an [n, N, ld] buffer, ld = N
    rounded up to 16 bytes: rows that the tensor-core forward stages by
    its widest (16-byte) copy, where N's own pitch would take 4-byte
    copies (N = 275: 1100 bytes in f32)."""
    per = 16 // dtype.itemsize
    ld = -(-N // per) * per
    return torch.empty_strided((n, N, N), (N * ld, ld, 1), dtype=dtype,
                               device=device)


def with_padded_rows(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` [n, N, N] in ``padded_rows``."""
    return padded_rows(*t.shape[:2], t.dtype, t.device).copy_(t)


def _row_pitch(t: torch.Tensor, lead: Optional[int], N: int, dtypes,
               device, what: str) -> int:
    """Check of a mask or bias [lead, N, N] for the tensor-core forward
    (one of ``dtypes``, on ``device``, rows contiguous and 16-byte
    aligned, each [N, N] slice rows of one buffer: contiguous, or a view
    of ``padded_rows``); returns the elements between its rows."""
    sh, st = t.shape, t.stride()
    if (t.dtype not in dtypes or len(sh) != 3 or sh[1] != N or sh[2] != N
            or (lead is not None and sh[0] != lead) or st[2] != 1
            or st[1] < N or (sh[0] > 1 and st[0] != N * st[1])
            or t.data_ptr() % 16 or t.device != device):
        raise ValueError(f"{what}: expected {'/'.join(map(str, dtypes))} "
                         f"[{'nW' if lead is None else lead}, {N}, {N}] on "
                         f"{device}, rows contiguous and 16-byte aligned, "
                         f"got {t.dtype} {tuple(sh)} strides {st} on "
                         f"{t.device}")
    return st[1]


def _strides(*ts) -> ctypes.Array:
    """The (sequence, head, row) element strides of heads-layout tensors,
    in turn (host memory, the kernels' ``st``)."""
    return (ctypes.c_longlong * (3 * len(ts)))(
        *sum((t.stride()[:3] for t in ts), ()))


def attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, scale: float,
                    lse: Optional[torch.Tensor] = None,
                    seed: Optional[torch.Tensor] = None,
                    rate: float = 0.0, head0: int = 0,
                    heads_total: int = 0) -> torch.Tensor:
    """The attention core on heads-layout q, k, v [B, nH, L, hd] (bf16, any
    strides with the head dim contiguous, e.g. transposed views of
    [B, L, nH, hd]) under an additive per-sequence f32 mask [B, L, L]
    (its rows contiguous: contiguous, or a view of ``padded_rows``), read
    in place, on the tensor cores (``csrc/attention_fwd_tc.cu``, any L).
    ``lse`` (a contiguous f32 [B, nH, L]), when given, receives each query
    row's log-sum-exp (K13a; K7 passes none); at ``rate`` > 0 the
    probabilities are dropped in the P.V sum by the counter hash of
    ``seed`` at the logical (sequence, head, row, key) (the same bits as
    ``attention`` on the packed slab, ``head0`` and ``heads_total`` as
    there).  Returns a contiguous [B, nH, L, hd]."""
    _heads_operands((q, k, v), ("q", "k", "v"), "attention_heads")
    B, nH, L, hd = q.shape
    ld = _row_pitch(mask, B, L, (torch.float32,), q.device,
                    "attention_heads mask")
    if lse is not None:
        _check_lse(lse, q, B, nH, L, "attention_heads")
    seed_ptr, thresh, drop_scale = _dropout_args(seed, rate, q.device)
    out = torch.empty(B, nH, L, hd, dtype=q.dtype, device=q.device)
    err = library().lvt_attention_heads_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _strides(q, k, v, out), mask.data_ptr(), ld, _ptr(lse), B, L, nH, hd,
        float(scale), seed_ptr, thresh, drop_scale, head0, heads_total,
        _stream(q))
    _raise_on(err, "lvt_attention_heads_bf16")
    return out


# the wgmma kernels' tile (csrc/attention_wg.cuh kT): 64 query rows a
# forward CTA, 64 keys a backward CTA, 64 queries a step of its sweep
ATTN_BWD_TILE = 64
# the wgmma forward's warpgroups a CTA (csrc/attention_fwd_wgmma.cu kWGs)
ATTN_FWD_WGS = 2
# the shared memory one CTA may take (227 KB of an SM's 228)
CTA_SMEM = 227 * 1024


def _wg_operands(what: str, hd: int, strides, ptrs):
    """The wgmma kernels' rules: hd in {16, 32, 64}, every stepped stride
    a multiple of 8 elements and every pointer 16-byte aligned (the tensor
    maps' rule, and the 16-byte copies of the bias and mask)."""
    if hd not in (16, 32, 64):
        raise ValueError(f"{what}: head dim {hd} unsupported (16/32/64)")
    bad = [st for st in strides if st % 8]
    if bad:
        raise ValueError(f"{what}: strides {bad} are not multiples of 8 "
                         "elements (16 bytes)")
    bad = [hex(pt) for pt in ptrs if pt % 16]
    if bad:
        raise ValueError(f"{what}: pointers {bad} are not 16-byte aligned")


class AttnFwdPlan(NamedTuple):
    q_tiles: int     # 64-row query tiles of a sequence
    keys: int        # keys a block: 256 up to 256 tokens, else 128
    key_blocks: int  # blocks of a query tile's row (1: the softmax exact,
    #                  no running rescale)
    ctas: int        # one a (sequence, head), two warpgroups each
    smem: int        # dynamic shared memory a CTA, bytes
    tma_tiles: bool  # the bias and mask tiles by TMA (rows 16-byte
    #                  aligned: N % 8 == 0), else by cp.async


def attention_fwd_plan(n_seq: int, n_tok: int, n_heads: int, hd: int,
                       strides=(), ptrs=()) -> AttnFwdPlan:
    """The launch of the wgmma + TMA forward of K8a
    (``csrc/attention_fwd_wgmma.cu``: lse with a per-head bias, a bf16
    mask or none) on n_seq sequences of n_tok tokens and n_heads heads of
    hd, as its C entry sizes it: query tiles, the key block (256 keys up to
    256 tokens, else 128), key blocks, CTAs (a (sequence, head) each, its
    two warpgroups taking alternate query tiles), shared memory (each
    warpgroup's Q tile and 64-row bias and mask tiles of a key block, the
    sequence's K and V whole), and whether the bias and mask tiles come by
    TMA (their rows 16-byte aligned) or by cp.async (rows padded by 16
    bytes for the lead).  ``strides``: the element strides the kernel
    steps, ``ptrs``: the operands' addresses.  Raises where the kernel does
    not run: hd outside {16, 32, 64}, a stride that is no multiple of 8
    elements or a pointer that is not 16-byte aligned, more tokens than
    65535 or than K and V that fit beside the tiles in a CTA's 227 KB
    (1152 at hd 32, 512 at hd 64), more CTAs than a launch takes.  Pure
    arithmetic."""
    what = "attention forward (wgmma)"
    _wg_operands(what, hd, strides, ptrs)
    if not 0 < n_tok <= 65535:
        raise ValueError(f"{what}: {n_tok} tokens, outside 1..65535")
    keys = 256 if n_tok <= 256 else 128
    tma_tiles = n_tok % 8 == 0
    tile = ATTN_BWD_TILE * 2 * hd
    wide = ATTN_BWD_TILE * (2 * keys + (0 if tma_tiles else 16))
    q_tiles = -(-n_tok // ATTN_BWD_TILE)
    smem = ATTN_FWD_WGS * (tile + 2 * wide) + 2 * q_tiles * tile + 1024
    if smem > CTA_SMEM:
        raise ValueError(f"{what}: {n_tok} tokens' K and V do not fit "
                         f"beside the tiles ({smem} bytes of shared memory "
                         f"at hd {hd}, over {CTA_SMEM})")
    ctas = n_seq * n_heads
    if ctas > 2 ** 31 - 1:
        raise ValueError(f"{what}: {ctas} CTAs, more than a launch takes")
    return AttnFwdPlan(q_tiles, keys, -(-n_tok // keys), ctas, smem,
                       tma_tiles)


class AttnBwdPlan(NamedTuple):
    tiles: int      # T: 64-row key tiles of a sequence (as many query tiles)
    ctas: int       # one a (key tile, sequence, head), two an SM
    stages: int     # query tiles in the ring
    smem: int       # dynamic shared memory a CTA, bytes
    acc_bytes: int  # the f32 dQ sums, T x 64 x hd a (sequence, head); 0 at
    #                 T = 1
    sems: int       # int32 turn counters, one a (sequence, head, query
    #                 tile); 0 at T = 1
    # with a bias (K8b): the dbias kernel's chunks of sequences, CTAs (one a
    # (query tile, key tile, head, chunk)) and shared memory, and its f32
    # partial sums [chunks, heads, N, N]; 0 without; whether the bias and
    # mask tiles come by TMA (rows 16-byte aligned: N % 8 == 0)
    dbias_chunks: int = 0
    dbias_ctas: int = 0
    dbias_smem: int = 0
    part_bytes: int = 0
    tma_tiles: bool = False


def attention_bwd_plan(n_seq: int, n_tok: int, n_heads: int, hd: int,
                       mask_f32: bool, strides=(), ptrs=(),
                       sms: int = H100_SMS,
                       bias: bool = False) -> AttnBwdPlan:
    """The launch of the wgmma + TMA backward of K10b / K13b, and with
    ``bias`` of K8b (``csrc/attention_bwd_wgmma.cu``) on n_seq sequences of
    n_tok tokens and n_heads heads of hd, as its C entry sizes it: key
    tiles, CTAs, the ring's stages, shared memory (with the bias, each
    stage's bias tile too), the dQ sums' scratch and the turn counters
    (both unused at one tile), and with the bias the dbias kernel's chunks
    of sequences (enough for eight CTAs on each of ``sms`` SMs, at most
    n_seq), CTAs, shared memory and partial sums, and whether the bias and
    mask tiles come by TMA (64 x 64 boxes, where N % 8 == 0) or by cp.async
    (rows padded by 16 bytes for their lead).  ``strides``: the element
    strides the kernel steps (the operands' sequence, head and row strides
    whose extent is over 1), ``ptrs``: the operands' addresses.  Raises
    where the kernel does not run: hd outside {16, 32, 64}, a stride that
    is no multiple of 8 elements or a pointer that is not 16-byte aligned
    (the tensor maps' rule), more key tiles than two CTAs on each of
    ``sms`` SMs (a key tile's CTA waits on the next one's, so all must be
    resident at once), more than 65535 tokens, a bias under an f32 mask.
    Pure arithmetic."""
    what = "attention backward"
    _wg_operands(what, hd, strides, ptrs)
    if not 0 < n_tok <= 65535:
        raise ValueError(f"{what}: {n_tok} tokens, outside 1..65535")
    if bias and mask_f32:
        raise ValueError(f"{what}: the bias's backward takes a bf16 mask")
    tiles = -(-n_tok // ATTN_BWD_TILE)
    if tiles > 2 * sms:
        raise ValueError(f"{what}: {n_tok} tokens make {tiles} "
                         f"key tiles, more than the {2 * sms} CTAs the card "
                         "holds at once")
    stages = 2
    tile = ATTN_BWD_TILE * 2 * hd
    tma_tiles = bias and n_tok % 8 == 0
    mask_tile = ATTN_BWD_TILE * (ATTN_BWD_TILE * 2 + (0 if tma_tiles else 16))
    mask = ATTN_BWD_TILE * (ATTN_BWD_TILE * (4 if mask_f32 else 2)
                            + (0 if tma_tiles else 16))
    rows = 2 * ATTN_BWD_TILE * 4  # a stage's lse and D rows
    # K, V, each stage's Q and G, dS^T, dQ_t's f32 hand-off, each stage's
    # mask tile and lse / D rows (and bias tile), 1 KB to align
    smem = ((2 + 2 * stages) * tile + ATTN_BWD_TILE * 128
            + ATTN_BWD_TILE * hd * 4 + stages * (mask + rows)
            + (stages * mask_tile if bias else 0) + 1024)
    pairs = n_seq * n_heads
    acc = pairs * tiles * ATTN_BWD_TILE * hd * 4 if tiles > 1 else 0
    plan = AttnBwdPlan(tiles, pairs * tiles, stages, smem, acc,
                       pairs * tiles if tiles > 1 else 0)
    if not bias:
        return plan
    base = tiles * tiles * n_heads
    chunks = max(1, min(n_seq, 65535, -(-8 * sms // base)))
    # each stage's K, V, Q and G, mask tile and lse / D rows, the bias tile
    db_smem = stages * (4 * tile + mask_tile + rows) + mask_tile + 1024
    return plan._replace(dbias_chunks=chunks, dbias_ctas=base * chunks,
                         dbias_smem=db_smem,
                         part_bytes=chunks * n_heads * n_tok * n_tok * 4,
                         tma_tiles=tma_tiles)


# the wgmma backward's turn counters per (device, stream): int32, 0 between
# calls (each call's last adder of a tile resets its counter), grown on demand
_sem_bufs: dict = {}


def _bwd_scratch(x: torch.Tensor, stream: int, plan: AttnBwdPlan):
    """(acc, sem) addresses of the wgmma backward's scratch for ``plan``
    on x's device (both None at one key tile)."""
    if plan.sems == 0:
        return None, None
    key = (x.get_device(), stream)
    sem = _sem_bufs.get(key)
    if sem is None or sem.numel() < plan.sems:
        with torch.inference_mode(False):
            sem = _sem_bufs[key] = torch.zeros(plan.sems, dtype=torch.int32,
                                               device=x.device)
    return _scratch(x, stream, plan.acc_bytes), sem.data_ptr()


def _stepped(extents, *strides) -> tuple:
    """The strides of (sequence, head, row) triples whose extent is over 1."""
    return tuple(st for triple in strides for st, n in zip(triple, extents)
                 if n > 1)


def _row_dot(out: Optional[torch.Tensor], dout: torch.Tensor,
             what: str) -> torch.Tensor:
    """D = rowsum(out * dout) in f32 [S, nH, L] of heads-layout out and dout
    [S, nH, L, hd] (bf16, strides as in ``attention_heads``): the
    tensor-core backward's D = rowsum(p * dp), from the forward's output."""
    if out is None:
        raise ValueError(f"{what}: the forward's output is required on the "
                         "tensor-core route")
    _heads_operands((out, dout), ("out", "dout"), what)
    S, nH, L, hd = dout.shape
    dd = torch.empty(S, nH, L, dtype=torch.float32, device=dout.device)
    err = library().lvt_attention_row_dot_bf16(
        out.data_ptr(), dout.data_ptr(), _strides(out, dout), dd.data_ptr(),
        S, L, nH, hd, _stream(dout))
    _raise_on(err, "lvt_attention_row_dot_bf16")
    return dd


def attention_heads_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor,
                        mask: torch.Tensor, scale: float,
                        seed: Optional[torch.Tensor] = None,
                        rate: float = 0.0, dmask: bool = False,
                        out: Optional[torch.Tensor] = None, head0: int = 0,
                        heads_total: int = 0):
    """Backward of ``attention_heads`` with dropout: q, k, v and the
    cotangent ``dout`` [B, nH, L, hd] (bf16, strides as there), the
    forward's lse [B, nH, L] and mask [B, L, L] (f32, the same buffer).
    Returns (dq, dk, dv) contiguous [B, nH, L, hd] bf16 and, with
    ``dmask``, the f32 [B, L, L] sum over heads of the scores' gradient
    (the same on every run: per-chunk partial sums, then one pass adding
    them), else None.  Without ``dmask`` the wgmma + TMA kernel runs
    (``csrc/attention_bwd_wgmma.cu``, as ``attention_bwd_plan`` sizes it)
    and needs the forward's output ``out`` [B, nH, L, hd] (for D =
    rowsum(out * dout)); with it the f32-pipe kernel.  ``head0`` and
    ``heads_total``: the dropout's stream, as the forward's."""
    _heads_operands((q, k, v, dout), ("q", "k", "v", "dout"),
                    "attention_heads_bwd")
    B, nH, L, hd = q.shape
    _heads_mask(mask, q, "attention_heads_bwd")
    _check_lse(lse, q, B, nH, L, "attention_heads_bwd")
    seed_ptr, thresh, drop_scale = _dropout_args(seed, rate, q.device)
    dq, dk, dv = (torch.empty(B, nH, L, hd, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    acc = sem = None
    if not dmask:
        n_chunks, dm = nH, None
        outs = (dq, dk, dv)
        plan = attention_bwd_plan(
            B, L, nH, hd, True,
            _stepped((B, nH, L), *(t.stride()[:3] for t in (q, k, v, dout,
                                                             *outs))),
            tuple(t.data_ptr() for t in (q, k, v, dout, *outs, mask)))
        part = _row_dot(out, dout, "attention_heads_bwd")
        acc, sem = _bwd_scratch(q, _stream(q), plan)
    else:
        # one block per (sequence, chunk of heads): enough chunks for two
        # blocks per SM, each summing its heads into its own f32 slice
        n_chunks = max(1, min(nH, -(-264 // B)))
        part = torch.empty(n_chunks, B, L, L, dtype=torch.float32,
                           device=q.device)
        dm = torch.empty(B, L, L, dtype=torch.float32, device=q.device)
    err = library().lvt_attention_heads_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), mask.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _ptr(dm), _ptr(part),
        _strides(q, k, v, dout, dq, dk, dv), B, L, nH, hd, n_chunks,
        float(scale), seed_ptr, thresh, drop_scale, head0, heads_total, acc,
        sem, _stream(q))
    _raise_on(err, "lvt_attention_heads_bwd_bf16")
    return dq, dk, dv, dm


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor],
                     mask: Optional[torch.Tensor], scale: float
                     ) -> torch.Tensor:
    """softmax(q k^T * scale + bias[h] + mask[w % nW]) v per (window, head)
    on heads-layout q, k, v [W, nH, N, hd] (bf16, read in place by their
    strides, as ``attention_heads``), on the tensor cores; bias [nH, N, N]
    bf16 and mask [nW, N, N] bf16 or f32 (read in its own dtype), both
    optional, each with its rows contiguous (contiguous, or a view of
    ``padded_rows``).  Returns a contiguous [W, nH, N, hd]."""
    _heads_operands((q, k, v), ("q", "k", "v"), "window_attention")
    W, nH, N, hd = q.shape
    bias_ld, mask_ld, n_win = 0, 0, 1
    if bias is not None:
        bias_ld = _row_pitch(bias, nH, N, (torch.bfloat16,), q.device,
                             "window_attention bias")
    if mask is not None:
        mask_ld = _row_pitch(mask, None, N, (torch.bfloat16, torch.float32),
                             q.device, "window_attention mask")
        n_win = mask.shape[0]
        if W % n_win:
            raise ValueError(f"window_attention mask: {W} windows are not a "
                             f"multiple of its {n_win}")
    out = torch.empty(W, nH, N, hd, dtype=q.dtype, device=q.device)
    err = library().lvt_window_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _strides(q, k, v, out), _ptr(bias), bias_ld, _ptr(mask), mask_ld,
        int(mask is not None and mask.dtype == torch.float32), W, N, nH, hd,
        n_win, float(scale), _stream(q))
    _raise_on(err, "lvt_window_attention_bf16")
    return out


def attention_bwd(qkv: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  n_seq: int, n_tok: int, n_heads: int, scale: float,
                  out: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  seed: Optional[torch.Tensor] = None, rate: float = 0.0,
                  head0: int = 0, heads_total: int = 0):
    """Backward of ``attention`` with ``lse`` (no keep vector), on the
    wgmma + TMA kernels (``csrc/attention_bwd_wgmma.cu``, launched as
    ``attention_bwd_plan`` sizes them): without a bias (K10b) the
    backward, with one (K8b) the backward with the bias tile, then the
    dbias kernel by chunks of sequences and the chunks' sum in order.

    qkv [n_seq * N, 3C], dout and the forward's output ``out`` [n_seq * N,
    C] (bf16; D = rowsum(out * dout)), lse the forward's f32 [n_seq, nH,
    N]; ``seed``, ``rate``, ``head0`` and ``heads_total`` the forward's
    dropout, whose bits are regenerated.  Returns (dqkv [n_seq * N, 3C] bf16, dbias [nH, N, N] f32
    summed over every sequence, or None without a bias); the mask gets no
    gradient."""
    C, hd, n_win = _attention_args(qkv, n_seq, n_tok, n_heads, bias, mask,
                                   "attention_bwd")
    for t, name in ((dout, "dout"), (out, "out")):
        _check(t, f"attention_bwd {name}")
        if not t.is_contiguous() or tuple(t.shape) != (qkv.shape[0], C):
            raise ValueError(f"attention_bwd {name}: expected contiguous "
                             f"[{qkv.shape[0]}, {C}], got {tuple(t.shape)}")
    _check_lse(lse, qkv, n_seq, n_heads, n_tok, "attention_bwd")
    if rate > 0.0 and bias is not None:
        raise ValueError("attention_bwd: dropout with a bias is not taken")
    seed_ptr, thresh, drop_scale = _dropout_args(seed, rate, qkv.device)
    dqkv = torch.empty_like(qkv)

    def heads(t):
        return t.view(n_seq, n_tok, n_heads, hd).transpose(1, 2)
    dd = _row_dot(heads(out), heads(dout), "attention_bwd")
    slab, cols = (n_tok * 3 * C, hd, 3 * C), (n_tok * C, hd, C)
    e = qkv.element_size()
    plan = attention_bwd_plan(
        n_seq, n_tok, n_heads, hd, False,
        _stepped((n_seq, n_heads, n_tok), slab, cols),
        (qkv.data_ptr(), qkv.data_ptr() + C * e, qkv.data_ptr() + 2 * C * e,
         dout.data_ptr(), dqkv.data_ptr(), dqkv.data_ptr() + C * e,
         dqkv.data_ptr() + 2 * C * e)
        + tuple(t.data_ptr() for t in (bias, mask) if t is not None),
        bias=bias is not None)
    acc, sem = _bwd_scratch(qkv, _stream(qkv), plan)
    n_chunks, dbias, part = 1, None, None
    if bias is not None:  # K8b: dbias by chunks of sequences, summed in order
        n_chunks = plan.dbias_chunks
        part = torch.empty(n_chunks, n_heads, n_tok, n_tok,
                           dtype=torch.float32, device=qkv.device)
        dbias = torch.empty(n_heads, n_tok, n_tok, dtype=torch.float32,
                            device=qkv.device)
    err = library().lvt_attention_bwd_bf16(
        qkv.data_ptr(), dout.data_ptr(), lse.data_ptr(), dd.data_ptr(),
        _ptr(bias), _ptr(mask), dqkv.data_ptr(), _ptr(dbias), _ptr(part),
        n_seq, n_tok, n_heads, hd, n_win, n_chunks, float(scale), seed_ptr,
        thresh, drop_scale, head0, heads_total, acc, sem, _stream(qkv))
    _raise_on(err, "lvt_attention_bwd_bf16")
    return dqkv, dbias


# the K depth of gemm_tc.cu's tiles (BK): K-slices are whole such steps
TILE_K = 64
# scratch of ffn_post_ln and gemm_tc_ln per (device, stream): one uint8
# buffer, grown on demand (the calls on one stream run in order, so they
# can share it)
_scratch_bufs: dict = {}


def _scratch(x: torch.Tensor, stream: int, nbytes: int) -> int:
    """Address of at least ``nbytes`` of scratch on x's device for the
    launches on ``stream``."""
    key = (x.get_device(), stream)
    buf = _scratch_bufs.get(key)
    if buf is None or buf.numel() < nbytes:
        with torch.inference_mode(False):
            buf = _scratch_bufs[key] = torch.empty(nbytes, dtype=torch.uint8,
                                                   device=x.device)
    return buf.data_ptr()


class GemmTcPlan(NamedTuple):
    bm: int       # a tile's rows: 256, 128 or 64 (4, 2 or 1 warpgroups)
    splits: int   # K-slices of the partial epilogue, whole TILE_K steps
    blocks: int   # tiles (the persistent kernel runs min(tiles, the SMs'
    #               blocks) blocks over them)


# gemm_tc.cu's blocks an SM by tile height, and the relative rate of one
# SM's tensor work at that height (85, 64 and 43 FLOP a byte staged; from
# ``python -m lavender_tpu_torch.gemm_tc_sweep`` on an H100)
_TC_BLOCKS = {256: 1, 128: 2, 64: 2}
_TC_RATE = {256: 1.0, 128: 0.8, 64: 0.6}


@functools.lru_cache(maxsize=512)
def gemm_tc_plan(M: int, N: int, K: int, G: int = 1, split: bool = False,
                 residual: bool = False,
                 sms: int = H100_SMS) -> GemmTcPlan:
    """The launch plan of ``gemm_tc`` (G weights) or, with ``split``,
    ``gemm_tc_ln``, for a [M, K] x [N, K]^T product on the card; tiles
    are bm x 128.  Without ``split``, the tile height with the least
    waves x rows a wave / rate (``_TC_BLOCKS`` blocks an SM at ``_TC_RATE``,
    the taller on a tie), at most 128 rows with the ``residual`` epilogue
    (two blocks an SM hide its loads).  With ``split``, the fewest f32
    K-slices (each costs 8 bytes an output, written and read) that keep
    half the ``sms`` busy, 128-row tiles before 64-row ones; ``splits``
    divides K's TILE_K steps.  Pure arithmetic."""
    steps = -(-K // TILE_K)
    cols = -(-N // 128) * G
    if split:
        fits = [s for s in range(1, 9) if steps % s == 0]
        for s in fits:
            for bm in (128, 64):
                tiles = -(-M // bm) * cols * s
                if 2 * tiles >= sms:
                    return GemmTcPlan(bm, s, tiles)
        return GemmTcPlan(64, fits[-1], -(-M // 64) * cols * fits[-1])

    def cost(bm):
        slots = sms * _TC_BLOCKS[bm]
        waves = -(-(-(-M // bm) * cols) // slots)
        return waves * bm * _TC_BLOCKS[bm] / _TC_RATE[bm]

    bm = min((128, 64) if residual else (256, 128, 64), key=cost)
    return GemmTcPlan(bm, 1, -(-M // bm) * cols)


def _tc_operand(t: torch.Tensor, shape, dev, what: str):
    """Check of a contiguous bf16 operand of the tile GEMM (one pass of
    cheap attribute reads: it runs on every launch)."""
    if not (t.dtype == torch.bfloat16 and t.device == dev
            and t.shape == shape and t.is_contiguous()
            and t.data_ptr() % 16 == 0):
        raise ValueError(f"{what}: expected a contiguous, 16-byte aligned "
                         f"bf16 {tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def tile_rows_ok(shape, strides, ptr: int, M: int, N: int) -> bool:
    """Whether a bf16 tensor of this shape, element strides and address is
    an [M, N] the tile GEMM reads or writes in place: its rows contiguous,
    their pitch a multiple of 8 elements (a tensor map's row stride is
    whole 16 bytes) and at least N, the first element 16-byte aligned; a
    column slice of a wider slab passes (K4's q | k | v)."""
    return (tuple(shape) == (M, N) and strides[1] == 1
            and strides[0] % 8 == 0 and strides[0] >= N and ptr % 16 == 0)


def _tc_rows(t: torch.Tensor, M: int, N: int, what: str):
    """Check of a bf16 [M, N] on the card whose rows the tile GEMM takes
    in place (``tile_rows_ok``)."""
    if not (t.is_cuda and t.dtype == torch.bfloat16 and t.dim() == 2
            and tile_rows_ok(t.shape, t.stride(), t.data_ptr(), M, N)):
        raise ValueError(f"{what}: expected a bf16 CUDA tensor [{M}, {N}], "
                         f"rows contiguous, their pitch a multiple of 8 and "
                         f">= {N}, 16-byte aligned; got {t.dtype} "
                         f"{tuple(t.shape)} strides {t.stride()} on "
                         f"{t.device}")


def gemm_tc(a: torch.Tensor, w, bias=None, *, gelu: bool = False,
            residual: Optional[torch.Tensor] = None,
            out: Optional[torch.Tensor] = None,
            rows: Optional[torch.Tensor] = None,
            pad_zero: bool = False) -> torch.Tensor:
    """``out = epi(a @ w.T + bias)`` on the wgmma + TMA tiles
    (``csrc/gemm_tc.cu``), epi the exact GELU or ``+ residual``, in ONE
    launch: ``w`` one weight [N, K] (torch Linear layout) or a tuple of up
    to 3, ``bias`` then one [N] (or None) or a tuple of as many (entries
    may be None), weight g's product landing in columns g*N.. of ``out``
    [M, G*N] (K4's q | k | v in one packed slab; ``out`` may be a column
    slice of a wider tensor, its row stride passed through).  a [M, K] and
    ``residual`` [M, N] with their rows contiguous and 16-byte aligned,
    the weights contiguous; N and K multiples of 8.  ``gemm_tc_plan``
    picks the tile's rows.  ``rows`` (int32 [M], one weight, with
    ``residual`` and ``out``, both [R, N]): the scatter epilogue, row m of
    the product + ``residual[rows[m]]`` into ``out[rows[m]]``, dropped
    where rows[m] < 0 (K14's proj), or with ``pad_zero`` (out [M, N])
    a zero row into ``out[m]`` there (K16's proj, whose pad rows are the
    rows that no index names)."""
    ws = tuple(w) if isinstance(w, (tuple, list)) else (w,)
    bs = tuple(bias) if isinstance(bias, (tuple, list)) else (bias,)
    G = len(ws)
    M, K = a.shape
    N = ws[0].shape[0]
    if not 1 <= G <= 3 or len(bs) != G or N % 8 or K % 8:
        raise ValueError(f"gemm_tc: unsupported {G} weights / {len(bs)} "
                         f"biases, N={N}, K={K} (1..3 weights, one bias "
                         f"each, N and K multiples of 8)")
    if gelu and residual is not None:
        raise ValueError("gemm_tc: GELU and residual epilogues are exclusive")
    _tc_rows(a, M, K, "gemm_tc a")
    dev = a.device
    for i, (wi, bi) in enumerate(zip(ws, bs)):
        _tc_operand(wi, (N, K), dev, f"gemm_tc w[{i}]")
        if bi is not None:
            _tc_operand(bi, (N,), dev, f"gemm_tc bias[{i}]")
    if rows is not None:
        if G != 1 or residual is None or out is None or gelu:
            raise ValueError("gemm_tc rows: one weight, a residual and an "
                             "out, no GELU")
        R = residual.shape[0]
        if pad_zero and R != M:
            raise ValueError(f"gemm_tc pad_zero: out has {R} rows, the "
                             f"product {M}")
        _tc_rows(residual, R, N, "gemm_tc residual")
        _tc_rows(out, R, N, "gemm_tc out")
        err = library().lvt_gemm_tc_scatter_bf16(
            a.data_ptr(), a.stride(0), ws[0].data_ptr(), _ptr(bs[0]),
            residual.data_ptr(), residual.stride(0),
            _rows(rows, M, dev, "gemm_tc"), out.data_ptr(), out.stride(0),
            M, N, K, gemm_tc_plan(M, N, K, residual=True).bm, int(pad_zero),
            _stream(a))
        _raise_on(err, "lvt_gemm_tc_scatter_bf16")
        return out
    if pad_zero:
        raise ValueError("gemm_tc pad_zero: only with rows")
    if out is None:
        out = torch.empty(M, G * N, dtype=a.dtype, device=dev)
    _tc_rows(out, M, G * N, "gemm_tc out")
    epi, r_ptr, ldr = (_TC_GELU if gelu else _TC_BIAS), None, 0
    if residual is not None:
        _tc_rows(residual, M, N, "gemm_tc residual")
        epi, r_ptr, ldr = _TC_RESIDUAL, residual.data_ptr(), residual.stride(0)
    bm = gemm_tc_plan(M, N, K, G, False, residual is not None).bm
    wp = [t.data_ptr() for t in ws] + [None] * (3 - G)
    bp = [_ptr(t) for t in bs] + [None] * (3 - G)
    err = library().lvt_gemm_tc_bf16(
        a.data_ptr(), a.stride(0), *wp, *bp, G, r_ptr, ldr, out.data_ptr(),
        out.stride(0), M, N, K, epi, bm, 1, _stream(a))
    _raise_on(err, "lvt_gemm_tc_bf16")
    return out


def _gemm_tc_ln_args(a, w, bias, residual, ln_w, ln_b, what):
    """Checks of ``gemm_tc_ln`` and ``gemm_tc_dropout_ln``; returns (M, C,
    K, the split plan, the stream, the address of the f32 slices)."""
    M, K = a.shape
    C = w.shape[0]
    if C % 8 or K % 8 or C > MAX_ROW_C:
        raise ValueError(f"{what}: unsupported C={C}, K={K} (multiples of "
                         f"8, C <= {MAX_ROW_C})")
    _tc_rows(a, M, K, f"{what} a")
    dev = a.device
    _tc_operand(w, (C, K), dev, f"{what} w")
    _tc_operand(residual, (M, C), dev, f"{what} residual")
    for t, name in ((bias, "bias"), (ln_w, "ln_w"), (ln_b, "ln_b")):
        _tc_operand(t, (C,), dev, f"{what} {name}")
    plan = gemm_tc_plan(M, C, K, split=True)
    stream = _stream(a)
    return M, C, K, plan, stream, _scratch(a, stream,
                                           plan.splits * M * C * 4)


def gemm_tc_ln(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               residual: torch.Tensor, ln_w: torch.Tensor,
               ln_b: torch.Tensor, eps: float) -> torch.Tensor:
    """``LN(residual + a @ w.T + bias)`` (K4's proj + residual + LN): the
    product as f32 K-slices (the tile GEMM's partial epilogue, the slices
    of ``gemm_tc_plan(..., split=True)``) into scratch, then gemm_tc.cu's
    row kernel sums them in slice order, adds bias and residual and applies
    the LN in f32.  a [M, K] (rows contiguous), w [C, K], residual [M, C]
    contiguous, bias, ln_w, ln_b [C]; C % 8 == 0, C <= MAX_ROW_C.  Two
    launches, one C call."""
    M, C, K, plan, stream, part = _gemm_tc_ln_args(
        a, w, bias, residual, ln_w, ln_b, "gemm_tc_ln")
    out = torch.empty(M, C, dtype=a.dtype, device=a.device)
    err = library().lvt_gemm_tc_ln_bf16(
        a.data_ptr(), a.stride(0), w.data_ptr(), bias.data_ptr(),
        residual.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), part,
        out.data_ptr(), M, C, K, plan.bm, plan.splits, float(eps), stream)
    _raise_on(err, "lvt_gemm_tc_ln_bf16")
    return out


def gemm_tc_dropout_ln(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       residual: torch.Tensor, ln_w: torch.Tensor,
                       ln_b: torch.Tensor, eps: float,
                       seed: Optional[torch.Tensor], rate: float):
    """``(LN(residual + dropout(a @ w.T + bias)), keep)`` (K11): the
    product as ``gemm_tc_ln``'s f32 K-slices, then the row kernel's
    dropout mode sums them in slice order with the bias, drops element
    (row, col) by the counter hash of ``seed`` (``dropout.row_keep``'s
    bits), scales the kept ones by 1 / (1 - rate), adds the residual and
    applies the LN, all in f32; the bool keep
    mask [M, C] is returned (all True at rate 0).  Shapes as
    ``gemm_tc_ln``'s.  Two launches, one C call."""
    M, C, K, plan, stream, part = _gemm_tc_ln_args(
        a, w, bias, residual, ln_w, ln_b, "gemm_tc_dropout_ln")
    seed_ptr, thresh, scale = _dropout_args(seed, rate, a.device)
    out = torch.empty(M, C, dtype=a.dtype, device=a.device)
    keep = torch.empty(M, C, dtype=torch.bool, device=a.device)
    err = library().lvt_gemm_tc_dropout_ln_bf16(
        a.data_ptr(), a.stride(0), w.data_ptr(), bias.data_ptr(),
        residual.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), part,
        out.data_ptr(), keep.data_ptr(), M, C, K, plan.bm, plan.splits,
        float(eps), seed_ptr, thresh, scale, stream)
    _raise_on(err, "lvt_gemm_tc_dropout_ln_bf16")
    return out, keep


@functools.lru_cache(maxsize=256)
def _swin_block_plan(M: int, C: int, HD: int):
    """K1's four tile heights (qkv, proj, fc1, fc2) as the C entry takes
    them, and its scratch bytes."""
    bm = (gemm_tc_plan(M, 3 * C, C).bm,
          gemm_tc_plan(M, C, C, residual=True).bm,
          gemm_tc_plan(M, HD, C).bm if HD else 0,
          gemm_tc_plan(M, C, HD, residual=True).bm if HD else 0)
    return (ctypes.c_int * 4)(*bm), library().lvt_swin_block_wm_scratch(
        M, C, HD)


class LnMlpPlan(NamedTuple):
    fc1_bm: int   # fc1's tile rows
    fc2_bm: int   # fc2's tile rows
    splits: int   # fc2's f32 K-slices (1: one launch, bias / residual
    #               epilogue; more: summed in order by the row kernel)
    scratch: int  # bytes: LN(x) and the hidden layer in bf16, the slices


def _round256(n: int) -> int:
    return -(-n // 256) * 256


@functools.lru_cache(maxsize=256)
def ln_mlp_plan(M: int, C: int, HD: int, residual: bool,
                sms: int = H100_SMS) -> LnMlpPlan:
    """The launch plan of ``ln_mlp`` for x [M, C], w1 [HD, C]: fc1's tile
    rows from ``gemm_tc_plan``, fc2's from it too (at most 128 with the
    residual epilogue), unless that leaves fc2 on 64-row tiles and 128-row
    ones would not give half the SMs a tile: then fc2 runs as the fewest
    f32 K-slices at 128 rows that give every SM a tile (each slice whole
    TILE_K steps).  ``gemm_tc_sweep`` measured the slices 9% faster at
    Swin-B's B=4 stage 4 (M = 992) on an H100 SXM at 700 W, and no
    faster, or slower, at 1984 and 3968 rows.  ``scratch`` mirrors ``lvt_ln_mlp_scratch``
    (``csrc/blocks.cu``).  Pure arithmetic."""
    fc1 = gemm_tc_plan(M, HD, C, sms=sms).bm
    bm2, splits = gemm_tc_plan(M, C, HD, residual=residual, sms=sms).bm, 1
    tiles = -(-M // 128) * -(-C // 128)
    if bm2 == 64 and 2 * tiles < sms:
        steps = -(-HD // TILE_K)
        fits = [s for s in range(2, 9) if steps % s == 0]
        more = [s for s in fits if tiles * s >= sms]
        if more:
            bm2, splits = 128, more[0]
    scratch = _round256(M * C * 2) + _round256(M * HD * 2) + (
        _round256(splits * M * C * 4) if splits > 1 else 0)
    return LnMlpPlan(fc1, bm2, splits, scratch)


def ln_mlp(x: torch.Tensor, ln_w, ln_b, w1: torch.Tensor, b1,
           w2: torch.Tensor, b2, eps: float, residual: bool,
           plan: Optional[LnMlpPlan] = None) -> torch.Tensor:
    """K3's and K9's LN + MLP in one call (``csrc/blocks.cu``): x [M, C]
    -> fc2(GELU(fc1(LN(x)))) (+ x with ``residual``), w1 [HD, C], w2 [C,
    HD] (torch Linear layout): the row LN on 16-byte chunks, fc1 + bias
    + GELU and fc2 + bias (+ residual) on the wgmma + TMA tiles, fc2
    possibly as f32 K-slices that the row kernel sums in order with bias
    and residual; ``plan`` (default ``ln_mlp_plan``) the tile rows and
    slices.  LN affines None: the pure normalize; biases may be None.
    All bf16, contiguous, on one card; C <= MAX_ROW_C, C and HD multiples
    of 8.  The checks are one pass of cheap attribute reads: they run on
    every launch."""
    _check(x, "ln_mlp x")
    M, C = x.shape
    HD = w1.shape[0]
    dev = x.device
    if not x.is_contiguous() or C % 8 or C > MAX_ROW_C or HD % 8:
        raise ValueError(f"ln_mlp: unsupported x {tuple(x.shape)} "
                         f"(contiguous), MLP width {HD} (C and HD "
                         f"multiples of 8, C <= {MAX_ROW_C})")
    _tc_operand(w1, (HD, C), dev, "ln_mlp w1")
    _tc_operand(w2, (C, HD), dev, "ln_mlp w2")
    for t, n, what in ((ln_w, C, "ln_w"), (ln_b, C, "ln_b"), (b1, HD, "b1"),
                       (b2, C, "b2")):
        if t is not None:
            _tc_operand(t, (n,), dev, f"ln_mlp {what}")
    if (ln_w is None) != (ln_b is None):
        raise ValueError("ln_mlp: LN weight and bias are both given or both "
                         "None")
    if plan is None:
        plan = ln_mlp_plan(M, C, HD, residual)
    stream = _stream(x)
    ws = _scratch(x, stream, plan.scratch)
    out = torch.empty_like(x)
    err = library().lvt_ln_mlp_bf16(
        x.data_ptr(), _ptr(ln_w), _ptr(ln_b), w1.data_ptr(), _ptr(b1),
        w2.data_ptr(), _ptr(b2), ws, plan.scratch, out.data_ptr(), M, C, HD,
        float(eps), int(residual), plan.fc1_bm, plan.fc2_bm, plan.splits,
        stream)
    _raise_on(err, "lvt_ln_mlp_bf16")
    return out


def _swin_block_args(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, n_seq, n_tok,
                     n_heads, mlp, what):
    """Checks of a Swin block's C call (K1, K14): x [n_seq * n_tok, C]
    contiguous bf16 on the card, C <= MAX_ROW_C and a multiple of 8, head
    dim 16, 32 or 64, the weights contiguous and 16-byte aligned, each LN
    affine both or neither.  Returns (M, C, HD, mlp), HD 0 and mlp six Nones
    without the MLP."""
    _check(x, f"{what} x")
    M, C = x.shape
    hd = C // n_heads
    dev = x.device
    if (not x.is_contiguous() or M != n_seq * n_tok or C % 8
            or C > MAX_ROW_C or hd * n_heads != C or hd not in (16, 32, 64)):
        raise ValueError(f"{what}: unsupported x {tuple(x.shape)} for "
                         f"{n_seq} x {n_tok} rows, {n_heads} heads (C % 8 "
                         f"== 0, C <= {MAX_ROW_C}, head dim 16/32/64)")
    n2w = n2b = w1 = b1 = w2 = b2 = None
    HD = 0
    if mlp is not None:
        n2w, n2b, w1, b1, w2, b2 = mlp
        HD = w1.shape[0]
        if HD % 8:
            raise ValueError(f"{what}: MLP width {HD} not a multiple of 8")
        _tc_operand(w1, (HD, C), dev, f"{what} w1")
        _tc_operand(w2, (C, HD), dev, f"{what} w2")
        for t, n, name in ((b1, HD, "b1"), (b2, C, "b2"), (n2w, C, "ln2_w"),
                           (n2b, C, "ln2_b")):
            if t is not None:
                _tc_operand(t, (n,), dev, f"{what} {name}")
        if (n2w is None) != (n2b is None):
            raise ValueError(f"{what}: ln2 weight and bias are both given "
                             "or both None")
    if (ln_w is None) != (ln_b is None):
        raise ValueError(f"{what}: ln1 weight and bias are both given or "
                         "both None")
    for t, shape, name in ((wqkv, (3 * C, C), "wqkv"),
                           (wproj, (C, C), "wproj"), (bqkv, (3 * C,), "bqkv"),
                           (bproj, (C,), "bproj"), (ln_w, (C,), "ln_w"),
                           (ln_b, (C,), "ln_b")):
        if t is not None:
            _tc_operand(t, shape, dev, f"{what} {name}")
    return M, C, HD, (n2w, n2b, w1, b1, w2, b2)


def swin_block_wm(x: torch.Tensor, ln_w, ln_b, wqkv: torch.Tensor, bqkv,
                  wproj: torch.Tensor, bproj, bias: torch.Tensor,
                  mask: Optional[torch.Tensor], n_seq: int, n_tok: int,
                  n_heads: int, scale: float, eps: float,
                  mlp=None) -> torch.Tensor:
    """K1's whole block in one call (``csrc/blocks.cu``): x [n_seq *
    n_tok, C] window-major rows, out = x + proj(attn(LN1(x))) (then +
    fc2(GELU(fc1(LN2(.))))) with ``mlp`` = (ln2_w, ln2_b, w1 [HD, C], b1,
    w2 [C, HD], b2)): LN1, the qkv product, the window core on the tensor
    cores (bias [nH, N, N], mask [nW, N, N] or None), proj + residual, and
    the MLP, each the primitive ``layernorm`` / ``gemm_tc`` /
    ``attention(tensor_cores=True)`` launches, from one C call.  LN
    affines None: the pure normalize.  All bf16, contiguous, on one card;
    C <= MAX_ROW_C and a multiple of 8, head dim 16, 32 or 64."""
    M, C, HD, mlp = _swin_block_args(x, ln_w, ln_b, wqkv, bqkv, wproj,
                                     bproj, n_seq, n_tok, n_heads, mlp,
                                     "swin_block_wm")
    n2w, n2b, w1, b1, w2, b2 = mlp
    dev = x.device
    _tc_operand(bias, (n_heads, n_tok, n_tok), dev, "swin_block_wm bias")
    n_win = 1
    if mask is not None:
        n_win = mask.shape[0]
        _tc_operand(mask, (n_win, n_tok, n_tok), dev, "swin_block_wm mask")
        if n_seq % n_win:
            raise ValueError("swin_block_wm: n_seq must be a multiple of nW")
    bm, nbytes = _swin_block_plan(M, C, HD)
    stream = _stream(x)
    ws = _scratch(x, stream, nbytes)
    out = torch.empty_like(x)
    err = library().lvt_swin_block_wm_bf16(
        x.data_ptr(), _ptr(ln_w), _ptr(ln_b), wqkv.data_ptr(), _ptr(bqkv),
        wproj.data_ptr(), _ptr(bproj), bias.data_ptr(), _ptr(mask),
        _ptr(n2w), _ptr(n2b), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), ws,
        out.data_ptr(), n_seq, n_tok, C, n_heads, HD, n_win, float(scale),
        float(eps), bm, stream)
    _raise_on(err, "lvt_swin_block_wm_bf16")
    return out


class SpatialPlan(NamedTuple):
    qkv_bm: int   # the qkv product's tile rows
    proj_bm: int  # the proj's (its scatter epilogue: at most 128)
    fc1_bm: int   # the MLP's, as ``ln_mlp_plan`` with the residual (0:
    fc2_bm: int   # no MLP)
    splits: int   # fc2's f32 K-slices
    scratch: int  # bytes, as lvt_swin_block_spatial_scratch lays them out


@functools.lru_cache(maxsize=256)
def swin_spatial_plan(M: int, C: int, HD: int,
                      sms: int = H100_SMS) -> SpatialPlan:
    """K14's launch plan for M spatial rows of width C (HD the MLP's width,
    0 for the attention half; K16's with HD 0 for its M = B * nW * Npad
    window-major rows): the qkv and proj tiles from
    ``gemm_tc_plan`` (the proj under its residual rule), the MLP's from
    ``ln_mlp_plan(M, C, HD, residual=True)``, and the scratch: LN1's output,
    the qkv slab and the core's output (5 bf16 [M, C] pieces, each rounded
    up to 256 bytes), with the MLP also ``ln_mlp_plan``'s (the block's
    output before the MLP, the hidden layer, the slices).  Pure
    arithmetic."""
    qkv = gemm_tc_plan(M, 3 * C, C, sms=sms).bm
    proj = gemm_tc_plan(M, C, C, residual=True, sms=sms).bm
    scratch = 5 * _round256(M * C * 2)
    if not HD:
        return SpatialPlan(qkv, proj, 0, 0, 1, scratch)
    mlp = ln_mlp_plan(M, C, HD, True, sms)
    return SpatialPlan(qkv, proj, mlp.fc1_bm, mlp.fc2_bm, mlp.splits,
                       scratch + mlp.scratch)


def swin_block_spatial(x: torch.Tensor, rows: torch.Tensor, ln_w, ln_b,
                       wqkv: torch.Tensor, bqkv, wproj: torch.Tensor, bproj,
                       bias: torch.Tensor, mask: Optional[torch.Tensor],
                       n_seq: int, n_tok: int, n_heads: int, scale: float,
                       eps: float, mlp=None,
                       pad_zero: bool = False) -> torch.Tensor:
    """K14's whole block in one call (``csrc/blocks.cu``): x [n_seq *
    n_tok, C] in spatial row order, ``rows`` (int32 [M], a permutation)
    the spatial row of each window row; out = x + proj(attn(LN1(x[rows])))
    scattered back by ``rows`` (then + fc2(GELU(fc1(LN2(.)))) on the
    spatial rows with ``mlp`` = (ln2_w, ln2_b, w1 [HD, C], b1, w2 [C, HD],
    b2)): the 16-byte-chunk LN gathering its rows, the qkv product, the
    window core on the tensor cores (bias [nH, N, N] bf16, mask [nW, N, N]
    bf16 or f32 or None, each with its rows contiguous: contiguous, or a
    view of ``padded_rows``), the proj's scatter epilogue with the
    residual, and K3's MLP path.  LN affines None: the pure normalize.
    ``pad_zero`` (K16, no ``mlp``): x the unshifted window-major slab,
    ``rows`` the wm shift's index with -1 at the pad rows (LN1 gathers a
    zero row there), and out[m] = 0 where rows[m] < 0 (the proj's zeroing
    scatter; those must be the rows no index names).  Plan:
    ``swin_spatial_plan``.  Checks run on every launch and raise."""
    M, C, HD, mlp = _swin_block_args(x, ln_w, ln_b, wqkv, bqkv, wproj,
                                     bproj, n_seq, n_tok, n_heads, mlp,
                                     "swin_block_spatial")
    n2w, n2b, w1, b1, w2, b2 = mlp
    if pad_zero and w1 is not None:
        raise ValueError("swin_block_spatial: pad_zero takes no MLP")
    dev = x.device
    bias_ld = _row_pitch(bias, n_heads, n_tok, (torch.bfloat16,), dev,
                         "swin_block_spatial bias")
    n_win, mask_ld = 1, 0
    if mask is not None:
        mask_ld = _row_pitch(mask, None, n_tok,
                             (torch.bfloat16, torch.float32), dev,
                             "swin_block_spatial mask")
        n_win = mask.shape[0]
        if n_seq % n_win:
            raise ValueError(f"swin_block_spatial: {n_seq} windows are not "
                             f"a multiple of the mask's {n_win}")
    rows_ptr = _rows(rows, M, dev, "swin_block_spatial")
    plan = swin_spatial_plan(M, C, HD)
    stream = _stream(x)
    ws = _scratch(x, stream, plan.scratch)
    out = torch.empty_like(x)
    err = library().lvt_swin_block_spatial_bf16(
        x.data_ptr(), rows_ptr, _ptr(ln_w), _ptr(ln_b), wqkv.data_ptr(),
        _ptr(bqkv), wproj.data_ptr(), _ptr(bproj), bias.data_ptr(), bias_ld,
        _ptr(mask), mask_ld,
        int(mask is not None and mask.dtype == torch.float32), _ptr(n2w),
        _ptr(n2b), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), ws, plan.scratch,
        out.data_ptr(), n_seq, n_tok, C, n_heads, HD, n_win, float(scale),
        float(eps), plan.qkv_bm, plan.proj_bm, plan.fc1_bm, plan.fc2_bm,
        plan.splits, int(pad_zero), stream)
    _raise_on(err, "lvt_swin_block_spatial_bf16")
    return out


@functools.lru_cache(maxsize=256)
def _bert_block_plan(M: int, C: int):
    """K4's tile heights (q | k | v, proj), the proj's K-slices, and the
    scratch bytes."""
    proj = gemm_tc_plan(M, C, C, split=True)
    return (gemm_tc_plan(M, C, C, 3).bm, proj.bm, proj.splits,
            library().lvt_bert_attn_block_scratch(M, C, proj.splits))


def bert_attn_block(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                    wv: torch.Tensor, bq, bk, bv, wproj: torch.Tensor,
                    bproj: torch.Tensor, ln_w: torch.Tensor,
                    ln_b: torch.Tensor, keep: Optional[torch.Tensor], B: int,
                    L: int, n_heads: int, scale: float, eps: float,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4's and K6's whole sub-block in one call (``csrc/blocks.cu``): x
    [B * L, C] -> LN(x + proj(attention(q, k, v))) under the key-keep
    vector keep [B, L] (bool or uint8; 0 drops the key; K4) or, with keep
    None, the additive bf16 ``mask`` [B, L, L] (K6: clamped by the caller,
    its rows contiguous, one pitch, 16-byte aligned, e.g. ``padded_rows``;
    no key is skipped): q | k | v in one ``gemm_tc`` launch, the core on
    the tensor cores, proj + residual + LN as ``gemm_tc_ln``, from one C
    call.  All bf16 but keep, contiguous, on one card; C <= 1024 and a
    multiple of 8, head dim 16, 32 or 64."""
    _check(x, "bert_attn_block x")
    M, C = x.shape
    hd = C // n_heads
    dev = x.device
    if (not x.is_contiguous() or M != B * L or C % 8 or C > 1024
            or hd * n_heads != C or hd not in (16, 32, 64)):
        raise ValueError(f"bert_attn_block: unsupported x {tuple(x.shape)} "
                         f"for {B} x {L} rows, {n_heads} heads (C % 8 == 0, "
                         f"C <= 1024, head dim 16/32/64)")
    for t, shape, what in ((wq, (C, C), "wq"), (wk, (C, C), "wk"),
                           (wv, (C, C), "wv"), (wproj, (C, C), "wproj"),
                           (bproj, (C,), "bproj"), (ln_w, (C,), "ln_w"),
                           (ln_b, (C,), "ln_b")):
        _tc_operand(t, shape, dev, f"bert_attn_block {what}")
    for t, what in ((bq, "bq"), (bk, "bk"), (bv, "bv")):
        if t is not None:
            _tc_operand(t, (C,), dev, f"bert_attn_block {what}")
    if (keep is None) == (mask is None):
        raise ValueError("bert_attn_block: takes a keep vector or a mask, "
                         "exactly one")
    if mask is not None:
        mask_ld = _row_pitch(mask, B, L, (torch.bfloat16,), dev,
                             "bert_attn_block mask")
    else:
        if keep.device != dev or tuple(keep.shape) != (B, L):
            raise ValueError(f"bert_attn_block keep: expected [{B}, {L}] on "
                             f"{dev}, got {tuple(keep.shape)} on "
                             f"{keep.device}")
        if keep.dtype == torch.bool and keep.is_contiguous():
            keep = keep.view(torch.uint8)  # its bytes, read in place
        else:
            keep = keep.to(torch.uint8).contiguous()
        if keep.data_ptr() % 4:
            keep = keep.clone()
    bm_qkv, bm_proj, splits, nbytes = _bert_block_plan(M, C)
    stream = _stream(x)
    ws = _scratch(x, stream, nbytes)
    out = torch.empty_like(x)
    common = (x.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
              _ptr(bq), _ptr(bk), _ptr(bv), wproj.data_ptr(),
              bproj.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr())
    shape = (B, L, C, n_heads, float(scale), float(eps), bm_qkv, bm_proj,
             splits, stream)
    if mask is not None:
        err = library().lvt_bert_attn_block_mask_bf16(
            *common, mask.data_ptr(), mask_ld, ws, out.data_ptr(), *shape)
        _raise_on(err, "lvt_bert_attn_block_mask_bf16")
    else:
        err = library().lvt_bert_attn_block_bf16(
            *common, keep.data_ptr(), ws, out.data_ptr(), *shape)
        _raise_on(err, "lvt_bert_attn_block_bf16")
    return out


def ffn_post_ln(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor, ln_w: torch.Tensor,
                ln_b: torch.Tensor, eps: float, short: bool,
                splits: int) -> torch.Tensor:
    """``LN(x + fc2(GELU(fc1 x)))`` (``csrc/ffn_post_ln.cu``): x [M, C],
    w1 [HD, C], b1 [HD], w2 [C, HD], b2, ln_w, ln_b [C], all bf16,
    contiguous and on one card, C <= 1024.
    ``short`` (M <= 64) and ``splits`` (fc2's K-slices) are the plan of
    ``fused_mlp.ffn_plan``.  The checks run on every launch: x's device
    check, then one pass of cheap attribute reads over the weights."""
    _check(x, "ffn_post_ln x")
    lib = library()
    M, C = x.shape
    HD = w1.shape[0]
    dev = x.device
    if not x.is_contiguous():
        raise ValueError("ffn_post_ln x: must be contiguous")
    for t, shape, what in ((w1, (HD, C), "w1"), (b1, (HD,), "b1"),
                           (w2, (C, HD), "w2"), (b2, (C,), "b2"),
                           (ln_w, (C,), "ln_w"), (ln_b, (C,), "ln_b")):
        if not (t.dtype == torch.bfloat16 and t.device == dev
                and t.shape == shape and t.is_contiguous()
                and t.data_ptr() % 16 == 0):
            raise ValueError(
                f"ffn_post_ln {what}: expected a contiguous, 16-byte aligned "
                f"bf16 {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    unit = 32 if short else TILE_K  # K-steps: a chunk, a tile's depth
    if C % unit or C > 1024 or HD % (unit * splits) or (short and M > 64):
        raise ValueError(f"ffn_post_ln: unsupported M={M}, C={C}, HD={HD}, "
                         f"{splits} K-slices (C and HD / slices multiples "
                         f"of {unit}, C <= 1024, M <= 64 when short)")
    stream = _stream(x)
    h_bytes = -(-M * HD * 2 // 16) * 16
    ws = _scratch(x, stream, h_bytes + splits * M * C * 4)
    out = torch.empty_like(x)
    err = lib.lvt_ffn_post_ln_bf16(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), ws, ws + h_bytes,
        out.data_ptr(), M, C, HD, splits, int(short), float(eps), stream)
    _raise_on(err, "lvt_ffn_post_ln_bf16")
    return out


def ffn_dropout_ln(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, ln_w: torch.Tensor,
                   ln_b: torch.Tensor, eps: float,
                   seed: Optional[torch.Tensor], rate: float,
                   splits: int):
    """K12 in one call (``csrc/ffn_post_ln.cu``): ``(LN(x + dropout(
    fc2(GELU(fc1 x + b1)) + b2)), keep)`` for x [M, C], w1 [HD, C], w2 [C,
    HD] (torch Linear layout): K5's long-M products on the tile GEMM (fc1
    on ``gemm_tc_plan``'s tile, fc2 as ``splits`` f32 K-slices of 128-row
    tiles, ``fused_mlp.ffn_plan``'s), then the row kernel's dropout mode
    (K11's): element (row, col) dropped by the counter hash of ``seed``
    (``dropout.row_keep``), the bool keep mask [M, C] returned (all True at
    rate 0).  All bf16 but seed, contiguous, on one card; C and HD /
    splits multiples of 64, C <= 1024.  The checks run on every launch."""
    _check(x, "ffn_dropout_ln x")
    M, C = x.shape
    HD = w1.shape[0]
    dev = x.device
    if (not x.is_contiguous() or C % TILE_K or C > 1024
            or HD % (TILE_K * splits)):
        raise ValueError(f"ffn_dropout_ln: unsupported x {tuple(x.shape)} "
                         f"(contiguous), HD={HD}, {splits} K-slices (C and "
                         f"HD / slices multiples of {TILE_K}, C <= 1024)")
    for t, shape, what in ((w1, (HD, C), "w1"), (b1, (HD,), "b1"),
                           (w2, (C, HD), "w2"), (b2, (C,), "b2"),
                           (ln_w, (C,), "ln_w"), (ln_b, (C,), "ln_b")):
        _tc_operand(t, shape, dev, f"ffn_dropout_ln {what}")
    seed_ptr, thresh, scale = _dropout_args(seed, rate, dev)
    stream = _stream(x)
    h_bytes = _round256(M * HD * 2)
    ws = _scratch(x, stream, h_bytes + splits * M * C * 4)
    out = torch.empty_like(x)
    keep = torch.empty(M, C, dtype=torch.bool, device=dev)
    err = library().lvt_ffn_dropout_ln_bf16(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), ws, ws + h_bytes,
        out.data_ptr(), keep.data_ptr(), M, C, HD,
        gemm_tc_plan(M, HD, C).bm, splits, float(eps), seed_ptr, thresh,
        scale, stream)
    _raise_on(err, "lvt_ffn_dropout_ln_bf16")
    return out, keep


def permute_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """out[b, r] = x[b, index[r]], or zeros where index[r] < 0, over the R
    rows of each batch: x [B, ..., C] contiguous (the dims between B and C
    flattened into R; any dtype whose row is a multiple of 16 bytes),
    index int32 [R] on x's device.  The checks are one pass of cheap
    attribute reads: they run on every launch."""
    if not (x.is_cuda and x.dim() >= 2 and x.is_contiguous()
            and x.data_ptr() % 16 == 0
            and x.shape[-1] * x.element_size() % 16 == 0):
        raise ValueError(f"permute_rows: expected a contiguous, 16-byte "
                         f"aligned CUDA tensor [B, ..., C] whose rows are "
                         f"multiples of 16 bytes, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    B, C = x.shape[0], x.shape[-1]
    R = x.numel() // (B * C) if B * C else 0
    if not (index.dtype == torch.int32 and index.device == x.device
            and index.shape == (R,) and index.is_contiguous()):
        raise ValueError(f"permute_rows: index must be a contiguous int32 "
                         f"[{R}] on {x.device}")
    out = torch.empty_like(x)
    err = library().lvt_permute_rows(
        x.data_ptr(), out.data_ptr(), index.data_ptr(), B, R,
        C * x.element_size(), _stream(x))
    _raise_on(err, "lvt_permute_rows")
    return out


class PatchEmbedPlan(NamedTuple):
    units: int   # (clip, frame, patch row, 64-patch chunk) work units
    blocks: int  # persistent blocks: the units, at most two an SM (one
    #              at E > 128, where a warp holds twice the weights)
    vec: int     # bytes a pixel copy: 16 where every segment is 16-byte
    #              aligned, else 4


@functools.lru_cache(maxsize=64)
def patch_embed_plan(B: int, D: int, H: int, W: int, E: int, aligned16: bool,
                     sms: int = H100_SMS) -> PatchEmbedPlan:
    """K17's launch plan (``csrc/patch_embed.cu``) for clips [B, D, H, W,
    3] and width E: a unit is one row of up to 64 patches of one frame,
    B * D * (H / 4) * ceil((W / 4) / 64) of them; the persistent grid the
    units or two blocks an SM at E <= 128 (one above); 16-byte pixel
    copies where the clip is 16-byte aligned (``aligned16``) and a pixel
    row's segments are too (W % 16 == 0), else 4-byte.  Pure
    arithmetic."""
    units = B * D * (H // 4) * -(-(W // 4) // 64)
    per_sm = 2 if E <= 128 else 1
    vec = 16 if aligned16 and W % 16 == 0 else 4
    return PatchEmbedPlan(units, min(units, per_sm * sms), vec)


def patch_embed_u8(x: torch.Tensor, w: torch.Tensor,
                   bias_t: torch.Tensor) -> torch.Tensor:
    """The uint8 patch embed, kernel (2, 4, 4), stride (1, 4, 4), temporal
    end pad: x uint8 [B, D, H, W, 3] (contiguous, H and W multiples of 4),
    w bf16 [96, E] the folded conv weights (rows in (kd, kh, kw, c) order),
    bias_t f32 [D, E] the per-time bias table.  Returns bf16
    [B, D, H / 4, W / 4, E].  Plan: ``patch_embed_plan``."""
    if (x.device.type != "cuda" or x.dtype != torch.uint8 or x.dim() != 5
            or not x.is_contiguous() or x.data_ptr() % 4 or x.shape[-1] != 3
            or x.shape[2] % 4 or x.shape[3] % 4):
        raise ValueError(f"patch_embed_u8: x must be a contiguous, 4-byte "
                         f"aligned CUDA uint8 [B, D, H, W, 3] with H, W "
                         f"multiples of 4, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    B, D, H, W, _ = x.shape
    _check(w, "patch_embed_u8 w")
    E = w.shape[1]
    if (w.shape[0] != 96 or E % 16 or E > 256 or not w.is_contiguous()
            or w.data_ptr() % 16):
        raise ValueError(f"patch_embed_u8 w: expected a contiguous, 16-byte "
                         f"aligned [96, E], E % 16 == 0, E <= 256, got "
                         f"{tuple(w.shape)}")
    if (bias_t.dtype != torch.float32 or bias_t.device != x.device
            or not bias_t.is_contiguous() or tuple(bias_t.shape) != (D, E)
            or bias_t.data_ptr() % 16):
        raise ValueError(f"patch_embed_u8 bias_t: expected a contiguous, "
                         f"16-byte aligned f32 [{D}, {E}] on {x.device}")
    plan = patch_embed_plan(B, D, H, W, E, x.data_ptr() % 16 == 0)
    out = torch.empty(B, D, H // 4, W // 4, E, dtype=torch.bfloat16,
                      device=x.device)
    err = library().lvt_patch_embed_u8(
        x.data_ptr(), w.data_ptr(), bias_t.data_ptr(), out.data_ptr(), B, D,
        H, W, E, plan.blocks, plan.vec, _stream(x))
    _raise_on(err, "lvt_patch_embed_u8")
    return out
