"""Build, bind and launch the port's hand-written CUDA kernels.

The sources under ``lavender_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a``, one process per source, all at once, and linked into ONE shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use (never at import), writes into ``build/`` at the repository
root, and is keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is loaded as is.

The primitives bound here (tiled GEMM with fused epilogues, optionally
scattering its rows, row LayerNorm, with or without its affine, optionally
gathering its rows, and its dropout + residual variant, attention core (on
the packed qkv slab, or on strided heads-layout q, k, v, with a per-head
bias and a per-window mask) and its backward, both with optional dropout,
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
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Optional

import torch

from lavender_tpu_torch.ops.dropout import threshold

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
# the heads-layout attention core's 12 element strides (host memory)
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# the dropout arguments of a kernel: seed pointer (null = no dropout), the
# keep threshold of the bits, the scale of the kept values
_DROP = [_P, _U, _F]
_SIGNATURES = {
    "lvt_gemm_bf16": [_P, _I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P,
                      _P],
    "lvt_layernorm_bf16": [_P, _P, _P, _P, _I, _I, _F, _P, _P],
    "lvt_dropout_add_ln_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _F, *_DROP,
                                _P],
    "lvt_attention_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                           *_DROP, _P],
    "lvt_attention_heads_bf16": [_P, _P, _P, _P, _STRIDES, _P, _I, _I, _I, _I,
                                 _F, _P],
    "lvt_window_attention_bf16": [_P, _P, _P, _P, _STRIDES, _P, _P, _I, _I, _I,
                                  _I, _I, _F, _P],
    "lvt_attention_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _F, *_DROP, _P],
    "lvt_permute_rows": [_P, _P, _P, _I, _I, _I, _P],
    "lvt_patch_embed_u8": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "lvt_dropout_bits": [_P, _P, _I, _I, _P],
}

_EPI_BIAS, _EPI_GELU, _EPI_RESIDUAL = 0, 1, 2

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
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _cast(v, dtype: torch.dtype):
    """``v`` with its floating tensors (also inside tuples) cast to dtype."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype) if v.is_floating_point() else v
    if isinstance(v, (tuple, list)):
        return type(v)(_cast(e, dtype) for e in v)
    return v


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
        if x.device.type == "cpu":
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
        torch.is_tensor(t) and t.requires_grad for t in args)


def select(op: KernelOp) -> Callable:
    """What a model calls for ``op``: the op, or its plain version inside
    ``plain_path()``."""
    return op.plain_as_launched if _plain_path else op


# --------------------------------------------------------------------------
# Launchers of the primitives (CUDA tensors only).
# --------------------------------------------------------------------------


def _check(t: torch.Tensor, what: str, ndim: int = 2):
    if t.device.type != "cuda":
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
    return torch.cuda.current_stream(t.device).cuda_stream


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


def gemm(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
         *, gelu: bool = False, residual: Optional[torch.Tensor] = None,
         out: Optional[torch.Tensor] = None,
         rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = epi(a @ w.T + bias)``: epi is exact GELU or ``+ residual``.

    a [M, K], w [N, K] (torch Linear layout); ``out`` may be a column slice
    of a wider tensor (its row stride is passed through).  ``rows`` (int32
    [M], distinct rows of ``out``) scatters: row m of the product goes to
    ``out[rows[m]]``, with ``residual[rows[m]]`` added, and is dropped where
    ``rows[m] < 0`` (those rows of ``out`` keep what they held)."""
    _check(a, "gemm a")
    _check(w, "gemm w")
    M, K = a.shape
    N = w.shape[0]
    if w.shape[1] != K or K % 32 != 0 or N % 8 != 0:
        raise ValueError(f"gemm: unsupported shapes a {tuple(a.shape)}, "
                         f"w {tuple(w.shape)} (need K % 32 == 0, N % 8 == 0)")
    if gelu and residual is not None:
        raise ValueError("gemm: GELU and residual epilogues are exclusive")
    if out is None:
        out = torch.empty(M, N, dtype=a.dtype, device=a.device)
    _check(out, "gemm out")
    if tuple(out.shape) != (M, N):
        raise ValueError(f"gemm out: expected {(M, N)}, got {tuple(out.shape)}")
    epi, r_ptr, ldr = _EPI_BIAS, None, 0
    if gelu:
        epi = _EPI_GELU
    if residual is not None:
        _check(residual, "gemm residual")
        if tuple(residual.shape) != (M, N):
            raise ValueError("gemm residual: shape mismatch")
        epi, r_ptr, ldr = _EPI_RESIDUAL, residual.data_ptr(), residual.stride(0)
    err = library().lvt_gemm_bf16(
        a.data_ptr(), a.stride(0), w.data_ptr(), w.stride(0),
        _vec(bias, N, "gemm bias"), r_ptr, ldr, out.data_ptr(), out.stride(0),
        M, N, K, epi, _rows(rows, M, a.device, "gemm"), _stream(a))
    _raise_on(err, "lvt_gemm_bf16")
    return out


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


def dropout_add_ln(x: torch.Tensor, res: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float,
                   seed: Optional[torch.Tensor], rate: float):
    """``(LN(res + dropout(x)), keep)`` on contiguous bf16 rows [M, C],
    C <= 1024: the dropout of element (row, col) from the counter hash of
    ``seed`` (``dropout.row_keep``), the bool keep mask [M, C] returned
    (all True at rate 0)."""
    for t, what in ((x, "x"), (res, "res")):
        _check(t, f"dropout_add_ln {what}")
        if not t.is_contiguous() or t.shape[1] > 1024:
            raise ValueError(f"dropout_add_ln {what}: must be contiguous with "
                             "C <= 1024")
    if res.shape != x.shape:
        raise ValueError(f"dropout_add_ln: res {tuple(res.shape)} != x "
                         f"{tuple(x.shape)}")
    M, C = x.shape
    seed_ptr, thresh, scale = _dropout_args(seed, rate, x.device)
    out = torch.empty_like(x)
    keep = torch.empty(M, C, dtype=torch.bool, device=x.device)
    err = library().lvt_dropout_add_ln_bf16(
        x.data_ptr(), res.data_ptr(),
        _vec(weight, C, "dropout_add_ln weight", optional=False),
        _vec(bias, C, "dropout_add_ln bias", optional=False), out.data_ptr(),
        keep.data_ptr(),
        M, C, float(eps), seed_ptr, thresh, scale, _stream(x))
    _raise_on(err, "lvt_dropout_add_ln_bf16")
    return out, keep


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


def layernorm(x: torch.Tensor, weight: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float,
              rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row LayerNorm of contiguous x [M, C], C <= 1024; ``weight`` and
    ``bias`` both None: the pure normalize (the serving fold cache's LN).
    ``rows`` (int32 [M'], indices into x's rows) gathers: out[m] =
    LN(x[rows[m]]), a zero row where rows[m] < 0."""
    _check(x, "layernorm x")
    if not x.is_contiguous() or x.shape[1] > 1024:
        raise ValueError("layernorm: x must be contiguous with C <= 1024")
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


def attention(qkv: torch.Tensor, n_seq: int, n_tok: int, n_heads: int,
              scale: float, bias: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              keep: Optional[torch.Tensor] = None,
              lse: Optional[torch.Tensor] = None,
              seed: Optional[torch.Tensor] = None,
              rate: float = 0.0) -> torch.Tensor:
    """Attention core on the packed qkv slab [n_seq * n_tok, 3C].

    bias [nH, N, N], mask [nW, N, N] (sequence s uses window s % nW), keep
    [n_seq, N] bool; all optional.  ``lse``, when given, is a contiguous
    f32 [n_seq, nH, N] that receives each query row's log-sum-exp of its
    scores (what ``attention_bwd`` takes).  At ``rate`` > 0 the
    probabilities are dropped by the counter hash of ``seed`` (an int64
    [1] on the device; ``dropout.attention_keep``) in the P.V sum only.
    Returns [n_seq * n_tok, C]."""
    C, hd, n_win = _attention_args(qkv, n_seq, n_tok, n_heads, bias, mask,
                                   "attention")
    if lse is not None:
        _check_lse(lse, qkv, n_seq, n_heads, n_tok, "attention")
    keep_ptr = None
    if keep is not None:
        if keep.device != qkv.device or tuple(keep.shape) != (n_seq, n_tok):
            raise ValueError(f"attention keep: expected [{n_seq}, {n_tok}] on "
                             f"{qkv.device}, got {tuple(keep.shape)}")
        keep = keep.to(torch.uint8).contiguous()
        keep_ptr = keep.data_ptr()
    seed_ptr, thresh, drop_scale = _dropout_args(seed, rate, qkv.device)
    out = torch.empty(qkv.shape[0], C, dtype=qkv.dtype, device=qkv.device)
    err = library().lvt_attention_bf16(
        qkv.data_ptr(), out.data_ptr(), _ptr(bias), _ptr(mask), keep_ptr,
        _ptr(lse), n_seq, n_tok, n_heads, hd, n_win, float(scale), seed_ptr,
        thresh, drop_scale, _stream(qkv))
    _raise_on(err, "lvt_attention_bf16")
    return out


def _heads_operands(ts, names, what):
    """Checks of heads-layout operands [S, nH, N, hd] (bf16, the head dim
    contiguous, other strides multiples of 8)."""
    q = ts[0]
    for t, name in zip(ts, names):
        _check(t, f"{what} {name}", ndim=4)
        if t.shape != q.shape or any(
                st % 8 for st, n in zip(t.stride()[:3], t.shape) if n > 1):
            raise ValueError(f"{what} {name}: expected {tuple(q.shape)} with "
                             f"strides that are multiples of 8, got "
                             f"{tuple(t.shape)}, {t.stride()}")
    if q.shape[3] not in (16, 32, 64):
        raise ValueError(f"{what}: head dim {q.shape[3]} unsupported "
                         "(16/32/64)")


def attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, scale: float) -> torch.Tensor:
    """The attention core on heads-layout q, k, v [B, nH, L, hd] (bf16, any
    strides with the head dim contiguous, e.g. transposed views of
    [B, L, nH, hd]) under an additive per-sequence f32 mask [B, L, L]
    (contiguous), read in place.  Returns a contiguous [B, nH, L, hd]."""
    _heads_operands((q, k, v), ("q", "k", "v"), "attention_heads")
    B, nH, L, hd = q.shape
    if (mask.device != q.device or mask.dtype != torch.float32
            or not mask.is_contiguous() or tuple(mask.shape) != (B, L, L)):
        raise ValueError(f"attention_heads mask: expected a contiguous f32 "
                         f"[{B}, {L}, {L}] on {q.device}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    out = torch.empty(B, nH, L, hd, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *sum((t.stride()[:3] for t in (q, k, v, out)), ()))
    err = library().lvt_attention_heads_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        mask.data_ptr(), B, L, nH, hd, float(scale), _stream(q))
    _raise_on(err, "lvt_attention_heads_bf16")
    return out


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor],
                     mask: Optional[torch.Tensor], scale: float
                     ) -> torch.Tensor:
    """softmax(q k^T * scale + bias[h] + mask[w % nW]) v per (window, head)
    on heads-layout q, k, v [W, nH, N, hd] (bf16, read in place by their
    strides, as ``attention_heads``); bias [nH, N, N] bf16 and mask
    [nW, N, N] f32, both contiguous and optional.  Returns a contiguous
    [W, nH, N, hd]."""
    _heads_operands((q, k, v), ("q", "k", "v"), "window_attention")
    W, nH, N, hd = q.shape
    if bias is not None:
        _check(bias, "window_attention bias", ndim=3)
        if not bias.is_contiguous() or tuple(bias.shape) != (nH, N, N):
            raise ValueError(f"window_attention bias: expected a contiguous "
                             f"[{nH}, {N}, {N}], got {tuple(bias.shape)}")
    n_win = 1
    if mask is not None:
        n_win = mask.shape[0]
        if (mask.device != q.device or mask.dtype != torch.float32
                or not mask.is_contiguous() or mask.dim() != 3
                or tuple(mask.shape[1:]) != (N, N) or W % n_win):
            raise ValueError(f"window_attention mask: expected a contiguous "
                             f"f32 [nW, {N}, {N}] with {W} % nW == 0 on "
                             f"{q.device}, got {mask.dtype} "
                             f"{tuple(mask.shape)}")
    out = torch.empty(W, nH, N, hd, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *sum((t.stride()[:3] for t in (q, k, v, out)), ()))
    err = library().lvt_window_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        _ptr(bias), _ptr(mask), W, N, nH, hd, n_win, float(scale),
        _stream(q))
    _raise_on(err, "lvt_window_attention_bf16")
    return out


def attention_bwd(qkv: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  n_seq: int, n_tok: int, n_heads: int, scale: float,
                  bias: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  seed: Optional[torch.Tensor] = None, rate: float = 0.0):
    """Backward of ``attention`` (no keep vector).

    qkv [n_seq * N, 3C], dout [n_seq * N, C] (bf16), lse the forward's f32
    [n_seq, nH, N]; ``seed`` and ``rate`` the forward's dropout, whose bits
    are regenerated.  Returns (dqkv [n_seq * N, 3C] bf16, dbias [nH, N, N]
    f32 summed over every sequence, or None without a bias); the mask gets
    no gradient."""
    C, hd, n_win = _attention_args(qkv, n_seq, n_tok, n_heads, bias, mask,
                                   "attention_bwd")
    _check(dout, "attention_bwd dout")
    if not dout.is_contiguous() or tuple(dout.shape) != (qkv.shape[0], C):
        raise ValueError(f"attention_bwd dout: expected contiguous "
                         f"[{qkv.shape[0]}, {C}], got {tuple(dout.shape)}")
    _check_lse(lse, qkv, n_seq, n_heads, n_tok, "attention_bwd")
    seed_ptr, thresh, drop_scale = _dropout_args(seed, rate, qkv.device)
    dqkv = torch.empty_like(qkv)
    part = dbias = None
    n_chunks = n_seq  # without a bias: one sequence per block
    if bias is not None:
        # sequences are split into chunks, one block per (chunk, head);
        # each chunk sums its dbias into its own f32 slice, a second pass
        # adds the slices (no atomics; the sum is the same on every run)
        n_chunks = max(1, min(n_seq, -(-264 // n_heads)))
        part = torch.empty(n_chunks, n_heads, n_tok, n_tok,
                           dtype=torch.float32, device=qkv.device)
        dbias = torch.empty(n_heads, n_tok, n_tok, dtype=torch.float32,
                            device=qkv.device)
    err = library().lvt_attention_bwd_bf16(
        qkv.data_ptr(), dout.data_ptr(), lse.data_ptr(), _ptr(bias),
        _ptr(mask), dqkv.data_ptr(), _ptr(dbias), _ptr(part), n_seq, n_tok,
        n_heads, hd, n_win, n_chunks, float(scale), seed_ptr, thresh,
        drop_scale, _stream(qkv))
    _raise_on(err, "lvt_attention_bwd_bf16")
    return dqkv, dbias


def permute_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """out[b, r] = x[b, index[r]], or zeros where index[r] < 0.

    x [B, R, C] contiguous (any dtype whose row is a multiple of 16
    bytes), index int32 [R] on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"permute_rows: expected a CUDA tensor, got "
                         f"{x.device}")
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("permute_rows: x must be a contiguous, 16-byte "
                         f"aligned [B, R, C], got {tuple(x.shape)}")
    B, R, C = x.shape
    row_bytes = C * x.element_size()
    if row_bytes % 16:
        raise ValueError(f"permute_rows: a row of {row_bytes} bytes is not a "
                         "multiple of 16")
    if (index.dtype != torch.int32 or index.device != x.device
            or tuple(index.shape) != (R,) or not index.is_contiguous()):
        raise ValueError(f"permute_rows: index must be int32 [{R}] on "
                         f"{x.device}")
    out = torch.empty_like(x)
    err = library().lvt_permute_rows(
        x.data_ptr(), out.data_ptr(), index.data_ptr(), B, R, row_bytes,
        _stream(x))
    _raise_on(err, "lvt_permute_rows")
    return out


def patch_embed_u8(x: torch.Tensor, w: torch.Tensor,
                   bias_t: torch.Tensor) -> torch.Tensor:
    """The uint8 patch embed, kernel (2, 4, 4), stride (1, 4, 4), temporal
    end pad: x uint8 [B, D, H, W, 3] (contiguous, H and W multiples of 4),
    w bf16 [96, E] the folded conv weights (rows in (kd, kh, kw, c) order),
    bias_t f32 [D, E] the per-time bias table.  Returns bf16
    [B, D, H / 4, W / 4, E]."""
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
    if w.shape[0] != 96 or E % 16 or E > 256 or not w.is_contiguous():
        raise ValueError(f"patch_embed_u8 w: expected a contiguous [96, E], "
                         f"E % 16 == 0, E <= 256, got {tuple(w.shape)}")
    if (bias_t.dtype != torch.float32 or bias_t.device != x.device
            or not bias_t.is_contiguous() or tuple(bias_t.shape) != (D, E)):
        raise ValueError(f"patch_embed_u8 bias_t: expected a contiguous f32 "
                         f"[{D}, {E}] on {x.device}")
    out = torch.empty(B, D, H // 4, W // 4, E, dtype=torch.bfloat16,
                      device=x.device)
    err = library().lvt_patch_embed_u8(
        x.data_ptr(), w.data_ptr(), bias_t.data_ptr(), out.data_ptr(), B, D,
        H, W, E, _stream(x))
    _raise_on(err, "lvt_patch_embed_u8")
    return out
