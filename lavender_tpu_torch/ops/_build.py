"""Build, bind and launch the port's hand-written CUDA kernels.

The sources under ``lavender_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` into ONE shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use (never at import), writes into
``build/`` at the repository root, and is keyed by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one is loaded as is.

The primitives bound here (tiled GEMM with fused epilogues, row
LayerNorm and its dropout + residual variant, attention core and its
backward, both with optional dropout, row permutation, and a probe of the
dropout hash) are what the ports of the TPU kernels are composed from, see
``swin_block_attn.py``, ``swin_core_attn.py``, ``wm_permute.py``,
``fused_mlp.py``, ``encoder_attention.py`` and ``dropout.py``.  Each launch goes on PyTorch's current stream,
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
# the dropout arguments of a kernel: seed pointer (null = no dropout), the
# keep threshold of the bits, the scale of the kept values
_DROP = [_P, _U, _F]
_SIGNATURES = {
    "lvt_gemm_bf16": [_P, _I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "lvt_layernorm_bf16": [_P, _P, _P, _P, _I, _I, _F, _P],
    "lvt_dropout_add_ln_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _F, *_DROP,
                                _P],
    "lvt_attention_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                           *_DROP, _P],
    "lvt_attention_bwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _F, *_DROP, _P],
    "lvt_permute_rows": [_P, _P, _P, _I, _I, _I, _P],
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
    """Compile the sources unless the library for their hash exists.

    nvcc's output (with ``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        tmp_so = Path(tmp) / so.name
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp_so), *map(str, cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
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


class KernelOp:
    """Entry point of one ported TPU kernel.

    A CPU tensor goes to ``plain`` (the plain PyTorch version, which the
    CPU tests compare with the JAX package); any other tensor goes to the
    CUDA ``launch``, which runs the hand-written kernels or raises: there
    is no fallback.  ``launches`` counts the calls that launched.

    ``casts``: under CUDA autocast the kernel takes its floating inputs in
    the autocast dtype (its autograd Function is
    ``torch.amp.custom_fwd(cast_inputs=...)``); ``plain_as_launched`` then
    casts the same way, so that both paths see the same inputs."""

    def __init__(self, name: str, plain: Callable, launch: Callable,
                 casts: bool = True):
        self.name = name
        self.plain = plain
        self._launch = launch
        self.casts = casts
        self.launches = 0
        self.__doc__ = plain.__doc__

    def __call__(self, x: torch.Tensor, *args, **kwargs):
        if x.device.type == "cpu":
            return self.plain(x, *args, **kwargs)
        out = self._launch(x, *args, **kwargs)
        self.launches += 1
        return out

    def plain_as_launched(self, *args, **kwargs):
        """``plain`` on the inputs the kernel would get (see ``casts``)."""
        if not (self.casts and torch.is_autocast_enabled("cuda")):
            return self.plain(*args, **kwargs)
        dt = torch.get_autocast_dtype("cuda")
        with torch.autocast("cuda", enabled=False):
            return self.plain(*_cast(args, dt), **_cast(kwargs, dt))


_plain_path = False


@contextlib.contextmanager
def plain_path():
    """Inside this block the models call every kernel's plain PyTorch
    version, on any device: the reference path that ``chip_smoke.py``
    compares the kernel path with.  The wrappers themselves stay as they
    are (a CUDA tensor launches or raises)."""
    global _plain_path
    prev, _plain_path = _plain_path, True
    try:
        yield
    finally:
        _plain_path = prev


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on these arguments (None allowed)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


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


def _vec(t: Optional[torch.Tensor], n: int, what: str):
    if t is None:
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


def gemm(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
         *, gelu: bool = False, residual: Optional[torch.Tensor] = None,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = epi(a @ w.T + bias)``: epi is exact GELU or ``+ residual``.

    a [M, K], w [N, K] (torch Linear layout); ``out`` may be a column slice
    of a wider tensor (its row stride is passed through)."""
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
        M, N, K, epi, _stream(a))
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
        x.data_ptr(), res.data_ptr(), _vec(weight, C, "dropout_add_ln weight"),
        _vec(bias, C, "dropout_add_ln bias"), out.data_ptr(), keep.data_ptr(),
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


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """Row LayerNorm of contiguous x [M, C], C <= 1024."""
    _check(x, "layernorm x")
    if not x.is_contiguous() or x.shape[1] > 1024:
        raise ValueError("layernorm: x must be contiguous with C <= 1024")
    M, C = x.shape
    out = torch.empty_like(x)
    err = library().lvt_layernorm_bf16(
        x.data_ptr(), _vec(weight, C, "layernorm weight"),
        _vec(bias, C, "layernorm bias"), out.data_ptr(), M, C, float(eps),
        _stream(x))
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
