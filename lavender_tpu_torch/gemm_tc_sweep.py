"""Device time of the tile GEMM (``csrc/gemm_tc.cu``) at each tile height,
against F.linear, at the products of K1 and K4 on the B=4 serving forward
and the B=8 train step, on one CUDA GPU.

    python -m lavender_tpu_torch.gemm_tc_sweep

Prints the card's name and power limit (nvidia-smi), then per product
F.linear's device ms a call and the tile GEMM's at 64-, 128- and 256-row
tiles (128 and 64 only with the residual epilogue), each from 10 calls
in a CUDA graph (``device_ms``), its ratio to F.linear and the plan's
pick (``_build.gemm_tc_plan``); then K4's proj +
residual + LN (``_build.gemm_tc_ln``'s C entry) at each (tile rows,
K-slices); then K3's and K9's LN + MLP (``_build.ln_mlp``, one C call)
at each fc2 (tile rows, K-slices) and each fc1 tile height beside their
plain version.  The
constants of ``_build.gemm_tc_plan`` (``_TC_RATE``) and the slice rule of
``_build.ln_mlp_plan`` come from these times.  Needs a CUDA device;
raises without one.
"""
from __future__ import annotations

import subprocess

import torch
import torch.nn.functional as F

from lavender_tpu_torch.ops import _build

# (name, M, N, K, epilogue): Swin-B at T = 5, 224 x 224 (M = B * nW *
# 248), BERT-base at B = 4, L = 276
PRODUCTS = (
    ("stage 1 qkv B=4", 63488, 384, 128, "bias"),
    ("stage 1 proj B=4", 63488, 128, 128, "residual"),
    ("stage 1 fc1 B=4", 63488, 512, 128, "gelu"),
    ("stage 1 fc2 B=4", 63488, 128, 512, "residual"),
    ("stage 2 qkv B=8", 31744, 768, 256, "bias"),
    ("stage 2 proj B=8", 31744, 256, 256, "residual"),
    ("stage 2 fc1 B=4", 15872, 1024, 256, "gelu"),
    ("stage 2 fc2 B=4", 15872, 256, 1024, "residual"),
    ("stage 3 qkv B=4", 3968, 1536, 512, "bias"),
    ("stage 3 proj B=4", 3968, 512, 512, "residual"),
    ("stage 3 fc1 B=4", 3968, 2048, 512, "gelu"),
    ("stage 3 fc2 B=4", 3968, 512, 2048, "residual"),
    ("stage 4 qkv B=4", 992, 3072, 1024, "bias"),
    ("stage 4 proj B=4", 992, 1024, 1024, "residual"),
    ("K4 q|k|v (one launch) B=4", 1104, 768, 768, "qkv"),
)
# (name, M, C, residual) of the LN + MLP (HD = 4C): K9 on the B=8 train
# step (no residual) and the B=4 "pallas" forward (+ residual), K3 at B=4
# serving's stage 4
LN_MLPS = (
    ("K9 stage 1 B=8", 126976, 128, False),
    ("K9 stage 2 B=8", 31744, 256, False),
    ("K9 stage 3 B=8", 7936, 512, False),
    ("K9 stage 4 B=8", 1984, 1024, False),
    ("K9 stage 3 B=4 +residual", 3968, 512, True),
    ("K3 stage 4 B=4", 992, 1024, True),
)


def device_ms(fn, n: int = 10) -> float:
    """Device ms a call: n calls captured in one CUDA graph (after a
    warm-up call), its replays timed by CUDA events (median of 5 windows
    of 5), / n: no host time in it."""
    import statistics

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(5)]
    for start, end in marks:
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks) / 5 / n


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gemm_tc_sweep: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    lib = _build.library()

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * std).to(
            torch.bfloat16)

    for name, M, N, K, epi in PRODUCTS:
        G = 3 if epi == "qkv" else 1
        a = rnd(M, K)
        ws = [rnd(N, K, std=K ** -0.5) for _ in range(G)]
        bs = [rnd(N) for _ in range(G)]
        r = rnd(M, N) if epi == "residual" else None
        w_lib, b_lib = torch.cat(ws), torch.cat(bs)
        lib_ms = device_ms(lambda: F.linear(a, w_lib, b_lib))
        plan = _build.gemm_tc_plan(M, N, K, G, residual=r is not None).bm
        row = [f"{name} M={M} N={N}x{G} K={K} {epi}: F.linear "
               f"{lib_ms:.4f} ms"]
        code = {"gelu": 1, "residual": 2}.get(epi, 0)
        out = torch.empty(M, G * N, dtype=torch.bfloat16, device="cuda")
        for bm in ((64, 128) if r is not None else (64, 128, 256)):
            def call(bm=bm):  # lvt_gemm_tc_bf16 at this tile height
                w3 = [t.data_ptr() for t in ws] + [None] * (3 - G)
                b3 = [t.data_ptr() for t in bs] + [None] * (3 - G)
                err = lib.lvt_gemm_tc_bf16(
                    a.data_ptr(), K, *w3, *b3, G,
                    None if r is None else r.data_ptr(), N, out.data_ptr(),
                    G * N, M, N, K, code, bm, 1,
                    torch.cuda.current_stream().cuda_stream)
                _build._raise_on(err, "lvt_gemm_tc_bf16")
            t = device_ms(call)
            row.append(f"bm {bm} {t:.4f} ({t / lib_ms:.2f}x)"
                       + (" plan" if bm == plan else ""))
        print(" | ".join(row), flush=True)
    for M in (1104, 1000):
        C = K = 768
        a, x, w, b = rnd(M, K), rnd(M, C), rnd(C, K, std=K ** -0.5), rnd(C)
        lw, lb = 1.0 + rnd(C, std=0.1), rnd(C, std=0.1)
        part = torch.empty(8 * M * C, dtype=torch.float32, device="cuda")
        out = torch.empty(M, C, dtype=torch.bfloat16, device="cuda")
        plan = _build.gemm_tc_plan(M, C, K, split=True)
        row = [f"K4 proj + residual + LN M={M}: F.linear "
               f"{device_ms(lambda: F.linear(a, w, b)):.4f} ms"]
        for bm, S in ((128, 1), (64, 1), (128, 2), (64, 2), (128, 3)):
            def call(bm=bm, S=S):
                err = lib.lvt_gemm_tc_ln_bf16(
                    a.data_ptr(), K, w.data_ptr(), b.data_ptr(),
                    x.data_ptr(), lw.data_ptr(), lb.data_ptr(),
                    part.data_ptr(), out.data_ptr(), M, C, K, bm, S, 1e-12,
                    torch.cuda.current_stream().cuda_stream)
                _build._raise_on(err, "lvt_gemm_tc_ln_bf16")
            row.append(f"(bm {bm}, S {S}) {device_ms(call):.4f}"
                       + (" plan" if (bm, S) == plan[:2] else ""))
        print(" | ".join(row), flush=True)
    from lavender_tpu_torch.ops.fused_mlp import fused_ln_mlp

    for name, M, C, residual in LN_MLPS:
        HD = 4 * C
        x = rnd(M, C)
        mlp = (1.0 + rnd(C, std=0.1), rnd(C, std=0.1),
               rnd(HD, C, std=C ** -0.5), rnd(HD, std=0.02),
               rnd(C, HD, std=HD ** -0.5), rnd(C, std=0.02))
        plan = _build.ln_mlp_plan(M, C, HD, residual)
        plain = device_ms(lambda: fused_ln_mlp.plain(x, *mlp, 1e-5, residual))
        row = [f"{name} LN + MLP M={M} C={C}: plain {plain:.4f} ms"]
        options = [(bm, 1) for bm in ((64, 128) if residual
                                      else (64, 128, 256))]
        if M < 16384:  # the short products: fc2 as f32 K-slices too
            options += [(bm, S) for bm in (64, 128, 256) for S in (2, 4)
                        if (HD // _build.TILE_K) % S == 0]
        options = [(plan.fc1_bm, bm, S) for bm, S in options] + [
            (bm1, plan.fc2_bm, plan.splits) for bm1 in (64, 128, 256)
            if bm1 != plan.fc1_bm]
        for bm1, bm, S in options:
            p = _build.LnMlpPlan(bm1, bm, S,
                                 lib.lvt_ln_mlp_scratch(M, C, HD, S))
            t = device_ms(lambda p=p: _build.ln_mlp(x, *mlp, 1e-5, residual,
                                                    plan=p))
            picked = p[:3] == plan[:3]
            row.append(f"(fc1 bm {bm1}; bm {bm}, S {S}) {t:.4f}"
                       + (" plan" if picked else ""))
        print(" | ".join(row), flush=True)
        del x
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
