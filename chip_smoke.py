#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits nonzero:

  1. card and build: print the card's name and power limit (nvidia-smi),
     build every CUDA kernel of the serving path from ``src/repro_torch/csrc``
     with nvcc for sm_90a (one nvcc per source, in parallel) and print the
     build time and ptxas's register/spill report;
  2. kernels: hold each kernel (each of the GEMM's three paths, the
     attention tile and its split-KV form, K3's wgmma and WMMA kernels,
     K4's vector and scalar paths) against its plain PyTorch version, on
     the card, at the main paths' shapes (the SSD's batched
     products, mamba2's causal conv, whisper's conv stem and encoder and
     cross attention, qwen2-vl's patch embed and GQA prefill included)
     and on edge cases
     (ragged fringes, batch, accumulate forms, every epilogue, GQA, window,
     q_offset, valid, fully-masked rows, conv strides, ragged channels, F
     and K fringes, f16/f32 conv inputs); print each case's worst error
     and tolerance (K4 also bit for bit at mamba2's four shapes with no
     epilogue; K3's stems launched three times for the same bits), and
     time each kernel (CUDA events, L2 flushed between
     launches) beside its plain version, one PyTorch library call as a
     yardstick, and the bound from bytes and flops at the card's published
     peaks;
  3. serve, through ``repro_torch.launch.serve.serve_loop`` with random
     bf16 weights from a seed: deepseek-7b at full width (the GEMM and
     flash-attention kernels), zamba2-1.2b at full width and depth (GEMM,
     attention, depthwise conv), mamba2-130m at full width (GEMM and
     depthwise conv) and deepseek-moe-16b at full width and depth (GEMM,
     its expert banks batched products on the weight stream, and
     attention); then generate, through ``models.model.prefill`` and
     ``decode_step`` (the serving loop admits token-only prompts), with
     whisper-small (4 clips of 3000 mel frames, a 4-token decoder prompt)
     and qwen2-vl-7b (4 requests of one 448 x 448 image and 64 text
     tokens) at full width and depth: a batch-4 prefill, the cache
     handoff, 32 greedy decode steps (GEMM, attention and the dense conv).
     Every kernel's launch count is reset just before each run and read
     just after, and must match the per-call model (each kernel of that
     path > 0); then each model's prefill and decode logits on the kernel
     backend against the eager torch backend (for deepseek-moe-16b also
     the share of (token, choice) pairs the two backends routed alike),
     mamba2-130m's exact per-slot prefill handoff, and a profile of one
     prefill and one decode step of deepseek-7b, zamba2, deepseek-moe-16b,
     whisper-small and qwen2-vl-7b.  Each run also
     records the GEMM's and the two convs' launches by path and the shapes
     it gave the GEMM, the attention kernel and the depthwise conv; every
     decode product and every expert-bank product must have taken the
     weight stream, every other deepseek-7b, qwen2-vl-7b and
     deepseek-moe-16b prefill product the wgmma tile, every one-query
     attention split-KV, every dense conv K3's wgmma kernel and every
     depthwise conv K4's vector path;
  4. the runs' shapes: each distinct GEMM, attention and depthwise conv
     shape of the runs held against its plain version and timed (kernel,
     path, torch.matmul, SDPA or cuDNN, bound);
  5. train, through ``repro_torch.launch.train.build`` with random fp32
     weights from seed 0 and the default BF16GER2 facility: deepseek-7b at
     full width with its depth cut to 4 layers (fp32 parameters, gradients
     and both moments of all 30 layers, ~110 GB, do not fit the card),
     zamba2-1.2b at full width and depth, deepseek-moe-16b at full width
     cut to 3 layers (one dense, two MoE) and whisper-small at full width
     and depth (4 clips of 3000 mel frames, 448 decoder tokens), each 6
     steps of AdamW (lr 3e-5, whisper-small 1e-3; no weight decay) on one
     repeated batch of 4 x 512 tokens.  Step 1's
     loss and every parameter's gradient on the kernel backend are held
     against the eager torch backend (the same rule as the logits); the
     loss must be finite, fall at every step after the first update (at
     full width it rises after Adam's first update) and by 20% or more
     from step 1 to step 6; each kernel's launches must match the
     per-call model (the forward's, two more GEMMs per GEMM in the
     backward and one recompute per GEMM with a fused activation;
     attention and the depthwise conv launch in the forward only); the
     same steps on the eager torch backend must give each step's loss
     within 2e-2 relative; step time, a profiled step's device busy time
     and idle share, tokens/s, model TFLOP/s and peak memory are printed;
     the state goes through a ``Checkpointer`` save and restore and must
     come back bit for bit.  Then, as in phase 4, each distinct shape the
     train steps gave the GEMM (forward, dX, dW, the recompute of Z),
     attention and the depthwise conv is held against its plain version
     and timed.

The line before the last is ``{"kernels": [...]}`` (one entry per kernel,
``launches`` summed over the runs and ``launches_by_run``; the GEMM's
and the convs' ``launches_by_path``; the GEMM's ``host_us`` per call and,
with the attention kernel's and the depthwise conv's, ``run_shapes``;
``max_abs_err`` covers the runs' shapes, training's included); the last
is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX and nothing
of the JAX package.  Exits nonzero, printing no result, where CUDA
is absent or where ``src/repro_torch`` is not beside this file.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (dense, no sparsity) at the full 700 W limit.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12}

# The serving runs, each at full width: deepseek-7b (slice 1: the GEMM and
# flash-attention kernels), zamba2-1.2b at full depth (slice 2: all three
# kernels, mamba2 layers with a shared attention block) and mamba2-130m
# (slice 2: the pure-SSM kind and its exact per-slot prefill handoff).
ARCH = "deepseek-7b"
SERVE = dict(batch=4, prompt_len=256, gen_len=32, n_requests=8)
NUM_LAYERS = None        # None = the config's full depth; an int cuts depth
SSM_RUNS = (("zamba2-1.2b", SERVE),
            ("mamba2-130m", dict(batch=4, prompt_len=256, gen_len=16,
                                 n_requests=4)))
# The MoE serving run (ROADMAP B1): deepseek-moe-16b at full width and depth
# (28 layers: one dense, 27 of 64 routed top-6 experts and 2 shared; 16.4
# B parameters, 32.8 GB in bf16), its expert banks batched products on the
# GEMM's batch axis.
MOE_RUN = ("deepseek-moe-16b", SERVE)
# The generation runs of the multimodal kinds (slice 3), at full width and
# depth: whisper-small over 30 s clips (3000 mel frames, its fixed input
# window) with a 4-token decoder prompt; qwen2-vl-7b with one 448 x 448
# image (its 32 x 32 patch grid feeds the 1024 vision positions) and 64
# text tokens a request, a 1088-token prompt.
MM_RUNS = {"whisper-small": dict(batch=4, frames=3000, prompt_len=4,
                                 gen_len=32),
           "qwen2-vl-7b": dict(batch=4, text_len=64, gen_len=32)}
# The training runs (slice 6): (arch, depth cut or None), each at full
# width; deepseek-7b at 4 of its 30 layers (1.65 B parameters: ~26 GB of
# fp32 parameters, gradients and moments, where full depth needs ~110 GB).
# The launcher's schedule takes its first update at the peak rate, and
# Adam's first update moves every weight by about lr: at full width the
# loss rises after it at every rate from 1e-5 to 1e-3 for deepseek-7b, as
# the reference's does at d_model 2048 at 1e-4 and 1e-3
# (scripts/train_lr_witness.py; PERF.md, section 6).  At 3e-5 both
# losses fall at every step after that, by 36% (deepseek-7b) and 72%
# (zamba2) over 6 steps; ``fall`` is the least fall from step 1 to the
# last that the check accepts.
# deepseek-moe-16b at 3 of its 28 layers (the dense layer and 2 MoE layers,
# 1.68 B parameters; full depth needs ~260 GB of fp32 state) and
# whisper-small at full depth over 4 clips of 3000 mel frames, its fixed
# 30 s input window (``seq`` is the frame count for the audio kind; its
# decoder takes its fixed 448 tokens).
TRAIN_RUNS = (("deepseek-7b", 4), ("zamba2-1.2b", None),
              ("deepseek-moe-16b", 3), ("whisper-small", None))
TRAIN = dict(batch=4, seq=512, steps=6, lr=3e-5, fall=0.2)
TRAIN_SEQ = {"whisper-small": 3000}
# whisper-small's decoder labels are uniformly random tokens, with no
# unigram statistics to learn: over 6 steps its loss falls at every rate
# from 1e-5 to 1e-3, but by 20% only at 1e-3 (26%; 12% at 3e-4, 5.6% at
# 3e-5: scripts/train_lr_witness.py --card, PERF.md section 6).
TRAIN_LR = {"whisper-small": 1e-3}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# Timing
# ----------------------------------------------------------------------

class Timer:
    """Median device time of a callable over ``iters`` launches (after
    ``warmup`` untimed ones), each timed with its own CUDA event pair after
    a write of ``flush_bytes`` (larger than the 50 MB L2), so every launch
    starts from a cold cache, and a spin of ``hold_us`` on the card, so
    that the callable's host work is done before its first kernel may
    start and its launches are timed back to back: the time is the
    device's, not the wrapper's."""

    def __init__(self, torch, flush_bytes: int = 256 << 20,
                 hold_us: float = 300.0):
        self.torch = torch
        self.flush = torch.empty(flush_bytes, dtype=torch.uint8,
                                 device="cuda")
        # cycles at the H100's 1.98 GHz boost clock (a slower clock only
        # holds longer)
        self.hold_cycles = int(hold_us * 1e-6 * 1.98e9)

    def __call__(self, fn, iters: int = 10, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.hold_cycles)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        times = sorted(a.elapsed_time(b) for a, b in pairs)
        return times[len(times) // 2]


def bound_ms(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bf16_ulp(torch, v):
    """Spacing of bf16 numbers at |v| (8 significant bits)."""
    mag = v.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# ----------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def check_gemm(torch, timer, failures):
    from repro_torch.core import precision
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_gemm as G

    Ger = precision.Ger
    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    p = SERVE["prompt_len"]
    cases = []
    # The serving path's products: (name, M, K, N, epilogue, out dtype).
    for m in (4, p):
        cases += [
            (f"qkvo M={m}", m, 4096, 4096, None, torch.bfloat16),
            (f"wo+res M={m}", m, 4096, 4096, "residual", torch.bfloat16),
            (f"w1+silu M={m}", m, 4096, 11008, "silu", torch.bfloat16),
            (f"w3 M={m}", m, 4096, 11008, None, torch.bfloat16),
            (f"w2+res M={m}", m, 11008, 4096, "residual", torch.bfloat16),
            (f"logits M={m}", m, 4096, 102400, None, torch.float32),
        ]
    worst = 0.0
    for name, m, k, n, epi, od in cases:
        x = randn(m, k)
        y = randn(k, n, scale=k ** -0.5)
        res = randn(m, n) if epi == "residual" else None
        ep = E.Epilogue(activation="silu") if epi == "silu" else (
            E.Epilogue(residual=True) if epi == "residual" else None)
        kw = dict(kind=Ger.BF16GER2, ep=ep, residual=res, out_dtype=od)
        got = G.mma_gemm(x, y, **kw).float()
        want = G.mma_gemm_plain(x, y, **kw).float()
        worst = max(worst, _report_close(
            torch, f"gemm {name}", got, want, od, failures))
    # The SSD's batched products (models/mamba2.py) at zamba2's widths
    # (H = 64 heads of P = 64, N = 64) and mamba2-130m's (H = 24, N = 128),
    # prefill chunk L = 256, decode batch B = 4: (batch, M, K, N, out).
    b = SERVE["batch"]
    for arch, h, n_st in (("zamba2", 64, 64), ("mamba2", 24, 128)):
        hp = h * 64
        for name, bb, m, k, n, od in (
                ("scores", 1, p, n_st, p, torch.float32),
                ("y_intra", h, p, p, 64, torch.bfloat16),
                ("states", 1, n_st, p, hp, torch.float32),
                ("y_inter", 1, p, n_st, hp, torch.bfloat16),
                ("decode outer K=1", b, n_st, 1, hp, torch.float32),
                ("decode y M=1", b, 1, n_st, hp, torch.bfloat16)):
            x, y = randn(bb, m, k), randn(bb, k, n, scale=k ** -0.5)
            kw = dict(kind=Ger.BF16GER2, out_dtype=od)
            got = G.mma_gemm(x, y, **kw).float()
            want = G.mma_gemm_plain(x, y, **kw).float()
            worst = max(worst, _report_close(
                torch, f"gemm {arch} ssd {name} ({bb},{m},{k})x({bb},{k},{n})",
                got, want, od, failures))

    # Edge cases: ragged fringes, batch, accumulate forms, epilogues, tiles,
    # F32GER and F16GER2.
    edge = []
    x = randn(5, 999)
    edge.append(("ragged M/K, N%8!=0", x, randn(999, 1001, scale=0.03),
                 None, dict(kind=Ger.BF16GER2, out_dtype=torch.float32)))
    edge.append(("batched B=3 77x200x130", randn(3, 77, 200),
                 randn(3, 200, 130, scale=0.07), None,
                 dict(kind=Ger.BF16GER2, out_dtype=torch.float32)))
    edge.append(("seed neg/neg alpha/beta", randn(70, 256),
                 randn(256, 90, scale=0.06),
                 randn(70, 90, dtype=torch.float32),
                 dict(kind=Ger.BF16GER2, neg_product=True, neg_acc=True,
                      alpha=0.5, beta=-2.0, out_dtype=torch.float32)))
    edge.append(("bias+gelu+res tile 128", randn(300, 512),
                 randn(512, 260, scale=0.04), None,
                 dict(kind=Ger.BF16GER2, block=(128, 128, 32),
                      ep=E.Epilogue(bias=True, activation="gelu",
                                    residual=True),
                      bias=randn(260, dtype=torch.float32),
                      residual=randn(300, 260), out_dtype=torch.bfloat16)))
    edge.append(("relu tile 64 f16", randn(130, 384, dtype=torch.float16),
                 randn(384, 200, dtype=torch.float16, scale=0.05), None,
                 dict(kind=Ger.F16GER2, block=(64, 64, 64),
                      ep=E.Epilogue(activation="relu"),
                      out_dtype=torch.float16)))
    edge.append(("F32GER 256x1024x1000", randn(256, 1024,
                                               dtype=torch.float32),
                 randn(1024, 1000, dtype=torch.float32, scale=0.03),
                 randn(256, 1000, dtype=torch.float32),
                 dict(kind=Ger.F32GER, beta=0.5, out_dtype=torch.float32)))
    # the weight stream and the wgmma tile at their own fringes and forms
    edge.append(("seed neg/neg alpha/beta M=40 (stream)", randn(40, 768),
                 randn(768, 520, scale=0.04),
                 randn(40, 520, dtype=torch.float32),
                 dict(kind=Ger.BF16GER2, neg_product=True, neg_acc=True,
                      alpha=0.5, beta=-2.0, out_dtype=torch.float32)))
    edge.append(("bias+gelu+res M=16 (stream)", randn(16, 768),
                 randn(768, 1000, scale=0.04), None,
                 dict(kind=Ger.BF16GER2,
                      ep=E.Epilogue(bias=True, activation="gelu",
                                    residual=True),
                      bias=randn(1000, dtype=torch.float32),
                      residual=randn(16, 1000), out_dtype=torch.bfloat16)))
    edge.append(("f16 silu M=7 (stream)", randn(7, 512, dtype=torch.float16),
                 randn(512, 300, dtype=torch.float16, scale=0.05), None,
                 dict(kind=Ger.F16GER2, ep=E.Epilogue(activation="silu"),
                      out_dtype=torch.float16)))
    edge.append(("seed neg alpha/beta 130x96x72 (wgmma)", randn(130, 96),
                 randn(96, 72, scale=0.1),
                 randn(130, 72, dtype=torch.float32),
                 dict(kind=Ger.BF16GER2, neg_product=True, alpha=-1.5,
                      beta=0.25, out_dtype=torch.float32)))
    edge.append(("batched B=3 77x200x136 (wgmma)", randn(3, 77, 200),
                 randn(3, 200, 136, scale=0.07), None,
                 dict(kind=Ger.BF16GER2, out_dtype=torch.float32)))
    edge.append(("bias+relu+res 257x384x200 f16 (wgmma)",
                 randn(257, 384, dtype=torch.float16),
                 randn(384, 200, dtype=torch.float16, scale=0.05), None,
                 dict(kind=Ger.F16GER2,
                      ep=E.Epilogue(bias=True, activation="relu",
                                    residual=True),
                      bias=randn(200, dtype=torch.float32),
                      residual=randn(257, 200, dtype=torch.float16),
                      out_dtype=torch.float16)))
    for name, xe, ye, ce, kw in edge:
        before = dict(G.mma_gemm.launches_by_path)
        got = G.mma_gemm(xe, ye, ce, **kw).float()
        path = [p for p, n in G.mma_gemm.launches_by_path.items()
                if n != before[p]]
        plain_kw = {k: v for k, v in kw.items() if k != "block"}
        want = G.mma_gemm_plain(xe, ye, ce, **plain_kw).float()
        worst = max(worst, _report_close(
            torch, f"gemm {name} -> {path}", got, want, kw["out_dtype"],
            failures))

    # Timing at the decode MLP's product (M = batch, 4096 -> 11008).
    m, k, n = SERVE["batch"], 4096, 11008
    x, y = randn(m, k), randn(k, n, scale=k ** -0.5)
    kw = dict(kind=Ger.BF16GER2, out_dtype=torch.bfloat16)
    times = {name: timer(fn) for name, fn in (
        ("ms", lambda: G.mma_gemm(x, y, **kw)),
        ("plain_ms", lambda: G.mma_gemm_plain(x, y, **kw)),
        ("library_ms", lambda: torch.matmul(x, y)))}
    b_ms, b_by = bound_ms((m * k + k * n + m * n) * 2, 2 * m * n * k, "bf16")
    print(f"  time gemm {m}x{k}x{n}: kernel {times['ms']:.4f} ms, plain "
          f"{times['plain_ms']:.4f} ms, torch.matmul "
          f"{times['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # Host time of one call at decode M (the weight stream), beside
    # torch.matmul's, and of one at prefill M (the wgmma tile, whose
    # tensor maps are encoded on every call).
    xw, yw = randn(p, 4096), randn(4096, 4096, scale=4096 ** -0.5)
    host = {"mma_gemm decode (stream)": host_us(
                torch, lambda: G.mma_gemm(x, y, **kw)),
            "torch.matmul decode": host_us(torch, lambda: torch.matmul(x, y)),
            "mma_gemm prefill (wgmma)": host_us(
                torch, lambda: G.mma_gemm(xw, yw))}
    print("  host us per call: " + ", ".join(f"{k} {v:.1f}"
                                             for k, v in host.items()))
    return {"name": "mma_gemm", "route": "cuda",
            "source": "src/repro_torch/csrc/gemm_stream.cu, "
                      "src/repro_torch/csrc/gemm_wgmma.cu, "
                      "src/repro_torch/csrc/mma_gemm.cu",
            "replaces": "src/repro/kernels/mma_gemm.py:197",
            "max_abs_err": worst, "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"M={m} K={k} N={n} bf16 (stream)", **times,
            "host_us": host}


def host_us(torch, fn, n: int = 200) -> float:
    """Host time of one call (enqueue only), over ``n`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def _report_close(torch, name, got, want, out_dtype, failures) -> float:
    err = (got - want).abs()
    scale = want.abs().max().item()
    if out_dtype == torch.float32:
        # fp32 sums in another order: rtol 2e-5, atol 2e-5 * max|ref|
        tol = 2e-5 * want.abs() + 2e-5 * scale
        how = "rtol 2e-5 + 2e-5*max|ref|"
    else:
        # one ulp of the 16-bit output, plus fp32 sum-order noise
        ulp = (bf16_ulp(torch, want) if out_dtype == torch.bfloat16
               else bf16_ulp(torch, want) / 8)
        tol = ulp + 1e-4 * scale
        how = "1 ulp + 1e-4*max|ref|"
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
    e = err.max().item()
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: max|err| {e:.3e} "
          f"(tol {how}, max|ref| {scale:.3e})")
    if not ok:
        failures.append(name)
    return e


def check_attention(torch, timer, failures):
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_attention as A

    g = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    p = SERVE["prompt_len"]
    cases = [
        (f"prefill causal (1,{p},32,128)", (1, p, 32, 128), (1, p, 32, 128),
         dict(causal=True)),
        ("GQA 32/4 ragged S=200 B=2", (2, 200, 32, 128), (2, 200, 4, 128),
         dict(causal=True)),
        ("window 100 S=300", (1, 300, 8, 128), (1, 300, 8, 128),
         dict(causal=True, window=100)),
        ("q_offset 256 (64 on 320)", (1, 64, 8, 128), (1, 320, 8, 128),
         dict(causal=True, q_offset=256)),
        ("full, no mask, D=64", (2, 96, 4, 64), (2, 130, 4, 64),
         dict(causal=False)),
        (f"zamba2 shared block causal (1,{p},32,64)", (1, p, 32, 64),
         (1, p, 32, 64), dict(causal=True)),
    ] + [(name, qs, ks, kw) for name, qs, ks, kw in MM_ATTENTION]
    worst = 0.0
    for name, qs, ks, kw in cases:
        q, k, v = randn(*qs), randn(*ks), randn(*ks)
        e, _ = check_attn_case(torch, f"attn {name}", q, k, v, kw, failures)
        worst = max(worst, e)
    # valid slots, with fully-masked rows (rows 0-2 see only invalid keys)
    q, k, v = randn(2, 70, 8, 128), randn(2, 70, 2, 128), randn(2, 70, 2, 128)
    valid = torch.ones((2, 70), dtype=torch.bool, device="cuda")
    valid[:, :3] = False
    valid[1, 40:] = False
    e, got = check_attn_case(torch, "attn valid + masked rows", q, k, v,
                             dict(causal=True, valid=valid), failures)
    worst = max(worst, e)
    zero_ok = bool((got[:, :3] == 0).all())
    print(f"  [{'ok' if zero_ok else 'FAIL'}] attn fully-masked rows are "
          f"exact zeros")
    if not zero_ok:
        failures.append("attn masked rows")
    # the epilogue on the normalised output, f32 store
    ep = E.Epilogue(bias=True, activation="silu", residual=True)
    bias = randn(128, dtype=torch.float32)
    res = randn(1, 130, 8, 128)
    q, k, v = randn(1, 130, 8, 128), randn(1, 130, 8, 128), randn(1, 130, 8, 128)
    kw = dict(causal=True, ep=ep, bias=bias, residual=res,
              out_dtype=torch.float32)
    e, _ = check_attn_case(torch, "attn bias+silu+res f32", q, k, v, kw,
                           failures)
    worst = max(worst, e)

    # Timing at the prefill shape.
    q, k, v = randn(1, p, 32, 128), randn(1, p, 32, 128), randn(1, p, 32, 128)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {name: timer(fn) for name, fn in (
        ("ms", lambda: A.mma_flash_attention(q, k, v, causal=True)),
        ("plain_ms", lambda: A.flash_attention_plain(q, k, v, causal=True)),
        ("library_ms", lambda: sdpa(qt, kt, vt, is_causal=True)))}
    pairs = A.attn_live_pairs(p, p, causal=True)
    b_ms, b_by = bound_ms(4 * p * 32 * 128 * 2, 4 * 128 * pairs * 32, "bf16")
    extra = {}   # causal prefill at lengths the runs do not reach
    for s, d in ((1024, 128), (4096, 128)):
        q2, k2, v2 = (randn(1, s, 32, d) for _ in range(3))
        qt2, kt2, vt2 = (t.transpose(1, 2) for t in (q2, k2, v2))
        t = timer(lambda: A.mma_flash_attention(q2, k2, v2, causal=True),
                  iters=5)
        tl = timer(lambda: sdpa(qt2, kt2, vt2, is_causal=True), iters=5)
        bb, by = bound_ms(4 * s * 32 * d * 2,
                          4 * d * A.attn_live_pairs(s, s, causal=True) * 32,
                          "bf16")
        extra[f"S={s} D={d}"] = dict(ms=t, library_ms=tl, bound_ms=bb,
                                     bound_by=by)
        print(f"  time attn causal (1,{s},32,{d}): kernel {t:.4f} ms, "
              f"sdpa {tl:.4f} ms, bound {bb:.4f} ms ({by})")
    print(f"  time attn causal (1,{p},32,128): kernel {times['ms']:.4f} ms, "
          f"plain {times['plain_ms']:.4f} ms, sdpa "
          f"{times['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "mma_flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/mma_attention.cu",
            "replaces": "src/repro/kernels/mma_attention.py:193",
            "max_abs_err": worst, "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"(1,{p},32,128) causal bf16", **times,
            "other_shapes": extra}


def _mm_attention():
    """(name, q shape, k/v shape, flags) at the generation runs' shapes:
    whisper's encoder self attention (non-causal over the frames / 2
    encoder positions, 12 x 64 heads) and its decode cross attention (one
    query over those positions), and qwen2-vl's causal GQA prefill (28
    query heads over 4 kv heads of 128, 1024 vision + text positions)."""
    wb = MM_RUNS["whisper-small"]["batch"]
    enc = MM_RUNS["whisper-small"]["frames"] // 2
    qb = MM_RUNS["qwen2-vl-7b"]["batch"]
    qs = 1024 + MM_RUNS["qwen2-vl-7b"]["text_len"]
    return (
        (f"whisper encoder ({wb},{enc},12,64)", (wb, enc, 12, 64),
         (wb, enc, 12, 64), dict(causal=False)),
        (f"whisper decode cross Sq 1 x Sk {enc}", (wb, 1, 12, 64),
         (wb, enc, 12, 64), dict(causal=False)),
        (f"qwen2-vl prefill GQA 28/4 ({qb},{qs},28,128)", (qb, qs, 28, 128),
         (qb, qs, 4, 128), dict(causal=True)),
    )


MM_ATTENTION = _mm_attention()


def check_attn_case(torch, name, q, k, v, kw, failures):
    """One attention call against flash_attention_plain and, where it
    splits KV, against flash_attention_splitkv_plain too, each output
    within 2^-7 * max|v| and within its rounding budget (_report_attn);
    (max|err|, the kernel's output)."""
    from repro_torch.kernels import mma_attention as A

    got = A.mma_flash_attention(q, k, v, **kw)
    out_dtype = kw.get("out_dtype") or q.dtype
    budget = A.rounding_budget(q, k, v, **{
        f: kw[f] for f in ("causal", "q_offset", "window", "valid", "ep")
        if f in kw})
    want = A.flash_attention_plain(q, k, v, **kw)
    e = _report_attn(torch, name, got, want, v, budget, out_dtype,
                     failures)
    n_split, per = A.split_kv_plan(q.shape[2], q.shape[1], k.shape[1])
    if n_split > 1:
        want = A.flash_attention_splitkv_plain(q, k, v, n_split=n_split,
                                               per=per, **kw)
        e = max(e, _report_attn(
            torch, f"{name} vs split-KV plain ({n_split} x {per} blocks)",
            got, want, v, budget, out_dtype, failures))
    return e, got


def _report_attn(torch, name, got, want, v, budget, out_dtype, failures):
    # Two bounds, both must hold.  The kernel rounds the unnormalised P to
    # bf16 block by block, the plain version the normalised P once: each
    # weight differs by up to a bf16 half-ulp either way, so |err| <=
    # 2^-7 * max|v| per output, plus one ulp of a 16-bit store.  Tighter,
    # per output: its own rounding budget (mma_attention.rounding_budget:
    # 2u * sum p|v| and fp32 slack), plus one ulp of a 16-bit store at
    # |ref| and 2^-20 * max|ref| for the epilogue's fp32 arithmetic in
    # another order.
    got, want = got.float(), want.float()
    err = (got - want).abs()
    old = 2.0 ** -7 * v.float().abs().max() + bf16_ulp(torch, want)
    tol = budget + 2.0 ** -20 * want.abs().max()
    if out_dtype != torch.float32:
        tol = tol + (bf16_ulp(torch, want) if out_dtype == torch.bfloat16
                     else bf16_ulp(torch, want) / 8)
    ok = (bool(torch.isfinite(got).all()) and bool((err <= tol).all())
          and bool((err <= old).all()))
    e = err.max().item()
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: max|err| {e:.3e}, "
          f"max err/tol {(err / tol).max().item():.3f} (tol rounding "
          f"budget + 1 ulp, max budget {budget.max().item():.3e}); max "
          f"err/tol {(err / old).max().item():.3f} (tol 2^-7*max|v| + 1 "
          f"bf16 ulp)")
    if not ok:
        failures.append(name)
    return e


def _path_taken(wrapper, before) -> str:
    """The path(s) a wrapper's launches took since ``before`` (a copy of
    its ``launches_by_path``)."""
    return ",".join(p for p, n in wrapper.launches_by_path.items()
                    if n > before[p])


def check_depthwise_conv(torch, timer, failures):
    """K4 against its plain version: mamba2's causal conv at zamba2's and
    mamba2-130m's widths (conv_dim 4224 and 1792; prefill over the 256 + 3
    padded frames, decode over the 3-frame history + 1), then edge cases:
    strides, 2-D taps, a C that no vector width divides, bf16/f16 inputs
    and every epilogue."""
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_conv as K

    g = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    p, b = SERVE["prompt_len"], SERVE["batch"]
    silu = E.Epilogue(bias=True, activation="silu")
    # (name, image NHWC, KH, KW, stride, in dtype, epilogue, out dtype)
    cases = []
    for arch, c in (("zamba2", 4224), ("mamba2-130m", 1792)):
        cases += [(f"{arch} prefill", (1, 1, p + 3, c), 1, 4, (1, 1),
                   torch.float32, silu, torch.bfloat16),
                  (f"{arch} decode", (b, 1, 4, c), 1, 4, (1, 1),
                   torch.float32, silu, torch.bfloat16)]
    cases += [
        ("stride (2,3) 3x5 C=130 none f32", (2, 9, 37, 130), 3, 5, (2, 3),
         torch.float32, None, torch.float32),
        ("stride (1,2) C=77 bias bf16-in", (3, 1, 50, 77), 1, 4, (1, 2),
         torch.bfloat16, E.Epilogue(bias=True), torch.float32),
        ("2x3 C=33 bias+gelu f16", (2, 5, 20, 33), 2, 3, (1, 1),
         torch.float16, E.Epilogue(bias=True, activation="gelu"),
         torch.float16),
        ("C=4227 residual f32", (2, 1, 30, 4227), 1, 4, (1, 1),
         torch.float32, E.Epilogue(residual=True), torch.float32),
        ("C=131 bias+relu+res bf16", (2, 3, 11, 131), 2, 2, (1, 1),
         torch.bfloat16, E.Epilogue(bias=True, activation="relu",
                                    residual=True), torch.bfloat16),
    ]
    worst = 0.0
    for name, shape, kh, kw, stride, idt, ep, od in cases:
        n, h, w, c = shape
        oh, ow = (h - kh) // stride[0] + 1, (w - kw) // stride[1] + 1
        x = randn(*shape, dtype=idt)
        taps = randn(kh, kw, c, dtype=idt, scale=0.3)
        bias = randn(c) if ep is not None and ep.bias else None
        res = randn(n, oh, ow, c) if ep is not None and ep.residual else None
        kw_ = dict(stride=stride, out_dtype=od, ep=ep, bias=bias,
                   residual=res)
        before = dict(K.mma_depthwise_conv2d.launches_by_path)
        got = K.mma_depthwise_conv2d(x, taps, **kw_).float()
        want = K.mma_depthwise_conv2d_plain(x, taps, **kw_).float()
        taken = _path_taken(K.mma_depthwise_conv2d, before)
        worst = max(worst, _report_close(
            torch, f"depthwise {name} [{taken}]", got, want, od, failures))
    # Bit for bit at the main path's four shapes with no epilogue and an
    # f32 store: the same products and sums, each rounded on its own, in
    # the plain version's order.
    for name, shape, kh, kw, *_ in cases[:4]:
        x = randn(*shape)
        taps = randn(kh, kw, shape[-1], scale=0.3)
        before = dict(K.mma_depthwise_conv2d.launches_by_path)
        same = torch.equal(K.mma_depthwise_conv2d(x, taps),
                           K.mma_depthwise_conv2d_plain(x, taps))
        print(f"  [{'ok' if same else 'FAIL'}] depthwise {name} {shape} "
              f"[{_path_taken(K.mma_depthwise_conv2d, before)}], no "
              f"epilogue, f32 store: bit for bit equal to the plain version")
        if not same:
            failures.append(f"depthwise {name} not bit for bit")

    # Timing at zamba2's prefill conv: f32 frames (the F32GER policy cast)
    # in, bias + silu, bf16 out.  The library yardstick is cuDNN's
    # depthwise conv1d with bias (one call; silu is not part of it).
    c = 4224
    x = randn(1, 1, p + 3, c)
    taps, bias = randn(1, 4, c, scale=0.3), randn(c)
    kw_ = dict(out_dtype=torch.bfloat16, ep=silu, bias=bias)
    xc = x[:, 0].transpose(1, 2).contiguous()              # (N, C, L + 3)
    wc = taps[0].t().contiguous()[:, None]                  # (C, 1, 4)
    conv1d = torch.nn.functional.conv1d
    times = {name: timer(fn) for name, fn in (
        ("ms", lambda: K.mma_depthwise_conv2d(x, taps, **kw_)),
        ("plain_ms", lambda: K.mma_depthwise_conv2d_plain(x, taps, **kw_)),
        ("library_ms", lambda: conv1d(xc, wc, bias, groups=c)))}
    nbytes = x.numel() * 4 + taps.numel() * 4 + c * 4 + p * c * 2
    b_ms, b_by = bound_ms(nbytes, 2 * p * c * 4 + 4 * p * c, "f32")
    extra = {}
    for name, shape in (("zamba2 decode", (b, 1, 4, c)),
                        ("mamba2-130m prefill", (1, 1, p + 3, 1792)),
                        ("mamba2-130m decode", (b, 1, 4, 1792))):
        cc = shape[-1]
        x2, t2, b2 = randn(*shape), randn(1, 4, cc, scale=0.3), randn(cc)
        xc2 = x2[:, 0].transpose(1, 2).contiguous()
        wc2 = t2[0].t().contiguous()[:, None]
        kw2 = dict(out_dtype=torch.bfloat16, ep=silu, bias=b2)
        t = timer(lambda: K.mma_depthwise_conv2d(x2, t2, **kw2))
        tp = timer(lambda: K.mma_depthwise_conv2d_plain(x2, t2, **kw2))
        tl = timer(lambda: conv1d(xc2, wc2, b2, groups=cc))
        lo = shape[2] - 3
        bb, by = bound_ms(x2.numel() * 4 + t2.numel() * 4 + cc * 4
                          + shape[0] * lo * cc * 2,
                          shape[0] * lo * cc * 12, "f32")
        extra[name] = dict(ms=t, plain_ms=tp, library_ms=tl, bound_ms=bb,
                           bound_by=by)
        print(f"  time depthwise {name} {shape}: kernel {t:.4f} ms, plain "
              f"{tp:.4f} ms, cuDNN conv1d {tl:.4f} ms, bound {bb:.4f} ms "
              f"({by})")
    print(f"  time depthwise zamba2 prefill (1,1,{p + 3},{c}): kernel "
          f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, cuDNN "
          f"conv1d {times['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    return {"name": "mma_depthwise_conv2d", "route": "cuda",
            "source": "src/repro_torch/csrc/mma_conv.cu",
            "replaces": "src/repro/kernels/mma_conv.py:242",
            "max_abs_err": worst, "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"(1,1,{p + 3},{c}) x (1,4,{c}) f32 bias+silu -> bf16",
            **times, "other_shapes": extra}


def _report_conv(torch, name, got, want, out_dtype, failures) -> float:
    # The kernel sums its fp32 products in another order than the plain
    # version's single fp32 matmul: a 16-bit store is within one ulp of the
    # output dtype at |ref|, plus 1e-5*max|ref| where that sum-order noise
    # exceeds the tiny ulp of an output near zero; an f32 store within
    # 1e-4*max|ref|.
    err = (got - want).abs()
    scale = want.abs().max().item()
    if out_dtype == torch.float32:
        tol = torch.full_like(want, 1e-4 * scale)
        how = "1e-4*max|ref|"
    else:
        bits = 7 if out_dtype == torch.bfloat16 else 10
        mag = want.abs().clamp_min(torch.finfo(torch.float32).tiny)
        tol = torch.exp2(torch.floor(torch.log2(mag)) - bits) + 1e-5 * scale
        how = "1 ulp of the output dtype + 1e-5*max|ref|"
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol).all())
    e = err.max().item()
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: max|err| {e:.3e} "
          f"(tol {how}, max|ref| {scale:.3e})")
    if not ok:
        failures.append(name)
    return e


def check_conv2d(torch, timer, failures):
    """K3 against its plain version: the main path's three stems at their
    full shapes (whisper's conv1 and conv2 over 4 clips of 3000 mel
    frames, SAME-padded, bias + gelu; qwen2-vl's 14 x 14 stride-14 patch
    embed over 4 images of 448 x 448, bias), then edge cases: ragged F and
    OW, K fringes, a 3 x 3 stride-1 2-D conv, a residual epilogue, f16
    inputs, f32 (F32GER) inputs and a filter bank narrower than the
    tile; and times the three stems beside the plain version, one cuDNN
    conv2d on the same operands (channels-last, TF32 off) and the bound."""
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_conv as K

    g = torch.Generator(device="cuda").manual_seed(7)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    gelu = E.Epilogue(bias=True, activation="gelu")
    bias_only = E.Epilogue(bias=True)
    b, fr = MM_RUNS["whisper-small"]["batch"], MM_RUNS["whisper-small"][
        "frames"]
    qb = MM_RUNS["qwen2-vl-7b"]["batch"]
    # (name, image NHWC, filters HWIO, stride, in dtype, epilogue, out
    # dtype)
    path = [
        ("whisper conv1", (b, 1, fr + 2, 80), (1, 3, 80, 768), (1, 1), bf16,
         gelu, bf16),
        ("whisper conv2", (b, 1, fr + 1, 768), (1, 3, 768, 768), (1, 2),
         bf16, gelu, bf16),
        ("qwen2-vl patch embed", (qb, 448, 448, 3), (14, 14, 3, 3584),
         (14, 14), bf16, bias_only, bf16),
    ]
    edge = [
        ("ragged F=200 OW=37", (2, 1, 39, 64), (1, 3, 64, 200), (1, 1),
         bf16, gelu, bf16),
        ("K fringe C=3 5x5 stride 3, f32 out", (2, 31, 29, 3),
         (5, 5, 3, 100), (3, 3), bf16, bias_only, f32),
        ("3x3 stride 1 2-D + residual", (2, 20, 17, 32), (3, 3, 32, 96),
         (1, 1), bf16, E.Epilogue(residual=True), bf16),
        ("f16 inputs 2x2 stride 2 bias+relu", (2, 12, 12, 24),
         (2, 2, 24, 130), (2, 2), f16,
         E.Epilogue(bias=True, activation="relu"), f16),
        ("F32GER f32 inputs stride (1,2) bias+gelu+res", (2, 1, 300, 80),
         (1, 3, 80, 144), (1, 2), f32,
         E.Epilogue(bias=True, activation="gelu", residual=True), f32),
        ("F=64 C=5 scalar gather", (3, 1, 50, 5), (1, 4, 5, 64),
         (1, 1), bf16, None, bf16),
    ]
    worst = 0.0
    operands = {}
    for i, (name, shape, fshape, stride, idt, ep, od) in enumerate(
            path + edge):
        n, h, w, c = shape
        kh, kw, _, f = fshape
        oh, ow = (h - kh) // stride[0] + 1, (w - kw) // stride[1] + 1
        x = randn(*shape, dtype=idt)
        filt = randn(*fshape, dtype=idt, scale=(kh * kw * c) ** -0.5)
        bias = randn(f, dtype=f32) if ep is not None and ep.bias else None
        res = (randn(n, oh, ow, f, dtype=od)
               if ep is not None and ep.residual else None)
        kw_ = dict(stride=stride, out_dtype=od, ep=ep, bias=bias,
                   residual=res)
        before = dict(K.mma_conv2d.launches_by_path)
        got = K.mma_conv2d(x, filt, **kw_)
        taken = _path_taken(K.mma_conv2d, before)
        want = K.mma_conv2d_plain(x, filt, **kw_).float()
        worst = max(worst, _report_conv(
            torch, f"conv2d {name} {shape}x{fshape} s{stride} [{taken}]",
            got.float(), want, od, failures))
        if i < len(path):
            # A gathered panel read before it landed shows as a difference
            # between launches.
            same = all(torch.equal(K.mma_conv2d(x, filt, **kw_), got)
                       for _ in range(2))
            print(f"  [{'ok' if same else 'FAIL'}] conv2d {name}: three "
                  f"launches give the same bits")
            if not same:
                failures.append(f"conv2d {name} differs between launches")
        operands[name] = (x, filt, bias, kw_, od)

    def stem_times(name):
        x, filt, bias, kw_, od = operands[name]
        xc = x.permute(0, 3, 1, 2)                 # NCHW, channels-last
        wc = filt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = bias.to(x.dtype)
        conv2d = torch.nn.functional.conv2d
        times = {key: timer(fn, iters=5) for key, fn in (
            ("ms", lambda: K.mma_conv2d(x, filt, **kw_)),
            ("plain_ms", lambda: K.mma_conv2d_plain(x, filt, **kw_)),
            ("library_ms", lambda: conv2d(xc, wc, bc, stride=kw_["stride"])))}
        n, h, w, c = x.shape
        kh, kw, _, f = filt.shape
        m = n * ((h - kh) // kw_["stride"][0] + 1) * (
            (w - kw) // kw_["stride"][1] + 1)
        nbytes = (x.numel() * x.element_size() + filt.numel()
                  * filt.element_size() + f * 4 + m * f * od.itemsize)
        bb, by = bound_ms(nbytes, 2 * m * kh * kw * c * f, "bf16")
        print(f"  time conv2d {name} {tuple(x.shape)}x{tuple(filt.shape)}: "
              f"kernel {times['ms']:.4f} ms, plain {times['plain_ms']:.4f} "
              f"ms, cuDNN conv2d {times['library_ms']:.4f} ms, bound "
              f"{bb:.4f} ms ({by})")
        return dict(times, bound_ms=bb, bound_by=by)

    main = stem_times("whisper conv2")
    extra = {name: stem_times(name) for name in ("whisper conv1",
                                                 "qwen2-vl patch embed")}
    return {"name": "mma_conv2d", "route": "cuda",
            "source": "src/repro_torch/csrc/mma_conv.cu",
            "replaces": "src/repro/kernels/mma_conv.py:110",
            "max_abs_err": worst, **main,
            "shape": f"({b},1,{fr + 1},768) x (1,3,768,768) stride (1,2) "
                     f"bf16, bias+gelu -> bf16",
            "other_shapes": extra}


# ----------------------------------------------------------------------
# Phase 3: serve
# ----------------------------------------------------------------------

def expected_launches(cfg) -> dict:
    """Kernel launches per prefill and per decode step, from the code:
    dense layers run 4 attention GEMMs (q, k, v, o; in decode the new k/v
    projections take the place of apply_attention's) and 3 MLP GEMMs (2
    for whisper's plain MLP), and one flash attention in prefill only
    (decode attends over the ring on the eager path); qwen2-vl adds the
    vision projection GEMM and one dense conv (the patch embed) per
    prefill; whisper's 12 encoder layers add 6 GEMMs and one attention
    each and its stem two dense convs per prefill, and each decoder layer
    adds cross-attention's q and o GEMMs (its k and v in prefill) and one
    flash attention over the encoder positions, in prefill and in every
    decode step; mamba2 layers run in_proj, the four SSD products and
    out_proj in prefill, in_proj, the two decode products and out_proj in
    a decode step, and one depthwise conv in each; zamba2's shared block
    runs 8 GEMMs (in_proj, q, k, v, o, w1, w3, w2) after each group of
    ``shared_attn_every`` layers, and one flash attention in prefill only;
    the moe kind's leading dense layers run a dense layer's GEMMs, and
    each MoE layer 4 attention GEMMs, the router, the expert banks (w1,
    w3, w2: one batched product each) and the shared experts' MLP;
    plus the logits GEMM."""
    n = cfg.num_layers
    block = 4 + (3 if cfg.gated_mlp else 2)
    if cfg.family == "moe":
        fd = cfg.first_dense_layers
        mlp = 3 if cfg.gated_mlp else 2
        per_moe = 4 + 1 + mlp + (mlp if cfg.num_shared_experts else 0)
        gemm = block * fd + per_moe * (n - fd) + 1
        return {"prefill": {"mma_gemm": gemm, "mma_flash_attention": n},
                "decode": {"mma_gemm": gemm}}
    if cfg.family in ("dense", "vlm"):
        prefill = {"mma_gemm": block * n + 1, "mma_flash_attention": n}
        if cfg.vision_prefix:
            prefill["mma_gemm"] += 1
            prefill["mma_conv2d"] = 1
        return {"prefill": prefill, "decode": {"mma_gemm": block * n + 1}}
    if cfg.family == "audio":
        e = cfg.encoder_layers
        return {"prefill": {"mma_gemm": block * e + (block + 4) * n + 1,
                            "mma_flash_attention": e + 2 * n,
                            "mma_conv2d": 2},
                "decode": {"mma_gemm": (block + 2) * n + 1,
                           "mma_flash_attention": n}}
    groups = -(-n // cfg.shared_attn_every) if cfg.shared_attn_every else 0
    prefill = {"mma_gemm": 6 * n + 8 * groups + 1,
               "mma_depthwise_conv2d": n}
    if groups:
        prefill["mma_flash_attention"] = groups
    return {"prefill": prefill,
            "decode": {"mma_gemm": 4 * n + 8 * groups + 1,
                       "mma_depthwise_conv2d": n}}


def kernel_wrappers():
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G
    return {"mma_gemm": G.mma_gemm,
            "mma_flash_attention": A.mma_flash_attention,
            "mma_depthwise_conv2d": K.mma_depthwise_conv2d,
            "mma_conv2d": K.mma_conv2d}


# Per run: the GEMM's launches by path, and the distinct shapes the run
# gave the GEMM, the attention kernel and the depthwise conv (their
# wrappers' traces).
RECORDS: dict[str, dict] = {}


# The kernels whose wrappers count their launches by path.
BY_PATH = ("mma_gemm", "mma_conv2d", "mma_depthwise_conv2d")


def reset_counts(kernels):
    """Zero every launch count, and start the GEMM's, attention's and
    depthwise conv's traces, just before a run."""
    for fn in kernels.values():
        fn.launches = 0
    for name in BY_PATH:
        kernels[name].launches_by_path = dict.fromkeys(
            kernels[name].launches_by_path, 0)
    for name in TRACED:
        kernels[name].trace = []


# The kernels whose wrappers record the shapes they launch at.
TRACED = ("mma_gemm", "mma_flash_attention", "mma_depthwise_conv2d")


def take_records(arch, kernels):
    """Read the run's launches by path and shapes, just after it, and stop
    tracing."""
    RECORDS[arch] = {"by_path": {name: dict(kernels[name].launches_by_path)
                                 for name in BY_PATH}}
    for key, name in zip(("gemm", "attn", "dw"), TRACED):
        RECORDS[arch][key] = sorted(set(kernels[name].trace), key=str)
        kernels[name].trace = None


def check_main_paths(failures):
    """Every decode product (M = batch) with K >= 768 on the weight stream,
    every expert-bank product of deepseek-moe-16b (b = E experts of M <=
    64 capacity slots, in prefill and in decode) on the weight stream,
    every other prefill product of deepseek-7b, qwen2-vl-7b and
    deepseek-moe-16b on the wgmma tile, every one-query attention
    (whisper's decode cross-attention) on split-KV, every dense conv
    (whisper's and qwen2-vl's stems) on K3's wgmma kernel and every
    depthwise conv (mamba2's) on K4's vector path."""
    for arch, rec in RECORDS.items():
        bad = []
        for name, path in (("mma_conv2d", "wgmma"),
                           ("mma_depthwise_conv2d", "vector")):
            off = {p: v for p, v in rec["by_path"][name].items()
                   if p != path and v}
            if off:
                bad.append((name, off))
        banks = arch == MOE_RUN[0]
        for b, m, k, n, _, _, path in rec["gemm"]:
            if b == 1 and m <= 16 and k >= 768 and path != "stream":
                bad.append((m, k, n, path))
            if banks and b > 1 and path != "stream":
                bad.append((b, m, k, n, path))
            if (arch in ("deepseek-7b", "qwen2-vl-7b", MOE_RUN[0])
                    and b == 1 and m > 64 and path != "wgmma"):
                bad.append((m, k, n, path))
        if banks and not any(b > 1 for b, *_ in rec["gemm"]):
            bad.append("no expert-bank product")
        for shape in rec["attn"]:
            if shape[1] == 1 and shape[-1] < 2:
                bad.append(("attention", shape))
        print(f"  [{'ok' if not bad else 'FAIL'}] {arch}: launches by "
              f"path {rec['by_path']}; {len(rec['gemm'])} GEMM and "
              f"{len(rec['attn'])} attention shapes on the expected paths"
              + (f"; off path: {bad}" if bad else ""))
        if bad:
            failures.append(f"{arch} products off their path: {bad}")


def time_run_shapes(torch, entries, failures, runs):
    """Each distinct GEMM, attention and depthwise conv shape that the runs
    ``runs`` (keys of RECORDS) gave the kernels: the kernel held against
    its plain version at that shape (the GEMM and the depthwise conv at
    _report_close's tolerance, attention within its rounding budget,
    split-KV also against its own plain version), then its time, its
    path, the library call's time and the bound.  A shape an earlier call
    held and timed only gains the runs' names."""
    from repro_torch.core import precision
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(4)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kind = {torch.bfloat16: "bf16", torch.float16: "f16",
            torch.float32: "f32"}
    ger = {torch.bfloat16: precision.Ger.BF16GER2,
           torch.float16: precision.Ger.F16GER2,
           torch.float32: precision.Ger.F32GER}
    shapes = {"gemm": {}, "attn": {}, "dw": {}}
    for arch in runs:
        for what, found in shapes.items():
            for s in RECORDS[arch][what]:
                found.setdefault(s, []).append(arch)
    by_name = {e["name"]: e for e in entries}
    done = {name: by_name[name].setdefault("run_shapes", {}) for name in
            ("mma_gemm", "mma_flash_attention", "mma_depthwise_conv2d")}
    errs = dict.fromkeys(done, 0.0)

    def seen(name, key, archs):
        if key in done[name]:
            done[name][key]["runs"] += archs
            return True
        return False

    gemm_out = done["mma_gemm"]
    for (b, m, k, n, dt, od, path), archs in sorted(shapes["gemm"].items(),
                                                    key=str):
        key = f"{b}x{m}x{k}x{n} {str(dt)[6:]} -> {str(od)[6:]}"
        if seen("mma_gemm", key, archs):
            continue
        lead = (b,) if b > 1 else ()
        x = torch.randn(lead + (m, k), generator=g, device="cuda").to(dt)
        y = (torch.randn(lead + (k, n), generator=g, device="cuda")
             * k ** -0.5).to(dt)
        kw = dict(kind=ger[dt], out_dtype=od)
        errs["mma_gemm"] = max(errs["mma_gemm"], _report_close(
            torch, f"gemm {key} [{path}]", G.mma_gemm(x, y, **kw).float(),
            G.mma_gemm_plain(x, y, **kw).float(), od, failures))
        t = timer(lambda: G.mma_gemm(x, y, **kw), iters=5)
        tl = timer(lambda: torch.matmul(x, y), iters=5)
        bb, by = bound_ms(b * ((m * k + k * n) * dt.itemsize
                               + m * n * od.itemsize),
                          2 * b * m * n * k, kind[dt])
        gemm_out[key] = dict(path=path, ms=t, library_ms=tl, bound_ms=bb,
                             bound_by=by, runs=archs)
        print(f"  time gemm {key} [{path}] ({', '.join(archs)}): kernel "
              f"{t:.4f} ms, torch.matmul {tl:.4f} ms, bound {bb:.4f} ms "
              f"({by}), {bb / t:.2f} of bound")
        del x, y
    attn_out = done["mma_flash_attention"]
    for shape, archs in sorted(shapes["attn"].items(), key=str):
        b, sq, sk, h, kvh, d, dt, causal, q_off, window, has_valid, ns = shape
        key = (f"({b},{sq},{h},{d}) over ({sk},{kvh}) causal={causal} "
               f"q_offset={q_off} window={window} valid={has_valid}")
        if seen("mma_flash_attention", key, archs):
            continue
        q = torch.randn((b, sq, h, d), generator=g, device="cuda").to(dt)
        k = torch.randn((b, sk, kvh, d), generator=g, device="cuda").to(dt)
        v = torch.randn((b, sk, kvh, d), generator=g, device="cuda").to(dt)
        valid = (torch.ones((b, sk), dtype=torch.bool, device="cuda")
                 if has_valid else None)
        kw = dict(causal=causal, q_offset=q_off, window=window, valid=valid)
        e, _ = check_attn_case(torch, f"attn {key}", q, k, v, kw, failures)
        errs["mma_flash_attention"] = max(errs["mma_flash_attention"], e)
        t = timer(lambda: A.mma_flash_attention(q, k, v, **kw), iters=5)
        qt, kt, vt = (z.transpose(1, 2) for z in (
            q, k.repeat_interleave(h // kvh, 2),
            v.repeat_interleave(h // kvh, 2)))
        # SDPA's flash path where is_causal says it all, else its mask
        mask, is_causal = None, causal and q_off == 0 and sq == sk \
            and window is None
        if (causal or window is not None) and not is_causal:
            qp = torch.arange(sq, device="cuda")[:, None] + q_off
            kp = torch.arange(sk, device="cuda")[None, :]
            mask = torch.ones((sq, sk), dtype=torch.bool, device="cuda")
            if causal:
                mask &= qp >= kp
            if window is not None:
                mask &= qp - kp < window
        tl = timer(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                is_causal=is_causal), iters=5)
        pairs = A.attn_live_pairs(sq, sk, causal=causal, q_offset=q_off,
                                  window=window)
        bb, by = bound_ms(2 * (2 * b * sq * h * d + 2 * b * sk * kvh * d),
                          4 * d * b * h * pairs, kind[dt])
        attn_out[key] = dict(path="split-kv" if ns > 1 else "tile", ms=t,
                             library_ms=tl, bound_ms=bb, bound_by=by,
                             runs=archs)
        print(f"  time attn {key} [{attn_out[key]['path']}] "
              f"({', '.join(archs)}): kernel {t:.4f} ms, sdpa {tl:.4f} ms, "
              f"bound {bb:.4f} ms ({by}), {bb / t:.2f} of bound")
    dw_out = done["mma_depthwise_conv2d"]
    for shape, archs in sorted(shapes["dw"].items(), key=str):
        (n, h, w, c), (kh, kw_), stride, dt, od, act, has_b, has_r, path = \
            shape
        oh, ow = (h - kh) // stride[0] + 1, (w - kw_) // stride[1] + 1
        key = (f"({n},{h},{w},{c}) x ({kh},{kw_}) stride {stride} "
               f"{str(dt)[6:]} -> {str(od)[6:]} bias={has_b} act={act} "
               f"residual={has_r}")
        if seen("mma_depthwise_conv2d", key, archs):
            continue
        x = torch.randn((n, h, w, c), generator=g, device="cuda").to(dt)
        taps = (torch.randn((kh, kw_, c), generator=g, device="cuda")
                * 0.3).to(dt)
        bias = (torch.randn((c,), generator=g, device="cuda")
                if has_b else None)
        res = (torch.randn((n, oh, ow, c), generator=g, device="cuda")
               if has_r else None)
        ep = (E.Epilogue(bias=has_b, activation=act, residual=has_r)
              if has_b or act or has_r else None)
        kw = dict(stride=stride, out_dtype=od, ep=ep, bias=bias,
                  residual=res)
        errs["mma_depthwise_conv2d"] = max(
            errs["mma_depthwise_conv2d"], _report_close(
                torch, f"depthwise {key} [{path}]",
                K.mma_depthwise_conv2d(x, taps, **kw).float(),
                K.mma_depthwise_conv2d_plain(x, taps, **kw).float(), od,
                failures))
        t = timer(lambda: K.mma_depthwise_conv2d(x, taps, **kw), iters=5)
        tp = timer(lambda: K.mma_depthwise_conv2d_plain(x, taps, **kw),
                   iters=5)
        # cuDNN's grouped conv2d with bias (the activation and residual
        # are not part of it)
        xc = x.permute(0, 3, 1, 2).contiguous()
        wc = taps.permute(2, 0, 1)[:, None].contiguous()
        tl = timer(lambda: torch.nn.functional.conv2d(
            xc, wc, None if bias is None else bias.to(dt), stride=stride,
            groups=c), iters=5)
        outs = n * oh * ow * c
        bb, by = bound_ms(x.numel() * dt.itemsize + taps.numel()
                          * dt.itemsize + (c * 4 if has_b else 0)
                          + (outs * 4 if has_r else 0) + outs * od.itemsize,
                          2 * outs * kh * kw_ + (4 * outs if act else 0),
                          "f32")
        dw_out[key] = dict(path=path, ms=t, plain_ms=tp, library_ms=tl,
                           bound_ms=bb, bound_by=by, runs=archs)
        print(f"  time depthwise {key} [{path}] ({', '.join(archs)}): "
              f"kernel {t:.4f} ms, plain {tp:.4f} ms, cuDNN conv2d "
              f"{tl:.4f} ms, bound {bb:.4f} ms ({by}), {bb / t:.2f} of "
              f"bound")
    for name, e in errs.items():
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], e)
    del timer


def serve(torch, failures, arch, settings, num_layers=None):
    """Serve ``arch`` with random bf16 weights from seed 0 through
    ``serve_loop``, every kernel's launch count reset just before and read
    just after; then the served model's prefill and decode logits on the
    kernel backend against the eager torch backend."""
    import dataclasses

    from repro_torch.configs import get as get_arch
    from repro_torch.core import facility
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M

    cfg = get_arch(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
        print(f"  depth cut: num_layers {num_layers} (of "
              f"{get_arch(arch).num_layers}); widths unchanged")
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nparam = sum(t.numel() for t in model.parameters())
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.num_heads}x{cfg.head_dim}, d_ff {cfg.d_ff}, ssm "
          f"state {cfg.ssm_state}, vocab {cfg.vocab_size}: "
          f"{nparam / 1e9:.3f} B params (projections bf16), init "
          f"{time.perf_counter() - t0:.1f} s")
    want = expected_launches(cfg)
    kernels = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    with facility.configure(facility.FacilityConfig(device="cuda")):
        reset_counts(kernels)
        stats = S.serve_loop(cfg, model, **settings)
        launches = {name: fn.launches for name, fn in kernels.items()}
        take_records(arch, kernels)
    print(f"  serve {settings}: {json.dumps(stats)}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; launches in the serving run: {launches}")
    print(f"  expected per prefill: {want['prefill']}; per decode step: "
          f"{want['decode']}")
    # The counts follow from the calls: every request is one prefill, and
    # the GEMM count then gives the number of decode steps, which must
    # explain the other kernels' counts too.
    pre = stats["completed"]
    steps = (launches["mma_gemm"] - pre * want["prefill"]["mma_gemm"]) / \
        want["decode"]["mma_gemm"]
    model_counts = {k: pre * want["prefill"].get(k, 0)
                    + steps * want["decode"].get(k, 0) for k in kernels}
    print(f"  {pre} prefills + {steps:g} decode steps give {model_counts}: "
          f"{'matches' if model_counts == launches else 'DIFFERS FROM'} the "
          f"counts")
    if model_counts != launches:
        failures.append(f"{arch} launch counts {launches} differ from the "
                        f"per-call model {model_counts}")
    for name in want["prefill"]:
        if launches[name] <= 0:
            failures.append(f"{name} never launched while serving {arch}")
    if stats["completed"] != settings["n_requests"]:
        failures.append(f"served {stats['completed']} of "
                        f"{settings['n_requests']} {arch} requests")

    # The served model's output against the eager torch backend: a prompt
    # through prefill, then one decode step.  The bound is the larger of
    # 2e-2 and twice the model's own bf16 noise (the torch backend's bf16
    # logits against its F32GER/f32 ones): rounding flips compound over
    # the layers, and a wrong kernel gives a relative L2 of ~1.
    g = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, 64), generator=g,
                           device="cuda", dtype=torch.int32)
    modes = {"kernel": dict(backend="kernel"), "torch": dict(backend="torch"),
             "f32": dict(backend="torch", ger=facility.Ger.F32GER,
                         out_dtype=torch.float32)}
    outs, routes = {}, {}
    for mode, kw in modes.items():
        with facility.configure(facility.FacilityConfig(device="cuda", **kw)), \
                recording_routes(routes.setdefault(mode, [])):
            last, _ = M.prefill(model, {"tokens": prompt}, cfg)
            cache = M.init_cache(cfg, 2, 64, device="cuda",
                                 dtype=kw.get("out_dtype", torch.bfloat16))
            step, _ = M.decode_step(model, cache, prompt[:, :1].expand(2, 1),
                                    cfg)
        outs[mode] = (last.float(), step[:, -1].float())

    check_logits(torch, failures, arch, cfg, outs)
    if routes["kernel"]:
        print_routing(arch, routes)
    if cfg.family == "ssm":
        check_handoff(torch, failures, model, cfg, prompt)
    return stats, launches, (model, cfg)


@contextlib.contextmanager
def recording_routes(into):
    """Append each MoE layer's top-k expert ids (``models.moe.route``'s
    third output, (T, k)) to the list ``into`` while the block runs."""
    from repro_torch.models import moe as MOE

    real = MOE.route

    def route(p, xf, cfg):
        out = real(p, xf, cfg)
        into.append(out[2])
        return out

    MOE.route = route
    try:
        yield
    finally:
        MOE.route = real


def print_routing(arch, routes):
    """The share of (token, choice) pairs of the logits check's prefill
    and decode step that the kernel backend routed to an expert the torch
    backend also chose for that token (and the torch backend's bf16 to
    one its f32 chose), over every MoE layer, and in the first and the
    last MoE layer of the prefill.  The router's output is discontinuous:
    a near tie that two sums in another order break differently swaps an
    expert, and the layers' inputs drift apart with depth."""
    def alike(x, y):
        return (x[..., :, None] == y[..., None, :]).any(-1)

    def share(a, b, layers=None):
        pairs = list(zip(routes[a], routes[b]))
        pairs = pairs if layers is None else [pairs[i] for i in layers]
        return (sum(int(alike(x, y).sum()) for x, y in pairs)
                / sum(x.numel() for x, _ in pairs))

    total = sum(x.numel() for x in routes["kernel"])
    n_moe = len(routes["kernel"]) // 2       # the prefill's, then decode's
    print(f"  {arch} routing: kernel vs torch backend "
          f"{share('kernel', 'torch'):.6f} of {total} (token, choice) pairs "
          f"alike; first MoE layer {share('kernel', 'torch', [0]):.6f}, "
          f"last {share('kernel', 'torch', [n_moe - 1]):.6f}; torch bf16 vs "
          f"f32 {share('torch', 'f32'):.6f}")


def check_logits(torch, failures, arch, cfg, outs):
    """``outs[mode]`` = (prefill logits, decode logits) for the modes
    kernel, torch (bf16) and f32: the kernel backend's against the torch
    backend's, relative L2 below the larger of 2e-2 and twice the model's
    own bf16 noise (the torch backend's bf16 logits against its f32
    ones)."""
    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    for what, i in (("prefill logits", 0), ("decode logits", 1)):
        got, want = outs["kernel"][i], outs["torch"][i]
        noise = rel(want, outs["f32"][i])
        tol = max(2e-2, 2 * noise)
        r = rel(got, want)
        ok = (bool(torch.isfinite(got).all())
              and got.shape == (want.shape[0], cfg.vocab_size) and r < tol)
        print(f"  [{'ok' if ok else 'FAIL'}] {arch} {what} "
              f"{tuple(got.shape)}: kernel vs torch backend rel L2 {r:.3e} "
              f"(tol {tol:.3e}; torch bf16 vs f32 {noise:.3e})")
        if not ok:
            failures.append(f"{arch} {what}")


def check_handoff(torch, failures, model, cfg, prompt):
    """The ssm kind's exact per-slot handoff: a slot's first decode logits
    after ``_scatter_prefill`` into a batch of 4 equal a batch-1 decode
    from the same prefill state (within 2^-8 of max|logit|, one bf16 ulp:
    each row's products are the same, only the batch around it differs)."""
    from repro_torch.core import facility
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M

    g = torch.Generator(device="cuda").manual_seed(6)
    b, slot = SERVE["batch"], 2
    with facility.configure(facility.FacilityConfig(device="cuda")):
        _, pre = M.prefill(model, {"tokens": prompt}, cfg)
        tok = prompt[:, -1:]
        many = torch.randint(0, cfg.vocab_size, (b, 1), generator=g,
                             device="cuda", dtype=torch.int32)
        many[slot] = tok[0]
        cache = S._scatter_prefill(M.init_cache(cfg, b, 64, device="cuda"),
                                   pre, slot)
        got, _ = M.decode_step(model, cache, many, cfg)
        one = S._scatter_prefill(M.init_cache(cfg, 1, 64, device="cuda"),
                                 pre, 0)
        want, _ = M.decode_step(model, one, tok, cfg)
    got, want = got[slot, -1].float(), want[0, -1].float()
    err = (got - want).abs().max().item()
    tol = 2.0 ** -8 * want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= tol
    print(f"  [{'ok' if ok else 'FAIL'}] {cfg.name} handoff: slot {slot} of "
          f"{b} after _scatter_prefill vs batch-1 decode: max|err| "
          f"{err:.3e} (tol 2^-8*max|ref| = {tol:.3e})")
    if not ok:
        failures.append(f"{cfg.name} prefill handoff")


def serve_steps(torch, model, cfg, settings):
    """A serving run's step closures: a batch-1 prefill of ``prompt_len``
    random tokens and a batch-``batch`` decode step on a fresh cache."""
    from repro_torch.models import model as M

    b, p = settings["batch"], settings["prompt_len"]
    g = torch.Generator(device="cuda").manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (1, p), generator=g,
                           device="cuda", dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=g,
                           device="cuda", dtype=torch.int32)
    state = {"cache": M.init_cache(cfg, b, p * 4, device="cuda")}

    def decode():
        _, state["cache"] = M.decode_step(model, state["cache"], tokens, cfg)

    return (lambda: M.prefill(model, {"tokens": prompt}, cfg), decode,
            f"prefill (1 x {p}), decode step (batch {b})")


def step_breakdown(torch, cfg, prefill, decode, what):
    """Where one prefill and one decode step spend their time: host-clock
    step times (synchronised, median), and a torch.profiler trace of each
    for device time by kernel and the device's idle share of the step."""
    from repro_torch.core import facility

    def host_ms(fn, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    with facility.configure(facility.FacilityConfig(device="cuda")):
        prefill_ms = host_ms(prefill, 3)
        decode_ms = host_ms(decode, 5)
        print(f"  {cfg.name} {what}: {prefill_ms:.2f} ms, {decode_ms:.2f} ms "
              f"(host clock, median)")
        for step, fn, step_ms in (("prefill", prefill, prefill_ms),
                                  ("decode step", decode, decode_ms)):
            profile_step(torch, step, fn, step_ms)


# The __global__ functions of src/repro_torch/csrc, as the profiler names
# them.
PORT_KERNELS = ("gemm_stream_kernel", "gemm_wgmma_kernel",
                "gemm_wmma_kernel", "gemm_f32_kernel", "flash_wgmma_kernel",
                "flash_combine_kernel", "depthwise_vec_kernel",
                "depthwise_conv_kernel", "conv_wgmma_kernel",
                "conv_wmma_kernel", "conv_f32_kernel")


def profile_step(torch, step, fn, step_ms):
    """One call of ``fn`` under torch.profiler: device busy time by kernel
    and the device's idle share, against the unprofiled ``step_ms`` too
    (the profiler slows the host)."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel rows only: an operator row (aten::copy_, ...) repeats the
    # device time of the kernels it launched.
    rows = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = max(getattr(ev, "device_time_total", 0),
                     getattr(ev, "self_device_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"  profiler: no device time recorded for the {step} (not "
              f"measured)")
        return None
    print(f"  profiled {step}: wall {wall_ms:.2f} ms, device busy "
          f"{busy:.2f} ms; device idle share {max(0.0, 1 - busy / step_ms):.3f}"
          f" of the unprofiled {step} ({max(0.0, 1 - busy / wall_ms):.3f} of "
          f"the profiled one)")
    # the ten largest rows, then every other row of the port's own kernels
    rows.sort(reverse=True)
    shown = rows[:10] + [r for r in rows[10:] if re.split(r"[<(]", r[2])[
        0].split()[-1] in PORT_KERNELS]
    for ms, count, key in shown:
        print(f"    {ms:8.3f} ms {100 * ms / busy:5.1f}%  x{count:<4d} "
              f"{key[:90]}")
    return busy, max(0.0, 1 - busy / step_ms)


def mm_batch(cfg, settings, batch):
    """A generation run's prefill batch from the port's synthetic_batch:
    whisper, ``batch`` clips of ``frames`` mel frames and the first
    ``prompt_len`` decoder tokens; qwen2-vl, ``batch`` images of its patch
    grid and ``text_len`` text tokens after the vision prefix, with their
    M-RoPE positions.  Returns (device batch, the decode cache's
    seq_len)."""
    from repro_torch.data import pipeline

    if cfg.is_enc_dec:
        host = pipeline.synthetic_batch(cfg, batch=batch,
                                        seq=settings["frames"], step=0)
        host["tokens"] = host["tokens"][:, :settings["prompt_len"]]
        seq_len = settings["frames"]
    else:
        seq = cfg.vision_prefix + settings["text_len"]
        host = pipeline.synthetic_batch(cfg, batch=batch, seq=seq, step=0)
        # room for the generated tokens and the profiled steps after them
        seq_len = seq + settings["gen_len"] + 16
    del host["labels"]
    return pipeline.device_batch(host, "cuda"), seq_len


def handoff(torch, cfg, pre, batch, seq_len, dtype):
    """The decode cache after a P-token prefill, on the reference's cache
    layout: prefill's k/v in ring slots [0, P), ``pos[:P] = arange(P)``,
    ``cur = P``; whisper's ``cross_kv`` in ``cross_k``/``cross_v``."""
    from repro_torch.models import model as M

    cache = M.init_cache(cfg, batch, seq_len, device="cuda", dtype=dtype)
    k, v = pre["kv"]
    p = k.shape[2]
    cache["k"][:, :, :p] = k
    cache["v"][:, :, :p] = v
    cache["pos"][:p] = torch.arange(p, dtype=torch.int32, device="cuda")
    cache["cur"] = p
    if "cross_kv" in pre:
        cache["cross_k"].copy_(pre["cross_kv"][0])
        cache["cross_v"].copy_(pre["cross_kv"][1])
    return cache


def generate(torch, failures, arch, settings):
    """Generate with ``arch`` (random bf16 weights from seed 0) through
    ``prefill`` and ``decode_step``: a batch prefill, the cache handoff and
    ``gen_len`` greedy decode steps, every kernel's launch count reset just
    before and read just after and held to the per-call model; then the
    prefill and decode logits of the first request on the kernel backend
    against the eager torch backend.  Returns the counts and the step
    closures for ``step_breakdown``."""
    from repro_torch.configs import get as get_arch
    from repro_torch.core import facility
    from repro_torch.models import model as M

    cfg = get_arch(arch)
    b, gen = settings["batch"], settings["gen_len"]
    t0 = time.perf_counter()
    model = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nparam = sum(t.numel() for t in model.parameters())
    print(f"  {cfg.name}: {cfg.num_layers} layers (+{cfg.encoder_layers} "
          f"encoder), d_model {cfg.d_model}, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads}x{cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}: {nparam / 1e9:.3f} B params (projections "
          f"bf16, stems fp32), init {time.perf_counter() - t0:.1f} s")
    batch, seq_len = mm_batch(cfg, settings, b)
    print(f"  batch: {({k: tuple(v.shape) for k, v in batch.items()})}")
    want = expected_launches(cfg)
    kernels = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    with facility.configure(facility.FacilityConfig(device="cuda")):
        reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, pre = M.prefill(model, batch, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache = handoff(torch, cfg, pre, b, seq_len, torch.bfloat16)
        del pre
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        out = [tok]
        finite = torch.isfinite(last).all()       # read once, after the run
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(gen):
            logits, cache = M.decode_step(model, cache, tok, cfg)
            finite &= torch.isfinite(logits).all()
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            out.append(tok)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = {name: fn.launches for name, fn in kernels.items()}
        take_records(arch, kernels)
        finite = bool(finite)
    tokens = torch.cat(out, dim=1)
    print(f"  generated {tuple(tokens.shape)} tokens: prefill "
          f"{(t1 - t0) * 1e3:.2f} ms, {gen} decode steps "
          f"{(t3 - t2) * 1e3:.2f} ms ({(t3 - t2) * 1e3 / gen:.2f} ms a step, "
          f"{b * gen / (t3 - t2):.1f} tok/s), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; first "
          f"request's tokens {tokens[0, :8].tolist()}...")
    model_counts = {k: want["prefill"].get(k, 0) + gen * want["decode"].get(
        k, 0) for k in kernels}
    print(f"  launches in the run: {launches}; 1 prefill + {gen} decode "
          f"steps give {model_counts}: "
          f"{'matches' if model_counts == launches else 'DIFFERS FROM'} the "
          f"counts")
    if model_counts != launches:
        failures.append(f"{arch} launch counts {launches} differ from the "
                        f"per-call model {model_counts}")
    for name in set(want["prefill"]) | set(want["decode"]):
        if launches[name] <= 0:
            failures.append(f"{name} never launched while generating {arch}")
    ok = (finite and tokens.shape == (b, gen + 1)
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()))
    print(f"  [{'ok' if ok else 'FAIL'}] {arch}: every logit finite, "
          f"tokens in range")
    if not ok:
        failures.append(f"{arch} generation output")

    # The first request through the three modes: prefill, the handoff and
    # one decode step of the prompt's last token.
    one = {k: (v[:, :1] if k == "positions" else v[:1])
           for k, v in batch.items()}
    modes = {"kernel": dict(backend="kernel"), "torch": dict(backend="torch"),
             "f32": dict(backend="torch", ger=facility.Ger.F32GER,
                         out_dtype=torch.float32)}
    outs = {}
    for mode, kw in modes.items():
        with facility.configure(facility.FacilityConfig(device="cuda", **kw)):
            first, pre = M.prefill(model, one, cfg)
            c1 = handoff(torch, cfg, pre, 1, seq_len,
                         kw.get("out_dtype", torch.bfloat16))
            del pre
            step, _ = M.decode_step(model, c1, one["tokens"][:, -1:], cfg)
        outs[mode] = (first.float(), step[:, -1].float())
        del c1
    check_logits(torch, failures, arch, cfg, outs)
    del outs

    state = {"cache": cache, "tok": tok}

    def decode():
        _, state["cache"] = M.decode_step(model, state["cache"],
                                          state["tok"], cfg)

    steps = (lambda: M.prefill(model, batch, cfg), decode,
             f"prefill (batch {b}), decode step (batch {b})")
    return launches, (cfg, *steps)


# ----------------------------------------------------------------------
# Phase 5: train
# ----------------------------------------------------------------------

def expected_train_launches(cfg) -> dict:
    """Kernel launches per train step, from the code: the forward's, which
    are a prefill's over the batch (``expected_launches``); then the
    backward: two GEMMs (dX, dY) per forward GEMM and one recompute of Z
    per GEMM with a fused activation (the w1 of each dense layer's MLP,
    of whisper's encoder and decoder MLPs, of each MoE layer's expert bank
    and shared MLP, or of the hybrid shared block's at each group);
    attention and both convs launch in the forward only (their backward
    recomputes through the torch lowering)."""
    fwd = dict(expected_launches(cfg)["prefill"])
    n = cfg.num_layers
    if cfg.family in ("dense", "vlm"):
        activated = n
    elif cfg.family == "audio":          # every encoder and decoder MLP
        activated = cfg.encoder_layers + n
    elif cfg.family == "moe":            # w1 of each MLP and expert bank
        fd = cfg.first_dense_layers
        activated = fd + (n - fd) * (2 if cfg.num_shared_experts else 1)
    else:
        activated = (-(-n // cfg.shared_attn_every)
                     if cfg.shared_attn_every else 0)
    return {"forward_gemm": fwd["mma_gemm"],
            **fwd, "mma_gemm": 3 * fwd["mma_gemm"] + activated}


def check_train_grads(torch, failures, arch, cfg, model, batch):
    """Step 1's loss and every parameter's gradient on the kernel backend
    against the eager torch backend: the loss within 2e-2 relative, each
    gradient's relative L2 below the larger of 5e-2 and twice that
    parameter's own bf16 noise (the torch backend's BF16GER2 gradient
    against its F32GER/f32 one), as the logits are held."""
    from repro_torch.core import facility
    from repro_torch.train import steps as S

    def rel(a, b):
        return ((a.float() - b.float()).norm()
                / b.float().norm().clamp_min(1e-30)).item()

    def run(**kw):
        with facility.configure(facility.FacilityConfig(device="cuda",
                                                        **kw)):
            loss, _, grads = S.loss_and_grads(cfg, model, batch)
        return loss.item(), grads

    t0 = time.perf_counter()
    loss_t, want = run(backend="torch")
    loss_f, f32 = run(backend="torch", ger=facility.Ger.F32GER,
                      out_dtype=torch.float32)
    noise = {k: rel(want[k], f32[k]) for k in want}
    del f32
    loss_k, got = run(backend="kernel")
    worst = sorted(((rel(got[k], want[k]) / max(5e-2, 2 * noise[k]),
                     rel(got[k], want[k]), noise[k], k) for k in got),
                   reverse=True)
    del got, want
    ok_loss = (abs(loss_k - loss_t) <= 2e-2 * abs(loss_t)
               and bool(torch.isfinite(torch.tensor(loss_k))))
    ok = ok_loss and worst[0][0] < 1
    print(f"  [{'ok' if ok else 'FAIL'}] {arch} step-1 loss kernel "
          f"{loss_k:.6f}, torch {loss_t:.6f} (f32 {loss_f:.6f}); "
          f"{len(worst)} gradients within max(5e-2, 2 x bf16 noise) of the "
          f"torch backend; worst rel L2 / tol {worst[0][0]:.3f} "
          f"({time.perf_counter() - t0:.1f} s)")
    for q, r, nz, k in worst[:3]:
        print(f"    {k}: rel L2 {r:.3e} (bf16 noise {nz:.3e})")
    if not ok:
        failures.append(f"{arch} step-1 loss or gradients")


def host_like(torch, tree):
    """Empty CPU tensors in ``tree``'s structure (a module's parameters
    in a CPU copy of the module), for a checkpoint to restore into."""
    import copy
    if isinstance(tree, torch.nn.Module):
        memo = {id(p): torch.nn.Parameter(torch.empty(p.shape,
                                                      dtype=p.dtype),
                                          requires_grad=False)
                for p in tree.parameters()}
        return copy.deepcopy(tree, memo)
    if isinstance(tree, dict):
        return {k: host_like(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_like(torch, v) for v in tree)
    return torch.empty(tree.shape, dtype=tree.dtype)


def check_checkpoint(torch, failures, arch, state, step):
    """A Checkpointer save of the train state and a restore into host
    tensors of its structure: every leaf back bit for bit."""
    import tempfile

    from repro_torch.checkpoint import checkpoint as C

    with tempfile.TemporaryDirectory() as d:
        ck = C.Checkpointer(d)
        t0 = time.perf_counter()
        ck.save(step, state)
        t1 = time.perf_counter()
        like = ck.restore(step, host_like(torch, state))
        t2 = time.perf_counter()
        flat, back = C._flatten(state), C._flatten(like)
        nbytes = sum(t.numel() * t.element_size() for _, t in flat)
        same = ([p for p, _ in flat] == [p for p, _ in back] and all(
            a.dtype == b.dtype and torch.equal(a.detach().cpu(), b)
            for (_, a), (_, b) in zip(flat, back)))
        del like, back
    print(f"  [{'ok' if same else 'FAIL'}] {arch} checkpoint of "
          f"{len(flat)} leaves, {nbytes / 2**30:.2f} GiB: save "
          f"{t1 - t0:.1f} s, restore {t2 - t1:.1f} s, bit for bit")
    if not same:
        failures.append(f"{arch} checkpoint round trip")


def train(torch, failures, arch, num_layers):
    """Train ``arch`` through ``launch.train.build`` (fp32 weights from
    seed 0, the default kernel backend) for ``TRAIN["steps"]`` steps on one
    repeated batch, every kernel's launch count reset just before the
    steps and read just after and held to ``expected_train_launches``;
    returns the counts."""
    import dataclasses

    from repro_torch.configs import get as get_arch
    from repro_torch.core import facility
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    from repro_torch.models import model as M

    cfg = get_arch(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
        print(f"  depth cut: num_layers {num_layers} (of "
              f"{get_arch(arch).num_layers}); widths unchanged")
    b, steps = TRAIN["batch"], TRAIN["steps"]
    s = TRAIN_SEQ.get(arch, TRAIN["seq"])
    lr = TRAIN_LR.get(arch, TRAIN["lr"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    make_state, make_step = T.build(cfg, lr=lr, total_steps=steps,
                                    weight_decay=0.0, seed=0, device="cuda")
    state, step = make_state(), make_step()
    model = state["params"]
    nparam = sum(t.numel() for t in model.parameters())
    batch = pipeline.device_batch(pipeline.synthetic_batch(
        cfg, batch=b, seq=s, step=0), "cuda")
    ntok = batch["tokens"].numel()
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {nparam / 1e9:.3f} B "
          f"fp32 parameters, init {time.perf_counter() - t0:.1f} s; batch "
          f"{({k: tuple(v.shape) for k, v in batch.items()})}, lr "
          f"{lr}, {steps} steps")
    check_train_grads(torch, failures, arch, cfg, model, batch)

    want = expected_train_launches(cfg)
    kernels = kernel_wrappers()
    torch.cuda.synchronize()
    reset_counts(kernels)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
    launches = {name: fn.launches for name, fn in kernels.items()}
    trace = list(kernels["mma_gemm"].trace)
    attn_trace = list(kernels["mma_flash_attention"].trace)
    take_records(f"{arch} train", kernels)
    losses = torch.stack(losses).tolist()
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = {k: v for k, v in want.items() if k != "forward_gemm"}
    model_counts = {k: steps * per_step.get(k, 0) for k in kernels}
    print(f"  losses {[round(x, 4) for x in losses]}; launches {launches}; "
          f"{steps} steps x {per_step} give {model_counts}: "
          f"{'matches' if model_counts == launches else 'DIFFERS FROM'} the "
          f"counts; GEMM by path "
          f"{RECORDS[f'{arch} train']['by_path']['mma_gemm']}")
    if model_counts != launches:
        failures.append(f"{arch} train launch counts {launches} differ from "
                        f"the per-call model {model_counts}")
    for name, n in per_step.items():
        if n and launches[name] <= 0:
            failures.append(f"{name} never launched while training {arch}")
    ok = (all(x == x and abs(x) != float("inf") for x in losses)
          and all(b < a for a, b in zip(losses[1:], losses[2:]))
          and losses[-1] <= (1 - TRAIN["fall"]) * losses[0])
    print(f"  [{'ok' if ok else 'FAIL'}] {arch}: loss finite, falling at "
          f"every step after the first update and by {TRAIN['fall']:.0%} "
          f"or more over the run ({losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{1 - losses[-1] / losses[0]:.1%})")
    if not ok:
        failures.append(f"{arch} training loss")
    # No backward product may leave the weight stream and the wgmma tile
    # where they take its shape (16-byte pitches, K >= 16): the WMMA and
    # fp32 tiles are for what they refuse.
    from repro_torch.core import tiling
    off = sorted({(bb, m, k, n) for bb, m, k, n, dt, _, path in trace
                  if path == "wmma" and k >= tiling.MIN_K
                  and (k * dt.itemsize) % 16 == 0
                  and (n * dt.itemsize) % 16 == 0})
    print(f"  [{'ok' if not off else 'FAIL'}] {arch}: every aligned "
          f"product on the weight stream or the wgmma tile"
          + (f"; on wmma: {off[:8]}" if off else ""))
    if off:
        failures.append(f"{arch} train products on the wmma tile: {off}")

    # Model FLOPs: 3x the forward's (the backward does twice its work):
    # its GEMMs (the first launches of the step) and its attention.
    from repro_torch.kernels import mma_attention as A
    fwd_gemm = sum(2 * bb * m * k * n for bb, m, k, n, *_ in
                   trace[:want["forward_gemm"]])
    fwd_attn = sum(4 * d * h * bb * A.attn_live_pairs(
        sq, sk, causal=causal, q_offset=qo, window=win)
        for bb, sq, sk, h, _, d, _, causal, qo, win, _, _ in
        attn_trace[:want.get("mma_flash_attention", 0)])
    step_ms = sorted(times)[len(times) // 2]
    flops = 3 * (fwd_gemm + fwd_attn)
    print(f"  {arch} train step: {step_ms:.2f} ms (host clock, median of "
          f"{steps}; {[round(t, 1) for t in times]}), {ntok / step_ms * 1e3:.0f}"
          f" tokens/s, model {flops / 1e12:.2f} TFLOP a step = "
          f"{flops / step_ms / 1e9:.1f} TFLOP/s ({flops / step_ms / 1e9 / 989:.3f}"
          f" of the 989 bf16 peak), peak device memory {peak:.2f} GiB")
    with facility.configure(facility.FacilityConfig(device="cuda")):
        prof = profile_step(torch, "train step",
                            lambda: step(state, batch), step_ms)
    check_checkpoint(torch, failures, arch, state, steps)
    del state, model, step, make_state, make_step
    torch.cuda.empty_cache()
    # The same steps from the same weights on the eager torch backend: each
    # step's loss within 2e-2 relative, as step 1's is held.
    make_state, make_step = T.build(cfg, lr=lr, total_steps=steps,
                                    weight_decay=0.0, seed=0, device="cuda",
                                    backend="torch")
    state, step = make_state(), make_step()
    eager = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        eager.append(metrics["loss"])
    eager = torch.stack(eager).tolist()
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, eager))
    ok = worst <= 2e-2
    print(f"  [{'ok' if ok else 'FAIL'}] {arch} the same steps on the eager "
          f"torch backend: losses {[round(x, 4) for x in eager]}; kernel "
          f"backend within {worst:.2e} relative (tol 2e-2)")
    if not ok:
        failures.append(f"{arch} loss curve against the torch backend")
    del state, step, make_state, make_step, batch
    return launches, dict(step_ms=step_ms, tokens_per_s=ntok / step_ms * 1e3,
                          tflops=flops / step_ms / 1e9, peak_gib=peak,
                          losses=losses,
                          busy_ms=prof[0] if prof else None,
                          idle=prof[1] if prof else None)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test runs on the card only")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False   # F32GER is true fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    failures: list[str] = []

    print("== phase 1: card and build", flush=True)
    card = card_line()
    print(f"  card: {card} ({torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"  built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s with {_build.nvcc()}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    print("== phase 2: kernels against their plain versions", flush=True)
    timer = Timer(torch)
    entries = [check_gemm(torch, timer, failures),
               check_attention(torch, timer, failures),
               check_depthwise_conv(torch, timer, failures),
               check_conv2d(torch, timer, failures)]
    del timer

    print("== phase 3: serve and generate", flush=True)
    by_run = {}
    for arch, settings, layers, profile in (
            (ARCH, SERVE, NUM_LAYERS, True),
            *((a, st, None, a == "zamba2-1.2b") for a, st in SSM_RUNS),
            (*MOE_RUN, None, True)):
        _, by_run[arch], (model, cfg) = serve(torch, failures, arch,
                                              settings, layers)
        if profile:
            step_breakdown(torch, cfg, *serve_steps(torch, model, cfg,
                                                    settings))
        del model
        torch.cuda.empty_cache()
    for arch, settings in MM_RUNS.items():
        by_run[arch], steps = generate(torch, failures, arch, settings)
        step_breakdown(torch, *steps)
        del steps
        torch.cuda.empty_cache()
    check_main_paths(failures)

    print("== phase 4: the runs' GEMM, attention and depthwise conv "
          "shapes, checked and timed", flush=True)
    time_run_shapes(torch, entries, failures, list(RECORDS))

    print("== phase 5: train", flush=True)
    for arch, layers in TRAIN_RUNS:
        by_run[f"{arch} train"], _ = train(torch, failures, arch, layers)
        torch.cuda.empty_cache()
    print("== phase 5: the train runs' GEMM (forward, dX, dW, recompute), "
          "attention and depthwise conv shapes, checked and timed",
          flush=True)
    time_run_shapes(torch, entries, failures,
                    [f"{arch} train" for arch, _ in TRAIN_RUNS])
    for e in entries:
        e["launches_by_run"] = {a: n[e["name"]] for a, n in by_run.items()}
        e["launches"] = sum(e["launches_by_run"].values())
        if e["name"] in BY_PATH:
            e["launches_by_path"] = {
                p: sum(r["by_path"][e["name"]][p] for r in RECORDS.values())
                for p in next(iter(RECORDS.values()))["by_path"][e["name"]]}

    print(f"== done in {time.perf_counter() - t_start:.1f} s", flush=True)
    if failures:
        fail(f"{len(failures)} check(s) failed: {failures}")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
