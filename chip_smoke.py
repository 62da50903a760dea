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
     and timed;
  6. the family table and its paths: the IMMA kernel (I8GER4, I4GER8,
     I16GER2) and the DMMA kernel (F64GER) against their plain versions
     at edge cases (ragged fringes, batch, every accumulate form with a
     full-range int32 seed, bias/relu/residual, gelu/silu for F64GER, out
     dtypes, I16GER2's wrap), integers bit for bit and F64GER within
     1e-15 * K * max|x| * max|y|; then, each run's launches reset just
     before and read just after and held to its path, DGEMM (F64GER,
     8192^2) and the integer families (8192^2, 4096^2) through
     ``facility.contract``, ``quant.qdot`` at deepseek-7b's MLP shapes
     (M = 4 and 1024, 4096 -> 11008; the two operand copies its spec
     makes counted and timed), ``blas3.complex_gemm`` at 4096^2 in
     complex64 and complex128 and a batched ``blas3.dft`` (N = 1024, 64 x
     128 columns) in f32 and f64 (four GEMM launches a call), against
     complex ``torch.matmul`` and a float64 fft, ``blas3.trsm`` (N = 4096,
     1024 right-hand sides, relative residual) and the saturating forms
     bit for bit against the ref lowering; each timed beside its plain
     version, a library yardstick and its bound;
  7. prepacked serving (``core.packing``: K1d, the GEMM's packed panel
     stream, and K3's packed filter stream), each model reused right
     after its phase-3 run: a copy of deepseek-7b packed in place
     (``prepack_params_for_serving``, min_size 1024) and served with
     phase 3's settings in turn with the natural model (natural, packed,
     packed, natural, natural, packed), every prefill and decode output (token ids and
     logits) of the first packed serve bit for bit phase 3's, each packed
     serve's launches by path phase 3's, and no pack, repack or demote
     while serving (pack time, each serve's decode tok/s, 5 batch-1
     prefills and 15 decode steps of each model in turn, host clock, and
     one decode step profiled, printed natural beside packed);
     deepseek-moe-16b (its expert banks as batched Y panels),
     whisper-small (conv1_w, conv2_w) and qwen2-vl-7b (patch_w and the
     dense stack) run one prefill and 4 decode steps on phase 3's inputs
     before and after packing, bit for bit, with no demote; then
     ``quant.qdot`` on X-side int8 panels at M = 4 and 1024 through the
     entry point (bit for bit, the IMMA kernel on packed panels), and each
     packed kernel mode (the weight stream at 4 x 4096 x 11008 and at an
     expert bank 64 x 1 x 2048 x 1408, the wgmma tile at 1024 x 4096 x
     11008, K3 at whisper's conv2, the IMMA kernel under qdot) bit for bit
     against its natural launch and within tolerance of its plain
     version, timed beside both, the library call and the bound, the
     host time of one call, natural beside packed, of the wrapper and of
     ``facility.contract`` at decode and prefill M, and ``qdot``'s whole
     call packed (no W^T copy) beside natural;
  8. the pm* masked forms (K1b) and the tight-parity config,
     ``FacilityConfig(ger=F32GER, out_dtype=float32)`` (K2e: f32
     attention on the attention kernel's fp32 tile): deepseek-7b served
     at full width and depth through ``serve_loop`` and whisper-small
     generating at full width and depth, each right after its phase-3 run
     (before phase 7 packs it), and two train steps of deepseek-7b at 4
     layers through ``launch.train.build(..., ger=F32GER,
     out_dtype=float32)``: each run's launches held to the per-call model,
     every GEMM on the fp32 WMMA tile and every attention on the fp32 tile
     (tile or split-KV, counted by mode), the logits (and step-1 loss and
     gradients) against the eager torch backend in the same config within
     ``F32_TOL``; then masked products through ``facility.contract(masks=)``
     and ``kernels.ops.mma_pm_dot`` at deepseek-7b's MLP shapes (and
     F32GER, I8GER4, F64GER and a batched F32GER product with a seed),
     launches counted by path, each held against its plain version with
     NaN and Inf in every disabled lane (integers bit for bit) and timed
     beside the same kernel unmasked, the unmasked default path, the plain
     version, a ``torch.where`` + library yardstick and its bound; and the
     fp32 tile at the F32GER runs' attention shapes beside SDPA on f32
     inputs;
  9. guarded serving and ABFT (``runtime/faults.py``, the guarded kernel
     -> torch -> ref ladder, ``core/abft.py``) and K1e, the GEMM kernels'
     checksum sidecar, its serving runs right after deepseek-7b's phase-3
     run, at full width and depth, each run's counts zeroed just before
     and read just after: a guards-on serve (ABFT off) whose every prefill
     and decode output is phase 3's bit for bit, with no guard event and
     every contract dispatch on the kernel rung; an ABFT serve
     (``serve_loop(..., abft=True)``, phase 3's settings) with no verdict
     and no demotion, each prefill's logits within phase 3's logits bound
     (relative L2) of phase 3's, the sidecar launched on the weight stream
     and the wgmma tile and attention at the padded depth 129;
     ``run_fault_matrix``
     (batch 2, 8-token prompts, 6 new tokens, 4 requests): all 7
     scenarios ok, ``sdc`` detected by a kernel-rung check that read the
     sidecar, and recovered; decode tok/s of each beside phase 3's and
     the matrix's wall time.  Then ABFT runs through ``facility.contract``
     of what that serve does not reach (F32GER and an unaligned pitch on
     the WMMA tile, a DGEMM on DMMA, whisper's conv2 with its 769th
     checksum filter on K3's WMMA tile, attention at D + 1 in every mode),
     each the unguarded call's (GEMMs bit for bit, the rest within 2e-2)
     with no verdict; then each sidecar kernel at the runs' shapes (decode
     4 x 4096 x 11008, split, and the 102400-column logits, unsplit, on
     the weight stream; 1024 x 4096 x 11008 on the wgmma tile; F32GER and
     an unaligned 1024 x 768 x 51865 on the WMMA tile; DGEMM 2048^3 on
     DMMA): ``out`` bit for bit ``checksum=False``'s, the sums within
     ABFT's tolerance of the plain version's, timed on and off beside the
     plain version, ``torch.matmul`` and the bound; and K2 at D = 129 and
     65 in every mode against its plain version, timed at deepseek's
     prefill beside D = 128 and SDPA.

The line before the last is ``{"kernels": [...]}`` (one entry per kernel,
``launches`` summed over the runs and ``launches_by_run``; the GEMM's
and the convs' ``launches_by_path``; the GEMM's ``host_us`` per call and,
with the attention kernel's and the depthwise conv's, ``run_shapes``;
phase 6's IMMA and DMMA entries their ``shapes``, the GEMM's entry
``phase6_shapes``, its runs on the WMMA tile or on no kernel; phase 7's
packed modes their ``natural_ms`` and ``launches_by_run`` over its runs,
the packed stream's ``host_us`` natural beside packed; phase 8's masked
entries their ``unmasked_ms``, ``default_ms`` and ``timed`` cases, its
f32 attention entries ``launches_by_run`` over the F32GER runs;
``max_abs_err`` covers the runs' shapes, training's included; phase 9's
sidecar entries their ``off_ms``, ``timed`` shapes and
``launches_by_run`` over its runs, its padded attention entry its
``d128_ms`` and ``launches_by_mode``); the last is ``{"ok": true,
"device": {...}}``.  Imports nothing of JAX and nothing
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
PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12,
              "f64": 67e12,            # the fp64 tensor cores (DMMA)
              "int8": 1979e12}         # the int8 tensor cores (IMMA), TOP/s

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


def serve(torch, failures, arch, settings, num_layers=None, record=None):
    """Serve ``arch`` with random bf16 weights from seed 0 through
    ``serve_loop``, every kernel's launch count reset just before and read
    just after (and every step's outputs recorded into the list
    ``record``, where one is given); then the served model's prefill and
    decode logits on the kernel backend against the eager torch
    backend."""
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
    with facility.configure(facility.FacilityConfig(device="cuda")), \
            (recording_steps(record) if record is not None
             else contextlib.nullcontext()):
        reset_counts(kernels)
        stats = S.serve_loop(cfg, model, **settings)
        launches = {name: fn.launches for name, fn in kernels.items()}
        take_records(arch, kernels)
    print(f"  serve {settings}: {json.dumps(stats)}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; launches in the serving run: {launches}")
    print(f"  expected per prefill: {want['prefill']}; per decode step: "
          f"{want['decode']}")
    # The counts follow from the calls: every request is one prefill and
    # every step of the loop one decode step (serve_loop's own counts).
    pre, steps = stats["completed"], stats["steps"]
    model_counts = {k: pre * want["prefill"].get(k, 0)
                    + steps * want["decode"].get(k, 0) for k in kernels}
    print(f"  {pre} prefills + {steps} decode steps give {model_counts}: "
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


# Each model's logits bound from its phase-3 check, by (arch, what).
LOGIT_TOLS: dict[tuple, float] = {}


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
        tol = LOGIT_TOLS[arch, what] = max(2e-2, 2 * noise)
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
    return launches, (cfg, *steps), (model, batch, seq_len)


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


# ----------------------------------------------------------------------
# Phase 6: the family table and its paths (the IMMA and DMMA kernels,
# quant.qdot, the complex op-class, blas3's dft and trsm, the saturating
# forms)
# ----------------------------------------------------------------------

# The phase's main-path runs: (run name, the kernel path each must launch,
# its launches a call).  dft and complex_gemm are four K1 launches a call
# (F32GER on the WMMA tile, F64GER on the DMMA kernel); trsm's panel
# updates and the saturating forms run the torch lowering, no kernel.
FAMILY_RUNS = {
    "dgemm F64GER 8192": ("dmma", 1),
    "I8GER4 8192": ("imma", 1),
    "I4GER8 8192": ("imma", 1), "I4GER8 4096": ("imma", 1),
    "I16GER2 8192": ("imma", 1), "I16GER2 4096": ("imma", 1),
    "qdot M=4": ("imma", 1), "qdot M=1024": ("imma", 1),
    "complex_gemm c64 4096": ("wmma", 4),
    "complex_gemm c128 4096": ("dmma", 4),
    "dft f32 N=1024 64x128": ("wmma", 4),
    "dft f64 N=1024 64x128": ("dmma", 4),
    "trsm f32 N=4096 R=1024": (None, 0),
    "saturating": (None, 0),
}
# The phase's kernel entries, by the GEMM path each reads its launches from.
PATH_ENTRIES = {"mma_gemm.imma": "imma", "mma_gemm.dmma": "dmma"}
# I16GER2's four int8 products a 16-bit product (its bound counts them).
_PRODUCTS = {"I8GER4": 1, "I4GER8": 1, "I16GER2": 4}


def _int_operands(torch, g, kind, lead, m, k, n):
    """Full-range operands of an integer family; K is logical (I4GER8
    packs it two nibbles a byte)."""
    name = kind.name
    xr, yr = {"I8GER4": ((-128, 128, torch.int8), (0, 256, torch.uint8)),
              "I4GER8": ((-128, 128, torch.int8), (-128, 128, torch.int8)),
              "I16GER2": ((-32768, 32768, torch.int16),
                          (-32768, 32768, torch.int16))}[name]
    kp = k // 2 if name == "I4GER8" else k

    def ri(lo, hi, dt, *shape):
        return torch.randint(lo, hi, shape, generator=g,
                             device="cuda").to(dt)
    return ri(*xr, *lead, m, kp), ri(*yr, *lead, kp, n)


def check_families(torch, failures) -> dict:
    """Each new path against its plain version at edge cases: ragged
    fringes, batch, every accumulate form with a full-range int32 seed,
    the epilogues an integer accumulator admits, out dtypes and I16GER2's
    wrap, bit for bit; F64GER within 1e-15 * K * max|x| * max|y| (fp64
    sums in another order), its activations included.  Returns the worst
    error by path."""
    from repro_torch.core import precision
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_gemm as G

    Ger = precision.Ger
    g = torch.Generator(device="cuda").manual_seed(6)
    worst = {"imma": 0.0, "dmma": 0.0}

    def ri(lo, hi, *shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g,
                             device="cuda").to(dtype)

    cases = [("ragged", (), (37, 100, 45), {}),
             ("batched B=3", (3,), (77, 200, 130), {}),
             ("aligned", (), (256, 4096, 512), {})]
    for neg_p in (False, True):
        for neg_a in (False, True):
            form = {(False, False): "pp", (True, False): "np",
                    (False, True): "pn", (True, True): "nn"}[neg_p, neg_a]
            cases.append((f"{form} seed alpha 3.7 beta -2.5", (),
                          (70, 256, 90),
                          dict(seed=True, neg_product=neg_p, neg_acc=neg_a,
                               alpha=3.7, beta=-2.5)))
    cases += [("bias+relu+res batched B=2", (2,), (33, 96, 40),
               dict(seed=True, epi=True)),
              ("out f32", (), (64, 512, 72), dict(out=torch.float32)),
              ("out bf16", (), (64, 512, 72), dict(out=torch.bfloat16)),
              ("out f64", (), (64, 512, 72), dict(out=torch.float64))]
    for kind in (Ger.I8GER4, Ger.I4GER8, Ger.I16GER2):
        for name, lead, (m, k, n), opts in cases:
            opts = dict(opts)
            x, y = _int_operands(torch, g, kind, lead, m, k, n)
            c = (ri(-2 ** 31, 2 ** 31 - 1, *lead, m, n)
                 if opts.pop("seed", False) else None)
            kw = dict(kind=kind, out_dtype=opts.pop("out", None), **{
                f: opts[f] for f in ("neg_product", "neg_acc", "alpha",
                                     "beta") if f in opts})
            if opts.get("epi"):
                kw.update(ep=E.Epilogue(bias=True, activation="relu",
                                        residual=True),
                          bias=ri(-1000, 1000, n),
                          residual=ri(-1000, 1000, *lead, m, n))
            got = G.mma_gemm(x, y, c, **kw)
            want = G.mma_gemm_plain(x, y, c, **kw)
            err = (got.double() - want.double()).abs().max().item()
            ok = torch.equal(got, want) and got.dtype == want.dtype
            worst["imma"] = max(worst["imma"], err)
            print(f"  [{'ok' if ok else 'FAIL'}] imma {kind.name} {name} "
                  f"{lead}{(m, k, n)}: max|err| {err:.3e} (bit for bit)")
            if not ok:
                failures.append(f"imma {kind.name} {name}")
    # I16GER2 at full range wraps: the exact sum leaves int32 and the
    # kernel keeps the wrapped bits of the reference's int32 dot
    x, y = _int_operands(torch, g, Ger.I16GER2, (), 128, 4096, 128)
    exact = torch.matmul(x.double(), y.double())
    wraps = bool((exact.abs() > 2 ** 31 - 1).any())
    ok = wraps and torch.equal(G.mma_gemm(x, y, kind=Ger.I16GER2),
                               exact.to(torch.int64).to(torch.int32))
    print(f"  [{'ok' if ok else 'FAIL'}] imma I16GER2 wrap 128x4096x128: "
          f"the exact sum leaves int32 ({wraps}); kernel == wrapped exact "
          f"sum bit for bit")
    if not ok:
        failures.append("imma I16GER2 wrap")

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.float64)

    f64_cases = [("ragged", (), (37, 301, 45), {}),
                 ("batched B=3", (3,), (77, 200, 130), {}),
                 ("np/nn seed alpha 0.5 beta -2", (), (70, 256, 90),
                  dict(seed=True, neg_product=True, neg_acc=True, alpha=0.5,
                       beta=-2.0)),
                 ("bias+gelu+res batched B=2", (2,), (65, 128, 66),
                  dict(act="gelu")),
                 ("bias+silu+res", (), (129, 256, 200), dict(act="silu")),
                 ("out f32", (), (64, 512, 72), dict(out=torch.float32))]
    for name, lead, (m, k, n), opts in f64_cases:
        x, y = rn(*lead, m, k), rn(*lead, k, n)
        c = rn(*lead, m, n) if opts.get("seed") else None
        kw = dict(kind=Ger.F64GER, out_dtype=opts.get("out"), **{
            f: opts[f] for f in ("neg_product", "neg_acc", "alpha", "beta")
            if f in opts})
        if "act" in opts:
            kw.update(ep=E.Epilogue(bias=True, activation=opts["act"],
                                    residual=True),
                      bias=rn(n), residual=rn(*lead, m, n))
        got = G.mma_gemm(x, y, c, **kw).double()
        want = G.mma_gemm_plain(x, y, c, **kw).double()
        err = (got - want).abs().max().item()
        tol = 1e-15 * k * x.abs().max().item() * y.abs().max().item()
        if opts.get("out") == torch.float32:
            tol += 2 ** -24 * want.abs().max().item()     # one f32 rounding
        ok = err <= tol
        worst["dmma"] = max(worst["dmma"], err)
        print(f"  [{'ok' if ok else 'FAIL'}] dmma F64GER {name} "
              f"{lead}{(m, k, n)}: max|err| {err:.3e} (tol {tol:.3e})")
        if not ok:
            failures.append(f"dmma F64GER {name}")
    return worst


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def family_runs(torch, timer, failures, by_run, worst):
    """The phase's main-path runs through the entry points a user calls
    (``facility.contract``, ``quant.qdot``, ``blas3.complex_gemm``,
    ``blas3.dft``, ``blas3.trsm``), every launch count reset just before
    each and read just after, each held to its expected path and count,
    its result checked; then each timed (CUDA events, L2 flushed) beside
    its plain version, a library yardstick and its bound.  Returns the
    ``kernels`` entries of the IMMA and DMMA kernels, and the timed rows
    of the runs on the WMMA tile or on no kernel."""
    from repro_torch.core import facility as F
    from repro_torch.core import quant as Q
    from repro_torch.kernels import blas3 as B3
    from repro_torch.kernels import mma_gemm as G

    Ger = F.Ger
    kernels = kernel_wrappers()
    g = torch.Generator(device="cuda").manual_seed(7)
    rows: dict[str, dict] = {}

    def run(name, fn):
        reset_counts(kernels)
        with F.configure(F.FacilityConfig(device="cuda")):
            out = fn()
        torch.cuda.synchronize()
        by_run[name] = {k: f.launches for k, f in kernels.items()}
        take_records(name, kernels)
        path, want = FAMILY_RUNS[name]
        got = RECORDS[name]["by_path"]["mma_gemm"]
        ok = (sum(got.values()) == want
              and (path is None or got[path] == want))
        print(f"  [{'ok' if ok else 'FAIL'}] {name}: GEMM launches by path "
              f"{ {p: v for p, v in got.items() if v} } (want {want} on "
              f"{path})")
        if not ok:
            failures.append(f"{name}: launches {got}, want {want} on {path}")
        return out

    def timed(name, kernel, plain, library, nbytes, ops, peak, lib_name,
              **extra):
        row = {"ms": timer(kernel), "plain_ms": timer(plain),
               "library_ms": timer(library) if library else None,
               "library": lib_name, **extra}
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, peak)
        rows[name] = row
        print(f"  time {name}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, {lib_name} "
              f"{row['library_ms'] if library else 'n/a'} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
              + "".join(f", {k} {v}" for k, v in extra.items()))

    def check(name, ok, what):
        print(f"  [{'ok' if ok else 'FAIL'}] {name}: {what}")
        if not ok:
            failures.append(f"{name}: {what}")

    # DGEMM on F64GER (the paper's first case study), 8192^2
    n = 8192
    a = torch.randn(n, n, generator=g, device="cuda", dtype=torch.float64)
    b = torch.randn(n, n, generator=g, device="cuda", dtype=torch.float64)
    plan = F.Plan(ger=Ger.F64GER, out_dtype=F.ACC)
    out = run("dgemm F64GER 8192",
              lambda: F.contract("mk,kn->mn", a, b, plan=plan))
    want = G.mma_gemm_plain(a, b, kind=Ger.F64GER)
    err = (out - want).abs().max().item()
    tol = 1e-15 * n * a.abs().max().item() * b.abs().max().item()
    worst["dmma"] = max(worst["dmma"], err)
    check("dgemm F64GER 8192", err <= tol,
          f"max|err| {err:.3e} vs plain (tol {tol:.3e})")
    timed("dgemm F64GER 8192", lambda: G.mma_gemm(a, b, kind=Ger.F64GER),
          lambda: G.mma_gemm_plain(a, b, kind=Ger.F64GER),
          lambda: torch.matmul(a, b), 3 * n * n * 8, 2 * n ** 3, "f64",
          "torch.matmul f64")
    del a, b, out, want

    # the integer families through contract at 8192^2 (and 4096^2)
    for kind, n in ((Ger.I8GER4, 8192), (Ger.I4GER8, 8192),
                    (Ger.I4GER8, 4096), (Ger.I16GER2, 8192),
                    (Ger.I16GER2, 4096)):
        name = f"{kind.name} {n}"
        x, y = _int_operands(torch, g, kind, (), n, n, n)
        plan = F.Plan(ger=kind, out_dtype=F.ACC)
        out = run(name, lambda: F.contract("mk,kn->mn", x, y, plan=plan))
        check(name, torch.equal(out, G.mma_gemm_plain(x, y, kind=kind)),
              "bit for bit with the plain version")
        s8 = torch.randint(-128, 128, (n, n), generator=g, device="cuda",
                           dtype=torch.int8)
        x8 = s8 if kind != Ger.I8GER4 else x
        in_bytes = (x.numel() * x.element_size()
                    + y.numel() * y.element_size())
        timed(name, lambda: G.mma_gemm(x, y, kind=kind),
              lambda: G.mma_gemm_plain(x, y, kind=kind),
              lambda: torch._int_mm(x8, s8), in_bytes + 4 * n * n,
              2 * n ** 3 * _PRODUCTS[kind.name], "int8",
              "torch._int_mm s8 x s8 of the unpacked shape (not the same "
              "function)")
        del x, y, out, s8, x8

    # qdot at deepseek-7b's MLP up-projection (4096 -> 11008)
    k, n = 4096, 11008
    w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
    wq, ws = Q.quantize_weight(w)
    for m in (4, 1024):
        name = f"qdot M={m}"
        x = torch.randn(m, k, generator=g, device="cuda")
        out = run(name, lambda: Q.qdot(x, wq, ws))
        with F.configure(F.FacilityConfig(device="cuda")):
            plain = Q.qdot(x, wq, ws, backend="torch")
        check(name, torch.equal(out, plain) and bool(
            torch.isfinite(out).all()), "bit for bit with the torch "
              "backend's qdot")
        rel = _rel(out, torch.matmul(x, w))
        check(name, rel < 2e-2, f"relative L2 to the f32 product {rel:.3e} "
              f"(int8 quantization; < 2e-2)")
        xq, _, _ = Q.quantize_act_u8(x)
        # the spec "kn,mk->mn" hands the kernel W^T and Xq^T: two copies
        copies = [nm for nm, t in (("W^T", wq.t()), ("Xq^T", xq.t()))
                  if not t.is_contiguous()]
        wt, xt = wq.t().contiguous(), xq.t().contiguous()
        xb, wb = x.bfloat16(), w.bfloat16()

        def qdot_call():
            with F.configure(F.FacilityConfig(device="cuda")):
                Q.qdot(x, wq, ws)

        def qdot_plain():
            with F.configure(F.FacilityConfig(device="cuda")):
                Q.qdot(x, wq, ws, backend="torch")

        timed(name, lambda: G.mma_gemm(wt, xt, kind=Ger.I8GER4),
              qdot_plain, lambda: torch.matmul(xb, wb),
              m * k + k * n + 4 * m * n, 2 * m * n * k, "int8",
              "torch.matmul bf16 of the unquantized product (not the same "
              "function)", copies=copies,
              qdot_ms=timer(qdot_call),
              copy_w_ms=timer(lambda: wq.t().contiguous()),
              copy_x_ms=timer(lambda: xq.t().contiguous()))
    del w, wq, wt, xt, xb, wb

    # complex_gemm at 4096^2: complex64 on F32GER, complex128 on F64GER
    n = 4096
    for kind, dt, cdt, tol in ((Ger.F32GER, torch.float32, torch.complex64,
                                1e-5),
                               (Ger.F64GER, torch.float64, torch.complex128,
                                1e-12)):
        name = f"complex_gemm c{64 if dt == torch.float32 else 128} {n}"
        ar, ai, br, bi = (torch.randn(n, n, generator=g, device="cuda",
                                      dtype=dt) for _ in range(4))
        re, im = run(name, lambda: B3.complex_gemm(ar, ai, br, bi,
                                                   kind=kind))
        ca, cb = torch.complex(ar, ai), torch.complex(br, bi)
        lib = torch.matmul(ca, cb)
        rel = _rel(torch.complex(re, im), lib)
        if kind == Ger.F64GER:
            worst["dmma"] = max(worst["dmma"], (torch.complex(re, im) - lib)
                                .abs().max().item())
        check(name, rel < tol, f"relative L2 to complex torch.matmul "
              f"{rel:.3e} (< {tol:g})")

        def cg(backend=None):
            with F.configure(F.FacilityConfig(device="cuda")):
                B3.complex_gemm(ar, ai, br, bi, kind=kind, backend=backend)

        timed(name, cg, lambda: cg("torch"), lambda: torch.matmul(ca, cb),
              6 * n * n * dt.itemsize, 8 * n ** 3,
              "f64" if dt == torch.float64 else "f32",
              f"torch.matmul {cdt}")
        del ar, ai, br, bi, re, im, ca, cb, lib

    # batched dft: N = 1024, 64 stacks of 128 columns
    bsz, n, m = 64, 1024, 128
    for dt, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        name = f"dft {'f32' if dt == torch.float32 else 'f64'} N={n} " \
               f"{bsz}x{m}"
        x = torch.randn(bsz, n, m, generator=g, device="cuda", dtype=dt)
        re, im = run(name, lambda: B3.dft(x))
        ref64 = torch.fft.fft(x.double(), dim=-2)
        got = torch.complex(re.double(), im.double())
        rel = _rel(got, ref64)
        rel_fft = _rel(torch.fft.fft(x, dim=-2).to(torch.complex128), ref64)
        check(name, rel < tol, f"relative L2 to a float64 fft {rel:.3e} (< "
              f"{tol:g}; torch.fft.fft in {dt}: {rel_fft:.3e})")

        def dft_call(backend=None):
            with F.configure(F.FacilityConfig(device="cuda")):
                B3.dft(x, backend=backend)

        xc = x.to(torch.complex64 if dt == torch.float32
                  else torch.complex128)
        timed(name, dft_call, lambda: dft_call("torch"),
              lambda: torch.fft.fft(xc, dim=-2),
              (2 * n * n + 3 * bsz * n * m) * dt.itemsize,
              8 * n * n * bsz * m, "f64" if dt == torch.float64 else "f32",
              "torch.fft.fft (not the same algorithm)")
        del x, re, im, ref64, got, xc

    # trsm: N = 4096, 1024 right-hand sides (panel updates on the torch
    # lowering, as the reference pins xla: no kernel launch)
    n, r = 4096, 1024
    l = (torch.tril(torch.randn(n, n, generator=g, device="cuda"))
         + n * torch.eye(n, device="cuda"))
    rhs = torch.randn(n, r, generator=g, device="cuda")
    xs = run("trsm f32 N=4096 R=1024", lambda: B3.trsm(l, rhs, block=64))
    res = ((torch.matmul(l, xs) - rhs).norm()
           / (l.norm() * xs.norm() + rhs.norm())).item()
    check("trsm f32 N=4096 R=1024", res < 1e-6,
          f"relative residual {res:.3e} (< 1e-6)")
    t_trsm = timer(lambda: B3.trsm(l, rhs, block=64), iters=3, warmup=1)
    t_lib = timer(lambda: torch.linalg.solve_triangular(l, rhs,
                                                        upper=False))
    print(f"  time trsm f32 N={n} R={r}: {t_trsm:.4f} ms, "
          f"torch.linalg.solve_triangular {t_lib:.4f} ms")
    rows["trsm f32 N=4096 R=1024"] = {"ms": t_trsm, "library_ms": t_lib}
    del l, rhs, xs

    # the saturating forms on the card: the kernel backend's route (the
    # torch lowering) against the ref oracle, seeded near both int32 ends
    def saturating():
        outs = []
        for kind in (Ger.I16GER2, Ger.I8GER4):
            x, y = _int_operands(torch, g, kind, (), 256, 512, 256)
            c = torch.where(torch.arange(256, device="cuda")[:, None] % 2
                            == 0, 2 ** 31 - 1000, -2 ** 31 + 1000).to(
                                torch.int32).expand(256, 256).contiguous()
            got, want = (F.contract("mk,kn->mn", x, y, acc=c,
                                    plan=F.Plan(ger=kind, saturating=True,
                                                backend=bk,
                                                out_dtype=F.ACC))
                         for bk in ("kernel", "ref"))
            outs.append((kind, got, want))
        return outs

    for kind, got, want in run("saturating", saturating):
        clamps = int((want.abs() >= 2 ** 31 - 1).sum())
        check(f"saturating {kind.name} 256x512x256",
              torch.equal(got, want) and clamps > 0,
              f"bit for bit with the ref lowering, {clamps} clamped "
              f"outputs")

    entries = []
    for ename, path, head in (("mma_gemm.imma", "imma", "I8GER4 8192"),
                              ("mma_gemm.dmma", "dmma",
                               "dgemm F64GER 8192")):
        row = rows[head]
        entries.append({
            "name": ename, "route": "cuda",
            "source": f"src/repro_torch/csrc/gemm_{path}.cu",
            "replaces": "src/repro/kernels/mma_gemm.py:197",
            "max_abs_err": worst[path], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row["library"], "shape": head,
            "shapes": {k: v for k, v in rows.items()
                       if FAMILY_RUNS[k][0] == path}})
    # the runs on the WMMA tile (F32GER) and on no kernel, for the GEMM's
    # entry
    others = {k: v for k, v in rows.items()
              if FAMILY_RUNS[k][0] in (None, "wmma")}
    return entries, others


# ----------------------------------------------------------------------
# Phase 7: prepacked serving (ROADMAP slice C4: core/packing.py, K1d and
# K3's packed filter stream)
# ----------------------------------------------------------------------

# The serving launcher's --prepack threshold.
PREPACK_MIN = 1024
# Decode steps of the prepacked step runs (deepseek-moe-16b, whisper-small,
# qwen2-vl-7b), after one prefill.
PREPACK_STEPS = 4
# Per phase-7 run: its packed launches by path, its pack time and stats.
PHASE7: dict[str, dict] = {}


@contextlib.contextmanager
def recording_steps(into):
    """Record every prefill's last logits and every decode tick's tokens
    and logits of ``serve_loop`` (``train.steps``' step factories) into
    the list ``into`` while the block runs."""
    from repro_torch.train import steps as ST

    made = (ST.make_prefill_step, ST.make_serve_step)

    def prefill_factory(cfg):
        step = made[0](cfg)

        def run(model, batch):
            last, pre = step(model, batch)
            into.append(("prefill", last.clone()))
            return last, pre
        return run

    def serve_factory(cfg):
        step = made[1](cfg)

        def run(model, cache, tokens):
            nxt, logits, cache = step(model, cache, tokens)
            into.append(("decode", nxt.clone(), logits.clone()))
            return nxt, logits, cache
        return run

    ST.make_prefill_step, ST.make_serve_step = prefill_factory, serve_factory
    try:
        yield into
    finally:
        ST.make_prefill_step, ST.make_serve_step = made


def zero_counts(kernels):
    """Zero every launch count, by path, on packed operands, with pm*
    masks and attention's by mode (no traces: the phase-7 and phase-8
    runs are not RECORDS)."""
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G
    for fn in kernels.values():
        fn.launches = 0
    for name in BY_PATH:
        kernels[name].launches_by_path = dict.fromkeys(
            kernels[name].launches_by_path, 0)
    G.mma_gemm.packed_launches_by_path = dict.fromkeys(G.PACKED_PATHS, 0)
    G.mma_gemm.masked_launches_by_path = dict.fromkeys(G.MASKED_PATHS, 0)
    A.mma_flash_attention.launches_by_mode = dict.fromkeys(A.MODES, 0)
    K.mma_conv2d.packed_launches = 0


def read_counts(kernels):
    """A run's launches, by path, on packed operands, with pm* masks and
    attention's by mode, just after it."""
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G
    return {"launches": {k: f.launches for k, f in kernels.items()},
            "by_path": {n: dict(kernels[n].launches_by_path)
                        for n in BY_PATH},
            "packed": {**{f"gemm {p}": v for p, v in
                          G.mma_gemm.packed_launches_by_path.items()},
                       "conv wgmma": K.mma_conv2d.packed_launches},
            "masked": dict(G.mma_gemm.masked_launches_by_path),
            "attn_by_mode": dict(A.mma_flash_attention.launches_by_mode)}


def pack_model(torch, arch, model):
    """``prepack_params_for_serving`` in place, timed (host clock around a
    synchronised pass); returns (stats, seconds, the counters after)."""
    from repro_torch.core import facility, packing

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with facility.configure(facility.FacilityConfig(device="cuda")):
        stats = packing.prepack_params_for_serving(model,
                                                   min_size=PREPACK_MIN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"  phase 7: {arch} packed in place in {dt:.3f} s: {stats}; "
          f"device memory {mem0 / 2**30:.2f} -> "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return stats, dt, dict(packing.COUNTERS)


def _relayouts(after, before):
    """The packs, repacks, invalidations and demotes since ``before``."""
    keys = ("pack", "repack", "invalidate", "demote")
    return {k: after.get(k, 0) - before.get(k, 0) for k in keys}


def _check(failures, name, ok, what):
    print(f"  [{'ok' if ok else 'FAIL'}] {name}: {what}")
    if not ok:
        failures.append(f"{name}: {what}")


def steps_in_turn(torch, models, cfg, settings, rounds=15):
    """Each model's batch-1 prefill and decode step (serve_steps' closures),
    the models in turn, so that all meet the same host load: ``{(name,
    "prefill" | "decode"): host-clock ms of its unprofiled steps}`` over
    5 prefill rounds and ``rounds`` decode rounds, and ``{name: device
    busy ms of one profiled decode step, or None where the profiler
    recorded none}``."""
    from repro_torch.core import facility

    steps = {k: serve_steps(torch, m, cfg, settings)[:2]
             for k, m in models.items()}
    host = {}
    dev = {}
    with facility.configure(facility.FacilityConfig(device="cuda")):
        for which, n in ((0, 5), (1, rounds)):
            for _ in range(n):
                for k, fns in steps.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fns[which]()
                    torch.cuda.synchronize()
                    host.setdefault((k, ("prefill", "decode")[which]),
                                    []).append(
                        (time.perf_counter() - t0) * 1e3)
        for k, (_, decode) in steps.items():
            got = profile_step(torch, f"decode step ({k})", decode,
                               sorted(host[k, "decode"])[rounds // 2])
            dev[k] = None if got is None else got[0]
    return host, dev


# Serves of deepseek-7b in phase 7, natural and packed in turn (ABBA, so
# that a drift of the host's load over the six weighs on both alike).
PREPACK_SERVES = ("natural", "packed", "packed", "natural", "natural",
                  "packed")


def prepacked_serve(torch, failures, arch, settings, model, cfg, natural):
    """deepseek-7b packed in place (a copy of phase 3's model, which stays
    natural beside it) and served with phase 3's settings, in turn with
    the natural model (PREPACK_SERVES): the first packed serve's tokens
    and every logit bit for bit those of phase 3's natural run
    (``natural``: its stats, counts and recorded steps), each packed
    serve's launches by path phase 3's, and no pack, repack or demote
    while serving; pack time and bytes, each serve's decode tok/s and a
    decode step's device and host time, natural beside packed."""
    import copy

    from repro_torch.core import facility, packing
    from repro_torch.launch import serve as S

    packed = copy.deepcopy(model)
    stats, pack_s, before = pack_model(torch, arch, packed)
    kernels = kernel_wrappers()
    name = f"{arch} prepacked serve"
    tok_s = {"natural": [], "packed": []}
    for i, which in enumerate(PREPACK_SERVES):
        first = which == "packed" and not tok_s["packed"]
        rec = []
        with facility.configure(facility.FacilityConfig(device="cuda")), \
                (recording_steps(rec) if first
                 else contextlib.nullcontext()):
            zero_counts(kernels)
            out = S.serve_loop(cfg, packed if which == "packed" else model,
                               **settings)
            counts = read_counts(kernels)
        tok_s[which].append(out["tokens_per_s"])
        print(f"  phase 7: serve {i + 1} ({which}) {settings}: "
              f"{json.dumps(out)}")
        if which == "natural":
            continue
        print(f"  phase 7: launches {counts['launches']}, by path "
              f"{counts['by_path']['mma_gemm']}, on packed panels "
              f"{counts['packed']}")
        if first:
            same = (len(rec) == len(natural["record"]) and all(
                len(a) == len(b) and a[0] == b[0]
                and all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
                for a, b in zip(rec, natural["record"])))
            _check(failures, name, same and out["completed"] == settings[
                "n_requests"], f"{len(rec)} prefill/decode outputs (token "
                f"ids and logits) bit for bit those of phase 3's natural "
                f"run")
            packed_counts = counts["packed"]
        _check(failures, name, counts["launches"] == natural["launches"]
               and counts["by_path"] == natural["by_path"],
               f"serve {i + 1}: launches and launches by path equal "
               f"phase 3's")
        _check(failures, name, counts["packed"]["gemm stream"] > 0
               and counts["packed"]["gemm wgmma"] > 0,
               f"serve {i + 1}: decode products on packed panels on the "
               f"weight stream, prefill products on the wgmma tile")
    moved = _relayouts(dict(packing.COUNTERS), before)
    _check(failures, name, not any(moved.values()),
           f"packing counters while serving: {moved} (all 0)")
    host, dev = steps_in_turn(
        torch, {"natural": model, "packed": packed}, cfg, settings)
    del packed
    steps = {f"{k} {what}": {"median": sorted(v)[len(v) // 2],
                             "min": min(v)}
             for (k, what), v in host.items()}
    print(f"  phase 7: {arch} decode tok/s by serve, in turn "
          f"{PREPACK_SERVES}: natural {tok_s['natural']}, packed "
          f"{tok_s['packed']} (phase 3's natural "
          f"{natural['stats']['tokens_per_s']:.2f}); batch-1 prefill (5 "
          f"each) and decode step (15 each), in turn, host ms: "
          + ", ".join(f"{k} median {v['median']:.3f} min {v['min']:.3f}"
                      for k, v in steps.items())
          + f"; device busy of a decode step {dev['packed']} ms packed vs "
          f"{dev['natural']} natural")
    PHASE7[name] = {"packed": packed_counts, "pack_s": pack_s,
                    "stats": stats, "tok_s": tok_s["packed"],
                    "tok_s_natural": tok_s["natural"],
                    "tok_s_phase3": natural["stats"]["tokens_per_s"],
                    "host_ms": steps,
                    "decode_device_ms": dev["packed"],
                    "decode_device_ms_natural": dev["natural"]}


def prepacked_steps(torch, failures, arch, model, cfg, batch, seq_len):
    """One prefill and PREPACK_STEPS greedy decode steps on ``batch``
    (phase 3's inputs) before and after packing ``model`` in place: every
    logit bit for bit, the same launches by path, no pack, repack or
    demote in the packed run, and the packed panels and filter streams
    launched."""
    from repro_torch.core import facility, packing
    from repro_torch.models import model as M

    kernels = kernel_wrappers()
    b = batch["tokens"].shape[0]

    def run():
        with facility.configure(facility.FacilityConfig(device="cuda")):
            zero_counts(kernels)
            last, pre = M.prefill(model, batch, cfg)
            if cfg.is_enc_dec or cfg.vision_prefix:
                cache = handoff(torch, cfg, pre, b, seq_len, torch.bfloat16)
            else:
                cache = M.init_cache(cfg, b, seq_len, device="cuda")
            del pre
            outs = [last]
            tok = last.argmax(-1, keepdim=True).to(torch.int32)
            for _ in range(PREPACK_STEPS):
                logits, cache = M.decode_step(model, cache, tok, cfg)
                outs.append(logits)
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            torch.cuda.synchronize()
            return outs, read_counts(kernels)

    nat, nat_counts = run()
    stats, pack_s, before = pack_model(torch, arch, model)
    pk, counts = run()
    moved = _relayouts(dict(packing.COUNTERS), before)
    name = f"{arch} prepacked prefill + {PREPACK_STEPS} decode steps"
    print(f"  phase 7: {name}: launches {counts['launches']}, GEMM by path "
          f"{counts['by_path']['mma_gemm']}, on packed panels "
          f"{counts['packed']}")
    _check(failures, name, len(nat) == len(pk) and all(
        torch.equal(x, y) for x, y in zip(nat, pk)),
        "prefill and decode logits bit for bit the natural run's")
    _check(failures, name, counts["launches"] == nat_counts["launches"]
           and counts["by_path"] == nat_counts["by_path"],
           "launches and launches by path equal the natural run's")
    _check(failures, name, not any(moved.values()),
           f"packing counters in the packed run: {moved} (all 0)")
    stems = cfg.is_enc_dec or cfg.vision_prefix
    _check(failures, name, counts["packed"]["gemm stream"] > 0 and (
        not stems or counts["packed"]["conv wgmma"] > 0),
        "decode products on packed panels"
        + (", the conv stem on K3's packed filter stream" if stems else ""))
    PHASE7[name] = {"packed": counts["packed"], "pack_s": pack_s,
                    "stats": stats}


def qdot_packed_run(torch, failures):
    """quant.qdot on a weight prepacked as X-side I8GER4 panels
    (``prepack_params_for_serving(quantize=True)``'s form) at
    deepseek-7b's MLP up-projection, M = 4 and 1024, through the entry
    point: counts zeroed just before and read just after; the output bit
    for bit the natural qdot's, no demote, the IMMA kernel on packed
    panels.  Returns the operands for the timings."""
    from repro_torch.core import facility, packing
    from repro_torch.core import quant as Q

    g = torch.Generator(device="cuda").manual_seed(11)
    k, n = 4096, 11008
    w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
    wq, ws = Q.quantize_weight(w)
    lay = packing.gemm_layout(facility.Ger.I8GER4, n, k, side="x",
                              transposed=True)
    po = packing.pack_gemm(wq, lay, scale=ws,
                           col_sum=wq.to(torch.int32).sum(0).float())
    xs = {m: torch.randn(m, k, generator=g, device="cuda")
          for m in (4, 1024)}
    kernels = kernel_wrappers()
    with facility.configure(facility.FacilityConfig(device="cuda")):
        nat = {m: Q.qdot(x, wq, ws) for m, x in xs.items()}
        before = dict(packing.COUNTERS)
        zero_counts(kernels)
        pk = {m: Q.qdot(x, po) for m, x in xs.items()}
        torch.cuda.synchronize()
        counts = read_counts(kernels)
    moved = _relayouts(dict(packing.COUNTERS), before)
    name = "qdot prepacked (M = 4, 1024)"
    _check(failures, name, all(torch.equal(nat[m], pk[m]) for m in xs),
           "bit for bit the natural qdot's")
    _check(failures, name, not any(moved.values())
           and counts["packed"]["gemm imma"] == 2,
           f"packed launches {counts['packed']}, packing counters {moved}")
    PHASE7[name] = {"packed": counts["packed"]}
    return w, wq, ws, po, xs


def phase7_kernels(torch, timer, failures, qdot_ops):
    """Each packed kernel mode against its natural launch (bit for bit)
    and its plain version (``_report_close``), timed (CUDA events, L2
    flushed) beside the natural launch, the plain version, the library
    call and the bound; ``qdot`` timed whole, natural (its W^T copy)
    beside packed.  Returns the ``kernels`` entries of the packed
    modes."""
    from repro_torch.core import facility, packing
    from repro_torch.core import quant as Q
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G

    Ger = facility.Ger
    g = torch.Generator(device="cuda").manual_seed(12)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(dtype)

    def ypack(w, batched=False):
        k, n = w.shape[-2:]
        return packing.pack_gemm(w, packing.gemm_layout(
            Ger.BF16GER2, k, n, batched=batched))

    rows = {}

    def mode(key, label, natural, packed, plain, library, nbytes, ops,
             peak, out_dtype):
        want = natural()
        got = packed()
        torch.cuda.synchronize()
        _check(failures, label, torch.equal(got, want),
               "bit for bit the natural launch")
        err = _report_close(torch, f"{label} vs plain", got.float(),
                            plain().float(), out_dtype, failures)
        row = {"ms": timer(packed), "natural_ms": timer(natural),
               "plain_ms": timer(plain),
               "library_ms": timer(library) if library else None}
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, peak)
        print(f"  time {label}: packed {row['ms']:.4f} ms, natural "
              f"{row['natural_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"library {row['library_ms']} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows.setdefault(key, {})[label] = (row, err)

    kw = dict(kind=Ger.BF16GER2, out_dtype=torch.bfloat16)
    m, k, n = SERVE["batch"], 4096, 11008
    x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
    po = ypack(w)
    mode("stream", f"stream packed Y {m}x{k}x{n}",
         lambda: G.mma_gemm(x, w, **kw),
         lambda: G.mma_gemm(x, po.data, y_layout=po.layout, **kw),
         lambda: G.mma_gemm_plain(x, w, **kw), lambda: torch.matmul(x, w),
         (m * k + k * n + m * n) * 2, 2 * m * n * k, "bf16", torch.bfloat16)
    xb, wb = randn(64, 1, 2048), randn(64, 2048, 1408, scale=2048 ** -0.5)
    pb = ypack(wb, batched=True)
    mode("stream", "stream packed Y bank 64x1x2048x1408",
         lambda: G.mma_gemm(xb, wb, **kw),
         lambda: G.mma_gemm(xb, pb.data, y_layout=pb.layout, **kw),
         lambda: G.mma_gemm_plain(xb, wb, **kw),
         lambda: torch.matmul(xb, wb),
         (64 * 2048 + 64 * 2048 * 1408 + 64 * 1408) * 2,
         2 * 64 * 2048 * 1408, "bf16", torch.bfloat16)
    del xb, wb, pb
    xw = randn(1024, k)
    mode("wgmma", f"wgmma packed Y 1024x{k}x{n}",
         lambda: G.mma_gemm(xw, w, **kw),
         lambda: G.mma_gemm(xw, po.data, y_layout=po.layout, **kw),
         lambda: G.mma_gemm_plain(xw, w, **kw), lambda: torch.matmul(xw, w),
         (1024 * k + k * n + 1024 * n) * 2, 2 * 1024 * n * k, "bf16",
         torch.bfloat16)
    # Host time of one call (enqueue only, 200 calls), natural beside
    # packed, in turn, 7 rounds (median and min): the wrapper alone, and
    # the whole facility.contract dispatch (admission, the normalizer,
    # refresh, the wrapper's one path choice) at decode and prefill M.
    calls = {}
    for where, xx in (("decode (stream)", x), ("prefill (wgmma)", xw)):
        calls[f"mma_gemm {where} natural"] = \
            lambda xx=xx: G.mma_gemm(xx, w, **kw)
        calls[f"mma_gemm {where} packed"] = \
            lambda xx=xx: G.mma_gemm(xx, po.data, y_layout=po.layout, **kw)
        calls[f"contract {where} natural"] = \
            lambda xx=xx: facility.contract("mk,kn->mn", xx, w)
        calls[f"contract {where} packed"] = \
            lambda xx=xx: facility.contract("mk,kn->mn", xx, po)
    host = {}
    with facility.configure(facility.FacilityConfig(device="cuda")):
        for _ in range(7):
            for label, fn in calls.items():
                host.setdefault(label, []).append(host_us(torch, fn))
    host = {label: {"median": sorted(v)[3], "min": min(v)}
            for label, v in host.items()}
    print("  host us per call, natural and packed in turn (median, min "
          "of 7): " + ", ".join(f"{label} {v['median']:.1f}, "
                                f"{v['min']:.1f}"
                                for label, v in host.items()))
    del x, w, po, xw, calls
    # whisper-small's conv2 (k3 s2 over 3000 frames, SAME: 3001 padded
    # frames), bias + gelu, bf16 out
    img = randn(4, 1, 3001, 768)
    wc = randn(1, 3, 768, 768, scale=(3 * 768) ** -0.5)
    pc = packing.pack_conv(wc[0], packing.conv_layout(
        Ger.BF16GER2, 1, 3, 768, 768, nd=1))
    bias = randn(768, dtype=torch.float32)
    ep = E.Epilogue(bias=True, activation="gelu")
    ckw = dict(stride=(1, 2), ep=ep, bias=bias, out_dtype=torch.bfloat16)
    # cuDNN as phase 2 times it: channels-last NCHW views, the bias
    w_nchw = wc.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    x_nchw = img.permute(0, 3, 1, 2)
    b16 = bias.to(img.dtype)
    ow = 1500
    mode("conv", "K3 packed filters whisper conv2 4x3001x768 k3 s2",
         lambda: K.mma_conv2d(img, wc, **ckw),
         lambda: K.mma_conv2d(img, pc.data, w_layout=pc.layout, **ckw),
         lambda: K.mma_conv2d_plain(img, wc, **ckw),
         lambda: torch.nn.functional.conv2d(x_nchw, w_nchw, b16,
                                            stride=(1, 2)),
         (4 * 3001 * 768 + 3 * 768 * 768 + 4 * ow * 768) * 2 + 768 * 4,
         2 * 4 * ow * 768 * 3 * 768, "bf16", torch.bfloat16)
    del img, wc, pc, x_nchw, w_nchw

    # qdot: the whole call natural (its W^T copy) and packed (none), and
    # the IMMA kernel alone on natural W^T and on packed panels
    w, wq, ws, pq, xs = qdot_ops
    qdot_rows = {}
    for m, x in xs.items():
        xq, _, _ = Q.quantize_act_u8(x)
        xt = xq.t().contiguous()
        wt = wq.t().contiguous()
        ikw = dict(kind=Ger.I8GER4)

        def whole(wgt, scale, x=x):
            with facility.configure(facility.FacilityConfig(device="cuda")):
                Q.qdot(x, wgt, scale)

        def torch_qdot(x=x):
            with facility.configure(facility.FacilityConfig(device="cuda")):
                Q.qdot(x, wq, ws, backend="torch")

        xb16, wb16 = x.bfloat16(), w.bfloat16()
        mode("imma", f"IMMA packed X qdot M={m} ({m}x4096x11008)",
             lambda: G.mma_gemm(wt, xt, **ikw),
             lambda: G.mma_gemm(pq.data, xt, x_layout=pq.layout, **ikw),
             lambda: G.mma_gemm_plain(wt, xt, **ikw),
             lambda: torch.matmul(xb16, wb16),
             m * k + k * n + 4 * m * n, 2 * m * n * k, "int8", torch.int32)
        row = {"qdot_ms": timer(lambda: whole(pq, None)),
               "qdot_natural_ms": timer(lambda: whole(wq, ws)),
               "qdot_torch_ms": timer(torch_qdot),
               "copy_w_ms": timer(lambda: wq.t().contiguous())}
        qdot_rows[f"M={m}"] = row
        print(f"  time qdot M={m} whole call: packed {row['qdot_ms']:.4f} "
              f"ms (no W^T copy), natural {row['qdot_natural_ms']:.4f} ms "
              f"(its W^T copy alone {row['copy_w_ms']:.4f} ms), torch "
              f"backend {row['qdot_torch_ms']:.4f} ms")
    del w, wq, pq

    sources = {"stream": ("src/repro_torch/csrc/gemm_stream.cu",
                          "src/repro/kernels/mma_gemm.py:333"),
               "wgmma": ("src/repro_torch/csrc/gemm_wgmma.cu",
                         "src/repro/kernels/mma_gemm.py:333"),
               "imma": ("src/repro_torch/csrc/gemm_imma.cu",
                        "src/repro/kernels/mma_gemm.py:333"),
               "conv": ("src/repro_torch/csrc/mma_conv.cu",
                        "src/repro/kernels/mma_conv.py:176")}
    names = {"stream": "mma_gemm packed Y (stream)",
             "wgmma": "mma_gemm packed Y (wgmma)",
             "imma": "mma_gemm packed X (imma)",
             "conv": "mma_conv2d packed filters (wgmma)"}
    counter = {"stream": "gemm stream", "wgmma": "gemm wgmma",
               "imma": "gemm imma", "conv": "conv wgmma"}
    entries = []
    for key, by_label in rows.items():
        label, (row, _) = next(iter(by_label.items()))
        e = {"name": names[key], "route": "cuda", "source": sources[key][0],
             "replaces": sources[key][1],
             "max_abs_err": max(err for _, err in by_label.values()),
             **row, "shape": label,
             "launches_by_run": {r: v["packed"][counter[key]]
                                 for r, v in PHASE7.items()},
             "timed": {lb: r for lb, (r, _) in by_label.items()}}
        if key == "imma":
            e["qdot"] = qdot_rows
        if key == "stream":
            e["host_us"] = host
        e["launches"] = sum(e["launches_by_run"].values())
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched in phase 7's runs")
        entries.append(e)
    return entries



# ----------------------------------------------------------------------
# Phase 8: the pm* masked forms (K1b) and the tight-parity F32GER config on
# the card (K2e: the attention kernel's fp32 tile)
# ----------------------------------------------------------------------

# The tight-parity config's runs, FacilityConfig(ger=F32GER,
# out_dtype=float32), each at full width: (a) deepseek-7b at full depth
# through serve_loop and (b) whisper-small at full depth through prefill
# and decode_step, both on phase 3's models (their bf16 weights cast per
# call by the F32GER policy) before phase 7 packs them; (c) two train
# steps of deepseek-7b cut to 4 layers through launch.train.build.
F32_SERVE = dict(batch=4, prompt_len=256, gen_len=12, n_requests=2)
F32_GEN = dict(batch=4, frames=3000, prompt_len=4, gen_len=8)
F32_TRAIN = ("deepseek-7b", 4, dict(batch=4, seq=512, steps=2))
# The tolerances, stated before the first run on the card: the kernel
# backend's logits, step-1 loss and step-1 gradients (each leaf) against
# the eager torch backend in the same config, relative L2.  Both backends
# compute in fp32 (bf16 weights and the embedding are exact in it); their
# sums run in other orders, about sqrt(K) * 2^-24 relative a product, and
# the difference travels through the layers.
F32_TOL = {"logits": 1e-4, "grads": 1e-4}
# Per phase-8 run: its launches by kernel, path, mode and mask.
PHASE8: dict[str, dict] = {}
# The masked products (K1b) at deepseek-7b's MLP shapes, in its bf16
# policy, and the other families' paths: (name, family, batch, M, K, N,
# with a seed).  About 30% of the lanes of each mask are off.
MASKED_CASES = (
    ("bf16 decode MLP", "BF16GER2", None, 4, 4096, 11008, False),
    ("bf16 prefill MLP", "BF16GER2", None, 1024, 4096, 11008, False),
    ("F32GER", "F32GER", None, 1024, 4096, 4096, False),
    ("F32GER batched + seed", "F32GER", 8, 256, 1024, 1024, True),
    ("I8GER4", "I8GER4", None, 4096, 4096, 4096, False),
    ("F64GER", "F64GER", None, 2048, 2048, 2048, False),
)
# K2e at the F32GER runs' attention shapes: (name, q shape, k/v shape,
# causal).
F32_ATTENTION = (
    ("deepseek-7b prefill", (1, 256, 32, 128), (1, 256, 32, 128), True),
    ("deepseek-7b logits check prefill", (4, 256, 32, 128),
     (4, 256, 32, 128), True),
    ("deepseek-7b train", (4, 512, 32, 128), (4, 512, 32, 128), True),
    ("whisper-small encoder", (4, 1500, 12, 64), (4, 1500, 12, 64), False),
    ("whisper-small cross prompt", (4, 4, 12, 64), (4, 1500, 12, 64), False),
    ("whisper-small cross decode", (4, 1, 12, 64), (4, 1500, 12, 64), False),
)


def f32_config(torch, **kw):
    from repro_torch.core import facility
    return facility.FacilityConfig(device="cuda", ger=facility.Ger.F32GER,
                                   out_dtype=torch.float32, **kw)


def check_f32_counts(failures, run, counts, model_counts, modes):
    """A phase-8 F32GER run's launches: the per-call model's counts, every
    GEMM on the WMMA tile (F32GER's fp32 FMAs) and attention's by mode
    (the fp32 tile, K2e)."""
    gemm = counts["by_path"]["mma_gemm"]
    off = {p: n for p, n in gemm.items() if p != "wmma" and n}
    got_modes = {m: n for m, n in counts["attn_by_mode"].items() if n}
    ok = counts["launches"] == model_counts and not off \
        and got_modes == modes
    print(f"  [{'ok' if ok else 'FAIL'}] phase 8: {run}: launches "
          f"{counts['launches']} (per-call model {model_counts}); GEMM by "
          f"path {gemm}; attention by mode {got_modes} (want {modes}); "
          f"conv by path {counts['by_path']['mma_conv2d']}")
    if not ok:
        failures.append(f"{run} launches")
    PHASE8[run] = counts


def _check_rel(failures, run, what, got, want, tol) -> float:
    r = _rel(got, want)
    ok = bool(got.isfinite().all()) and r <= tol
    print(f"  [{'ok' if ok else 'FAIL'}] phase 8: {run} {what} "
          f"{tuple(got.shape)}: kernel vs torch backend rel L2 {r:.3e} "
          f"(tol {tol:.0e})")
    if not ok:
        failures.append(f"{run} {what}")
    return r


def _greedy(torch, model, cfg, batch, seq_len, gen, fcfg, tokens):
    """Prefill, the cache handoff (f32) and ``gen`` decode steps under
    ``fcfg``: greedy where ``tokens`` is an empty list (which then records
    them), else teacher-forced with them.  Returns the prefill's and the
    last step's logits."""
    from repro_torch.core import facility
    from repro_torch.models import model as M

    b = next(iter(batch.values())).shape[0]
    with facility.configure(fcfg):
        last, pre = M.prefill(model, batch, cfg)
        cache = handoff(torch, cfg, pre, b, seq_len, torch.float32)
        del pre
        forced = bool(tokens)
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        for i in range(gen):
            if forced:
                tok = tokens[i]
            else:
                tokens.append(tok)
            logits, cache = M.decode_step(model, cache, tok, cfg)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    del cache
    return last.float(), logits[:, -1].float()


def f32_serve(torch, failures, model, cfg):
    """(a) deepseek-7b served through serve_loop in the tight-parity
    config, launches held to the per-call model with every GEMM on the
    WMMA tile and every prefill attention on K2e's fp32 tile; then a
    batch-4 prompt of 256 tokens through prefill and F32_SERVE's decode
    steps, greedy on the kernel backend and teacher-forced with its tokens
    on the eager torch backend: the prefill's and the last step's logits
    within F32_TOL of each other."""
    from repro_torch.core import facility
    from repro_torch.launch import serve as S

    kernels = kernel_wrappers()
    want = expected_launches(cfg)
    run = f"{cfg.name} F32GER serve"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with facility.configure(f32_config(torch)):
        zero_counts(kernels)
        stats = S.serve_loop(cfg, model, **F32_SERVE)
        torch.cuda.synchronize()
        counts = read_counts(kernels)
    print(f"  phase 8: {run} {F32_SERVE}: {json.dumps(stats)} "
          f"({time.perf_counter() - t0:.1f} s)")
    pre, steps = stats["completed"], stats["steps"]
    model_counts = {k: pre * want["prefill"].get(k, 0)
                    + steps * want["decode"].get(k, 0) for k in kernels}
    check_f32_counts(failures, run, counts, model_counts,
                     {"f32_tile": pre * cfg.num_layers})
    if pre != F32_SERVE["n_requests"]:
        failures.append(f"{run}: served {pre} of "
                        f"{F32_SERVE['n_requests']} requests")
    b, p, gen = (F32_SERVE[k] for k in ("batch", "prompt_len", "gen_len"))
    g = torch.Generator(device="cuda").manual_seed(8)
    prompt = torch.randint(0, cfg.vocab_size, (b, p), generator=g,
                           device="cuda", dtype=torch.int32)
    tokens = []
    t0 = time.perf_counter()
    outs = {be: _greedy(torch, model, cfg, {"tokens": prompt}, p + gen, gen,
                        f32_config(torch, backend=be), tokens)
            for be in ("kernel", "torch")}
    rel = [_check_rel(failures, run, what, outs["kernel"][i],
                      outs["torch"][i], F32_TOL["logits"])
           for i, what in enumerate(("prefill logits",
                                     f"decode step {gen} logits"))]
    print(f"  phase 8: {run} logits check: batch {b} x {p} prompt, {gen} "
          f"steps ({time.perf_counter() - t0:.1f} s)")
    PHASE8[run]["rel_l2"] = rel


def f32_generate(torch, failures, model, cfg):
    """(b) whisper-small in the tight-parity config: a batch-4 prefill over
    3000 mel frames (the encoder's attention on the fp32 tile, the
    decoder's cross-attention on fp32 split-KV), the handoff and
    F32_GEN's greedy decode steps (each step's cross-attention on fp32
    split-KV), launches held to the per-call model; then the same inputs,
    teacher-forced, on the eager torch backend: the prefill's and the
    last step's logits within F32_TOL."""
    b, gen = F32_GEN["batch"], F32_GEN["gen_len"]
    batch, seq_len = mm_batch(cfg, F32_GEN, b)
    kernels = kernel_wrappers()
    want = expected_launches(cfg)
    run = f"{cfg.name} F32GER generate"
    tokens = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zero_counts(kernels)
    got = _greedy(torch, model, cfg, batch, seq_len, gen, f32_config(torch),
                  tokens)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    t1 = time.perf_counter()
    model_counts = {k: want["prefill"].get(k, 0)
                    + gen * want["decode"].get(k, 0) for k in kernels}
    e, n = cfg.encoder_layers, cfg.num_layers
    print(f"  phase 8: {run} {F32_GEN}: prefill + {gen} steps "
          f"{t1 - t0:.2f} s; first request's tokens "
          f"{torch.cat(tokens, 1)[0].tolist()}")
    check_f32_counts(failures, run, counts, model_counts,
                     {"f32_tile": e + n, "f32_split": n + gen * n})
    ref = _greedy(torch, model, cfg, batch, seq_len, gen,
                  f32_config(torch, backend="torch"), tokens)
    PHASE8[run]["rel_l2"] = [
        _check_rel(failures, run, what, got[i], ref[i], F32_TOL["logits"])
        for i, what in enumerate(("prefill logits",
                                  f"decode step {gen} logits"))]


def f32_train(torch, failures):
    """(c) deepseek-7b at full width cut to 4 layers, trained through
    ``launch.train.build`` in the tight-parity config: step 1's loss and
    every gradient leaf on the kernel backend within F32_TOL of the eager
    torch backend's (same config, same weights), then two steps with the
    launches held to the per-step model (every GEMM, backward included, on
    the WMMA tile; the forward's attention on the fp32 tile) and the loss
    finite."""
    import dataclasses

    from repro_torch.configs import get as get_arch
    from repro_torch.core import facility
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    from repro_torch.train import steps as S

    arch, layers, st = F32_TRAIN
    cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
    run = f"{arch} F32GER train ({layers} layers)"
    t0 = time.perf_counter()
    make_state, make_step = T.build(
        cfg, lr=TRAIN["lr"], total_steps=st["steps"], weight_decay=0.0,
        seed=0, device="cuda", ger=facility.Ger.F32GER,
        out_dtype=torch.float32)
    state, step = make_state(), make_step()
    model = state["params"]
    batch = pipeline.device_batch(pipeline.synthetic_batch(
        cfg, batch=st["batch"], seq=st["seq"], step=0), "cuda")

    def grads(backend):
        with facility.configure(f32_config(torch, backend=backend)):
            loss, _, g = S.loss_and_grads(cfg, model, batch)
        return loss.item(), g

    loss_t, want = grads("torch")
    loss_k, got = grads("kernel")
    rels = sorted(((_rel(got[k].float(), want[k].float()), k) for k in got),
                  reverse=True)
    del got, want
    loss_rel = abs(loss_k - loss_t) / abs(loss_t)
    ok = (loss_k == loss_k and abs(loss_k) != float("inf")
          and loss_rel <= F32_TOL["grads"]
          and rels[0][0] <= F32_TOL["grads"])
    print(f"  [{'ok' if ok else 'FAIL'}] phase 8: {run} step-1 loss kernel "
          f"{loss_k:.7f}, torch {loss_t:.7f} (rel {loss_rel:.3e}); "
          f"{len(rels)} gradient leaves, worst rel L2 {rels[0][0]:.3e} "
          f"(tol {F32_TOL['grads']:.0e}): "
          + ", ".join(f"{k} {r:.3e}" for r, k in rels[:3]))
    if not ok:
        failures.append(f"{run} step-1 loss or gradients")
    kernels = kernel_wrappers()
    per_step = {k: v for k, v in expected_train_launches(cfg).items()
                if k != "forward_gemm"}
    torch.cuda.synchronize()
    zero_counts(kernels)
    losses, times = [], []
    for _ in range(st["steps"]):
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append(metrics["loss"].item())
    counts = read_counts(kernels)
    model_counts = {k: st["steps"] * per_step.get(k, 0) for k in kernels}
    check_f32_counts(failures, run, counts, model_counts, {
        "f32_tile": st["steps"] * per_step.get("mma_flash_attention", 0)})
    finite = all(x == x and abs(x) != float("inf") for x in losses)
    print(f"  [{'ok' if finite else 'FAIL'}] phase 8: {run} losses "
          f"{losses}, step times {[round(t, 1) for t in times]} ms, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB ({time.perf_counter() - t0:.1f} s in all)")
    if not finite:
        failures.append(f"{run} loss")
    PHASE8[run]["rel_l2"] = {"loss": loss_rel, "worst_grad": rels[0][0]}
    del state, step, model, batch


def _lane_masks(torch, g, m, n, k):
    return tuple(torch.rand(s, generator=g, device="cuda") > 0.3
                 for s in (m, n, k))


def phase8_kernels(torch, timer, failures):
    """The masked products (K1b): a main-path run through the entry points
    (``facility.contract(masks=)`` at each MASKED_CASES shape and
    ``kernels.ops.mma_pm_dot`` twice: on the first case and on I4GER8
    with a column mask), launches reset just before and read
    just after; then each case's masked kernel held against its plain
    version (integers bit for bit), with NaN and Inf in every disabled lane
    of the float families, and timed beside the same kernel unmasked, the
    unmasked default path, the plain version, the ``torch.where`` +
    ``torch.matmul`` yardstick (``torch._int_mm`` for I8GER4) and its
    bound; then K2e at the F32GER runs' attention shapes beside SDPA on
    f32 inputs (TF32 off).  Returns the ``kernels`` entries."""
    import warnings

    from repro_torch.core import facility, precision, tiling
    from repro_torch.kernels import mma_gemm as G
    from repro_torch.kernels import ops as O

    Ger = facility.Ger
    g = torch.Generator(device="cuda").manual_seed(20)
    operands = []
    for name, fam, b, m, k, n, seeded in MASKED_CASES:
        kind = Ger[fam]
        pol = precision.policy(kind)
        lead = (b,) if b else ()
        if pol.is_integer:
            x = torch.randint(-128, 128, lead + (m, k), generator=g,
                              device="cuda").to(torch.int8)
            y = torch.randint(0, 256, lead + (k, n), generator=g,
                              device="cuda").to(torch.uint8)
        else:
            x = torch.randn(lead + (m, k), generator=g, device="cuda",
                            dtype=torch.float64 if fam == "F64GER"
                            else torch.float32).to(pol.x_dtype)
            y = (torch.randn(lead + (k, n), generator=g, device="cuda",
                             dtype=x.dtype if fam == "F64GER"
                             else torch.float32) * k ** -0.5).to(pol.y_dtype)
        c = (torch.randn(lead + (m, n), generator=g, device="cuda")
             if seeded else None)
        masks = _lane_masks(torch, g, m, n, k)
        xm, ym, pm = masks
        if not pol.is_integer:     # NaN and Inf where the lanes are off
            x[..., ~xm, :] = float("nan")
            x[..., ~pm] = float("inf")
            y[..., ~pm, :] = float("nan")
            y[..., ~ym] = float("-inf")
        operands.append((name, kind, pol, b, m, k, n, x, y, c, masks))

    # I4GER8, which contract refuses: a column mask alone takes the IMMA
    # kernel's column predicate through ops.mma_pm_dot (nibbles packed
    # two a byte along K, at I8GER4's case's 4096^3)
    x4, y4 = (torch.randint(-128, 128, s, generator=g, device="cuda").to(
        torch.int8) for s in ((4096, 2048), (2048, 4096)))
    ym4 = torch.rand(4096, generator=g, device="cuda") > 0.3

    # the main path: the entry points a user calls
    kernels = kernel_wrappers()
    outs = []
    torch.cuda.synchronize()
    zero_counts(kernels)
    with facility.configure(facility.FacilityConfig(device="cuda")):
        for name, kind, pol, b, m, k, n, x, y, c, masks in operands:
            spec = "bmk,bkn->bmn" if b else "mk,kn->mn"
            outs.append(facility.contract(
                spec, x, y, acc=c, masks=masks,
                plan=facility.Plan(ger=kind, out_dtype=facility.ACC)))
        name, kind, pol, b, m, k, n, x, y, c, masks = operands[0]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            shim = O.mma_pm_dot(x, y, kind=kind, xmask=masks[0],
                                ymask=masks[1], pmask=masks[2])
            i4 = O.mma_pm_dot(x4, y4, kind=Ger.I4GER8, xmask=None,
                              ymask=ym4)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    PHASE8["masked products"] = counts
    print(f"  phase 8: masked products through contract(masks=) and "
          f"ops.mma_pm_dot: launches {counts['launches']}, GEMM by path "
          f"{counts['by_path']['mma_gemm']}, masked by path "
          f"{counts['masked']}")
    _check(failures, "ops.mma_pm_dot", torch.equal(shim, outs[0]),
           "bit for bit contract(masks=)")
    _check(failures, "ops.mma_pm_dot I4GER8 column mask 4096^3",
           torch.equal(i4, G.mma_gemm_plain(x4, y4, kind=Ger.I4GER8,
                                            masks=(None, ym4, None)))
           and bool((i4[:, ~ym4] == 0).all()),
           "bit for bit the plain version, exact zeros on disabled columns")
    del x4, y4, i4

    rows = {}
    for (name, kind, pol, b, m, k, n, x, y, c, masks), out in zip(
            operands, outs):
        xm, ym, pm = masks
        path, cfg = tiling.choose_gemm_path(m, n, k, kind, b or 1, True,
                                            None, True)
        label = f"masked {name} {'%dx' % b if b else ''}{m}x{k}x{n} ({path})"
        plain = G.mma_gemm_plain(x, y, c, kind=kind, masks=masks)
        finite = pol.is_integer or bool(out.isfinite().all())
        if pol.is_integer:
            ok = torch.equal(out, plain)
            _check(failures, label, ok, "bit for bit the plain version")
            err = 0.0 if ok else float("inf")
        elif kind == Ger.F64GER:
            xs, ys = G.select_masks(x, y, masks)
            tol = 1e-15 * k * xs.abs().max().item() * ys.abs().max().item()
            err = (out - plain).abs().max().item()
            _check(failures, label, finite and err <= tol,
                   f"max|err| {err:.3e} (tol 1e-15*K*max|x|*max|y| "
                   f"{tol:.3e}), finite")
        else:
            err = _report_close(torch, label, out.float(), plain.float(),
                                torch.float32, failures)
            _check(failures, label, finite, "finite (NaN/Inf lanes off)")
        if c is None:
            zero = bool((out[..., ~xm, :] == 0).all()) \
                and bool((out[..., ~ym] == 0).all())
            _check(failures, label, zero, "exact zeros on disabled rows "
                   "and columns")
        blk = (cfg.bm, cfg.bn, cfg.bk) if path == "wmma" else None
        before = dict(G.mma_gemm.launches_by_path)
        G.mma_gemm(x, y, c, kind=kind)
        default = _path_taken(G.mma_gemm, before)
        if pol.is_integer:
            def library():    # s8 x s8: not the same function as s8 x u8
                return torch._int_mm(
                    torch.where(xm[:, None] & pm, x, 0),
                    torch.where(pm[:, None] & ym, y, 0).to(torch.int8))
        else:
            def library():
                xs = torch.where(xm[:, None] & pm, x, 0)
                ys = torch.where(pm[:, None] & ym, y, 0)
                z = torch.matmul(xs, ys)
                return z if c is None else z + c
        row = {"ms": timer(lambda: G.mma_gemm(x, y, c, kind=kind,
                                              masks=masks)),
               "unmasked_ms": timer(lambda: G.mma_gemm(x, y, c, kind=kind,
                                                       block=blk)),
               "default_ms": timer(lambda: G.mma_gemm(x, y, c, kind=kind)),
               "default_path": default,
               "plain_ms": timer(lambda: G.mma_gemm_plain(
                   x, y, c, kind=kind, masks=masks)),
               "library_ms": timer(library)}
        # the work this run's masks leave: enabled rows, columns and ranks
        mo, no, ko = (int(t.sum()) for t in masks)
        bb = b or 1
        nbytes = (bb * (mo * ko * x.element_size() + ko * no * y.element_size()
                        + m * n * 4 * (2 if c is not None else 1))
                  + m + n + k)
        peak = {"BF16GER2": "bf16", "F32GER": "f32", "I8GER4": "int8",
                "F64GER": "f64"}[kind.name]
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 2 * bb * mo * no * ko, peak)
        print(f"  time {label}: masked {row['ms']:.4f} ms, same kernel "
              f"unmasked {row['unmasked_ms']:.4f} ms, default path "
              f"({default}) {row['default_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, where + library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}; {mo}/{m} rows, {no}/{n} columns, "
              f"{ko}/{k} ranks on)")
        rows.setdefault(path, {})[label] = (row, err)
    del operands, outs

    sources = {"wmma": "src/repro_torch/csrc/mma_gemm.cu, "
                       "src/repro_torch/csrc/tile_gemm.cuh",
               "imma": "src/repro_torch/csrc/gemm_imma.cu",
               "dmma": "src/repro_torch/csrc/gemm_dmma.cu"}
    entries = []
    for path, by_label in rows.items():
        label, (row, _) = next(iter(by_label.items()))
        e = {"name": f"mma_gemm masked ({path})", "route": "cuda",
             "source": sources[path],
             "replaces": "src/repro/kernels/mma_gemm.py:121",
             "max_abs_err": max(err for _, err in by_label.values()),
             **row, "shape": label,
             "launches": counts["masked"][path],
             "timed": {lb: r for lb, (r, _) in by_label.items()}}
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched on phase 8's "
                            f"masked run")
        entries.append(e)
    return entries + phase8_attention(torch, timer, failures)


def _tf32_control(torch, label, q, k, v, got, kw, failures):
    """The control of the f32 rounding budget: the plain version on q and
    k rounded to TF32 (10 mantissa bits, to nearest: what a TF32
    tensor-core product reads; ``allow_tf32`` would not do, as cuBLAS
    keeps a one-query product off the tensor cores) must land outside
    the tolerance that the fp32 tile met (the budget plus 2^-20 *
    max|ref|), or the budget could not tell fp32 scores from TF32 ones.
    Returns both max err/tol readings."""
    from repro_torch.kernels import mma_attention as A

    def tf32(t):
        return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    want = A.flash_attention_plain(q, k, v, **kw)
    tol = A.rounding_budget(q, k, v, **kw) + 2.0 ** -20 * want.abs().max()
    scores = A.flash_attention_plain(tf32(q), tf32(k), v, **kw)
    ratios = {"budget_ratio": ((got - want).abs() / tol).max().item(),
              "tf32_budget_ratio":
                  ((scores - want).abs() / tol).max().item()}
    ok = ratios["tf32_budget_ratio"] > 2
    print(f"  [{'ok' if ok else 'FAIL'}] control {label}: max err/tol, "
          f"fp32 tile {ratios['budget_ratio']:.3f}, plain version on "
          f"TF32-rounded q and k {ratios['tf32_budget_ratio']:.3f} (must "
          f"exceed 2)")
    if not ok:
        failures.append(f"{label}: the f32 budget admits TF32 scores")
    return ratios


def phase8_attention(torch, timer, failures):
    """K2e at the F32GER runs' attention shapes: each held against its
    plain version (``check_attn_case``: the rounding budget, with no P
    rounding in f32) and the budget's TF32 control (``_tf32_control``),
    and timed beside the plain version and SDPA on f32 inputs (TF32 off),
    with its bound at the fp32 peak; the entries' launches are the F32GER
    runs' (PHASE8), by mode."""
    from repro_torch.kernels import mma_attention as A

    g = torch.Generator(device="cuda").manual_seed(21)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, qs, ks, causal in F32_ATTENTION:
        q, k, v = (torch.randn(s, generator=g, device="cuda")
                   for s in (qs, ks, ks))
        kw = dict(causal=causal)
        n_split, _ = A.split_kv_plan(qs[2], qs[1], ks[1])
        mode = "split" if n_split > 1 else "tile"
        label = f"f32 {name} {qs} over {ks[1]} ({mode})"
        err, got = check_attn_case(torch, label, q, k, v, kw, failures)
        ratios = _tf32_control(torch, label, q, k, v, got, kw, failures)
        del got
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {"ms": timer(lambda: A.mma_flash_attention(q, k, v, **kw)),
               "plain_ms": timer(lambda: A.flash_attention_plain(
                   q, k, v, **kw)),
               "library_ms": timer(lambda: sdpa(qt, kt, vt,
                                                is_causal=causal))}
        b, sq, h, d = qs
        pairs = A.attn_live_pairs(sq, ks[1], causal=causal)
        row["bound_ms"], row["bound_by"] = bound_ms(
            (2 * q.numel() + k.numel() + v.numel()) * 4,
            4 * d * pairs * h * b, "f32")
        row.update(ratios)
        print(f"  time attn {label}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, sdpa f32 {row['library_ms']:.4f} "
              f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows.setdefault(mode, {})[label] = (row, err)
    entries = []
    for mode, by_label in rows.items():
        label, (row, _) = next(iter(by_label.items()))
        by_run = {r: c["attn_by_mode"].get(f"f32_{mode}", 0)
                  for r, c in PHASE8.items() if "attn_by_mode" in c}
        e = {"name": f"mma_flash_attention f32 ({mode})", "route": "cuda",
             "source": "src/repro_torch/csrc/mma_attention.cu",
             "replaces": "src/repro/kernels/mma_attention.py:193",
             "max_abs_err": max(err for _, err in by_label.values()),
             **row, "shape": label, "launches_by_run": by_run,
             "launches": sum(by_run.values()),
             "timed": {lb: r for lb, (r, _) in by_label.items()}}
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched on phase 8's "
                            f"F32GER runs")
        entries.append(e)
    return entries



# ----------------------------------------------------------------------
# Phase 9: guarded serving and ABFT (runtime/faults.py, the guarded
# kernel -> torch -> ref ladder, core/abft.py) and K1e, the GEMM kernels'
# checksum sidecar, with K2 at ABFT's depth D + 1
# ----------------------------------------------------------------------

# The fault matrix's settings (launch/serve.py's run_fault_matrix
# defaults, the reference's), on full-width, full-depth deepseek-7b.
MATRIX = dict(batch=2, prompt_len=8, gen_len=6, n_requests=4)
# Per phase-9 run: its launches (by path, with the sidecar, attention by
# mode and at a padded depth) and what it showed.
PHASE9: dict[str, dict] = {}


def zero_counts9(kernels):
    """zero_counts, and the sidecar's and the padded depths' counts."""
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_gemm as G
    zero_counts(kernels)
    G.mma_gemm.checksum_launches_by_path = dict.fromkeys(G.SIDECAR_PATHS, 0)
    A.mma_flash_attention.padded_launches_by_mode = dict.fromkeys(A.MODES, 0)


def read_counts9(kernels):
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_gemm as G
    return {**read_counts(kernels),
            "sidecar": dict(G.mma_gemm.checksum_launches_by_path),
            "padded": dict(A.mma_flash_attention.padded_launches_by_mode)}


def _same_record(torch, rec, ref) -> bool:
    return len(rec) == len(ref) and all(
        len(a) == len(b) and a[0] == b[0]
        and all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
        for a, b in zip(rec, ref))


def guarded_serves(torch, failures, model, cfg, natural):
    """Phase 9's serving runs of deepseek-7b at full width and depth, right
    after its phase-3 run (``natural``: that run's stats, launches and
    recorded steps), each with every count zeroed just before it and read
    just after: (1) guards on, ABFT off: every prefill and decode output
    bit for bit phase 3's, no guard event, every contract dispatch counted
    on the kernel rung; (2) ``serve_loop(..., abft=True)``: no verdict, no
    demotion, each prefill's logits within phase 3's logits bound of phase
    3's (relative L2: the attn augmentation moves rounding only), the
    GEMM sidecar launched on the weight stream and the wgmma tile and the
    attention kernel at the padded depth 129; (3) ``run_fault_matrix``:
    every scenario ok, ``sdc`` detected by a kernel-rung check that read
    the sidecar, and recovered.  Decode tok/s of each beside phase 3's."""
    from repro_torch.core import abft, facility, lowering
    from repro_torch.launch import serve as S

    kernels = kernel_wrappers()
    runs = {}
    for run, kw in (("guards", dict(guards=True)),
                    ("abft", dict(guards=True, abft=True))):
        rec = []
        lowering.clear_guard_state()
        lowering.DISPATCH_COUNTS.clear()
        with facility.configure(facility.FacilityConfig(device="cuda",
                                                        **kw)), \
                recording_steps(rec):
            torch.cuda.synchronize()
            zero_counts9(kernels)
            out = S.serve_loop(cfg, model, **SERVE)
            counts = read_counts9(kernels)
        rungs = {}
        for (r, _, _), n in lowering.DISPATCH_COUNTS.items():
            rungs[r] = rungs.get(r, 0) + n
        out.pop("abft_verdicts")
        print(f"  phase 9: {cfg.name} serve, {kw}: {json.dumps(out)}")
        print(f"  phase 9: launches {counts['launches']}, GEMM by path "
              f"{counts['by_path']['mma_gemm']}, with the sidecar "
              f"{counts['sidecar']}, attention at a padded depth "
              f"{counts['padded']}; dispatches by rung {rungs}")
        name = f"{cfg.name} {run} serve"
        _check(failures, name, out["completed"] == SERVE["n_requests"]
               and lowering.GUARD_EVENTS == [] and set(rungs) == {"kernel"},
               f"{out['completed']} of {SERVE['n_requests']} requests, "
               f"{len(lowering.GUARD_EVENTS)} guard events, dispatches on "
               f"{sorted(rungs)} (only the kernel rung)")
        runs[run] = (out, counts, rec)
        PHASE9[name] = {**counts, "tok_s": out["tokens_per_s"],
                        "tok_s_phase3": natural["stats"]["tokens_per_s"]}
    out, counts, rec = runs["guards"]
    _check(failures, f"{cfg.name} guards serve", _same_record(
        torch, rec, natural["record"]) and counts["launches"]
        == natural["launches"], f"{len(rec)} prefill/decode outputs (token "
        f"ids and logits) bit for bit phase 3's, launches phase 3's")
    out, counts, rec = runs["abft"]
    pre = [(a[1], b[1]) for a, b in zip(rec, natural["record"])
           if a[0] == b[0] == "prefill"]
    rels = [_rel(a.float(), b.float()) for a, b in pre]
    tol = LOGIT_TOLS[cfg.name, "prefill logits"]
    ticks = [(a[1], b[1]) for a, b in zip(rec, natural["record"])
             if a[0] == b[0] == "decode"]
    same = next((i for i, (a, b) in enumerate(ticks)
                 if not torch.equal(a, b)), len(ticks))
    _check(failures, f"{cfg.name} abft serve", out["abft_detections"] == 0
           and len(pre) == SERVE["n_requests"] and max(rels) < tol,
           f"{out['abft_detections']} verdicts; {len(pre)} prefills' logits "
           f"vs phase 3's rel L2 max {max(rels):.3e} (phase 3's bound "
           f"{tol:.3e}); the first {same} of {len(ticks)} decode ticks' "
           f"tokens equal phase 3's")
    _check(failures, f"{cfg.name} abft serve",
           counts["sidecar"]["stream"] > 0 and counts["sidecar"]["wgmma"] > 0
           and counts["padded"]["tile"] > 0,
           "GEMM sidecar on the weight stream and the wgmma tile, attention "
           "at the padded depth 129 on the tile")
    PHASE9[f"{cfg.name} abft serve"].update(prefill_rel_l2=max(rels),
                                            same_ticks=same)
    print(f"  phase 9: decode tok/s: phase 3 "
          f"{natural['stats']['tokens_per_s']:.2f}, guards "
          f"{runs['guards'][0]['tokens_per_s']:.2f}, abft "
          f"{out['tokens_per_s']:.2f}")

    lowering.clear_guard_state()
    t0 = time.perf_counter()
    with facility.configure(facility.FacilityConfig(device="cuda")):
        torch.cuda.synchronize()
        zero_counts9(kernels)
        results = S.run_fault_matrix(cfg, model, **MATRIX)
        counts = read_counts9(kernels)
    wall = time.perf_counter() - t0
    for r in results:
        print(f"  [{'ok' if r['ok'] else 'FAIL'}] phase 9: fault matrix "
              f"{r['scenario']:16s} completed={r['completed']} "
              f"faults={r['fired']} demotions={r['demotions']} "
              f"abft={r['abft_detections']} nan={r['nan_steps']} "
              f"crashes={r['step_faults']} preempt={r['preemptions']} "
              f"requeue={r['requeues']} "
              f"pages_hw={r['pages']['high_water_pages']} "
              f"wall {r['wall_s']:.2f} s")
        if not r["ok"]:
            failures.append(f"fault matrix {r['scenario']}")
    sdc = next(r for r in results if r["scenario"] == "sdc")
    gemm = [v for v in sdc["abft_verdicts"] if v["op_class"] == "gemm"]
    _check(failures, "fault matrix sdc", len(results) == 7 and gemm
           and all(v["recovered"] and v["detail"].get("sidecar")
                   for v in gemm),
           f"{len(results)} scenarios; sdc's gemm verdicts "
           f"{[(v['rung'], v['how'], v['recovered'], v['detail']) for v in gemm]}"
           f" (recovered, detected by a check that read the sidecar)")
    print(f"  phase 9: fault matrix {MATRIX}: {wall:.1f} s wall; launches "
          f"{counts['launches']}, with the sidecar {counts['sidecar']}")
    PHASE9[f"{cfg.name} fault matrix"] = {**counts, "wall_s": wall}
    lowering.clear_guard_state()


# ABFT runs through facility.contract (the entry point) of the products and
# attention calls the deepseek-7b serve does not reach: (name, kind,
# operand shapes, plan keywords).  F32GER and an unaligned pitch take the
# WMMA tile, F64GER the DMMA kernel; the conv at whisper's conv2 shape with
# no epilogue gets ABFT's 769th filter column (K3's WMMA tile by its
# alignment rule); attention at D + 1 in every mode.
ABFT_CONTRACT_RUNS = (
    ("F32GER MLP 1024x4096x11008", "gemm", "F32GER",
     ((1024, 4096), (4096, 11008)), {}),
    ("bf16 logits 1024x768x51865", "gemm", "BF16GER2",
     ((1024, 768), (768, 51865)), {}),
    ("DGEMM 2048^3", "gemm", "F64GER", ((2048, 2048), (2048, 2048)), {}),
    ("conv1d whisper conv2 (F 768 + 1)", "conv", "BF16GER2",
     ((4, 3000, 768), (3, 768, 768)), dict(stride=2, padding="same")),
    ("attn deepseek prefill D=128+1", "attn", "BF16GER2",
     ((4, 256, 32, 128), (4, 256, 32, 128)), dict(causal=True)),
    ("attn one query over 288 D=128+1", "attn", "BF16GER2",
     ((4, 1, 32, 128), (4, 288, 32, 128)), dict(causal=True, q_offset=287)),
    ("attn whisper encoder D=64+1", "attn", "BF16GER2",
     ((4, 1500, 12, 64), (4, 1500, 12, 64)), dict(causal=False)),
    ("attn whisper cross D=64+1", "attn", "BF16GER2",
     ((4, 1, 12, 64), (4, 1500, 12, 64)), dict(causal=False)),
    ("attn F32GER prefill D=128+1", "attn", "F32GER",
     ((1, 256, 32, 128), (1, 256, 32, 128)), dict(causal=True)),
    ("attn F32GER decode D=128+1", "attn", "F32GER",
     ((4, 1, 32, 128), (4, 288, 32, 128)), dict(causal=True, q_offset=287)),
)


def abft_contract_runs(torch, failures):
    """ABFT_CONTRACT_RUNS through ``facility.contract`` under
    ``FacilityConfig(guards=True, abft=True)``, counts zeroed just before
    and read just after: no verdict, no guard event, each output within
    2e-2 of the same call unguarded (the reference's bound for the
    augmentation; the GEMMs are the unguarded call's bit for bit), and
    the sidecar, K3's WMMA tile and every padded attention mode
    launched."""
    from repro_torch.core import abft, facility, lowering

    Ger = facility.Ger
    g = torch.Generator(device="cuda").manual_seed(21)
    kernels = kernel_wrappers()
    operands = []
    for name, op, fam, shapes, kw in ABFT_CONTRACT_RUNS:
        dt = {"F32GER": torch.float32, "F64GER": torch.float64}.get(
            fam, torch.bfloat16)
        ts = [(torch.randn(s, generator=g, device="cuda",
                           dtype=torch.float64 if dt == torch.float64
                           else torch.float32)
               * (s[-2] ** -0.5 if op != "attn" and i else 1.0)).to(dt)
              for i, s in enumerate(shapes)]
        if op == "attn":
            ts.append(torch.randn(shapes[1], generator=g, device="cuda"
                                  ).to(dt))
        operands.append((name, op, Ger[fam], ts, kw))

    def call(op, ger, ts, kw):
        out = None if ger == Ger.BF16GER2 else (
            torch.float64 if ger == Ger.F64GER else torch.float32)
        plan = facility.Plan(ger=ger, out_dtype=out, **kw)
        spec = {"gemm": "mk,kn->mn", "conv": facility.CONV1D,
                "attn": facility.ATTN}[op]
        return facility.contract(spec, *ts, plan=plan)

    with facility.configure(facility.FacilityConfig(device="cuda")):
        base = [call(op, ger, ts, kw) for _, op, ger, ts, kw in operands]
    lowering.clear_guard_state()
    torch.cuda.synchronize()
    zero_counts9(kernels)
    t0 = time.perf_counter()
    with facility.configure(facility.FacilityConfig(
            device="cuda", guards=True, abft=True)):
        outs = [call(op, ger, ts, kw) for _, op, ger, ts, kw in operands]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts9(kernels)
    verdicts = abft.drain_verdicts()
    for (name, op, *_), a, b in zip(operands, outs, base):
        r = _rel(a.float(), b.float())
        ok = (torch.equal(a, b) if op == "gemm" else r < 2e-2) and bool(
            torch.isfinite(a).all())
        print(f"  [{'ok' if ok else 'FAIL'}] phase 9: abft {name}: "
              f"{tuple(a.shape)} vs unguarded rel L2 {r:.3e}"
              + (" (bit for bit)" if op == "gemm" else " (tol 2e-2)"))
        if not ok:
            failures.append(f"abft {name}")
    _check(failures, "abft contract runs", verdicts == []
           and lowering.GUARD_EVENTS == []
           and counts["sidecar"]["wmma"] >= 2
           and counts["sidecar"]["dmma"] >= 1
           and counts["by_path"]["mma_conv2d"].get("wmma", 0) >= 1
           and all(counts["padded"][m] > 0 for m in counts["padded"]),
           f"{len(verdicts)} verdicts, {len(lowering.GUARD_EVENTS)} guard "
           f"events; sidecar {counts['sidecar']}, conv by path "
           f"{counts['by_path']['mma_conv2d']}, attention at a padded depth "
           f"{counts['padded']} ({wall:.2f} s)")
    PHASE9["abft contract runs"] = {**counts, "wall_s": wall}
    del operands, outs, base


# The sidecar's timed shapes, at the runs' products: (label, family, M,
# K, N); "split" and "1" name the weight stream's split of K.
SIDECAR_TIMED = (
    ("stream", "decode 4x4096x11008 (split)", "BF16GER2", 4, 4096, 11008),
    ("stream", "decode logits 4x4096x102400 (split 1)", "BF16GER2", 4,
     4096, 102400),
    ("wgmma", "prefill 1024x4096x11008", "BF16GER2", 1024, 4096, 11008),
    ("wmma", "F32GER 1024x4096x11008", "F32GER", 1024, 4096, 11008),
    ("wmma", "unaligned 1024x768x51865", "BF16GER2", 1024, 768, 51865),
    ("dmma", "DGEMM 2048^3", "F64GER", 2048, 2048, 2048),
)


def phase9_kernels(torch, timer, failures):
    """Each sidecar kernel at SIDECAR_TIMED: ``checksum=True`` bit for bit
    ``checksum=False``, the sums within ABFT's tolerance of the plain
    version's (``mma_gemm_sidecar_plain``), each timed on and off beside
    the plain version, ``torch.matmul`` and the bound; then K2 at D + 1
    (129 and 65) in every mode against its plain version, and timed at
    deepseek's prefill beside the unpadded D = 128 and SDPA.  Returns the
    ``kernels`` entries (launches: phase 9's runs')."""
    from repro_torch.core import abft, precision, tiling
    from repro_torch.kernels import mma_attention as A
    from repro_torch.kernels import mma_gemm as G

    Ger = precision.Ger
    g = torch.Generator(device="cuda").manual_seed(22)
    rows = {}
    for path, label, fam, m, k, n in SIDECAR_TIMED:
        kind = Ger[fam]
        pol = precision.policy(kind)
        wide = torch.float64 if fam == "F64GER" else torch.float32
        x = torch.randn(m, k, generator=g, device="cuda", dtype=wide).to(
            pol.x_dtype)
        y = (torch.randn(k, n, generator=g, device="cuda", dtype=wide)
             * k ** -0.5).to(pol.y_dtype)
        took, cfg = tiling.choose_gemm_path(m, n, k, kind, 1,
                                            G.natural_aligned(x, y))
        out, ck_col, ck_row = G.mma_gemm(x, y, kind=kind, checksum=True)
        same = torch.equal(out, G.mma_gemm(x, y, kind=kind))
        _, want_col, want_row = G.mma_gemm_sidecar_plain(x, y, kind=kind)
        mag = x.double().abs() @ y.double().abs()
        mag_col, mag_row = G.checksum_tiles(mag, *G.sidecar_tile(
            took, cfg, m))
        eps = torch.finfo(pol.acc_dtype).eps
        err = max((a.double() - b.double()).abs().max().item()
                  for a, b in ((ck_col, want_col), (ck_row, want_row)))
        ok = same and took == path and all(bool(
            ((a.double() - b.double()).abs()
             <= abft.ATOL + abft.FACTOR * eps * mg).all())
            for a, b, mg in ((ck_col, want_col, mag_col),
                             (ck_row, want_row, mag_row)))
        del mag, mag_col, mag_row
        print(f"  [{'ok' if ok else 'FAIL'}] phase 9: sidecar {label} on "
              f"{took}{f' split {cfg.split}' if took == 'stream' else ''}: "
              f"out bit for bit {same}; sums vs plain max|err| {err:.3e} "
              f"(tol ATOL + FACTOR*eps*|X||Y| summed alike)")
        if not ok:
            failures.append(f"sidecar {label}")
        row = {name: timer(fn) for name, fn in (
            ("ms", lambda: G.mma_gemm(x, y, kind=kind, checksum=True)),
            ("off_ms", lambda: G.mma_gemm(x, y, kind=kind)),
            ("plain_ms", lambda: G.mma_gemm_sidecar_plain(x, y, kind=kind)),
            ("library_ms", lambda: torch.matmul(x, y)))}
        acc = pol.acc_dtype.itemsize
        ck_bytes = (ck_col.numel() + ck_row.numel()) * acc
        row["bound_ms"], row["bound_by"] = bound_ms(
            (m * k + k * n) * x.element_size() + m * n * acc + ck_bytes,
            2 * m * n * k, {"BF16GER2": "bf16", "F32GER": "f32",
                            "F64GER": "f64"}[fam])
        print(f"  time sidecar {label}: on {row['ms']:.4f} ms, off "
              f"{row['off_ms']:.4f} ms ({row['ms'] / row['off_ms']:.3f}x), "
              f"plain {row['plain_ms']:.4f} ms, torch.matmul "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
        rows.setdefault(path, []).append((label, row, err))
        del x, y, out, ck_col, ck_row, want_col, want_row

    # K2 at D + 1 in every mode, then timed at deepseek's prefill
    worst = 0.0
    cases = (("tile", torch.bfloat16, (4, 256, 32, 32), 256, True),
             ("split", torch.bfloat16, (4, 1, 32, 32), 288, True),
             ("f32_tile", torch.float32, (1, 256, 32, 32), 256, True),
             ("f32_split", torch.float32, (4, 1, 32, 32), 288, True))
    for d in (129, 65):
        for mode, dt, (b, sq, h, kvh), sk, causal in cases:
            q, k, v = (torch.randn(s, generator=g, device="cuda").to(dt)
                       for s in ((b, sq, h, d), (b, sk, kvh, d),
                                 (b, sk, kvh, d)))
            kw = dict(causal=causal, q_offset=sk - sq,
                      out_dtype=torch.float32)
            before = A.mma_flash_attention.padded_launches_by_mode[mode]
            e, _ = check_attn_case(torch, f"attention D={d} {mode} "
                                   f"({b},{sq},{h})x{sk}", q, k, v, kw,
                                   failures)
            worst = max(worst, e)
            if A.mma_flash_attention.padded_launches_by_mode[mode] \
                    != before + 1:
                failures.append(f"attention D={d} {mode}: not a padded "
                                f"launch of {mode}")
    b, s, h, d = 4, 256, 32, 129
    q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    q8, k8, v8 = (t[..., :128].contiguous() for t in (q, k, v))
    att = {name: timer(fn) for name, fn in (
        ("ms", lambda: A.mma_flash_attention(q, k, v, causal=True)),
        ("d128_ms", lambda: A.mma_flash_attention(q8, k8, v8, causal=True)),
        ("plain_ms", lambda: A.flash_attention_plain(q, k, v, causal=True)),
        ("library_ms", lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)))}
    pairs = A.attn_live_pairs(s, s, causal=True)
    att["bound_ms"], att["bound_by"] = bound_ms(
        4 * b * s * h * d * 2, 4 * b * h * d * pairs, "bf16")
    print(f"  time attention D=129 ({b},{s},{h}) causal (padded to 192): "
          f"{att['ms']:.4f} ms, at D=128 {att['d128_ms']:.4f} ms, plain "
          f"{att['plain_ms']:.4f} ms, SDPA {att['library_ms']:.4f} ms, "
          f"bound {att['bound_ms']:.4f} ms ({att['bound_by']})")

    launched = {"sidecar": {}, "padded": {}}
    for r in PHASE9.values():
        for key in launched:
            for p, n in r.get(key, {}).items():
                launched[key][p] = launched[key].get(p, 0) + n
    sources = {"stream": "src/repro_torch/csrc/gemm_stream.cu",
               "wgmma": "src/repro_torch/csrc/gemm_wgmma.cu, "
                        "src/repro_torch/csrc/wgmma_tile.cuh",
               "wmma": "src/repro_torch/csrc/mma_gemm.cu",
               "dmma": "src/repro_torch/csrc/gemm_dmma.cu"}
    entries = []
    for path, timed in rows.items():
        label, row, _ = timed[0]
        e = {"name": f"mma_gemm sidecar ({path})", "route": "cuda",
             "source": sources[path] + ", src/repro_torch/csrc/common.cuh",
             "replaces": "src/repro/kernels/mma_gemm.py:163",
             "max_abs_err": max(err for _, _, err in timed), **row,
             "shape": label,
             "launches": launched["sidecar"].get(path, 0),
             "launches_by_run": {n: r["sidecar"][path]
                                 for n, r in PHASE9.items()
                                 if "sidecar" in r},
             "timed": {lb: r for lb, r, _ in timed}}
        entries.append(e)
    entries.append({
        "name": "mma_flash_attention padded depth (D + 1)", "route": "cuda",
        "source": "src/repro_torch/csrc/mma_attention.cu, "
                  "src/repro_torch/csrc/wgmma_ops.cuh",
        "replaces": "src/repro/kernels/mma_attention.py:193",
        "max_abs_err": worst, **att,
        "shape": f"B={b} S={s} H={h} D={d} bf16 causal",
        "launches": sum(launched["padded"].values()),
        "launches_by_mode": launched["padded"]})
    for e in entries:
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched in phase 9's runs")
    return entries


def phase9(torch, failures, entries):
    """Phase 9: the serving runs (a) ran after deepseek-7b's phase-3 run;
    here the ABFT contract runs, then the sidecar kernels and K2 at D + 1."""
    print("== phase 9: guarded serving and ABFT (runtime/faults.py, the "
          "guarded ladder, core/abft.py) and K1e, the GEMM sidecar",
          flush=True)
    t0 = time.perf_counter()
    abft_contract_runs(torch, failures)
    torch.cuda.empty_cache()
    timer = Timer(torch)
    entries += phase9_kernels(torch, timer, failures)
    del timer
    print(f"  phase 9 (after the serves): {time.perf_counter() - t0:.1f} s")


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

    print("== phase 3: serve and generate (and phase 8's F32GER runs of "
          "deepseek-7b and whisper-small, phase 9's guarded and ABFT serves "
          "and fault matrix of deepseek-7b, and phase 7's prepacked runs of "
          "deepseek-7b, deepseek-moe-16b, whisper-small and qwen2-vl-7b "
          "after their natural runs)", flush=True)
    by_run = {}
    for arch, settings, layers, profile in (
            (ARCH, SERVE, NUM_LAYERS, True),
            *((a, st, None, a == "zamba2-1.2b") for a, st in SSM_RUNS),
            (*MOE_RUN, None, True)):
        record = [] if arch == ARCH else None
        stats, by_run[arch], (model, cfg) = serve(
            torch, failures, arch, settings, layers, record)
        if profile:
            step_breakdown(torch, cfg, *serve_steps(torch, model, cfg,
                                                    settings))
        if arch == ARCH:
            natural = {"stats": stats, "launches": by_run[arch],
                       "record": record, "by_path": RECORDS[arch]["by_path"]}
            f32_serve(torch, failures, model, cfg)
            t9 = time.perf_counter()
            guarded_serves(torch, failures, model, cfg, natural)
            print(f"  phase 9's serving runs: {time.perf_counter() - t9:.1f}"
                  f" s", flush=True)
            prepacked_serve(torch, failures, arch, settings, model, cfg,
                            natural)
            del natural
        elif arch == MOE_RUN[0]:
            # phase 3's first `batch` requests' prompts, decoded on a
            # fresh cache
            from repro_torch.launch import serve as S
            reqs = S._make_requests(cfg, settings["n_requests"],
                                    settings["prompt_len"],
                                    settings["gen_len"], 0)
            prompts = torch.cat([torch.from_numpy(r.prompt)
                                 for r in reqs[:settings["batch"]]])
            prepacked_steps(torch, failures, arch, model, cfg,
                            {"tokens": prompts.cuda()},
                            settings["prompt_len"] + PREPACK_STEPS + 1)
        del model, record
        torch.cuda.empty_cache()
    for arch, settings in MM_RUNS.items():
        by_run[arch], steps, (model, batch, seq_len) = generate(
            torch, failures, arch, settings)
        step_breakdown(torch, *steps)
        cfg = steps[0]
        del steps
        if arch == "whisper-small":
            f32_generate(torch, failures, model, cfg)
        prepacked_steps(torch, failures, arch, model, cfg, batch, seq_len)
        del model, batch
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

    print("== phase 6: the family table and its paths", flush=True)
    timer = Timer(torch)
    worst = check_families(torch, failures)
    new, others = family_runs(torch, timer, failures, by_run, worst)
    entries += new
    entries[0]["phase6_shapes"] = others
    del timer
    for e in entries:
        e["launches_by_run"] = {
            a: (RECORDS[a]["by_path"]["mma_gemm"][PATH_ENTRIES[e["name"]]]
                if e["name"] in PATH_ENTRIES else n[e["name"]])
            for a, n in by_run.items()}
        e["launches"] = sum(e["launches_by_run"].values())
        if e["name"] in BY_PATH:
            e["launches_by_path"] = {
                p: sum(r["by_path"][e["name"]][p] for r in RECORDS.values())
                for p in next(iter(RECORDS.values()))["by_path"][e["name"]]}
    for e in new:
        if e["launches"] <= 0:
            failures.append(f"{e['name']} never launched on phase 6's "
                            f"paths")

    print("== phase 7: prepacked serving (core/packing.py; K1d and K3's "
          "packed filter stream)", flush=True)
    for name, r in PHASE7.items():
        print(f"  {name}: packed launches {r['packed']}"
              + (f", pack {r['pack_s']:.3f} s, {r['stats']}"
                 if "pack_s" in r else ""))
    timer = Timer(torch)
    qdot_ops = qdot_packed_run(torch, failures)
    entries += phase7_kernels(torch, timer, failures, qdot_ops)
    del timer, qdot_ops

    phase8(torch, failures, entries)
    phase9(torch, failures, entries)
    finish(torch, failures, card, entries, t_start)


def phase8(torch, failures, entries):
    """Phase 8: the F32GER runs (a) and (b) ran after their models' phase-3
    runs; here (c), then the masked products and K2e's timings."""
    print("== phase 8: the pm* masked forms (K1b) and the tight-parity "
          "F32GER config (K2e)", flush=True)
    f32_train(torch, failures)
    torch.cuda.empty_cache()
    timer = Timer(torch)
    entries += phase8_kernels(torch, timer, failures)
    del timer


def finish(torch, failures, card, entries, t_start):
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
