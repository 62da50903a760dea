#!/usr/bin/env python3
"""Tile and plan sweeps of the port's kernels on one card.

    PYTHONPATH=src python scripts/port_kernel_times.py [--only stream|conv]

Card only (exits nonzero without CUDA).  ``stream``: the weight-stream
kernel (csrc/gemm_stream.cu) at deepseek-7b's decode products for every
64/128-column tile and K split it can launch, fastest first, beside
core.tiling.stream_plan's choice and torch.matmul: the measurement that
stream_plan's rule rests on.  ``conv``: K3 (csrc/mma_conv.cu) at the
main path's three stems (and whisper's conv2 recast as a 2-D conv, whose
image panel the kernel gathers instead of loading it by TMA) on the wgmma
kernel with 128- and 256-column tiles and on the WMMA kernel, beside
choose_conv_path's choice, cuDNN and the TMA-fed wgmma GEMM on the
materialised patch matrix; and K4 at mamba2's four conv shapes on its
vector and scalar paths, with L2 flushed and warm, beside depthwise_plan's
choice and cuDNN's conv1d.
Each launch goes through the kernel's wrapper with the path choice pinned
to the swept one, and is held against the plain version first (K3 within
chip_smoke.py's conv tolerance, K4 bit for bit).  Device times use
chip_smoke.py's Timer (median, L2 flushed, host work hidden); the card's
name and power limit head the output.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402

SPLITS = (1, 2, 3, 4, 5, 6, 8, 12, 16)


def sweep_stream(timer, g) -> None:
    from repro_torch.core import tiling
    from repro_torch.kernels import mma_gemm as G

    choose = tiling.choose_gemm_path
    for m, k, n in ((4, 4096, 4096), (4, 4096, 11008), (4, 11008, 4096)):
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        y = (torch.randn((k, n), generator=g, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        want = G.mma_gemm(x, y, out_dtype=torch.float32)
        runs = []
        try:
            for bn in (64, 128):
                for split in SPLITS:
                    cfg = tiling.StreamConfig(bn=bn, split=split)
                    tiling.choose_gemm_path = (
                        lambda *_, cfg=cfg: ("stream", cfg))
                    err = (G.mma_gemm(x, y, out_dtype=torch.float32)
                           - want).abs().max().item()
                    if err > 2e-5 * want.abs().max().item():
                        CS.fail(f"bn {bn} split {split}: max|err| {err}")
                    runs.append((timer(lambda: G.mma_gemm(x, y), iters=5),
                                 bn, split))
        finally:
            tiling.choose_gemm_path = choose
        runs.sort()
        plan = tiling.stream_plan(m, n, k)
        lib = timer(lambda: torch.matmul(x, y), iters=5)
        print(f"stream {m}x{k}x{n}: " + ", ".join(
            f"bn {b} split {s} {t:.4f} ms" for t, b, s in runs[:6])
            + f"; plan bn {plan.bn} split {plan.split}; torch.matmul "
            f"{lib:.4f} ms", flush=True)


def sweep_conv(timer, g) -> None:
    from repro_torch.core import tiling
    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G

    bf16 = torch.bfloat16
    gelu = E.Epilogue(bias=True, activation="gelu")
    failures = []
    choose = tiling.choose_conv_path
    for name, shape, fshape, stride, ep in (
            ("whisper conv1", (4, 1, 3002, 80), (1, 3, 80, 768), (1, 1),
             gelu),
            ("whisper conv2", (4, 1, 3001, 768), (1, 3, 768, 768), (1, 2),
             gelu),
            # the same product with the 4 clips as rows of one image: a
            # 2-D conv, whose A panel the producer gathers (no TMA box)
            ("whisper conv2 as a 2-D conv", (1, 4, 3001, 768),
             (1, 3, 768, 768), (1, 2), gelu),
            ("qwen2-vl patch embed", (4, 448, 448, 3), (14, 14, 3, 3584),
             (14, 14), E.Epilogue(bias=True))):
        kh, kw, c, f = fshape
        x = torch.randn(shape, generator=g, device="cuda").to(bf16)
        w = (torch.randn(fshape, generator=g, device="cuda")
             * (kh * kw * c) ** -0.5).to(bf16)
        bias = torch.randn(f, generator=g, device="cuda")
        kw_ = dict(stride=stride, out_dtype=bf16, ep=ep, bias=bias)
        want = K.mma_conv2d_plain(x, w, **kw_).float()
        n, h, wd, _ = shape
        m = n * ((h - kh) // stride[0] + 1) * ((wd - kw) // stride[1] + 1)
        runs = []
        try:
            for path, cfg in (("wgmma", tiling.WgmmaConfig(128, 128)),
                              ("wgmma", tiling.WgmmaConfig(128, 256)),
                              ("wmma", tiling.CONV_TILES[
                                  tiling.Ger.BF16GER2][0])):
                tiling.choose_conv_path = lambda *_, p=path, cfg=cfg: (p, cfg)
                label = f"{path} {cfg.bm}x{cfg.bn}"
                CS._report_conv(torch, f"conv2d {name} [{label}]",
                                K.mma_conv2d(x, w, **kw_).float(), want, bf16,
                                failures)
                runs.append((timer(lambda: K.mma_conv2d(x, w, **kw_),
                                   iters=5), label))
        finally:
            tiling.choose_conv_path = choose
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = timer(lambda: torch.nn.functional.conv2d(
            xc, wc, bias.to(bf16), stride=stride), iters=5)
        # The same product on the TMA-fed wgmma GEMM, from the patch
        # matrix materialised beforehand: what the gather costs beyond TMA.
        sh, sw = stride
        oh, ow = (h - kh) // sh + 1, (wd - kw) // sw + 1
        abar = torch.cat([x[:, i:i + (oh - 1) * sh + 1:sh,
                            j:j + (ow - 1) * sw + 1:sw, :]
                          for i in range(kh) for j in range(kw)],
                         dim=-1).reshape(m, kh * kw * c)
        hbar = w.reshape(kh * kw * c, f)
        gemm = timer(lambda: G.mma_gemm(abar, hbar, ep=ep, bias=bias,
                                        out_dtype=bf16), iters=5)
        path, cfg = choose(m, f, tiling.Ger.BF16GER2)
        print(f"conv2d {name}: " + ", ".join(
            f"{label} {t:.4f} ms" for t, label in sorted(runs))
            + f"; plan {path} {cfg.bm}x{cfg.bn}; cuDNN {lib:.4f} ms; "
            f"wgmma GEMM on the patch matrix {gemm:.4f} ms", flush=True)

    silu = E.Epilogue(bias=True, activation="silu")
    plan_fn = tiling.depthwise_plan
    # Inside the model the conv's input was just written by the in_proj
    # GEMM and sits in L2: time K4 with L2 warm too (no flush).
    warm = CS.Timer(torch, flush_bytes=1)
    for name, shape in (("zamba2 prefill", (1, 1, 259, 4224)),
                        ("zamba2 decode", (4, 1, 4, 4224)),
                        ("mamba2-130m prefill", (1, 1, 259, 1792)),
                        ("mamba2-130m decode", (4, 1, 4, 1792))):
        c = shape[-1]
        x = torch.randn(shape, generator=g, device="cuda")
        taps = torch.randn((1, 4, c), generator=g, device="cuda") * 0.3
        bias = torch.randn(c, generator=g, device="cuda")
        want = K.mma_depthwise_conv2d_plain(x, taps)
        kw_ = dict(out_dtype=bf16, ep=silu, bias=bias)
        runs = []
        try:
            for label, vec in (("vector", 4), ("scalar", 0)):
                tiling.depthwise_plan = lambda *_, v=vec: v
                if not torch.equal(K.mma_depthwise_conv2d(x, taps), want):
                    failures.append(f"depthwise {name} {label}")
                runs.append((timer(lambda: K.mma_depthwise_conv2d(
                    x, taps, **kw_)), label, warm(
                        lambda: K.mma_depthwise_conv2d(x, taps, **kw_))))
        finally:
            tiling.depthwise_plan = plan_fn
        xc = x[:, 0].transpose(1, 2).contiguous()
        wc = taps[0].t().contiguous()[:, None]
        lib = timer(lambda: torch.nn.functional.conv1d(xc, wc, bias,
                                                       groups=c))
        vec = plan_fn(c, torch.float32)
        print(f"depthwise {name} {shape}: " + ", ".join(
            f"{label} {t:.4f} ms (warm {tw:.4f})"
            for t, label, tw in sorted(runs))
            + f"; plan {'vector' if vec else 'scalar'}; cuDNN conv1d "
            f"{lib:.4f} ms", flush=True)
    if failures:
        CS.fail(f"{len(failures)} swept configuration(s) disagree with the "
                f"plain version: {failures}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--only", choices=("stream", "conv"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        CS.fail("CUDA is not available: this script times the card")
    torch.backends.cudnn.allow_tf32 = False
    print(CS.card_line())
    timer = CS.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
    if args.only in (None, "stream"):
        sweep_stream(timer, g)
    if args.only in (None, "conv"):
        sweep_conv(timer, g)


if __name__ == "__main__":
    main()
