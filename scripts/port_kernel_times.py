#!/usr/bin/env python3
"""The weight-stream GEMM's tile and K-split sweep on one card.

    PYTHONPATH=src python scripts/port_kernel_times.py

Card only (exits nonzero without CUDA).  Times the weight-stream kernel
(csrc/gemm_stream.cu) at deepseek-7b's decode products for every 64/128-
column tile and K split it can launch, fastest first, beside
core.tiling.stream_plan's choice and torch.matmul: the measurement that
stream_plan's rule rests on.  Each launch goes through ``mma_gemm``, with
the path choice pinned to the swept tile and split.  Device times use
chip_smoke.py's Timer (median, L2 flushed, host work hidden); the card's
name and power limit head the output.
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402

SPLITS = (1, 2, 3, 4, 5, 6, 8, 12, 16)


def main() -> None:
    if not torch.cuda.is_available():
        CS.fail("CUDA is not available: this script times the card")
    from repro_torch.core import tiling
    from repro_torch.kernels import mma_gemm as G

    print(CS.card_line())
    timer = CS.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(0)
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


if __name__ == "__main__":
    main()
