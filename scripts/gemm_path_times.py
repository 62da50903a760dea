#!/usr/bin/env python3
"""Device times and output hashes of the GEMM kernels' natural launches and
of the packed-Y launches of prepacked serving, one source tree at a time,
on one card.

    python scripts/gemm_path_times.py [--tree DIR]

Card only (exits nonzero without CUDA).  Imports ``repro_torch`` from
``DIR/src`` (default: this checkout) and times ``kernels.mma_gemm`` at a
main-path shape of each of the GEMM's five kernels: the weight stream at
decode 4 x 4096 x 11008, the wgmma tile at prefill 1024 x 4096 x 11008,
the WMMA tile at an explicit (128, 128, 32) block there, F32GER at decode
4 x 4096 x 11008 (natural and on packed Y) and at prefill 1024 x 4096 x
11008 (natural, packed Y and masked) and 1024 x 4096 x 4096, the IMMA
kernel at I8GER4 and I16GER2 4096^3 (and I8GER4 masked), the DMMA kernel
at DGEMM 2048^3 (and masked); then the weight as Y panels
(``packing.pack_gemm``) where a prepacked serve reads them: the stream at
decode, deepseek-moe-16b's expert bank 64 x 1 x 2048 x 1408 (batched
panels) on the stream, and the wgmma tile at prefill.  Each case's
inputs come from its own seed; the script prints the path the tree's
dispatch took (from the wrapper's counters) and a SHA-256 of the output's
bytes, so that two trees' outputs can be compared bit for bit.  Times use
chip_smoke.py's Timer (median, L2 flushed, host work hidden); the card's
name and power limit head the output.  To compare two trees, unpack one
beside the other and run the script for each in turn, A B B A, in one
session on one card: the kernels build per tree, into ``DIR/build``.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (label, family, (B, M, K, N), explicit block, masked, Y packed); B
# None: unbatched
CASES = (
    ("stream decode 4x4096x11008", "BF16GER2", (None, 4, 4096, 11008), None,
     False, False),
    ("wgmma prefill 1024x4096x11008", "BF16GER2", (None, 1024, 4096, 11008),
     None, False, False),
    ("wmma block (128, 128, 32) 1024x4096x11008", "BF16GER2",
     (None, 1024, 4096, 11008), (128, 128, 32), False, False),
    ("F32GER decode 4x4096x11008", "F32GER", (None, 4, 4096, 11008), None,
     False, False),
    ("F32GER decode 4x4096x11008 packed Y", "F32GER",
     (None, 4, 4096, 11008), None, False, True),
    ("F32GER prefill 1024x4096x11008", "F32GER", (None, 1024, 4096, 11008),
     None, False, False),
    ("F32GER prefill 1024x4096x11008 packed Y", "F32GER",
     (None, 1024, 4096, 11008), None, False, True),
    ("F32GER prefill 1024x4096x11008 masked", "F32GER",
     (None, 1024, 4096, 11008), None, True, False),
    ("wmma f32 1024x4096x4096", "F32GER", (None, 1024, 4096, 4096), None,
     False, False),
    ("imma I8GER4 4096^3", "I8GER4", (None, 4096, 4096, 4096), None, False,
     False),
    ("imma I8GER4 4096^3 masked", "I8GER4", (None, 4096, 4096, 4096), None,
     True, False),
    ("imma I16GER2 4096^3", "I16GER2", (None, 4096, 4096, 4096), None,
     False, False),
    ("dmma F64GER 2048^3", "F64GER", (None, 2048, 2048, 2048), None, False,
     False),
    ("dmma F64GER 2048^3 masked", "F64GER", (None, 2048, 2048, 2048), None,
     True, False),
    ("stream packed Y decode 4x4096x11008", "BF16GER2",
     (None, 4, 4096, 11008), None, False, True),
    ("stream packed Y bank 64x1x2048x1408", "BF16GER2", (64, 1, 2048, 1408),
     None, False, True),
    ("wgmma packed Y prefill 1024x4096x11008", "BF16GER2",
     (None, 1024, 4096, 11008), None, False, True),
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args()
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke as CS
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script runs on the card only")
    from repro_torch.core import packing, precision
    from repro_torch.kernels import mma_gemm as G
    print(CS.card_line(), flush=True)
    print(f"tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = CS.Timer(torch)
    for i, (label, fam, (b, m, k, n), block, masked, packed) in enumerate(
            CASES):
        g = torch.Generator(device="cuda").manual_seed(11 + i)
        kind = precision.Ger[fam]
        pol = precision.policy(kind)
        lead = () if b is None else (b,)
        if pol.is_integer:
            x, y = CS._int_operands(torch, g, kind, lead, m, k, n)
        else:
            x = torch.randn(*lead, m, k, generator=g, device="cuda"
                            ).to(pol.x_dtype)
            y = (torch.randn(*lead, k, n, generator=g, device="cuda")
                 * k ** -0.5).to(pol.y_dtype)
        masks = CS._lane_masks(torch, g, m, n, k) if masked else None
        kw = dict(kind=kind, block=block, masks=masks)
        if packed:
            po = packing.pack_gemm(y, packing.gemm_layout(
                kind, k, n, batched=b is not None))
            y, kw["y_layout"] = po.data, po.layout
        before = dict(G.mma_gemm.launches_by_path)
        out = G.mma_gemm(x, y, **kw)
        torch.cuda.synchronize()
        took = [p for p, v in G.mma_gemm.launches_by_path.items()
                if v != before[p]]
        if len(took) != 1:
            sys.exit(f"{label}: launched on {took}, not one path")
        digest = hashlib.sha256(
            out.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        ).hexdigest()[:16]
        ms = timer(lambda x=x, y=y, kw=kw: G.mma_gemm(x, y, **kw))
        print(f"  {label}: {ms:.4f} ms [{took[0]}] sha256 {digest}",
              flush=True)
        del x, y, masks, kw, out

if __name__ == "__main__":
    main()
