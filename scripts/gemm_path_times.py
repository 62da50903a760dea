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

The 16-bit WMMA tile's forms follow: the (64, 64, 64) block at prefill,
whisper-small's logits 1024 x 768 x 51865 (unaligned rows: the heuristic
sends them to the tile), natural and on Y panels, a masked bf16 prefill,
the SSD's K = 1 outer product, f16, X and Y panels masked over the M, N
and K fringes, and a seeded, batched product on a shared Y with the
checksum sidecar (its hash covers the sums too); then K3's conv at
explicit filter tiles (``CONV_CASES``): the WMMA tile at whisper-small's
conv2 (16-byte gathers), qwen2-vl-7b's patch embed (4-byte pairs) and a
5-channel image (element gathers; one K step with a 1 x 3 filter, eight
with 7 x 7), and the fp32 tile at conv2.  Then the DMMA kernel's forms
(``DMMA_CASES``, after the convs: the fp64 tensor cores warm the card):
DGEMM 2048^3 on X+Y panels and with the sidecar, 8192^3, a skinny 4 x
4096 x 11008 and a ragged 1000 x 999 x 1001, and blas3's complex128
``complex_gemm`` at 4096 and batched float64 ``dft`` (``ENTRY_CASES``,
launches by path printed beside each).

Then chip_smoke.py's phase-15 targets: ``WGMMA_TARGETS`` (the wgmma tile
at deepseek-7b's M = 256 prefill shapes, 1024 x 4096 x 11008 natural, on
X panels and with the sidecar, whisper-small's encoder, deepseek-7b's
train forward and its dW product, f16, packed Y; bf16 out, as the main
path stores) and ``CONV_F32_TARGETS`` (K3 in
f32 at whisper-small's conv1 and conv2 and qwen2-vl-7b's patch embed,
natural and packed, and the bf16 conv2 on the wgmma kernel), each at the
path and tile the tree's dispatch picks: time, the tile printed, the
output hash, the library call (``torch.matmul``; cuDNN
``conv2d``, channels-last, TF32 off) and the bound; ptxas' registers of
the fp32 conv's instances head the output.  ``--only targets``
runs these alone; ``--tiles`` times each wgmma target at every tile the
tree's wgmma kernel is compiled for too (a planted winner: the output
hash must not change), each bf16 conv target at every tile K3's wgmma
kernel is compiled for (a planted winner too) and each fp32 conv target at
both fp32 tiles (an explicit filter tile); ``--prefill`` then profiles deepseek-7b's prefill (1 x
256, full width and depth, random bf16 weights from seed 0) three times
and prints its device busy time (median) and the wgmma kernel's share.

chip_smoke.py's phase-16 targets, ``STREAM_TARGETS`` (the 16-bit weight
stream at deepseek-7b's decode products and logits, deepseek-moe-16b's
expert banks at decode and at a prefill's cap of 30, the row buckets,
whisper-small's decoder and unaligned logits, mamba2's in_proj and the
SSD's batched M = 1 product, packed X and Y, a shared Y, the sidecar,
f16), run first in a full run; ``--only stream`` runs them alone: time,
path and plan, output hash, ``torch.matmul``, bound.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (label, family, (B, M, K, N), explicit block, masked, Y packed[,
# forms]); B None: unbatched; forms: "x" X panels too, "seed" a C seed
# with beta = 0.5, "shared" Y panels without the batch axis, "checksum"
# the sidecar
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
    ("wmma block (64, 64, 64) 1024x4096x11008", "BF16GER2",
     (None, 1024, 4096, 11008), (64, 64, 64), False, False),
    ("wmma unaligned 1024x768x51865", "BF16GER2", (None, 1024, 768, 51865),
     None, False, False),
    ("wmma unaligned 1024x768x51865 packed Y", "BF16GER2",
     (None, 1024, 768, 51865), None, False, True),
    ("wmma masked 1024x4096x11008", "BF16GER2", (None, 1024, 4096, 11008),
     None, True, False),
    ("wmma K=1 4x(64x1x4096)", "BF16GER2", (4, 64, 1, 4096), None, False,
     False),
    ("wmma f16 block (128, 128, 32) 1024x4096x11008", "F16GER2",
     (None, 1024, 4096, 11008), (128, 128, 32), False, False),
    ("wmma block (128, 128, 32) 1000x330x1000 X+Y packed masked",
     "BF16GER2", (None, 1000, 330, 1000), (128, 128, 32), True, True,
     ("x",)),
    ("wmma block (64, 64, 64) 3x300x520x260 seeded shared Y sidecar",
     "BF16GER2", (3, 300, 520, 260), (64, 64, 64), False, True,
     ("seed", "shared", "checksum")),
)

# The DMMA kernel's forms (as CASES), timed after the convs: at 8192^3 the
# fp64 tensor cores draw the card's power for seconds, and the case timed
# next would start on a warmer card.
DMMA_CASES = (
    ("dmma F64GER 2048^3 X+Y packed", "F64GER", (None, 2048, 2048, 2048),
     None, False, True, ("x",)),
    ("dmma F64GER 2048^3 sidecar", "F64GER", (None, 2048, 2048, 2048), None,
     False, False, ("checksum",)),
    ("dmma F64GER 8192^3", "F64GER", (None, 8192, 8192, 8192), None, False,
     False),
    ("dmma F64GER 4x4096x11008", "F64GER", (None, 4, 4096, 11008), None,
     False, False),
    ("dmma F64GER 1000x999x1001", "F64GER", (None, 1000, 999, 1001), None,
     False, False),
)

# (label, entry point, shapes): blas3's complex128 complex_gemm (four DMMA
# launches of 4096^3) and batched float64 dft (64 stacks of 1024 x 128:
# four launches of 1024 x 1024 x 8192) through their entry points
ENTRY_CASES = (
    ("dmma complex_gemm c128 4096", "complex_gemm", (4096, 4096, 4096)),
    ("dmma dft f64 N=1024 64x128", "dft", (64, 1024, 128)),
)

# (label, image (N, H, W, C), filters (KH, KW, C, F), stride, dtype, filter
# tile): K3 with bias + gelu at an explicit filter tile (its WMMA or fp32
# tile)
CONV_CASES = (
    ("conv wmma whisper conv2 4x3001x768 k3 s2", (4, 1, 3001, 768),
     (1, 3, 768, 768), (1, 2), "bfloat16", 128),
    ("conv wmma qwen2-vl patch 4x448x448x3 k14 s14", (4, 448, 448, 3),
     (14, 14, 3, 3584), (14, 14), "bfloat16", 128),
    ("conv wmma C=5 elements 4x1x3001x5 k3", (4, 1, 3001, 5), (1, 3, 5, 768),
     (1, 1), "bfloat16", 128),
    ("conv wmma C=5 elements 4x64x64x5 k7", (4, 64, 64, 5), (7, 7, 5, 768),
     (1, 1), "bfloat16", 128),
    ("conv f32 whisper conv2 4x3001x768 k3 s2", (4, 1, 3001, 768),
     (1, 3, 768, 768), (1, 2), "float32", 64),
)


def digest(*ts) -> str:
    """The first 16 hex digits of a SHA-256 of the tensors' bytes."""
    import torch
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--only", choices=("all", "targets", "stream"),
                    default="all")
    ap.add_argument("--prefill", action="store_true")
    ap.add_argument("--tiles", action="store_true")
    opts = ap.parse_args()
    tree = pathlib.Path(opts.tree).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke as CS
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script runs on the card only")
    from repro_torch.core import packing, precision
    from repro_torch.kernels import _build
    from repro_torch.kernels import mma_gemm as G
    print(CS.card_line(), flush=True)
    print(f"tree {tree}")
    t0 = time.perf_counter()
    logs = _build.build()      # every source at once, one nvcc each
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("for", 1)[1].strip()
            if "spill" in line and " 0 bytes spill stores" not in line:
                print(f"    {name}: {fn}: {line.strip()}")
            if "registers" in line and "conv_f32_kernel" in fn:
                print(f"    {name}: {fn}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = CS.Timer(torch)

    def gemm_case(i, case):
        (label, fam, (b, m, k, n), block, masked, packed,
         *forms) = case
        forms = forms[0] if forms else ()
        g = torch.Generator(device="cuda").manual_seed(11 + i)
        kind = precision.Ger[fam]
        pol = precision.policy(kind)
        lead = () if b is None else (b,)
        ylead = () if "shared" in forms else lead
        if pol.is_integer:
            x, y = CS._int_operands(torch, g, kind, lead, m, k, n)
        else:
            x = torch.randn(*lead, m, k, generator=g, device="cuda"
                            ).to(pol.x_dtype)
            y = (torch.randn(*ylead, k, n, generator=g, device="cuda")
                 * k ** -0.5).to(pol.y_dtype)
        masks = CS._lane_masks(torch, g, m, n, k) if masked else None
        kw = dict(kind=kind, block=block, masks=masks)
        if "seed" in forms:
            kw.update(beta=0.5, c=torch.randn(*lead, m, n, generator=g,
                                              device="cuda"))
        if "checksum" in forms:
            kw["checksum"] = True
        if packed:
            po = packing.pack_gemm(y, packing.gemm_layout(
                kind, k, n, batched=len(ylead) > 0))
            y, kw["y_layout"] = po.data, po.layout
        if "x" in forms:
            po = packing.pack_gemm(x, packing.gemm_layout(
                kind, m, k, side="x", batched=b is not None))
            x, kw["x_layout"] = po.data, po.layout
        c = kw.pop("c", None)
        before = dict(G.mma_gemm.launches_by_path)
        out = G.mma_gemm(x, y, c, **kw)
        torch.cuda.synchronize()
        took = [p for p, v in G.mma_gemm.launches_by_path.items()
                if v != before[p]]
        if len(took) != 1:
            sys.exit(f"{label}: launched on {took}, not one path")
        sha = digest(*(out if isinstance(out, tuple) else (out,)))
        ms = timer(lambda x=x, y=y, c=c, kw=kw: G.mma_gemm(x, y, c, **kw))
        print(f"  {label}: {ms:.4f} ms [{took[0]}] sha256 {sha}",
              flush=True)

    from repro_torch.kernels import epilogue as E
    from repro_torch.kernels import mma_conv as K
    if opts.only == "stream":
        stream_targets(torch, CS, timer)
        return
    if opts.only == "targets":
        targets(torch, CS, timer, opts.tiles)
        if opts.prefill:
            prefill_busy(torch, CS)
        return
    for i, case in enumerate(CASES):
        gemm_case(i, case)
    for i, (label, ishape, wshape, stride, dtype, bf) in enumerate(
            CONV_CASES):
        g = torch.Generator(device="cuda").manual_seed(101 + i)
        dt = getattr(torch, dtype)
        x = torch.randn(*ishape, generator=g, device="cuda").to(dt)
        kk = wshape[0] * wshape[1] * wshape[2]
        w = (torch.randn(*wshape, generator=g, device="cuda")
             * kk ** -0.5).to(dt)
        kw = dict(stride=stride, bf=bf, ep=E.Epilogue(
            bias=True, activation="gelu"), bias=torch.randn(
                wshape[3], generator=g, device="cuda"))
        before = dict(K.mma_conv2d.launches_by_path)
        out = K.mma_conv2d(x, w, **kw)
        torch.cuda.synchronize()
        took = [p for p, v in K.mma_conv2d.launches_by_path.items()
                if v != before[p]]
        if len(took) != 1:
            sys.exit(f"{label}: launched on {took}, not one path")
        ms = timer(lambda x=x, w=w, kw=kw: K.mma_conv2d(x, w, **kw))
        print(f"  {label}: {ms:.4f} ms [{took[0]}] sha256 {digest(out)}",
              flush=True)
        del x, w, kw, out
    for i, case in enumerate(DMMA_CASES, len(CASES)):
        gemm_case(i, case)
    from repro_torch.core import facility as F
    from repro_torch.kernels import blas3 as B3
    cuda = F.FacilityConfig(device="cuda")
    for i, (label, entry, shape) in enumerate(ENTRY_CASES):
        g = torch.Generator(device="cuda").manual_seed(201 + i)
        if entry == "complex_gemm":
            m, k, n = shape
            args = tuple(torch.randn(*((m, k) if j < 2 else (k, n)),
                                     generator=g, device="cuda",
                                     dtype=torch.float64) for j in range(4))

            def call(args=args):
                with F.configure(cuda):
                    return B3.complex_gemm(*args, kind=precision.Ger.F64GER)
        else:
            args = (torch.randn(*shape, generator=g, device="cuda",
                                dtype=torch.float64),)

            def call(args=args):
                with F.configure(cuda):
                    return B3.dft(*args)
        before = dict(G.mma_gemm.launches_by_path)
        out = call()
        torch.cuda.synchronize()
        took = {p: v - before[p] for p, v in
                G.mma_gemm.launches_by_path.items() if v != before[p]}
        ms = timer(call)
        print(f"  {label}: {ms:.4f} ms {took} sha256 {digest(*out)}",
              flush=True)
        del args, out
    stream_targets(torch, CS, timer)
    targets(torch, CS, timer, opts.tiles)
    if opts.prefill:
        prefill_busy(torch, CS)


def stream_targets(torch, CS, timer) -> None:
    """chip_smoke.py's STREAM_TARGETS (phase 16) at the tree's own
    dispatch: time, path and plan, the output hash (the sidecar's
    ``out``'s alone), ``torch.matmul`` and the bound."""
    from repro_torch.core import tiling
    from repro_torch.kernels import mma_gemm as G
    for i, (label, (b, m, k, n), forms, _, _) in enumerate(
            CS.STREAM_TARGETS):
        x, y, xk, kw, yk = CS.stream_target_operands(torch, i)
        before = dict(G.mma_gemm.launches_by_path)
        out = G.mma_gemm(xk, yk, **kw)
        torch.cuda.synchronize()
        took = [p for p, v in G.mma_gemm.launches_by_path.items()
                if v != before[p]]
        plan = tiling.choose_gemm_path(m, n, k, kw["kind"], b or 1)
        sha = digest(out[0] if isinstance(out, tuple) else out)
        ms = timer(lambda xk=xk, yk=yk, kw=kw: G.mma_gemm(xk, yk, **kw))
        lib = timer(lambda x=x, y=y: torch.matmul(x, y))
        bb = b or 1
        ybytes = k * n * 2 * (1 if "shared" in forms else bb)
        bound, by = CS.bound_ms((m * k + m * n) * 2 * bb + ybytes,
                                2 * m * n * k * bb, "bf16")
        print(f"  stream {label}: {ms:.4f} ms {took} {plan[1]} sha256 "
              f"{sha}; torch.matmul {lib:.4f} ms; bound {bound:.4f} ms "
              f"({by})", flush=True)
        del x, y, xk, yk, out


def targets(torch, CS, timer, every_tile=False) -> None:
    """chip_smoke.py's WGMMA_TARGETS and CONV_F32_TARGETS at the tree's
    own dispatch: time, path and tile, output hash (the sidecar's of its
    ``out`` too), library time, bound."""
    from repro_torch.core import tiling
    from repro_torch.kernels import mma_conv as K
    from repro_torch.kernels import mma_gemm as G
    for i, (label, (b, m, k, n), forms, _, _) in enumerate(
            CS.WGMMA_TARGETS):
        x, y, xk, kw, yk = CS.wgmma_target_operands(torch, i)
        before = dict(G.mma_gemm.launches_by_path)
        out = G.mma_gemm(xk, yk, **kw)
        torch.cuda.synchronize()
        took = [p for p, v in G.mma_gemm.launches_by_path.items()
                if v != before[p]]
        plan = tiling.choose_gemm_path(m, n, k, kw["kind"], b or 1)
        sha = digest(*(out if isinstance(out, tuple) else (out,)))
        if isinstance(out, tuple):
            sha += f" (out {digest(out[0])})"
        ms = timer(lambda xk=xk, yk=yk, kw=kw: G.mma_gemm(xk, yk, **kw))
        lib = timer(lambda x=x, y=y: torch.matmul(x, y))
        bb, by = CS.bound_ms((m * k + k * n + m * n) * 2 * (b or 1),
                             2 * m * n * k * (b or 1), "bf16")
        print(f"  target {label}: {ms:.4f} ms {took} {plan[1]} sha256 "
              f"{sha}; torch.matmul {lib:.4f} ms; bound {bb:.4f} ms ({by})",
              flush=True)
        for cfg in (tiling.WGMMA_TILES if every_tile else ()):
            tkw = dict(kw, tuned=("wgmma", cfg))
            got = G.mma_gemm(xk, yk, **tkw)
            sha_t = digest(*(got if isinstance(got, tuple) else (got,)))
            ms_t = timer(lambda xk=xk, yk=yk, tkw=tkw: G.mma_gemm(xk, yk,
                                                                 **tkw))
            print(f"    tile {cfg}: {ms_t:.4f} ms sha256 {sha_t}", flush=True)
            del got
        del x, y, xk, yk, out
    for i, (label, ishape, wshape, stride, dtype, packed, _, _) in \
            enumerate(CS.CONV_F32_TARGETS):
        x, w, wk, ckw = CS.conv_target_operands(torch, i)
        kh, kw_, c, f = wshape
        before = dict(K.mma_conv2d.launches_by_path)
        out = K.mma_conv2d(x, wk, **ckw)
        torch.cuda.synchronize()
        took = [p for p, v in K.mma_conv2d.launches_by_path.items()
                if v != before[p]]
        plan = K.conv_path(x, kh, kw_, c, f, stride, None, True)
        sha = digest(out)
        ms = timer(lambda x=x, wk=wk, ckw=ckw: K.mma_conv2d(x, wk, **ckw),
                   iters=5)
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = ckw["bias"].to(x.dtype)
        lib = timer(lambda: torch.nn.functional.conv2d(
            xc, wc, bc, stride=stride), iters=5)
        n_, h, w_, _ = ishape
        mm = n_ * ((h - kh) // stride[0] + 1) * ((w_ - kw_) // stride[1] + 1)
        esz = x.element_size()
        bb, by = CS.bound_ms((x.numel() + w.numel() + mm * f) * esz + f * 4,
                             2 * mm * kh * kw_ * c * f,
                             "f32" if dtype == "float32" else "bf16")
        print(f"  target conv {label}: {ms:.4f} ms {took} {plan[1]} sha256 "
              f"{sha}; cuDNN {lib:.4f} ms; bound {bb:.4f} ms ({by})",
              flush=True)
        for cfg in (tiling.CONV_WGMMA_TILES
                    if every_tile and dtype != "float32" else ()):
            tkw = dict(ckw, tuned=("wgmma", cfg))
            got = K.mma_conv2d(x, wk, **tkw)
            ms_t = timer(lambda x=x, wk=wk, tkw=tkw: K.mma_conv2d(x, wk,
                                                                  **tkw),
                         iters=5)
            print(f"    tile {cfg}: {ms_t:.4f} ms sha256 {digest(got)}",
                  flush=True)
            del got
        for cfg in (tiling.CONV_TILES[tiling.Ger.F32GER]
                    if every_tile and dtype == "float32" else ()):
            tkw = dict(ckw, bf=cfg.bn)
            got = K.mma_conv2d(x, wk, **tkw)
            ms_t = timer(lambda x=x, wk=wk, tkw=tkw: K.mma_conv2d(x, wk,
                                                                  **tkw),
                         iters=5)
            print(f"    tile {cfg}: {ms_t:.4f} ms sha256 {digest(got)}",
                  flush=True)
            del got
        del x, w, wk, out, xc, wc


def prefill_busy(torch, CS) -> None:
    """deepseek-7b's prefill (1 x 256 tokens; full width and depth, random
    bf16 weights from seed 0) profiled three times: device busy time and
    the wgmma GEMM kernel's share (medians)."""
    from repro_torch.configs import get as get_arch
    from repro_torch.core import facility
    from repro_torch.models import model as M
    cfg = get_arch(CS.ARCH)
    model = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    prefill, _, what = CS.serve_steps(torch, model, cfg, CS.SERVE)
    act = torch.profiler.ProfilerActivity
    busy, wg = [], []
    with facility.configure(facility.FacilityConfig(device="cuda")):
        for _ in range(2):
            prefill()
        for _ in range(3):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as p:
                prefill()
                torch.cuda.synchronize()
            tot = w = 0.0
            for ev in p.key_averages():
                if getattr(ev, "device_type", None) != \
                        torch.autograd.DeviceType.CUDA:
                    continue
                us = max(getattr(ev, "device_time_total", 0),
                         getattr(ev, "self_device_time_total", 0))
                tot += us
                if "gemm_wgmma_kernel" in ev.key:
                    w += us
            busy.append(tot / 1e3)
            wg.append(w / 1e3)
    busy.sort()
    wg.sort()
    print(f"  prefill {cfg.name} {what.split(',')[0]}: device busy "
          f"{busy[1]:.4f} ms (of {busy}), gemm_wgmma_kernel {wg[1]:.4f} ms",
          flush=True)
    del model
    torch.cuda.empty_cache()

if __name__ == "__main__":
    main()
