#!/usr/bin/env python3
"""Device times and output hashes of the attention kernel's launches, one
source tree at a time, on one card.

    python scripts/attention_times.py [--tree DIR]

Card only (exits nonzero without CUDA).  Imports ``repro_torch`` from
``DIR/src`` (default: this checkout) and times
``kernels.mma_flash_attention`` at each of ``chip_smoke.ATTN_TARGETS``
(the 16-bit tile mode at the main path's prefill and train shapes, bf16),
then at the other modes and forms (``CASES``): whisper-small's split-KV
cross-attention decode, deepseek-7b's prefill at ABFT's depth 129
(padded to 192), f16, a ``valid`` predicate, the full grid at
``chip_smoke.K2D_CASES`` and the fp32 tile (K2e) in its tile and
split-KV modes.  Each case's inputs come from its own seed; the script
prints the mode the launch took (from the wrapper's counters), a SHA-256
of the output's bytes (so that two trees' outputs can be compared bit for
bit), SDPA's time on the same inputs and the bound.  Times use
chip_smoke.py's Timer (median, L2 flushed, host work hidden); the card's
name and power limit head the output.  To compare two trees, unpack one
beside the other and run the script for each in turn, A B B A, in one
run on one card: the kernels build per tree, into ``DIR/build``.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (label, (B, Sq, H, D), (Sk, KVH), dtype, flags); a "valid" flag is the
# share of slots left filled
CASES = (
    ("split whisper cross decode (4,1,12,64) over 1500", (4, 1, 12, 64),
     (1500, 12), "bfloat16", dict(causal=False)),
    ("padded D=129 (192) prefill causal (4,256,32,129)", (4, 256, 32, 129),
     (256, 32), "bfloat16", dict(causal=True)),
    ("f16 train causal (4,512,32,128)", (4, 512, 32, 128), (512, 32),
     "float16", dict(causal=True)),
    ("valid causal (2,1024,16,128)", (2, 1024, 16, 128), (1024, 16),
     "bfloat16", dict(causal=True, valid=0.8)),
    ("f32 tile train causal (4,512,32,128)", (4, 512, 32, 128), (512, 32),
     "float32", dict(causal=True)),
    ("f32 split whisper cross decode (4,1,12,64) over 1500", (4, 1, 12, 64),
     (1500, 12), "float32", dict(causal=False)),
)


def digest(t) -> str:
    """The first 16 hex digits of a SHA-256 of the tensor's bytes."""
    import torch
    h = hashlib.sha256()
    h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
    from repro_torch.kernels import _build
    from repro_torch.kernels import mma_attention as A
    print(CS.card_line(), flush=True)
    print(f"tree {tree}")
    t0 = time.perf_counter()
    _build.build(("mma_attention",))
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = CS.Timer(torch)
    cases = [(label, shape, kv, "bfloat16", kw, False)
             for label, shape, kv, kw, _, _ in CS.ATTN_TARGETS]
    cases += [(label, shape, kv, dt, kw, False)
              for label, shape, kv, dt, kw in CASES]
    cases += [(f"full grid {label}", shape, (shape[1], shape[2]),
               "bfloat16", kw, True) for label, shape, kw in CS.K2D_CASES]
    for i, (label, (b, sq, h, d), (sk, kvh), dt, kw, full) in enumerate(
            cases):
        g = torch.Generator(device="cuda").manual_seed(31 + i)
        dt = getattr(torch, dt)
        q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(b, sk, kvh, d, generator=g, device="cuda"
                            ).to(dt) for _ in range(2))
        kw = dict(kw)
        if "valid" in kw:
            kw["valid"] = torch.rand(b, sk, generator=g,
                                     device="cuda") < kw["valid"]
        if full:
            kw["bound_grid"] = False
        before = dict(A.mma_flash_attention.launches_by_mode)
        out = A.mma_flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        took = [m for m, n in A.mma_flash_attention.launches_by_mode.items()
                if n != before[m]]
        if len(took) != 1:
            sys.exit(f"{label}: launched in modes {took}, not one")
        ms = timer(lambda q=q, k=k, v=v, kw=kw: A.mma_flash_attention(
            q, k, v, **kw))
        flags = {f: kw[f] for f in ("causal", "window") if f in kw}
        sdpa = timer(CS.attn_sdpa(torch, q, k, v, flags))
        bound, by = CS.attn_bound(q, k, flags)
        print(f"  {label}: {ms:.4f} ms [{took[0]}] sha256 {digest(out)}; "
              f"sdpa {sdpa:.4f} ms ({ms / sdpa:.2f}x), bound {bound:.4f} ms "
              f"({by})", flush=True)
        del q, k, v, kw, out


if __name__ == "__main__":
    main()
