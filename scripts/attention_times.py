#!/usr/bin/env python3
"""Device times and output hashes of the attention kernel's launches, one
source tree at a time, on one card.

    python scripts/attention_times.py [--tree DIR] [--whisper-steps N]

Card only (exits nonzero without CUDA).  Imports ``repro_torch`` from
``DIR/src`` (default: this checkout) and times
``kernels.mma_flash_attention`` at each of ``chip_smoke.ATTN_TARGETS``
(the 16-bit tile mode at the main path's prefill and train shapes, bf16),
then at the other modes and forms (``CASES``): whisper-small's split-KV
cross-attention decode and prompt in bf16 and f32, deepseek-7b's prefill
at ABFT's depth 129 (padded to 192), f16, a ``valid`` predicate, the full
grid at ``chip_smoke.K2D_CASES`` and the fp32 tile (K2e) at deepseek-7b's
train and prefill shapes and whisper's encoder.  With ``--whisper-steps
N``, then whisper-small's decode step (full width, random bf16 weights,
batch 4 over 3000 mel frames, chip_smoke's generation run): the median
over N profiled steps of the device busy time and of the attention
kernels' share of it.  Each case's inputs come from its own seed; the script
prints the mode the launch took (from the wrapper's counters), a SHA-256
of the output's bytes (so that two trees' outputs can be compared bit for
bit), SDPA's time on the same inputs and the bound; an fp32 tile case
also its time and hash on each q tile, 64 and 128 rows.  Times use
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
    ("f32 tile prefill causal (1,256,32,128)", (1, 256, 32, 128), (256, 32),
     "float32", dict(causal=True)),
    ("f32 tile whisper encoder (4,1500,12,64)", (4, 1500, 12, 64),
     (1500, 12), "float32", dict(causal=False)),
    ("split whisper cross prompt (4,4,12,64) over 1500", (4, 4, 12, 64),
     (1500, 12), "bfloat16", dict(causal=False)),
    ("f32 split whisper cross prompt (4,4,12,64) over 1500", (4, 4, 12, 64),
     (1500, 12), "float32", dict(causal=False)),
)


def whisper_steps(torch, CS, rounds):
    """whisper-small's decode step as chip_smoke's generation run takes it
    (batch 4, the cache after a prefill of 3000 mel frames): the median of
    ``rounds`` profiled steps' device busy time and of the attention
    kernels' part of it, ms (None where the profiler recorded no device
    time)."""
    from repro_torch.configs import get
    from repro_torch.core import facility
    from repro_torch.models import model as M

    cfg = get("whisper-small")
    settings = CS.MM_RUNS["whisper-small"]
    b = settings["batch"]
    model = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    batch, seq_len = CS.mm_batch(cfg, settings, b)
    act = torch.profiler.ProfilerActivity
    busy, attn = [], []
    with facility.configure(facility.FacilityConfig(device="cuda")):
        last, pre = M.prefill(model, batch, cfg)
        cache = CS.handoff(torch, cfg, pre, b, seq_len, torch.bfloat16)
        del pre
        tok = last.argmax(-1, keepdim=True).to(torch.int32)
        for i in range(3 + rounds):
            with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
                _, cache = M.decode_step(model, cache, tok, cfg)
                torch.cuda.synchronize()
            if i < 3:
                continue
            total = flash = 0.0
            for ev in prof.key_averages():
                if getattr(ev, "device_type", None) != \
                        torch.autograd.DeviceType.CUDA:
                    continue
                ms = max(getattr(ev, "device_time_total", 0),
                         getattr(ev, "self_device_time_total", 0)) / 1e3
                total += ms
                if "flash_" in ev.key:
                    flash += ms
            busy.append(total)
            attn.append(flash)
    if not any(busy):
        return None
    return sorted(busy)[len(busy) // 2], sorted(attn)[len(attn) // 2]


def digest(t) -> str:
    """The first 16 hex digits of a SHA-256 of the tensor's bytes."""
    import torch
    h = hashlib.sha256()
    h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--whisper-steps", type=int, default=0)
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
        if took[0] == "f32_tile":
            for bq in (64, 128):
                tkw = dict(kw, tuned=(bq, 1))
                got = A.mma_flash_attention(q, k, v, **tkw)
                tms = timer(lambda q=q, k=k, v=v, tkw=tkw:
                            A.mma_flash_attention(q, k, v, **tkw))
                print(f"    on the {bq}-row tile: {tms:.4f} ms sha256 "
                      f"{digest(got)}", flush=True)
                del got
        del q, k, v, kw, out
    if args.whisper_steps:
        got = whisper_steps(torch, CS, args.whisper_steps)
        print("  whisper-small decode step (batch 4): " + (
            "device busy not measured (no device time recorded)"
            if got is None else
            f"device busy {got[0]:.4f} ms, attention {got[1]:.4f} ms "
            f"(median of {args.whisper_steps} profiled steps)"), flush=True)


if __name__ == "__main__":
    main()
