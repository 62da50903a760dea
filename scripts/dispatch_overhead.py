#!/usr/bin/env python3
"""Host time of the single-device dispatch, one source tree at a time, on
one card.

    python scripts/dispatch_overhead.py [--tree DIR] [--rounds N]

Card only (exits nonzero without CUDA).  Imports ``repro_torch`` from
``DIR/src`` (default: this checkout) and prints, after the card's name and
power limit:

  * the host microseconds of one ``facility.contract`` call (enqueue only,
    200 calls, median and min of ``N`` rounds) at deepseek-7b's decode
    product 4 x 4096 x 11008 (the weight stream) and a prefill product
    1024 x 4096 x 11008 (the wgmma tile), bf16, natural weights: the
    calls chip_smoke.py's phase 7 times;
  * deepseek-7b at full width and depth (random bf16 weights from seed 0)
    served ``N`` times through ``launch.serve.serve_loop`` at
    chip_smoke.py's phase-3 settings (batch 4, 256-token prompts, 32 new
    tokens, 8 requests): each serve's decode tokens/s, then the host
    milliseconds of 15 batched decode steps on a fresh cache (the
    enqueue of one step, after a first one; median and min).

Everything runs in one process with no ``torch.distributed`` world, as a
user's single-card serve does.  To compare trees, unpack each beside
this one and run the script for each in turn (A B A B ... B A) in one
session on one card: the kernels build per tree into ``DIR/build``, and a
tree whose ``csrc/`` is this one's may be given a copy of this build.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
SERVE = dict(batch=4, prompt_len=256, gen_len=32, n_requests=8)


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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--rounds", type=int, default=5)
    opts = ap.parse_args()
    tree = pathlib.Path(opts.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("dispatch_overhead.py needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    print(f"tree {tree}")

    from repro_torch.configs import get as get_arch
    from repro_torch.core import facility
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M

    _build.build(("gemm_stream", "gemm_wgmma", "mma_gemm", "mma_attention"))
    g = torch.Generator(device="cuda").manual_seed(7)
    w = (torch.randn(4096, 11008, generator=g, device="cuda")
         * 4096 ** -0.5).to(torch.bfloat16)
    calls = {
        f"contract {name}": (lambda x=torch.randn(
            m, 4096, generator=g, device="cuda").to(torch.bfloat16):
            facility.contract("mk,kn->mn", x, w))
        for name, m in (("decode 4x4096x11008 (stream)", 4),
                        ("prefill 1024x4096x11008 (wgmma)", 1024))}
    with facility.configure(facility.FacilityConfig(device="cuda")):
        host: dict = {}
        for _ in range(opts.rounds):
            for label, fn in calls.items():
                host.setdefault(label, []).append(host_us(torch, fn))
        for label, v in host.items():
            print(f"host us per call, {label}: median "
                  f"{statistics.median(v):.1f}, min {min(v):.1f} "
                  f"({opts.rounds} rounds of 200)")
        del calls, w

        cfg = get_arch("deepseek-7b")
        model = M.init_params(cfg, seed=0, device="cuda",
                              dtype=torch.bfloat16)
        for i in range(opts.rounds):
            stats = S.serve_loop(cfg, model, **SERVE)
            print(f"deepseek-7b serve {i}: decode tok/s "
                  f"{stats['tokens_per_s']:.2f} ({stats['decode_tokens']} "
                  f"tokens, {stats['steps']} steps, wall "
                  f"{stats['wall_s']:.3f} s)")
        cache = M.init_cache(cfg, batch=SERVE["batch"],
                             seq_len=SERVE["prompt_len"] * 4, device="cuda")
        tok = torch.zeros((SERVE["batch"], 1), dtype=torch.int32,
                          device="cuda")
        steps = []
        with torch.inference_mode():
            for _ in range(16):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = M.decode_step(model, cache, tok, cfg)
                t1 = time.perf_counter()
                tok = logits[:, -1:].argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                steps.append((t1 - t0) * 1e3)
        steps = steps[1:]
        print(f"deepseek-7b decode step host ms (batch "
              f"{SERVE['batch']}, 15 steps): median "
              f"{statistics.median(steps):.3f}, min {min(steps):.3f}")


if __name__ == "__main__":
    main()
