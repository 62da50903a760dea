#!/usr/bin/env python3
"""Per-step losses of a short training run at several peak learning rates.

    PYTHONPATH=src python scripts/train_lr_witness.py --card
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/train_lr_witness.py \
        --reference

Both modes train the way ``chip_smoke.py``'s phase 5 does: AdamW through
the launcher's schedule (``warmup_cosine(lr, 1, steps)``: the first update
already at the peak rate), no weight decay, 6 steps on one repeated
synthetic batch.

``--card``: the port alone, on the card, at the runs of phase 5 (full-width
deepseek-7b cut to 4 layers, zamba2-1.2b at full depth; fp32 weights from
seed 0, batch 4 x 512) through ``repro_torch.launch.train.build`` and the
kernel backend, at each rate of ``CARD_LRS``.  Exits nonzero without CUDA.

``--reference``: the JAX reference beside the port, on the CPU, from the
same weights (the reference's ``init_params``, carried over by
``repro_torch.models.convert``): deepseek-7b's family at 2 layers and each
``d_model`` of ``REF_WIDTHS`` (head_dim 128, d_ff 2.6875 d_model as in the
full model, the vocabulary cut to 32000), batch 4 x 128, at each rate of
``REF_LRS``, each in its default BF16GER2 mode: the reference's jitted
``make_train_step`` and the port's ``make_train_step`` (the kernels' plain
versions).  The reference is the independent witness of how the loss
moves with the rate and the width.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STEPS = 6
CARD_LRS = (1e-3, 3e-4, 1e-4, 3e-5, 1e-5)
REF_WIDTHS = (256, 512, 1024, 2048)
REF_LRS = (1e-3, 1e-4)


def _fmt(losses) -> str:
    return "[" + ", ".join(f"{x:.4f}" for x in losses) + "]"


def card(lrs) -> None:
    import torch

    from repro_torch.configs import get
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T

    if not torch.cuda.is_available():
        sys.exit("--card needs CUDA")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for arch, layers in (("deepseek-7b", 4), ("zamba2-1.2b", None)):
        cfg = get(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        batch = pipeline.device_batch(pipeline.synthetic_batch(
            cfg, batch=4, seq=512, step=0), "cuda")
        for lr in lrs:
            make_state, make_step = T.build(cfg, lr=lr, total_steps=STEPS,
                                            weight_decay=0.0, seed=0,
                                            device="cuda")
            state, step = make_state(), make_step()
            losses = []
            for _ in range(STEPS):
                state, metrics = step(state, batch)
                losses.append(metrics["loss"])
            losses = torch.stack(losses).tolist()
            print(f"card {arch} layers {cfg.num_layers} lr {lr:g}: losses "
                  f"{_fmt(losses)}", flush=True)
            del state, step, make_state, make_step
            torch.cuda.empty_cache()


def reference(widths, lrs) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get as jget
    from repro.data import pipeline as jpipe
    from repro.models import model as JM
    from repro.optim import adamw as JA
    from repro.optim import schedule as JS
    from repro.train import steps as JST
    from repro_torch.configs import get as tget
    from repro_torch.core import facility as tfac
    from repro_torch.models import convert
    from repro_torch.optim import adamw as TA
    from repro_torch.optim import schedule as TS
    from repro_torch.train import steps as TST

    for w in widths:
        cut = dict(num_layers=2, d_model=w, num_heads=w // 128,
                   num_kv_heads=w // 128, head_dim=128,
                   d_ff=11008 * w // 4096, vocab_size=32000)
        jcfg = dataclasses.replace(jget("deepseek-7b"), **cut)
        tcfg = dataclasses.replace(tget("deepseek-7b"), **cut)
        host = jpipe.synthetic_batch(jcfg, batch=4, seq=128, step=0)
        jb = {k: jnp.asarray(v) for k, v in host.items()}
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in host.items()}
        for lr in lrs:
            warm = min(100, STEPS // 10 + 1)
            jopt = JA.AdamWConfig(lr=JS.warmup_cosine(lr, warm, STEPS),
                                  weight_decay=0.0)
            topt = TA.AdamWConfig(lr=TS.warmup_cosine(lr, warm, STEPS),
                                  weight_decay=0.0)
            params = JM.init_params(jcfg, jax.random.key(0))
            tstate = TST.train_state_from(convert.params_from_numpy(
                jax.tree.map(np.asarray, params), tcfg, device="cpu"), topt)
            jstate = JST.init_train_state(jcfg, jax.random.key(0), jopt)
            del params
            jstep = jax.jit(JST.make_train_step(jcfg, jopt),
                            donate_argnums=(0,))
            jl = []
            for _ in range(STEPS):
                jstate, m = jstep(jstate, jb)
                jl.append(float(m["loss"]))
            del jstate
            tstep, tl = TST.make_train_step(tcfg, topt), []
            with tfac.configure(tfac.FacilityConfig(device="cpu")):
                for _ in range(STEPS):
                    tstate, m = tstep(tstate, tb)
                    tl.append(float(m["loss"]))
            del tstate
            drift = max(abs(a - b) / abs(b) for a, b in zip(tl, jl))
            print(f"reference deepseek-7b d_model {w} lr {lr:g}: losses "
                  f"{_fmt(jl)}\n     port deepseek-7b d_model {w} lr "
                  f"{lr:g}: losses {_fmt(tl)} (max relative difference "
                  f"{drift:.2e})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--card", action="store_true")
    mode.add_argument("--reference", action="store_true")
    if ap.parse_args().card:
        card(CARD_LRS)
    else:
        reference(REF_WIDTHS, REF_LRS)


if __name__ == "__main__":
    main()
