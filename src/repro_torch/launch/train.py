"""End-to-end training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 50 --batch 8 --seq 256 --ckpt-dir ckpt [--reduced]
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 4 --batch 2 --seq 64

Runs on the card (``--device cuda``, the default; it raises where CUDA is
absent) with random fp32 weights drawn from seed 0, through the
facility's kernel backend; ``--device cpu`` runs the kernels' plain
versions.  One device, no mesh (ROADMAP queue 1, E1), and a plain loop in
place of the reference's ``ElasticTrainer`` (D3, which brings resume and
restart): it checkpoints every ``--ckpt-every`` steps into ``--ckpt-dir``
when one is given, and prints the reference's
``steps= first_loss= last_loss= wall=`` line.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import ARCHS
from repro_torch.configs import get as get_arch
from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.core import facility
from repro_torch.data import pipeline
from repro_torch.optim import adamw, schedule
from repro_torch.train import steps as S


def build(cfg, *, lr: float = 3e-4, total_steps: int = 1000,
          grad_accum: int = 1, compress: bool = False, seed: int = 0,
          weight_decay: float = 0.1, device=None, backend: str = "kernel",
          ger=None, out_dtype=None):
    """Returns (make_state, make_step): the train state on ``device``
    (default: the card) and the step, which runs on that device under the
    facility's ``backend`` (the kernels; "torch" for the eager
    yardstick), with its ``ger`` family and ``out_dtype`` where given
    (the tight-parity config: ``Ger.F32GER`` and ``torch.float32``)."""
    opt_cfg = adamw.AdamWConfig(
        lr=schedule.warmup_cosine(lr, min(100, total_steps // 10 + 1),
                                  total_steps),
        weight_decay=weight_decay)
    policy = {k: v for k, v in (("ger", ger), ("out_dtype", out_dtype))
              if v is not None}
    fac = facility.FacilityConfig(device=device, backend=backend, **policy)

    def make_state():
        return S.init_train_state(cfg, seed, opt_cfg, compress=compress,
                                  device=fac.device)

    step = S.make_train_step(cfg, opt_cfg, grad_accum=grad_accum,
                             compress=compress)

    def make_step():
        def run(state, batch):
            with facility.configure(fac):
                return step(state, batch)
        return run

    return make_state, make_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (none: no checkpoints)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)

    make_state, make_step = build(
        cfg, lr=args.lr, total_steps=args.steps,
        grad_accum=args.grad_accum, compress=args.compress,
        device=args.device)
    state, step = make_state(), make_step()
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    batches = pipeline.Prefetcher(cfg, batch=args.batch, seq=args.seq,
                                  device=facility.resolve_device(args.device))
    losses = []
    t0 = time.time()
    try:
        for _ in range(args.steps):
            i, batch = next(batches)
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
            if ckpt is not None and (i + 1) % args.ckpt_every == 0:
                ckpt.save_async(i + 1, state)
        if ckpt is not None:
            ckpt.wait()
    finally:
        batches.close()
    losses = torch.stack(losses).tolist()
    dt = time.time() - t0
    print(f"steps={len(losses)} first_loss={losses[0]:.4f} "
          f"last_loss={losses[-1]:.4f} wall={dt:.1f}s")


if __name__ == "__main__":
    main()
