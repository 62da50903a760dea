"""End-to-end training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 50 --batch 8 --seq 256 --ckpt-dir ckpt [--reduced]
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 4 --batch 2 --seq 64

Runs on the card (``--device cuda``, the default; it raises where CUDA is
absent) with random fp32 weights drawn from seed 0, through the
facility's kernel backend; ``--device cpu`` runs the kernels' plain
versions.  ``build(cfg, mesh=...)`` runs the step on a mesh, as the
reference's does (``parallel.api``; each rank one process).  As the
reference's, every run goes through ``runtime.elastic.ElasticTrainer``: it
checkpoints every ``--ckpt-every`` steps into ``--ckpt-dir``, restarts from
the latest complete step after an injected failure, and a second run on
the same ``--ckpt-dir`` resumes from that directory's latest step.  Where
the reference defaults ``--ckpt-dir`` to ``/tmp/repro_ckpt``, the port's
default is a temporary directory removed at exit, so a plain run never
resumes from a stale one.  The last line is the reference's
``steps= first_loss= last_loss= wall= restarts=``.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile
import time

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import ARCHS
from repro_torch.configs import get as get_arch
from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.core import facility
from repro_torch.data import pipeline
from repro_torch.optim import adamw, schedule
from repro_torch.parallel import api as par
from repro_torch.runtime.elastic import ElasticConfig, ElasticTrainer
from repro_torch.train import steps as S


def build(cfg, *, mesh=None, lr: float = 3e-4, total_steps: int = 1000,
          grad_accum: int = 1, compress: bool = False, seed: int = 0,
          weight_decay: float = 0.1, device=None, backend: str = "kernel",
          ger=None, out_dtype=None):
    """Returns (make_state, make_step, state_shardings): the train state
    on ``device`` (default: the card) and the step, which runs on that
    device under the facility's ``backend`` (the kernels; "torch" for the
    eager yardstick), with its ``ger`` family and ``out_dtype`` where
    given (the tight-parity config: ``Ger.F32GER`` and ``torch.float32``).

    ``mesh`` (a ``DeviceMesh`` over the world the caller started): the
    state is built one model piece at a time onto the mesh at
    ``param_spec``'s TP + FSDP specs (no rank holds the whole state),
    ``state_shardings`` is that layout (None without a mesh), and the step
    runs under the mesh's rules: every contraction per shard."""
    opt_cfg = adamw.AdamWConfig(
        lr=schedule.warmup_cosine(lr, min(100, total_steps // 10 + 1),
                                  total_steps),
        weight_decay=weight_decay)
    policy = {k: v for k, v in (("ger", ger), ("out_dtype", out_dtype))
              if v is not None}
    fac = facility.FacilityConfig(device=device, backend=backend, **policy)
    rules = par.default_rules(mesh) if mesh is not None else par.current()
    sharded = rules if mesh is not None else None

    def make_state():
        return S.init_train_state(cfg, seed, opt_cfg, compress=compress,
                                  device=fac.device, rules=sharded)

    step = S.make_train_step(cfg, opt_cfg, grad_accum=grad_accum,
                             compress=compress)

    def make_step():
        def run(state, batch):
            with facility.configure(fac), par.use_rules(rules):
                return step(state, batch)
        return run

    shardings = (S.state_shardings(cfg, rules, compress=compress)
                 if mesh is not None else None)
    return make_state, make_step, shardings


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
                    help="checkpoint directory, resumed from where it holds "
                         "a step (default: a temporary directory removed at "
                         "exit)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)

    make_state, make_step, _ = build(
        cfg, lr=args.lr, total_steps=args.steps,
        grad_accum=args.grad_accum, compress=args.compress,
        device=args.device)
    device = facility.resolve_device(args.device)

    def batches(start_step):
        return pipeline.Prefetcher(cfg, batch=args.batch, seq=args.seq,
                                   device=device, start_step=start_step)

    with contextlib.ExitStack() as stack:
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_"))
        trainer = ElasticTrainer(
            make_step=make_step, make_state=make_state, batches=batches,
            checkpointer=Checkpointer(ckpt_dir),
            cfg=ElasticConfig(ckpt_every=args.ckpt_every))
        t0 = time.time()
        out = trainer.run(args.steps)
        dt = time.time() - t0
    losses = [m["loss"] for m in out["metrics"]] or [float("nan")]
    print(f"steps={len(out['metrics'])} first_loss={losses[0]:.4f} "
          f"last_loss={losses[-1]:.4f} wall={dt:.1f}s "
          f"restarts={out['restarts']}")


if __name__ == "__main__":
    main()
