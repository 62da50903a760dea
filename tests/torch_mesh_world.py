"""A spawned gloo world of 4 CPU ranks on a 2 x 2 ("data", "model") mesh,
running one suite of the port's mesh cases (``tests/test_torch_sharding.py``,
``tests/test_torch_parallel.py``).

    PYTHONPATH=src python tests/torch_mesh_world.py SUITE OUT_DIR

Every rank runs every case of the suite; rank 0 writes ``OUT_DIR/SUITE.json``
({case: {"ok": bool, "detail": str}}) and ``OUT_DIR/SUITE.npz`` (each
case's inputs and outputs, for the comparison with the reference's mesh
run).  A case that raises is recorded as failed; the world runs on.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import socket
import sys
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


class Ctx:
    """What a case sees: the rank, the mesh and its rules, a seeded input
    maker, and the arrays rank 0 saves."""

    def __init__(self, rank, mesh, rules, tmp):
        self.rank, self.mesh, self.rules, self.tmp = rank, mesh, rules, tmp
        self.arrays: dict = {}
        self.rng = np.random.default_rng(0)

    def arr(self, name, *shape):
        a = self.rng.standard_normal(shape).astype(np.float32)
        self.arrays[name] = a
        return torch.from_numpy(a.copy())

    def save(self, name, t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        self.arrays[name] = t.numpy().copy()


def probe():
    from repro_torch.runtime import faults
    return faults.FaultPlan([faults.FaultSpec(
        faults.COLLECTIVE, kind=faults.LATENCY, latency_s=0.0, every=1,
        max_fires=None)])


def check(ctx, name, fn, want_collective=True):
    """``fn()`` unsharded, then under the mesh rules with the collective
    probe installed: bit for bit equal, and the probe fired iff the
    dispatch went per shard."""
    from repro_torch.parallel import api as par
    from repro_torch.runtime import faults
    single = fn()
    p = probe()
    with par.use_rules(ctx.rules), faults.install(p):
        sharded = fn()
    fired = len(p.fired(faults.COLLECTIVE))
    ctx.save(name + ":single", single)
    ctx.save(name + ":sharded", sharded)
    same = torch.equal(single, sharded)
    ok = same and (fired > 0) == want_collective
    err = (single.float() - sharded.float()).abs().max().item()
    return ok, f"bitwise={same} max_err={err} fired={fired}"


def _child(rank, suite, port, out_dir):
    import warnings
    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    from repro_torch.core import facility
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import api as par
    mesh = make_test_mesh((2, 2), ("data", "model"))
    ctx = Ctx(rank, mesh, par.default_rules(mesh),
              os.path.join(out_dir, "tmp"))
    import torch_mesh_cases as cases
    results = {}
    with facility.configure(facility.FacilityConfig(device="cpu")):
        for name, fn in cases.SUITES[suite]:
            try:
                ok, detail = fn(ctx)
            except Exception as e:  # repro: allow(overbroad-except)
                # the world runs on so every case reports
                ok, detail = False, "".join(
                    traceback.format_exception(e))[-3000:]
            results[name] = {"ok": bool(ok), "detail": detail}
            dist.barrier()
    if rank == 0:
        with open(os.path.join(out_dir, f"{suite}.json"), "w") as f:
            json.dump(results, f, indent=1)
        np.savez(os.path.join(out_dir, f"{suite}.npz"), **ctx.arrays)
    dist.barrier()
    dist.destroy_process_group()


def run(suite: str, out_dir: str):
    os.makedirs(os.path.join(out_dir, "tmp"), exist_ok=True)
    with contextlib.closing(socket.socket()) as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_child, args=(suite, port, out_dir), nprocs=WORLD, join=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    run(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else tempfile.mkdtemp())
