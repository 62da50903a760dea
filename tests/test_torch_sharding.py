"""The port's shard-aware contract dispatch (``core/lowering.py``'s mesh
path, ``parallel/api.py``) on a spawned gloo world of 4 CPU ranks, a
2 x 2 ("data", "model") mesh: the reference's ``tests/test_sharding.py``
cases replayed (``tests/torch_mesh_cases.py``: gemm2d, bgemm, fused,
einsum, indivisible, packed y, conv1d, attn, causal, GQA and its
sequence-parallel form, valid, mesh of one, explicit binding,
``mesh=False``, guarded ABFT; also a 256-row product on the wgmma tile's
plan, whisper's stem conv, mamba2's depthwise conv, a windowed attention
and gradients).

Each case's sharded result must equal the unsharded one BIT FOR BIT, and
the ``collective`` fault point must fire exactly when the dispatch went per
shard.  The plain versions the wrappers run on the CPU are
row-independent, so no case needs the Ger family's tolerance; the gradient
case sums partial gradients over the mesh and is held within 1e-5 of the
largest gradient.

The port's sharded results are also held against the reference's own
sharded run (a subprocess with 4 forced host devices on a 2 x 2 mesh, as
the reference's ``_run`` does; its Pallas kernels in interpret mode) on
the same inputs: BF16GER2 with bf16 outputs in both, so within 2e-2 of
the output's largest element (two bf16 roundings apart at most).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_mesh_cases as cases  # noqa: E402

TOL = 2e-2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_sharding"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_mesh_world.py"),
         "sharding", out], capture_output=True, text=True, env=env,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    with open(os.path.join(out, "sharding.json")) as f:
        results = json.load(f)
    return results, dict(np.load(os.path.join(out, "sharding.npz"))), out


@pytest.mark.parametrize("case", [n for n, _ in cases.SHARDING])
def test_sharded_contract_bit_for_bit(world, case):
    results, _, _ = world
    assert results[case]["ok"], results[case]["detail"]


# the reference's sharded run of the same contractions, on the same inputs
_REFERENCE = """
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import facility, packing
    from repro.core.lowering import Plan
    from repro.parallel import api as par

    a = dict(np.load(IN))
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    rules = par.default_rules(mesh)
    PAL = Plan(backend="pallas")
    g = lambda n: jnp.asarray(a[n])
    out = {}
    lay = packing.GemmLayout(kind=facility.Ger.BF16GER2, block=(32, 32, 16),
                             side="y", rows=48, cols=96, transposed=False)
    runs = {
      "gemm2d": lambda: facility.contract("mk,kn->mn", g("gemm2d:x"),
                                          g("gemm2d:y"), plan=PAL),
      "bgemm": lambda: facility.contract("bmk,bkn->bmn", g("bgemm:x"),
                                         g("bgemm:y"), plan=PAL),
      "gemm_fused": lambda: facility.contract(
          "mk,kn->mn", g("gemm_fused:x"), g("gemm_fused:y"),
          bias=g("gemm_fused:bias"), residual=g("gemm_fused:res"), plan=PAL),
      "gemm_wide": lambda: facility.contract("mk,kn->mn", g("gemm_wide:x"),
                                             g("gemm_wide:y"), plan=PAL),
      "einsum": lambda: facility.contract("ab,bc->c", g("einsum:x"),
                                          g("einsum:y"), plan=PAL),
      "gemm_indivisible": lambda: facility.contract(
          "mk,kn->mn", g("gemm_indivisible:x"), g("gemm_indivisible:y"),
          plan=PAL),
      "gemm_packed_y": lambda: facility.contract(
          "mk,kn->mn", g("gemm_packed_y:x"),
          packing.pack_gemm(g("gemm_packed_y:y"), lay), plan=PAL),
      "conv1d": lambda: facility.contract(facility.CONV1D, g("conv1d:x"),
                                          g("conv1d:y"), plan=PAL),
      "conv_stem": lambda: facility.contract(
          facility.CONV1D, g("conv_stem:x"), g("conv_stem:y"),
          bias=g("conv_stem:bias"), plan=Plan(
              backend="pallas", stride=2, padding="same",
              epilogue=facility.Epilogue(bias=True, activation="gelu"))),
      "depthwise": lambda: facility.contract(
          facility.CONV1D_DEPTHWISE, g("depthwise:x"), g("depthwise:y"),
          plan=Plan(backend="pallas", padding="causal")),
      "attn": lambda: facility.contract(facility.ATTN, g("attn:q"),
                                        g("attn:k"), g("attn:v"), plan=PAL),
      "attn_causal": lambda: facility.contract(
          facility.ATTN, g("attn_causal:q"), g("attn_causal:k"),
          g("attn_causal:v"), plan=Plan(backend="pallas", causal=True)),
      "attn_gqa": lambda: facility.contract(
          facility.ATTN, g("attn_gqa:q"), g("attn_gqa:k"), g("attn_gqa:v"),
          plan=Plan(backend="pallas", causal=True)),
      "attn_seq": lambda: facility.contract(
          facility.ATTN, g("attn_seq:q"), g("attn_seq:k"), g("attn_seq:v"),
          plan=Plan(backend="pallas", causal=True)),
      "attn_window": lambda: facility.contract(
          facility.ATTN, g("attn_window:q"), g("attn_window:k"),
          g("attn_window:v"),
          plan=Plan(backend="pallas", causal=True, window=24)),
      "attn_valid": lambda: facility.contract(
          facility.ATTN, g("attn_valid:q"), g("attn_valid:k"),
          g("attn_valid:v"), masks=(jnp.asarray(a["attn_valid:valid"]),),
          plan=PAL),
    }
    with par.use_rules(rules):
        for name, fn in runs.items():
            out[name] = np.asarray(fn().astype(jnp.float32))
    np.savez(OUT, **out)
"""

REFERENCE_CASES = ("gemm2d", "bgemm", "gemm_fused", "gemm_wide", "einsum",
                   "gemm_indivisible", "gemm_packed_y", "conv1d",
                   "conv_stem", "depthwise", "attn", "attn_causal",
                   "attn_gqa", "attn_seq", "attn_window", "attn_valid")


@pytest.fixture(scope="module")
def reference(world):
    _, arrays, out = world
    src = (f"IN = {os.path.join(out, 'sharding.npz')!r}\n"
           f"OUT = {os.path.join(out, 'reference.npz')!r}\n"
           + textwrap.dedent(_REFERENCE))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        + env.get("XLA_FLAGS", ""))
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True,
                          text=True, env=env, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return dict(np.load(os.path.join(out, "reference.npz")))


@pytest.mark.parametrize("case", REFERENCE_CASES)
def test_sharded_contract_matches_reference_mesh(world, reference, case):
    _, arrays, _ = world
    got = arrays[f"{case}:sharded"].astype(np.float32)
    want = reference[case]
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)
