"""The rest of K1's family table (I8GER4, I4GER8, I16GER2, F64GER) in the
port against the JAX reference, on the CPU.

The same numpy inputs go through the reference's Pallas kernel in
interpret mode and its ``ref.ger`` oracle, and through the port's kernel
wrapper (its plain version on a CPU tensor) and its ``ref.ger``; then
through ``contract`` on every backend of both.

Tolerances: the integer families bit for bit (int32 that wraps modulo
2**32, alpha and beta truncated to integers); F64GER within rtol = atol =
1e-12, the reference's own fp64 tolerance (sums in another order).
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import facility as jfac
from repro.core import precision as jprec
from repro.kernels import epilogue as jep
from repro.kernels import mma_gemm as jgemm
from repro.kernels import ref as jref
from repro_torch.core import facility as tfac
from repro_torch.core import precision as tprec
from repro_torch.core import tiling
from repro_torch.kernels import epilogue as tep
from repro_torch.kernels import mma_gemm as tgemm
from repro_torch.kernels import ref as tref

FAMILIES = ("I8GER4", "I4GER8", "I16GER2", "F64GER")
INT_FAMILIES = FAMILIES[:3]

# (x dtype, y dtype, x range, y range, K packing) per family
OPERANDS = {
    "I8GER4": (np.int8, np.uint8, (-128, 128), (0, 256), 1),
    "I4GER8": (np.int8, np.int8, (-128, 128), (-128, 128), 2),
    "I16GER2": (np.int16, np.int16, (-32768, 32768), (-32768, 32768), 1),
    "F64GER": (np.float64, np.float64, None, None, 1),
}


def operands(fam, shape_x, shape_y, seed):
    """Seeded numpy operands; ``shape_*`` name logical K, which packs to
    K/2 bytes for I4GER8."""
    xd, yd, xr, yr, pack = OPERANDS[fam]
    rng = np.random.default_rng(seed)
    sx = shape_x[:-1] + (shape_x[-1] // pack,)
    sy = shape_y[:-2] + (shape_y[-2] // pack, shape_y[-1])
    if xr is None:
        return rng.standard_normal(sx), rng.standard_normal(sy)
    return (rng.integers(*xr, sx).astype(xd),
            rng.integers(*yr, sy).astype(yd))


def seed_like(fam, shape, seed):
    rng = np.random.default_rng(seed)
    if fam == "F64GER":
        return rng.standard_normal(shape)
    return rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(
        np.int32)


def small_like(fam, shape, seed):
    rng = np.random.default_rng(seed)
    if fam == "F64GER":
        return rng.standard_normal(shape)
    return rng.integers(-1000, 1000, shape).astype(np.int32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def assert_same(fam, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    if fam == "F64GER":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_array_equal(got, want)


def _kernel_pair(fam, x, y, c=None, *, ep=None, bias=None, residual=None,
                 out=None, **forms):
    """(port wrapper's plain version, reference interpret kernel)."""
    jep_ = (None if ep is None else jep.Epilogue(
        bias=ep.bias, activation=ep.activation, residual=ep.residual))
    want = jgemm.mma_gemm(_j(x), _j(y), _j(c), kind=jprec.Ger[fam],
                          ep=jep_, bias=_j(bias), residual=_j(residual),
                          out_dtype=None if out is None else out[0],
                          interpret=True, **forms)
    got = tgemm.mma_gemm(_t(x), _t(y), _t(c), kind=tprec.Ger[fam], ep=ep,
                         bias=_t(bias), residual=_t(residual),
                         out_dtype=None if out is None else out[1], **forms)
    if got.dtype == torch.bfloat16:          # numpy has no bf16
        return got.double().numpy(), np.asarray(want, np.float64)
    return got.numpy(), np.asarray(want)


def x64(on: bool):
    """JAX's x64 mode for the reference's float64 operands and outputs:
    ``jax.enable_x64`` where the installed jax has it (0.9 removed the
    older ``jax.experimental.enable_x64``), else the older spelling."""
    if not on:
        return contextlib.nullcontext()
    if hasattr(jax, "enable_x64"):
        return jax.enable_x64(True)
    from jax.experimental import enable_x64
    return enable_x64()


CASES = {
    "ragged": dict(shape=(37, 96, 45)),
    "batch": dict(shape=(19, 64, 30), batch=2),
    "pp": dict(shape=(20, 64, 24), seed=True),
    "np": dict(shape=(20, 64, 24), seed=True, neg_product=True),
    "pn": dict(shape=(20, 64, 24), seed=True, neg_acc=True),
    "nn": dict(shape=(20, 64, 24), seed=True, neg_product=True,
               neg_acc=True, alpha=-2.0, beta=3.0),
    "batch_seed": dict(shape=(9, 32, 17), batch=3, seed=True, beta=2.0),
    "bias_relu_res": dict(shape=(33, 64, 40), epilogue=True),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fam", FAMILIES)
def test_kernel_plain_matches_interpret(fam, case):
    with x64(fam == "F64GER"):
        _kernel_case(fam, case)


def _kernel_case(fam, case):
    spec = CASES[case]
    m, k, n = spec["shape"]
    lead = (spec["batch"],) if "batch" in spec else ()
    x, y = operands(fam, lead + (m, k), lead + (k, n),
                    seed=list(CASES).index(case))
    c = seed_like(fam, lead + (m, n), 3) if spec.get("seed") else None
    forms = {f: spec[f] for f in ("neg_product", "neg_acc", "alpha", "beta")
             if f in spec}
    kw = {}
    if spec.get("epilogue"):
        kw = dict(ep=tep.Epilogue(bias=True, activation="relu",
                                  residual=True),
                  bias=small_like(fam, (n,), 4),
                  residual=small_like(fam, lead + (m, n), 5))
    got, want = _kernel_pair(fam, x, y, c, **kw, **forms)
    assert_same(fam, got, want)
    # the port's oracle against the reference's, per batch element
    if not lead:
        got = tref.ger(_t(x), _t(y), tprec.Ger[fam], acc=_t(c),
                       neg_product=spec.get("neg_product", False),
                       neg_acc=spec.get("neg_acc", False))
        want = jref.ger(_j(x), _j(y), jprec.Ger[fam], acc=_j(c),
                        neg_product=spec.get("neg_product", False),
                        neg_acc=spec.get("neg_acc", False))
        assert_same(fam, got.numpy(), want)


def test_i16ger2_wraps_like_the_reference():
    """Full-range int16 at K = 96 overflows int32: the port wraps modulo
    2**32 bit for bit with the reference's int32 dot."""
    x, y = operands("I16GER2", (24, 96), (96, 20), seed=11)
    exact = x.astype(np.int64) @ y.astype(np.int64)
    assert (np.abs(exact) > 2 ** 31 - 1).any()          # it does wrap
    got, want = _kernel_pair("I16GER2", x, y)
    assert_same("I16GER2", got, want)
    np.testing.assert_array_equal(got, exact.astype(np.int32))


@pytest.mark.parametrize("alpha,beta", [(1.5, 2.9), (0.5, -1.7),
                                        (-2.5, 0.25)])
def test_integer_alpha_beta_truncate(alpha, beta):
    """The reference multiplies by jnp.asarray(alpha, int32): alpha and
    beta act as their integer parts (1.5 as 1, 0.5 as 0)."""
    x, y = operands("I8GER4", (16, 64), (64, 12), seed=2)
    c = small_like("I8GER4", (16, 12), 6)
    got, want = _kernel_pair("I8GER4", x, y, c, alpha=alpha, beta=beta)
    assert_same("I8GER4", got, want)
    trunc, _ = _kernel_pair("I8GER4", x, y, c, alpha=float(int(alpha)),
                            beta=float(int(beta)))
    np.testing.assert_array_equal(got, trunc)


@pytest.mark.parametrize("fam", INT_FAMILIES)
@pytest.mark.parametrize("out", ["float32", "float64", "bfloat16"])
def test_integer_out_dtype_cast(fam, out):
    x, y = operands(fam, (12, 32), (32, 10), seed=7)
    with x64(out == "float64"):
        got, want = _kernel_pair(fam, x, y, out=(getattr(jnp, out),
                                                 getattr(torch, out)))
    np.testing.assert_array_equal(np.asarray(got, np.float64),
                                  np.asarray(want, np.float64))


@pytest.mark.parametrize("act", ["gelu", "silu"])
@pytest.mark.parametrize("fam", INT_FAMILIES)
def test_float_activations_refuse_integer_accumulators(fam, act):
    x, y = operands(fam, (8, 32), (32, 8), seed=1)
    with pytest.raises(ValueError, match="float accumulator"):
        tgemm.mma_gemm(_t(x), _t(y), kind=tprec.Ger[fam],
                       ep=tep.Epilogue(activation=act))
    with pytest.raises(ValueError, match="float accumulator"):
        jgemm.mma_gemm(_j(x), _j(y), kind=jprec.Ger[fam],
                       ep=jep.Epilogue(activation=act), interpret=True)


def test_integer_families_have_no_gradient():
    x = torch.zeros((4, 32), dtype=torch.float32, requires_grad=True)
    y = torch.zeros((32, 4), dtype=torch.uint8)
    with pytest.raises(TypeError, match="integer family"):
        tgemm.mma_gemm(x.to(torch.int8), y, kind=tprec.Ger.I8GER4,
                       bias=torch.zeros(4, requires_grad=True),
                       ep=tep.Epilogue(bias=True))


def test_f64ger_gradient_runs_through_the_wrapper():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 8))).requires_grad_(True)
    y = torch.from_numpy(rng.standard_normal((8, 5))).requires_grad_(True)
    out = tgemm.mma_gemm(x, y, kind=tprec.Ger.F64GER, alpha=0.5,
                         ep=tep.Epilogue(activation="silu"))
    out.sum().backward()
    xr, yr = x.detach().requires_grad_(True), y.detach().requires_grad_(True)
    torch.nn.functional.silu(0.5 * torch.matmul(xr, yr)).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(y.grad, yr.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fam", FAMILIES)
def test_paths_and_tiles(fam):
    ger = tprec.Ger[fam]
    path, cfg = tiling.choose_gemm_path(4, 4096, 4096, ger)
    assert path == ("dmma" if fam == "F64GER" else "imma")
    if fam == "F64GER":
        assert cfg in tiling.tiles_for(ger)
        assert cfg.smem_bytes(tprec.policy(ger)) <= tiling.SMEM_PER_BLOCK
    else:   # the IMMA kernel's wgmma tile, by tiling.imma_plan
        assert cfg == tiling.imma_plan(4, 4096, 4096, ger)
        assert cfg.smem_bytes(ger) <= tiling.SMEM_PER_BLOCK
    for tile in tiling.tiles_for(ger):
        assert tile.smem_bytes(tprec.policy(ger)) <= tiling.SMEM_PER_BLOCK
    # an explicit block names the compiled tile; another raises
    assert tiling.choose_gemm_path(4, 64, 64, ger,
                                   block=tuple(tiling.GEMM_TILES[ger][0]))[0] \
        == path
    with pytest.raises(ValueError, match="not a compiled"):
        tiling.choose_gemm_path(4, 64, 64, ger, block=(32, 32, 32))


@pytest.mark.parametrize("backend", ["kernel", "torch", "ref"])
@pytest.mark.parametrize("fam", FAMILIES)
def test_contract_matches_reference(fam, backend):
    with x64(fam == "F64GER"):
        _contract_case(fam, backend)


def _contract_case(fam, backend):
    """``contract`` with Plan(ger=...) on each port backend against the
    reference's xla and ref lowerings: a batched spec with a seed, the np
    form and an integer-truncated alpha/beta, and a permuted output."""
    x, y = operands(fam, (2, 13, 64), (2, 64, 11), seed=9)
    c = seed_like(fam, (2, 13, 11), 10)
    forms = dict(neg_product=True, alpha=2.5, beta=-1.5)
    for jb in ("xla", "ref"):
        want = jfac.contract(
            "bmk,bkn->bmn", _j(x), _j(y), acc=_j(c),
            plan=jfac.Plan(ger=jprec.Ger[fam], out_dtype=jfac.ACC,
                           backend=jb, **forms))
        with tfac.configure(tfac.FacilityConfig(device="cpu")):
            got = tfac.contract(
                "bmk,bkn->bmn", _t(x), _t(y), acc=_t(c),
                plan=tfac.Plan(ger=tprec.Ger[fam], out_dtype=tfac.ACC,
                               backend=backend, **forms))
        assert_same(fam, got.numpy(), want)
    x2, y2 = operands(fam, (13, 64), (64, 11), seed=12)
    want = jfac.contract("mk,kn->nm", _j(x2), _j(y2),
                         plan=jfac.Plan(ger=jprec.Ger[fam],
                                        out_dtype=jfac.ACC, backend="xla"))
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        got = tfac.contract("mk,kn->nm", _t(x2), _t(y2),
                            plan=tfac.Plan(ger=tprec.Ger[fam],
                                           out_dtype=tfac.ACC,
                                           backend=backend))
    assert_same(fam, got.numpy(), want)


def test_unpack_int4_matches_reference():
    v = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(tref.unpack_int4(_t(v)).numpy(),
                                  np.asarray(jref.unpack_int4(_j(v))))
