"""The port's GEMM (repro_torch.kernels.mma_gemm and contract's gemm
op-class) against the JAX reference, on the CPU.

The same numpy inputs go through the reference's Pallas kernel in
interpret mode (or its ``contract`` on the xla backend) and through the
port, whose kernel wrapper runs its plain version on a CPU tensor.

Tolerances: F32GER and BF16GER2 with an f32 output within
``rtol=2e-5, atol=2e-5 * max|ref|`` (the two sum in another order in fp32;
bf16 products are exact in fp32); a bf16 output within 1 bf16 ulp of the
reference plus that fp32 sum-order noise (a near-tie may round either way).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import facility as jfac
from repro.core import precision as jprec
from repro.kernels import epilogue as jep
from repro.kernels import mma_gemm as jgemm
from repro_torch.core import facility as tfac
from repro_torch.core import precision as tprec
from repro_torch.core import tiling
from repro_torch.kernels import epilogue as tep
from repro_torch.kernels import mma_gemm as tgemm

CPU_F32 = dict(device="cpu", ger=tprec.Ger.F32GER, out_dtype=torch.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a, np.float32).copy())
    return t.to(dtype) if dtype is not None else t


def _np(t):
    return t.detach().to(torch.float32).numpy()


def assert_f32_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


def assert_bf16_close(got, want):
    """Within 1 bf16 ulp of the reference plus fp32 sum-order noise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    tol = ulp + 2e-5 * float(np.abs(want).max())
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
KINDS = {"f32": "F32GER", "bf16": "BF16GER2"}


@pytest.mark.parametrize("kind,out", [("f32", "f32"), ("bf16", "f32"),
                                      ("bf16", "bf16")])
@pytest.mark.parametrize("shape", [(37, 200, 130), (8, 64, 128),
                                   (5, 99, 257)])
def test_plain_matches_pallas_2d(kind, out, shape):
    m, k, n = shape
    rng = np.random.default_rng(m * k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    ger = KINDS[kind]
    want = jgemm.mma_gemm(jnp.asarray(x, JDT[kind]), jnp.asarray(y, JDT[kind]),
                          kind=jprec.Ger[ger], out_dtype=JDT[out],
                          interpret=True)
    got = tgemm.mma_gemm(_t(x, TDT[kind]), _t(y, TDT[kind]),
                         kind=tprec.Ger[ger], out_dtype=TDT[out])
    assert got.dtype == TDT[out] and tuple(got.shape) == (m, n)
    check = assert_f32_close if out == "f32" else assert_bf16_close
    check(_np(got), np.asarray(want, np.float32))


def test_plain_matches_pallas_batched_ragged():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 21, 70)).astype(np.float32)
    y = (rng.standard_normal((3, 70, 45)) * 0.1).astype(np.float32)
    want = jgemm.mma_gemm(jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(y, jnp.bfloat16),
                          kind=jprec.Ger.BF16GER2, out_dtype=jnp.float32,
                          interpret=True)
    got = tgemm.mma_gemm(_t(x, torch.bfloat16), _t(y, torch.bfloat16),
                         kind=tprec.Ger.BF16GER2, out_dtype=torch.float32)
    assert tuple(got.shape) == (3, 21, 45)
    assert_f32_close(_np(got), want)


@pytest.mark.parametrize("neg_product,neg_acc,alpha,beta", [
    (False, False, 1.0, 1.0), (True, False, 0.5, 1.0),
    (False, True, 1.0, -2.0), (True, True, -1.5, 0.25)])
def test_plain_matches_pallas_accumulate_forms(neg_product, neg_acc, alpha,
                                               beta):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((24, 96)).astype(np.float32)
    y = (rng.standard_normal((96, 136)) * 0.1).astype(np.float32)
    c = rng.standard_normal((24, 136)).astype(np.float32)
    kw = dict(neg_product=neg_product, neg_acc=neg_acc, alpha=alpha,
              beta=beta)
    want = jgemm.mma_gemm(jnp.asarray(x), jnp.asarray(y), jnp.asarray(c),
                          kind=jprec.Ger.F32GER, interpret=True, **kw)
    got = tgemm.mma_gemm(_t(x), _t(y), _t(c), kind=tprec.Ger.F32GER, **kw)
    assert_f32_close(_np(got), want)


@pytest.mark.parametrize("bias,act,res", [
    (True, None, False), (False, "relu", False), (False, "silu", False),
    (False, "gelu", False), (False, None, True), (True, "gelu", True),
    (True, "silu", True)])
def test_plain_matches_pallas_epilogues(bias, act, res):
    rng = np.random.default_rng(11)
    m, k, n = 19, 64, 130
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = (rng.standard_normal((k, n)) * 0.2).astype(np.float32)
    b = rng.standard_normal((n,)).astype(np.float32) if bias else None
    r = rng.standard_normal((m, n)).astype(np.float32) if res else None
    want = jgemm.mma_gemm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16),
        kind=jprec.Ger.BF16GER2,
        ep=jep.Epilogue(bias=bias, activation=act, residual=res),
        bias=None if b is None else jnp.asarray(b),
        residual=None if r is None else jnp.asarray(r, jnp.bfloat16),
        out_dtype=jnp.float32, interpret=True)
    got = tgemm.mma_gemm(
        _t(x, torch.bfloat16), _t(y, torch.bfloat16),
        kind=tprec.Ger.BF16GER2,
        ep=tep.Epilogue(bias=bias, activation=act, residual=res),
        bias=None if b is None else _t(b),
        residual=None if r is None else _t(r, torch.bfloat16),
        out_dtype=torch.float32)
    assert_f32_close(_np(got), want)


def _contract_pair(spec, x, y, *, ger, out, backend, **kw):
    """The same contract on the reference (xla backend) and on the port."""
    jplan = jfac.Plan(ger=jprec.Ger[ger], out_dtype=JDT[out], backend="xla",
                      **{k: v for k, v in kw.items()
                         if k not in ("acc", "bias", "residual")})
    want = jfac.contract(
        spec, jnp.asarray(x), jnp.asarray(y), plan=jplan,
        acc=None if kw.get("acc") is None else jnp.asarray(kw["acc"]),
        bias=None if kw.get("bias") is None else jnp.asarray(kw["bias"]),
        residual=(None if kw.get("residual") is None
                  else jnp.asarray(kw["residual"])))
    tplan = tfac.Plan(ger=tprec.Ger[ger], out_dtype=TDT[out],
                      backend=backend,
                      **{k: v for k, v in kw.items()
                         if k not in ("acc", "bias", "residual")})
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        got = tfac.contract(
            spec, _t(x), _t(y), plan=tplan,
            acc=None if kw.get("acc") is None else _t(kw["acc"]),
            bias=None if kw.get("bias") is None else _t(kw["bias"]),
            residual=(None if kw.get("residual") is None
                      else _t(kw["residual"])))
    return _np(got), np.asarray(want, np.float32)


@pytest.mark.parametrize("backend", ["kernel", "torch", "ref"])
@pytest.mark.parametrize("spec,xs,ys", [
    ("...k,kn->...n", (2, 7, 48), (48, 40)),          # the models' DOT
    ("bmk,bkn->bmn", (3, 9, 32), (3, 32, 20)),         # batched
    ("bkm,bnk->bmn", (2, 32, 9), (2, 20, 32)),         # permuted operands
    ("mk,kn->nm", (9, 32), (32, 20)),                  # permuted output
])
def test_contract_matches_reference(backend, spec, xs, ys):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(xs).astype(np.float32)
    y = rng.standard_normal(ys).astype(np.float32)
    got, want = _contract_pair(spec, x, y, ger="F32GER", out="f32",
                               backend=backend)
    assert got.shape == want.shape
    assert_f32_close(got, want)


@pytest.mark.parametrize("backend", ["kernel", "torch", "ref"])
@pytest.mark.parametrize("spec,ys", [("...k,kn->...n", (64, 48)),
                                     ("bmk,bkn->bmn", (2, 64, 48))])
def test_contract_fused_forms_match_reference(backend, spec, ys):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    y = (rng.standard_normal(ys) * 0.2).astype(np.float32)
    acc = rng.standard_normal((2, 5, 48)).astype(np.float32)
    bias = rng.standard_normal((48,)).astype(np.float32)
    res = rng.standard_normal((2, 5, 48)).astype(np.float32)
    got, want = _contract_pair(
        spec, x, y, ger="F32GER", out="f32", backend=backend,
        acc=acc, bias=bias, residual=res, neg_product=True, alpha=0.75,
        beta=-0.5)
    assert_f32_close(got, want)


def test_every_backend_lowers_the_slice():
    from repro_torch.core import lowering
    for op_class in ("gemm", "attn", "einsum"):
        assert lowering.backends_for(op_class, tprec.Ger.BF16GER2) == (
            ["kernel", "torch", "ref"] if op_class != "einsum"
            else ["torch", "ref"])


@pytest.mark.parametrize("backend", ["kernel", "torch", "ref"])
@pytest.mark.parametrize("fused", [False, True])
def test_f32ger_3xbf16_chain_matches_reference(backend, fused):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, 80)).astype(np.float32)
    y = rng.standard_normal((80, 33)).astype(np.float32)
    kw = dict(bias=rng.standard_normal((33,)).astype(np.float32),
              alpha=2.0) if fused else {}
    got, want = _contract_pair("mk,kn->mn", x, y, ger="F32GER_3XBF16",
                               out="f32", backend=backend, **kw)
    assert_f32_close(got, want)
    # and the chain really is closer to fp32 than one bf16 pass
    exact = np.matmul(x.astype(np.float64), y.astype(np.float64))
    if fused:
        exact = 2.0 * exact + kw["bias"]
    assert np.abs(got - exact).max() < 1e-3


def test_bf16_default_contract_matches_reference():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 4, 128)).astype(np.float32)
    y = (rng.standard_normal((128, 96)) * 0.1).astype(np.float32)
    got, want = _contract_pair("...k,kn->...n", x, y, ger="BF16GER2",
                               out="bf16", backend="kernel")
    assert_bf16_close(got, want)


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.5, -1.5)])
def test_ref_gemm_matches_reference_oracle(alpha, beta):
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(12)
    x = rng.standard_normal((9, 40)).astype(np.float32)
    y = rng.standard_normal((40, 11)).astype(np.float32)
    c = rng.standard_normal((9, 11)).astype(np.float32)
    want = jref.gemm(jnp.asarray(x), jnp.asarray(y), jprec.Ger.F32GER,
                     jnp.asarray(c), alpha=alpha, beta=beta)
    got = tref.gemm(_t(x), _t(y), tprec.Ger.F32GER, _t(c), alpha=alpha,
                    beta=beta)
    assert_f32_close(_np(got), want)


def test_choose_blocks_picks_compiled_tiles():
    for ger in (tprec.Ger.BF16GER2, tprec.Ger.F16GER2, tprec.Ger.F32GER):
        tiles = tiling.tiles_for(ger)
        pol = tprec.policy(ger)
        for m, n, k in ((4, 4096, 4096), (256, 11008, 4096), (1, 8, 8),
                        (4096, 4096, 4096)):
            assert tiling.choose_blocks(m, n, k, ger) in tiles
        for cfg in tiles:
            assert cfg.smem_bytes(pol) <= tiling.SMEM_PER_BLOCK
    # decode's skinny products take the small tile, large ones the big one
    bf = tprec.Ger.BF16GER2
    assert tiling.choose_blocks(4, 4096, 4096, bf).bm == 64
    assert tiling.choose_blocks(256, 11008, 4096, bf).bm == 128


def test_uncompiled_block_raises():
    x = torch.zeros((8, 16), dtype=torch.bfloat16)
    y = torch.zeros((16, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not a compiled"):
        tgemm.mma_gemm(x, y, block=(32, 128, 128))
    # the integer families have compiled tiles now, and their block runs
    assert tiling.tiles_for(tprec.Ger.I8GER4) == (
        tiling.BlockConfig(128, 128, 64),)
    out = tgemm.mma_gemm(torch.ones((8, 16), dtype=torch.int8),
                         torch.ones((16, 8), dtype=torch.uint8),
                         kind=tprec.Ger.I8GER4, block=(128, 128, 64))
    assert out.dtype == torch.int32 and bool((out == 16).all())
    with pytest.raises(ValueError, match="not a compiled"):
        tgemm.mma_gemm(torch.ones((8, 16), dtype=torch.int8),
                       torch.ones((16, 8), dtype=torch.uint8),
                       kind=tprec.Ger.I8GER4, block=(128, 128, 32))
    # an expansion hook has no tile of its own
    with pytest.raises(NotImplementedError):
        tiling.tiles_for(tprec.Ger.F32GER_3XBF16)


def test_later_op_classes_raise_with_their_slice():
    x = torch.zeros((4, 8))
    y = torch.zeros((8, 4))
    with tfac.configure(tfac.FacilityConfig(**CPU_F32)):
        # the pm* masked forms (K1b) are ported: their op-class runs
        rows = torch.tensor([True, False, True, True])
        out = tfac.contract("mk,kn->mn", x + 1, y + 1,
                            masks=(rows, None, None))
        assert out.shape == (4, 4) and bool((out[1] == 0).all())
        assert bool((out[0] == 8).all())
        # the saturating forms (slice C2) are ported: they run on integer
        # families and refuse float ones, as the reference does
        out = tfac.contract("mk,kn->mn", x.to(torch.int16),
                            y.to(torch.int16),
                            plan=tfac.Plan(ger=tprec.Ger.I16GER2,
                                           saturating=True,
                                           out_dtype=tfac.ACC))
        assert out.dtype == torch.int32 and out.shape == (4, 4)
        with pytest.raises(ValueError, match="integer-only"):
            tfac.contract("mk,kn->mn", x, y, plan=tfac.Plan(saturating=True))
        # the dense conv (slice B2, K3) is ported: it runs
        assert tfac.contract("nhwc,hwio->nhwo", torch.zeros((1, 4, 4, 2)),
                             torch.zeros((2, 2, 2, 3))).shape == (1, 3, 3, 3)
        # complex contractions (slice C1) are ported: they run
        out = tfac.contract("mk,kn->mn", x.to(torch.complex64),
                            y.to(torch.complex64))
        assert out.dtype == torch.complex64 and out.shape == (4, 4)
        # and so do the integer families (K1c/K1f)
        out = tfac.contract("mk,kn->mn", x.to(torch.int8),
                            y.to(torch.uint8),
                            plan=tfac.Plan(ger=tprec.Ger.I8GER4,
                                           out_dtype=tfac.ACC))
        assert out.dtype == torch.int32 and out.shape == (4, 4)


def test_cpu_tensors_never_run_a_cuda_facility(monkeypatch):
    """A facility configured for the card refuses CPU operands instead of
    quietly computing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = tfac.FacilityConfig()
    assert cfg.device.type == "cuda"
    with tfac.configure(cfg):
        with pytest.raises(ValueError, match="facility runs on cuda"):
            tfac.contract(tfac.DOT, torch.zeros((2, 8)), torch.zeros((8, 4)))
