"""K1d on every GEMM path: packed X and Y panels in every family the
reference packs, masked or not, batched or shared, in the port against the
JAX reference, on the CPU.

The reference's one Pallas GEMM reads packed X and Y panels in every family
but I4GER8 (``packed_spec``), masked too; a packed operand without a batch
axis under a batched grid is shared, its index map ignoring the batch
coordinate.  The port's wrapper reads the panels on every path (the
stream, the wgmma tile, the WMMA and fp32 tiles, IMMA and DMMA; on the CPU
the plain version of that path over ``packing.gemm_panels_matrix``), with
no demote.  Each case here:

  * the port's packed call gives the port's natural call bit for bit, with
    ``packing.COUNTERS["demote"]`` unchanged: through ``facility.contract``
    for the batched form (``bmk,bkn->bmn``), through the kernel wrapper
    for the shared form, whose natural counterpart is the shared operand
    expanded over the batch (``contract`` has no spec for an operand
    without the batch label);
  * it matches the reference's ``mma_gemm(x_layout=, y_layout=, masks=,
    interpret=True)`` on the same panels: the integer families bit for
    bit, F64GER within 1e-15 * K * max|x| * max|y| (under
    ``jax.enable_x64``), F32GER, BF16GER2 and F16GER2 within 1e-5 of
    max|ref| (fp32 accumulators, sums in another order:
    tests/test_torch_masked.py's tolerance).

Masked cases put NaN in every disabled lane of the float operands: the
kernels (and the reference) select those lanes to zero, never multiply
them.  The repaired fault is pinned on its own: an unbatched packed Y
beside a batched natural x used to raise ``shape mismatch``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro.core import precision as jprec
from repro.kernels import mma_gemm as jgemm
from repro_torch.core import facility as tfac
from repro_torch.core import packing
from repro_torch.core import precision as tprec
from repro_torch.kernels import mma_gemm as tgemm
from test_torch_families import x64
from test_torch_masked import _masks, _operands

CPU = tfac.FacilityConfig(device="cpu")
FAMILIES = ("BF16GER2", "F16GER2", "F32GER", "F64GER", "I8GER4", "I16GER2")
INTEGER = ("I8GER4", "I16GER2")
# M, K and N fringes past the (128, 64) X and (64, 64) Y panels
M, K, N, B = 100, 136, 72, 2


@pytest.fixture(autouse=True)
def _clean_counters():
    packing.clear_state()
    yield
    packing.clear_state()


def _inputs(fam, side, masked, form, seed):
    """numpy x (B?, M, K) and y (B?, K, N) in the family's values, the
    masks (or None), and which operand is shared: in the shared form the
    packed y (or, with x alone packed, the packed x) has no batch axis."""
    shared = None
    if form == "shared":
        shared = "x" if side == "x" else "y"
    lx = () if shared == "x" else (B,)
    ly = () if shared == "y" else (B,)
    x, y = _operands(fam, lx + (M, K), ly + (K, N), seed)
    masks = _masks(seed, M, N, K) if masked else None
    if masked and fam not in INTEGER:
        x, y = x.copy(), y.copy()
        xm, ym, pm = masks
        x[..., ~xm, :] = np.nan
        x[..., ~pm] = np.nan
        y[..., ~pm, :] = np.nan
        y[..., ~ym] = np.inf
    return x, y, masks, shared


def _torch(a, fam, which):
    pol = tprec.policy(tprec.Ger[fam])
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        pol.x_dtype if which == "x" else pol.y_dtype)


def _jax(a, fam, which):
    pol = jprec.policy(jprec.Ger[fam])
    return jnp.asarray(a).astype(pol.x_dtype if which == "x"
                                 else pol.y_dtype)


def _layout(mod, fam, side, batched):
    ger = (tprec if mod is packing else jprec).Ger[fam]
    rows, cols = (M, K) if side == "x" else (K, N)
    return mod.GemmLayout(kind=ger, block=packing.PANEL_BLOCK, side=side,
                          rows=rows, cols=cols, batched=batched)


def _close(fam, got, want, x, y):
    got = (got.double() if got.dtype == torch.bfloat16 else got).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if fam in INTEGER:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    if fam == "F64GER":
        finite = lambda a: np.abs(a[np.isfinite(a)]).max()  # noqa: E731
        tol = 1e-15 * K * finite(x) * finite(y)
    else:
        tol = 1e-5 * max(np.abs(want).max(), 1.0)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


@pytest.mark.parametrize("form", ["batched", "shared"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("side", ["x", "y", "both"])
@pytest.mark.parametrize("fam", FAMILIES)
def test_packed_operands_read_as_panels(fam, side, masked, form):
    seed = FAMILIES.index(fam) * 10 + len(side) + 3 * masked
    x, y, masks, shared = _inputs(fam, side, masked, form, seed)
    tx, ty = _torch(x, fam, "x"), _torch(y, fam, "y")
    tmasks = None if masks is None else tuple(
        torch.from_numpy(m) for m in masks)
    pack = {"x": side in ("x", "both"), "y": side in ("y", "both")}
    lays = {s: _layout(packing, fam, s, shared != s) for s in "xy"}
    px = packing.pack_gemm(tx, lays["x"]) if pack["x"] else tx
    py = packing.pack_gemm(ty, lays["y"]) if pack["y"] else ty
    kind = tprec.Ger[fam]
    demotes = packing.COUNTERS["demote"]
    if form == "batched":
        plan = tfac.Plan(ger=kind, out_dtype=tfac.ACC)
        with tfac.configure(CPU):
            nat = tfac.contract("bmk,bkn->bmn", tx, ty, masks=tmasks,
                                plan=plan)
            got = tfac.contract("bmk,bkn->bmn", px, py, masks=tmasks,
                                plan=plan)
    else:
        ex, ey = (t.expand((B,) + tuple(t.shape)).contiguous()
                  if t.ndim == 2 else t for t in (tx, ty))
        nat = tgemm.mma_gemm(ex, ey, kind=kind, masks=tmasks)
        got = tgemm.mma_gemm(
            px.data if pack["x"] else px, py.data if pack["y"] else py,
            kind=kind, masks=tmasks,
            x_layout=lays["x"] if pack["x"] else None,
            y_layout=lays["y"] if pack["y"] else None)
    assert torch.equal(got, nat)
    assert packing.COUNTERS["demote"] == demotes

    jlays = {s: _layout(jpack, fam, s, shared != s) for s in "xy"}
    with x64(fam == "F64GER"):
        jx, jy = _jax(x, fam, "x"), _jax(y, fam, "y")
        if pack["x"]:
            jx = jpack.pack_gemm(jx, jlays["x"]).data
        if pack["y"]:
            jy = jpack.pack_gemm(jy, jlays["y"]).data
        want = jgemm.mma_gemm(
            jx, jy, kind=jprec.Ger[fam], interpret=True,
            x_layout=jlays["x"] if pack["x"] else None,
            y_layout=jlays["y"] if pack["y"] else None,
            masks=None if masks is None else tuple(
                jnp.asarray(m) for m in masks))
        want = np.asarray(want)
    _close(fam, got, want, x, y)


def test_shared_packed_operand_under_a_batched_call():
    """The repaired fault: an unbatched packed Y beside a batched x was
    refused (``shape mismatch x(2, 4, 64) @ y(None, 64, 128)``); it is
    shared across the batch, as the reference's index map ignores the
    batch coordinate for it, and gives the natural call on the expanded
    weight bit for bit and the reference's result.  A natural unbatched
    operand beside a batched one stays refused, as in the reference."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4, 64)).astype(np.float32)
    w = rng.standard_normal((64, 128)).astype(np.float32)
    tx, tw = (torch.from_numpy(a).bfloat16() for a in (x, w))
    po = packing.pack_gemm(tw, packing.gemm_layout(tprec.Ger.BF16GER2, 64,
                                                   128))
    got = tgemm.mma_gemm(tx, po.data, y_layout=po.layout)
    assert got.shape == (2, 4, 128)
    assert torch.equal(got, tgemm.mma_gemm(
        tx, tw.expand(2, 64, 128).contiguous()))
    jl = jpack.GemmLayout(kind=jprec.Ger.BF16GER2, block=packing.PANEL_BLOCK,
                          side="y", rows=64, cols=128)
    jw = jpack.pack_gemm(jnp.asarray(w).astype(jnp.bfloat16), jl)
    want = jgemm.mma_gemm(jnp.asarray(x).astype(jnp.bfloat16), jw.data,
                          y_layout=jl, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    with pytest.raises(ValueError, match="mma_gemm wants"):
        tgemm.mma_gemm(tx, tw)
    px = packing.pack_gemm(tx, packing.gemm_layout(
        tprec.Ger.BF16GER2, 4, 64, side="x", batched=True))
    with pytest.raises(ValueError, match="batched natural"):
        tgemm.mma_gemm(px.data, tw, x_layout=px.layout)
