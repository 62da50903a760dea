"""The port's prepacked operands (``repro_torch.core.packing``, K1d and
K3's packed filter stream) against the JAX reference, on the CPU.

Held here:

  * the layout transforms: for the same layout, ``pack_gemm`` and
    ``pack_conv`` give the reference's panels bit for bit (X and Y side,
    transposed, batched, leading axes, fringes; conv nd 1 and 2), unpack
    inverts pack exactly, and the refusals match;
  * a packed dispatch is the natural one bit for bit: ``contract`` on the
    kernel (its plain versions on the CPU), torch and ref backends, 2-D
    products and MoE banks, the 1-D and 2-D conv specs, ``quant.qdot``;
  * the counters: a steady-state packed loop makes no pack, repack or
    demote; a panel mismatch repacks once; the torch/ref backends demote
    once a call, counted, with a reason; every kernel path reads the
    panels (F32GER's WMMA tile, an explicit block, F64GER's DMMA kernel,
    IMMA in I16GER2), so none demotes;
  * ``prepack_params_for_serving`` on port models: its skip rules, its
    stats against the reference's on the same reduced models (the port's
    layers are unstacked: counts are the reference's times the layers,
    bytes equal), mamba2's ``conv_w`` demoted at every depthwise call as
    in the reference, a prepacked qwen2-vl forward bit for bit the natural
    one and within the bf16 model tolerance of tests/test_torch_vlm.py
    (2^-5 of max|ref|) of the reference's prepacked forward, and a CPU
    serve giving the natural run's tokens.

Tolerances: everything port-to-port bit for bit; qdot against the
reference's within 1e-5 of max|ref| (tests/test_torch_quant.py).
"""

from __future__ import annotations

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs.base import reduced as jreduced
from repro.core import facility as jfac
from repro.core import packing as jpack
from repro.core import quant as jquant
from repro.core.precision import Ger as JGer
from repro.data import pipeline as jdata
from repro.models import model as JM
from repro_torch.configs import get as tget
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import facility as tfac
from repro_torch.core import packing
from repro_torch.core import quant as tquant
from repro_torch.core import tiling
from repro_torch.core.precision import Ger
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import mma_gemm as tgemm
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.train import steps as tsteps

CPU = tfac.FacilityConfig(device="cpu")


@pytest.fixture(autouse=True)
def _clean_counters():
    packing.clear_state()
    jpack.clear_state()
    yield
    packing.clear_state()
    jpack.clear_state()


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


# ----------------------------------------------------------------------
# Layouts: the reference's panels, bit for bit
# ----------------------------------------------------------------------

_GEMM_CASES = list(itertools.product(
    [(1, 107), (70, 150), (64, 64), (130, 200)],   # (rows, cols), fringes
    ["x", "y"], [False, True], [0, 2],
    [(128, 64, 64), (32, 64, 48)]))


@pytest.mark.parametrize("dims,side,transposed,lead,block", _GEMM_CASES)
def test_pack_gemm_matches_reference(dims, side, transposed, lead, block):
    rows, cols = dims
    tl = packing.GemmLayout(kind=Ger.F32GER, block=block, side=side,
                            rows=rows, cols=cols, transposed=transposed,
                            batched=lead > 0)
    jl = jpack.GemmLayout(kind=JGer.F32GER, block=block, side=side,
                          rows=rows, cols=cols, transposed=transposed,
                          batched=lead > 0)
    w = _rand((3,) * lead + tl.caller_shape, seed=rows + cols + lead)
    got = packing.pack_gemm(_t(w), tl)
    want = jpack.pack_gemm(jnp.asarray(w), jl)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.shape == tuple(want.shape) == w.shape
    assert got.ndim == w.ndim and got.dtype == torch.float32
    np.testing.assert_array_equal(got.unpack().numpy(), w)


@pytest.mark.parametrize("kh,kw,c,f,bf,nd", [
    (1, 3, 80, 72, 64, 1), (1, 3, 24, 64, 64, 1), (1, 5, 9, 150, 32, 1),
    (3, 3, 8, 72, 64, 2), (4, 4, 3, 128, 64, 2), (2, 5, 7, 1, 64, 2)])
def test_pack_conv_matches_reference(kh, kw, c, f, bf, nd):
    tl = packing.ConvLayout(kind=Ger.BF16GER2, bf=bf, kh=kh, kw=kw, c=c,
                            f=f, nd=nd)
    jl = jpack.ConvLayout(kind=JGer.BF16GER2, bf=bf, kh=kh, kw=kw, c=c,
                          f=f, nd=nd)
    w = _rand(tl.caller_shape, seed=f + c)
    got = packing.pack_conv(_t(w), tl)
    want = jpack.pack_conv(jnp.asarray(w), jl)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.shape == tuple(want.shape) == w.shape
    np.testing.assert_array_equal(got.unpack().numpy(), w)


def test_round_trip_dtypes_and_lead_axes():
    for i, (dt, lead, side) in enumerate(itertools.product(
            (torch.float32, torch.bfloat16, torch.float16, torch.int8),
            (0, 1, 2), ("x", "y"))):
        lay = packing.GemmLayout(kind=Ger.BF16GER2, block=(128, 64, 64),
                                 side=side, rows=75, cols=131,
                                 transposed=bool(i % 2), batched=lead > 0)
        w = (torch.randn((2,) * lead + lay.caller_shape) * 50).to(dt)
        po = packing.pack_gemm(w, lay)
        assert po.dtype == dt and po.shape == tuple(w.shape)
        assert torch.equal(po.unpack(), w)


def test_pack_refusals():
    lay = packing.GemmLayout(kind=Ger.F32GER, block=(128, 64, 64), side="y",
                             rows=16, cols=16)
    with pytest.raises(ValueError, match="natural shape"):
        packing.pack_gemm(torch.zeros(8, 8), lay)
    with pytest.raises(ValueError, match="batch axis"):
        packing.pack_gemm(torch.zeros(16, 16),
                          dataclasses.replace(lay, batched=True))
    with pytest.raises(ValueError, match="int4"):
        packing.pack_gemm(torch.zeros(16, 16, dtype=torch.int8),
                          dataclasses.replace(lay, kind=Ger.I4GER8))
    with pytest.raises(ValueError, match="natural shape"):
        packing.pack_conv(torch.zeros(3, 3, 4, 8),
                          packing.conv_layout(Ger.F32GER, 3, 3, 4, 9))
    q = packing.pack_gemm(
        torch.ones(32, 32, dtype=torch.int8),
        packing.gemm_layout(Ger.I8GER4, 32, 32, side="x", transposed=True),
        scale=torch.ones(1, 32), col_sum=torch.zeros(32))
    assert q.quantized and q.to(torch.int8) is q
    with pytest.raises(ValueError, match="refusing to cast"):
        q.to(torch.float32)
    with pytest.raises(TypeError, match="nn.Module"):
        packing.prepack_params_for_serving({})


# ----------------------------------------------------------------------
# Packed dispatch == natural dispatch, bit for bit
# ----------------------------------------------------------------------

# (m, k, n): the weight stream unsplit and split over K, the wgmma tile,
# and an N fringe of 1000 columns
_GEMM_SHAPES = [(4, 96, 200), (4, 512, 128), (100, 128, 192),
                (24, 64, 1000)]


@pytest.mark.parametrize("backend", ["kernel", "torch", "ref"])
@pytest.mark.parametrize("m,k,n", _GEMM_SHAPES)
def test_packed_gemm_bitwise(backend, m, k, n):
    x = _t(_rand((m, k), 0), torch.bfloat16)
    w = _t(_rand((k, n), 1), torch.bfloat16)
    po = packing.pack_gemm(w, packing.gemm_layout(Ger.BF16GER2, k, n))
    plan = tfac.Plan(backend=backend)
    with tfac.configure(CPU):
        nat = tfac.contract("mk,kn->mn", x, w, plan=plan)
        base = dict(packing.COUNTERS)
        pk = tfac.contract("mk,kn->mn", x, po, plan=plan)
    assert torch.equal(nat, pk)
    demotes = packing.COUNTERS["demote"] - base.get("demote", 0)
    assert demotes == (0 if backend == "kernel" else 1)
    if backend != "kernel":
        assert packing.EVENTS[-1]["why"] == f"{backend}-gemm"


@pytest.mark.parametrize("backend", ["kernel", "torch", "ref"])
def test_packed_moe_bank_bitwise(backend):
    """The expert banks as batched Y panels on the kernel's batch axis, at
    decode (the stream) and prefill (the wgmma tile) capacities, both
    orientations of the expert MLP."""
    e, d, f = 4, 96, 136
    w1 = _t(_rand((e, d, f), 2), torch.bfloat16)
    w2 = _t(_rand((e, f, d), 3), torch.bfloat16)
    p1 = packing.pack_gemm(w1, packing.gemm_layout(Ger.BF16GER2, d, f,
                                                   batched=True))
    p2 = packing.pack_gemm(w2, packing.gemm_layout(Ger.BF16GER2, f, d,
                                                   batched=True))
    plan = tfac.Plan(backend=backend)
    for cap in (1, 80):
        x = _t(_rand((e, cap, d), cap), torch.bfloat16)
        with tfac.configure(CPU):
            h = tfac.contract("ecd,edf->ecf", x, w1, plan=plan)
            assert torch.equal(h, tfac.contract("ecd,edf->ecf", x, p1,
                                                plan=plan))
            y = tfac.contract("ecf,efd->ecd", h, w2, plan=plan)
            assert torch.equal(y, tfac.contract("ecf,efd->ecd", h, p2,
                                                plan=plan))
    assert packing.COUNTERS["demote"] == (0 if backend == "kernel" else 4)


@pytest.mark.parametrize("backend", ["kernel", "torch", "ref"])
@pytest.mark.parametrize("spec,wshape,stride", [
    (tfac.CONV1D, (3, 24, 72), 1), (tfac.CONV1D, (3, 24, 64), 2),
    (tfac.CONV2D, (3, 3, 8, 72), 1), (tfac.CONV2D, (4, 4, 3, 64), 4)])
def test_packed_conv_bitwise(backend, spec, wshape, stride):
    """K3's packed filter stream against the natural filter bank: whisper's
    1-D stem (SAME, stride 1 and 2) and a 2-D patch stem (kernel =
    stride), bias and gelu fused."""
    nd = len(wshape) - 2
    xs = (2, 48, 24) if nd == 1 else (2, 16, 16, wshape[2])
    x = _t(_rand(xs, 4))
    w = _t(_rand(wshape, 5), torch.bfloat16)
    bias = _t(_rand((wshape[-1],), 6))
    kh = 1 if nd == 1 else wshape[0]
    po = packing.pack_conv(w, packing.conv_layout(Ger.BF16GER2, kh,
                                                  *wshape[-3:], nd=nd))
    plan = tfac.Plan(padding="same" if nd == 1 else "valid", stride=stride,
                     backend=backend,
                     epilogue=tfac.Epilogue(bias=True, activation="gelu"))
    with tfac.configure(CPU):
        nat = tfac.contract(spec, x, w, bias=bias, plan=plan)
        pk = tfac.contract(spec, x, po, bias=bias, plan=plan)
    assert torch.equal(nat, pk)
    assert packing.COUNTERS["demote"] == (0 if backend == "kernel" else 1)


def test_paths_without_panels_demote_once_counted():
    """F32GER runs the WMMA fp32 tile, an explicit block names a WMMA
    tile, F32GER's conv runs the fp32 tile, F64GER runs the DMMA kernel
    and I16GER2 the IMMA kernel: each reads packed panels (K1d, K3), Y
    side and X side alike, so none demotes, and each gives the natural
    bits."""
    x = _t(_rand((100, 64), 7))
    w = _t(_rand((64, 136), 8))
    po = packing.pack_gemm(w, packing.gemm_layout(Ger.F32GER, 64, 136))
    w64 = w.double()
    po64 = packing.pack_gemm(w64, packing.gemm_layout(Ger.F64GER, 64, 136))
    px64 = packing.pack_gemm(x.double(), packing.gemm_layout(
        Ger.F64GER, 100, 64, side="x"))
    w16 = (w * 300).to(torch.int16)
    po16 = packing.pack_gemm(w16, packing.gemm_layout(Ger.I16GER2, 64, 136))
    cases = [(tfac.Plan(ger=Ger.F32GER), x, w, x, po),
             (tfac.Plan(block=(64, 64, 64)), x, w, x, po),
             (tfac.Plan(ger=Ger.F64GER), x.double(), w64, x.double(), po64),
             (tfac.Plan(ger=Ger.F64GER), x.double(), w64, px64, po64),
             (tfac.Plan(ger=Ger.I16GER2, out_dtype=tfac.ACC),
              (x * 300).to(torch.int16), w16, (x * 300).to(torch.int16),
              po16)]
    with tfac.configure(CPU):
        for plan, xx, nat, px, pk in cases:
            packing.EVENTS.clear()
            assert torch.equal(tfac.contract("mk,kn->mn", xx, nat, plan=plan),
                               tfac.contract("mk,kn->mn", px, pk, plan=plan))
            assert [e["why"] for e in packing.EVENTS] == []
        img = _t(_rand((1, 8, 8, 4), 9))
        wc = _t(_rand((3, 3, 4, 8), 10))
        pc = packing.pack_conv(wc, packing.conv_layout(Ger.F32GER, 3, 3, 4,
                                                       8))
        packing.EVENTS.clear()
        plan = tfac.Plan(ger=Ger.F32GER)
        assert torch.equal(tfac.contract(tfac.CONV2D, img, wc, plan=plan),
                           tfac.contract(tfac.CONV2D, img, pc, plan=plan))
        assert [e["why"] for e in packing.EVENTS] == []
    assert packing.COUNTERS["demote"] == 0


def test_admission_demotes_what_cannot_ride_packed():
    """A spec the pack's orientation does not fit, the einsum fallback and
    an expansion chain demote at admission, once each, counted."""
    x = _t(_rand((8, 64), 11))
    w = _t(_rand((64, 72), 12))
    po = packing.pack_gemm(w, packing.gemm_layout(Ger.BF16GER2, 64, 72))
    with tfac.configure(CPU):
        for spec, plan, why in (
                ("mk,kn->mn", tfac.Plan(ger=Ger.F32GER_3XBF16), "gemm"),
                ("kn,mk->mn", tfac.Plan(), "spec-orientation")):
            packing.EVENTS.clear()
            ops = (x, w) if spec.startswith("mk") else (w, x)
            pops = (x, po) if spec.startswith("mk") else (po, x)
            assert torch.equal(tfac.contract(spec, *ops, plan=plan),
                               tfac.contract(spec, *pops, plan=plan))
            assert [e["why"] for e in packing.EVENTS] == [why]


# ----------------------------------------------------------------------
# qdot on packed int8 panels
# ----------------------------------------------------------------------

def _qdot_inputs(m=8, k=96, n=200, seed=13):
    x = _rand((m, k), seed) * 2.0 + 0.3
    w = _rand((k, n), seed + 1) * 0.05
    return x, w


@pytest.mark.parametrize("m", [4, 130])
def test_packed_qdot_bitwise_and_against_reference(m):
    x, w = _qdot_inputs(m=m)
    wq, ws = tquant.quantize_weight(_t(w))
    col_sum = wq.to(torch.int32).sum(0).to(torch.float32)
    po = packing.pack_gemm(wq, packing.gemm_layout(
        Ger.I8GER4, 200, 96, side="x", transposed=True), scale=ws,
        col_sum=col_sum)
    with tfac.configure(CPU):
        nat = tquant.qdot(_t(x), wq, ws)
        pk = tquant.qdot(_t(x), po)
        acc_nat = tfac.contract("kn,mk->mn", wq, _t(x).to(torch.uint8),
                                plan=tfac.Plan(ger=Ger.I8GER4,
                                               out_dtype=tfac.ACC))
        acc_pk = tfac.contract("kn,mk->mn", po, _t(x).to(torch.uint8),
                               plan=tfac.Plan(ger=Ger.I8GER4,
                                              out_dtype=tfac.ACC))
    assert torch.equal(nat, pk) and torch.equal(acc_nat, acc_pk)
    assert packing.COUNTERS["demote"] == 0
    jwq, jws = jquant.quantize_weight(jnp.asarray(w))
    jsum = jwq.astype(jnp.int32).sum(axis=0).astype(jnp.float32)
    jpo = jpack.pack_gemm(jwq, jpack.GemmLayout(
        kind=JGer.I8GER4, block=packing.PANEL_BLOCK, side="x", rows=200,
        cols=96, transposed=True), scale=jws, col_sum=jsum)
    np.testing.assert_array_equal(po.data.numpy(), np.asarray(jpo.data))
    want = np.asarray(jquant.qdot(jnp.asarray(x), jpo, backend="xla"))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(pk.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)


def test_packed_qdot_refusals():
    po = packing.pack_gemm(
        torch.ones(32, 32, dtype=torch.int8),
        packing.gemm_layout(Ger.I8GER4, 32, 32, side="x", transposed=True),
        scale=torch.ones(1, 32), col_sum=None)
    with tfac.configure(CPU):
        with pytest.raises(ValueError, match="scale/col_sum"):
            tquant.qdot(torch.ones(4, 32), po)


# ----------------------------------------------------------------------
# Counters: pack once, never read stale panels
# ----------------------------------------------------------------------

def test_steady_state_dispatch_zero_relayout():
    x = _t(_rand((8, 64), 14), torch.bfloat16)
    w = _t(_rand((64, 192), 15), torch.bfloat16)
    po = packing.pack_gemm(w, packing.gemm_layout(Ger.BF16GER2, 64, 192))
    base = dict(packing.COUNTERS)
    data = po.data
    with tfac.configure(CPU):
        for m in (8, 8, 100, 1):
            tfac.contract("mk,kn->mn", x[:1].expand(m, 64).contiguous(), po)
    assert dict(packing.COUNTERS) == base, packing.EVENTS
    assert po.data is data


def test_panel_mismatch_repacks_once():
    x = _t(_rand((8, 96), 16), torch.bfloat16)
    w = _t(_rand((96, 192), 17), torch.bfloat16)
    po = packing.pack_gemm(w, packing.GemmLayout(
        kind=Ger.BF16GER2, block=(8, 128, 32), side="y", rows=96, cols=192))
    with tfac.configure(CPU):
        nat = tfac.contract("mk,kn->mn", x, w)
        for _ in range(3):
            assert torch.equal(nat, tfac.contract("mk,kn->mn", x, po))
    assert packing.COUNTERS["repack"] == 1
    assert packing.COUNTERS["invalidate"] == 1
    assert packing.COUNTERS["demote"] == 0
    assert po.layout.block == packing.PANEL_BLOCK


def test_wrapper_refuses_stale_or_unread_panels():
    """The wrapper refuses a stale layout (it never reads stale panels);
    an explicit block names a WMMA tile, which reads the panels (K1d); so
    does F64GER's DMMA kernel, on either side or both, masked too: no
    demote event, the natural bits."""
    w = torch.ones(64, 128, dtype=torch.bfloat16)
    stale = packing.GemmLayout(kind=Ger.BF16GER2, block=(8, 128, 32),
                               side="y", rows=64, cols=128)
    po = packing.pack_gemm(w, stale)
    x = torch.ones(4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stale packed layout"):
        tgemm.mma_gemm(x, po.data, y_layout=stale)
    fresh = packing.pack_gemm(w, packing.gemm_layout(Ger.BF16GER2, 64, 128))
    x = _t(_rand((100, 64), 30), torch.bfloat16)
    packing.EVENTS.clear()
    assert torch.equal(
        tgemm.mma_gemm(x, w, block=(64, 64, 64)),
        tgemm.mma_gemm(x, fresh.data, block=(64, 64, 64),
                       y_layout=fresh.layout))
    assert list(packing.EVENTS) == []
    w64 = _t(_rand((64, 128), 31)).double()
    p64 = packing.pack_gemm(w64, packing.gemm_layout(Ger.F64GER, 64, 128))
    x64 = x.double()
    px64 = packing.pack_gemm(x64, packing.gemm_layout(Ger.F64GER, 100, 64,
                                                      side="x"))
    masks = (torch.arange(100) % 3 > 0, torch.arange(128) % 5 > 0,
             torch.arange(64) % 7 > 0)
    packing.EVENTS.clear()
    for mk in (None, masks):
        want = tgemm.mma_gemm(x64, w64, kind=Ger.F64GER, masks=mk)
        assert torch.equal(want, tgemm.mma_gemm(
            x64, p64.data, kind=Ger.F64GER, y_layout=p64.layout, masks=mk))
        assert torch.equal(want, tgemm.mma_gemm(
            px64.data, p64.data, kind=Ger.F64GER, x_layout=px64.layout,
            y_layout=p64.layout, masks=mk))
    assert list(packing.EVENTS) == []
    want = tgemm.mma_gemm(x, w)
    assert torch.equal(want, tgemm.mma_gemm(x, fresh.data,
                                            y_layout=fresh.layout))
    assert packing.COUNTERS["demote"] == 0


def test_demote_refuses_a_quantized_operand_without_its_scale():
    """A quantized operand's natural values are raw int8: demoted only for
    a dispatch that applies its scale (qdot's Dequant, on every backend),
    refused elsewhere, as its cast is."""
    x, w = _qdot_inputs(m=6)
    wq, ws = tquant.quantize_weight(_t(w))
    col_sum = wq.to(torch.int32).sum(0).to(torch.float32)
    po = packing.pack_gemm(wq, packing.gemm_layout(
        Ger.I8GER4, 200, 96, side="x", transposed=True), scale=ws,
        col_sum=col_sum)
    with pytest.raises(ValueError, match="refusing to demote"):
        packing.demote_value(po, "test")
    with tfac.configure(CPU):
        with pytest.raises(ValueError, match="refusing to demote"):
            tfac.contract("mk,kn->mn", _t(x), po)      # a model's DOT
        for backend in ("torch", "ref"):
            packing.EVENTS.clear()
            assert torch.equal(tquant.qdot(_t(x), wq, ws, backend=backend),
                               tquant.qdot(_t(x), po, backend=backend))
            assert [e["why"] for e in packing.EVENTS] == [f"{backend}-gemm"]
    assert torch.equal(packing.demote_value(po, "test", dequantized=True),
                       wq)


def test_reference_demotes_a_quantized_operand_to_raw_int8():
    """The reference caveat the port refuses (ROADMAP queue 3): its
    ``demote_value`` hands a quantized operand's raw int8 values on,
    without their scale."""
    _, w = _qdot_inputs()
    jwq, jws = jquant.quantize_weight(jnp.asarray(w))
    jpo = jpack.pack_gemm(jwq, jpack.GemmLayout(
        kind=JGer.I8GER4, block=packing.PANEL_BLOCK, side="x", rows=200,
        cols=96, transposed=True), scale=jws,
        col_sum=jwq.astype(jnp.int32).sum(axis=0).astype(jnp.float32))
    got = jpack.demote_value(jpo, "spec-orientation")
    assert got.dtype == jnp.int8
    np.testing.assert_array_equal(np.asarray(got), np.asarray(jwq))


def test_events_log_is_bounded():
    """EVENTS keeps the last EVENTS_KEPT events while COUNTERS counts all:
    a server that demotes every step does not grow it."""
    w = torch.ones(64, 64)
    lay = packing.gemm_layout(Ger.F32GER, 64, 64)
    n = packing.EVENTS_KEPT + 10
    for _ in range(n):
        packing.pack_gemm(w, lay)
    assert packing.COUNTERS["pack"] == n
    assert len(packing.EVENTS) == packing.EVENTS_KEPT


# ----------------------------------------------------------------------
# prepack_params_for_serving on port models
# ----------------------------------------------------------------------

class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        p = lambda t: torch.nn.Parameter(t, requires_grad=False)  # noqa
        self.tok = p(torch.ones(512, 128))
        self.small = p(torch.ones(4, 4))
        self.ints = p(torch.ones(256, 256, dtype=torch.int32))
        self.big = p(torch.ones(128, 512))
        self.scale = p(torch.ones(4096))


def test_prepack_skips_tok_small_and_nonfloat():
    m = _Toy()
    with tfac.configure(CPU):
        stats = packing.prepack_params_for_serving(m, min_size=1 << 12)
    assert isinstance(m.tok, torch.nn.Parameter)
    assert isinstance(m.small, torch.nn.Parameter)
    assert isinstance(m.ints, torch.nn.Parameter)
    assert isinstance(m.scale, torch.nn.Parameter)
    assert packing.is_packed(m.big) and "big" not in m._parameters
    assert stats == {"dense": 1, "bytes": 128 * 512 * 4,
                     "panel_bytes": 128 * 512 * 4}
    assert {n for n, _ in m.named_parameters()} == {"tok", "small", "ints",
                                                    "scale"}


def test_prepack_quantize_builds_i8ger4_tiles():
    m = _Toy()
    with tfac.configure(CPU):
        stats = packing.prepack_params_for_serving(m, min_size=1 << 12,
                                                   quantize=True)
    po = m.big
    assert po.quantized and po.dtype == torch.int8
    assert po.layout.side == "x" and po.layout.transposed
    assert po.col_sum is not None and po.shape == (128, 512)
    assert stats == {"quantized": 1, "bytes": 128 * 512,
                     "panel_bytes": 128 * 512 + 512 * 4 * 2}
    assert tquant.prepack_params_for_serving is \
        packing.prepack_params_for_serving


def _pair(name):
    jcfg, tcfg = jreduced(jget(name)), treduced(tget(name))
    params = JM.init_params(jcfg, jax.random.key(0))
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    return jcfg, tcfg, params, model


def _expected_port_stats(packed_tree):
    """The reference's packed leaves counted per layer: a stacked leaf's
    leading layer axis (and not an expert bank's E axis) multiplies.  The
    reference's name rule also takes deepseek-moe's stacked shared-expert
    MLP ``moe/shared/w1..w3`` (L, d, f) for an expert bank batched over
    the layer axis (ROADMAP queue 3); the port's shared MLP is one 2-D
    weight a layer, which packs as dense."""
    want = {}
    flat = jax.tree_util.tree_flatten_with_path(
        packed_tree, is_leaf=jpack.is_packed)[0]
    for path, v in flat:
        if not jpack.is_packed(v):
            continue
        lay = v.layout
        lead = v.data.shape[:v.data.ndim - lay.tile_rank]
        if lay.tile == "conv":
            cat = "conv"
        elif lay.side == "x":
            cat = "quantized"
        elif lay.batched and "shared" not in jax.tree_util.keystr(path):
            cat, lead = "moe", lead[:-1]
        else:
            cat = "dense"
        want[cat] = want.get(cat, 0) + int(np.prod(lead, dtype=np.int64))
    return want


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "whisper-small",
                                  "qwen2-vl-7b", "mamba2-130m"])
def test_prepack_stats_match_reference(name):
    jcfg, tcfg, params, model = _pair(name)
    packed, jstats = jpack.prepack_params_for_serving(params, min_size=1024)
    with tfac.configure(CPU):
        stats = packing.prepack_params_for_serving(model, min_size=1024)
    assert stats["bytes"] == jstats["bytes"]
    assert {k: v for k, v in stats.items()
            if k not in ("bytes", "panel_bytes")} == \
        _expected_port_stats(packed)
    if name != "mamba2-130m":
        assert set(jstats) - {"bytes"} >= {"dense"}
    if name == "deepseek-moe-16b":
        # the reference's shared-expert MLP, packed as a bank, demotes at
        # its (unbatched) call; the port's packs as dense and rides packed
        jw = jax.tree.map(lambda a: a[0],
                          packed["layers"]["moe"]["shared"]["w1"])
        assert jw.layout.batched
        x = _rand((3, jcfg.d_model), 20)
        with jfac.configure(jfac.FacilityConfig(use_pallas=True,
                                                interpret=True)):
            jfac.contract(jfac.DOT, jnp.asarray(x), jw)
        assert [e["why"] for e in jpack.EVENTS
                if e["event"] == "demote"] == ["spec-orientation"]
        tw = model.layers[0].moe.shared.w1
        assert packing.is_packed(tw) and not tw.layout.batched
        with tfac.configure(CPU):
            tfac.contract(tfac.DOT, _t(x, torch.bfloat16), tw)
        assert packing.COUNTERS["demote"] == 0


def test_mamba2_conv_w_demotes_at_every_depthwise_call_as_reference():
    """Reduced mamba2's taps conv_w (4, 288) reach min_size 1024, so both
    passes pack them as dense Y panels; a depthwise call then demotes them
    ("conv-layout-mismatch"), once a call, on both sides: the port keeps
    the reference's rule (ROADMAP queue 3)."""
    jcfg, tcfg, params, model = _pair("mamba2-130m")
    packed, _ = jpack.prepack_params_for_serving(params, min_size=1024)
    jtaps = jax.tree.map(lambda a: a[0], packed["layers"]["mamba"]["conv_w"])
    assert jpack.is_packed(jtaps) and jtaps.layout.tile == "gemm"
    xin = _rand((2, 7, 288), 18)
    with jfac.configure(jfac.FacilityConfig(use_pallas=True,
                                            interpret=True)):
        jfac.contract(jfac.CONV1D_DEPTHWISE, jnp.asarray(xin), jtaps)
    assert [e["why"] for e in jpack.EVENTS if e["event"] == "demote"] == [
        "conv-layout-mismatch"]
    tokens = torch.from_numpy(np.random.default_rng(19).integers(
        0, tcfg.vocab_size, (2, 16), dtype=np.int32))
    with tfac.configure(CPU):
        nat, _, _ = TM.forward(model, {"tokens": tokens}, tcfg)
        packing.prepack_params_for_serving(model, min_size=1024)
        assert packing.is_packed(model.layers[0].mamba.conv_w)
        packing.EVENTS.clear()
        pk, _, _ = TM.forward(model, {"tokens": tokens}, tcfg)
    assert torch.equal(nat, pk)
    assert [e["why"] for e in packing.EVENTS] == \
        ["conv-layout-mismatch"] * tcfg.num_layers


def test_vlm_forward_prepacked_bitwise_and_against_reference():
    """Reduced qwen2-vl-7b (the patch stem on K3's packed stream and the
    dense stack): the prepacked forward is the natural one bit for bit,
    with no demote, and within 2^-5 of max|ref| of the reference's
    prepacked forward (its Pallas kernels in interpret mode)."""
    jcfg, tcfg, params, model = _pair("qwen2-vl-7b")
    host = jdata.synthetic_batch(jcfg, batch=2, seq=12, step=0)
    with tfac.configure(CPU):
        nat, _, _ = TM.forward(model, tdata.device_batch(host, "cpu"), tcfg)
        stats = packing.prepack_params_for_serving(model, min_size=1024)
        base = dict(packing.COUNTERS)
        pk, _, _ = TM.forward(model, tdata.device_batch(host, "cpu"), tcfg)
    assert stats["conv"] == 1 and stats["dense"] >= 4
    assert torch.equal(nat, pk)
    assert dict(packing.COUNTERS) == base, packing.EVENTS
    with jfac.configure(jfac.FacilityConfig(use_pallas=True,
                                            interpret=True)):
        jpp, _ = jpack.prepack_params_for_serving(params, min_size=1024)
        want, _, _ = JM.forward(jpp, {k: jnp.asarray(v)
                                      for k, v in host.items()}, jcfg)
    want = np.asarray(want, np.float32)
    err = float(np.abs(pk.float().numpy() - want).max())
    assert err <= 2.0 ** -5 * float(np.abs(want).max())


def test_audio_prefill_and_decode_prepacked_bitwise():
    """Reduced whisper-small: the 1-D conv stem (conv1_w, conv2_w) on the
    packed filter stream, the encoder, and decode steps, bit for bit the
    natural run's, with no demote."""
    _, tcfg, _, model = _pair("whisper-small")
    host = tdata.synthetic_batch(tcfg, batch=2, seq=8, step=0)
    batch = tdata.device_batch(host, "cpu")

    def run():
        last, pre = TM.prefill(model, batch, tcfg)
        return last, pre["kv"][0]

    with tfac.configure(CPU):
        nat = run()
        stats = packing.prepack_params_for_serving(model, min_size=1024)
        base = dict(packing.COUNTERS)
        pk = run()
    assert stats["conv"] == 2
    assert all(torch.equal(a, b) for a, b in zip(nat, pk))
    assert dict(packing.COUNTERS) == base, packing.EVENTS


def _recorded_serve(monkeypatch, cfg, model, **kw):
    """serve_loop's settings, recording every decode tick's tokens and
    logits."""
    seen = []
    make = tsteps.make_serve_step

    def recording(cfg_):
        step = make(cfg_)

        def run(model_, cache, tokens):
            out = step(model_, cache, tokens)
            seen.append((out[0].clone(), out[1].clone()))
            return out
        return run

    monkeypatch.setattr(tsteps, "make_serve_step", recording)
    stats = tserve.serve_loop(cfg, model, **kw)
    monkeypatch.setattr(tsteps, "make_serve_step", make)
    return stats, seen


def test_serve_loop_prepacked_gives_the_natural_tokens(monkeypatch):
    tcfg = treduced(tget("deepseek-7b"))
    settings = dict(batch=2, prompt_len=8, gen_len=4, n_requests=3)
    with tfac.configure(CPU):
        model = TM.init_params(tcfg, seed=0, device="cpu",
                               dtype=torch.bfloat16)
        nat_stats, nat = _recorded_serve(monkeypatch, tcfg, model,
                                         **settings)
        packing.prepack_params_for_serving(model, min_size=1024)
        base = dict(packing.COUNTERS)
        pk_stats, pk = _recorded_serve(monkeypatch, tcfg, model, **settings)
    assert dict(packing.COUNTERS) == base, packing.EVENTS
    assert nat_stats["completed"] == pk_stats["completed"] == 3
    assert len(nat) == len(pk) > 0
    for (ta, la), (tb, lb) in zip(nat, pk):
        assert torch.equal(ta, tb) and torch.equal(la, lb)


def test_serve_cli_prepack(capsys):
    out = tserve.main(["--reduced", "--device", "cpu", "--prepack",
                       "--batch", "2", "--prompt-len", "8", "--gen", "3",
                       "--requests", "2"])
    assert out["completed"] == 2
    assert "prepacked params: {'dense'" in capsys.readouterr().out


# ----------------------------------------------------------------------
# K1d on the WMMA and fp32 tiles, K3's packed filters on its WMMA and fp32
# tiles: the panels reach the wrapper and are read, never demoted
# ----------------------------------------------------------------------

def _spy_wrapper_layouts(monkeypatch):
    """Record (path, y_layout given) of every GEMM the lowering hands the
    wrapper, through the wrapper's one path choice."""
    seen = []
    choose = tiling.choose_gemm_path
    wrapper = tgemm.mma_gemm

    def spy_choose(*a, **kw):
        got = choose(*a, **kw)
        seen.append([got[0]])
        return got

    def spy_wrapper(*a, y_layout=None, **kw):
        out = wrapper(*a, y_layout=y_layout, **kw)
        seen[-1].append(y_layout is not None)
        return out
    monkeypatch.setattr(tiling, "choose_gemm_path", spy_choose)
    monkeypatch.setattr(tgemm, "mma_gemm", spy_wrapper)
    return seen


_WMMA_CASES = {
    # name: (family, (M, K, N), plan keywords); F32GER decode takes the
    # fp32 weight stream, which reads the same panels
    "block-128": (Ger.BF16GER2, (100, 256, 384), dict(block=(128, 128, 32))),
    "block-64": (Ger.BF16GER2, (4, 256, 384), dict(block=(64, 64, 64))),
    "f32ger-decode": (Ger.F32GER, (4, 200, 136), {}),
    "f32ger-prefill": (Ger.F32GER, (130, 96, 200), {}),
    "unaligned": (Ger.BF16GER2, (100, 64, 1001), {}),
    "fringe": (Ger.BF16GER2, (37, 45, 100), dict(block=(128, 128, 32))),
}


@pytest.mark.parametrize("name", list(_WMMA_CASES))
def test_packed_wmma_and_f32_tiles_read_panels_bitwise(name, monkeypatch):
    """An explicit block (both WMMA tiles), F32GER (the fp32 tile at
    M > 64, the fp32 weight stream at decode), an unaligned pitch (N =
    1001 at M > 64) and M/N/K fringes: the packed dispatch takes the
    natural call's path with its panels un-demoted, is the natural one
    bit for bit, and counts no demote (K1d)."""
    kind, (m, k, n), plan_kw = _WMMA_CASES[name]
    dt = torch.float32 if kind == Ger.F32GER else torch.bfloat16
    x = _t(_rand((m, k), 40), dt)
    w = _t(_rand((k, n), 41), dt)
    bias = _t(_rand((n,), 42))
    po = packing.pack_gemm(w, packing.gemm_layout(kind, k, n))
    plan = tfac.Plan(ger=kind, out_dtype=tfac.ACC, **plan_kw)
    seen = _spy_wrapper_layouts(monkeypatch)
    with tfac.configure(CPU):
        nat = tfac.contract("mk,kn->mn", x, w, bias=bias, plan=plan)
        pk = tfac.contract("mk,kn->mn", x, po, bias=bias, plan=plan)
    path = "stream" if name == "f32ger-decode" else "wmma"
    assert seen == [[path, False], [path, True]]
    assert torch.equal(nat, pk)
    assert packing.COUNTERS["demote"] == 0


@pytest.mark.parametrize("kind", [Ger.BF16GER2, Ger.F32GER])
def test_packed_conv_on_wmma_and_f32_tiles_bitwise(kind, monkeypatch):
    """K3's packed (gf, KH, KW, C, 64) stream on the WMMA tile (an explicit
    filter tile of 128: two slabs) and on the fp32 tile (F32GER): the
    wrapper takes the path and reads the stream, no demote, the natural
    bits; 1-D (whisper's stem form) and 2-D."""
    seen = []
    choose = tiling.choose_conv_path

    def spy(*a, **kw):
        got = choose(*a, **kw)
        seen.append(got[0])
        return got
    monkeypatch.setattr(tiling, "choose_conv_path", spy)
    dt = torch.float32 if kind == Ger.F32GER else torch.bfloat16
    path = "f32" if kind == Ger.F32GER else "wmma"
    block = None if kind == Ger.F32GER else (64, 128, 32)
    plan = tfac.Plan(ger=kind, out_dtype=torch.float32, block=block)
    with tfac.configure(CPU):
        for spec, img, w, stride in (
                (tfac.CONV1D, _t(_rand((2, 41, 24), 43), dt),
                 _t(_rand((3, 24, 200), 44), dt) * 0.2, 2),
                (tfac.CONV2D, _t(_rand((1, 12, 12, 3), 45), dt),
                 _t(_rand((4, 4, 3, 72), 46), dt) * 0.2, (4, 4))):
            nd = 1 if spec == tfac.CONV1D else 2
            kh, (kw, c, f) = ((1, w.shape) if nd == 1
                              else (w.shape[0], w.shape[1:]))
            pc = packing.pack_conv(w, packing.conv_layout(kind, kh, kw, c,
                                                          f, nd=nd))
            p = dataclasses.replace(plan, stride=stride)
            nat = tfac.contract(spec, img, w, plan=p)
            pk = tfac.contract(spec, img, pc, plan=p)
            assert torch.equal(nat, pk)
    assert seen == [path] * 4
    assert packing.COUNTERS["demote"] == 0


def test_packed_f32ger_panels_match_reference_interpret_kernel():
    """The reference's interpret-mode K1 on the same packed F32GER panels
    (its (gn, gk, 64, 64) Y panels, the port's bit for bit) gives the
    port's packed result within 1e-5 of max|ref| (fp32 sums in another
    order), with the fused bias + silu epilogue."""
    from repro.kernels import epilogue as jep
    from repro.kernels import mma_gemm as jgemm
    from repro_torch.kernels import epilogue as tep
    m, k, n = 70, 200, 136
    x, w, bias = _rand((m, k), 47), _rand((k, n), 48), _rand((n,), 49)
    po = packing.pack_gemm(_t(w), packing.gemm_layout(Ger.F32GER, k, n))
    jl = jpack.GemmLayout(kind=JGer.F32GER, block=(64, 64, 64), side="y",
                          rows=k, cols=n)
    jpo = jpack.pack_gemm(jnp.asarray(w), jl)
    np.testing.assert_array_equal(po.data.numpy(), np.asarray(jpo.data))
    want = jgemm.mma_gemm(jnp.asarray(x), jpo.data, kind=JGer.F32GER,
                          block=(64, 64, 64), y_layout=jl, interpret=True,
                          ep=jep.Epilogue(bias=True, activation="silu"),
                          bias=jnp.asarray(bias))
    got = tgemm.mma_gemm(_t(x), po.data, kind=Ger.F32GER, y_layout=po.layout,
                         ep=tep.Epilogue(bias=True, activation="silu"),
                         bias=_t(bias))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert packing.COUNTERS["demote"] == 0


def test_f32ger_prepacked_serve_matches_natural(monkeypatch):
    """The tight-parity config (F32GER, f32) served prepacked on the CPU:
    the bf16 weights are widened once to fp32 panels, which every GEMM
    reads on the WMMA fp32 tile's path; every decode tick's tokens and
    logits are the natural serve's, with no demote, pack or repack while
    serving."""
    tcfg = treduced(tget("deepseek-7b"))
    settings = dict(batch=2, prompt_len=8, gen_len=4, n_requests=3)
    f32 = tfac.FacilityConfig(device="cpu", ger=Ger.F32GER,
                              out_dtype=torch.float32)
    with tfac.configure(f32):
        model = TM.init_params(tcfg, seed=0, device="cpu",
                               dtype=torch.bfloat16)
        nat_stats, nat = _recorded_serve(monkeypatch, tcfg, model,
                                         **settings)
        stats = packing.prepack_params_for_serving(model, min_size=1024)
        po = model.layers[0].mlp.w1
        base = dict(packing.COUNTERS)
        pk_stats, pk = _recorded_serve(monkeypatch, tcfg, model, **settings)
    assert packing.is_packed(po) and po.dtype == torch.float32
    # the widened panels hold at least twice the natural bf16 bytes
    assert stats["panel_bytes"] >= 2 * stats["bytes"] > 0
    assert dict(packing.COUNTERS) == base, packing.EVENTS
    assert nat_stats["completed"] == pk_stats["completed"] == 3
    assert len(nat) == len(pk) > 0
    for (ta, la), (tb, lb) in zip(nat, pk):
        assert torch.equal(ta, tb) and torch.equal(la, lb)
