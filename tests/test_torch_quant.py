"""The port's quant path (``repro_torch.core.quant``: int8 weights, uint8
activations, one I8GER4 plan with a Dequant deprime) against the JAX
reference, on the CPU.

Tolerances: the quantizers and the int32 accumulator bit for bit; qdot's
fp32 output within 1e-5 of max|ref| (the Dequant's few fp32 operations may
contract differently under XLA).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import facility as jfac
from repro.core import quant as jquant
from repro.core.precision import Ger as JGer
from repro_torch.core import facility as tfac
from repro_torch.core import packing
from repro_torch.core import quant as tquant
from repro_torch.core.precision import Ger as TGer

BACKENDS = {"kernel": "pallas", "torch": "xla", "ref": "ref"}


def _inputs(m=13, k=96, n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 2.0 + 0.3).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0                       # a zero column: scale 1
    x[2] = 0.7                          # a constant row: scale 1
    return x, w


def test_quantizers_bit_for_bit():
    x, w = _inputs()
    q, s = tquant.quantize_weight(torch.from_numpy(w))
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    xq, xs, xz = tquant.quantize_act_u8(torch.from_numpy(x))
    jxq, jxs, jxz = jquant.quantize_act_u8(jnp.asarray(x))
    for a, b in ((xq, jxq), (xs, jxs), (xz, jxz)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert xq.dtype == torch.uint8


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_qdot_accumulator_bit_for_bit(backend):
    """The int32 accumulator of qdot's plan (spec "kn,mk->mn": signed
    weights on X, unsigned activations on Y) matches the reference's."""
    x, w = _inputs()
    wq, _ = jquant.quantize_weight(jnp.asarray(w))
    xq, _, _ = jquant.quantize_act_u8(jnp.asarray(x))
    want = jfac.contract("kn,mk->mn", wq, xq,
                         plan=jfac.Plan(ger=JGer.I8GER4, out_dtype=jfac.ACC,
                                        backend=BACKENDS[backend]))
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        got = tfac.contract(
            "kn,mk->mn", torch.from_numpy(np.array(wq)),
            torch.from_numpy(np.array(xq)),
            plan=tfac.Plan(ger=TGer.I8GER4, out_dtype=tfac.ACC,
                           backend=backend))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_qdot_matches_reference(backend):
    x, w = _inputs(seed=1)
    jwq, jws = jquant.quantize_weight(jnp.asarray(w))
    want = np.asarray(jquant.qdot(jnp.asarray(x), jwq, jws,
                                  backend=BACKENDS[backend]))
    wq, ws = tquant.quantize_weight(torch.from_numpy(w))
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        got = tquant.qdot(torch.from_numpy(x), wq, ws, backend=backend)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)
    # and it approximates the float product to int8 precision, but for
    # the constant row 2, which the reference's zero point rounds (scale
    # 1, zero point round(-0.7) = -1: the row reads as 1.0)
    keep = np.arange(x.shape[0]) != 2
    np.testing.assert_allclose(got.numpy()[keep], (x @ w)[keep],
                               atol=0.05 * scale)


def test_qdot_out_dtype_and_refusals():
    x, w = _inputs(seed=2)
    wq, ws = tquant.quantize_weight(torch.from_numpy(w))
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        out = tquant.qdot(torch.from_numpy(x), wq, ws,
                          out_dtype=torch.bfloat16)
        assert out.dtype == torch.bfloat16
        with pytest.raises(ValueError, match="explicit wscale"):
            tquant.qdot(torch.from_numpy(x), wq)
        with pytest.raises(TypeError, match="PackedOperand"):
            tquant.qdot(torch.from_numpy(x), packing.STORE, ws)
        dq = tfac.Dequant(row_scale=torch.ones(4, 1),
                          row_zp=torch.zeros(4, 1), col_sum=torch.zeros(4),
                          col_scale=torch.ones(4))
        with pytest.raises(ValueError, match="epilogue are exclusive"):
            tfac.contract("mk,kn->mn", torch.zeros(4, 8, dtype=torch.int8),
                          torch.zeros(8, 4, dtype=torch.uint8), dequant=dq,
                          bias=torch.zeros(4, dtype=torch.int32),
                          plan=tfac.Plan(ger=TGer.I8GER4))
        with pytest.raises(ValueError, match="dequant"):
            tfac.contract("nhwc,hwio->nhwo", torch.zeros(1, 4, 4, 2),
                          torch.zeros(2, 2, 2, 3), dequant=dq)
        with pytest.raises(ValueError, match="masks and dequant"):
            tfac.contract("mk,kn->mn", torch.zeros(4, 8),
                          torch.zeros(8, 4), dequant=dq,
                          masks=(None, None, None))
    with pytest.raises(TypeError, match="nn.Module"):
        tquant.prepack_params_for_serving({})


def test_quantize_params_for_serving():
    rng = np.random.default_rng(4)
    tree = {"big": rng.standard_normal((256, 300)).astype(np.float32),
            "layer": {"w1": rng.standard_normal((300, 256)).astype(
                          np.float32),
                      "norm": rng.standard_normal((300,)).astype(np.float32),
                      "small": rng.standard_normal((16, 16)).astype(
                          np.float32)},
            "emb": rng.standard_normal((256, 300)).astype(np.float16)}
    jtree = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else jnp.asarray(v))
             for k, v in tree.items()}
    ttree = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.from_numpy(v))
             for k, v in tree.items()}
    jq, jsaved = jquant.quantize_params_for_serving(jtree)
    tq, tsaved = tquant.quantize_params_for_serving(ttree)
    assert tsaved == jsaved == 3 * (256 * 300 * 2)
    for name in ("big",):
        assert set(tq[name]) == {"q", "scale"}
        np.testing.assert_array_equal(tq[name]["q"].numpy(),
                                      np.asarray(jq[name]["q"]))
        np.testing.assert_array_equal(tq[name]["scale"].numpy(),
                                      np.asarray(jq[name]["scale"]))
    np.testing.assert_array_equal(tq["layer"]["w1"]["q"].numpy(),
                                  np.asarray(jq["layer"]["w1"]["q"]))
    for leaf in (tq["layer"]["norm"], tq["layer"]["small"], tq["emb"]):
        assert isinstance(leaf, torch.Tensor)
