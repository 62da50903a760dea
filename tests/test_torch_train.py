"""The port's training slice against the JAX reference, on the CPU:
``models.model.loss_fn`` and its gradients, ``optim`` (schedule, AdamW,
compression), ``train.steps.make_train_step``, the ``Checkpointer``, the
``Prefetcher`` and the train launcher.

Weights come from the reference's ``init_params`` through
``models.convert``; batches from the reference's ``synthetic_batch``
(numpy, seeded), which the port's reproduces bit for bit.  The reference
differentiates its xla backend (its Pallas kernels have no gradient); the
port runs its kernel backend (the kernels' plain versions through their
``autograd.Function``s) and its torch backend.

Tolerances:
  * F32 mode (``FacilityConfig(ger=F32GER, out_dtype=float32)``, the
    reference under ``eager_layers()``): the loss within 1e-5 relative;
    each parameter's gradient within 1e-4 relative L2, except the
    embedding table and the first layer's parameters, within 2^-7: the
    reference's F32 mode still embeds in bf16, so the cotangent of that
    bf16 tensor is rounded to bf16 in both frameworks (a sum that lands
    near a bf16 tie rounds either way), and the reference sums the
    embedding gradient of repeated tokens in a bf16 scatter-add where the
    port sums in fp32.  Measured here: at most 4.0e-3 on those leaves and
    1.3e-6 elsewhere.
  * the BF16GER2 default: each gradient within 3e-2 relative L2 of the
    reference's xla default (deepseek-7b), or, for the ssm and hybrid
    kinds, whose bf16 reference cannot run on this CPU (DotThunk), of the
    port's own torch backend.
  * optimizer: AdamW within 2 fp32 ulps per element over 3 steps;
    compression exact; the schedule exact in its warmup and constant
    forms and within 1 fp32 ulp in its cosine branch (XLA's and PyTorch's
    fp32 cosines round differently: neither is correctly rounded).
  * train steps in F32 mode, at the optimizer's default peak rate 3e-4:
    each step's loss within 1e-4 relative.  Adam's first step moves every
    weight by about lr whatever its gradient's size, so an element whose
    gradient differs between the frameworks in sign (a near-zero sum, or
    a bf16 rounding of the first layer's) moves by 2 lr; the loss drift
    grows with the rate: at step 4, 1.8e-3 at lr 1e-2, 1.4e-4 at 1e-3,
    1.2e-5 at 3e-4 (measured here).
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.configs.base import reduced as jreduced
from repro.core import facility as jfac
from repro.core import precision as jprec
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.optim import schedule as JS
from repro.train import steps as JST
from repro_torch.checkpoint import checkpoint as TCK
from repro_torch.configs import get as tget
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import facility as tfac
from repro_torch.core import precision as tprec
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import mamba2 as TM2
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TC
from repro_torch.optim import schedule as TSch
from repro_torch.train import steps as TST

B = 2
SEQ = {"deepseek-7b": 16, "mamba2-130m": 32, "zamba2-1.2b": 32,
       "whisper-small": 32}           # SSM: two SSD chunks of 16
F32_LEAF, F32_FIRST, BF16_LEAF = 1e-4, 2.0 ** -7, 3e-2


@contextlib.contextmanager
def _ref_mode(mode):
    """The reference's facility: F32 under eager_layers (its scan carry
    cannot change dtype), else its default."""
    with contextlib.ExitStack() as stack:
        if mode == "f32":
            stack.enter_context(jfac.configure(jfac.FacilityConfig(
                ger=jprec.Ger.F32GER, out_dtype=jnp.float32)))
            stack.enter_context(JM.eager_layers())
        yield


def _port_mode(mode, backend="kernel"):
    kw = (dict(ger=tprec.Ger.F32GER, out_dtype=torch.float32)
          if mode == "f32" else {})
    return tfac.configure(tfac.FacilityConfig(device="cpu", backend=backend,
                                              **kw))


def _ref_leaf(tree, name: str) -> np.ndarray:
    """The reference pytree's leaf for a port parameter name: the layer
    index of a ``ModuleList`` (``layers.3.attn.wq``) indexes the stacked
    leaf's leading axis."""
    node, idx = tree, None
    for part in name.split("."):
        if part.isdigit():
            idx = int(part)
        else:
            node = node[part]
    return np.asarray(node if idx is None else node[idx], np.float32)


def _first_layer(name: str) -> bool:
    """The embedding and the parameters of the first layer the bf16
    embedding enters (the decoder's, for the encoder-decoder kind)."""
    return name.startswith(("embed.", "layers.0."))


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=sorted(SEQ))
def arch(request):
    name = request.param
    jcfg, tcfg = jreduced(jget(name)), treduced(tget(name))
    params = JM.init_params(jcfg, jax.random.key(0))
    host = jpipe.synthetic_batch(jcfg, batch=B, seq=SEQ[name], step=0)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    with _ref_mode("f32"):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: JM.loss_fn(p, b, jcfg), has_aux=True))(params, jb)
    ref = (float(loss), jax.tree.map(
        lambda g: np.asarray(g.astype(jnp.float32)), grads))
    return name, jcfg, tcfg, params, host, ref


def _port_grads(tcfg, params, host, mode, backend, dtype=None):
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                      tcfg, device="cpu", dtype=dtype)
    state = TST.train_state_from(model, TA.AdamWConfig())
    with _port_mode(mode, backend):
        loss, metrics, grads = TST.loss_and_grads(tcfg, state["params"],
                                                  _t(host))
    return float(loss), metrics, grads


def _rel(got, want) -> float:
    got = got.detach().to(torch.float32).numpy()
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den > 0 else 1.0))


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_f32_loss_and_grads_match_reference(arch, backend):
    name, jcfg, tcfg, params, host, (jloss, jgrads) = arch
    loss, metrics, grads = _port_grads(tcfg, params, host, "f32", backend)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    assert float(metrics["nll"]) == loss and float(metrics["aux"]) == 0.0
    # every reference gradient element has its port gradient
    assert sum(g.numel() for g in grads.values()) == sum(
        a.size for a in jax.tree.leaves(jgrads))
    for k, g in grads.items():
        r = _rel(g, _ref_leaf(jgrads, k))
        assert r <= (F32_FIRST if _first_layer(k) else F32_LEAF), (k, r)


def test_bf16_grads_match_reference_default():
    """deepseek-7b in the default BF16GER2/bf16 policy, bf16 weights at
    rest, against the reference's xla default."""
    jcfg, tcfg = jreduced(jget("deepseek-7b")), treduced(tget("deepseek-7b"))
    params = JM.init_params(jcfg, jax.random.key(1))
    host = jpipe.synthetic_batch(jcfg, batch=B, seq=32, step=1)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jcfg), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in host.items()})
    jgrads = jax.tree.map(lambda g: np.asarray(g.astype(jnp.float32)),
                          jgrads)
    loss, _, grads = _port_grads(tcfg, params, host, "bf16", "kernel",
                                 dtype=torch.bfloat16)
    assert abs(loss - float(jloss)) <= 1e-3 * abs(float(jloss))
    for k, g in grads.items():
        assert g.dtype == (torch.bfloat16 if g.ndim >= 2 else torch.float32)
        assert _rel(g, _ref_leaf(jgrads, k)) <= BF16_LEAF, k


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-1.2b"])
def test_bf16_ssm_kernel_grads_match_torch_backend(name):
    jcfg, tcfg = jreduced(jget(name)), treduced(tget(name))
    params = JM.init_params(jcfg, jax.random.key(1))
    host = jpipe.synthetic_batch(jcfg, batch=B, seq=32, step=1)
    want = _port_grads(tcfg, params, host, "bf16", "torch",
                       dtype=torch.bfloat16)
    got = _port_grads(tcfg, params, host, "bf16", "kernel",
                      dtype=torch.bfloat16)
    assert abs(got[0] - want[0]) <= 1e-3 * abs(want[0])
    for k, g in got[2].items():
        w = want[2][k].to(torch.float32).numpy()
        assert np.isfinite(w).all() and _rel(g, w) <= BF16_LEAF, k


@pytest.mark.parametrize("dt", [1e-3, 1.0, 30.0])
def test_ssd_gradients_are_finite(dt):
    """The SSD's -inf-masked segment sums (exp(-inf) = 0 above the
    diagonal) give no NaN gradient, from small to saturating steps."""
    rng = np.random.default_rng(0)
    b, l, h, p, n = 2, 32, 4, 8, 16

    def leaf(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).requires_grad_(True)

    x, bb, cc = leaf(b, l, h, p), leaf(b, l, n), leaf(b, l, n)
    dts = torch.full((b, l, h), dt, requires_grad=True)
    a = (-torch.linspace(1.0, 16.0, h)).requires_grad_(True)
    d = leaf(h)
    with _port_mode("f32"):
        y, state = TM2.ssd_chunked(x, dts, a, bb, cc, d, 16,
                                   return_state=True)
        grads = torch.autograd.grad((y.sum() + state.sum()),
                                    (x, dts, a, bb, cc, d))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert all(float(g.abs().sum()) > 0 for g in grads)


# ----------------------------------------------------------------------
# Optimizer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("args", [(3e-4, 100, 1000), (1e-3, 5, 20),
                                  (1e-2, 1, 4)])
def test_schedule_matches_reference(args):
    steps = np.arange(0, args[2] + 30, dtype=np.int32)
    want = np.asarray(JS.warmup_cosine(*args)(jnp.asarray(steps)))
    got = TSch.warmup_cosine(*args)(torch.from_numpy(steps)).numpy()
    warm = steps < args[1]
    assert np.array_equal(got[warm], want[warm])
    # the cosine branch: one fp32 ulp of the cosine (|cos| <= 1), scaled
    # by peak * (1 - final_frac) / 2, plus one ulp of the rate
    tol = np.spacing(want) + args[0] * 0.9 * 0.5 * 2.0 ** -23
    assert np.all(np.abs(got - want) <= tol)
    step = torch.tensor(7, dtype=torch.int32)
    assert TSch.constant(3e-4)(step).item() == np.float32(
        JS.constant(3e-4)(jnp.asarray(7)))
    assert TSch.constant(3e-4)(step).dtype == torch.float32


def _opt_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "e": rng.standard_normal((3, 4)).astype(np.float32)}


@pytest.mark.parametrize("clip", [1e3, 0.05])
def test_adamw_matches_reference(clip):
    rng = np.random.default_rng(3)
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    jp = {k: jnp.asarray(v) for k, v in _opt_tree(rng).items()}
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    jstate, tstate = JA.init_state(jp), TA.init_state(tp)
    for _ in range(3):
        g = _opt_tree(rng)
        jp, jstate, jm = JA.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate,
            JA.AdamWConfig(**cfg))
        tp, tstate, tm = TA.apply_updates(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate,
            TA.AdamWConfig(**cfg))
        gn = float(jm["grad_norm"])
        assert abs(float(tm["grad_norm"]) - gn) <= 2 * np.spacing(
            np.float32(gn))
        assert (clip < gn) == (clip == 0.05)       # clipping active or not
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for k in jp:
        want = np.asarray(jp[k])
        assert np.all(np.abs(tp[k].numpy() - want)
                      <= 2 * np.spacing(np.abs(want))), k
    # the moments: the clip scale (an fp32 norm summed in another order)
    # moves g by an ulp, and b1 m + (1 - b1) g cancels for small entries
    for tree_t, tree_j in ((tstate["m"], jstate["m"]),
                           (tstate["v"], jstate["v"])):
        for k in tree_j:
            want = np.asarray(tree_j[k])
            assert np.all(np.abs(tree_t[k].numpy() - want)
                          <= 2 * np.spacing(np.abs(want).max())), k


def test_adamw_schedule_and_bf16_params():
    """A callable lr reads the step on the device; a bf16 parameter is
    updated in fp32 and cast back, as the reference does."""
    rng = np.random.default_rng(4)
    sched = dict(lr=JS.warmup_cosine(1e-2, 1, 4))
    w = rng.standard_normal((4, 4)).astype(np.float32)
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    tp = {"w": torch.from_numpy(w).to(torch.bfloat16)}
    jstate, tstate = JA.init_state(jp), TA.init_state(tp)
    g = rng.standard_normal((4, 4)).astype(np.float32)
    jp, _, jm = JA.apply_updates(jp, {"w": jnp.asarray(g)}, jstate,
                                 JA.AdamWConfig(**sched))
    tp, _, tm = TA.apply_updates(
        tp, {"w": torch.from_numpy(g)}, tstate,
        TA.AdamWConfig(lr=TSch.warmup_cosine(1e-2, 1, 4)))
    assert float(tm["lr"]) == float(jm["lr"])
    assert tp["w"].dtype == torch.bfloat16
    assert np.array_equal(tp["w"].float().numpy(),
                          np.asarray(jp["w"].astype(jnp.float32)))


def test_compression_matches_reference():
    rng = np.random.default_rng(5)
    tree = _opt_tree(rng)
    jr = JC.init_residual({k: jnp.asarray(v) for k, v in tree.items()})
    tr = TC.init_residual({k: torch.from_numpy(v) for k, v in tree.items()})
    for _ in range(3):
        g = {k: v * 1.37 for k, v in _opt_tree(rng).items()}
        jq, jr = JC.compress({k: jnp.asarray(v) for k, v in g.items()}, jr)
        tq, tr = TC.compress({k: torch.from_numpy(v) for k, v in g.items()},
                             tr)
        jd, td = JC.decompress(jq), TC.decompress(tq)
        for k in g:
            assert tq[k].dtype == torch.bfloat16
            assert np.array_equal(td[k].numpy(), np.asarray(jd[k]))
            assert np.array_equal(tr[k].numpy(), np.asarray(jr[k]))


# ----------------------------------------------------------------------
# Train steps
# ----------------------------------------------------------------------

def _train_pair(name, *, steps, **kw):
    """Per-step losses of the reference's and the port's train steps in
    F32 mode, from the same weights on one repeated batch, and the final
    states."""
    jcfg, tcfg = jreduced(jget(name)), treduced(tget(name))
    jopt = JA.AdamWConfig(lr=JS.warmup_cosine(3e-4, 1, steps),
                          weight_decay=0.1)
    topt = TA.AdamWConfig(lr=TSch.warmup_cosine(3e-4, 1, steps),
                          weight_decay=0.1)
    init = {k: kw[k] for k in ("compress", "bf16_params") if k in kw}
    jstate = JST.init_train_state(jcfg, jax.random.key(0), jopt, **init)
    params = JM.init_params(jcfg, jax.random.key(0))
    tstate = TST.train_state_from(
        convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu"), topt, **init)
    host = jpipe.synthetic_batch(jcfg, batch=2 * B, seq=16, step=0)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    jlosses, tlosses = [], []
    with _ref_mode("f32"):
        jstep = jax.jit(JST.make_train_step(jcfg, jopt, **kw))
        for _ in range(steps):
            jstate, jm = jstep(jstate, jb)
            jlosses.append(float(jm["loss"]))
    tstep = TST.make_train_step(tcfg, topt, **kw)
    with _port_mode("f32"):
        for _ in range(steps):
            tstate, tm = tstep(tstate, _t(host))
            tlosses.append(float(tm["loss"]))
    assert set(tm) == {"loss", "nll", "aux", "grad_norm", "lr"}
    return jlosses, tlosses, jstate, tstate


# The bf16 variants' drift from the reference: the reference stacks each
# layer's parameters, so its bf16 view (``ndim >= 2``) also rounds the
# per-layer norm scales, whose stacks are 2-D; the port's are 1-D and stay
# fp32 (ROADMAP queue 3).  Measured here: 1.9e-4 to 4.9e-4 relative over
# steps 2-4.
BF16_VIEW_DRIFT = 1e-3


@pytest.mark.parametrize("variant", [
    dict(), dict(grad_accum=2), dict(compress=True),
    dict(bf16_params=True), dict(bf16_weights=True)],
    ids=["plain", "grad_accum2", "compress", "bf16_params", "bf16_weights"])
def test_train_step_matches_reference(variant):
    jl, tl, jstate, tstate = _train_pair("deepseek-7b", steps=4, **variant)
    assert tl[-1] < tl[0], tl                     # the loss falls
    bf16 = variant.get("bf16_params") or variant.get("bf16_weights")
    tol = BF16_VIEW_DRIFT if bf16 else 1e-4
    for got, want in zip(tl, jl):
        assert abs(got - want) <= tol * abs(want), (tl, jl)
    if variant.get("bf16_params"):
        master = tstate["opt"]["master"]
        for k, p in tstate["params"].named_parameters():
            # the compute weights are the master's, rounded once
            want = (master[k].to(torch.bfloat16) if p.ndim >= 2
                    else master[k])
            assert p.dtype == want.dtype and torch.equal(p, want), k


def test_bf16_weights_grads_are_the_bf16_models():
    """The bf16 view's gradients are those of a model stored in bf16, cast
    to fp32 (the cast's gradient), and fp32 for the 1-D parameters."""
    jcfg, tcfg = jreduced(jget("deepseek-7b")), treduced(tget("deepseek-7b"))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.key(0)))
    host = _t(jpipe.synthetic_batch(jcfg, batch=B, seq=16, step=0))
    opt = TA.AdamWConfig()
    fp32 = TST.train_state_from(
        convert.params_from_numpy(tree, tcfg, device="cpu"), opt)
    bf16 = TST.train_state_from(convert.params_from_numpy(
        tree, tcfg, device="cpu", dtype=torch.bfloat16), opt)
    with _port_mode("f32"):
        lv, _, gv = TST.loss_and_grads(tcfg, fp32["params"], host,
                                       bf16_weights=True)
        lb, _, gb = TST.loss_and_grads(tcfg, bf16["params"], host)
    assert float(lv) == float(lb)
    for k, g in gv.items():
        assert g.dtype == torch.float32
        assert torch.equal(g, gb[k].to(torch.float32)), k


def test_grad_accum_matches_one_batch():
    """Two microbatches of 2 give the full batch of 4's gradient (the
    mean of the microbatch means; every row has the same mask count)."""
    tcfg = treduced(tget("deepseek-7b"))
    host = tpipe.synthetic_batch(tcfg, batch=4, seq=16, step=0)
    states = []
    for accum in (1, 2):
        model = convert.params_from_numpy(
            jax.tree.map(np.asarray, JM.init_params(
                jreduced(jget("deepseek-7b")), jax.random.key(0))),
            tcfg, device="cpu")
        opt = TA.AdamWConfig(lr=1e-2, weight_decay=0.0, grad_clip=1e9)
        state = TST.train_state_from(model, opt)
        with _port_mode("f32"):
            state, m = TST.make_train_step(tcfg, opt, grad_accum=accum)(
                state, _t(host))
        states.append((state, m))
    (s1, m1), (s2, m2) = states
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-6 * float(
        m1["loss"])
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) <= 1e-5 * \
        float(m1["grad_norm"])
    for k, p in s1["opt"]["m"].items():
        q = s2["opt"]["m"][k]
        assert float((p - q).norm()) <= 1e-5 * float(p.norm()) + 1e-12, k


@pytest.mark.parametrize("name", ["deepseek-7b", "qwen2-vl-7b"])
def test_split_microbatches_matches_reference_reshape(name):
    cfg = jreduced(jget(name))
    host = jpipe.synthetic_batch(cfg, batch=4, seq=12, step=0)
    n = 2
    # the reference's split; its positions on their batch axis (the
    # reference first applies the leading-axis split to every array, which
    # for the (3, B, S) positions raises before this overwrites it)
    want = {k: v.reshape(n, 4 // n, *v.shape[1:]) for k, v in host.items()
            if k != "positions"}
    if "positions" in host:
        want["positions"] = host["positions"].reshape(
            3, n, -1, host["positions"].shape[-1]).transpose(1, 0, 2, 3)
    got = TST.split_microbatches(_t(host), n)
    assert len(got) == n
    for i, mb in enumerate(got):
        assert set(mb) == set(host)
        for k in host:
            assert np.array_equal(mb[k].numpy(), want[k][i]), k
    with pytest.raises(ValueError, match="microbatches"):
        TST.split_microbatches(_t(host), 3)


def test_serve_loop_builds_no_graph_for_a_trained_model():
    """A model whose parameters require gradients is served under
    inference mode: the loop runs and the parameters keep no grad."""
    cfg = treduced(tget("deepseek-7b"))
    from repro_torch.models import model as TM
    model = TM.init_params(cfg, seed=0, device="cpu")
    state = TST.train_state_from(model, TA.AdamWConfig())
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        stats = tserve.serve_loop(cfg, state["params"], batch=2,
                                  prompt_len=8, gen_len=2, n_requests=2)
    assert stats["completed"] == 2
    assert all(p.requires_grad and p.grad is None
               for p in state["params"].parameters())


# ----------------------------------------------------------------------
# Checkpointer, Prefetcher, launcher
# ----------------------------------------------------------------------

def _ckpt_state(seed):
    """A train-state-shaped tree: a module, an int32 step, an fp32 moment
    and a bf16 leaf in a list."""
    g = torch.Generator().manual_seed(seed)
    model = torch.nn.Linear(4, 3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return {"params": model,
            "opt": {"step": torch.tensor(seed, dtype=torch.int32),
                    "m": {"a": torch.randn((3, 4), generator=g)},
                    "master": [torch.randn((5,), generator=g).to(
                        torch.bfloat16)]}}


def _equal_trees(a, b):
    fa, fb = TCK._flatten(a), TCK._flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def test_checkpoint_round_trip_and_gc(tmp_path):
    ck = TCK.Checkpointer(str(tmp_path), keep=3)
    assert ck.latest_step() is None
    for step in range(1, 6):
        (ck.save if step % 2 else ck.save_async)(step, _ckpt_state(step))
    ck.wait()
    assert ck.latest_step() == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_3", "step_4", "step_5"]
    like = _ckpt_state(99)
    got = ck.restore(4, like)
    assert got is like
    _equal_trees(got, _ckpt_state(4))
    # the on-disk protocol: npz entries by index, bf16 as a uint16 view
    manifest = json.loads((tmp_path / "step_4" / "manifest.json").read_text())
    i = manifest["dtypes"].index("bfloat16")
    assert manifest["paths"][i] == "['opt']['master'][0]"
    with np.load(tmp_path / "step_4" / "arrays.npz") as z:
        assert z[str(i)].dtype == np.uint16
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(4, {"x": torch.zeros(1)})


def test_killed_async_save_leaves_latest_step(tmp_path, monkeypatch):
    ck = TCK.Checkpointer(str(tmp_path))
    ck.save(1, _ckpt_state(1))
    calls = []
    real = np.lib.format.write_array

    def dies(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("killed mid-write")
        return real(*a, **kw)

    monkeypatch.setattr(np.lib.format, "write_array", dies)
    ck.save_async(2, _ckpt_state(2))
    with pytest.raises(OSError, match="killed"):
        ck.wait()
    assert ck.latest_step() == 1
    assert (tmp_path / "step_2.tmp").is_dir()
    monkeypatch.undo()
    like = _ckpt_state(7)
    _equal_trees(ck.restore(1, like), _ckpt_state(1))


def test_async_save_snapshots_host_tensors(tmp_path):
    """``save_async`` copies leaves that already lie on the host: the tree
    updated in place before ``wait()`` (as the next train step updates the
    parameters and moments) leaves the checkpoint with the values at the
    call, bit for bit."""
    ck = TCK.Checkpointer(str(tmp_path))
    state = _ckpt_state(3)
    ck.save_async(3, state)
    with torch.no_grad():
        for _, leaf in TCK._flatten(state):
            leaf.add_(1)
    ck.wait()
    _equal_trees(ck.restore(3, _ckpt_state(99)), _ckpt_state(3))


def test_prefetcher_order_and_errors():
    cfg = treduced(tget("deepseek-7b"))
    pf = tpipe.Prefetcher(cfg, batch=2, seq=8, start_step=3, seed=1,
                          device="cpu")
    try:
        for want in (3, 4, 5):
            step, b = next(pf)
            host = tpipe.synthetic_batch(cfg, batch=2, seq=8, step=want,
                                         seed=1)
            assert step == want
            assert all(np.array_equal(b[k].numpy(), host[k]) for k in host)
    finally:
        pf.close()
    assert not pf._t.is_alive()
    bad = tpipe.Prefetcher(cfg, batch=-1, seq=8, device="cpu")
    try:
        with pytest.raises(ValueError):
            next(bad)
        with pytest.raises(ValueError):
            next(bad)
    finally:
        bad.close()


def test_train_launcher_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "64",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"],
        capture_output=True, text=True, timeout=300, check=True)
    line = out.stdout.strip().splitlines()[-1]
    fields = dict(f.split("=") for f in line.split())
    assert fields["steps"] == "4"
    assert float(fields["last_loss"]) < float(fields["first_loss"])
    assert fields["restarts"] == "0"
    assert TCK.Checkpointer(str(tmp_path)).latest_step() == 4


def test_train_launcher_resumes_from_its_checkpoint_dir(tmp_path):
    """The launcher runs under ``ElasticTrainer``: a second process on the
    same ``--ckpt-dir`` starts at that directory's latest step."""
    def run(steps):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
             "--device", "cpu", "--steps", str(steps), "--batch", "2",
             "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every",
             "2"], capture_output=True, text=True, timeout=300, check=True)
        line = out.stdout.strip().splitlines()[-1]
        return dict(f.split("=") for f in line.split())

    ck = TCK.Checkpointer(str(tmp_path))
    first = run(2)
    assert (first["steps"], first["restarts"]) == ("2", "0")
    assert ck.latest_step() == 2
    second = run(4)
    # steps 2 and 3 only: resumed from step 2, not from 0
    assert (second["steps"], second["restarts"]) == ("2", "0")
    assert ck.latest_step() == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_4"]


def test_train_defaults_run_on_the_card_or_raise():
    from repro_torch.launch import train as TT
    cfg = treduced(tget("deepseek-7b"))
    assert TT.build(cfg, device="cpu")
    if torch.cuda.is_available():
        assert TT.build(cfg)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TT.build(cfg)
