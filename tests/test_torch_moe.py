"""The port's Mixture-of-Experts (repro_torch.models.moe and the moe kind of
repro_torch.models.model) against the JAX reference on reduced
mixtral-8x22b and deepseek-moe-16b (8 experts top-2; deepseek-moe with a
shared expert and a leading dense layer), on the CPU.

Weights come from the reference's ``init_params`` (its MoE layers from
``moe.init_moe(key 0)``, as the reference's own MoE tests draw them),
carried over through ``models.convert``.

The reference has two dispatch forms.  Its gather form
(``GATHER_DISPATCH = True``) keeps the stated contract, "same routing,
same drops"; its default scatter form writes every dropped pair's zeros
to slot 0 and so zeroes the token in expert 0's first slot whenever a
choice drops (ROADMAP queue 3).  The port gives the gather form's
results: the layer is held to both forms where nothing drops and to the
gather form where a choice drops, and the scatter form's overwrite is
pinned; every model-level comparison sets ``GATHER_DISPATCH = True`` and
restores it.

Tolerances:
  * F32 mode (``FacilityConfig(ger=F32GER, out_dtype=float32)``): the
    layer within 1e-4 relative L2, its aux loss within 1e-6, top-k
    indices and the keep mask identical (measured: 2e-7 and 2e-9);
    ``forward``, ``prefill`` and ``decode_step`` logits within 1e-4 of
    max|ref| (the reference under ``eager_layers()``); ``loss_fn`` and
    its gradients as tests/test_torch_train.py holds them (``F32_LEAF``,
    and ``F32_FIRST`` for the embedding and the first layer the bf16
    embedding enters);
  * the BF16GER2 default: the layer within 2e-2 (rtol and atol) of the
    gather form, the reference test's own tolerance.
"""

from __future__ import annotations

import contextlib
import copy
import functools

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
from repro.models import moe as JMOE
from repro_torch.configs import get as tget
from repro_torch.configs.base import reduced as treduced
from repro_torch.core import facility as tfac
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.optim import adamw as TA
from repro_torch.train import steps as TST
from test_torch_model import _close, _reference_mode
from test_torch_train import (F32_FIRST, F32_LEAF, _port_mode, _ref_leaf,
                              _ref_mode, _rel)

ARCHS = ("mixtral-8x22b", "deepseek-moe-16b")
F32 = dict(ger=jprec.Ger.F32GER, out_dtype=jnp.float32)


@contextlib.contextmanager
def _dispatch(gather: bool):
    """The reference's dispatch form for the block, restored after."""
    try:
        JMOE.GATHER_DISPATCH = gather
        yield
    finally:
        JMOE.GATHER_DISPATCH = False


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(reference config, port config, the reference's parameters with
    every MoE layer's subtree drawn by ``init_moe(key 0)``, the port's
    model carried over from them)."""
    jcfg, tcfg = jreduced(jget(name)), treduced(tget(name))
    params = jax.jit(JM.init_params, static_argnums=0)(
        jcfg, jax.random.key(0))
    n = jcfg.num_layers - jcfg.first_dense_layers
    moe = jax.jit(JMOE.init_moe, static_argnums=1)(jax.random.key(0), jcfg)
    params["layers"]["moe"] = jax.tree.map(lambda a: jnp.stack([a] * n),
                                           moe)
    model = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                      device="cpu")
    return jcfg, tcfg, params, model


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return (request.param, *_setup(request.param))


def _x(jcfg, shape, dtype=jnp.float32):
    return jax.random.normal(jax.random.key(1), shape + (jcfg.d_model,),
                             dtype)


def _ref_layer(params, x, jcfg, gather, **fac):
    p = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    with jfac.configure(jfac.FacilityConfig(**fac)), _dispatch(gather):
        out, aux = JMOE.apply_moe(p, x, jcfg)
    return np.asarray(out.astype(jnp.float32)), float(aux)


def _ref_routing(params, x, jcfg):
    """The reference's top-k ids and FIFO keep mask (its gather form's
    cumsum positions), F32 mode."""
    p = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    xf = x.reshape(-1, jcfg.d_model)
    with jfac.configure(jfac.FacilityConfig(**F32)):
        logits = jfac.contract(jfac.DOT, xf, p["router"],
                               plan=jfac.Plan(out_dtype=jnp.float32))
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.top_k)
    ef = np.asarray(topi).reshape(-1)
    oh = np.eye(jcfg.num_experts, dtype=np.int64)[ef]
    pos = (np.cumsum(oh, axis=0) - 1)[np.arange(ef.size), ef]
    cap = int(max(1, -(-xf.shape[0] * jcfg.top_k * jcfg.capacity_factor
                       // jcfg.num_experts)))
    return np.asarray(topi), pos < cap


def _port_layer(model, x, tcfg, **fac):
    with tfac.configure(tfac.FacilityConfig(device="cpu", **fac)):
        out, aux = TMOE.apply_moe(model.layers[0].moe,
                                  torch.from_numpy(np.array(x)), tcfg)
    return out, float(aux)


def _port_routing(model, x, tcfg):
    xf = torch.from_numpy(np.array(x)).reshape(-1, tcfg.d_model)
    with tfac.configure(tfac.FacilityConfig(device="cpu", **_T_F32)):
        _, _, topi = TMOE.route(model.layers[0].moe, xf, tcfg)
    keep, _ = TMOE.slots(topi, tcfg.num_experts,
                         TMOE.capacity(xf.shape[0], tcfg))
    return topi.numpy(), keep.numpy()


_T_F32 = dict(ger=tfac.Ger.F32GER, out_dtype=torch.float32)


def _l2(got, want) -> float:
    got = np.asarray(got, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_layer_matches_both_reference_forms_without_drops(arch):
    """x (2, 64): nothing drops, and the two reference forms agree."""
    name, jcfg, tcfg, params, model = arch
    x = _x(jcfg, (2, 64))
    got, aux = _port_layer(model, x, tcfg, **_T_F32)
    for gather in (False, True):
        want, jaux = _ref_layer(params, x, jcfg, gather, **F32)
        assert _l2(got.numpy(), want) <= 1e-4, (name, gather)
        assert abs(aux - jaux) <= 1e-6
    topi, keep = _port_routing(model, x, tcfg)
    jtopi, jkeep = _ref_routing(params, x, jcfg)
    assert np.array_equal(topi, jtopi)
    assert np.array_equal(keep, jkeep) and keep.all()


def test_layer_drop_case_and_the_reference_slot0_overwrite(arch):
    """x (4, 64) from key 1: one choice drops.  The port matches the
    reference's gather form; its scatter form differs from the port in one
    row only, that of the token in expert 0's slot 0, whose expert-0
    output the dropped pair's zeros overwrote."""
    name, jcfg, tcfg, params, model = arch
    x = _x(jcfg, (4, 64))
    got, aux = _port_layer(model, x, tcfg, **_T_F32)
    got = got.numpy().reshape(-1, jcfg.d_model)
    gather, jaux = _ref_layer(params, x, jcfg, True, **F32)
    assert _l2(got, gather.reshape(got.shape)) <= 1e-4
    assert abs(aux - jaux) <= 1e-6
    topi, keep = _port_routing(model, x, tcfg)
    jtopi, jkeep = _ref_routing(params, x, jcfg)
    assert np.array_equal(topi, jtopi) and np.array_equal(keep, jkeep)
    assert (~keep).sum() == 1
    slot0 = int(np.flatnonzero(topi.reshape(-1) == 0)[0]) // jcfg.top_k
    scatter, _ = _ref_layer(params, x, jcfg, False, **F32)
    rows = np.abs(got - scatter.reshape(got.shape)).max(1)
    scale = float(np.abs(gather).max())
    others = np.delete(rows, slot0)
    assert others.max() <= 1e-4 * scale, (name, others.max())
    assert rows[slot0] > 0.1 * scale, (name, slot0, rows[slot0])


def test_layer_bf16_default_matches_gather_form(arch):
    name, jcfg, tcfg, params, model = arch
    for shape in ((2, 64), (4, 64)):
        x = _x(jcfg, shape, jnp.bfloat16)
        got, aux = _port_layer(model, x.astype(jnp.float32), tcfg)
        want, jaux = _ref_layer(params, x, jcfg, True)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2)
        assert abs(aux - jaux) <= 1e-6


def test_layer_gives_the_same_bits_twice(arch):
    _, jcfg, tcfg, _, model = arch
    x = _x(jcfg, (4, 64))
    a, aux_a = _port_layer(model, x, tcfg)
    b, aux_b = _port_layer(model, x, tcfg)
    assert torch.equal(a, b) and aux_a == aux_b


def test_layer_gradients_are_deterministic(arch):
    """Two backward passes of the layer give the same bits for x and
    every parameter: no gradient is summed with atomics."""
    _, jcfg, tcfg, _, model = arch
    moe = copy.deepcopy(model.layers[0].moe)
    x = torch.from_numpy(np.array(_x(jcfg, (4, 64)))).requires_grad_(True)
    for p in moe.parameters():
        p.requires_grad_(True)
    leaves = [x] + list(moe.parameters())
    grads = []
    for _ in range(2):
        with tfac.configure(tfac.FacilityConfig(device="cpu")):
            out, aux = TMOE.apply_moe(moe, x, tcfg)
            loss = out.float().square().mean() + aux
            grads.append(torch.autograd.grad(loss, leaves))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert all(float(g.abs().sum()) > 0 for g in grads[0])


def test_capacity_matches_the_reference_formula():
    cfg = tget("deepseek-moe-16b")
    # decode at batch 4, a 256-token prefill, training at 4 x 512
    assert [TMOE.capacity(t, cfg) for t in (4, 256, 2048)] == [1, 30, 240]
    e = cfg.num_experts
    topi = torch.tensor([[0, 1], [0, 2], [0, 1], [3, 0]])
    keep, dest = TMOE.slots(topi, e, 2)
    assert keep.tolist() == [True, True, True, True, False, True, True,
                             False]
    assert dest.tolist() == [0, 2, 1, 4, e * 2, 3, 6, e * 2]


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_forward_matches_reference(arch, mode):
    name, jcfg, tcfg, params, model = arch
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    with _reference_mode(mode), _dispatch(True):
        jlogits, jaux, _ = JM.forward(params, {"tokens": jnp.asarray(
            tokens)}, jcfg)
    kw = _T_F32 if mode == "f32" else {}
    with tfac.configure(tfac.FacilityConfig(device="cpu", **kw)):
        logits, aux, _ = TM.forward(model, {"tokens": torch.from_numpy(
            tokens)}, tcfg)
    _close(logits.numpy(), jlogits, 1e-4 if mode == "f32" else 2.0 ** -8,
           f"{name} forward logits")
    assert float(aux) > 0 and abs(float(aux) - float(jaux)) <= 1e-6


def _handoff(init_cache, pre, batch, seq_len, to_np, **kw):
    """The decode cache after a P-token prefill: prefill's k/v in ring
    slots [0, P), pos[:P] = arange(P), cur = P (main stack and the leading
    dense layers)."""
    cache = {k: to_np(v) if k != "cur" else v
             for k, v in init_cache(batch, seq_len, **kw).items()}
    p = None
    for key, ring in (("kv", ("k", "v")), ("first_dense_kv",
                                           ("fd_k", "fd_v"))):
        if key not in pre:
            continue
        for i, name in enumerate(ring):
            src = to_np(pre[key][i])
            p = src.shape[2]
            cache[name][:, :, :p] = src
    cache["pos"][:p] = np.arange(p)
    cache["cur"] = p
    return cache


@pytest.mark.parametrize("name,prompt,seq_len", [
    ("deepseek-moe-16b", 12, 16),    # the leading dense layer's fd_k/fd_v
    ("mixtral-8x22b", 62, 80)])      # the 64-slot window's ring wraps
def test_prefill_then_decode_match_reference(name, prompt, seq_len):
    """``prefill``, the cache handoff and 4 teacher-forced decode steps in
    F32 mode; decode at batch 2 has one slot an expert, so choices drop
    (the reference in its gather form)."""
    jcfg, tcfg, params, model = _setup(name)
    b, steps = 2, 4
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (b, prompt + steps), dtype=np.int32)

    def f32(a):
        return np.array(a, dtype=np.float32)

    jsteps, tsteps = [], []
    with _reference_mode("f32"), _dispatch(True):
        jlast, jpre = JM.prefill(params, {"tokens": jnp.asarray(
            tokens[:, :prompt])}, jcfg)
        cache = _handoff(lambda bb, s: JM.init_cache(jcfg, bb, s,
                                                     dtype=jnp.float32),
                         jpre, b, seq_len, f32)
        jcache = {k: (jnp.asarray(v) if k != "cur" else jnp.asarray(
            v, jnp.int32)) for k, v in cache.items()}
        jcache["pos"] = jcache["pos"].astype(jnp.int32)
        for t in range(steps):
            lg, jcache = JM.decode_step(
                params, jcache, jnp.asarray(tokens[:, prompt + t:prompt + t
                                                   + 1]), jcfg)
            jsteps.append(np.asarray(lg, np.float32))
    with tfac.configure(tfac.FacilityConfig(device="cpu", **_T_F32)):
        tlast, tpre = TM.prefill(model, {"tokens": torch.from_numpy(
            tokens[:, :prompt])}, tcfg)
        assert ("first_dense_kv" in tpre) == bool(tcfg.first_dense_layers)
        cache = _handoff(lambda bb, s: TM.init_cache(
            tcfg, bb, s, device="cpu", dtype=torch.float32), tpre, b,
            seq_len, lambda v: v.numpy() if torch.is_tensor(v) else v)
        tcache = {k: (torch.from_numpy(v) if k != "cur" else v)
                  for k, v in cache.items()}
        for t in range(steps):
            lg, tcache = TM.decode_step(model, tcache, torch.from_numpy(
                tokens[:, prompt + t:prompt + t + 1]), tcfg)
            tsteps.append(lg.numpy())
    _close(tlast.numpy(), jlast, 1e-4, f"{name} prefill logits")
    for t in range(steps):
        _close(tsteps[t], jsteps[t], 1e-4, f"{name} decode step {t}")
    for k in ("k", "v", "fd_k", "fd_v"):
        if k in jcache:
            _close(tcache[k].numpy(), np.asarray(jcache[k], np.float32),
                   1e-4, f"{name} {k} cache")
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_f32_loss_and_grads_match_reference(arch):
    name, jcfg, tcfg, params, model = arch
    host = jpipe.synthetic_batch(jcfg, batch=2, seq=16, step=0)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    with _ref_mode("f32"), _dispatch(True):
        (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
            lambda p, bb: JM.loss_fn(p, bb, jcfg), has_aux=True))(params, jb)
    jgrads = jax.tree.map(lambda g: np.asarray(g.astype(jnp.float32)),
                          jgrads)
    # a model of its own: the train state makes its parameters trainable
    state = TST.train_state_from(convert.params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, device="cpu"),
        TA.AdamWConfig())
    with _port_mode("f32"):
        loss, metrics, grads = TST.loss_and_grads(
            tcfg, state["params"], {k: torch.from_numpy(np.asarray(v))
                                    for k, v in host.items()})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(metrics["aux"]) - float(jmet["aux"])) <= 1e-6
    assert float(metrics["aux"]) > 0
    assert sum(g.numel() for g in grads.values()) == sum(
        a.size for a in jax.tree.leaves(jgrads))
    first = "first_dense.0." if tcfg.first_dense_layers else "layers.0."
    for k, g in grads.items():
        tol = F32_FIRST if k.startswith(("embed.", first)) else F32_LEAF
        assert _rel(g, _ref_leaf(jgrads, k)) <= tol, (k, _rel(
            g, _ref_leaf(jgrads, k)))
    # the banks are 3-D and decay like every >= 2-D weight
    bank = state["params"].layers[0].moe.w1
    assert bank.ndim == 3 and bank.requires_grad


def test_serve_loop_on_the_cpu_ends_quiescent():
    cfg = treduced(tget("deepseek-moe-16b"))
    model = TM.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    assert len(model.first_dense) == 1 and isinstance(
        model.layers[0], TM.MoEBlock)
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        stats = tserve.serve_loop(cfg, model, batch=2, prompt_len=8,
                                  gen_len=4, n_requests=3)
    assert stats["completed"] == 3 and stats["rejected"] == 0
    pages = stats["pages"]
    assert pages["free_pages"] == pages["total_pages"]
    assert pages["allocs"] == pages["frees"] == 3
