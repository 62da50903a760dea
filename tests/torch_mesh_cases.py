"""The cases ``tests/torch_mesh_world.py`` runs on each rank of its 2 x 2
gloo world: ``SUITES[name]`` is a list of (case, fn(ctx) -> (ok, detail)).

"sharding" replays the reference's ``tests/test_sharding.py`` on the port:
each contraction unsharded and under the mesh rules, bit for bit.  The
plain versions the wrappers run on the CPU are row-independent (a row of
the output is summed in the same order whatever rows the call holds), so
no case needs a tolerance.  "parallel" holds the expert exchange, the
sharded train step, checkpoint restore onto shardings, the elastic trainer
and the launcher on the mesh.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from torch_mesh_world import check


def _contract():
    from repro_torch.core import facility
    return facility


# ----------------------------------------------------------------------
# sharding
# ----------------------------------------------------------------------

def gemm2d(ctx):
    f = _contract()
    x, y = ctx.arr("gemm2d:x", 64, 48), ctx.arr("gemm2d:y", 48, 96)
    return check(ctx, "gemm2d", lambda: f.contract("mk,kn->mn", x, y))


def bgemm(ctx):
    f = _contract()
    x, y = ctx.arr("bgemm:x", 4, 32, 48), ctx.arr("bgemm:y", 4, 48, 64)
    return check(ctx, "bgemm", lambda: f.contract("bmk,bkn->bmn", x, y))


def gemm_fused(ctx):
    f = _contract()
    x, y = ctx.arr("gemm_fused:x", 64, 48), ctx.arr("gemm_fused:y", 48, 96)
    bias, res = ctx.arr("gemm_fused:bias", 96), ctx.arr("gemm_fused:res",
                                                          64, 96)
    return check(ctx, "gemm_fused", lambda: f.contract(
        "mk,kn->mn", x, y, bias=bias, residual=res))


def gemm_wide(ctx):
    """A prefill-shaped product, 256 rows: on the wgmma tile's plan (the
    CPU runs its plain version), pinned for the 128-row shards."""
    f = _contract()
    x, y = ctx.arr("gemm_wide:x", 256, 128), ctx.arr("gemm_wide:y", 128, 256)
    return check(ctx, "gemm_wide", lambda: f.contract("mk,kn->mn", x, y))


def einsum(ctx):
    # a general einsum (a sum-reduced free label) has no kernel: it runs
    # the torch lowering on the global value, no per-shard dispatch
    f = _contract()
    x, y = ctx.arr("einsum:x", 8, 16), ctx.arr("einsum:y", 16, 8)
    return check(ctx, "einsum", lambda: f.contract("ab,bc->c", x, y),
                 want_collective=False)


def gemm_indivisible(ctx):
    f = _contract()
    x, y = ctx.arr("gemm_indivisible:x", 7, 48), \
        ctx.arr("gemm_indivisible:y", 48, 13)
    return check(ctx, "gemm_indivisible",
                 lambda: f.contract("mk,kn->mn", x, y),
                 want_collective=False)


def gemm_packed_y(ctx):
    from repro_torch.core import packing
    f = _contract()
    x, y = ctx.arr("gemm_packed_y:x", 64, 48), \
        ctx.arr("gemm_packed_y:y", 48, 96)
    lay = packing.GemmLayout(kind=f.Ger.BF16GER2, block=(32, 32, 16),
                             side="y", rows=48, cols=96, transposed=False)
    yp = packing.pack_gemm(y, lay)
    # packed y: N sharding is vetoed (its panels are not sliced), M shards
    # over data, the panels go whole to every shard
    return check(ctx, "gemm_packed_y",
                 lambda: f.contract("mk,kn->mn", x, yp))


def conv1d(ctx):
    f = _contract()
    img, filt = ctx.arr("conv1d:x", 8, 40, 6), ctx.arr("conv1d:y", 5, 6, 12)
    return check(ctx, "conv1d", lambda: f.contract(f.CONV1D, img, filt))


def conv_stem(ctx):
    """whisper's conv2 in small: k3 s2 SAME with bias + gelu fused."""
    f = _contract()
    img, filt = ctx.arr("conv_stem:x", 4, 31, 16), \
        ctx.arr("conv_stem:y", 3, 16, 16)
    bias = ctx.arr("conv_stem:bias", 16)
    plan = f.Plan(stride=2, padding="same",
                  epilogue=f.Epilogue(bias=True, activation="gelu"))
    return check(ctx, "conv_stem", lambda: f.contract(
        f.CONV1D, img, filt, bias=bias, plan=plan))


def depthwise(ctx):
    """mamba2's causal depthwise conv (K4), the image batch over data."""
    f = _contract()
    img, taps = ctx.arr("depthwise:x", 4, 33, 64), \
        ctx.arr("depthwise:y", 4, 64)
    return check(ctx, "depthwise", lambda: f.contract(
        f.CONV1D_DEPTHWISE, img, taps, plan=f.Plan(padding="causal")))


def attn(ctx):
    f = _contract()
    q, k, v = (ctx.arr(f"attn:{n}", 4, 64, 8, 16) for n in "qkv")
    return check(ctx, "attn", lambda: f.contract(f.ATTN, q, k, v))


def attn_causal(ctx):
    f = _contract()
    q, k, v = (ctx.arr(f"attn_causal:{n}", 4, 64, 8, 16) for n in "qkv")
    return check(ctx, "attn_causal", lambda: f.contract(
        f.ATTN, q, k, v, plan=f.Plan(causal=True)))


def attn_gqa_seqshard(ctx):
    # GQA 6 heads / 2 kv heads: both divide over the 2-way model axis, so
    # each shard keeps the group ratio (3 heads, 1 kv head)
    f = _contract()
    q = ctx.arr("attn_gqa:q", 2, 64, 6, 16)
    k, v = ctx.arr("attn_gqa:k", 2, 64, 2, 16), ctx.arr("attn_gqa:v", 2, 64,
                                                         2, 16)
    return check(ctx, "attn_gqa", lambda: f.contract(
        f.ATTN, q, k, v, plan=f.Plan(causal=True)))


def attn_seq_parallel(ctx):
    # GQA 6 heads / 3 kv heads: 3 does not divide over the 2-way model
    # axis, so Sq goes sequence-parallel; each rank's causal q_offset is
    # its index along the axis times its 32 rows (the reference's
    # test_sharding.py gqa_seqshard case on this mesh)
    f = _contract()
    q = ctx.arr("attn_seq:q", 2, 64, 6, 16)
    k, v = ctx.arr("attn_seq:k", 2, 64, 3, 16), ctx.arr("attn_seq:v", 2, 64,
                                                         3, 16)
    return check(ctx, "attn_seq", lambda: f.contract(
        f.ATTN, q, k, v, plan=f.Plan(causal=True)))


def attn_window(ctx):
    f = _contract()
    q = ctx.arr("attn_window:q", 1, 64, 3, 16)
    k, v = ctx.arr("attn_window:k", 1, 64, 3, 16), \
        ctx.arr("attn_window:v", 1, 64, 3, 16)
    return check(ctx, "attn_window", lambda: f.contract(
        f.ATTN, q, k, v, plan=f.Plan(causal=True, window=24)))


def attn_valid(ctx):
    f = _contract()
    q, k, v = (ctx.arr(f"attn_valid:{n}", 4, 64, 8, 16) for n in "qkv")
    valid = torch.from_numpy(ctx.rng.random((4, 64)) > 0.3)
    ctx.arrays["attn_valid:valid"] = valid.numpy()
    return check(ctx, "attn_valid", lambda: f.contract(
        f.ATTN, q, k, v, masks=(valid,)))


def mesh_of_one(ctx):
    """A mesh whose data axis has one rank: the plan binds, nothing
    shards, the dispatch is the plain one."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import api as par
    from repro_torch.runtime import faults
    f = _contract()
    x, y = ctx.arr("one:x", 64, 48), ctx.arr("one:y", 48, 96)
    want = f.contract("mk,kn->mn", x, y)
    m1 = make_test_mesh((4, 1), ("replica", "data"))
    p = probe_plan()
    with par.use_rules(par.default_rules(m1)), faults.install(p):
        got = f.contract("mk,kn->mn", x, y)
    fired = len(p.fired(faults.COLLECTIVE))
    return torch.equal(want, got) and fired == 0, f"fired={fired}"


def explicit_binding(ctx):
    """Plan(mesh=...) binds without ambient rules."""
    from repro_torch.runtime import faults
    f = _contract()
    x, y = ctx.arr("explicit:x", 64, 48), ctx.arr("explicit:y", 48, 96)
    want = f.contract("mk,kn->mn", x, y)
    p = probe_plan()
    with faults.install(p):
        got = f.contract("mk,kn->mn", x, y, plan=f.Plan(mesh=ctx.mesh))
        got_rules = f.contract("mk,kn->mn", x, y,
                               plan=f.Plan(mesh=ctx.rules))
    fired = len(p.fired(faults.COLLECTIVE))
    return (torch.equal(want, got) and torch.equal(want, got_rules)
            and fired == 2), f"fired={fired}"


def mesh_false(ctx):
    """Plan(mesh=False) opts out under active ambient rules."""
    from repro_torch.parallel import api as par
    from repro_torch.runtime import faults
    f = _contract()
    x, y = ctx.arr("nomesh:x", 64, 48), ctx.arr("nomesh:y", 48, 96)
    want = f.contract("mk,kn->mn", x, y)
    p = probe_plan()
    with par.use_rules(ctx.rules), faults.install(p):
        got = f.contract("mk,kn->mn", x, y, plan=f.Plan(mesh=False))
    fired = len(p.fired(faults.COLLECTIVE))
    return torch.equal(want, got) and fired == 0, f"fired={fired}"


def guarded_abft(ctx):
    """Guards and ABFT wrap the per-shard dispatch from outside: the same
    bits, no verdict, no demotion."""
    from repro_torch.core import abft, lowering
    from repro_torch.parallel import api as par
    f = _contract()
    x, y = ctx.arr("abft:x", 64, 48), ctx.arr("abft:y", 48, 96)
    q, k, v = (ctx.arr(f"abft:{n}", 4, 64, 8, 16) for n in "qkv")
    lowering.clear_guard_state()
    with f.configure(f.FacilityConfig(device="cpu", guards=True,
                                      abft=True)):
        s0 = f.contract("mk,kn->mn", x, y)
        a0 = f.contract(f.ATTN, q, k, v)
        with par.use_rules(ctx.rules):
            s1 = f.contract("mk,kn->mn", x, y)
            a1 = f.contract(f.ATTN, q, k, v)
    ok = (torch.equal(s0, s1) and torch.equal(a0, a1)
          and not lowering.GUARD_EVENTS
          and all(vd["recovered"] for vd in abft.VERDICTS))
    return ok, (f"events={lowering.GUARD_EVENTS} "
                f"verdicts={len(abft.VERDICTS)}")


def grad_gemm(ctx):
    """Gradients through the per-shard dispatch: the partial sums over the
    mesh axes reduced back (dX over the model axis, dW over data) equal
    the single-device gradients within fp32 reassociation."""
    f = _contract()
    xs = ctx.arr("grad:x", 64, 48)
    ys = ctx.arr("grad:y", 48, 96)
    cfg = f.FacilityConfig(device="cpu", ger=f.Ger.F32GER,
                           out_dtype=torch.float32)

    def run():
        x = xs.clone().requires_grad_(True)
        y = ys.clone().requires_grad_(True)
        with f.configure(cfg):
            out = f.contract("mk,kn->mn", x, y)
        (out * out).sum().backward()
        return out, x.grad, y.grad

    o0, gx0, gy0 = run()
    from repro_torch.parallel import api as par
    with par.use_rules(ctx.rules):
        o1, gx1, gy1 = run()
    # the partial sums add in another order: fp32 reassociation, 1e-5 of
    # the gradient's largest element
    ok = (torch.equal(o0, o1)
          and torch.allclose(gx0, gx1, rtol=1e-5,
                             atol=1e-5 * gx0.abs().max().item())
          and torch.allclose(gy0, gy1, rtol=1e-5,
                             atol=1e-5 * gy0.abs().max().item()))
    return ok, (f"dx {(gx0 - gx1).abs().max().item()} "
                f"dy {(gy0 - gy1).abs().max().item()}")


def probe_plan():
    from torch_mesh_world import probe
    return probe()


SHARDING = [("gemm2d", gemm2d), ("bgemm", bgemm), ("gemm_fused", gemm_fused),
            ("gemm_wide", gemm_wide), ("einsum", einsum),
            ("gemm_indivisible", gemm_indivisible),
            ("gemm_packed_y", gemm_packed_y), ("conv1d", conv1d),
            ("conv_stem", conv_stem), ("depthwise", depthwise),
            ("attn", attn), ("attn_causal", attn_causal),
            ("attn_gqa", attn_gqa_seqshard),
            ("attn_seq", attn_seq_parallel), ("attn_window", attn_window),
            ("attn_valid", attn_valid), ("mesh_of_one", mesh_of_one),
            ("explicit_binding", explicit_binding),
            ("mesh_false", mesh_false), ("guarded_abft", guarded_abft),
            ("grad_gemm", grad_gemm)]

# ----------------------------------------------------------------------
# parallel
# ----------------------------------------------------------------------

def _moe_setup(ctx, tag):
    from repro_torch.configs import get
    from repro_torch.configs.base import reduced
    from repro_torch.models import moe as MOE
    cfg = reduced(get("mixtral-8x22b"))
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    w = {"router": ctx.arr(f"{tag}:router", d, e) * d ** -0.5,
         "w1": ctx.arr(f"{tag}:w1", e, d, f) * d ** -0.5,
         "w3": ctx.arr(f"{tag}:w3", e, d, f) * d ** -0.5,
         "w2": ctx.arr(f"{tag}:w2", e, f, d) * f ** -0.5}
    for k, v in w.items():
        ctx.arrays[f"{tag}:{k}"] = v.numpy().copy()
    x = ctx.arr(f"{tag}:x", 2, 64, d)
    return cfg, MOE, MOE.MoE(w["router"], w["w1"], w["w3"], w["w2"]), x


def _exchange(ctx, rules, tag):
    from repro_torch.parallel import api as par
    from repro_torch.runtime import faults
    cfg, MOE, layer, x = _moe_setup(ctx, tag)
    o_ref, a_ref = MOE.apply_moe(layer, x, cfg)
    p = probe_plan()
    try:
        MOE.EXCHANGE_DISPATCH = True
        with par.use_rules(rules), faults.install(p):
            o_ex, a_ex = MOE.apply_moe(layer, x, cfg)
        o_deg, _ = MOE.apply_moe(layer, x, cfg)     # no mesh: fn(buf)
    finally:
        MOE.EXCHANGE_DISPATCH = False
    ctx.save(f"{tag}:gather", o_ref)
    ctx.save(f"{tag}:exchange", o_ex)
    fired = len(p.fired(faults.COLLECTIVE))
    ok = (torch.equal(o_ref, o_ex) and torch.equal(o_ref, o_deg)
          and torch.equal(a_ref, a_ex) and fired > 0)
    return ok, (f"max_err={(o_ref.float() - o_ex.float()).abs().max()} "
                f"fired={fired} bytes={dict(par.COLLECTIVE_BYTES)}")


def moe_exchange(ctx):
    """EXCHANGE_DISPATCH over the 2-way model axis (4 experts a rank) is
    the gather dispatch bit for bit, and degrades to it with no mesh."""
    return _exchange(ctx, ctx.rules, "moe2")


def moe_exchange_4way(ctx):
    """The same over a 4-way expert axis (a (1, 4) mesh: 2 experts a
    rank)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import api as par
    m4 = make_test_mesh((1, 4), ("data", "model"))
    return _exchange(ctx, par.default_rules(m4), "moe4")


def _ref_tree(ctx):
    """The reference's deepseek-7b (reduced) parameters, written by the
    test before the world starts, as the nested dict convert takes."""
    z = np.load(os.path.join(ctx.tmp, "..", "ref_train.npz"))
    tree: dict = {}
    for key in z.files:
        if not key.startswith("p0/"):
            continue
        node = tree
        parts = key[3:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = z[key]
    return tree, z


def _train_setup():
    from repro_torch.configs import get
    from repro_torch.configs.base import reduced
    from repro_torch.data import pipeline
    from repro_torch.optim import adamw
    from repro_torch.train import steps as S
    cfg = reduced(get("deepseek-7b"))
    opt = adamw.AdamWConfig(lr=1e-3)
    batch = pipeline.device_batch(
        pipeline.synthetic_batch(cfg, batch=4, seq=64, step=0), "cpu")
    return cfg, opt, batch, S


def _full_params(model):
    from repro_torch.parallel import api as par
    with torch.no_grad():
        return {k: par.full(p).detach().clone()
                for k, p in model.named_parameters()}


def _moments(state) -> dict:
    """The optimizer's first and second moments after a step, as global
    values by parameter name: ``m`` = (1 - b1) g and ``v`` = (1 - b2) g^2
    (g clipped by the world's gradient norm), what the step computed
    before Adam normalised it."""
    from repro_torch.parallel import api as par
    with torch.no_grad():
        return {w: {k: par.full(t).detach().clone()
                    for k, t in state["opt"][w].items()} for w in "mv"}


def moment_error(ref: dict, got: dict) -> float:
    """The worst leaf's max |got - ref| over its max |ref|, over m and v."""
    return max(((got[w][k] - ref[w][k]).abs().max()
                / ref[w][k].abs().max().clamp_min(1e-30)).item()
               for w in "mv" for k in ref[w])


# A sound mesh step's readings: each leaf's moments within 5e-2 of its
# scale, the gradient norm within 1e-3 relative.  The BF16GER2 backward
# products round each shard's partial sums (the data axis's gradient sum,
# the model axis's dX) to their output before the sum, so a sound step
# reads up to 1.2e-2 and 5.2e-5 against one process, and 1.2e-2 and 8e-6
# against the reference's mesh step; a skipped or doubled data-axis sum,
# or an unchanged state, reads >= 1.0 and >= 5.8e-2.
MOMENT_TOL, NORM_TOL = 5e-2, 1e-3


@contextlib.contextmanager
def planted(fault: str, mesh):
    """A fault planted in the data axis's gradient sums (the FSDP
    reduce-scatter and the all-reduce of ``parallel.api._Enter``'s
    backward): ``skip`` leaves each rank's partial unsummed, ``double``
    doubles the sum."""
    from repro_torch.parallel import api as par
    data = list(par.axis_sizes(mesh)).index("data")
    rs, ar = par._reduce_scatter, par._all_reduce

    def reduce_scatter(x, m, axis, dim):
        if axis != data:
            return rs(x, m, axis, dim)
        return (par._slice(x, m, axis, dim) if fault == "skip"
                else 2 * rs(x, m, axis, dim))

    def all_reduce(x, m, axis):
        if axis != data:
            return ar(x, m, axis)
        return x.clone() if fault == "skip" else 2 * ar(x, m, axis)

    par._reduce_scatter, par._all_reduce = reduce_scatter, all_reduce
    try:
        yield
    finally:
        par._reduce_scatter, par._all_reduce = rs, ar


def train_step(ctx):
    """One train step of reduced deepseek-7b (the reference's weights) on
    the 2 x 2 mesh with param_spec's TP + FSDP layout, against the same
    step in one process: the loss within 1e-3 and every parameter within
    rtol/atol 2e-3 (the reference's test_parallel.py tolerances), and what
    the step computed before Adam normalised it, which those cannot see
    (Adam's first step moves a parameter by lr whatever its gradient):
    each leaf's moments within MOMENT_TOL and the world's gradient norm
    within NORM_TOL.  The same readings must fail on a step whose data
    axis skips or doubles its gradient sum, and on a state the step left
    unchanged."""
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.parallel import api as par
    cfg, opt, batch, S = _train_setup()
    tree, _ = _ref_tree(ctx)
    step = S.make_train_step(cfg, opt)

    single = S.train_state_from(
        convert.params_from_numpy(tree, cfg, device="cpu"), opt)
    _, m1 = step(single, batch)
    p1 = _full_params(single["params"])
    mo1, gn1 = _moments(single), m1["grad_norm"].item()

    def sharded_step(fault=None):
        model = M.place(convert.params_from_numpy(tree, cfg, device="cpu"),
                        M.param_axes(cfg), ctx.rules)
        state = S.train_state_from(model, opt)
        with par.use_rules(ctx.rules), (
                planted(fault, ctx.mesh) if fault else
                contextlib.nullcontext()):
            _, met = step(state, batch)
        return state, met

    sharded, m2 = sharded_step()
    model = sharded["params"]
    n_local = sum(par.local(p).numel() for p in model.parameters())
    n_all = sum(p.numel() for p in model.parameters())
    p2, mo2 = _full_params(model), _moments(sharded)
    ctx.arrays["train:loss"] = np.float32(m2["loss"].item())
    ctx.arrays["train:grad_norm"] = np.float32(m2["grad_norm"].item())
    for k, v in p2.items():
        ctx.save(f"train:{k}", v)
        ctx.save(f"train:m:{k}", mo2["m"][k])
    dl = abs(m1["loss"].item() - m2["loss"].item())
    worst = max(((p1[k] - p2[k]).abs() - 2e-3 * p1[k].abs()).max().item()
                for k in p1)
    readings = {"sound": (moment_error(mo1, mo2),
                          abs(m2["grad_norm"].item() - gn1) / gn1)}
    for fault in ("skip", "double"):
        st, met = sharded_step(fault)
        readings[fault] = (moment_error(mo1, _moments(st)),
                           abs(met["grad_norm"].item() - gn1) / gn1)
    fresh = S.train_state_from(M.place(
        convert.params_from_numpy(tree, cfg, device="cpu"),
        M.param_axes(cfg), ctx.rules), opt)
    readings["unchanged"] = (moment_error(mo1, _moments(fresh)), None)

    def holds(r):
        return r[0] <= MOMENT_TOL and r[1] is not None and r[1] <= NORM_TOL

    ok = (dl < 1e-3 and worst <= 2e-3 and n_local < n_all
          and holds(readings["sound"])
          and not any(holds(r) for f, r in readings.items()
                      if f != "sound"))
    return ok, (f"loss {m1['loss'].item()} vs {m2['loss'].item()} "
                f"worst={worst} local {n_local} of {n_all}; (moment error,"
                f" grad-norm error) {readings}")


def launcher(ctx):
    """launch.train.build(mesh=...): the state is built onto the mesh at
    the shardings it returns (each leaf a shard, no rank holding the whole
    state), and its step gives the single-process build's loss."""
    from repro_torch.configs import get
    from repro_torch.configs.base import reduced
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    from repro_torch.parallel import api as par
    cfg = reduced(get("deepseek-7b"))
    batch = pipeline.device_batch(
        pipeline.synthetic_batch(cfg, batch=4, seq=64, step=0), "cpu")
    mk1, st1, sh1 = T.build(cfg, device="cpu", lr=1e-3, total_steps=10)
    mk2, st2, sh2 = T.build(cfg, device="cpu", lr=1e-3, total_steps=10,
                            mesh=ctx.mesh)
    s1, s2 = mk1(), mk2()
    _, m1 = st1()(s1, batch)
    _, m2 = st2()(s2, batch)
    laid = all(par.spec_of(p) == tuple(a for a in sh2["params"][k].spec)
               or (par.spec_of(p) is not None
                   and all(a is None for a in sh2["params"][k].spec)
                   and all(a is None for a in par.spec_of(p)))
               for k, p in s2["params"].named_parameters())
    n_local = sum(par.local(v).numel() for v in
                  list(s2["params"].parameters())
                  + list(s2["opt"]["m"].values())
                  + list(s2["opt"]["v"].values()))
    n_all = 3 * sum(p.numel() for p in s2["params"].parameters())
    dl = abs(m1["loss"].item() - m2["loss"].item())
    ok = sh1 is None and laid and dl < 1e-3 and n_local < n_all / 2
    return ok, f"laid={laid} dloss={dl} local {n_local} of {n_all}"


def checkpoint_restore(ctx):
    """A mesh state saved as global arrays, restored onto the same
    shardings and onto a single-process state: every leaf's global value
    comes back.  Only the writer (rank 0) copies leaves to the host, in
    ``save`` and in ``save_async``."""
    from repro_torch.checkpoint import checkpoint as C
    from repro_torch.configs import get
    from repro_torch.configs.base import reduced
    from repro_torch.launch import train as T
    cfg = reduced(get("deepseek-7b"))
    mk, _, shardings = T.build(cfg, device="cpu", mesh=ctx.mesh, seed=3)
    state = mk()
    want = _full_params(state["params"])
    ck = C.Checkpointer(os.path.join(ctx.tmp, "ckpt_restore"))
    copies, to_host = [], C._to_host
    C._to_host = lambda leaf, copy: copies.append(1) or to_host(leaf, copy)
    try:
        ck.save_async(6, state)
        ck.save(7, state)
        ck.wait()
    finally:
        C._to_host = to_host
    n_leaves = len(C._flatten(state))
    # every rank's count, held where rank 0 reports
    bad = torch.tensor([int(len(copies) != (2 * n_leaves if ctx.rank == 0
                                            else 0))])
    torch.distributed.all_reduce(bad)
    host_ok = bad.item() == 0
    mk0, _, _ = T.build(cfg, device="cpu", mesh=ctx.mesh, seed=5)
    other = ck.restore(7, mk0(), shardings)
    got = _full_params(other["params"])
    plain_mk, _, _ = T.build(cfg, device="cpu", seed=5)
    plain = ck.restore(7, plain_mk())
    got_plain = {k: p.detach() for k, p in
                 plain["params"].named_parameters()}
    ok = host_ok and all(torch.equal(want[k], got[k])
                         and torch.equal(want[k], got_plain[k])
                         for k in want)
    return ok, (f"latest={ck.latest_step()} host copies on rank "
                f"{ctx.rank}: {len(copies)} of {n_leaves} leaves x 2")


def elastic(ctx):
    """ElasticTrainer(state_shardings=...) on the mesh, reduced
    mamba2-130m: a collective raise in step 3 restarts once, restoring
    the step-2 checkpoint onto the shardings; every step's loss is the
    clean run's bit for bit."""
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.configs import get
    from repro_torch.configs.base import reduced
    from repro_torch.data import pipeline
    from repro_torch.launch import train as T
    from repro_torch.runtime import faults
    from repro_torch.runtime.elastic import ElasticConfig, ElasticTrainer
    cfg = reduced(get("mamba2-130m"))
    mk, mstep, shardings = T.build(cfg, device="cpu", mesh=ctx.mesh,
                                   lr=1e-3, total_steps=6)

    def trainer(tag, plan):
        return ElasticTrainer(
            make_step=mstep, make_state=mk,
            batches=lambda s: pipeline.Prefetcher(cfg, batch=2, seq=32,
                                                  device="cpu",
                                                  start_step=s),
            checkpointer=Checkpointer(os.path.join(ctx.tmp, tag)),
            cfg=ElasticConfig(ckpt_every=2), state_shardings=shardings,
            faults=plan)

    count = probe_plan()
    clean = trainer("elastic_clean", count).run(6)
    visits = len(count.fired(faults.COLLECTIVE)) // 6
    plan = faults.FaultPlan([faults.FaultSpec(
        faults.COLLECTIVE, kind=faults.RAISE, every=3 * visits + 1,
        max_fires=1)])
    failed = trainer("elastic_fail", plan).run(6)
    lc = [m["loss"] for m in clean["metrics"]]
    lf = {m["step"]: m["loss"] for m in failed["metrics"]}
    ok = (failed["restarts"] == 1 and clean["restarts"] == 0
          and [lf[i] for i in range(6)] == lc and visits > 0)
    return ok, (f"visits/step={visits} restarts={failed['restarts']} "
                f"clean={lc} failed={lf}")


PARALLEL = [("moe_exchange", moe_exchange),
            ("moe_exchange_4way", moe_exchange_4way),
            ("train_step", train_step), ("launcher", launcher),
            ("checkpoint_restore", checkpoint_restore),
            ("elastic", elastic)]

SUITES = {"sharding": SHARDING, "parallel": PARALLEL}
