"""The port's distribution layer (``parallel/api.py``, ``launch/mesh.py``)
against the reference's, on the CPU.

  * Spec parity, with no ranks: for every arch, ``param_axes``,
    ``train_state_axes``, ``tree_param_specs`` (FSDP on and off) and
    ``activation_spec`` at the model's activation shapes equal the
    reference's leaf by leaf on the production meshes 16 x 16 and
    2 x 16 x 16 (the reference on ``jax.sharding.AbstractMesh``, the port
    on ``parallel.api.AbstractMesh``); the spec -> DTensor placements
    converter, pod-major.
  * One spawned gloo world of 4 CPU ranks on a 2 x 2 mesh
    (``tests/torch_mesh_world.py``, suite "parallel"): the expert exchange
    (reduced mixtral-8x22b, 2- and 4-way expert axes) bit for bit the
    gather dispatch; one train step of reduced deepseek-7b (batch 4, seq
    64, the reference's weights) with TP + FSDP against the single-process
    step (loss within 1e-3, parameters within rtol/atol 2e-3: the
    reference's ``test_parallel.py`` tolerances; each leaf's moments and
    the gradient norm within the tolerances ``torch_mesh_cases`` states,
    which a skipped or doubled data-axis gradient sum and an unchanged
    state must fail); ``launch.train.build
    (mesh=)``; ``Checkpointer.restore(shardings=)``; ``ElasticTrainer
    (state_shardings=)`` through a ``collective`` raise, bit for bit the
    clean run.
  * Against the reference: the exchange's output within 2e-2 (rtol and
    atol, BF16GER2 with bf16 outputs, the tolerance of
    tests/test_torch_moe.py's layer test) of the reference's gather
    dispatch on the same weights; the port's mesh step within the same
    1e-3 / 2e-3, moment and gradient-norm tolerances of the reference's
    mesh step (a subprocess with 4 forced host devices on a 2 x 2 mesh, as
    the reference's test runs it).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCHS
from repro.configs import get as jget
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.parallel import api as jpar
from repro.train import steps as JS
from repro_torch.configs import get as tget
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as TM
from repro_torch.parallel import api as tpar
from repro_torch.train import steps as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_mesh_cases as cases  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _rules(mesh_name):
    shape, axes = MESHES[mesh_name]
    return (jpar.default_rules(AbstractMesh(shape, axes)),
            tpar.default_rules(tpar.AbstractMesh(shape, axes)))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{path}/{k}")
        return out
    return [(path, tree)]


def _spec(p):
    return tuple(p)


# ----------------------------------------------------------------------
# spec parity (no ranks)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_axes_match_reference(arch):
    assert TM.param_axes(tget(arch)) == JM.param_axes(jget(arch))
    for compress in (False, True):
        for bf16 in (False, True):
            assert TS.train_state_axes(
                tget(arch), compress=compress, bf16_params=bf16) == \
                JS.train_state_axes(jget(arch), compress=compress,
                                    bf16_params=bf16)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_param_specs_match_reference(arch, mesh_name):
    jr, tr = _rules(mesh_name)
    jcfg = jget(arch)
    abstract = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                     jax.random.key(0)))
    shapes = jax.tree.map(lambda a: tuple(a.shape), abstract)
    for fsdp in (True, False):
        want = jpar.tree_param_specs(abstract, JM.param_axes(jcfg), jr,
                                     fsdp=fsdp)
        got = tpar.tree_param_specs(shapes, TM.param_axes(tget(arch)), tr,
                                    fsdp=fsdp)
        w = [(p, _spec(s)) for p, s in _leaves(
            jax.tree.map(_spec, want, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec)))]
        assert _leaves(got) == w, (arch, mesh_name, fsdp)


def _activation_cases(cfg):
    b, s = 256, 4096
    h, kv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    out = [((b, s, d), ("batch", "seq", None)),
           ((b, s, h, hd), ("batch", None, "heads", None)),
           ((b, s, kv, hd), ("batch", None, "kv_heads", None)),
           ((b, s, kv, hd), ("batch", "seq_kv", None, None)),
           ((b, s, cfg.d_ff), ("batch", None, "mlp")),
           ((b, s, cfg.vocab_size), ("batch", None, "vocab")),
           ((b, 1, d), ("batch", None, None)),
           ((7, s, d), ("batch", "seq", None))]
    if cfg.ssm_state:
        nh = cfg.ssm_expand * d // cfg.ssm_headdim
        out.append(((b, s, nh, cfg.ssm_headdim),
                    ("batch", None, "ssm_heads", None)))
    if cfg.num_experts:
        cap = -(-b * s * cfg.top_k * 5 // (4 * cfg.num_experts))
        f = cfg.moe_d_ff or cfg.d_ff
        out += [((cfg.num_experts, cap, d), ("experts", None, None)),
                ((cfg.num_experts, cap, f), ("experts", None, "mlp"))]
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_activation_specs_match_reference(arch, mesh_name):
    jr, tr = _rules(mesh_name)
    for shape, axes in _activation_cases(tget(arch)):
        assert tpar.activation_spec(shape, axes, tr) == _spec(
            jpar.activation_spec(shape, axes, jr)), (shape, axes)


def test_placements_are_pod_major():
    from torch.distributed.tensor import Replicate, Shard
    m = tpar.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert tpar.placements((("pod", "data"), "model"), m) == [
        Shard(0), Shard(0), Shard(1)]
    assert tpar.placements((None, "model"), m) == [
        Replicate(), Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="axis order"):
        tpar.placements((("data", "pod"),), m)


def test_shard_is_a_no_op_without_a_mesh_and_checks_rank():
    import torch
    x = torch.zeros(2, 3)
    assert tpar.shard(x, "batch", None) is x
    mesh = tpar.AbstractMesh((2, 2), ("data", "model"))
    with tpar.use_rules(tpar.default_rules(mesh)):
        with pytest.raises(ValueError, match="rank-2"):
            tpar.shard(x, "batch")
        # a plain tensor holds the global value: it stays as it is
        assert tpar.shard(x, "batch", None) is x


def test_single_device_dispatch_makes_no_mesh_check(monkeypatch):
    """With no torch.distributed world there is no mesh and no DTensor: a
    contract call asks ``parallel.api.active`` once and goes on, even
    under mesh rules, without planning shards or scanning its operands."""
    import torch
    from repro_torch.core import facility, lowering

    def boom(*a, **k):
        raise AssertionError("a mesh check ran with no world")

    monkeypatch.setattr(lowering, "_mesh_dispatch", boom)
    monkeypatch.setattr(tpar, "is_dtensor", boom)
    x, y = torch.ones(4, 8), torch.ones(8, 16)
    mesh = tpar.AbstractMesh((2, 2), ("data", "model"))
    with facility.configure(facility.FacilityConfig(device="cpu")), \
            tpar.use_rules(tpar.default_rules(mesh)):
        assert not tpar.active()
        out = facility.contract("mk,kn->mn", x, y)
    assert torch.equal(out, torch.full((4, 16), 8.0))


def test_production_mesh_says_what_it_needs():
    with pytest.raises(RuntimeError, match="world of 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="world of 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)


def test_rules_hash_by_identity():
    mesh = tpar.AbstractMesh((2, 2), ("data", "model"))
    a, b = tpar.default_rules(mesh), tpar.default_rules(mesh)
    assert a == b and hash(a) != hash(b)
    assert a.axis_extent(("data", "model")) == 4
    assert a.axis_extent(None) == 1


# ----------------------------------------------------------------------
# the gloo world
# ----------------------------------------------------------------------

_REFERENCE_STEP = """
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get
    from repro.configs.base import reduced
    from repro.data import pipeline
    from repro.launch.mesh import make_test_mesh
    from repro.optim import adamw
    from repro.parallel import api as par
    from repro.train import steps as S

    cfg = reduced(get('deepseek-7b'))
    opt_cfg = adamw.AdamWConfig(lr=1e-3)
    b = pipeline.synthetic_batch(cfg, batch=4, seq=64, step=0)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    step = S.make_train_step(cfg, opt_cfg)
    state0 = S.init_train_state(cfg, jax.random.key(0), opt_cfg)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            state0['params'])[0]:
        key = '/'.join(p.key for p in path)
        out['p0/' + key] = np.asarray(leaf, np.float32)
    mesh = make_test_mesh((2, 2), ('data', 'model'))
    rules = par.default_rules(mesh)
    ax = S.train_state_axes(cfg)
    shardings = jax.tree.map(
        lambda a, x: NamedSharding(
            mesh, par.param_spec(a.shape, x, rules) if x else P()),
        state0, ax,
        is_leaf=lambda t: isinstance(t, tuple) and all(
            isinstance(e, (str, type(None))) for e in t))
    state0 = jax.device_put(state0, shardings)
    with par.use_rules(rules), mesh:
        s2, m2 = jax.jit(step, in_shardings=(shardings, None))(
            state0, batch)
    out['loss'] = np.float32(m2['loss'])
    out['grad_norm'] = np.float32(m2['grad_norm'])
    for tag, tree in (('p1/', s2['params']), ('m1/', s2['opt']['m'])):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = '/'.join(p.key for p in path)
            out[tag + key] = np.asarray(leaf, np.float32)
    np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_parallel"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        + env.get("XLA_FLAGS", ""))
    src = (f"OUT = {os.path.join(out, 'ref_train.npz')!r}\n"
           + textwrap.dedent(_REFERENCE_STEP))
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True,
                          text=True, env=env, timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_mesh_world.py"),
         "parallel", out], capture_output=True, text=True, env=env,
        timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    with open(os.path.join(out, "parallel.json")) as f:
        results = json.load(f)
    return (results, dict(np.load(os.path.join(out, "parallel.npz"))),
            dict(np.load(os.path.join(out, "ref_train.npz"))))


@pytest.mark.parametrize("case", [n for n, _ in cases.PARALLEL])
def test_mesh_case(world, case):
    results, _, _ = world
    assert results[case]["ok"], results[case]["detail"]


@pytest.mark.parametrize("tag", ["moe2", "moe4"])
def test_exchange_matches_reference_gather_dispatch(world, tag):
    from repro.configs.base import reduced
    _, arrays, _ = world
    cfg = reduced(jget("mixtral-8x22b"))
    p = {k: jnp.asarray(arrays[f"{tag}:{k}"]) for k in
         ("router", "w1", "w3", "w2")}
    old = JMOE.GATHER_DISPATCH
    try:
        JMOE.GATHER_DISPATCH = True
        want, _ = JMOE.apply_moe(p, jnp.asarray(arrays[f"{tag}:x"]), cfg)
    finally:
        JMOE.GATHER_DISPATCH = old
    want = np.asarray(want.astype(jnp.float32))
    got = arrays[f"{tag}:exchange"]
    np.testing.assert_allclose(got, want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


def test_mesh_step_matches_reference_mesh_step(world):
    """The port's mesh step against the reference's: the loss within
    1e-3 and each parameter within rtol/atol 2e-3 (the reference's
    tolerances), and the first moment (1 - b1) g, which Adam's first step
    hides from the parameters, within each leaf's ``MOMENT_TOL`` with the
    gradient norm within ``NORM_TOL`` (tests/torch_mesh_cases.py gives
    the sound and the faulted readings)."""
    _, arrays, ref = world
    assert abs(float(arrays["train:loss"]) - float(ref["loss"])) < 1e-3
    gn = float(ref["grad_norm"])
    assert abs(float(arrays["train:grad_norm"]) - gn) <= cases.NORM_TOL * gn
    model = TM.init_params(_reduced("deepseek-7b"), device="meta")
    checked = 0
    for name, _ in model.named_parameters():
        idx = _layer_index(name)
        for tag, got in (("p1/", f"train:{name}"), ("m1/", f"train:m:{name}")):
            want = ref[tag + _ref_key(name)]
            if idx is not None:
                want = want[idx]
            if tag == "p1/":
                np.testing.assert_allclose(arrays[got], want, rtol=2e-3,
                                           atol=2e-3, err_msg=name)
            else:
                err = np.abs(arrays[got] - want).max() / np.abs(want).max()
                assert err <= cases.MOMENT_TOL, (name, err)
        checked += 1
    assert checked == len(list(model.parameters()))


def _reduced(arch):
    from repro_torch.configs.base import reduced
    return reduced(tget(arch))


def _ref_key(name: str) -> str:
    return "/".join(p for p in name.split(".") if not p.isdigit())


def _layer_index(name: str):
    parts = name.split(".")
    for i, p in enumerate(parts):
        if p.isdigit():
            return int(p)
    return None
