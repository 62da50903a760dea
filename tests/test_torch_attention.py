"""The port's attention (repro_torch.kernels.mma_attention and contract's
attn op-class) against the JAX reference, on the CPU.

The same numpy inputs go through the reference's Pallas flash kernel in
interpret mode and through the port, whose kernel wrapper runs its plain
version (the two-product softmax) on a CPU tensor.  Tolerance on the f32
output: ``rtol=atol=1e-5`` (online vs one-shot softmax in fp32); rows whose
every slot is masked must be exact zeros in both.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import facility as jfac
from repro.core import precision as jprec
from repro.kernels import epilogue as jep
from repro.kernels import mma_attention as jattn
from repro_torch.core import facility as tfac
from repro_torch.core import precision as tprec
from repro_torch.kernels import epilogue as tep
from repro_torch.kernels import mma_attention as tattn


def _qkv(seed, b, sq, sk, h, kvh, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    return q, k, v


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.mark.parametrize("name,shape,kw", [
    ("causal", (2, 32, 32, 4, 4, 16), dict(causal=True)),
    ("full", (1, 32, 48, 4, 4, 16), dict(causal=False)),
    ("gqa", (2, 32, 32, 8, 2, 16), dict(causal=True)),
    ("window", (1, 64, 64, 4, 2, 16), dict(causal=True, window=20)),
    ("q_offset", (1, 16, 64, 4, 4, 16), dict(causal=True, q_offset=48)),
    ("window+q_offset", (1, 16, 64, 4, 1, 16),
     dict(causal=True, q_offset=48, window=24)),
])
def test_plain_matches_pallas(name, shape, kw):
    b, sq, sk, h, kvh, d = shape
    q, k, v = _qkv(sum(map(ord, name)), b, sq, sk, h, kvh, d)
    want = jattn.mma_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=16,
        block_k=16, out_dtype=jnp.float32, interpret=True, **kw)
    got = tattn.mma_flash_attention(_t(q), _t(k), _t(v),
                                    out_dtype=torch.float32, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_plain_matches_pallas_valid_and_masked_rows():
    q, k, v = _qkv(4, 2, 32, 32, 4, 2, 16)
    valid = np.ones((2, 32), bool)
    valid[:, :3] = False          # causal rows 0-2 see only invalid slots
    valid[1, 20:] = False
    want = np.asarray(jattn.mma_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        valid=jnp.asarray(valid), block_q=16, block_k=16,
        out_dtype=jnp.float32, interpret=True))
    got = tattn.mma_flash_attention(
        _t(q), _t(k), _t(v), causal=True, valid=torch.from_numpy(valid),
        out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[:, :3] == 0.0) and np.all(want[:, :3] == 0.0)


def test_plain_matches_pallas_epilogue():
    q, k, v = _qkv(5, 1, 32, 32, 4, 4, 16)
    rng = np.random.default_rng(6)
    bias = rng.standard_normal((16,)).astype(np.float32)
    res = rng.standard_normal(q.shape).astype(np.float32)
    want = jattn.mma_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        ep=jep.Epilogue(bias=True, activation="gelu", residual=True),
        bias=jnp.asarray(bias), residual=jnp.asarray(res), block_q=16,
        block_k=16, out_dtype=jnp.float32, interpret=True)
    got = tattn.mma_flash_attention(
        _t(q), _t(k), _t(v), causal=True,
        ep=tep.Epilogue(bias=True, activation="gelu", residual=True),
        bias=_t(bias), residual=_t(res), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bf16_plain_matches_pallas():
    """bf16 operands: the kernel rounds the unnormalised P per block, the
    plain version the normalised P once; both are within a bf16 half-ulp
    of each weight, so 2^-7 * max|v| bounds the difference."""
    q, k, v = _qkv(7, 1, 32, 32, 4, 4, 16)
    want = np.asarray(jattn.mma_flash_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), causal=True, block_q=16, block_k=16,
        out_dtype=jnp.float32, interpret=True))
    got = tattn.mma_flash_attention(
        _t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(), causal=True,
        out_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(v).max()


@pytest.mark.parametrize("sq,sk,bq,bk,kw", [
    (256, 256, 64, 64, dict(causal=True)),
    (256, 256, 64, 64, dict(causal=False)),
    (200, 200, 64, 64, dict(causal=True)),
    (64, 320, 64, 64, dict(causal=True, q_offset=256)),
    (300, 300, 64, 64, dict(causal=True, window=100)),
    (128, 512, 32, 128, dict(causal=True, q_offset=384, window=50)),
    (96, 96, 32, 32, dict(causal=True, bound=False)),
])
def test_grid_plan_matches_reference(sq, sk, bq, bk, kw):
    want = jattn.attn_grid_plan(sq, sk, bq, bk, **kw)
    got = tattn.attn_grid_plan(sq, sk, bq, bk, **kw)
    np.testing.assert_array_equal(got, want)
    kw.pop("bound", None)
    assert (tattn.attn_live_steps(sq, sk, bq, bk, **kw)
            == jattn.attn_live_steps(sq, sk, bq, bk, **kw))
    assert (tattn.attn_live_pairs(sq, sk, **kw)
            == jattn.attn_live_pairs(sq, sk, **kw))


@pytest.mark.parametrize("backend", ["kernel", "torch", "ref"])
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=12, q_chunk=8),
                                dict(causal=False)])
def test_contract_attn_matches_reference(backend, kw):
    q, k, v = _qkv(8, 2, 24, 24, 4, 2, 16)
    valid = np.ones((2, 24), bool)
    valid[0, 5] = False
    want = jfac.contract(
        jfac.ATTN, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        plan=jfac.Plan(ger=jprec.Ger.F32GER, out_dtype=jnp.float32,
                       backend="xla", **kw), masks=(jnp.asarray(valid),))
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        got = tfac.contract(
            tfac.ATTN, _t(q), _t(k), _t(v),
            plan=tfac.Plan(ger=tprec.Ger.F32GER, out_dtype=torch.float32,
                           backend=backend, **kw),
            masks=(torch.from_numpy(valid),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_kernel_tile_is_fixed():
    q, k, v = (_t(a) for a in _qkv(9, 1, 8, 8, 2, 2, 16))
    with tfac.configure(tfac.FacilityConfig(device="cpu")):
        with pytest.raises(ValueError, match="tile"):
            tfac.contract(tfac.ATTN, q, k, v,
                          plan=tfac.Plan(causal=True, block=(128, 128)))


# ----------------------------------------------------------------------
# The 16-bit tile mode's schedule (csrc/mma_attention.cu flash_tile_kernel)
# mirrored in pure Python: its tile list, its configurations' shared
# memory and its step alignment
# ----------------------------------------------------------------------

# An H100 SM's shared memory (228 KB, 1 KB of it reserved a block) and the
# most a block may take (227 KB).
SM_SMEM, BLOCK_SMEM_MAX, BLOCK_SMEM_RESERVED = 233472, 232448, 1024


def tile_config(d, nc):
    """``TileCfg<D, NC>`` of csrc/mma_attention.cu: the step, the blocks an
    SM holds, the ring's stages and the block's shared memory (two Q
    buffers, the K and V stages, their barriers and 1 KB of alignment
    slack)."""
    bq, bkv = 64 * nc, (tattn.TILE_STEP if d <= 128 else tattn.BLOCK_K)
    q_bytes, kv_bytes = bq * d * 2, bkv * d * 2
    min_blocks = 2 if nc == 1 and d <= 64 else 1
    budget = (110 if min_blocks == 2 else 225) * 1024
    stages = min(3, (budget - 2 * q_bytes) // (2 * kv_bytes))
    smem = 1024 + 2 * q_bytes + 2 * stages * kv_bytes + 8 * (4 + 4 * stages)
    return dict(bq=bq, bkv=bkv, min_blocks=min_blocks, stages=stages,
                smem=smem)


def tile_order(b, h, sq, bq, causal):
    """The kernel's tile list (``tile_job``): head by head, b slower than h,
    each head's q tiles the longest first when causal."""
    nq = -(-sq // bq)
    return [(bi, hi, nq - 1 - p if causal else p)
            for bi in range(b) for hi in range(h) for p in range(nq)]


def tile_walk(n_tiles, grid):
    """The list indices each of ``grid`` persistent blocks runs
    (``tile_at``): rounds of ``grid`` tiles, every other one backwards."""
    walks = [[] for _ in range(grid)]
    for base in range(0, n_tiles, grid):
        r = min(grid, n_tiles - base)
        for j in range(r):
            walks[j].append(base + (r - 1 - j if (base // grid) & 1 else j))
    return walks


_TILE_SHAPES = [
    # (b, h, sq, sk, bq, flags)
    (1, 32, 4096, 4096, 128, dict(causal=True)),
    (4, 32, 512, 512, 128, dict(causal=True)),
    (1, 32, 256, 256, 64, dict(causal=True)),
    (4, 28, 1088, 1088, 128, dict(causal=True)),
    (4, 12, 1500, 1500, 128, dict(causal=False)),
    (4, 12, 448, 1500, 64, dict(causal=False)),
    (1, 32, 2048, 2048, 128, dict(causal=True, window=512)),
    (2, 8, 100, 356, 64, dict(causal=True, q_offset=256)),
    (3, 4, 300, 700, 128, dict(causal=False, window=150)),
]


@pytest.mark.parametrize("b,h,sq,sk,bq,kw", _TILE_SHAPES)
def test_tile_order_runs_every_tile_once_longest_first(b, h, sq, sk, bq,
                                                       kw):
    """Every (b, h, q tile) appears once in the kernel's list and once
    among any number of persistent blocks walking it; the list runs head
    by head (neighbouring query heads, one GQA group, side by side),
    each head's tiles the longest (the most steps) first when causal;
    the snake walk spreads the steps over the blocks no worse than one
    tile's worth past the mean."""
    order = tile_order(b, h, sq, bq, kw["causal"])
    nq, nk = -(-sq // bq), -(-sk // tattn.TILE_STEP)
    assert sorted(order) == [(bi, hi, qi) for bi in range(b)
                             for hi in range(h) for qi in range(nq)]
    assert [t[:2] for t in order[::nq]] == [(bi, hi) for bi in range(b)
                                             for hi in range(h)]
    steps = [np.subtract(*tattn.attn_k_bounds(
        qi, nk, bq=bq, bk=tattn.TILE_STEP, **kw)[::-1]) for _, _, qi in order]
    if kw["causal"]:
        for i in range(0, len(order), nq):
            head = steps[i:i + nq]
            assert all(x >= y for x, y in zip(head, head[1:]))
    for grid in (1, 7, 132, 264, len(order) + 5):
        walks = tile_walk(len(order), grid)
        assert sorted(i for w in walks for i in w) == list(range(len(order)))
        if grid <= len(order):
            load = [sum(steps[i] for i in w) for w in walks]
            assert max(load) <= sum(steps) / grid + max(steps)


@pytest.mark.parametrize("d,nc", [(d, nc) for d in tattn.KERNEL_HEAD_DIMS
                                  for nc in (1, 2) if nc == 1 or d < 192])
def test_tile_configs_fit_shared_memory(d, nc):
    """Each compiled configuration (the 128-row tile only below 192, as
    attn_takes has it) fits a block's 227 KB, its resident blocks an SM's
    228 KB with 1 KB reserved each; two or three ring stages; 128-key
    steps at D <= 128."""
    assert tattn.attn_takes((64 * nc, 1), 512, 512, d, False)
    cfg = tile_config(d, nc)
    assert cfg["smem"] <= BLOCK_SMEM_MAX
    assert cfg["min_blocks"] * (cfg["smem"] + BLOCK_SMEM_RESERVED) \
        <= SM_SMEM
    assert cfg["stages"] in (2, 3)
    assert cfg["bkv"] == (128 if d <= 128 else 64) == \
        tattn.kv_step(d, False, 1)
    assert cfg["bq"] == 64 * nc


@pytest.mark.parametrize("sq,sk,kw", [
    (256, 256, dict(causal=True)),
    (300, 300, dict(causal=True, window=100)),
    (100, 356, dict(causal=True, q_offset=256)),
    (64, 1000, dict(causal=True, q_offset=936, window=70)),
    (200, 333, dict(causal=False)),
    (700, 700, dict(causal=False, window=150)),
    (2048, 2048, dict(causal=True, window=512)),
])
@pytest.mark.parametrize("bq", [64, 128])
def test_tile_steps_hold_the_same_live_pairs(sq, sk, kw, bq):
    """The kernel's steps of 128 keys, attn_k_bounds at bk = 128, are
    attn_k_bounds at 64 widened to multiples of 128, and hold the same
    live (q, k) pairs as the 64-key blocks: every pair
    attn_live_pairs counts, and only dead pairs besides."""
    step, nq = tattn.TILE_STEP, -(-sq // bq)
    live = 0
    for qi in range(nq):
        lo, hi = tattn.attn_k_bounds(qi, -(-sk // step), bq=bq, bk=step,
                                     **kw)
        lo64, hi64 = tattn.attn_k_bounds(qi, -(-sk // 64), bq=bq, bk=64,
                                         **kw)
        assert (lo, hi) == (lo64 * 64 // step, -(-hi64 * 64 // step))
        rows = np.arange(qi * bq, min(sq, (qi + 1) * bq)) + kw.get(
            "q_offset", 0)
        for keys, span in (((lo * step, min(sk, hi * step)), "steps"),
                           ((lo64 * 64, min(sk, hi64 * 64)), "blocks")):
            k = np.arange(*keys)
            m = np.ones((len(rows), len(k)), bool)
            if kw["causal"]:
                m &= rows[:, None] >= k[None]
            if kw.get("window"):
                m &= rows[:, None] - k[None] < kw["window"]
            if span == "steps":
                got = int(m.sum())
            else:
                assert int(m.sum()) == got
        live += got
    assert live == tattn.attn_live_pairs(sq, sk, **{
        f: kw[f] for f in ("causal", "q_offset", "window") if f in kw})


# ----------------------------------------------------------------------
# Split-KV reads no batch: one query row sums in the same order at any B
# ----------------------------------------------------------------------

@pytest.mark.parametrize("batch", [4, 8])
def test_one_query_row_does_not_depend_on_the_batch(batch):
    """At Sq = 1, H = 2 over 2560 positions the plan splits KV (7 splits
    of 6 blocks).  Row 0's output from ``mma_flash_attention`` on the CPU
    (the split-KV plain version, the card's arithmetic) at batch 1 equals
    the same row inside a batch of 4 and of 8, bit for bit: the plan, and
    so the order of each row's sums, does not depend on B."""
    h, sk, d = 2, 2560, 64
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(13, batch, 1, sk, h, h, d))
    one = tattn.mma_flash_attention(q[:1], k[:1], v[:1], causal=False,
                                    out_dtype=torch.float32)
    many = tattn.mma_flash_attention(q, k, v, causal=False,
                                     out_dtype=torch.float32)
    assert torch.equal(one[0], many[0])
    assert tattn.split_kv_plan(h, 1, sk)[0] > 1


def test_split_kv_plan_reads_no_batch():
    """The plan is a function of (h, sq, sk): whisper's cross-attention
    heads over 1500 encoder positions split the same way for any batch,
    and prefill (sq > 64) or a single KV block never splits."""
    import inspect
    assert list(inspect.signature(tattn.split_kv_plan).parameters) == \
        ["h", "sq", "sk"]
    assert tattn.split_kv_plan(12, 1, 1500) == (4, 6)
    assert tattn.split_kv_plan(2, 1, 2560) == (7, 6)
    assert tattn.split_kv_plan(12, 65, 1500)[0] == 1
    assert tattn.split_kv_plan(12, 1, 64) == (1, 1)


# ----------------------------------------------------------------------
# f32 q, k, v (K2e: the F32GER policy's operands) in both kernel modes
# ----------------------------------------------------------------------

F32_CASES = {
    # tile mode (Sq > 64: no split)
    "tile_causal": ((1, 80, 80, 2, 1), dict(causal=True)),
    "tile_window_offset": ((1, 80, 136, 2, 2),
                           dict(causal=True, window=40, q_offset=64)),
    "tile_valid": ((2, 80, 80, 2, 1), dict(causal=False, valid=True)),
    # split-KV mode (Sq <= 64 over several KV blocks)
    "split_full": ((2, 8, 320, 2, 2), dict(causal=False)),
    "split_causal_offset": ((1, 8, 320, 4, 2),
                            dict(causal=True, q_offset=312)),
    "split_valid_window": ((2, 8, 320, 2, 1),
                           dict(causal=True, q_offset=312, window=100,
                                valid=True)),
}


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", list(F32_CASES))
def test_f32_plain_matches_pallas_in_both_modes(case, d):
    """f32 operands at the kernel's head dims: the wrapper's plain version
    of the mode the card runs (the tile, or split-KV where the plan
    splits) against the reference's interpret-mode kernel on the same f32
    inputs, within 1e-5 (fp32 throughout; P is not rounded); rows with no
    valid slot exact zeros in both."""
    (b, sq, sk, h, kvh), kw = F32_CASES[case]
    kw = dict(kw)
    q, k, v = _qkv(sum(map(ord, case)) + d, b, sq, sk, h, kvh, d)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("valid", False):
        valid = np.ones((b, sk), bool)
        valid[:, : sk // 3] = False
        valid[-1, sk // 2:] = False
        jkw["valid"], tkw["valid"] = jnp.asarray(valid), torch.from_numpy(
            valid)
    n_split, _ = tattn.split_kv_plan(h, sq, sk)
    assert (n_split > 1) == case.startswith("split")
    want = np.asarray(jattn.mma_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        block_q=8 if sq <= 8 else 16, block_k=64 if sk % 64 == 0 else 8,
        out_dtype=jnp.float32, interpret=True, **jkw))
    got = tattn.mma_flash_attention(_t(q), _t(k), _t(v),
                                    out_dtype=torch.float32, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.array_equal(got == 0, want == 0) or not np.any(want == 0)


@pytest.mark.parametrize("batch", [4, 8])
def test_f32_one_query_row_does_not_depend_on_the_batch(batch):
    """The f32 split-KV arithmetic reads no batch either: row 0 at batch 1
    equals the same row inside a batch of 4 and of 8, bit for bit."""
    h, sk, d = 2, 2560, 64
    q, k, v = (torch.from_numpy(a) for a in _qkv(17, batch, 1, sk, h, h, d))
    one = tattn.mma_flash_attention(q[:1], k[:1], v[:1], causal=False,
                                    out_dtype=torch.float32)
    many = tattn.mma_flash_attention(q, k, v, causal=False,
                                     out_dtype=torch.float32)
    assert torch.equal(one[0], many[0])
    assert tattn.split_kv_plan(h, 1, sk)[0] > 1


def test_f32_rounding_budget_has_no_p_rounding_term():
    """rounding_budget for f32 operands keeps only fp32 rounding (P is not
    rounded to v's dtype): (D + 8) * 2^-24 of the oracle on |v|."""
    q, k, v = (_t(a) for a in _qkv(18, 1, 8, 64, 2, 2, 32))
    budget = tattn.rounding_budget(q, k, v, causal=False)
    mean_abs = tattn.ref_attention(q, k, v.abs(), causal=False)
    assert torch.allclose(budget, (32 + 8) * 2.0 ** -24 * mean_abs)
    assert tattn.KERNEL_DTYPES[torch.float32] == 0


def _tf32(t):
    """t rounded to TF32 (10 mantissa bits, to nearest): the operands a
    TF32 tensor-core product reads."""
    i = t.view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16_p(q, k, v, causal):
    """ref_attention with each normalised weight rounded to bf16."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    if causal:
        sq, sk = s.shape[-2:]
        live = torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
        s = torch.where(live, s, torch.full_like(s, tattn.NEG_INF))
    p = torch.softmax(s, -1).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal", [(1, 1500, False), (8, 900, False),
                                          (64, 64, True)])
def test_f32_rounding_budget_separates_fp32_from_tf32_and_bf16_p(
        sq, sk, causal, d):
    """The f32 budget admits fp32 arithmetic in another order (the split-KV
    plain version against the one-shot plain version) and refuses a
    variant with TF32 scores or with P rounded to bf16: the control that
    it would catch a kernel computing S or P below fp32."""
    q, k, v = (_t(a) for a in _qkv(19 + d, 2, sq, sk, 2, 2, d))
    kw = dict(causal=causal, out_dtype=torch.float32)
    plain = tattn.flash_attention_plain(q, k, v, **kw)
    tol = (tattn.rounding_budget(q, k, v, causal=causal)
           + 2.0 ** -20 * plain.abs().max())

    def ratio(got):
        return ((got - plain).abs() / tol).max().item()

    per = -(-sk // tattn.BLOCK_K) // 4 or 1
    n_split = -(-(-(-sk // tattn.BLOCK_K)) // per)
    assert ratio(tattn.flash_attention_splitkv_plain(
        q, k, v, n_split=n_split, per=per, **kw)) <= 1
    assert ratio(tattn.flash_attention_plain(_tf32(q), _tf32(k), v,
                                             **kw)) > 2
    assert ratio(_bf16_p(q, k, v, causal)) > 2


# ----------------------------------------------------------------------
# K2d: the full rectangular grid, mma_flash_attention(bound_grid=False)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype,kw", [
    ("f32", dict(causal=True)),
    ("f32", dict(causal=True, window=64)),
    ("bf16", dict(causal=True)),
], ids=["f32-causal", "f32-window", "bf16-causal"])
def test_full_grid_matches_reference(dtype, kw):
    """The reference's own cases (tests/test_quant_attention.py): at (1,
    256, 2, 32) the full grid walks all 16 (q, k) block steps of 64, the
    bounded causal one 10 (fewer under the window), and both give the
    same output; the port's bound_grid=False matches the reference's
    (f32 within 1e-5, bf16 within 2^-7 max|v| as test_bf16_plain_matches
    _pallas states) and equals its own bounded call bit for bit."""
    q, k, v = _qkv(11, 1, 256, 256, 2, 2, 32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jattn.mma_flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), block_q=64, block_k=64,
        bound_grid=False, out_dtype=jnp.float32, interpret=True, **kw))
    tq, tk, tv = (_t(a).to(tdt) for a in (q, k, v))
    full = tattn.mma_flash_attention(tq, tk, tv, bound_grid=False,
                                     out_dtype=torch.float32, **kw)
    bounded = tattn.mma_flash_attention(tq, tk, tv,
                                        out_dtype=torch.float32, **kw)
    assert torch.equal(full, bounded)
    tol = 1e-5 if dtype == "f32" else 2.0 ** -7 * np.abs(v).max()
    np.testing.assert_allclose(full.numpy(), want, rtol=tol, atol=tol)
    steps = {bound: tattn.attn_grid_plan(256, 256, 64, 64, bound=bound,
                                         **kw).shape[1]
             for bound in (True, False)}
    assert steps == {bound: jattn.attn_grid_plan(256, 256, 64, 64,
                                                 bound=bound, **kw).shape[1]
                     for bound in (True, False)}
    assert steps[False] == 16
    assert steps[True] == (10 if "window" not in kw else
                           tattn.attn_live_steps(256, 256, 64, 64, **kw))


@pytest.mark.parametrize("kw", [dict(causal=True, q_offset=200),
                                dict(causal=False, q_offset=1000,
                                     window=300)],
                         ids=["causal", "window"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_grid_split_kv(kw, dtype):
    """Split-KV (Sq <= 64) on the full grid: the splits partition all
    ceil(Sk / 64) blocks.  Causal, the live range starts at block 0, so
    the live blocks fall into the same splits and the splits past the
    diagonal hold only dead blocks, which weigh 0: bit for bit the bounded
    launch.  Under a window the live range starts later, the splits group
    it otherwise and round P against other maxima: within twice the
    kernel's rounding budget of the bounded launch, each within the budget
    of the oracle."""
    q, k, v = _qkv(12, 2, 4, 1024, 4, 2, 32)
    tq, tk, tv = (_t(a).to(dtype) for a in (q, k, v))
    f32 = dtype == torch.float32
    _, n_split, per = tattn.attn_plan(2, 4, 4, 1024, 32, f32)
    assert n_split > 1
    full = tattn.mma_flash_attention(tq, tk, tv, bound_grid=False,
                                     out_dtype=torch.float32, **kw)
    bounded = tattn.mma_flash_attention(tq, tk, tv,
                                        out_dtype=torch.float32, **kw)
    budget = tattn.rounding_budget(tq, tk, tv, **kw)
    oracle = tattn.ref_attention(tq, tk, tv, **kw)
    assert bool(((full - oracle).abs() <= budget).all())
    if "window" in kw:
        assert bool(((full - bounded).abs() <= 2 * budget).all())
    else:
        assert torch.equal(full, bounded)
    assert torch.equal(full, tattn.flash_attention_splitkv_plain(
        tq, tk, tv, n_split=n_split, per=per, bound_grid=False,
        out_dtype=torch.float32, **kw))


def test_full_grid_under_autograd():
    """The autograd Function hands bound_grid to the forward (the
    backward differentiates the torch lowering, which has no schedule):
    the same output and gradients as the bounded call."""
    q, k, v = _qkv(13, 1, 64, 64, 2, 2, 16)
    grads = []
    for bound in (True, False):
        tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
        out = tattn.mma_flash_attention(tq, tk, tv, causal=True,
                                        bound_grid=bound)
        out.square().sum().backward()
        grads.append((out.detach(), tq.grad, tk.grad, tv.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ----------------------------------------------------------------------
# The split-KV decode kernel and the fp32 tile (csrc/mma_attention.cu
# flash_decode_kernel, flash_f32_tile_kernel) mirrored in pure Python:
# their shared memory, the split plan's partition and the fp32 tile's
# 32-key steps; the plain versions of both modes at the plan's edges
# ----------------------------------------------------------------------

# Shared memory each of two resident blocks may take (the SM's 228 KB
# less 1 KB reserved a block).
SMEM_TWO_A_SM = 115712


def decode_config(d, itemsize):
    """``DecodeCfg<T, D>``: four warps over one 64-row q tile; K and V
    rows padded by 16 bytes; fp32 Q staged in shared memory; a ring of
    2-3 stages of one 64-key block, as deep as two blocks an SM allow,
    else one block an SM; the four warps' (16, D + 2) fp32 partials and
    the split's (up to 64, D + 2) alias the ring after the loop."""
    f32 = itemsize == 4
    ldk = d + 4 if f32 else d + 8
    q_bytes = 4 * 64 * (d + 4) if f32 else 0
    stage = 2 * 64 * ldk * itemsize
    fit2 = int((SMEM_TWO_A_SM - q_bytes) / stage)   # C++ truncation
    min_blocks = 2 if fit2 >= 2 else 1
    fit = fit2 if min_blocks == 2 else int((BLOCK_SMEM_MAX - q_bytes)
                                           / stage)
    stages = min(3, fit)
    return dict(stages=stages, min_blocks=min_blocks,
                smem=q_bytes + stages * stage, ring=stages * stage,
                partials=2 * 64 * (d + 2) * 4)


def f32_tile_config(d, rw):
    """``F32TileCfg<D, RW>``: eight warps of ``rw`` query rows, steps of
    ``kv_step`` keys (64; 32 at D = 160); S's lane grid: step / 4 lanes
    across the keys (4 keys a lane), the rest across the warp's rows; the
    Q tile (rows unpadded), each warp's (step, rw) P and rw corrections,
    and a ring of 2-3 K and V steps (K rows D + 4 floats, V rows D), as
    deep as two blocks an SM allow, else one block an SM."""
    step = tattn.kv_step(d, True, 1)
    bq, kg = 8 * rw, step // 4
    stage = 4 * step * (2 * d + 4)
    base = 4 * (bq * d + 8 * step * rw + 8 * rw)
    fit2 = int((SMEM_TWO_A_SM - base) / stage)
    min_blocks = 2 if fit2 >= 2 else 1
    fit = fit2 if min_blocks == 2 else int((BLOCK_SMEM_MAX - base) / stage)
    stages = min(3, fit)
    return dict(bq=bq, stages=stages, min_blocks=min_blocks,
                smem=base + stages * stage, step=step,
                s_tile=(rw // (32 // kg), 4))


@pytest.mark.parametrize("d,itemsize", [(d, 2) for d in
                                        tattn.KERNEL_HEAD_DIMS]
                         + [(d, 4) for d in tattn.F32_HEAD_DIMS])
def test_decode_configs_fit_shared_memory(d, itemsize):
    """Each compiled decode configuration fits a block's 227 KB, its
    resident blocks an SM's 228 KB with 1 KB reserved each; two or three
    stages; the warps' and the split's partials fit in the ring they
    alias.  16-bit
    operands at D <= 128 and fp32 at D <= 64 run two blocks an SM."""
    cfg = decode_config(d, itemsize)
    assert cfg["stages"] in (2, 3)
    assert cfg["smem"] <= BLOCK_SMEM_MAX
    assert cfg["min_blocks"] * (cfg["smem"] + BLOCK_SMEM_RESERVED) \
        <= SM_SMEM
    assert cfg["partials"] <= cfg["ring"]
    assert cfg["min_blocks"] == (2 if d <= (128 if itemsize == 2 else 64)
                                 or (itemsize == 2 and d == 192) else 1)


@pytest.mark.parametrize("d,rw", [(d, rw) for d in tattn.F32_HEAD_DIMS
                                  for rw in (8, 16)])
def test_f32_tile_configs_fit_shared_memory(d, rw):
    """Each fp32 tile (128 rows: rw = 16; 64 rows: rw = 8) fits a block's
    227 KB and its resident blocks an SM's 228 KB; two or three stages,
    two blocks an SM where a 128-register thread fits them; S's lane tile
    is 8 x 4 on the 128-row tile at D <= 128 (64-key steps), 4 x 4 on its
    64-row tile; the wrapper runs both tiles at every fp32 depth, in the
    tile mode only (split-KV runs the decode kernel)."""
    cfg = f32_tile_config(d, rw)
    assert cfg["smem"] <= BLOCK_SMEM_MAX
    assert cfg["min_blocks"] * (cfg["smem"] + BLOCK_SMEM_RESERVED) \
        <= SM_SMEM
    assert cfg["stages"] in (2, 3)
    assert cfg["step"] == (64 if d <= 128 else 32)
    if d <= 128:
        assert cfg["s_tile"] == ((8, 4) if rw == 16 else (4, 4))
    if d == 128:
        assert cfg["min_blocks"] == 1
    # the 128-row tile where its tiles fill the card, at depths 128 and
    # 160 (below, the 64-row tile holds two blocks an SM)
    assert tattn.attn_block_q(4, 32, 512, d, True) == (128 if d >= 128
                                                        else 64)
    assert tattn.attn_block_q(1, 32, 256, d, True) == 64
    assert tattn.attn_takes((cfg["bq"], 1), 512, 512, d, True)
    assert not tattn.attn_takes((128, 2), 1, 1500, d, True)


@pytest.mark.parametrize("sq,sk,kw", [
    (256, 256, dict(causal=True)),
    (300, 300, dict(causal=True, window=100)),
    (100, 356, dict(causal=True, q_offset=256)),
    (200, 333, dict(causal=False)),
    (512, 512, dict(causal=True)),
])
@pytest.mark.parametrize("bq", [64, 128])
def test_f32_steps_hold_the_same_live_pairs(sq, sk, kw, bq):
    """The fp32 tile's steps of 32 keys (its depth 160), attn_k_bounds at
    bk = 32, cover the tile's live range of 64-key blocks (its steps at
    D <= 128): every live (q, k) pair of a tile lies in its steps, none
    past them, and the steps are no more than the 64-key blocks'."""
    assert tattn.kv_step(128, True, 1) == tattn.BLOCK_K
    step, nq = tattn.kv_step(160, True, 1), -(-sq // bq)
    for qi in range(nq):
        lo, hi = tattn.attn_k_bounds(qi, -(-sk // step), bq=bq, bk=step,
                                     **kw)
        lo64, hi64 = tattn.attn_k_bounds(qi, -(-sk // 64), bq=bq, bk=64,
                                         **kw)
        assert lo64 * 64 <= lo * step and hi * step <= hi64 * 64
        rows = np.arange(qi * bq, min(sq, (qi + 1) * bq)) + kw.get(
            "q_offset", 0)
        k = np.arange(sk)
        m = np.ones((len(rows), sk), bool)
        if kw["causal"]:
            m &= rows[:, None] >= k[None]
        if kw.get("window"):
            m &= rows[:, None] - k[None] < kw["window"]
        inside = (k >= lo * step) & (k < hi * step)
        assert not m[:, ~inside].any()


_SPLIT_PLANS = [(12, 1, 1500), (12, 4, 1500), (32, 1, 4096), (2, 1, 2560),
                (8, 64, 700), (4, 20, 272), (33, 1, 1500), (1, 1, 65),
                (40, 2, 300), (12, 1, 64)]


@pytest.mark.parametrize("h,sq,sk", _SPLIT_PLANS)
def test_split_plan_puts_every_key_in_one_split(h, sq, sk):
    """split_kv_plan's splits partition the KV blocks: each of the
    ceil(Sk / 64) blocks (each key) lies in exactly one split, no split is
    empty, each walks at least SPLIT_MIN_BLOCKS blocks (or half of them
    where there are fewer than twice that), and a query of at most 64
    rows over two or more blocks splits."""
    n_split, per = tattn.split_kv_plan(h, sq, sk)
    nk = -(-sk // tattn.BLOCK_K)
    owner = [s for s in range(n_split) for _ in range(per)][:nk]
    assert len(owner) == nk
    assert sorted(set(owner)) == list(range(n_split))
    keys = np.repeat(owner, tattn.BLOCK_K)[:sk]
    assert len(keys) == sk and np.all(np.diff(keys) >= 0)
    if n_split > 1:
        assert sq <= tattn.BLOCK_Q_SHORT
        assert per >= min(tattn.SPLIT_MIN_BLOCKS, -(-nk // 2))
    else:
        assert per == nk and (sq > tattn.BLOCK_Q_SHORT or nk < 2)
    assert tattn.attn_plan(3, h, sq, sk, 64, False)[1:] == (n_split, per)
    assert tattn.attn_plan(7, h, sq, sk, 64, True)[1:] == (n_split, per)


# (name, (B, Sq, Sk, H, KVH), flags): the edges of the split plan and of
# the fp32 tile's
_EDGE_CASES = {
    "split Sq=1 Sk=600": ((2, 1, 600, 4, 4), dict(causal=False)),
    "split Sq=4 gqa 4": ((2, 4, 520, 8, 2), dict(causal=False)),
    "split Sq=64 causal q_offset": ((1, 64, 400, 4, 4),
                                    dict(causal=True, q_offset=336)),
    "split Sq=20 window q_offset": ((1, 20, 700, 4, 1),
                                    dict(causal=True, q_offset=680,
                                         window=250)),
    "split Sq=1 valid": ((2, 1, 344, 4, 2), dict(causal=False, valid=True)),
    "tile Sq=100 gqa 4 valid": ((2, 100, 100, 8, 2),
                                dict(causal=True, valid=True)),
    "tile window q_offset": ((1, 72, 200, 4, 4),
                             dict(causal=True, q_offset=128, window=50)),
}


def _divisor(n, most):
    """The largest power of two up to ``most`` that divides ``n`` (the
    reference's blocks must divide S)."""
    b = most
    while n % b:
        b //= 2
    return b


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("case", list(_EDGE_CASES))
def test_plain_versions_match_pallas_at_the_plan_edges(case, dtype):
    """The plain version of the mode the card runs (split-KV where the
    plan splits, else the tile) against the reference's interpret-mode
    kernel on the same inputs, bf16 and f32, at D = 32: each output within
    twice the rounding budget (both round P against running or split
    maxima: each within the budget of the exact result); rows with no
    valid slot exact zeros in both."""
    (b, sq, sk, h, kvh), kw = _EDGE_CASES[case]
    kw = dict(kw)
    d = 32
    q, k, v = _qkv(sum(map(ord, case)), b, sq, sk, h, kvh, d)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("valid", False):
        valid = np.ones((b, sk), bool)
        valid[0] = False
        valid[-1, 70:200] = False
        jkw["valid"], tkw["valid"] = jnp.asarray(valid), torch.from_numpy(
            valid)
    n_split, per = tattn.split_kv_plan(h, sq, sk)
    assert (n_split > 1) == case.startswith("split")
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jattn.mma_flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)),
        block_q=_divisor(sq, 16), block_k=_divisor(sk, 64),
        out_dtype=jnp.float32, interpret=True, **jkw))
    tq, tk, tv = (_t(a).to(tdt) for a in (q, k, v))
    got = tattn.mma_flash_attention(tq, tk, tv, out_dtype=torch.float32,
                                    **tkw)
    if n_split > 1:
        assert torch.equal(got, tattn.flash_attention_splitkv_plain(
            tq, tk, tv, n_split=n_split, per=per, out_dtype=torch.float32,
            **tkw))
    flags = {f: tkw[f] for f in ("causal", "q_offset", "window", "valid")
             if f in tkw}
    budget = tattn.rounding_budget(tq, tk, tv, **flags).numpy()
    assert np.all(np.abs(got.numpy() - want) <= 2 * budget + 1e-6)
    if "valid" in kw or "valid" in tkw:
        assert np.all(got[0].numpy() == 0) and np.all(want[0] == 0)
