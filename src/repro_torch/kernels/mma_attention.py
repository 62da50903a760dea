"""Flash attention: the wrapper of the Hopper kernel, its plain version, the
host-side block schedule and the oracle (port of
``repro.kernels.mma_attention``, TPU kernel K2).

The kernel is ``csrc/mma_attention.cu``; its head comment says which TPU
kernel it replaces (``repro/kernels/mma_attention.py``,
``mma_flash_attention``), what bounds it on an H100 (the bf16 tensor cores
for prefill past a few hundred tokens, bytes for one query over a long
cache) and what its design does about that.  The 16-bit tile mode runs
persistent blocks (``flash_tile_kernel``): at most as many as the card
holds at once, walking a static list of (b, h, q tile) tiles (head by
head, the longest first within a head when causal, in rounds of the
block count taken alternately forwards and backwards) on TMA loads and
wgmma, its producer loading the next tile's Q and first K/V steps while
the consumers finish the current one, its two consumer warpgroups (the
128-row tile; 64 rows where 128-row tiles leave SMs idle) taking turns
on the tensor cores, and the output stored from registers through shared
memory in 16-byte rows where there is no epilogue.  It walks steps of
:func:`kv_step` keys (128 at D <= 128, 64 at the padded 192) aligned to
multiples of the step: :func:`attn_k_bounds` at ``bk`` = the step, which
is the bounds at 64 widened to that alignment.  Short queries (Sq <= 64)
split their KV blocks of 64 over several blocks of one launch
(:func:`split_kv_plan`; ``flash_decode_kernel``, every input type): four
warps a block stream the split's blocks through a ``cp.async`` ring,
16-row slices on ``mma.sync`` (fp32: the same fragments on true fp32
FMAs), the warps of one slice splitting each block's keys; their partials
merge inside the block in warp order, and the splits' partials merge by
log-sum-exp in split order in the same launch: the (at most
:data:`DECODE_CLUSTER_MAX`) splits of a (b, h) are one thread-block
cluster, whose first block merges them through shared memory.  f32 q, k
and v (K2e: the F32GER policy's operands) in the tile mode run the fp32
tile (``flash_f32_tile_kernel``): true fp32 FMAs, eight warps of 16 query
rows (the 128-row tile) or 8 (the 64-row tile, where 128-row tiles leave
SMs idle) walking steps of :func:`kv_step` keys (64; 32 at depth 160),
S in 8 x 4 (128-row tile) or 4 x 4 register tiles a lane, P kept in
fp32.  :func:`attn_plan` picks the q tile
and the split: an autotune winner or an explicit tile where the kernel
runs it (``core/autotune.py``, keyed by heads and never by the batch),
else that heuristic.

A CPU tensor goes to the plain version of what the card would run:
:func:`flash_attention_splitkv_plain` (per-split partials and their
merge) where :func:`split_kv_plan` splits, else
:func:`flash_attention_plain` (the two-product softmax of
:func:`ref_attention` plus the epilogue).  A CUDA tensor launches the
kernel or raises.  ``mma_flash_attention.launches`` counts attention
calls run on the card (the split-KV merge is part of its launch), and
nothing else; ``mma_flash_attention.launches_by_mode`` the same by mode:
``tile`` (the 16-bit wgmma tile), ``split`` (the decode kernel on 16-bit
operands), ``f32_tile`` (the fp32 tile, K2e) and ``f32_split`` (the
decode kernel on fp32 operands); ``padded_launches_by_mode`` those of
them whose depth was padded; ``full_grid_launches`` those that ran the
full grid.

The full grid (K2d: the reference's ``mma_flash_attention(bound_grid=
False)``): ``bound_grid=False`` has every q tile walk every step of the
KV sequence, :func:`attn_grid_plan`'s ``bound=False`` schedule, the
baseline the bounded causal/window schedule is measured against.  A step
with no live slot leaves the running max, sum and accumulator untouched
(the kernel's masked-block guard), so in the tile modes the full grid is
the bounded launch bit for bit, as the reference's test holds its two
grids; so is a row's result on the 64-row and the 128-row tile, at any
batch and in any block.
In the split-KV modes the splits partition [0, nk) where the bounded
launch partitions the live range [lo, hi) into the same ``per`` blocks a
split.  Where lo = 0 (no window, or a window that reaches block 0) the
live blocks fall into the same splits, the blocks past hi only add dead
blocks or dead splits, so the result is again the bounded launch's bit for
bit.  Where the window starts later the live blocks group otherwise: each
split rounds P against its own running max and the partials merge in
another grouping, so the two launches differ within their rounding budgets
(each is within :func:`rounding_budget` of the oracle, so they differ by
at most twice it), not bit for bit.  A split that holds only dead blocks
has m = -inf and l = 0, and weighs 0 in the merge.
:func:`flash_attention_plain` takes the flag and, running no schedule,
ignores it; :func:`flash_attention_splitkv_plain` partitions as the
kernel does.  No ``Plan`` field or ``contract`` option reaches it, as
in the reference: it is an argument of the kernel API.

Head depths: the kernel is compiled for D = 32, 64, 128 and 192 (16-bit)
or 32, 64, 128 and 160 (fp32) (:data:`KERNEL_HEAD_DIMS`).  Any other D up
to the largest runs every mode at the next compiled depth: the wrapper
zero-pads q, k and v (and the epilogue's bias and residual), which leaves
every score unchanged, passes the softmax scale of the *logical* depth D
(never the padded one), and drops the padded output columns.  This is the
depth ABFT's attention check gives (``core/abft.py`` adds one checksum
column: deepseek's 128 becomes 129, run at 192; whisper's 64 becomes 65,
run at 128), whose q the reference pre-scales by sqrt((D + 1) / D) on
exactly that assumption.

Gradients: where q, k, v, bias or the residual requires one, the call
runs as a ``torch.autograd.Function``: the forward is the kernel (or the
plain version on the CPU), the backward differentiates a recomputation
through the torch lowering (``core.lowering.torch_attention``; no TPU
backward kernel exists, see ``kernels._autograd``) and launches nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.tiling import NUM_SMS
from repro_torch.kernels import _autograd, _build
from repro_torch.kernels import epilogue as _epilogue

NEG_INF = -1e30

# The kernel's tiles (csrc/mma_attention.cu): 128 query rows (two consumer
# warpgroups, or eight fp32 warps of 16; 64 where the grid would not fill
# the card, and the split-KV kernel's one q tile) by 64 KV rows, the
# schedule's unit (the 16-bit tile mode walks steps of two of them at
# D <= 128, the fp32 tile steps of one, half of one at its depth 160:
# kv_step).
BLOCK_Q, BLOCK_Q_SHORT, BLOCK_K = 128, 64, 64
TILE_STEP, F32_STEP, F32_STEP_160 = 128, 64, 32
# The fewest KV blocks of 64 a split walks (split_kv_plan), and the most
# splits of a (b, h), which merge as one thread-block cluster
# (csrc/mma_attention.cu's DEC_CLUSTER_MAX, the portable cluster size).
SPLIT_MIN_BLOCKS, DECODE_CLUSTER_MAX = 6, 8
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MODES = ("tile", "split", "f32_tile", "f32_split")
# The depths the kernel is compiled for, by operand dtype (the 16-bit
# wgmma kernel; the fp32 tile, whose 192 would not fit shared memory).
KERNEL_HEAD_DIMS = (32, 64, 128, 192)
F32_HEAD_DIMS = (32, 64, 128, 160)
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


# ----------------------------------------------------------------------
# Grid plan: the bounded (qi, ki) block schedule (pure, host-side)
# ----------------------------------------------------------------------

def attn_k_bounds(qi: int, nk: int, *, bq: int, bk: int, causal: bool,
                  q_offset: int = 0, window: int | None = None
                  ) -> tuple[int, int]:
    """[k_lo, k_hi) — KV block range with any structurally-live slot for
    query block ``qi``.  Causal bounds above (no block past the diagonal
    of the last row), the sliding window bounds below (no block whose last
    slot is already outside the first row's window).  Always non-empty:
    a fully-masked query block still runs one (masked) step so its output
    tile is deprimed (to zeros, via the masked-block guard).  The CUDA
    kernel computes the same bounds per block."""
    hi = nk
    if causal:
        hi = min(nk, -(-(q_offset + (qi + 1) * bq) // bk))
        hi = max(hi, 1)
    lo = 0
    if window is not None:
        lo = max(0, (q_offset + qi * bq - (window - 1)) // bk)
        lo = min(lo, hi - 1)
    return lo, hi


def attn_live_steps(sq: int, sk: int, bq: int, bk: int, *, causal: bool,
                    q_offset: int = 0, window: int | None = None) -> int:
    """Total (qi, ki) block steps the bounded schedule runs."""
    nq, nk = -(-sq // bq), -(-sk // bk)
    total = 0
    for qi in range(nq):
        lo, hi = attn_k_bounds(qi, nk, bq=bq, bk=bk, causal=causal,
                               q_offset=q_offset, window=window)
        total += hi - lo
    return total


def attn_live_pairs(sq: int, sk: int, *, causal: bool, q_offset: int = 0,
                    window: int | None = None) -> int:
    """Position-level live (q, k) pair count — the useful-FLOPs numerator
    of the roofline model (block-level padding is charged separately)."""
    q_pos = np.arange(sq) + q_offset
    hi = np.minimum(sk, q_pos + 1) if causal else np.full(sq, sk)
    lo = np.clip(q_pos - (window - 1), 0, sk) if window is not None \
        else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def attn_grid_plan(sq: int, sk: int, bq: int, bk: int, *, causal: bool,
                   q_offset: int = 0, window: int | None = None,
                   bound: bool = True) -> np.ndarray:
    """The block schedule as a (4, T) int32 array with rows ``qi``, ``ki``,
    ``first`` (this step primes qi's accumulator) and ``last`` (this step
    deprimes).  The kernel walks the same live steps, one q block per
    thread block; ``bound=False`` is the full rectangular schedule."""
    nq, nk = -(-sq // bq), -(-sk // bk)
    rows = []
    for qi in range(nq):
        lo, hi = (attn_k_bounds(qi, nk, bq=bq, bk=bk, causal=causal,
                                q_offset=q_offset, window=window)
                  if bound else (0, nk))
        for ki in range(lo, hi):
            rows.append((qi, ki, int(ki == lo), int(ki == hi - 1)))
    return np.asarray(rows, np.int32).T


def kv_step(d: int, f32: bool, n_split: int) -> int:
    """Keys a step of the kernel's KV loop at compiled depth ``d``: 128 in
    the 16-bit tile mode at D <= 128 (S a 64 x 128 wgmma tile beside O in
    the registers), 64 on the fp32 tile (32 at its depth 160, whose 64-key
    steps would not fit shared memory), else 64 (D = 192, split-KV)."""
    if n_split > 1:
        return BLOCK_K
    if f32:
        return F32_STEP if d <= 128 else F32_STEP_160
    return TILE_STEP if d <= 128 else BLOCK_K


def attn_block_q(b: int, h: int, sq: int, d: int, f32: bool) -> int:
    """The q tile: 128 rows, or 64 where 128-row tiles leave SMs idle.
    The fp32 tile below its compiled depth 128 always takes 64 rows: there
    the 64-row tile holds two blocks an SM, the 128-row one a single block
    of 8 warps (the 64-row tile was the faster at whisper's encoder)."""
    if f32 and compiled_depth(d, True) < 128:
        return BLOCK_Q_SHORT
    return BLOCK_Q if -(-sq // BLOCK_Q) * b * h >= NUM_SMS else BLOCK_Q_SHORT


def split_kv_plan(h: int, sq: int, sk: int) -> tuple[int, int]:
    """(n_split, KV blocks per split) of a launch.  Queries of at most 64
    rows (one q tile) split their KV blocks so that one batch element's
    (h, split) blocks would fill the card twice over, but each split walks
    at least :data:`SPLIT_MIN_BLOCKS` blocks (384 keys), or half the
    blocks where there are fewer than twice that: a block's fixed costs
    (its Q, the ring's first round trip, the partial it writes and the
    merge's read of it) are paid over a few blocks' bytes, which the
    decode kernel's ring keeps in flight.  A (b, h) takes at most
    :data:`DECODE_CLUSTER_MAX` splits (the cluster that merges them),
    longer ones past that.  Each split walks ``per`` consecutive blocks
    of the tile's live range.  Otherwise (1, all
    blocks).  The plan does not read the batch: a query row is summed in
    the same order at any B (a larger batch runs more blocks), as the
    reference's kernel schedules each (b, h, q-block) alike."""
    nk = -(-sk // BLOCK_K)
    if sq > BLOCK_Q_SHORT or nk < 2:
        return 1, nk
    per = max(min(SPLIT_MIN_BLOCKS, -(-nk // 2)),
              -(-nk // max(1, 2 * NUM_SMS // h)),
              -(-nk // DECODE_CLUSTER_MAX))
    return -(-nk // per), per


def compiled_depth(d: int, f32: bool) -> int | None:
    """The depth a launch at head dim ``d`` runs (the next compiled one),
    or None above the largest."""
    depths = F32_HEAD_DIMS if f32 else KERNEL_HEAD_DIMS
    return next((c for c in depths if c >= d), None)


def attn_takes(tuned: tuple, sq: int, sk: int, d: int, f32: bool) -> bool:
    """Whether the kernel runs the winner ``tuned`` = (bq, n_split) at
    this shape: a compiled q tile (128 rows only in the tile modes, and
    not at the 16-bit padded depth 192), and KV split over 1 to
    ceil(Sk / 64) blocks and at most :data:`DECODE_CLUSTER_MAX` splits,
    more than one only for queries of at most 64 rows (the split-KV
    kernel's one 64-row q tile)."""
    bq, n = tuned
    nk = -(-sk // BLOCK_K)
    dp = compiled_depth(d, f32)
    if dp is None or bq not in (BLOCK_Q, BLOCK_Q_SHORT) \
            or not 1 <= n <= min(max(nk, 1), DECODE_CLUSTER_MAX):
        return False
    if n > 1 and sq > BLOCK_Q_SHORT:
        return False
    return bq == BLOCK_Q_SHORT or (n == 1 and (f32 or dp != 192))


def attn_plan(b: int, h: int, sq: int, sk: int, d: int, f32: bool,
              tuned: tuple | None = None) -> tuple[int, int, int]:
    """(bq, n_split, per) of a launch: the q tile, the KV split and the KV
    blocks a split walks.  ``tuned`` = (bq, n_split) (an autotune winner,
    or an explicit ``Plan.block``'s tile with n_split None: the
    heuristic's split) where the kernel takes it (:func:`attn_takes`);
    else the heuristic: :func:`split_kv_plan`'s split, and the 64-row
    tile where KV splits and at the 16-bit padded depth 192 (whose 128-row
    tile would spill its accumulators), else :func:`attn_block_q`'s (the
    fp32 tile's rows sum alike on both tiles, so its choice by batch moves
    no bit).  A split count is rounded to the one its per-split block
    count gives (ceil(nk / ceil(nk / n)))."""
    if tuned is not None and tuned[1] is None:
        tuned = (tuned[0], split_kv_plan(h, sq, sk)[0])
    if tuned is not None and attn_takes(tuned, sq, sk, d, f32):
        nk = max(1, -(-sk // BLOCK_K))
        per = -(-nk // tuned[1])
        return tuned[0], -(-nk // per), per
    n_split, per = split_kv_plan(h, sq, sk)
    short = n_split > 1 or (not f32 and compiled_depth(d, f32) == 192)
    return (BLOCK_Q_SHORT if short else attn_block_q(b, h, sq, d, f32),
            n_split, per)


# ----------------------------------------------------------------------
# The oracle and the plain versions
# ----------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, KVH * n_rep, D), each KV head repeated over
    its GQA group (the plain versions and the eager decode path; the
    kernel indexes KV head h // group instead)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def ref_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                  q_offset: int = 0, valid: torch.Tensor | None = None):
    """Two-product oracle on (B, S, H, D) operands; returns the fp32
    result.  Scores in fp32, softmax in fp32, the value product on P
    rounded to v's dtype with fp32 accumulation.  Rows whose every slot is
    masked yield exact zeros — the facility's fully-masked-row
    convention."""
    b, sq, h, d = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    k = repeat_kv(k, h // kvh)
    v = repeat_kv(v, h // kvh)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d ** -0.5)
    q_pos = (torch.arange(sq, device=q.device) + q_offset)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos >= k_pos)[None]
    if window is not None:
        mask = mask & (q_pos - k_pos < window)[None]
    if valid is not None:
        mask = mask & valid.to(torch.bool).reshape(-1, 1, sk)
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None, :, None], p, torch.zeros_like(p))
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())


def flash_attention_plain(q, k, v, *, causal: bool = True, q_offset: int = 0,
                          window: int | None = None, valid=None,
                          ep: _epilogue.Epilogue | None = None, bias=None,
                          residual=None, out_dtype=None,
                          bound_grid: bool = True):
    """The plain version of the kernel: the oracle's two-product softmax,
    then the epilogue on the normalised fp32 output, then the cast.  It
    runs no block schedule, so ``bound_grid`` changes nothing (the kernel's
    full grid gives its bounded result: the module docstring)."""
    out = ref_attention(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, valid=valid)
    out = _epilogue.apply(out, ep, bias=bias, residual=residual)
    return out.to(out_dtype or q.dtype)


def rounding_budget(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    window: int | None = None, valid=None,
                    ep: _epilogue.Epilogue | None = None):
    """Per-output bound, in fp32, on |kernel - plain version| before the
    final cast.  Both round each softmax weight p_i to v's dtype once --
    the kernel unnormalised against its running max, the plain versions
    normalised or against a split's max -- so each rounded weight is
    within u * p_i of the exact one (u = 2^-8 for bf16, 2^-11 for f16)
    and an output moves by at most 2u * sum_i p_i |v_i|: 2u times the
    oracle on |v|, plus 2^-12 of it for the fp32 scores, exponentials and
    sums in another order (a score off by D * 2^-24 * sum_d |q_d k_d| /
    sqrt(D), below 2^-14 relative at unit inputs and D = 128).  f32
    operands round no weight (P stays fp32), so only fp32 arithmetic in
    another order is left: (D + 8) * 2^-24 of the oracle on |v| -- D
    units for the scores (a sum of D products in two orders, at unit-scale
    scores), 4 for exp2f's two ulps and 4 for the sums over the keys.
    TF32 products (2^-11 relative a factor) or P rounded to bf16 land
    hundreds of such units away.  Times 1.13 (the largest slope of gelu
    and silu) under an activation.  A fully masked row has a budget of
    0."""
    u = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}.get(v.dtype)
    fp32 = 2.0 ** -12 if u else (q.shape[-1] + 8) * 2.0 ** -24
    slope = 1.13 if ep is not None and ep.activation is not None else 1.0
    mean_abs = ref_attention(q, k, v.abs(), causal=causal, window=window,
                             q_offset=q_offset, valid=valid)
    return (2 * (u or 0.0) + fp32) * slope * mean_abs


def _live_mask(sq, sk, k0, k1, *, causal, window, q_offset, valid, device):
    """(1|B, Sq, k1 - k0) predicate of slots k0..k1-1, as ref_attention's."""
    q_pos = (torch.arange(sq, device=device) + q_offset)[:, None]
    k_pos = torch.arange(k0, k1, device=device)[None, :]
    mask = torch.ones((1, sq, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (q_pos >= k_pos)[None]
    if window is not None:
        mask = mask & (q_pos - k_pos < window)[None]
    if valid is not None:
        mask = mask & valid.to(torch.bool).reshape(-1, 1, sk)[..., k0:k1]
    return mask


def flash_attention_splitkv_plain(q, k, v, *, n_split: int, per: int,
                                  causal: bool = True, q_offset: int = 0,
                                  window: int | None = None, valid=None,
                                  ep: _epilogue.Epilogue | None = None,
                                  bias=None, residual=None, out_dtype=None,
                                  bound_grid: bool = True):
    """The split-KV arithmetic of the kernel: split s covers ``per`` KV
    blocks of 64 from the q tile's first live block (``bound_grid=False``,
    the full grid: from block 0); each split keeps its
    own fp32 partial (unnormalised O with P = exp(S - m_s) rounded to v's
    dtype, its max m_s and sum l_s; a split with no live slot has
    m_s = -inf and zeros); the partials merge in split order by
    log-sum-exp, a row with l = 0 gives 0, then the epilogue and the
    cast.  Each batch element is computed on its own, as the kernel's
    blocks are, so a row's result does not depend on the batch around
    it."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    rows = None
    if valid is not None:
        rows = valid.to(torch.bool).reshape(-1, sk)
    out = torch.cat([_splitkv_one(
        q[i:i + 1], k[i:i + 1], v[i:i + 1], n_split=n_split, per=per,
        causal=causal, q_offset=q_offset, window=window,
        valid=None if rows is None else rows[i % rows.shape[0]][None],
        bound_grid=bound_grid)
        for i in range(b)])
    out = _epilogue.apply(out, ep, bias=bias, residual=residual)
    return out.to(out_dtype or q.dtype)


def _splitkv_one(q, k, v, *, n_split, per, causal, q_offset, window,
                 valid, bound_grid):
    """One batch element's split-KV partials and their merge: the fp32
    (1, Sq, H, D) output before the epilogue."""
    _, sq, h, d = q.shape
    kvh, sk = k.shape[2], k.shape[1]
    kr, vr = repeat_kv(k, h // kvh).float(), repeat_kv(v, h // kvh)
    lo, hi = attn_k_bounds(0, -(-sk // BLOCK_K), bq=BLOCK_Q_SHORT,
                           bk=BLOCK_K, causal=causal, q_offset=q_offset,
                           window=window)
    start = lo if bound_grid else 0  # where the splits' partition starts
    qf = q.float()
    parts = []
    for s in range(n_split):
        # a block outside [lo, hi) has no live slot and leaves a split's
        # state untouched (the kernel's masked-block guard): left out
        b0 = start + s * per
        k0 = min(sk, max(b0, lo) * BLOCK_K)
        k1 = min(sk, min(hi, b0 + per) * BLOCK_K)
        if k1 <= k0:
            parts.append((torch.full((1, h, sq, 1), NEG_INF, device=q.device),
                          torch.zeros((1, h, sq, 1), device=q.device),
                          torch.zeros((1, h, sq, d), device=q.device)))
            continue
        sc = torch.einsum("bqhd,bkhd->bhqk", qf, kr[:, k0:k1]) * (d ** -0.5)
        live = _live_mask(sq, sk, k0, k1, causal=causal, window=window,
                          q_offset=q_offset, valid=valid,
                          device=q.device)[:, None]
        sc = torch.where(live, sc, torch.full_like(sc, NEG_INF))
        m_s = sc.amax(-1, keepdim=True)
        p = torch.where(live & (m_s > NEG_INF), torch.exp(sc - m_s),
                        torch.zeros_like(sc))
        o_s = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                           vr[:, k0:k1].float())
        parts.append((m_s, p.sum(-1, keepdim=True), o_s))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    l_all = torch.zeros_like(m_all)
    o_all = torch.zeros((1, h, sq, d), device=q.device)
    for m_s, l_s, o_s in parts:              # split order
        w = torch.where(m_all > NEG_INF, torch.exp(m_s - m_all),
                        torch.zeros_like(m_s))
        l_all = l_all + w * l_s
        o_all = o_all + w * o_s
    out = o_all / torch.where(l_all == 0, torch.ones_like(l_all), l_all)
    return out.permute(0, 2, 1, 3)


# ----------------------------------------------------------------------
# The kernel wrapper
# ----------------------------------------------------------------------

def _lib():
    lib = _build.load("mma_attention")
    fn = lib.mma_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def mma_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        window: int | None = None,
                        valid: torch.Tensor | None = None,
                        ep: _epilogue.Epilogue | None = None,
                        bias: torch.Tensor | None = None,
                        residual: torch.Tensor | None = None,
                        out_dtype: torch.dtype | None = None,
                        tuned: tuple | None = None,
                        bound_grid: bool = True) -> torch.Tensor:
    """Fused attention over q (B, Sq, H, D) and k, v (B, Sk, KVH, D), with
    H % KVH == 0.  ``q_offset`` is the absolute position of q[0];
    ``window`` the sliding-window width (q attends k with
    ``q_pos - k_pos < window``); ``valid`` an optional (Sk,), (1, Sk) or
    (B, Sk) filled-slot predicate.  ``ep`` fuses bias (D,) / activation /
    residual (B, Sq, H, D) into the normalised store.  ``tuned`` is an
    autotune winner (bq, n_split), or an explicit tile (bq, None), taken
    where the kernel runs it (:func:`attn_plan`; otherwise the heuristic
    runs, counted in ``mma_flash_attention.tuned_fallbacks``).
    ``bound_grid=False`` runs the full grid (K2d; the module docstring
    says what it gives).  Differentiable where an operand requires a
    gradient (the module docstring says how; the forward takes the flag,
    the backward's recomputation has no schedule)."""
    opts = dict(causal=causal, q_offset=q_offset, window=window, ep=ep,
                out_dtype=out_dtype, tuned=tuned, bound_grid=bound_grid)
    if _autograd.wants_grad(q, k, v, bias, residual):
        return _FlashAttentionFn.apply(q, k, v, valid, bias, residual, opts)
    return _mma_flash_attention(q, k, v, valid=valid, bias=bias,
                                residual=residual, **opts)


class _FlashAttentionFn(torch.autograd.Function):
    """Attention under autograd: the kernel forward; the backward
    differentiates the torch lowering's recomputation."""

    @staticmethod
    def forward(ctx, q, k, v, valid, bias, residual, opts):
        ctx.opts = opts
        ctx.res_dtype = residual.dtype if residual is not None else None
        ctx.save_for_backward(q, k, v, valid, bias)
        return _mma_flash_attention(q, k, v, valid=valid, bias=bias,
                                    residual=residual, **opts)

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.core import lowering   # imports this module
        q, k, v, valid, bias = ctx.saved_tensors
        o = ctx.opts
        need = ctx.needs_input_grad

        def recomputed(q, k, v, bias):
            return lowering.torch_attention(
                q, k, v, causal=o["causal"], window=o["window"],
                q_offset=o["q_offset"], valid=valid,
                ep=_autograd.without_residual(o["ep"]), bias=bias,
                out_dtype=dout.dtype)

        dq, dk, dv, dbias = _autograd.recompute(
            recomputed, (q, k, v, bias), (need[0], need[1], need[2], need[4]),
            dout)
        return (dq, dk, dv, None, dbias,
                (dout.to(ctx.res_dtype) if need[5] else None), None)


def _mma_flash_attention(q, k, v, *, causal, q_offset, window, valid, ep,
                         bias, residual, out_dtype, tuned,
                         bound_grid=True) -> torch.Tensor:
    """The dispatch of one attention call: the plain version on a CPU
    tensor, the kernel on a CUDA tensor."""
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"attention shapes {tuple(q.shape)} x "
                         f"{tuple(k.shape)} x {tuple(v.shape)} are "
                         f"inconsistent")
    if h % kvh:
        raise ValueError(f"H ({h}) must be a multiple of KVH ({kvh})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    ep = ep if ep is not None and not ep.is_identity else None
    if ep is not None:
        ep.validate(torch.float32, bias=bias, residual=residual)
    elif bias is not None or residual is not None:
        raise ValueError("bias/residual operands need an Epilogue")
    out_dtype = out_dtype or q.dtype
    f32 = q.dtype == torch.float32
    bq, n_split, per = attn_plan(b, h, sq, sk, d, f32, tuned)
    if tuned is not None and not attn_takes(
            (tuned[0], split_kv_plan(h, sq, sk)[0] if tuned[1] is None
             else tuned[1]), sq, sk, d, f32):
        mma_flash_attention.tuned_fallbacks += 1
    flags = dict(causal=causal, q_offset=q_offset, window=window,
                 valid=valid, ep=ep, bias=bias, residual=residual,
                 out_dtype=out_dtype, bound_grid=bound_grid)
    if q.device.type == "cpu":
        if n_split > 1:
            return flash_attention_splitkv_plain(q, k, v, n_split=n_split,
                                                 per=per, **flags)
        return flash_attention_plain(q, k, v, **flags)
    if q.device.type != "cuda":
        raise ValueError(f"mma_flash_attention runs on cuda (or its plain "
                         f"version on cpu), not {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in KERNEL_DTYPES:
        raise NotImplementedError(
            f"the attention kernel takes f32/bf16/f16 q, k, v of one dtype, "
            f"not {q.dtype}/{k.dtype}/{v.dtype}")
    dp = compiled_depth(d, f32)
    if dp is None:
        raise NotImplementedError(
            f"head dim {d} is above the compiled depths "
            f"{F32_HEAD_DIMS if f32 else KERNEL_HEAD_DIMS}")
    if out_dtype not in _OUT_CODES:
        raise NotImplementedError(f"the attention kernel stores "
                                  f"f32/bf16/f16, not {out_dtype}")
    for t in (k, v, valid, bias, residual):
        if t is not None and t.device != q.device:
            raise ValueError(f"operands on {q.device} and {t.device}")
    if residual is not None and tuple(residual.shape) != (b, sq, h, d):
        raise ValueError(f"residual has shape {tuple(residual.shape)}")
    if bias is not None and tuple(bias.shape) != (d,):
        raise ValueError(f"bias has shape {tuple(bias.shape)}; want ({d},)")
    for t in (bias, residual):
        if t is not None and t.dtype not in _OUT_CODES:
            raise NotImplementedError(f"epilogue operand dtype {t.dtype}")
    if valid is not None:
        valid = torch.broadcast_to(valid.to(torch.bool).reshape(-1, sk),
                                   (b, sk)).to(torch.uint8).contiguous()
    if b * n_split > 65535:
        raise ValueError(f"grid too large for one launch: b={b} x "
                         f"{n_split} splits")
    if dp != d:
        # zero columns past the logical depth: the scores are unchanged
        q, k, v, bias, residual = (
            torch.nn.functional.pad(t, (0, dp - d)) if t is not None
            else None for t in (q, k, v, bias, residual))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    bias = bias.contiguous() if bias is not None else None
    residual = residual.contiguous() if residual is not None else None
    out = torch.empty((b, sq, h, dp), dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out[..., :d]         # an empty grid is not a launch
    lib = _lib()
    rc = lib.mma_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        valid.data_ptr() if valid is not None else None,
        bias.data_ptr() if bias is not None else None,
        residual.data_ptr() if residual is not None else None,
        out.data_ptr(), KERNEL_DTYPES[q.dtype],
        _OUT_CODES[bias.dtype] if bias is not None else 0,
        _OUT_CODES[residual.dtype] if residual is not None else 0,
        _OUT_CODES[out_dtype], b, sq, sk, h, kvh, dp, int(causal),
        int(q_offset), int(window or 0), float(d ** -0.5),
        _epilogue.ACT_CODES[ep.activation if ep is not None else None],
        bq, n_split, per, int(bound_grid),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "mma_flash_attention")
    mode = ("f32_" if f32 else "") + ("split" if n_split > 1 else "tile")
    mma_flash_attention.launches += 1
    mma_flash_attention.launches_by_mode[mode] += 1
    if not bound_grid:
        mma_flash_attention.full_grid_launches += 1
    if mma_flash_attention.trace is not None:
        mma_flash_attention.trace.append(
            (b, sq, sk, h, kvh, d, q.dtype, bool(causal), int(q_offset),
             window, valid is not None, n_split))
    if dp != d:
        mma_flash_attention.padded_launches_by_mode[mode] += 1
        return out[..., :d].contiguous()
    return out


mma_flash_attention.launches = 0
mma_flash_attention.launches_by_mode = dict.fromkeys(MODES, 0)
# The launches at a padded depth (also in launches_by_mode), by mode.
mma_flash_attention.padded_launches_by_mode = dict.fromkeys(MODES, 0)
# The launches on the full grid, bound_grid=False (also in launches).
mma_flash_attention.full_grid_launches = 0
# The calls whose tuned tile or split the kernel could not run, so that
# the heuristic ran (not launches: counted on the CPU too).
mma_flash_attention.tuned_fallbacks = 0
# A list to record (B, Sq, Sk, H, KVH, D, dtype, causal, q_offset, window,
# valid given, n_split) of each launch into, or None (chip_smoke.py).
mma_flash_attention.trace = None
