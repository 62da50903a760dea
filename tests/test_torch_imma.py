"""The IMMA kernel's forms (``csrc/gemm_imma.cu``) on the CPU: the Python
side that mirrors the kernel, against the JAX reference where the
reference has a counterpart.

  * the form: ``tiling.imma_plan`` sends every unmasked product TMA can
    read to the wgmma tile (form A), I8GER4 at N <= 64 with a TMA-read X
    to the weight stream (form B) and the masked forms and pitches TMA
    cannot read to the mma.sync kernel; an explicit block and a
    planted autotune winner still win;
  * the shared memory of every compiled instance, against the constants
    read from the source, under a block's 227 KB;
  * the pre-pass's transforms, mirrored in numpy: the int16 split into a
    signed high and an unsigned low byte recombined by shifts (I16GER2's
    wrap at 128 x 4096 x 128 against the reference), the nibble unpack
    (against the reference's ``_unpack_int4``), and the transpose of Y
    into K-major planes, from Y's rows and from Y panels: every byte
    written, zero past K, the planes' product the reference's;
  * ``contract`` in all three families at the fringes a 128-deep stage
    adds (K = 129, 16 < N < 64, batched, a shared packed operand) against
    the reference's interpret-mode kernel and xla lowering;
  * the autotune candidates and the prior of each form.

On the CPU the wrapper runs the plain version of the path it picks, which
every form shares (integer sums are exact), so these tests hold the
choice, the shapes and the arithmetic.  The kernel itself is held against
its plain version on the card (``tests/test_torch_cuda.py``,
``test_imma_redesign_forms``, ``test_imma_stream_qdot``,
``test_imma_tile_panels``).  Tolerance: bit for bit throughout.
"""

from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import facility as jfac
from repro.core import precision as jprec
from repro.kernels import mma_gemm as jgemm
from repro_torch.core import autotune, packing, tiling
from repro_torch.core import facility as tfac
from repro_torch.core import precision as tprec
from repro_torch.kernels import mma_gemm as tgemm
from repro_torch.roofline import analysis as roofline

Ger = tprec.Ger
I8, I4, I16 = Ger.I8GER4, Ger.I4GER8, Ger.I16GER2
CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "csrc" / "gemm_imma.cu")
CPU = tfac.FacilityConfig(device="cpu")
MMA = {g: tiling.tiles_for(g)[0] for g in tiling.IMMA_GERS}

# (x dtype, y dtype, x range, y range, K packing) per family
OPERANDS = {"I8GER4": (np.int8, np.uint8, (-128, 128), (0, 256), 1),
            "I4GER8": (np.int8, np.int8, (-128, 128), (-128, 128), 2),
            "I16GER2": (np.int16, np.int16, (-32768, 32768),
                        (-32768, 32768), 1)}


def operands(fam, lead, m, k, n, seed):
    """Full-range numpy operands; ``k`` is logical (I4GER8 packs it)."""
    xd, yd, xr, yr, pack = OPERANDS[fam]
    rng = np.random.default_rng(seed)
    return (rng.integers(*xr, lead + (m, k // pack)).astype(xd),
            rng.integers(*yr, lead + (k // pack, n)).astype(yd))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True)
def _hermetic_cache(tmp_path, monkeypatch):
    """Every test dispatches against a fresh temporary autotune cache."""
    cache = autotune.AutotuneCache(tmp_path / "default.json")
    monkeypatch.setattr(autotune, "_DEFAULT_CACHE", cache)
    yield cache


# ----------------------------------------------------------------------
# the form
# ----------------------------------------------------------------------

# (family, (M, N, K), aligned, x_aligned, masked, the configuration)
PLAN_CASES = {
    "i8-8192": (I8, (8192, 8192, 8192), True, None, False,
                tiling.ImmaTileConfig(256)),
    "i8-small-grid": (I8, (256, 4096, 512), True, None, False,
                      tiling.ImmaTileConfig(128)),
    "i4-4096": (I4, (4096, 4096, 2048), True, None, False,
                tiling.ImmaTileConfig(256)),
    "i16-4096": (I16, (4096, 4096, 4096), True, None, False,
                 tiling.ImmaTileConfig(64)),
    "qdot-decode": (I8, (11008, 4, 4096), False, True, False,
                    tiling.ImmaStreamConfig(8, 4)),
    "qdot-64": (I8, (11008, 64, 4096), True, None, False,
                tiling.ImmaStreamConfig(64, 16)),
    "n-65": (I8, (11008, 80, 4096), True, None, False,
             tiling.ImmaTileConfig(128)),
    "i16-narrow": (I16, (300, 48, 512), True, None, False,
                   tiling.ImmaTileConfig(64)),
    "i4-narrow": (I4, (300, 48, 256), True, None, False,
                  tiling.ImmaTileConfig(128)),
    "masked": (I8, (4096, 4096, 4096), True, None, True, MMA[I8]),
    "masked-narrow": (I8, (11008, 4, 4096), False, True, True, MMA[I8]),
    "i4-masked": (I4, (4096, 4096, 2048), True, None, True, MMA[I4]),
    "unaligned": (I16, (100, 100, 101), False, False, False, MMA[I16]),
    "x-unaligned": (I8, (11008, 4, 4100), False, False, False, MMA[I8]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_imma_plan_picks_the_form(case):
    ger, (m, n, k), aligned, x_aligned, masked, want = PLAN_CASES[case]
    got = tiling.imma_plan(m, n, k, ger, 1, aligned, masked, x_aligned)
    assert got == want
    assert tiling.choose_gemm_path(m, n, k, ger, 1, aligned, None, masked,
                                   None, x_aligned) == ("imma", want)
    assert tiling.imma_takes(want, m, n, k, ger, aligned, masked, x_aligned)


@pytest.mark.parametrize("m,n,k,b", [(11008, 4, 4096, 1), (128, 8, 65536, 1),
                                     (300, 48, 512, 3),
                                     (100_000, 64, 8192, 1)])
def test_imma_stream_split_fits_the_card_and_shared_memory(m, n, k, b):
    """The weight stream's split: never more slices than K's stages, a
    slice's Y columns within IMMA_STREAM_YT bytes, every stage in one
    slice, the block's shared memory within an SM's; at qdot's decode the
    grid is one wave, most of the blocks the card holds."""
    cfg = tiling.imma_stream_plan(m, n, k, b)
    stages = -(-k // tiling.IMMA_STREAM_BK)
    assert cfg.bn >= n and cfg.bn in tiling.IMMA_STREAM_WIDTHS
    assert 1 <= cfg.split <= stages
    assert cfg.bn * tiling.IMMA_STREAM_BK * cfg.slice_stages(k) \
        <= tiling.IMMA_STREAM_YT
    cuts = [s * stages // cfg.split for s in range(cfg.split + 1)]
    assert cuts[0] == 0 and cuts[-1] == stages
    assert max(c - a for a, c in zip(cuts, cuts[1:])) \
        == cfg.slice_stages(k)
    assert cfg.smem_bytes(k) <= tiling.SMEM_PER_BLOCK
    if (m, n, k, b) == (11008, 4, 4096, 1):
        assert cfg.blocks(m, b) <= cfg.blocks_per_sm(k) * tiling.NUM_SMS
        assert cfg.blocks(m, b) > 0.8 * cfg.blocks_per_sm(k) \
            * tiling.NUM_SMS


def _spy_paths(monkeypatch):
    seen = []
    choose = tiling.choose_gemm_path

    def spy(*args, **kw):
        got = choose(*args, **kw)
        seen.append(got)
        return got
    monkeypatch.setattr(tiling, "choose_gemm_path", spy)
    return seen


def test_imma_explicit_block_and_planted_winner_win(_hermetic_cache,
                                                    monkeypatch):
    """An explicit block names the mma.sync kernel's tile; a planted winner (the narrow
    tile where the plan picks the wide one) is the configuration
    ``contract`` takes; a winner the call cannot take (the weight stream
    under masks) gives way to the plan; every route the same bits."""
    m, n, k = 256, 256, 256
    assert tiling.choose_gemm_path(m, n, k, I8, block=(128, 128, 64)) \
        == ("imma", MMA[I8])
    with pytest.raises(ValueError, match="not a compiled"):
        tiling.choose_gemm_path(m, n, k, I8, block=(128, 256, 128))
    heur = tiling.choose_gemm_path(m, n, k, I8)
    winner = ("imma", tiling.ImmaTileConfig(
        256 if heur[1].bn == 128 else 128))
    key = autotune.cache_key(I8, autotune.tune_rows(I8, m), n, k, "none",
                             "cpu", 1)
    _hermetic_cache.put(key, winner, source=autotune.PRIOR, score=0.0)
    x, y = operands("I8GER4", (), m, k, n, 1)
    plan = tfac.Plan(ger=I8, out_dtype=tfac.ACC)
    seen = _spy_paths(monkeypatch)
    with tfac.configure(CPU):
        tuned = tfac.contract("mk,kn->mn", _t(x), _t(y), plan=plan)
        explicit = tfac.contract("mk,kn->mn", _t(x), _t(y), plan=tfac.Plan(
            ger=I8, out_dtype=tfac.ACC, block=(128, 128, 64)))
    assert seen == [winner, ("imma", MMA[I8])]
    assert torch.equal(tuned, explicit)
    stream = ("imma", tiling.ImmaStreamConfig(64, 2))
    assert tiling.takes(stream, 300, 48, 512, I8)
    assert not tiling.takes(stream, 300, 48, 512, I8, masked=True)
    assert not tiling.takes(stream, 300, 48, 512, I16)
    assert tiling.choose_gemm_path(300, 48, 512, I8, 1, True, None, True,
                                   stream) == ("imma", MMA[I8])
    assert tiling.takes(("imma", MMA[I8]), 300, 48, 512, I8, False, True)


# ----------------------------------------------------------------------
# shared memory: the Python mirror against the kernel's own constants
# ----------------------------------------------------------------------

def _constants():
    src = CSRC.read_text()

    def num(name):
        return int(re.search(rf"\b{name} = (\d+)[,;]", src).group(1))

    budget = re.search(r"TA_BUDGET = (\d+) - (\d+);", src)
    tiles = {(fam, int(bn)) for fam, bn in re.findall(
        r"launch_tile<FAM_(I8|I4|I16), (\d+),", src)}
    widths = sorted({int(w) for w in re.findall(r"launch_stream<(\d+)>",
                                                src)})
    return dict(TA_BM=num("TA_BM"), TA_BK=num("TA_BK"),
                TA_MAX_STAGES=num("TA_MAX_STAGES"), TA_KPAD=num("TA_KPAD"),
                TA_BUDGET=int(budget.group(1)) - int(budget.group(2)),
                TB_BM=num("TB_BM"), TB_BK=num("TB_BK"),
                TB_STAGES=num("TB_STAGES"), TB_YT_MAX=num("TB_YT_MAX"),
                tiles=tiles, widths=widths)


def test_imma_shared_memory_mirrors_the_kernel():
    c = _constants()
    assert (c["TA_BM"], c["TA_BK"]) == (tiling.IMMA_TILE_BM,
                                        tiling.IMMA_TILE_BK)
    assert c["TA_MAX_STAGES"] == tiling.IMMA_TILE_MAX_STAGES
    assert c["TA_BUDGET"] == tiling.IMMA_TILE_BUDGET
    assert c["TA_KPAD"] == tiling.IMMA_TILE_KPAD
    assert (c["TB_BM"], c["TB_BK"], c["TB_STAGES"], c["TB_YT_MAX"]) == (
        tiling.IMMA_STREAM_BM, tiling.IMMA_STREAM_BK,
        tiling.IMMA_STREAM_STAGES, tiling.IMMA_STREAM_YT)
    fam = {"I8": I8, "I4": I4, "I16": I16}
    assert {(fam[f], bn) for f, bn in c["tiles"]} == {
        (g, w) for g, ws in tiling.IMMA_TILE_WIDTHS.items() for w in ws}
    assert tuple(c["widths"]) == tiling.IMMA_STREAM_WIDTHS
    for ger, widths in tiling.IMMA_TILE_WIDTHS.items():
        for bn in widths:
            cfg = tiling.ImmaTileConfig(bn)
            stage, stages = cfg.stage_bytes(ger), cfg.stages(ger)
            assert stages >= 2 and stages * stage <= tiling.IMMA_TILE_BUDGET
            assert stages * stage >= 128 * (bn + 8) * 4    # the int32 tile
            assert stage % 1024 == 0 and (bn * 128) % 1024 == 0  # swizzle
            assert cfg.smem_bytes(ger) <= tiling.SMEM_PER_BLOCK
    biggest = tiling.ImmaStreamConfig(8, 1).smem_bytes(
        tiling.IMMA_STREAM_YT // 8)
    assert biggest <= tiling.SMEM_PER_BLOCK


# ----------------------------------------------------------------------
# the pre-pass's arithmetic, mirrored
# ----------------------------------------------------------------------

def byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 arrays (selector nibbles 0-7)."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    both = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        sel = (int(s) >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * sel)) & np.uint64(0xff)) \
            << np.uint64(8 * i)
    return out.astype(np.uint32)


def words(b):
    """(..., 4k) bytes -> (..., k) little-endian uint32 words."""
    return np.ascontiguousarray(b).view(np.uint32)


def vsub4(a, b):
    """__vsub4: four byte-wise subtractions modulo 256."""
    a8, b8 = (np.asarray(v, np.uint32)[..., None].view(np.uint8)
              for v in (a, b))
    return ((a8.astype(np.int16) - b8) & 0xff).astype(np.uint8).view(
        np.uint32)[..., 0]


def nib_lo(v):
    return vsub4((v & 0x0f0f0f0f) ^ 0x08080808, np.uint32(0x08080808))


def nib_hi(v):
    return vsub4(((v >> 4) & 0x0f0f0f0f) ^ 0x08080808,
                 np.uint32(0x08080808))


def test_int16_split_recombines_to_the_wrapped_reference():
    """I16GER2: each int16 v = 256 h + l (h signed, l unsigned), split by
    the pre-pass's byte permutes (0x7531, 0x6420); the four byte products
    into three s32 accumulators, each wrapping, recombined by shifts,
    equal the reference's int32 dot bit for bit where the exact sum
    leaves int32 (128 x 4096 x 128, full range)."""
    x, y = operands("I16GER2", (), 128, 4096, 128, 21)
    x[0, :] = -32768                   # the extremes, to force a wrap
    y[:, 0] = -32768
    xw = words(x)                      # two int16 a word
    xh = np.ascontiguousarray(byte_perm(xw[:, 0::2], xw[:, 1::2],
                                        0x7531)).view(np.int8)
    xl = np.ascontiguousarray(byte_perm(xw[:, 0::2], xw[:, 1::2],
                                        0x6420)).view(np.uint8)
    assert np.array_equal(256 * xh.astype(np.int64) + xl, x)
    yh, yl = (y >> 8).astype(np.int8), (y & 0xff).astype(np.uint8)
    assert np.array_equal(256 * yh.astype(np.int64) + yl, y)

    def s32(a, b):                     # one wrapping s32 accumulator
        return (a.astype(np.int64) @ b.astype(np.int64)) % 2 ** 32

    acc0 = s32(xh, yh)
    acc1 = (s32(xh, yl) + s32(xl, yh)) % 2 ** 32
    acc2 = s32(xl, yl)
    got = ((acc0 << 16) + (acc1 << 8) + acc2) % 2 ** 32
    got = got.astype(np.uint32).view(np.int32)
    exact = x.astype(np.int64) @ y.astype(np.int64)
    assert (np.abs(exact) > 2 ** 31 - 1).any()
    want = jfac.contract("mk,kn->mn", jnp.asarray(x), jnp.asarray(y),
                         plan=jfac.Plan(ger=jprec.Ger.I16GER2,
                                        out_dtype=jfac.ACC, backend="xla"))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(
        got, tgemm.mma_gemm_plain(_t(x), _t(y), kind=I16).numpy())


def test_nibble_unpack_matches_the_reference():
    """I4GER8: the pre-pass's nib_lo / nib_hi (sign-extended nibbles) and
    its byte interleave (0x5140, 0x7362) give the reference's
    ``_unpack_int4`` order along K, low nibble first."""
    rng = np.random.default_rng(22)
    packed = rng.integers(-128, 128, (16, 64)).astype(np.int8)
    w = words(packed)                                    # (16, 16)
    lo, hi = nib_lo(w), nib_hi(w)
    out = np.stack([byte_perm(lo, hi, 0x5140), byte_perm(lo, hi, 0x7362)],
                   -1).reshape(16, -1)
    got = out.view(np.int8)
    want = np.asarray(jgemm._unpack_int4(jnp.asarray(packed), axis=1))
    np.testing.assert_array_equal(got, want)
    # Y's rows: packed row kp gives logical rows 2 kp (low), 2 kp + 1
    rows = np.stack([nib_lo(w).view(np.int8), nib_hi(w).view(np.int8)], 1)
    want_y = np.asarray(jgemm._unpack_int4(jnp.asarray(packed), axis=0))
    np.testing.assert_array_equal(rows.reshape(32, 64), want_y)


def prep_y(y, fam, k, n, kp, y_gk=0):
    """prep_y_kernel, mirrored: the Y^T planes (planes, N, kp) bytes of Y
    (natural (Ks, N) rows, or Y panels when ``y_gk``), a (64 k x 64 n)
    tile at a time, each thread's 16 k of one column gathered from the
    tile (I4GER8's packed rows unpacked, I16GER2's int16 split), zero past
    K."""
    esz = 2 if fam == "I16GER2" else 1
    rows = k // 2 if fam == "I4GER8" else k
    tile_rows = 32 if fam == "I4GER8" else 64
    planes = 2 if fam == "I16GER2" else 1
    out = np.zeros((planes, n, kp), np.uint8)
    written = np.zeros((planes, n, kp), bool)
    raw = np.ascontiguousarray(y).view(np.uint8).reshape(-1)
    for n0 in range(0, n, 64):
        for t0 in range(0, -(-rows // tile_rows) * tile_rows, tile_rows):
            tile = np.zeros((tile_rows, 64 * esz), np.uint8)
            for r in range(tile_rows):       # 16-byte chunks in
                row = t0 + r
                for c in range(4 * esz):
                    col = n0 + c * (16 // esz)
                    if row < rows and col < n:
                        off = (((col // 64) * y_gk + row // 64) * 4096
                               + row % 64 * 64 + col % 64) if y_gk \
                            else row * n + col
                        tile[r, 16 * c:16 * c + 16] = raw[off * esz:
                                                          off * esz + 16]
            for t in range(256):             # 16 bytes of a Y^T row out
                nn, c = t // 4, t % 4
                k0 = t0 // tile_rows * 64 + 16 * c
                if n0 + nn >= n:
                    continue
                written[:, n0 + nn, k0:k0 + 16] = True
                if fam == "I8GER4":
                    out[0, n0 + nn, k0:k0 + 16] = tile[16 * c:16 * c + 16,
                                                       nn]
                elif fam == "I4GER8":
                    b = tile[8 * c:8 * c + 8, nn].astype(np.int32)
                    lo = ((b & 0xF) ^ 8) - 8
                    hi = ((b >> 4) ^ 8) - 8
                    out[0, n0 + nn, k0:k0 + 16] = np.stack(
                        [lo, hi], 1).reshape(-1).astype(np.uint8)
                else:
                    v = tile[16 * c:16 * c + 16, 2 * nn:2 * nn + 2].view(
                        np.uint16)[:, 0]
                    out[0, n0 + nn, k0:k0 + 16] = (v >> 8).astype(np.uint8)
                    out[1, n0 + nn, k0:k0 + 16] = (v & 0xFF).astype(np.uint8)
    assert written.all()
    return out


@pytest.mark.parametrize("fam,k,n,packed", [
    ("I8GER4", 200, 80, False), ("I8GER4", 200, 80, True),
    ("I4GER8", 192, 48, False), ("I16GER2", 136, 72, False),
    ("I16GER2", 136, 72, True)])
def test_prep_transposes_and_splits_like_the_reference(fam, k, n, packed):
    """The pre-pass's Y^T planes, mirrored: every byte in [0, K) of every
    row written, zero on [K, kp), and the planes' product with X's planes
    (I4GER8 unpacked, I16GER2 split and recombined by shifts, each s32
    accumulator wrapping) the reference's kernel bit for bit; Y panels
    give the same planes as Y's rows."""
    kp = -(-k // tiling.IMMA_TILE_KPAD) * tiling.IMMA_TILE_KPAD
    x, y = operands(fam, (), 40, k, n, 31)
    gk = 0
    yin = y
    if packed:
        po = packing.pack_gemm(_t(y), packing.gemm_layout(Ger[fam], k, n))
        yin, gk = po.data.numpy(), -(-k // 64)
    planes = prep_y(yin, fam, k, n, kp, gk)
    if packed:
        assert np.array_equal(planes, prep_y(y, fam, k, n, kp))
    assert not (planes[:, :, k:] != 0).any()
    if fam == "I16GER2":
        xh, xl = (x >> 8).astype(np.int8), (x & 0xFF).astype(np.uint8)
        yh, yl = planes[0, :, :k].view(np.int8), planes[1, :, :k]

        def s32(a, b):
            return (a.astype(np.int64) @ b.T.astype(np.int64)) % 2 ** 32
        got = ((s32(xh, yh) << 16) + ((s32(xh, yl) + s32(xl, yh)) << 8)
               + s32(xl, yl)) % 2 ** 32
    else:
        xs = (np.asarray(jgemm._unpack_int4(jnp.asarray(x), axis=1))
              if fam == "I4GER8" else x)
        ys = planes[0, :, :k].view(np.int8 if fam == "I4GER8" else np.uint8)
        got = (xs.astype(np.int64) @ ys.T.astype(np.int64)) % 2 ** 32
    got = got.astype(np.uint32).view(np.int32)
    want = jgemm.mma_gemm(jnp.asarray(x), jnp.asarray(y),
                          kind=jprec.Ger[fam], interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


# ----------------------------------------------------------------------
# contract at the fringes a 128-deep stage adds
# ----------------------------------------------------------------------

# (lead, M, K logical, N): K = 129 (I4GER8: 130, its nibbles pair), N
# between 16 and 64, batched
FRINGES = {"k129": ((), 130, 129, 144), "n48": ((), 300, 256, 48),
           "batched": ((2,), 129, 160, 40)}


@pytest.mark.parametrize("case", sorted(FRINGES))
@pytest.mark.parametrize("fam", ["I8GER4", "I4GER8", "I16GER2"])
def test_contract_at_stage_fringes_matches_reference(fam, case):
    lead, m, k, n = FRINGES[case]
    if fam == "I4GER8":
        k += k % 2
    x, y = operands(fam, lead, m, k, n, 24)
    rng = np.random.default_rng(25)
    c = rng.integers(-2 ** 31, 2 ** 31, lead + (m, n),
                     dtype=np.int64).astype(np.int32)
    spec = "mk,kn->mn" if not lead else "bmk,bkn->bmn"
    forms = dict(neg_product=True, alpha=3.0, beta=-2.0)
    with tfac.configure(CPU):
        got = tfac.contract(spec, _t(x), _t(y), acc=_t(c), plan=tfac.Plan(
            ger=Ger[fam], out_dtype=tfac.ACC, **forms))
    kernel = jgemm.mma_gemm(jnp.asarray(x), jnp.asarray(y), jnp.asarray(c),
                            kind=jprec.Ger[fam], interpret=True, **forms)
    xla = jfac.contract(spec, jnp.asarray(x), jnp.asarray(y),
                        acc=jnp.asarray(c), plan=jfac.Plan(
                            ger=jprec.Ger[fam], out_dtype=jfac.ACC,
                            backend="xla", **forms))
    for want in (kernel, xla):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fam", ["I8GER4", "I16GER2"])
def test_shared_packed_operand_matches_reference(fam):
    """A packed Y without the batch axis beside a batched X (shared across
    the batch, as the reference's index map ignores the batch for it):
    the batch's products bit for bit the reference's, one at a time."""
    b, m, k, n = 3, 129, 160, 48
    x, y = operands(fam, (b,), m, k, n, 26)
    y0 = y[0]
    po = packing.pack_gemm(_t(y0), packing.gemm_layout(Ger[fam], k, n))
    got = tgemm.mma_gemm(_t(x), po.data, kind=Ger[fam], y_layout=po.layout)
    for i in range(b):
        want = jgemm.mma_gemm(jnp.asarray(x[i]), jnp.asarray(y0),
                              kind=jprec.Ger[fam], interpret=True)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# the autotune candidates and the prior
# ----------------------------------------------------------------------

@pytest.mark.parametrize("ger,m,n,k", [(I8, 4096, 4096, 4096),
                                       (I16, 4096, 4096, 4096),
                                       (I8, 11008, 4, 4096),
                                       (I4, 100, 100, 50)])
def test_imma_candidates_are_the_compiled_configurations(ger, m, n, k):
    aligned = (k * (2 if ger == I16 else 1)) % 16 == 0 and n % 16 == 0
    cands = autotune.candidate_blocks(m, n, k, ger, 1, aligned)
    assert ("imma", MMA[ger]) in cands
    assert tiling.choose_gemm_path(m, n, k, ger, 1, aligned) in cands
    for path, cfg in cands:
        assert path == "imma"
        assert tiling.takes((path, cfg), m, n, k, ger, aligned)
        blk, fields = autotune._entry_of((path, cfg))
        assert autotune._winner_of({"block": blk, **fields}) == (path, cfg)
    tiles = [c for _, c in cands if isinstance(c, tiling.ImmaTileConfig)]
    assert (len(tiles) == len(tiling.IMMA_TILE_WIDTHS[ger])) == aligned


def test_imma_prior_ranks_each_form():
    """The prior: the weight stream below both tiles at qdot's decode
    (it reads the weight once, on the whole card); the wide tile below
    the narrow one and the mma.sync kernel at 8192^3 (fewer panel reads)."""
    pol = tprec.policy(I8)

    def t(m, n, k, cfg):
        return roofline.gemm_projected_time(m, n, k, cfg, pol)

    stream = tiling.imma_stream_plan(11008, 4, 4096)
    dec = {c: t(11008, 4, 4096, c) for c in (
        stream, tiling.ImmaTileConfig(128), MMA[I8])}
    assert min(dec, key=dec.get) == stream
    assert roofline.gemm_traffic_bytes(11008, 4, 4096, stream, pol) == (
        11008 * 4096 + 86 * 4096 * 4 + 2 * 4 * stream.split * 11008 * 4
        + 11008 * 4 * 4)
    big = {c: t(8192, 8192, 8192, c) for c in (
        tiling.ImmaTileConfig(256), tiling.ImmaTileConfig(128), MMA[I8])}
    assert min(big, key=big.get) == tiling.ImmaTileConfig(256)
    i16 = tprec.policy(I16)
    assert roofline.gemm_projected_time(
        4096, 4096, 4096, tiling.ImmaTileConfig(128), i16) > t(
            4096, 4096, 4096, tiling.ImmaTileConfig(128))
