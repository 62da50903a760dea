"""Persistent prepacked operand layouts (port of ``repro.core.packing``).

A weight is packed ONCE into the panels its kernel reads, and every later
dispatch streams those panels straight into the kernel, with no relayout
on the call:

  * :class:`PackedOperand` -- a weight in its kernel-native tiled layout.
    ``data`` holds the panels; the frozen :class:`GemmLayout` /
    :class:`ConvLayout` records the caller's logical shape, the tiling
    and the orientation; ``scale`` / ``col_sum`` carry the int8
    quantization metadata of the ``I8GER4`` Dequant deprime.  ``shape`` /
    ``ndim`` / ``dtype`` / ``device`` mirror the *caller's natural
    tensor*, so ``facility.contract``'s spec parsing and shape checks see
    no packing.  It is a plain Python class, not a tensor subclass.
  * The layouts: GEMM Y side ``(gn, gk, bk, bn)``, X side
    ``(gm, gk, bm, bk)``, conv ``(gf, KH, KW, C, bf)``, leading layer or
    expert axes kept in front; fringes zero-padded up to the panel grid.
    For the same block the panels are the reference's bit for bit (the
    transform does not depend on the framework).
  * **Freshness**: :func:`refresh_gemm` / :func:`refresh_conv` at dispatch.
    A layout is fresh while its panel is the one the kernels read
    (:data:`PANELS`, :data:`CONV_BF`); on a mismatch the operand is
    repacked on the spot, once (``COUNTERS["repack"]``, ``["invalidate"]``),
    and keeps the new panels.
  * **Demotion**: :func:`demote_value` / :func:`demote_op` (the torch and
    ref lowerings, and the admission of what cannot ride packed) are the
    only packed -> natural conversions, each counted
    (``COUNTERS["demote"]``), so a steady-state packed loop can be held to
    zero of them.  A quantized operand is demoted only for a dispatch that
    applies its scale.  The kernel wrappers demote nothing: every GEMM
    path reads packed panels, and so does every conv path.
  * :func:`prepack_params_for_serving` -- the pass over a port ``Model``
    (an ``nn.Module``) that replaces dense weights, MoE expert banks and
    the conv stems' filters by packed operands in place.
  * :class:`PackedStore` -- the process-global store of packed constants
    (the DFT twiddles of ``kernels/blas3.py``).

Where the port departs from the reference.  The reference derives a
layout's block from the autotune winner at an ``m_hint`` (the serving
batch) and, inside a jit trace, demotes a stale layout it cannot repack.
The port does not trace, and its winners (``core/autotune.py``) change a
call's path, never its panel:

  * a layout's panel is the panel its kernels read, fixed and independent
    of M and of the winner (:data:`PANEL_BLOCK`): the Y side's (bk, bn) =
    (64, 64) is the wgmma tile's 128-byte-swizzled B box, two of the
    weight stream's 32-row stages, and the panel the WMMA, fp32, IMMA and
    DMMA tiles cut their (bk, bn) stages from, so one pack serves decode,
    prefill and every tuned path, and a tuned serve repacks nothing (the
    128-column tiles, DMMA's large one among them, read two Y panels a
    stage); the X side's (bm, bk) = (128, 64) is the wgmma tile's A box,
    the IMMA tile's I8GER4 X panel and the band of DMMA's 128-row tile,
    which the other paths cut their rows from (DMMA's 64-row tile half a
    band; DMMA's 32- and 16-deep stages half or a quarter of a panel's
    depth); the conv filter tile is bf = 64 (:data:`CONV_BF`), K3's wgmma
    B box and half its WMMA tile's 128 filters;
  * the reference's "stale under trace -> demote" branch has no
    counterpart: a stale layout is always repacked;
  * a packed dispatch takes the path its natural operands would take
    (``tiling.choose_gemm_path`` / ``choose_conv_path``, chosen once, in
    the kernel wrapper, a tuned winner included), and that path reads the
    panels, so its result is the natural one bit for bit.
"""

from __future__ import annotations

import collections
import dataclasses
import typing

import torch
import torch.nn.functional as F

from repro_torch.core import precision, tiling

Ger = precision.Ger

# Pack / repack / invalidate / demote / store traffic.  Tests hold deltas
# (a steady-state decode loop issues zero demotes and zero new packs);
# ``clear_state`` resets it.  EVENTS keeps the last EVENTS_KEPT events
# (each with its reason), so a long-running server's log stays bounded.
COUNTERS: collections.Counter = collections.Counter()
EVENTS_KEPT = 1024
EVENTS: collections.deque = collections.deque(maxlen=EVENTS_KEPT)


def _record(event: str, **info):
    COUNTERS[event] += 1
    EVENTS.append({"event": event, **info})


def clear_state() -> None:
    COUNTERS.clear()
    EVENTS.clear()


# The panels the port's kernels read, (bm, bn, bk): Y side (bk, bn) =
# (64, 64), X side (bm, bk) = (128, 64), on every GEMM path
# (csrc/common.cuh's x_panel_at / y_panel_at); and K3's filter tile
# (csrc/mma_conv.cu).
PANEL_BLOCK = (128, 64, 64)
CONV_BF = 64
# The (rows, cols) of one panel by side: GemmLayout.panel_blocks of a
# fresh layout.
PANELS = {"y": (PANEL_BLOCK[2], PANEL_BLOCK[1]),
          "x": (PANEL_BLOCK[0], PANEL_BLOCK[2])}


# ----------------------------------------------------------------------
# Layout descriptors
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GemmLayout:
    """Tiled layout of one GEMM weight panel stream.

    ``side`` names the normalized operand the weight plays: ``"y"`` the
    right (K, N) operand (dense and MoE weights), ``"x"`` the left (M, K)
    operand (the quant path's signed int8 weights, spec ``"kn,mk->mn"``).
    ``rows``/``cols`` are the kernel-facing dims; ``transposed`` says the
    caller's natural tensor is their transpose (the pack pays that
    transpose once).  ``batched`` marks an expert bank whose leading axis
    is the kernel's batch axis.

    Physical ``data`` layout (leading layer/batch axes elided):

        side "y":  (gn, gk, bk, bn)
        side "x":  (gm, gk, bm, bk)
    """

    kind: Ger
    block: tuple[int, int, int]       # (bm, bn, bk)
    side: str                         # "x" | "y"
    rows: int                         # kernel-facing rows (k for y, m for x)
    cols: int                         # kernel-facing cols (n for y, k for x)
    transposed: bool = False
    batched: bool = False

    tile: typing.ClassVar[str] = "gemm"
    tile_rank: typing.ClassVar[int] = 4

    @property
    def caller_shape(self) -> tuple[int, int]:
        return ((self.cols, self.rows) if self.transposed
                else (self.rows, self.cols))

    @property
    def panel_blocks(self) -> tuple[int, int]:
        """(block rows, block cols) of one packed panel."""
        bm, bn, bk = self.block
        return (bk, bn) if self.side == "y" else (bm, bk)


@dataclasses.dataclass(frozen=True)
class ConvLayout:
    """Tiled layout of one conv filter bank, ``(gf, KH, KW, C, bf)``: the F
    axis blocked by the kernel's filter tile.  1-D specs (``nd == 1``)
    pack with a size-1 KH axis, the conv normalizer's NHWC x HWIO form."""

    kind: Ger
    bf: int
    kh: int
    kw: int
    c: int
    f: int
    nd: int = 2                       # spatial ndim of the caller's spec

    tile: typing.ClassVar[str] = "conv"
    tile_rank: typing.ClassVar[int] = 5

    @property
    def caller_shape(self) -> tuple[int, ...]:
        if self.nd == 1:
            return (self.kw, self.c, self.f)
        return (self.kh, self.kw, self.c, self.f)


# ----------------------------------------------------------------------
# PackedOperand
# ----------------------------------------------------------------------

class PackedOperand:
    """A weight persisted in its kernel-native tiled layout.

    ``shape``/``ndim``/``dtype``/``device`` mirror the caller's natural
    tensor.  Mutable on purpose: a repack on a stale layout replaces
    ``data`` and ``layout`` in place, so the next dispatch finds it fresh.
    """

    __slots__ = ("data", "layout", "scale", "col_sum")

    def __init__(self, data, layout, scale=None, col_sum=None):
        self.data = data
        self.layout = layout
        self.scale = scale            # (1, N) fp32: int8 weight scales
        self.col_sum = col_sum        # (N,) fp32: Dequant column sums

    @property
    def shape(self) -> tuple[int, ...]:
        return (tuple(self.data.shape[:-self.layout.tile_rank])
                + self.layout.caller_shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def quantized(self) -> bool:
        return self.scale is not None

    def to(self, dtype: torch.dtype) -> "PackedOperand":
        """The reference's ``astype``: an elementwise cast commutes with
        the tiling, so the policy cast lands on the natural values."""
        if dtype == self.data.dtype:
            return self
        if self.quantized:
            raise ValueError(
                "refusing to cast a packed-quantized (int8) operand; "
                "route it through quant.qdot's I8GER4 Dequant plan")
        return PackedOperand(self.data.to(dtype), self.layout, self.scale,
                             self.col_sum)

    def unpack(self) -> torch.Tensor:
        """The caller's natural tensor (exact: the inverse tile transpose,
        the fringe padding sliced away, the orientation undone)."""
        if self.layout.tile == "conv":
            return _unpack_conv(self.data, self.layout)
        return _unpack_gemm(self.data, self.layout)

    def __repr__(self):
        return (f"PackedOperand(shape={self.shape}, dtype={self.dtype}, "
                f"layout={self.layout!r})")


def is_packed(v) -> bool:
    return isinstance(v, PackedOperand)


# ----------------------------------------------------------------------
# Pack / unpack transforms
# ----------------------------------------------------------------------

def _pad_to(w: torch.Tensor, sizes: tuple[int, ...]) -> torch.Tensor:
    """Zero-pad the trailing dims of ``w`` up to ``sizes``."""
    pads = []
    for have, want in zip(reversed(w.shape[-len(sizes):]), reversed(sizes)):
        pads += [0, want - have]
    if not any(pads):
        return w
    return F.pad(w, pads)


def pack_gemm(w: torch.Tensor, layout: GemmLayout, *, scale=None,
              col_sum=None) -> PackedOperand:
    """Pack a GEMM weight into ``layout`` (any transpose paid once).

    Leading axes beyond the trailing matrix (expert banks) are carried
    through, ahead of the tile axes.  Fringes are zero-padded up to the
    panel grid, where the kernels read zeros past K and N anyway.
    """
    if precision.policy(layout.kind).packed_int4:
        raise ValueError("packed-int4 kinds keep their own nibble packing; "
                         "the layout subsystem packs byte-addressable tiles")
    if w.ndim < 2 or tuple(w.shape[-2:]) != layout.caller_shape:
        raise ValueError(f"operand {tuple(w.shape)} does not end in the "
                         f"layout's natural shape {layout.caller_shape}")
    if layout.batched and w.ndim < 3:
        raise ValueError(f"batched layout wants a leading batch axis; "
                         f"got {tuple(w.shape)}")
    w2 = w.transpose(-1, -2) if layout.transposed else w
    br, bc = layout.panel_blocks
    gr, gc = -(-layout.rows // br), -(-layout.cols // bc)
    lead = w2.ndim - 2
    w2 = _pad_to(w2, (gr * br, gc * bc))
    t = w2.reshape(tuple(w2.shape[:lead]) + (gr, br, gc, bc))
    head = tuple(range(lead))
    if layout.side == "y":            # (gn, gk, bk, bn)
        order = (lead + 2, lead + 0, lead + 1, lead + 3)
    else:                             # (gm, gk, bm, bk)
        order = (lead + 0, lead + 2, lead + 1, lead + 3)
    data = t.permute(head + order).contiguous()
    _record("pack", tile="gemm", side=layout.side, block=layout.block,
            shape=tuple(w.shape))
    return PackedOperand(data, layout, scale=scale, col_sum=col_sum)


def gemm_panels_matrix(data: torch.Tensor, lay: GemmLayout) -> torch.Tensor:
    """The kernel-facing (rows, cols) matrix of packed panels (leading
    axes kept): the plain versions' view of what a kernel streams."""
    lead = data.ndim - 4
    head = tuple(range(lead))
    if lay.side == "y":
        t = data.permute(head + (lead + 1, lead + 2, lead + 0, lead + 3))
    else:
        t = data.permute(head + (lead + 0, lead + 2, lead + 1, lead + 3))
    gr, br, gc, bc = t.shape[lead:]
    w2 = t.reshape(tuple(t.shape[:lead]) + (gr * br, gc * bc))
    return w2[..., :lay.rows, :lay.cols]


def _unpack_gemm(data, lay: GemmLayout) -> torch.Tensor:
    w2 = gemm_panels_matrix(data, lay)
    w2 = w2.transpose(-1, -2) if lay.transposed else w2
    return w2.contiguous()


def pack_conv(w: torch.Tensor, layout: ConvLayout) -> PackedOperand:
    """Pack a conv filter bank into the ``(gf, KH, KW, C, bf)`` stream."""
    want = layout.caller_shape
    if w.ndim < len(want) or tuple(w.shape[-len(want):]) != want:
        raise ValueError(f"filter {tuple(w.shape)} does not end in the "
                         f"layout's natural shape {want}")
    if layout.nd == 1:
        w = w.unsqueeze(-4)                    # (..., 1, KW, C, F)
    lead = w.ndim - 4
    gf = -(-layout.f // layout.bf)
    w = _pad_to(w, (gf * layout.bf,))
    t = w.reshape(tuple(w.shape[:lead + 3]) + (gf, layout.bf))
    head = tuple(range(lead))
    data = t.permute(head + (lead + 3, lead + 0, lead + 1, lead + 2,
                             lead + 4)).contiguous()
    _record("pack", tile="conv", bf=layout.bf, shape=tuple(w.shape))
    return PackedOperand(data, layout)


def conv_panels_filter(data: torch.Tensor, lay: ConvLayout) -> torch.Tensor:
    """The (..., KH, KW, C, F) filter bank of a packed stream (1-D layouts
    keep their size-1 KH axis): the plain versions' view of it."""
    lead = data.ndim - 5
    head = tuple(range(lead))
    t = data.permute(head + (lead + 1, lead + 2, lead + 3, lead + 0,
                             lead + 4))
    gf, bf = t.shape[lead + 3:]
    return t.reshape(tuple(t.shape[:lead + 3]) + (gf * bf,))[..., :lay.f]


def _unpack_conv(data, lay: ConvLayout) -> torch.Tensor:
    w = conv_panels_filter(data, lay)
    if lay.nd == 1:
        w = w.squeeze(-4)
    return w.contiguous()


def repack(po: PackedOperand, layout) -> PackedOperand:
    """Re-derive a packed operand under a new layout, counted as a repack
    (not a fresh pack)."""
    w = po.unpack()
    if layout.tile == "conv":
        out = pack_conv(w, layout)
    else:
        out = pack_gemm(w, layout, scale=po.scale, col_sum=po.col_sum)
    COUNTERS["pack"] -= 1
    EVENTS[-1]["event"] = "repack"
    COUNTERS["repack"] += 1
    return out


# ----------------------------------------------------------------------
# The layouts the kernels read, and the block a dispatch runs
# ----------------------------------------------------------------------


def plan_gemm_block(kind: Ger, m: int, n: int, k: int, *, b: int = 1,
                    epilogue_key: str = "none",
                    block: tuple[int, int, int] | None = None,
                    device: str = "cuda") -> tuple:
    """The configuration a kernel-backend GEMM at (b, m, n, k) would run,
    as ``(path, *config)``, in the reference's order: an explicit
    ``block`` wins, then the autotune winner (``lowering.resolve_block``),
    else ``tiling.choose_gemm_path``'s heuristic: the freshness key of a
    packed constant.  ``m`` is the caller's hint for the rows the operand
    will meet, ``device`` the backend the winner is keyed by.  Operands
    are taken as contiguous with 16-byte pitches where K and N allow it.
    An expansion hook (F32GER_3XBF16) plans as the family it runs on.
    The panel a packed operand holds does not follow this plan
    (:data:`PANELS`): the plan keys a store, it never repacks."""
    from repro_torch.core import lowering as _lowering
    kind = _lowering.rep_kind(kind)
    pitch = precision.policy(kind).in_bytes
    aligned = (k * pitch) % 16 == 0 and (n * pitch) % 16 == 0
    block, tuned = _lowering.resolve_block(kind, m, n, k, block,
                                           epilogue_key, b=b, device=device)
    path, cfg = tiling.choose_gemm_path(m, n, k, kind, b, aligned, block,
                                        tuned=tuned)
    return (path, *dataclasses.astuple(cfg))


def gemm_layout(kind: Ger, rows: int, cols: int, *, side: str = "y",
                transposed: bool = False, batched: bool = False
                ) -> GemmLayout:
    """The kernel-native layout of a GEMM weight whose kernel-facing
    matrix is (rows, cols): (K, N) on the Y side, (M, K) on the X side.
    Its panel is :data:`PANEL_BLOCK`'s whatever M the weight meets and
    whichever path a winner picks, so the reference's ``m_hint`` and
    autotune key have no counterpart here."""
    return GemmLayout(kind=kind, block=PANEL_BLOCK, side=side, rows=rows,
                      cols=cols, transposed=transposed, batched=batched)


def conv_layout(kind: Ger, kh: int, kw: int, c: int, f: int, *,
                nd: int = 2) -> ConvLayout:
    """The kernel-native layout of a conv filter bank (filter tile
    :data:`CONV_BF`)."""
    return ConvLayout(kind=kind, bf=CONV_BF, kh=kh, kw=kw, c=c, f=f, nd=nd)


# ----------------------------------------------------------------------
# Dispatch-time freshness
# ----------------------------------------------------------------------

def refresh_gemm(po: PackedOperand):
    """Freshness check at dispatch.  Returns ``(data, layout)``: the
    packed panels and their layout, untouched, while the layout's panel is
    the one the kernels read (:data:`PANELS`, the steady state); else the
    operand is repacked on the spot, once (``repack``, ``invalidate``),
    and ``po`` keeps the new panels.

    Which path the dispatch takes is the kernel wrapper's one decision
    (``kernels/mma_gemm.py``, a tuned winner included); every path reads
    the same panel, whatever M or the winner, so this check needs none of
    them.  There is no reference-style "stale under trace" branch: the
    port does not trace.  The prepack pass writes only fresh layouts: a
    stale one is a weight packed by hand with another block.
    """
    lay = po.layout
    if lay.panel_blocks == PANELS[lay.side]:
        return po.data, lay
    fresh = repack(po, dataclasses.replace(lay, block=PANEL_BLOCK))
    _record("invalidate", have=lay.block, want=PANEL_BLOCK)
    po.data, po.layout = fresh.data, fresh.layout
    return po.data, po.layout


def refresh_conv(po: PackedOperand):
    """Conv analogue of :func:`refresh_gemm`: the filter tile
    :data:`CONV_BF` is the one slab width K3's kernels read, on every
    path (``kernels/mma_conv.py``)."""
    lay = po.layout
    if lay.bf == CONV_BF:
        return po.data, lay
    fresh = repack(po, dataclasses.replace(lay, bf=CONV_BF))
    _record("invalidate", have=lay.bf, want=CONV_BF)
    po.data, po.layout = fresh.data, fresh.layout
    return po.data, po.layout


# ----------------------------------------------------------------------
# Demotion: the one sanctioned packed -> natural conversion for dispatch
# ----------------------------------------------------------------------

def demote_value(v, why: str = "backend", *, dequantized: bool = False):
    """Unpack a packed operand for a lowering that wants natural layout
    (the torch/ref lowerings, op-classes with no packed form).  Counted:
    a steady-state packed fast path never passes through here.

    A quantized operand's natural values are raw int8, which mean the
    weight only under its ``scale``/``col_sum``: it is demoted only for a
    dispatch that applies them (``dequantized``: a ``Dequant`` deprime,
    ``quant.qdot``'s plan), and refused otherwise, as :meth:`PackedOperand
    .to` refuses its cast."""
    if isinstance(v, PackedOperand):
        if v.quantized and not dequantized:
            raise ValueError(
                f"refusing to demote a packed-quantized (int8) operand "
                f"({why}): its values mean the weight only under its "
                f"scale; route it through quant.qdot's I8GER4 Dequant plan")
        _record("demote", why=why)
        return v.unpack()
    return v


def demote_op(op, why: str = "backend"):
    """Demote every packed operand of a resolved Op in one step (quantized
    ones are demoted at admission, where the Dequant is known)."""
    repl = {}
    for field in ("x", "y", "acc", "bias", "residual", "z"):
        v = getattr(op, field)
        if isinstance(v, PackedOperand):
            repl[field] = demote_value(v, why)
    return dataclasses.replace(op, **repl) if repl else op


# ----------------------------------------------------------------------
# PackedStore: persistent packed constants (DFT twiddles, ...)
# ----------------------------------------------------------------------

class PackedStore:
    """Process-global store for packed constant operands, keyed by the
    caller's (name, shape, dtype, block-config) tuple -- the facility-wide
    replacement for per-module private caches.  ``invalidate`` drops
    entries when a key's configuration changes, so the constant is
    re-derived, never read stale."""

    def __init__(self):
        self._entries: dict[tuple, object] = {}

    def get_or_build(self, key: tuple, make):
        hit = self._entries.get(key)
        if hit is None:
            _record("store_build", key=key)
            hit = make()
            self._entries[key] = hit
        else:
            COUNTERS["store_hit"] += 1
        return hit

    def invalidate(self, key: tuple | None = None) -> int:
        """Drop one entry (or every entry whose key starts with ``key``);
        ``None`` clears the store.  Returns the number dropped."""
        if key is None:
            n = len(self._entries)
            self._entries.clear()
            return n
        drop = [k for k in self._entries
                if k == key or k[:len(key)] == key]
        for k in drop:
            del self._entries[k]
        return len(drop)

    def __len__(self):
        return len(self._entries)

    def keys(self):
        return list(self._entries)


STORE = PackedStore()


# ----------------------------------------------------------------------
# prepack_params_for_serving: the pass over a port Model
# ----------------------------------------------------------------------

# Leaves that stay natural: ``tok`` is consumed by an embedding gather AND
# (tied) transposed by ``layers.logits`` -- two orientations, one tensor.
_SKIP_NAMES = frozenset({"tok"})

# Conv filter stacks by name -> spatial ndim (whisper's audio stem is 1-D
# over frames; qwen2-vl's vision patch stem is a 2-D filter bank).
_CONV_NAMES = {"conv1_w": 1, "conv2_w": 1, "patch_w": 2}

# MoE expert banks: (E, d, f) weights whose E axis is the kernel's batch
# axis (specs "ecd,edf->ecf" / "ecf,efd->ecd").
_MOE_NAMES = frozenset({"w1", "w2", "w3"})

_PACKABLE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def prepack_params_for_serving(model: torch.nn.Module, *,
                               min_size: int = 1 << 16,
                               quantize: bool = False):
    """Replace weight parameters of ``model`` by :class:`PackedOperand`s,
    in place, one parameter at a time.

    The rules are the reference's: ``tok`` stays natural; the conv stems'
    filters (``conv1_w``, ``conv2_w``, ``patch_w``) pack into K3's filter
    stream; the MoE banks ``w1/w2/w3`` under a ``moe`` module pack as
    batched Y panels; every other float weight of >= 2 dims and >=
    ``min_size`` elements packs as Y panels, or, with ``quantize=True``
    and fp32, is int8-quantized into X-side I8GER4 panels carrying
    ``scale`` and ``col_sum`` (``quant.qdot``'s orientation).  The conv
    filters are cast once to the operand dtype of the facility's family
    (``facility.current().ger``, the family every dispatch runs: the
    values the per-call policy cast gives, ``models/convert.py``); a bf16
    or f16 weight under an fp32 family is widened once to fp32 (exact, and
    undone exactly by any narrower dispatch's cast), so the tight-parity
    config (F32GER) served prepacked holds fp32 panels, which the fp32
    WMMA tile reads with no per-call cast.  (The reference packs the leaf
    as it is and casts per call.)  Non-float and smaller leaves stay natural.  Note that
    this includes mamba2's 2-D depthwise taps ``conv_w`` where they reach
    ``min_size``; a depthwise call demotes them, as the reference's
    admission does (ROADMAP queue 3), so no SSM arch is served prepacked.

    Each weight leaves ``model._parameters`` before its packed form is set
    as a plain attribute (``nn.Module`` refuses anything else under a
    parameter's name), so the natural tensor is freed as the pass goes:
    the pass never holds two copies of the model.  The reference's
    ``m_hint`` has no counterpart: the port's panels do not depend on M
    (the module docstring says why).

    Returns the stats ``{category: count, "bytes": natural bytes packed,
    "panel_bytes": bytes the packed forms hold}``.  The reference counts a
    stacked layer leaf once; the port's layers are unstacked, so its
    per-category counts are the reference's times the layers, and its
    ``bytes`` equal the reference's wherever the leaf dtypes match.
    ``panel_bytes`` adds the panels' padding and the widening: a bf16
    model prepacked under F32GER holds about twice its natural bytes.
    """
    if not isinstance(model, torch.nn.Module):
        raise TypeError(f"prepack_params_for_serving walks a port Model "
                        f"(an nn.Module), not a {type(model).__name__}")
    from repro_torch.core import facility as _facility
    kind = _facility.current().ger
    pol = precision.policy(kind)
    stats: collections.Counter = collections.Counter()

    def widened(leaf):
        # a 16-bit weight under an fp32 family: the cast is exact, and any
        # later cast to another family's dtype gives the 16-bit values back
        return (leaf.float() if pol.y_dtype == torch.float32
                and leaf.dtype in (torch.bfloat16, torch.float16) else leaf)

    def packed_form(names, leaf):
        last = names[-1]
        if last in _SKIP_NAMES:
            return None
        if last in _CONV_NAMES and leaf.ndim >= _CONV_NAMES[last] + 2:
            nd = _CONV_NAMES[last]
            if nd == 1:
                kh, (kw, c, f) = 1, leaf.shape[-3:]
            else:
                kh, kw, c, f = leaf.shape[-4:]
            stats["conv"] += 1
            stats["bytes"] += leaf.numel() * leaf.element_size()
            lay = conv_layout(kind, kh, kw, c, f, nd=nd)
            w = leaf.to(pol.y_dtype) if leaf.is_floating_point() else leaf
            return pack_conv(w, lay)
        if leaf.dtype not in _PACKABLE_DTYPES:
            return None
        if "moe" in names[:-1] and last in _MOE_NAMES and leaf.ndim >= 3:
            d, f = leaf.shape[-2:]
            stats["moe"] += 1
            stats["bytes"] += leaf.numel() * leaf.element_size()
            lay = gemm_layout(kind, d, f, batched=True)
            return pack_gemm(widened(leaf), lay)
        if leaf.ndim < 2:
            return None
        k, n = leaf.shape[-2:]
        if k * n < min_size:
            return None
        if quantize and leaf.ndim == 2 and leaf.dtype == torch.float32:
            from repro_torch.core import quant as _quant
            q, scale = _quant.quantize_weight(leaf)
            col_sum = q.to(torch.int32).sum(dim=0).to(torch.float32)
            stats["quantized"] += 1
            stats["bytes"] += q.numel()
            lay = gemm_layout(Ger.I8GER4, n, k, side="x", transposed=True)
            return pack_gemm(q, lay, scale=scale, col_sum=col_sum)
        stats["dense"] += 1
        stats["bytes"] += leaf.numel() * leaf.element_size()
        return pack_gemm(widened(leaf), gemm_layout(kind, k, n))

    for mod_name, module in list(model.named_modules()):
        path = mod_name.split(".") if mod_name else []
        for name in list(module._parameters):
            leaf = module._parameters[name]
            if leaf is None:
                continue
            with torch.no_grad():
                po = packed_form(path + [name], leaf.detach())
            if po is None:
                continue
            stats["panel_bytes"] += sum(
                t.numel() * t.element_size()
                for t in (po.data, po.scale, po.col_sum) if t is not None)
            del module._parameters[name]
            setattr(module, name, po)
            del leaf
    return dict(stats)
