"""Roofline models of the port's kernels on an NVIDIA H100 (port of
``repro.roofline.analysis``: the parts that read no HLO text).

Two uses:

  * :class:`RooflineTerms` -- a whole step's compute, memory and
    collective terms and its useful-FLOPs share, as the reference keeps
    them per (arch x shape x mesh) cell;
  * the kernel-level models, the autotuner's ranking prior
    (``core/autotune.py``): :func:`gemm_projected_time` per GEMM path and
    :func:`attn_projected_time` per attention tile and split.

The hardware model is one H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates): 3.35 TB/s of device memory, 989 TFLOP/s bf16/f16 on
the tensor cores, 67 TFLOP/s fp32 (F32GER's FMAs on the CUDA cores) and
fp64 (DMMA), 1979 TOP/s int8 (IMMA), 132 SMs, 450 GB/s of NVLink each
way.  These are the constants PERF.md's bounds use.

The traffic model is per path (``core/tiling.py``'s kernels):

  * the weight stream (:class:`tiling.StreamConfig`) reads X and the
    weight once, and writes and reads back fp32 partials only where a
    tile's K slices span blocks: the 16-bit TMA kernel's units that do not
    fold every slice (:meth:`tiling.StreamConfig.partials`), F32GER's
    kernel wherever K is split (``tiling.stream_plan``'s docstring);
  * the tiles (WMMA, fp32, IMMA's mma.sync kernel, DMMA:
    :class:`tiling.BlockConfig`; the wgmma tile: :class:`tiling.WgmmaConfig`,
    K steps of 64; IMMA's wgmma tile: :class:`tiling.ImmaTileConfig`, K
    steps of 128) read each X
    panel once per N tile and each Y panel once per M tile, and write C
    once: the reference's count for the same block, bit for bit
    (``tests/test_torch_roofline.py``).

Time is charged by waves, which the reference's one-core TPU grid did not
need: a grid of G blocks on an H100 that holds ``occupancy`` of them an SM
runs ceil(G / (132 * occupancy)) waves, each as long as one block's share
of the card's peak, so a partial last wave costs a whole one; and a grid
smaller than one wave moves bytes at the share of the SMs it occupies.
The collective-byte parser (``collective_stats``, ``_shape_bytes``) and
``roofline/report.py`` read XLA's HLO text and dry-run records; they come
with the port's dry run (ROADMAP F2).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import precision, tiling

Ger = precision.Ger

H100 = {
    "peak_flops": 989e12,   # bf16/f16 FLOP/s, dense, tensor cores
    "hbm_bw": 3.35e12,      # bytes/s of device memory
    "link_bw": 450e9,       # bytes/s of NVLink, each way
    "sms": tiling.NUM_SMS,
}

# Peak operations a second by the family's input type.
PEAK_FLOPS = {Ger.BF16GER2: 989e12, Ger.F16GER2: 989e12,
              Ger.F32GER: 67e12, Ger.F32GER_3XBF16: 989e12,
              Ger.F64GER: 67e12, Ger.I8GER4: 1979e12, Ger.I4GER8: 1979e12,
              Ger.I16GER2: 1979e12}

# Int8 tensor-core products a family's product costs: I16GER2 runs four
# (gemm_imma.cu's byte planes, in each of its forms).  The IMMA kernel's
# forms are priced as their shapes say: the wgmma tile
# (tiling.ImmaTileConfig) and the mma.sync kernel's tile as tiles, one
# block an SM; I8GER4's weight stream (tiling.ImmaStreamConfig) by its
# weight's bytes at the blocks an SM its shared memory allows.
_PRODUCTS = {Ger.I16GER2: 4}

# Modeled host time a kernel launch costs the caller: the port's wrapper
# calls took ~35-50 us of host time each on the H100 (PERF.md section 5).
# Charged only where a caller asks (launches > 0); the autotune prior
# ranks candidates of one launch, where a constant cannot move the argmin.
LAUNCH_OVERHEAD_S = 40e-6

WG_BK = 64                   # the wgmma tile's K step (gemm_wgmma.cu)


def peak_flops(pol: precision.GerPolicy) -> float:
    """The card's peak rate for the family's products."""
    return PEAK_FLOPS[pol.ger] / _PRODUCTS.get(pol.ger, 1)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops: float            # 6*N*D (dense) or 6*N_active*D (MoE)

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / H100["peak_flops"]

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / H100["hbm_bw"]

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / H100["link_bw"]

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def step_time_lower_bound(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """The useful tensor-core time over the step's bound: how close
        the program is to 'only useful FLOPs, perfectly overlapped'."""
        ideal = self.model_flops / self.chips / H100["peak_flops"]
        bound = self.step_time_lower_bound
        return ideal / bound if bound else 0.0

    def to_json(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


# ----------------------------------------------------------------------
# Kernel-level GEMM roofline: the autotuner's ranking prior
# ----------------------------------------------------------------------

def _tile(cfg) -> tuple[int, int, int]:
    """(bm, bn, bk) of a tile config (the wgmma tile's K step is 64)."""
    if isinstance(cfg, tiling.WgmmaConfig):
        return cfg.bm, cfg.bn, WG_BK
    return cfg.bm, cfg.bn, cfg.bk


def gemm_traffic_bytes(m: int, n: int, k: int, cfg, pol, b: int = 1) -> int:
    """Device-memory traffic of one launch on ``cfg``'s path.

    The tiles: each X panel is read once per N tile, each Y panel once per
    M tile, C written once (the reference's count).  The weight stream: X
    and the weight read once, C written once, and where a tile's slices
    span blocks (:func:`stream_partials`) the fp32 partials written and
    read back once each.  A batched launch repeats the per-element
    traffic ``b`` times."""
    acc = pol.acc_dtype.itemsize
    if isinstance(cfg, tiling.ImmaStreamConfig):
        # IMMA's weight stream: the weight once, the activations once a
        # 128-row tile, the int32 partials written and read back where K
        # is split
        parts = 2 * 4 * b * cfg.split * m * n if cfg.split > 1 else 0
        return (b * (m * k + -(-m // cfg.bm) * k * n) * pol.in_bytes
                + parts + b * m * n * acc)
    if isinstance(cfg, tiling.StreamConfig):
        parts = (2 * 4 * b * cfg.split * m * n
                 if stream_partials(n, cfg, pol, b) else 0)
        return (b * (m * k + k * n) * pol.in_bytes + parts
                + b * m * n * acc)
    bm, bn, bk = _tile(cfg)
    gm, gn, gk = -(-m // bm), -(-n // bn), -(-k // bk)
    x_reads = b * gm * gn * gk * bm * bk * pol.in_bytes
    y_reads = b * gm * gn * gk * bk * bn * pol.in_bytes
    c_write = b * m * n * acc
    return x_reads + y_reads + c_write


def stream_partials(n: int, cfg, pol, b: int = 1) -> bool:
    """Whether a weight-stream launch writes split-K partials: the 16-bit
    TMA kernel where a tile's slices span units, F32GER's kernel (one
    block a slice) wherever K is split."""
    return cfg.partials(n, b) if pol.in_bytes == 2 else cfg.split > 1


def gemm_blocks(m: int, n: int, k: int, cfg, b: int = 1,
                pol=None) -> int:
    """Thread blocks of one launch on ``cfg``'s path: the weight stream's
    work units (16-bit), or one block a slice (F32GER, ``pol``)."""
    del k
    if isinstance(cfg, tiling.ImmaStreamConfig):
        return cfg.blocks(m, b)
    if isinstance(cfg, tiling.StreamConfig):
        if pol is not None and pol.in_bytes == 4:
            gx, gy, gz = cfg.grid(n, b)
            return gx * gy * gz
        return cfg.blocks(n, b)
    bm, bn, _ = _tile(cfg)
    return b * -(-m // bm) * -(-n // bn)


def _waved_time(blocks: int, occupancy: int, flops: float, nbytes: float,
                peak: float, hw: dict) -> float:
    slots = hw["sms"] * occupancy
    waves = -(-blocks // slots)
    t_compute = waves * slots * (flops / max(blocks, 1)) / peak
    t_memory = nbytes / (hw["hbm_bw"] * min(1.0, blocks / slots))
    return max(t_compute, t_memory)


def gemm_projected_time(m: int, n: int, k: int, cfg, pol,
                        hw: dict = H100, b: int = 1,
                        launches: int = 0) -> float:
    """Roofline seconds of one launch on ``cfg``'s path on the card.

    The compute term charges the padded grid (a fringe tile does a whole
    tile's work) in whole waves; the memory term the path's traffic
    (:func:`gemm_traffic_bytes`) at the share of the card the grid
    occupies.  ``launches`` > 0 adds the modeled host cost a launch."""
    # blocks an SM holds: the weight stream's grid target; the tiles'
    # shared memory and registers hold one
    occ = 1
    if isinstance(cfg, tiling.StreamConfig):
        flops = 2.0 * b * max(m, 1) * n * k
        occ = tiling.BLOCKS_PER_SM
    elif isinstance(cfg, tiling.ImmaStreamConfig):
        # the padded columns' products; the blocks an SM holds
        flops = 2.0 * b * -(-m // cfg.bm) * cfg.bm * cfg.bn * k
        occ = cfg.blocks_per_sm(k)
    else:
        bm, bn, bk = _tile(cfg)
        flops = (2.0 * b * -(-m // bm) * bm * -(-n // bn) * bn
                 * -(-k // bk) * bk)
    t = _waved_time(gemm_blocks(m, n, k, cfg, b, pol), occ, flops,
                    gemm_traffic_bytes(m, n, k, cfg, pol, b),
                    peak_flops(pol), hw)
    return t + launches * LAUNCH_OVERHEAD_S


def gemm_projected_util(m: int, n: int, k: int, cfg, pol,
                        hw: dict = H100, b: int = 1,
                        launches: int = 0) -> float:
    """Useful-FLOPs fraction of peak under the projected time (the paper's
    Figure 11 score: % of peak against problem size)."""
    ideal = 2.0 * b * m * n * k / peak_flops(pol)
    t = gemm_projected_time(m, n, k, cfg, pol, hw, b, launches)
    return ideal / t if t else 0.0


# ----------------------------------------------------------------------
# Kernel-level attention roofline: the attention autotuner's prior
# ----------------------------------------------------------------------
# Two chained products a (q block, kv block) step, QK^T and PV, with the
# output and its m/l state resident across the KV loop.  The compute term
# charges only the live blocks of the bounded schedule; the memory term
# charges K/V panel reads a live step, Q once a query block and one O
# write, plus, with KV split over n_split blocks, the fp32 partials and
# their (m, l) written and read back by the merge.  ``bk`` is the step
# the kernel walks: the reference's 64, or the 16-bit tile mode's 128 at
# D <= 128 (steps aligned to multiples of 128, so a diagonal or window
# edge charges up to a step more: ``kernels.mma_attention.kv_step``), as
# :func:`attn_projected_time` passes it.


def attn_flops(bh: int, sq: int, sk: int, d: int, bq: int, bk: int, *,
               causal: bool = True, q_offset: int = 0,
               window: int | None = None) -> float:
    """Tensor-core FLOPs of the bounded flash schedule (padded to block
    granularity: a partly masked block still does its whole work)."""
    from repro_torch.kernels import mma_attention as _attn
    n_live = _attn.attn_live_steps(sq, sk, bq, bk, causal=causal,
                                   q_offset=q_offset, window=window)
    return 4.0 * bh * n_live * bq * bk * d      # QK^T + PV, 2*m*n*k each


def attn_traffic_bytes(bh: int, sq: int, sk: int, d: int, bq: int, bk: int,
                       pol, *, causal: bool = True, q_offset: int = 0,
                       window: int | None = None, n_split: int = 1) -> int:
    """Device-memory traffic: Q once a query block, one (bk, d) K and V
    panel a live step, O written once (the reference's count); with
    ``n_split`` > 1 also each split's fp32 (d + 2)-wide partial row
    written and read back."""
    from repro_torch.kernels import mma_attention as _attn
    n_live = _attn.attn_live_steps(sq, sk, bq, bk, causal=causal,
                                   q_offset=q_offset, window=window)
    q_reads = bh * (-(-sq // bq)) * bq * d * pol.in_bytes
    kv_reads = bh * n_live * 2 * bk * d * pol.in_bytes
    o_write = bh * sq * d * pol.in_bytes
    parts = 2 * 4 * bh * sq * n_split * (d + 2) if n_split > 1 else 0
    return q_reads + kv_reads + o_write + parts


def attn_projected_time(bh: int, sq: int, sk: int, d: int, bq: int,
                        bk: int, pol, hw: dict = H100, *,
                        causal: bool = True, q_offset: int = 0,
                        window: int | None = None, n_split: int = 1,
                        launches: int = 0) -> float:
    """Roofline seconds of one attention launch: (bh, query block, split)
    blocks, one an SM, charged in waves as :func:`gemm_projected_time`
    charges them, over the steps the kernel walks (``bk``, the schedule's
    block, widened to the launch's ``kv_step``); ``launches`` > 0 adds
    the modeled host cost a launch."""
    from repro_torch.kernels import mma_attention as _attn
    f32 = pol.in_bytes == 4
    bk = max(bk, _attn.kv_step(_attn.compiled_depth(d, f32) or d, f32,
                               n_split))
    blocks = bh * -(-sq // bq) * n_split
    flops = attn_flops(bh, sq, sk, d, bq, bk, causal=causal,
                       q_offset=q_offset, window=window)
    nbytes = attn_traffic_bytes(bh, sq, sk, d, bq, bk, pol, causal=causal,
                                q_offset=q_offset, window=window,
                                n_split=n_split)
    t = _waved_time(blocks, 1, flops, nbytes, peak_flops(pol), hw)
    return t + launches * LAUNCH_OVERHEAD_S


def attn_projected_util(bh: int, sq: int, sk: int, d: int, bq: int,
                        bk: int, pol, hw: dict = H100, *,
                        causal: bool = True, q_offset: int = 0,
                        window: int | None = None, n_split: int = 1,
                        launches: int = 0) -> float:
    """Useful-FLOPs fraction of peak: the numerator counts only the live
    (q, k) position pairs, so block padding and split merges both show
    up as lost utilization."""
    from repro_torch.kernels import mma_attention as _attn
    pairs = _attn.attn_live_pairs(sq, sk, causal=causal, q_offset=q_offset,
                                  window=window)
    ideal = 4.0 * bh * pairs * d / peak_flops(pol)
    t = attn_projected_time(bh, sq, sk, d, bq, bk, pol, hw, causal=causal,
                            q_offset=q_offset, window=window,
                            n_split=n_split, launches=launches)
    return ideal / t if t else 0.0


# ----------------------------------------------------------------------
# Model FLOPs
# ----------------------------------------------------------------------

def _encdec_split(cfg) -> tuple[float, float]:
    """Rough (encoder, decoder) active-param split for enc-dec archs:
    encoder = enc_layers * (attn + ffn); decoder adds cross-attn."""
    d = cfg.d_model
    attn = d * cfg.head_dim * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    ffn = d * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    n_enc = cfg.encoder_layers * (attn + ffn)
    n_dec = cfg.num_layers * (2 * attn + ffn) + 2 * cfg.vocab_size * d
    return n_enc, n_dec


def model_flops_for(cfg, shape_info) -> float:
    """6*N*D training / 2*N*D inference FLOPs (D = tokens processed).

    Enc-dec archs split N: encoder params see the post-conv-stem encoder
    positions (``cfg.encoder_len(seq)``), decoder params see
    ``decoder_len`` tokens."""
    n = cfg.active_param_count()
    b, s = shape_info["batch"], shape_info["seq"]
    if shape_info["kind"] == "train":
        if cfg.is_enc_dec:
            n_enc, n_dec = _encdec_split(cfg)
            return 6.0 * b * (n_enc * cfg.encoder_len(s)
                              + n_dec * cfg.decoder_len)
        return 6.0 * n * b * s
    if shape_info["kind"] == "prefill":
        if cfg.is_enc_dec:
            n_enc, n_dec = _encdec_split(cfg)
            return 2.0 * b * (n_enc * cfg.encoder_len(s)
                              + n_dec * cfg.decoder_len)
        return 2.0 * n * b * s
    # decode: one token per sequence
    return 2.0 * n * shape_info["batch"]
