// Flash attention for Hopper (sm_90a): TMA + wgmma for 16-bit prefill, a
// split-KV decode kernel for short queries, and fp32 CUDA-core tiles.
//
// Replaces the TPU kernel K2: repro/kernels/mma_attention.py,
// mma_flash_attention (kernel body _flash_kernel, schedule attn_grid_plan):
//
//     out = cast(epilogue(softmax(Q K^T * D^-1/2 + mask) V))
//
// q (B, Sq, H, D), k and v (B, Sk, KVH, D), bf16, f16 or (K2e, the F32GER
// policy's operands) f32, D = 32, 64, 128 or 192 (f32: 160 for 192), fp32
// online softmax.  The scale comes from the caller (the wrapper passes the
// logical depth's D^-1/2): a depth that is not compiled -- ABFT's checksum
// column makes deepseek's 128 a 129 and whisper's 64 a 65 -- is zero-padded
// to the next compiled one by the wrapper (kernels/mma_attention.py),
// which leaves Q K^T unchanged, and the padded output columns are dropped.
// 192 = 3 x 64 keeps the 128-byte swizzled boxes; the 16-bit tile runs it
// on the 64-row tile only (steps of 64 keys, 3 ring stages, 197,760 bytes
// of shared memory; 232 registers a consumer thread, no spill), as the
// 128-row tile's 96 fp32 accumulators a thread spilled; fp32's 160 holds
// its 128-row tile in 226,816 bytes.  Query head h reads KV head
// h / (H / KVH) (GQA) without materialising the repeat.  The mask is the
// conjunction of the causal, sliding-window, q_offset and valid-slot
// predicates.
//
// What bounds it on an H100.  Prefill past a few hundred tokens does
// 4 * D flops per live (q, k) pair over inputs read once: the bf16 tensor
// cores (989 TFLOP/s) bound it, and only wgmma reaches them; fp32 operands
// run on the CUDA cores (67 TFLOP/s).  One query over a long cache
// (whisper's decode cross-attention, Sq = 1 over 1500 positions) reads K
// and V once for 4 * D flops per position: bytes bound it, and the card is
// filled only if the positions are split over blocks.
//
// Design of the 16-bit tile mode (flash_tile_kernel, n_split = 1).
//   * Persistent blocks: min(tiles, the blocks the card holds at once)
//     walk a static list of (b, h, q tile) tiles -- q tiles of 128 rows
//     (two consumer warpgroups), 64 where 128-row tiles would leave SMs
//     idle -- listed head by head, each head's tiles the longest first when
//     causal, so that the tiles running at once share their K and V in
//     L2; the blocks take the list in rounds of gridDim.x, every other
//     round backwards (a snake), which evens out their steps.  A tile's
//     result does not depend on the block, the tile size or the batch.
//   * Steps of 128 keys (64 at D = 192, where S and O would not fit the
//     registers), aligned to absolute multiples of the step: the bounds
//     are attn_k_bounds' arithmetic at bk = the step, which is its range
//     of 64-key blocks widened to that alignment; the extra keys are
//     masked.
//   * Warpgroup 0 is the producer: one thread loads each tile's Q into one
//     of two Q buffers (the next tile's lands while this one finishes) and
//     its K and V steps into a ring of 2-3 stages by TMA, K and V on
//     barriers of their own, from 4-D tensor maps (D, H, S, B) -- the KV
//     head coordinate is h / group, so GQA repeats nothing, and TMA
//     zero-fills the ragged S edge.  Boxes are 128-byte swizzled rows of
//     64 elements (64-byte rows for D = 32).  Ring position and phases run
//     on across tiles.
//   * Each consumer warpgroup owns 64 query rows.  S = Q K^T runs on
//     wgmma (both operands K-major in D); the online softmax runs in
//     registers in the exp2 domain with the scale folded in, masking only
//     the steps that cross the diagonal, the window edge, the Sk fringe
//     or a valid predicate (each row's live columns as a range; valid's
//     bytes read once a step); P is rounded to the input type (as the
//     reference rounds it) and fed from registers as the A operand of
//     O += P V (V is MN-major: tnspB).  O, m and l stay in registers for
//     the tile's KV loop, which is software-pipelined: S of step i is
//     issued with O += P V of step i - 1, and step i's softmax runs
//     while the tensor cores finish the latter.  The two consumers take
//     turns to issue (named barriers: a ping-pong), so that one's softmax
//     runs while the other's GEMMs do.
//   * The store: without an epilogue, O is normalised and rounded to T in
//     registers, staged in the consumer's rows of the Q buffer and written
//     in 16-byte rows; with one (or another output type) it goes through
//     the same rows in fp32, half the columns at a time, to one loop of
//     attn_store2.  The buffer then goes back to the producer.
//
// The split-KV mode (flash_decode_kernel, n_split > 1, every input type;
// chosen by the wrapper for Sq <= 64 from H, Sq and Sk alone, so that a row
// sums in one order at any batch).  A 64-row tile for one query row spent
// its life on fixed costs; this kernel is shaped for the bytes instead.
//   * One block of four warps owns (b, h, split): the split's `per`
//     consecutive KV blocks of 64 keys of the live range, streamed through
//     a ring of 2-3 stages by 16-byte cp.async (rows past Sk zero-filled,
//     GQA by the KV head index), one __syncthreads a block, the next
//     blocks' copies in flight under this one's arithmetic.
//   * Rows in 16-row slices (the m16 of mma.sync).  For Sq <= 16 the four
//     warps share the one slice and split each block's keys into quarters
//     of 16; else each warp owns a slice and all 64 keys.  Each warp keeps
//     its own running max, sum and O, so a warp whose keys or rows are all
//     dead skips the step (its state would not move).
//   * 16-bit operands: S = Q K^T by mma.sync m16n8k16 (Q's fragments in
//     registers from the start, K by ldmatrix), the online softmax on the
//     fragments in the exp2 domain, P rounded to T against the warp's
//     running max straight into the A fragments of O += P V (V by
//     ldmatrix.trans), fp32 accumulation.  fp32 operands: the same
//     fragment layout on true fp32 FMAs (float4 reads of Q and K along D;
//     P handed along the quad by shuffles, V read in float2s), P kept in
//     fp32 and exp2f throughout.
//   * The warps of a slice merge their partials through shared memory in
//     warp order (log-sum-exp) into the split's fp32 partial --
//     unnormalised O, its max m (log2 domain) and sum l.  The splits of a
//     (b, h), at most 8 (the portable cluster size: the plan takes longer
//     splits past that), are launched as one thread-block cluster: after
//     a cluster barrier the block of rank 0 merges the partials from the
//     others' shared memory in split order, applies the guard, the
//     normalisation and the epilogue once, and a second barrier keeps the
//     others resident until it has.  No workspace, no second launch.  The
//     merge order is fixed, so a row's result does not depend on which
//     split finishes first or on the batch.
//
// The fp32 tile (flash_f32_tile_kernel, K2e: f32 q, k, v, the tight-parity
// F32GER config, n_split = 1).  The tensor cores would round fp32 to TF32,
// which F32GER forbids, so it runs true fp32 FMAs, as F32GER's GEMM does
// (tile_gemm.cuh's f32_simt_tile).
//   * Eight warps; each owns RW = 16 query rows (the 128-row tile) or 8
//     (the 64-row tile, where 128-row tiles would leave SMs idle) and
//     walks the tile's live steps of 64 keys (32 at D = 160), skipping
//     those dead for all its rows.  One block a tile, in rounds of the
//     (b, h) pairs, the longest first: q tiles descending when causal,
//     ascending otherwise (a ragged last q tile in the last wave).
//   * The Q tile and a 2-3 stage ring of K and V steps sit in shared
//     memory, filled by 16-byte cp.async (zero past Sq and Sk; GQA by the
//     KV head index), one __syncthreads a step.  K rows are padded by 16
//     bytes (a load's keys on distinct banks); Q and V rows are not (at
//     D = 128 the 128-row tile's Q, P and two 64-key stages then fit one
//     block's 227 KB), Q's 16-byte chunks XOR-swizzled by the lane row
//     group that reads them.
//   * S: lane (r, c) of a warp's (32 / KG) x KG grid, KG = step / 4, holds
//     SR = RW * KG / 32 consecutive rows by 4 keys (c + KG j): 8 x 4 on
//     the 128-row tile at 64-key steps (12 float4 loads for 128 FMAs), 4 x
//     4 on the 64-row tile.  The loads are float4s of Q (broadcast over
//     the row group) and K along D.  The online softmax runs in the log2
//     domain with exp2f (no approximate ex2), its row max and sum reduced
//     over the row's KG lanes by shuffles; P stays fp32 (the reference
//     rounds P to v's dtype: here f32) and goes to the warp's own
//     key-major P buffer with the rows' corrections, behind a __syncwarp.
//   * O += P V: lane (r, c) of a 2 x 16 grid holds RW / 2 rows by D / 16
//     columns (float4s at c * 4 + 64 i, a float2 past the last 64), so
//     each key reads float4s of P and V: RW * D / 32 FMAs for a few
//     loads.  Both tiles of a depth share the step and the lane grid's
//     width, so each row sums its keys in one order on either tile: the
//     two tiles give the same bits.
//   * What holds it back (PERF.md): at D = 128 either tile holds one
//     block of 8 warps an SM (shared memory), and the 8 x 4 S tile ran
//     within 2% of the 2 x 4 one it replaced at deepseek-7b's train
//     shape, at ~0.36 of the fp32 peak; how the rest splits between
//     shared-memory traffic, the softmax and latency is not measured.
//   * The store goes through shared memory (O over the Q tile, l beside
//     it): one loop of paired stores and one copy of the epilogue.
//
// Every mode:
//   * The masked-block guard: p = 0 where the running max is still -inf,
//     and a row with l = 0 stores 0 before the epilogue.
//   * The full grid (K2d: the reference's mma_flash_attention(bound_grid=
//     False), its attn_grid_plan(bound=False)): with AttnArgs.bound = 0
//     every q tile walks all KV steps, lo = 0 and hi = nk, the rectangular
//     schedule the bounded one is measured against.  A step with no live
//     slot leaves the state untouched: its row max is -inf, so m keeps its
//     value, the correction is exp2(0) = 1, every p is 0, l gains 0 and O
//     gains P V = 0 exactly (a warp of the decode and fp32 kernels skips
//     it outright).  So the full grid's tile modes are the bounded launch
//     bit for bit, and so are a row's results on either q tile.  In
//     split-KV mode the splits partition [0, nk) instead of the live range
//     [lo, hi): bit for bit too where lo = 0 (the blocks past hi are dead,
//     a split of them only contributes m = -inf, l = 0: weight 0), else
//     the live blocks group otherwise and P rounds against other split
//     maxima (within the wrapper's stated budget).

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

// exp2 on the special-function unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct AttnArgs {
  const unsigned char* valid;  // (B, Sk) or null
  const void* bias;            // (D,) or null
  const void* res;             // (B, Sq, H, D) or null
  void* out;                   // (B, Sq, H, D)
  int bias_dt, res_dt, out_dt;
  int B, Sq, Sk, H, KVH, group, D;
  int causal, q_offset, window;  // window <= 0: no window
  float scale_log2;              // D^-1/2 * log2(e)
  int act;
  int n_split, per_split;        // KV blocks per split
  int bound;                     // 0: the full grid, every KV block (K2d)
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Normalise (l == 0 rows store 0), epilogue, cast: two adjacent d of a row.
__device__ __forceinline__ void attn_store2(const AttnArgs& a, int b, int s,
                                            int h, int d, float o0, float o1,
                                            float l) {
  const float inv_den = l == 0.f ? 1.f : l;
  const long long idx = (((long long)b * a.Sq + s) * a.H + h) * a.D + d;
  const float v0 = epilogue_apply(o0 / inv_den, a.act, a.bias, a.bias_dt, d,
                                  a.res, a.res_dt, idx);
  const float v1 = epilogue_apply(o1 / inv_den, a.act, a.bias, a.bias_dt,
                                  d + 1, a.res, a.res_dt, idx + 1);
  if (a.out_dt == DT_BF16) {
    *reinterpret_cast<__nv_bfloat162*>(
        reinterpret_cast<__nv_bfloat16*>(a.out) + idx) =
        __floats2bfloat162_rn(v0, v1);
  } else if (a.out_dt == DT_F16) {
    *reinterpret_cast<__half2*>(reinterpret_cast<__half*>(a.out) + idx) =
        __floats2half2_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(a.out) + idx) =
        make_float2(v0, v1);
  }
}

// ---- split-KV (n_split > 1): the decode kernel, every input type ---------

// Shared memory an SM gives each of two resident blocks (228 KB less 1 KB
// reserved a block) and the most one block may take.
constexpr long long SMEM_TWO_A_SM = 115712, SMEM_ONE_A_SM = 232448;

// The decode kernel's shapes for operands of type T at depth D;
// tests/test_torch_attention.py mirrors them (decode_config).  Four warps
// over one 64-row q tile; K and V rows padded by 16 bytes (the 8 rows an
// ldmatrix or a float4 read touches lie on distinct banks); fp32 Q staged
// in shared memory (16-bit Q goes straight into the registers); a ring of
// 2-3 stages of one 64-key block each, as deep as two blocks an SM allow,
// else one block an SM (a third stage ran faster than a fourth: PERF.md).
// The warps' partials and the split's alias the ring after the loop.
constexpr int DEC_THREADS = 128, DEC_BQ = 64, DEC_BKV = 64;
// The most splits that merge as one cluster (the portable cluster size);
// kernels/mma_attention.py's DECODE_CLUSTER_MAX.
constexpr int DEC_CLUSTER_MAX = 8;

template <typename T, int D>
struct DecodeCfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int LDK = F32 ? D + 4 : D + 8;  // K/V row pitch (elements)
  static constexpr int LDQ = D + 4;                // fp32 Q row pitch
  static constexpr long long Q_BYTES = F32 ? 4LL * DEC_BQ * LDQ : 0;
  static constexpr long long STAGE = 2LL * DEC_BKV * LDK * (long long)sizeof(T);
  static constexpr long long FIT2 = (SMEM_TWO_A_SM - Q_BYTES) / STAGE;
  static constexpr int MIN_BLOCKS = FIT2 >= 2 ? 2 : 1;
  static constexpr long long FIT =
      MIN_BLOCKS == 2 ? FIT2 : (SMEM_ONE_A_SM - Q_BYTES) / STAGE;
  static constexpr int STAGES = FIT > 3 ? 3 : (int)FIT;
  static_assert(STAGES >= 2, "the ring holds two KV blocks at a time");
  static_assert(2LL * 64 * (D + 2) * 4 <= STAGES * STAGE,
                "the warps' and the split's partials fit in the ring");
  static constexpr size_t smem = (size_t)(Q_BYTES + STAGES * STAGE);
};

template <bool F32>
__device__ __forceinline__ float attn_exp2(float x) {
  if constexpr (F32)
    return exp2f(x);  // within two ulps: rounding_budget's f32 terms count it
  else
    return fast_exp2(x);
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

template <typename T, int D, int KS>
__global__ void __launch_bounds__(DEC_THREADS, DecodeCfg<T, D>::MIN_BLOCKS)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, AttnArgs a) {
  using C = DecodeCfg<T, D>;
  constexpr bool F32 = C::F32;
  constexpr int LDK = C::LDK, LDQ = C::LDQ, S = C::STAGES;
  constexpr int KW = DEC_BKV / KS, NT = KW / 8;  // keys a warp takes a block
  constexpr int PW = D + 2;                      // a partial row: O, m, l
  extern __shared__ __align__(16) unsigned char dec_smem[];
  float* qsm = reinterpret_cast<float*>(dec_smem);  // fp32 Q (64, D + 4)
  T* ring = reinterpret_cast<T*>(dec_smem + C::Q_BYTES);

  const int h = blockIdx.y;
  const int b = blockIdx.z / a.n_split, split = blockIdx.z % a.n_split;
  const int kvh = h / a.group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = (warp / KS) * 16, kq = warp % KS;  // rows, key quarter

  // The live KV blocks of the q tile, attn_k_bounds(0, nk, bq=64, bk=64,
  // ...), or with the full grid (bound = 0) all nk; this split's share of
  // them (possibly none).
  const int nk = (a.Sk + DEC_BKV - 1) / DEC_BKV;
  int hi = nk;
  if (a.bound && a.causal) {
    const long long e = (long long)a.q_offset + DEC_BQ;
    hi = max((int)min((long long)nk, (e + DEC_BKV - 1) / DEC_BKV), 1);
  }
  int lo = 0;
  if (a.bound && a.window > 0) {
    const long long e = (long long)a.q_offset - (a.window - 1);
    lo = min(e > 0 ? (int)(e / DEC_BKV) : 0, hi - 1);
  }
  lo += split * a.per_split;
  hi = min(hi, lo + a.per_split);
  const int nkb = max(hi - lo, 0);

  const long long kvstride = (long long)a.KVH * D, qstride = (long long)a.H * D;
  const T* kb = k + ((long long)b * a.Sk * a.KVH + kvh) * D;
  const T* vb = v + ((long long)b * a.Sk * a.KVH + kvh) * D;
  const T* qb = q + ((long long)b * a.Sq * a.H + h) * D;
  // block i of the split into stage i % S: K then V, 64 rows of D
  auto load = [&](int i) {
    constexpr int EPC = 16 / (int)sizeof(T), CH = D / EPC;
    T* ks = ring + (i % S) * 2 * DEC_BKV * LDK;
    T* vs = ks + DEC_BKV * LDK;
    const int k0 = (lo + i) * DEC_BKV;
    for (int c = threadIdx.x; c < DEC_BKV * CH; c += DEC_THREADS) {
      const int r = c / CH, off = (c % CH) * EPC;
      const bool in = k0 + r < a.Sk;
      const long long at = in ? (long long)(k0 + r) * kvstride + off : 0;
      cp_async16(ks + r * LDK + off, kb + at, in);
      cp_async16(vs + r * LDK + off, vb + at, in);
    }
  };
  if constexpr (F32) {  // the tile's 64 Q rows, zero past Sq
    const float* qf32 = reinterpret_cast<const float*>(qb);
    for (int c = threadIdx.x; c < DEC_BQ * (D / 4); c += DEC_THREADS) {
      const int r = c / (D / 4), off = (c % (D / 4)) * 4;
      const bool in = r < a.Sq;
      cp_async16(qsm + r * LDQ + off, qf32 + (in ? r * qstride + off : 0), in);
    }
  }
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nkb) load(s);
    cp_async_commit();
  }
  // 16-bit Q: the slice's A fragments (rows g, g + 8; columns 2t, 2t + 8
  // of each 16-deep slice), zero past Sq
  uint32_t qf[F32 ? 1 : D / 16][4];
  if constexpr (!F32) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + g + ((e & 1) ? 8 : 0);
        const int d = 16 * kk + 2 * t + ((e & 2) ? 8 : 0);
        qf[kk][e] = r < a.Sq ? *reinterpret_cast<const uint32_t*>(
                                   qb + r * qstride + d)
                             : 0u;
      }
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float mrow[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, lrow[2] = {0.f, 0.f};
  const bool rows_live = row0 < a.Sq;
  const long long plo = (long long)a.q_offset + row0;  // the slice's positions
  const long long phi = (long long)a.q_offset + min(row0 + 15, a.Sq - 1);

  for (int i = 0; i < nkb; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();  // block i is whole; every warp is past block i - 1
    if (i + S - 1 < nkb) load(i + S - 1);
    cp_async_commit();
    const int kbase = (lo + i) * DEC_BKV + kq * KW;  // the warp's first key
    // keys dead for every row of the slice leave its state untouched
    if (!rows_live || kbase >= a.Sk || (a.causal && kbase > phi) ||
        (a.window > 0 && (long long)kbase + KW - 1 <= plo - a.window))
      continue;
    const T* ks = ring + (i % S) * 2 * DEC_BKV * LDK + kq * KW * LDK;
    const T* vs = ks + DEC_BKV * LDK;

    // S = Q K^T: the m16n8 fragments of NT 8-key tiles
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if constexpr (F32) {
      const float* q0r = qsm + (row0 + g) * LDQ;
      const float* kr = reinterpret_cast<const float*>(ks) + 2 * t * LDK;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(q0r + d);
        const float4 qz = *reinterpret_cast<const float4*>(q0r + 8 * LDQ + d);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float4 ka =
              *reinterpret_cast<const float4*>(kr + 8 * j * LDK + d);
          const float4 kz =
              *reinterpret_cast<const float4*>(kr + (8 * j + 1) * LDK + d);
          sc[j][0] = dot4(qa, ka, sc[j][0]);
          sc[j][1] = dot4(qa, kz, sc[j][1]);
          sc[j][2] = dot4(qz, ka, sc[j][2]);
          sc[j][3] = dot4(qz, kz, sc[j][3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, ks + (16 * np + lane % 8 + 8 * (lane / 16)) * LDK +
                             16 * kk + 8 * ((lane / 8) % 2));
          mma16816<T>(sc[2 * np], qf[kk], r[0], r[1]);
          mma16816<T>(sc[2 * np + 1], qf[kk], r[2], r[3]);
        }
    }

    // Scale (log2 domain) and mask, the new running max, P in sc.
    const bool need_mask = kbase + KW > a.Sk || a.valid != nullptr ||
                           (a.causal && kbase + KW - 1 > plo) ||
                           (a.window > 0 && phi - kbase >= a.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (need_mask) {
          const int kpos = kbase + 8 * j + 2 * t + (e & 1);
          const long long qpos = plo + g + (e >= 2 ? 8 : 0);
          bool live = kpos < a.Sk;
          if (a.causal) live = live && qpos >= kpos;
          if (a.window > 0) live = live && (qpos - kpos < a.window);
          if (a.valid != nullptr && live)
            live = a.valid[(long long)b * a.Sk + kpos] != 0;
          if (!live) sc[j][e] = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float neg_m[2], corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_blk = quad_max(mx[r]);
      const float m_new = m_blk == -INFINITY
                              ? mrow[r]
                              : fmaxf(mrow[r], m_blk * a.scale_log2);
      corr[r] = attn_exp2<F32>(mrow[r] - m_new);
      mrow[r] = m_new;
      // masked-block guard: no live slot yet, the row contributes zeros
      neg_m[r] = m_new == REPRO_NEG_INF ? -INFINITY : -m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = attn_exp2<F32>(
            fmaf(sc[j][e], a.scale_log2, neg_m[e >> 1]));
        sc[j][e] = p;
        psum[e >> 1] += p;
      }
    lrow[0] = lrow[0] * corr[0] + psum[0];
    lrow[1] = lrow[1] * corr[1] + psum[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P V
    if constexpr (F32) {
      // key 8j + kk's p of rows g and g + 8 sits in lane (g, kk / 2)
      const float* vr0 = reinterpret_cast<const float*>(vs) + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int src = (lane & ~3) | (kk >> 1);
          const float p0 =
              __shfl_sync(0xffffffffu, (kk & 1) ? sc[j][1] : sc[j][0], src);
          const float p1 =
              __shfl_sync(0xffffffffu, (kk & 1) ? sc[j][3] : sc[j][2], src);
          const float* vr = vr0 + (8 * j + kk) * LDK;
#pragma unroll
          for (int nd = 0; nd < D / 8; ++nd) {
            const float2 w = *reinterpret_cast<const float2*>(vr + 8 * nd);
            o[nd][0] = fmaf(p0, w.x, o[nd][0]);
            o[nd][1] = fmaf(p0, w.y, o[nd][1]);
            o[nd][2] = fmaf(p1, w.x, o[nd][2]);
            o[nd][3] = fmaf(p1, w.y, o[nd][3]);
          }
        }
    } else {
      // P rounded to T against the running max: the A fragments
      uint32_t pa[KW / 16][4];
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        pa[kk][0] = pack2<T>(sc[2 * kk][0], sc[2 * kk][1]);
        pa[kk][1] = pack2<T>(sc[2 * kk][2], sc[2 * kk][3]);
        pa[kk][2] = pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[kk][3] = pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      }
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk)
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(
              r, vs + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) * LDK +
                     16 * np + 8 * (lane / 16));
          mma16816<T>(o[2 * np], pa[kk], r[0], r[1]);
          mma16816<T>(o[2 * np + 1], pa[kk], r[2], r[3]);
        }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the partials alias it
  lrow[0] = quad_sum(lrow[0]);
  lrow[1] = quad_sum(lrow[1]);
  float* part = reinterpret_cast<float*>(dec_smem + C::Q_BYTES);
  float* mine = part + warp * 16 * PW;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = mine + (g + 8 * r) * PW;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + 2 * t) =
          make_float2(o[j][2 * r], o[j][2 * r + 1]);
    if (t == 0) {
      row[D] = mrow[r];
      row[D + 1] = lrow[r];
    }
  }
  __syncthreads();
  // The split's fp32 partial of each row: its slice's KS warps merged in
  // warp order, into shared memory beside the warps' partials.
  float* splits_part = part + 4 * 16 * PW;  // (Sq, D + 2): O, m, l
  for (int i = threadIdx.x; i < a.Sq * (D / 2); i += DEC_THREADS) {
    const int s = i / (D / 2), d = 2 * (i % (D / 2));
    const float* p0 = part + (s / 16) * KS * 16 * PW + (s % 16) * PW;
    float m = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < KS; ++w) m = fmaxf(m, p0[w * 16 * PW + D]);
    float l = 0.f, o0 = 0.f, o1 = 0.f;
    if (m != REPRO_NEG_INF) {
#pragma unroll
      for (int w = 0; w < KS; ++w) {
        const float* pw = p0 + w * 16 * PW;
        const float f = attn_exp2<F32>(pw[D] - m);
        l += f * pw[D + 1];
        o0 += f * pw[d];
        o1 += f * pw[d + 1];
      }
    }
    float* row = splits_part + s * PW;
    *reinterpret_cast<float2*>(row + d) = make_float2(o0, o1);
    if (d == 0) *reinterpret_cast<float2*>(row + D) = make_float2(m, l);
  }

  // The splits of (b, h) are one cluster, split s its block of rank s:
  // rank 0 merges the partials from the others' shared memory in split
  // order, and every block stays until it has.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int i = threadIdx.x; i < a.Sq * (D / 2); i += DEC_THREADS) {
      const int s = i / (D / 2), d = 2 * (i % (D / 2));
      float m = REPRO_NEG_INF;
      for (int p = 0; p < a.n_split; ++p)
        m = fmaxf(m, cluster.map_shared_rank(splits_part, p)[s * PW + D]);
      float l = 0.f, o0 = 0.f, o1 = 0.f;
      if (m != REPRO_NEG_INF) {
        for (int p = 0; p < a.n_split; ++p) {  // split order
          const float* row = cluster.map_shared_rank(splits_part, p) + s * PW;
          const float f = attn_exp2<F32>(row[D] - m);
          const float2 op = *reinterpret_cast<const float2*>(row + d);
          l += f * row[D + 1];
          o0 += f * op.x;
          o1 += f * op.y;
        }
      }
      attn_store2(a, b, s, h, d, o0, o1, l);
    }
  }
  cluster.sync();
}

// ---- the 16-bit tile mode (n_split == 1): persistent, ping-ponged ---------

// The tile mode's shapes at depth D with NC consumer warpgroups (q tiles of
// 64 * NC rows); tests/test_torch_attention.py mirrors them (tile_config).
// Steps of BKV keys, aligned to absolute multiples of BKV: 128 where S
// (m64n128, 64 fp32 a thread) fits the registers beside O, 64 at D = 192.
// Two Q buffers (the next tile's Q lands while this one finishes) and a
// ring of 2-3 K and V stages with their own barriers.
template <int D, int NC>
struct TileCfg {
  static constexpr int BQ = 64 * NC;
  static constexpr int BKV = D <= 128 ? 128 : 64;
  static constexpr int SWB = D * 2 >= 128 ? 128 : D * 2;  // bytes a box row
  static constexpr int CH = SWB / 2;                       // elements a box row
  static constexpr int NCH = D / CH;                       // boxes across D
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int THREADS = 128 * (NC + 1);
  // two blocks an SM where registers and shared memory allow (the 64-row
  // tile at D <= 64), else one
  static constexpr int MIN_BLOCKS = (NC == 1 && D <= 64) ? 2 : 1;
  static constexpr int BUDGET = (MIN_BLOCKS == 2 ? 110 : 225) * 1024;
  static constexpr int FREE = (BUDGET - 2 * Q_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = FREE > 3 ? 3 : FREE;
  static_assert(STAGES >= 2, "the loop holds two steps at a time");
  static constexpr int NBAR = 4 + 4 * STAGES;
  static constexpr size_t smem =
      1024 + 2 * (size_t)Q_BYTES + 2 * (size_t)STAGES * KV_BYTES + 8 * NBAR;
};

template <typename T>
struct DtOf;
template <>
struct DtOf<__nv_bfloat16> {
  static constexpr int v = DT_BF16;
};
template <>
struct DtOf<__half> {
  static constexpr int v = DT_F16;
};

// Arrive at barrier `id` without waiting (the other side bar.syncs).
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Keep a wgmma's register A operand in place until its wait.
template <int R>
__device__ __forceinline__ void reg_fence_u(uint32_t (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// The launch's tiles: B * H * ceil(Sq / BQ), head by head (b slower than
// h: neighbouring query heads share a KV head), each head's q tiles the
// longest first when causal, so that the tiles running at once share
// their K and V in L2.  The persistent blocks walk the list in rounds of
// gridDim.x, every other round backwards (a snake), which evens out the
// steps each block takes.  tile_at: the block's k-th tile, -1 past its
// last.
__device__ __forceinline__ int tile_at(int k, int tiles) {
  const int base = k * (int)gridDim.x;
  const int r = min((int)gridDim.x, tiles - base);  // tiles in round k
  if ((int)blockIdx.x >= r) return -1;
  return base + ((k & 1) ? r - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

// Tile t's (b, h, q tile) and step range [lo, hi): attn_k_bounds(qi,
// ceil(Sk / BKV), bq=BQ, bk=BKV, ...), which is attn_k_bounds at bk = 64
// widened to multiples of BKV, or every step with the full grid (bound =
// 0).
struct TileJob {
  int b, h, qi, lo, hi;
};

template <int BQ, int BKV>
__device__ __forceinline__ TileJob tile_job(const AttnArgs& a, int t, int nq) {
  TileJob j;
  const int u = t / nq, pos = t % nq;
  j.qi = a.causal ? nq - 1 - pos : pos;
  j.h = u % a.H;
  j.b = u / a.H;
  const int nk = (a.Sk + BKV - 1) / BKV;
  j.hi = nk;
  if (a.bound && a.causal) {
    const long long e = (long long)a.q_offset + (long long)(j.qi + 1) * BQ;
    j.hi = max((int)min((long long)nk, (e + BKV - 1) / BKV), 1);
  }
  j.lo = 0;
  if (a.bound && a.window > 0) {
    const long long e =
        (long long)a.q_offset + (long long)j.qi * BQ - (a.window - 1);
    j.lo = min(e > 0 ? (int)(e / BKV) : 0, j.hi - 1);
  }
  return j;
}

// Named barriers: 1 + c is consumer c's turn to issue its GEMMs (the
// ping-pong), 3 + c consumer c's own store.
constexpr int TURN_BAR = 1, STORE_BAR = 3;

template <typename T, int D, int NC>
__global__ void __launch_bounds__(TileCfg<D, NC>::THREADS,
                                  TileCfg<D, NC>::MIN_BLOCKS)
    flash_tile_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, AttnArgs a) {
  using C = TileCfg<D, NC>;
  constexpr int BQ = C::BQ, BKV = C::BKV, SWB = C::SWB, CH = C::CH,
                NCH = C::NCH, S = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;                  // two Q buffers
  unsigned char* ks = qs + 2 * C::Q_BYTES;   // S K stages
  unsigned char* vs = ks + S * C::KV_BYTES;  // S V stages
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + S * C::KV_BYTES);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;

  const int nq = (a.Sq + BQ - 1) / BQ;
  const int tiles = nq * a.H * a.B;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], NC * 128);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], NC * 128);
      mbar_init(&v_empty[s], NC * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread walks the block's tiles, Q into the tile's
    // buffer once its store two tiles back is done, then the K and V
    // steps through the ring (ring position and phases run on across
    // tiles, so the next tile's loads start while this one finishes) ----
    setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int g = 0;  // steps issued so far
    for (int j = 0, tt; (tt = tile_at(j, tiles)) >= 0; ++j) {
      const TileJob tj = tile_job<BQ, BKV>(a, tt, nq);
      const int qb = j & 1;
      if (j >= 2) mbar_wait(&q_empty[qb], ((j >> 1) + 1) & 1);
      unsigned char* qd = qs + qb * C::Q_BYTES;
      mbar_expect_tx(&q_full[qb], C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        tma_load_4d(qd + c * BQ * SWB, &tq, &q_full[qb], c * CH, tj.h,
                    tj.qi * BQ, tj.b);
      const int kvh = tj.h / a.group;
      for (int i = tj.lo; i < tj.hi; ++i, ++g) {
        const int s = g % S;
        const uint32_t before = ((g / S) + 1) & 1;  // the stage's last use
        unsigned char* kd = ks + s * C::KV_BYTES;
        unsigned char* vd = vs + s * C::KV_BYTES;
        if (g >= S) mbar_wait(&k_empty[s], before);
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load_4d(kd + c * BKV * SWB, &tk, &k_full[s], c * CH, kvh,
                      i * BKV, tj.b);
        if (g >= S) mbar_wait(&v_empty[s], before);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load_4d(vd + c * BKV * SWB, &tv, &v_full[s], c * CH, kvh,
                      i * BKV, tj.b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows of each tile apiece ----
  setmaxnreg_inc<C::MIN_BLOCKS == 2 ? 216 : 232>();
  const int c = wg - 1;
  const int wl = threadIdx.x % 128, lane = wl % 32;
  const int gq = lane / 4, t = lane % 4;
  const int rl = (wl / 32) * 16 + gq;  // this thread's rows rl, rl + 8
  // no epilogue and the input's type out: O leaves as T in 16-byte rows
  const bool direct = a.act == 0 && a.bias == nullptr && a.res == nullptr &&
                      a.out_dt == DtOf<T>::v;

  float o[D / 2];
  float sc[BKV / 2];          // S, then P, of the step in hand
  uint32_t pa[BKV / 16][4];   // P rounded to T: O += P V's A operand
  float mrow[2], lrow[2];

  // Ping-pong: consumer c issues its GEMMs when it holds turn 1 + c and
  // then hands the turn over, so that one consumer's softmax runs while
  // the other's GEMMs do.  Consumer 0 goes first; consumer 1 hands back
  // no turn after its very last.
  if (NC == 2 && c == 1) named_bar_arrive(TURN_BAR, 256);
  int g = 0;  // steps consumed so far
  for (int j = 0, tt; (tt = tile_at(j, tiles)) >= 0; ++j) {
    const TileJob tj = tile_job<BQ, BKV>(a, tt, nq);
    const bool last_tile = tile_at(j + 1, tiles) < 0;
    const int qb = j & 1, n = tj.hi - tj.lo;
    unsigned char* qd = qs + qb * C::Q_BYTES;
    const int q0 = tj.qi * BQ + c * 64;  // this consumer's first row
    const int qlo = a.q_offset + q0, qhi = qlo + 63;

#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    mrow[0] = mrow[1] = REPRO_NEG_INF;
    lrow[0] = lrow[1] = 0.f;

    // Scale (log2 domain) and mask S of the step at key k0, the new
    // running max and P in sc; the row sums of P and the correction.
    auto softmax = [&](int k0, float (&psum)[2], float (&corr)[2]) {
      const bool need_mask = k0 + BKV > a.Sk || a.valid != nullptr ||
                             (a.causal && k0 + BKV - 1 > qlo) ||
                             (a.window > 0 && qhi - k0 >= a.window);
      float mx[2] = {-INFINITY, -INFINITY};
      if (need_mask) {
        // element (jj, e) is row rl + 8 (e >> 1) and key k0 + 2t + col,
        // col = 8 jj + (e & 1); bit 2 jj + e of `on`: the slot of col
        // 8 jj + e is filled (valid's bytes read once a step, not once a
        // row)
        const int dq = qlo + rl - k0 - 2 * t, left = a.Sk - k0 - 2 * t;
        uint32_t on = ~0u;
        if (a.valid != nullptr) {
          const unsigned char* vr = a.valid + (long long)tj.b * a.Sk + k0 + 2 * t;
          on = 0u;
#pragma unroll
          for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * jj + e < left && vr[8 * jj + e] != 0)
                on |= 1u << (2 * jj + e);
        }
        // a row's live columns: [lo, hi), its window, its causal bound and
        // the end of the sequence
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int d = dq + 8 * r;  // q - k at col 0
          hi[r] = a.causal ? min(left, d + 1) : left;
          lo[r] = a.window > 0 ? d - a.window + 1 : -(1 << 30);
        }
#pragma unroll
        for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * jj + (e & 1), r = e >> 1;
            const bool live = col >= lo[r] && col < hi[r] &&
                              ((on >> (2 * jj + (e & 1))) & 1u);
            if (!live) sc[4 * jj + e] = -INFINITY;
            mx[r] = fmaxf(mx[r], sc[4 * jj + e]);
          }
      } else {
#pragma unroll
        for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * jj + e]);
      }
      float neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_blk = quad_max(mx[r]);
        const float m_new = m_blk == -INFINITY
                                ? mrow[r]
                                : fmaxf(mrow[r], m_blk * a.scale_log2);
        corr[r] = fast_exp2(mrow[r] - m_new);
        mrow[r] = m_new;
        // masked-block guard: no live slot yet, the row contributes zeros
        neg_m[r] = m_new == REPRO_NEG_INF ? -INFINITY : -m_new;
        psum[r] = 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < BKV / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              fast_exp2(fmaf(sc[4 * jj + e], a.scale_log2, neg_m[e >> 1]));
          sc[4 * jj + e] = p;
          psum[e >> 1] += p;
        }
    };
    // Fold a step into the state: rescale O and l, round P to T.
    auto fold = [&](const float (&psum)[2], const float (&corr)[2]) {
      lrow[0] = lrow[0] * corr[0] + psum[0];
      lrow[1] = lrow[1] * corr[1] + psum[1];
      if (corr[0] != 1.f || corr[1] != 1.f) {  // a row max moved
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          o[4 * jj] *= corr[0];
          o[4 * jj + 1] *= corr[0];
          o[4 * jj + 2] *= corr[1];
          o[4 * jj + 3] *= corr[1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pa[kk][q] = pack2<T>(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
    };
    // S_i = Q K_i^T into sc, O += P_i V_i: issue, commit.
    auto issue_s = [&](int i) {
      const unsigned char* kd = ks + ((g + i) % S) * C::KV_BYTES;
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        const int ch = (16 * jj) / CH, off = ((16 * jj) % CH) * 2;
        const uint64_t dq = wgmma_desc(qd + ch * BQ * SWB + c * 64 * SWB + off,
                                       16, 8 * SWB, SWB);
        const uint64_t dk =
            wgmma_desc(kd + ch * BKV * SWB + off, 16, 8 * SWB, SWB);
        Wgmma<BKV, T>::template ss<0>(sc, dq, dk);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int i) {
      const unsigned char* vd = vs + ((g + i) % S) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t dv =
            wgmma_desc(vd + kk * 16 * SWB, BKV * SWB, 8 * SWB, SWB);
        Wgmma<D, T>::rs(o, pa[kk], dv);
      }
      wgmma_commit();
    };
    auto wait_k = [&](int i) {
      mbar_wait(&k_full[(g + i) % S], ((g + i) / S) & 1);
#pragma unroll
      for (int jj = 0; jj < BKV / 2; ++jj) sc[jj] = 0.f;
    };
    auto wait_v = [&](int i) {
      mbar_wait(&v_full[(g + i) % S], ((g + i) / S) & 1);
    };
    // the ping-pong: take this consumer's turn; hand it to the other
    // (consumer 1 not after its very last turn)
    auto turn = [&]() {
      if (NC == 2) named_bar_sync(TURN_BAR + c, 256);
    };
    auto hand_over = [&](bool very_last) {
      if (NC == 2 && !(c == 1 && very_last))
        named_bar_arrive(TURN_BAR + 1 - c, 256);
    };
    // Turn 0 issues S_0, turn i of 1 .. n-1 S_i with P_{i-1} V_{i-1}
    // (S_i's softmax then runs while P_{i-1} V_{i-1} and the other
    // consumer's GEMMs keep the tensor cores busy), turn n the last P V;
    // a tile with no step takes one empty turn.  Straight-line code
    // between each issue and its waits keeps the wgmma pipeline
    // asynchronous.
    mbar_wait(&q_full[qb], (j >> 1) & 1);
    float psum[2], corr[2];
    if (n == 0) {
      turn();
      hand_over(last_tile);
    } else {
      wait_k(0);
      turn();
      reg_fence(sc);
      wgmma_fence();
      issue_s(0);
      hand_over(false);
      wgmma_wait<0>();
      reg_fence(sc);
      mbar_arrive(&k_empty[g % S]);
      softmax(tj.lo * BKV, psum, corr);
      fold(psum, corr);
      for (int i = 1; i < n; ++i) {
        wait_k(i);
        wait_v(i - 1);
        turn();
        reg_fence(sc);
        reg_fence(o);
        wgmma_fence();
        issue_s(i);
        issue_pv(i - 1);
        hand_over(false);
        wgmma_wait<1>();  // S_i is done; P_{i-1} V_{i-1} may still run
        reg_fence(sc);
        mbar_arrive(&k_empty[(g + i) % S]);
        softmax((tj.lo + i) * BKV, psum, corr);
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence_u(pa);
        mbar_arrive(&v_empty[(g + i - 1) % S]);
        fold(psum, corr);
      }
      wait_v(n - 1);
      turn();
      reg_fence(o);
      wgmma_fence();
      issue_pv(n - 1);
      hand_over(last_tile);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence_u(pa);
      mbar_arrive(&v_empty[(g + n - 1) % S]);
    }
    g += n;
    lrow[0] = quad_sum(lrow[0]);
    lrow[1] = quad_sum(lrow[1]);

    // The store, through this consumer's rows of the Q buffer (its GEMMs
    // are done with them; box x of a row holds its columns [x CH, x CH +
    // CH)), the next tile's loads running meanwhile.  A row with l = 0
    // stores 0 (the guard).
    unsigned char* wq = qd + c * 64 * SWB;
    named_bar_sync(STORE_BAR + c, 128);
    if (direct) {
      // normalised, rounded to T, in 16-byte chunks XOR-swizzled by row
      constexpr int CPB = SWB / 16;  // chunks a box row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rl + 8 * r;
        const float den = lrow[r] == 0.f ? 1.f : lrow[r];
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          const int box = jj / CPB, cb = jj % CPB;
          *reinterpret_cast<uint32_t*>(
              wq + box * BQ * SWB + row * SWB +
              ((cb ^ (row & (CPB - 1))) * 16) + 4 * t) =
              pack2<T>(o[4 * jj + 2 * r] / den, o[4 * jj + 2 * r + 1] / den);
        }
      }
      named_bar_sync(STORE_BAR + c, 128);
      T* out = reinterpret_cast<T*>(a.out);
      for (int i = wl; i < 64 * (D / 8); i += 128) {
        const int row = i / (D / 8), ch = i % (D / 8);
        const int s = q0 + row;
        if (s >= a.Sq) continue;
        const int box = ch / CPB, cb = ch % CPB;
        const uint4 v = *reinterpret_cast<const uint4*>(
            wq + box * BQ * SWB + row * SWB + ((cb ^ (row & (CPB - 1))) * 16));
        *reinterpret_cast<uint4*>(
            out + (((long long)tj.b * a.Sq + s) * a.H + tj.h) * D + 8 * ch) = v;
      }
    } else {
      // the epilogue or another output type: normalised fp32 O in two
      // passes of D / 2 columns, each one loop of attn_store2 pairs
      constexpr int HALF = D / 2;
      auto at = [&](int f) {  // float f of a pass's (64, HALF) tile
        const int byte = 4 * f;
        return reinterpret_cast<float*>(wq + (byte / (64 * SWB)) * BQ * SWB +
                                        byte % (64 * SWB));
      };
#pragma unroll 1
      for (int hp = 0; hp < 2; ++hp) {
        if (hp) named_bar_sync(STORE_BAR + c, 128);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = rl + 8 * r;
          const float den = lrow[r] == 0.f ? 1.f : lrow[r];
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj)
            if ((8 * jj) / HALF == hp)
              *reinterpret_cast<float2*>(
                  at(row * HALF + 8 * jj + 2 * t - hp * HALF)) =
                  make_float2(o[4 * jj + 2 * r] / den,
                              o[4 * jj + 2 * r + 1] / den);
        }
        named_bar_sync(STORE_BAR + c, 128);
        for (int i = wl; i < 64 * (HALF / 2); i += 128) {
          const int row = i / (HALF / 2), d = 2 * (i % (HALF / 2));
          const int s = q0 + row;
          if (s >= a.Sq) continue;
          const float2 v = *reinterpret_cast<const float2*>(at(row * HALF + d));
          attn_store2(a, tj.b, s, tj.h, hp * HALF + d, v.x, v.y, 1.f);
        }
      }
    }
    // the buffer goes back to the producer (its TMA writes follow these
    // generic-proxy accesses)
    fence_proxy_async();
    mbar_arrive(&q_empty[qb]);
  }
}

// ---- the fp32 tile (K2e, n_split == 1) ------------------------------------

// The fp32 tile's shapes at depth D with RW query rows a warp (8 warps: q
// tiles of 8 * RW rows); tests/test_torch_attention.py mirrors them
// (f32_tile_config).  Steps of BKV keys: 64 at D <= 128, 32 at D = 160
// (whose 64-key steps would not fit shared memory beside its Q tile).
// S's lane grid is RG x KG: KG lanes across the step's keys (4 keys a
// lane) by RG across the warp's rows (SR rows a lane): 8 x 4 on the
// 128-row tile at D <= 128, 4 x 4 on its 64-row tile.  Shared memory: the
// Q tile (rows unpadded, 16-byte chunks swizzled), each warp's key-major
// P (BKV keys by RW rows) and its rows' corrections, and a ring of 2-3 K
// and V steps (K rows padded by 16 bytes, V rows unpadded), as deep as two
// blocks an SM allow, else one block an SM.
constexpr int F32T_THREADS = 256;

constexpr int f32_step(int D) { return D <= 128 ? 64 : 32; }

template <int D, int RW>
struct F32TileCfg {
  static constexpr int BKV = f32_step(D);
  static constexpr int BQ = 8 * RW;
  static constexpr int LDK = D + 4;  // K row pitch (floats)
  static constexpr int KG = BKV / 4, RG = 32 / KG;  // S's lane grid
  static constexpr int SR = RW / RG, OR = RW / 2;   // S and O rows a lane
  static constexpr int C4 = D / 64, C2 = (D % 64) / 32;  // float4s, float2
  static constexpr int DC = 4 * C4 + 2 * C2;             // O columns a lane
  // The two product loops are unrolled in bodies of ~512 FMAs a lane
  // (SU chunks of 4 of D; OU keys): fully unrolled, the 128-row tile at
  // D = 128 ran at less than half the speed (PERF.md).
  static constexpr int SU = (D / 4) % (32 / SR) == 0 ? 32 / SR : 8;
  static constexpr int OU = OR * DC >= 64 ? 8 : 16;
  static constexpr long long STAGE = 4LL * BKV * (LDK + D);
  static constexpr long long BASE =
      4LL * ((long long)BQ * D + 8LL * BKV * RW + 8LL * RW);
  static constexpr long long FIT2 = (SMEM_TWO_A_SM - BASE) / STAGE;
  static constexpr int MIN_BLOCKS = FIT2 >= 2 ? 2 : 1;
  static constexpr long long FIT =
      MIN_BLOCKS == 2 ? FIT2 : (SMEM_ONE_A_SM - BASE) / STAGE;
  static constexpr int STAGES = FIT > 3 ? 3 : (int)FIT;
  static_assert(STAGES >= 2, "the ring holds two steps at a time");
  static_assert(D % 32 == 0 && (RW == 8 || RW == 16) && SR >= 2,
                "fp32 tile shapes");
  static constexpr size_t smem = (size_t)(BASE + STAGES * STAGE);
};

// Rows [r0, r0 + ROWS) of a (rows, D) fp32 slab whose rows lie `stride`
// floats apart, by 16-byte cp.async: chunk c of row r to at(r, c); rows at
// or past `limit` are zero-filled and read nothing.
template <int D, int ROWS, typename At>
__device__ __forceinline__ void f32_rows_async(At at, const float* src,
                                               long long stride, int r0,
                                               int limit) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += F32T_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool in = r0 + r < limit;
    const float* from = in ? src + (long long)(r0 + r) * stride + 4 * c : src;
    cp_async16(at(r, c), from, in);
  }
}

// Max and sum over the N lanes of a row (lanes N r .. N r + N - 1).
template <int N>
__device__ __forceinline__ float rows_max(float v) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
template <int N>
__device__ __forceinline__ float rows_sum(float v) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Component i (a constant once unrolled) of a float4.
__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// N floats to p (float4s, or one float2 where N == 2).
template <int N>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[N]) {
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int u = 0; u < N; u += 4)
      *reinterpret_cast<float4*>(p + u) =
          make_float4(v[u], v[u + 1], v[u + 2], v[u + 3]);
  }
}

// N floats at p, 16-byte aligned (N a multiple of 4).
template <int N>
__device__ __forceinline__ void ld_vec(float (&v)[N], const float* p) {
#pragma unroll
  for (int u = 0; u < N; u += 4) {
    const float4 w = *reinterpret_cast<const float4*>(p + u);
    v[u] = w.x; v[u + 1] = w.y; v[u + 2] = w.z; v[u + 3] = w.w;
  }
}

template <int D, int RW>
__global__ void __launch_bounds__(F32T_THREADS, F32TileCfg<D, RW>::MIN_BLOCKS)
    flash_f32_tile_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, AttnArgs a) {
  using C = F32TileCfg<D, RW>;
  constexpr int BQ = C::BQ, LDK = C::LDK, KG = C::KG, SR = C::SR,
                OR = C::OR, C4 = C::C4, C2 = C::C2, DC = C::DC,
                S = C::STAGES, BKV = C::BKV, SU = C::SU, OU = C::OU;
  static_assert((D / 4) % SU == 0 && BKV % OU == 0 && OU % 2 == 0,
                "whole unrolled bodies");
  extern __shared__ __align__(16) unsigned char f32t_smem[];
  float* qs = reinterpret_cast<float*>(f32t_smem);  // (BQ, D), swizzled
  float* ring = qs + BQ * D;                         // S x (K, V) steps
  float* pall = ring + S * BKV * (LDK + D);          // 8 x (BKV, RW) P
  float* call = pall + 8 * BKV * RW;                 // 8 x (RW,) corrections

  // The tile: in rounds of the (b, h) pairs, the longest first -- q tiles
  // descending when causal, ascending otherwise (the last q tile, short
  // where Sq is ragged, in the last wave).
  const int nq = (a.Sq + BQ - 1) / BQ, bhn = a.B * a.H;
  const int round = (int)blockIdx.x / bhn;
  const int qi = a.causal ? nq - 1 - round : round;
  const int bh = (int)blockIdx.x % bhn;
  const int b = bh / a.H, h = bh % a.H, kvh = h / a.group;
  const int q0 = qi * BQ;

  // Its live steps, attn_k_bounds(qi, nk, bq=BQ, bk=BKV, ...) (the full
  // grid, bound = 0: all nk).
  const int nk = (a.Sk + BKV - 1) / BKV;
  int hi = nk;
  if (a.bound && a.causal) {
    const long long e = (long long)a.q_offset + (long long)(qi + 1) * BQ;
    hi = max((int)min((long long)nk, (e + BKV - 1) / BKV), 1);
  }
  int lo = 0;
  if (a.bound && a.window > 0) {
    const long long e =
        (long long)a.q_offset + (long long)qi * BQ - (a.window - 1);
    lo = min(e > 0 ? (int)(e / BKV) : 0, hi - 1);
  }
  const int steps = hi - lo;

  const long long qstride = (long long)a.H * D;
  const long long kvstride = (long long)a.KVH * D;
  const float* qb = q + ((long long)b * a.Sq * a.H + h) * D;
  const float* kb = k + ((long long)b * a.Sk * a.KVH + kvh) * D;
  const float* vb = v + ((long long)b * a.Sk * a.KVH + kvh) * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sr = lane / KG, kc = lane % KG;   // S: rows sr*SR + i, keys kc + KG j
  const int orr = lane / 16, cc = lane % 16;  // O: rows orr * OR + i
  const int wr0 = warp * RW;                  // the warp's rows in the tile
  float* pw = pall + warp * BKV * RW;
  float* cw = call + warp * RW;

  auto load = [&](int i) {
    float* ks = ring + (i % S) * BKV * (LDK + D);
    float* vs = ks + BKV * LDK;
    const int k0 = (lo + i) * BKV;
    f32_rows_async<D, BKV>([&](int r, int c) { return ks + r * LDK + 4 * c; },
                           kb, kvstride, k0, a.Sk);
    f32_rows_async<D, BKV>([&](int r, int c) { return vs + r * D + 4 * c; },
                           vb, kvstride, k0, a.Sk);
  };
  // Q row r's chunk c at chunk c ^ ((r % RW) / SR): the RG rows one load
  // of S reads (one a lane row group) lie on distinct banks.
  f32_rows_async<D, BQ>(
      [&](int r, int c) { return qs + r * D + 4 * (c ^ ((r % RW) / SR)); },
      qb, qstride, q0, a.Sq);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }

  const bool warp_live = q0 + wr0 < a.Sq;
  const long long plo = (long long)a.q_offset + q0 + wr0;  // its positions
  const long long phi = plo + RW - 1;

  float o[OR][DC];
#pragma unroll
  for (int i = 0; i < OR; ++i)
#pragma unroll
    for (int e = 0; e < DC; ++e) o[i][e] = 0.f;
  float mrow[SR], lrow[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
  }

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();  // step it is whole; every warp is past step it - 1
    if (it + S - 1 < steps) load(it + S - 1);
    cp_async_commit();
    const int slot = it % S;
    const int k0 = (lo + it) * BKV;
    // a step dead for every row of the warp leaves its state untouched
    if (warp_live && !(a.causal && k0 > phi) &&
        !(a.window > 0 && (long long)k0 + BKV - 1 <= plo - a.window)) {
      const float* ks = ring + slot * BKV * (LDK + D);
      const float* vs = ks + BKV * LDK;

      // S = Q K^T: SR rows (sr * SR + i) by 4 keys (kc + KG j) a lane, on
      // float4s of Q (broadcast over the row group) and K along D
      float sc[SR][4];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      const float* qr = qs + (wr0 + sr * SR) * D;
      const float* kr = ks + kc * LDK;
#pragma unroll 1
      for (int d0 = 0; d0 < D; d0 += 4 * SU) {
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int d = d0 + 4 * u;
          const int qc = 4 * ((d / 4) ^ sr);  // the swizzled chunk
          float4 qv[SR], kv[4];
#pragma unroll
          for (int i = 0; i < SR; ++i)
            qv[i] = *reinterpret_cast<const float4*>(qr + i * D + qc);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            kv[j] = *reinterpret_cast<const float4*>(kr + KG * j * LDK + d);
#pragma unroll
          for (int i = 0; i < SR; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              sc[i][j] = dot4(qv[i], kv[j], sc[i][j]);
        }
      }

      // online softmax (log2 domain); P and the corrections to the warp's
      // buffers
      const bool need_mask = k0 + BKV > a.Sk || a.valid != nullptr ||
                             (a.causal && k0 + BKV - 1 > plo) ||
                             (a.window > 0 && phi - k0 >= a.window);
      float pt[4][SR], cr[SR];
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const long long qpos = plo + sr * SR + i;
        float tv[4], mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          tv[j] = sc[i][j] * a.scale_log2;
          if (need_mask) {
            const int kpos = k0 + kc + KG * j;
            bool live = kpos < a.Sk;
            if (a.causal) live = live && qpos >= kpos;
            if (a.window > 0) live = live && (qpos - kpos < a.window);
            if (a.valid != nullptr && live)
              live = a.valid[(long long)b * a.Sk + kpos] != 0;
            if (!live) tv[j] = -INFINITY;
          }
          mx = fmaxf(mx, tv[j]);
        }
        const float m_new = fmaxf(mrow[i], rows_max<KG>(mx));
        // masked-block guard: no live slot yet, the row contributes zeros
        const bool dead = m_new == -INFINITY;
        cr[i] = dead ? 1.f : exp2f(mrow[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pt[j][i] = dead ? 0.f : exp2f(tv[j] - m_new);
          psum += pt[j][i];
        }
        lrow[i] = lrow[i] * cr[i] + rows_sum<KG>(psum);
        mrow[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        st_vec(pw + (kc + KG * j) * RW + sr * SR, pt[j]);
      if (kc == 0) st_vec(cw + sr * SR, cr);
      __syncwarp();

      // O = O * corr + P V: OR rows by DC columns a lane, the next key's P
      // and V loaded while this one's FMAs run
      float co[OR];
      ld_vec(co, cw + orr * OR);
#pragma unroll
      for (int i = 0; i < OR; ++i)
#pragma unroll
        for (int e = 0; e < DC; ++e) o[i][e] *= co[i];
      float pq[2][OR];
      float4 vq[2][C4 + 1];
      auto pv_operands = [&](int buf, int kk) {
        ld_vec(pq[buf], pw + kk * RW + orr * OR);
        const float* vr = vs + kk * D;
#pragma unroll
        for (int c = 0; c < C4; ++c)
          vq[buf][c] = *reinterpret_cast<const float4*>(vr + 64 * c + 4 * cc);
        if constexpr (C2 == 1) {
          const float2 w =
              *reinterpret_cast<const float2*>(vr + 64 * C4 + 2 * cc);
          vq[buf][C4] = make_float4(w.x, w.y, 0.f, 0.f);
        }
      };
      pv_operands(0, 0);
#pragma unroll 1
      for (int k0b = 0; k0b < BKV; k0b += OU) {
#pragma unroll
        for (int u = 0; u < OU; ++u) {
          const int kk = k0b + u, cur = u & 1;
          if (kk + 1 < BKV) pv_operands(cur ^ 1, kk + 1);
#pragma unroll
          for (int i = 0; i < OR; ++i)
#pragma unroll
            for (int e = 0; e < DC; ++e)
              o[i][e] = fmaf(pq[cur][i], lane_of(vq[cur][e / 4], e % 4),
                             o[i][e]);
        }
      }
    }
  }

  // The store: O through shared memory (the Q tile, read by now; rows
  // unswizzled), l beside it, so the epilogue is one loop, not inlined
  // once per register.  (With no live step the Q tile's copy is still in
  // flight: wait for it first.)
  cp_async_wait<0>();
  __syncthreads();
  float* ot = qs;
#pragma unroll
  for (int i = 0; i < OR; ++i) {
    float* row = ot + (wr0 + orr * OR + i) * D;
#pragma unroll
    for (int c = 0; c < C4; ++c)
      *reinterpret_cast<float4*>(row + 64 * c + 4 * cc) =
          make_float4(o[i][4 * c], o[i][4 * c + 1], o[i][4 * c + 2],
                      o[i][4 * c + 3]);
    if constexpr (C2 == 1)
      *reinterpret_cast<float2*>(row + 64 * C4 + 2 * cc) =
          make_float2(o[i][4 * C4], o[i][4 * C4 + 1]);
  }
  if (kc == 0)
#pragma unroll
    for (int i = 0; i < SR; ++i) call[wr0 + sr * SR + i] = lrow[i];
  __syncthreads();
#pragma unroll 1
  for (int idx = threadIdx.x; idx < BQ * (D / 2); idx += F32T_THREADS) {
    const int r = idx / (D / 2), d = 2 * (idx % (D / 2));
    const int s = q0 + r;
    if (s >= a.Sq) continue;
    const float2 val = *reinterpret_cast<const float2*>(ot + r * D + d);
    attn_store2(a, b, s, h, d, val.x, val.y, call[r]);
  }
}

// The 4-D tensor maps (D, heads, S, B) of q, k and v, boxes of `bq` and
// `bkv` rows of `swb`-byte swizzled rows.
template <int D>
static int attn_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
                     const void* q, const void* k, const void* v,
                     const AttnArgs& a, int bq, int bkv, int swb) {
  const uint64_t Dd = D, H = a.H, KVH = a.KVH, Sq = a.Sq, Sk = a.Sk, B = a.B;
  const uint64_t q_dims[4] = {Dd, H, Sq, B};
  const uint64_t q_str[3] = {Dd * 2, H * Dd * 2, Sq * H * Dd * 2};
  const uint64_t kv_dims[4] = {Dd, KVH, Sk, B};
  const uint64_t kv_str[3] = {Dd * 2, KVH * Dd * 2, Sk * KVH * Dd * 2};
  const uint32_t ch = (uint32_t)swb / 2;
  const uint32_t q_box[4] = {ch, 1, (uint32_t)bq, 1};
  const uint32_t kv_box[4] = {ch, 1, (uint32_t)bkv, 1};
  int rc = tmap_16bit(tq, q, 4, q_dims, q_str, q_box, swb);
  if (rc) return rc;
  rc = tmap_16bit(tk, k, 4, kv_dims, kv_str, kv_box, swb);
  if (rc) return rc;
  return tmap_16bit(tv, v, 4, kv_dims, kv_str, kv_box, swb);
}

// The split-KV mode: one launch of the decode kernel, the splits of a
// (b, h) one cluster whose rank 0 merges them.  Sq <= 16 shares one row
// slice among the four warps (keys split four ways), else each warp owns a
// slice of 16 rows.
template <typename T, int D, int KS>
static int launch_decode_ks(const void* q, const void* k, const void* v,
                            const AttnArgs& a, cudaStream_t stream) {
  using C = DecodeCfg<T, D>;
  const dim3 grid(1, a.H, a.B * a.n_split);
  const T* qt = reinterpret_cast<const T*>(q);
  const T* kt = reinterpret_cast<const T*>(k);
  const T* vt = reinterpret_cast<const T*>(v);
  static bool smem_ok = false;
  auto kernel = flash_decode_kernel<T, D, KS>;
  cudaError_t e = allow_smem(kernel, C::smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = C::smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.n_split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, qt, kt, vt, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, int D>
static int launch_decode(const void* q, const void* k, const void* v,
                         const AttnArgs& a, cudaStream_t stream) {
  if (a.Sq > DEC_BQ || a.n_split > DEC_CLUSTER_MAX)
    return (int)cudaErrorInvalidValue;
  return a.Sq <= 16 ? launch_decode_ks<T, D, 4>(q, k, v, a, stream)
                    : launch_decode_ks<T, D, 1>(q, k, v, a, stream);
}

// The fp32 tile: one block a (b, h, q tile), longest first when causal.
template <int D, int RW>
static int launch_f32_tile(const void* q, const void* k, const void* v,
                           const AttnArgs& a, cudaStream_t stream) {
  using C = F32TileCfg<D, RW>;
  static bool smem_ok = false;
  auto kernel = flash_f32_tile_kernel<D, RW>;
  cudaError_t e = allow_smem(kernel, C::smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const long long tiles =
      (long long)((a.Sq + C::BQ - 1) / C::BQ) * a.B * a.H;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, F32T_THREADS, C::smem, stream>>>(
      reinterpret_cast<const float*>(q), reinterpret_cast<const float*>(k),
      reinterpret_cast<const float*>(v), a);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_f32(const void* q, const void* k, const void* v,
                      const AttnArgs& a, int bq, cudaStream_t s) {
  if (a.n_split > 1)  // the 64-row tile only (the wrapper asks for no other)
    return bq == 64 ? launch_decode<float, D>(q, k, v, a, s)
                    : (int)cudaErrorInvalidValue;
  if (bq == 128) return launch_f32_tile<D, 16>(q, k, v, a, s);
  if (bq == 64) return launch_f32_tile<D, 8>(q, k, v, a, s);
  return (int)cudaErrorInvalidValue;
}

static int launch_f32_by_depth(const void* q, const void* k, const void* v,
                               const AttnArgs& a, int bq, cudaStream_t s) {
  if (a.D == 160) return launch_f32<160>(q, k, v, a, bq, s);
  if (a.D == 128) return launch_f32<128>(q, k, v, a, bq, s);
  if (a.D == 64) return launch_f32<64>(q, k, v, a, bq, s);
  if (a.D == 32) return launch_f32<32>(q, k, v, a, bq, s);
  return (int)cudaErrorInvalidValue;
}

// The tile mode: min(tiles, the blocks the card holds at once) persistent
// blocks.
template <typename T, int D, int NC>
static int launch_tile(const void* q, const void* k, const void* v,
                       const AttnArgs& a, cudaStream_t stream) {
  using C = TileCfg<D, NC>;
  CUtensorMap tq, tk, tv;
  int rc = attn_maps<D>(&tq, &tk, &tv, q, k, v, a, C::BQ, C::BKV, C::SWB);
  if (rc) return rc;
  static bool smem_ok = false;
  static int resident = 0;
  auto kernel = flash_tile_kernel<T, D, NC>;
  cudaError_t e = allow_smem(kernel, C::smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  if (resident == 0) {
    int dev = 0, sms = 0, per = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                        C::THREADS, C::smem);
    if (e != cudaSuccess) return (int)e;
    if (per < 1) return (int)cudaErrorInvalidConfiguration;
    resident = sms * per;
  }
  const long long tiles = (long long)((a.Sq + C::BQ - 1) / C::BQ) * a.H * a.B;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < resident ? tiles : resident);
  kernel<<<grid, C::THREADS, C::smem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_by_tile(const void* q, const void* k, const void* v,
                          const AttnArgs& a, int bq, cudaStream_t s) {
  if (a.n_split > 1)  // the 64-row tile only (the wrapper asks for no other)
    return bq == 64 ? launch_decode<T, D>(q, k, v, a, s)
                    : (int)cudaErrorInvalidValue;
  if constexpr (D <= 128)
    if (bq == 128) return launch_tile<T, D, 2>(q, k, v, a, s);
  if (bq == 64) return launch_tile<T, D, 1>(q, k, v, a, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_by_depth(const void* q, const void* k, const void* v,
                           const AttnArgs& a, int bq, cudaStream_t s) {
  if (a.D == 192)  // the 64-row tile only (the wrapper asks for no other)
    return bq == 64 ? launch_by_tile<T, 192>(q, k, v, a, bq, s)
                    : (int)cudaErrorInvalidValue;
  if (a.D == 128) return launch_by_tile<T, 128>(q, k, v, a, bq, s);
  if (a.D == 64) return launch_by_tile<T, 64>(q, k, v, a, bq, s);
  if (a.D == 32) return launch_by_tile<T, 32>(q, k, v, a, bq, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mma_attention_launch(
    const void* q, const void* k, const void* v, const void* valid,
    const void* bias, const void* res, void* out, int in_dt, int bias_dt, int res_dt, int out_dt,
    int B, int Sq, int Sk, int H, int KVH, int D, int causal, int q_offset,
    int window, float scale,
    int act, int bq, int n_split, int per_split, int bound, void* stream) {
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorInvalidValue;
  if (n_split < 1 || (n_split > 1 && per_split < 1))
    return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.valid = reinterpret_cast<const unsigned char*>(valid);
  a.bias = bias; a.res = res; a.out = out;
  a.bias_dt = bias_dt; a.res_dt = res_dt; a.out_dt = out_dt;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.KVH = KVH; a.group = H / KVH;
  a.D = D;
  a.causal = causal; a.q_offset = q_offset; a.window = window;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.act = act;
  a.n_split = n_split; a.per_split = per_split;
  a.bound = bound;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (in_dt == DT_BF16) return launch_by_depth<__nv_bfloat16>(q, k, v, a, bq, s);
  if (in_dt == DT_F16) return launch_by_depth<__half>(q, k, v, a, bq, s);
  if (in_dt == DT_F32) return launch_f32_by_depth(q, k, v, a, bq, s);
  return (int)cudaErrorInvalidValue;
}
