// Flash attention for Hopper (sm_90a): TMA + wgmma, and split-KV for short
// queries.
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
// 192 = 3 x 64 keeps the 128-byte swizzled boxes; it runs the 64-row tile
// only (the tile mode: steps of 64 keys, 3 ring stages, 197,760 bytes of
// shared memory; split-KV: 4 stages, 222,280 bytes; 232 registers a
// consumer thread, no spill), as the 128-row tile's 96 fp32 accumulators
// a thread spilled; fp32's 160 holds its tile in 227,328 bytes.  Query
// head h reads KV head h / (H / KVH) (GQA) without materialising the
// repeat.  The mask is the conjunction of
// the causal, sliding-window, q_offset and valid-slot predicates.
//
// What bounds it on an H100.  Prefill past a few hundred tokens does
// 4 * D flops per live (q, k) pair over inputs read once: the bf16 tensor
// cores (989 TFLOP/s) bound it, and only wgmma reaches them.  One query
// over a long cache (whisper's decode cross-attention, Sq = 1 over 1500
// positions) reads K and V once for 4 * D flops per position: bytes bound
// it, and the card is filled only if the positions are split over blocks.
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
// The split-KV mode (flash_wgmma_kernel, n_split > 1, chosen by the
// wrapper for Sq <= 64 from H and Sk alone, so that a row sums in one
// order at any batch): one block owns (b, h, a 64-row q tile, a split),
// walks its share of the live KV blocks of 64 with a ring of up to 8
// stages, the consumer as above without the ping-pong, and writes an fp32
// partial -- unnormalised O, its running max m (log2 domain) and sum l --
// to a workspace; a second kernel (flash_combine_kernel) merges the
// partials of each row in split order by log-sum-exp, then applies the
// guard, the normalisation and the epilogue once.
//
// Both modes:
//   * The masked-block guard: p = 0 where the running max is still -inf,
//     and a row with l = 0 stores 0 before the epilogue.
//   * The full grid (K2d: the reference's mma_flash_attention(bound_grid=
//     False), its attn_grid_plan(bound=False)): with AttnArgs.bound = 0
//     every q tile walks all KV steps, lo = 0 and hi = nk, the rectangular
//     schedule the bounded one is measured against.  A step with no live
//     slot leaves the state untouched: its row max is -inf, so m keeps its
//     value, the correction is exp2(0) = 1, every p is 0, l gains 0 and O
//     gains P V = 0 exactly.  So the full grid's tile mode is the bounded
//     launch bit for bit, and so are a row's results on either q tile.
//     In split-KV mode the splits partition [0, nk) instead of the live
//     range [lo, hi): bit for bit too where lo = 0 (the blocks past hi are
//     dead, a split of them only contributes m = -inf, l = 0: weight 0),
//     else the live blocks group otherwise and P rounds against other
//     split maxima (within the wrapper's stated budget).
//
// The fp32 tile (K2e: f32 q, k, v, the tight-parity F32GER config).  The
// tensor cores would round fp32 to TF32, which F32GER forbids, so it runs
// true fp32 FMAs on the CUDA cores (67 TFLOP/s bound it past a few
// hundred tokens, bytes for one query over a long cache), as F32GER's
// GEMM does (mma_gemm.cu's gemm_f32_kernel).
//   * One block of 256 threads owns (b, h, a 64-row q tile) and walks the
//     same live KV blocks of 64 as the split-KV kernel; the split-KV mode
//     is the same, its partials merged by flash_combine_kernel.
//   * The Q tile and a double buffer of K and V blocks sit in shared
//     memory (row pitch D + 4 floats), filled by 16-byte cp.async (zero
//     past Sq and Sk; GQA by the KV head index); block i + 1 loads while
//     block i computes.
//   * Thread (ty, tx) of a 16 x 16 grid holds a 4 x 4 micro-tile of S
//     (rows ty + 16i, columns tx + 16j), its K reads float4s along D.
//     The online softmax runs in the log2 domain with exp2f (no
//     approximate ex2), its row max and sum reduced over the 16 threads
//     of a row by shuffles; P stays fp32 (the reference rounds P to v's
//     dtype: here f32) and goes through shared memory to O += P V, where
//     the thread holds the same 4 rows by D/16 contiguous columns.
//   * The masked-block guard: p = 0 while a row's max is still -inf, and
//     a row with l = 0 stores 0 before the epilogue.
//   * The store goes through shared memory (O, m and l over the Q tile and
//     P's rows): one loop of paired stores and one copy of the epilogue.

#include "hopper.cuh"

constexpr int FA_BKV = 64;  // KV rows a step of the loop

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
  float* ws_o;                 // (B, H, Sq, n_split, D) partial O
  float* ws_ml;                // (B, H, Sq, n_split, 2) partial m, l
  int bias_dt, res_dt, out_dt;
  int B, Sq, Sk, H, KVH, group, D;
  int causal, q_offset, window;  // window <= 0: no window
  float scale_log2;              // D^-1/2 * log2(e)
  int act;
  int n_split, per_split;        // KV blocks per split
  int bound;                     // 0: the full grid, every KV block (K2d)
};

template <int D, int NC>
struct FlashCfg {
  static constexpr int BQ = 64 * NC;
  static constexpr int SWB = D * 2 >= 128 ? 128 : D * 2;  // bytes a box row
  static constexpr int CH = SWB / 2;                       // elements a box row
  static constexpr int NCH = D / CH;                       // boxes across D
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = FA_BKV * D * 2;
  static constexpr int STAGE = 2 * KV_BYTES;  // K then V
  static constexpr int THREADS = 128 * (NC + 1);
  // Blocks an SM holds: two of the 64-row tile where registers allow (the
  // split-KV grids are short), else one.  The ring takes what shared
  // memory is left: the producer runs up to 8 KV blocks ahead, which
  // hides TMA's latency behind a few blocks of work.
  static constexpr int MIN_BLOCKS = (NC == 1 && D <= 64) ? 2 : 1;
  static constexpr int BUDGET = (MIN_BLOCKS == 2 ? 110 : 225) * 1024;
  static constexpr int FREE = (BUDGET - Q_BYTES) / STAGE;
  static constexpr int STAGES = FREE > 8 ? 8 : FREE;
  static_assert(STAGES >= 2, "the loop holds two KV blocks at a time");
  static constexpr size_t smem =
      (size_t)Q_BYTES + STAGES * STAGE + 1024 + 8 * (1 + 2 * STAGES);
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

template <typename T, int D, int NC>
__global__ void __launch_bounds__(FlashCfg<D, NC>::THREADS,
                                  FlashCfg<D, NC>::MIN_BLOCKS)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, AttnArgs a) {
  using C = FlashCfg<D, NC>;
  constexpr int BQ = C::BQ, SWB = C::SWB, CH = C::CH, NCH = C::NCH;
  constexpr int FA_STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* kv = smem + C::Q_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(kv + FA_STAGES * C::STAGE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + FA_STAGES;

  const int nq = gridDim.x;
  const int qi = a.causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / a.n_split, split = blockIdx.z % a.n_split;
  const int kvh = h / a.group;
  const int q0 = qi * BQ;

  // The live KV-block range of this q tile: attn_k_bounds(qi, nk, bq=BQ,
  // bk=64, causal, q_offset, window) in kernels/mma_attention.py, or with
  // the full grid (bound = 0) all nk blocks; a split takes its share of it
  // (possibly none).
  const int nk = (a.Sk + FA_BKV - 1) / FA_BKV;
  int hi = nk;
  if (a.bound && a.causal) {
    const long long t = (long long)a.q_offset + (long long)(qi + 1) * BQ;
    hi = (int)min((long long)nk, (t + FA_BKV - 1) / FA_BKV);
    hi = max(hi, 1);
  }
  int lo = 0;
  if (a.bound && a.window > 0) {
    const long long t = (long long)a.q_offset + (long long)qi * BQ - (a.window - 1);
    lo = t > 0 ? (int)(t / FA_BKV) : 0;
    lo = min(lo, hi - 1);
  }
  if (a.n_split > 1) {
    lo += split * a.per_split;
    hi = min(hi, lo + a.per_split);
  }
  const int nkb = max(hi - lo, 0);

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread loads Q once, then K/V blocks ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        tma_load_4d(qs + c * BQ * SWB, &tq, qbar, c * CH, h, q0, b);
      for (int i = 0; i < nkb; ++i) {
        const int s = i % FA_STAGES;
        if (i >= FA_STAGES) mbar_wait(&empty[s], ((i / FA_STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], C::STAGE);
        unsigned char* ks = kv + s * C::STAGE;
        unsigned char* vs = ks + C::KV_BYTES;
        const int k0 = (lo + i) * FA_BKV;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(ks + c * FA_BKV * SWB, &tk, &full[s], c * CH, kvh, k0, b);
          tma_load_4d(vs + c * FA_BKV * SWB, &tv, &full[s], c * CH, kvh, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<NC == 2 ? 240 : 232>();
    const int c = wg - 1;
    const int wl = threadIdx.x % 128, lane = wl % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + c * 64 + (wl / 32) * 16 + g;  // and r0 + 8
    const int qlo = a.q_offset + q0 + c * 64;        // this warpgroup's rows
    const int qhi = qlo + 63;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float mrow[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, lrow[2] = {0.f, 0.f};
    float sc[FA_BKV / 2];          // S, then P, of the block in hand
    uint32_t pa[FA_BKV / 16][4];   // P rounded to T: O += P V's A operand

    // S_i = Q K_i^T into sc: wait for stage i, issue, commit (no wait).
    auto issue_s = [&](int i) {
      const int s = i % FA_STAGES;
      mbar_wait(&full[s], (i / FA_STAGES) & 1);
      const unsigned char* ks = kv + s * C::STAGE;
#pragma unroll
      for (int j = 0; j < FA_BKV / 2; ++j) sc[j] = 0.f;
      reg_fence(sc);
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const int ch = (16 * j) / CH, off = ((16 * j) % CH) * 2;
        const uint64_t dq = wgmma_desc(qs + ch * BQ * SWB + c * 64 * SWB + off,
                                       16, 8 * SWB, SWB);
        const uint64_t dk =
            wgmma_desc(ks + ch * FA_BKV * SWB + off, 16, 8 * SWB, SWB);
        Wgmma<FA_BKV, T>::template ss<0>(sc, dq, dk);
      }
      wgmma_commit();
    };
    // O += P_i V_i, P from the registers of pa: issue, commit (no wait).
    auto issue_pv = [&](int i) {
      const unsigned char* vs = kv + (i % FA_STAGES) * C::STAGE + C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < FA_BKV / 16; ++kk) {
        const uint64_t dv =
            wgmma_desc(vs + kk * 16 * SWB, FA_BKV * SWB, 8 * SWB, SWB);
        Wgmma<D, T>::rs(o, pa[kk], dv);
      }
      wgmma_commit();
    };
    // Scale (log2 domain) and mask S_i, the new running max and P in sc;
    // returns the row sums of P and the correction of the old max.
    auto softmax = [&](int i, float (&psum)[2], float (&corr)[2]) {
      const int k0 = (lo + i) * FA_BKV;
      const bool need_mask =
          k0 + FA_BKV > a.Sk || a.valid != nullptr ||
          (a.causal && k0 + FA_BKV - 1 > qlo) ||
          (a.window > 0 && qhi - k0 >= a.window);
      // max over the raw scores (masked ones -inf), then
      // p = 2^(s * scale * log2(e) - m) as one FFMA and one MUFU.EX2
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < FA_BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (need_mask) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const long long qpos = (long long)a.q_offset + r0 + (e >= 2 ? 8 : 0);
            bool live = kpos < a.Sk;
            if (a.causal) live = live && qpos >= kpos;
            if (a.window > 0) live = live && (qpos - kpos < a.window);
            if (a.valid != nullptr && live)
              live = a.valid[(long long)b * a.Sk + kpos] != 0;
            if (!live) sc[4 * j + e] = -INFINITY;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
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
      for (int j = 0; j < FA_BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              fast_exp2(fmaf(sc[4 * j + e], a.scale_log2, neg_m[e >> 1]));
          sc[4 * j + e] = p;
          psum[e >> 1] += p;
        }
    };
    // Fold block i's P into the state: rescale O and l, round P to T.
    auto fold = [&](const float (&psum)[2], const float (&corr)[2]) {
      lrow[0] = lrow[0] * corr[0] + psum[0];
      lrow[1] = lrow[1] * corr[1] + psum[1];
      if (corr[0] != 1.f || corr[1] != 1.f) {  // a row max moved
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < FA_BKV / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pa[kk][q] = pack2<T>(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
    };

    // Software pipeline: the softmax of block i runs on the CUDA cores
    // while the tensor cores run O += P_{i-1} V_{i-1}.
    mbar_wait(qbar, 0);
    if (nkb > 0) {
      float psum[2], corr[2];
      issue_s(0);
      wgmma_wait<0>();
      reg_fence(sc);
      softmax(0, psum, corr);
      fold(psum, corr);
      for (int i = 1; i < nkb; ++i) {
        issue_s(i);
        issue_pv(i - 1);
        wgmma_wait<1>();  // S_i is done; P_{i-1} V_{i-1} may still run
        reg_fence(sc);
        softmax(i, psum, corr);
        wgmma_wait<0>();
        reg_fence(o);
        mbar_arrive(&empty[(i - 1) % FA_STAGES]);
        fold(psum, corr);
      }
      reg_fence(o);
      wgmma_fence();
      issue_pv(nkb - 1);
      wgmma_wait<0>();
      reg_fence(o);
      mbar_arrive(&empty[(nkb - 1) % FA_STAGES]);
    }
    lrow[0] = quad_sum(lrow[0]);
    lrow[1] = quad_sum(lrow[1]);
    // fp32 partial of this split: unnormalised O, m, l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = r0 + 8 * r;
      if (s >= a.Sq) continue;
      const long long row =
          (((long long)b * a.H + h) * a.Sq + s) * a.n_split + split;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(a.ws_o + row * D + 8 * j + 2 * t) =
            make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(a.ws_ml + row * 2) =
            make_float2(mrow[r], lrow[r]);
    }
  }
}

// Split-KV merge: one block per (row, h, b), one thread per pair of d.
__global__ void flash_combine_kernel(AttnArgs a) {
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int d = 2 * threadIdx.x;
  const long long row = (((long long)b * a.H + h) * a.Sq + s) * a.n_split;
  const float* ml = a.ws_ml + row * 2;
  float m = REPRO_NEG_INF;
  for (int p = 0; p < a.n_split; ++p) m = fmaxf(m, ml[2 * p]);
  float l = 0.f, o0 = 0.f, o1 = 0.f;
  if (m != REPRO_NEG_INF) {
    for (int p = 0; p < a.n_split; ++p) {  // split order: deterministic
      const float w = fast_exp2(ml[2 * p] - m);
      const float2 op =
          *reinterpret_cast<const float2*>(a.ws_o + (row + p) * a.D + d);
      l += w * ml[2 * p + 1];
      o0 += w * op.x;
      o1 += w * op.y;
    }
  }
  attn_store2(a, b, s, h, d, o0, o1, l);
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

// ---- the fp32 tile (K2e) --------------------------------------------------

constexpr int F32A_BQ = 64, F32A_THREADS = 256;

template <int D>
struct F32AttnCfg {
  static constexpr int LD = D + 4;          // Q, K and V row pitch (floats)
  static constexpr int LDP = FA_BKV + 4;    // P row pitch
  static constexpr int DC = D / 16;         // O columns a thread
  static constexpr size_t smem =
      ((size_t)F32A_BQ * LD + 4 * (size_t)FA_BKV * LD +
       (size_t)F32A_BQ * LDP) * sizeof(float);
};

// Rows [r0, r0 + ROWS) of a (rows, D) fp32 slab whose rows lie `stride`
// floats apart, by 16-byte cp.async into shared memory of row pitch D + 4;
// rows at or past `limit` are zero-filled and read nothing.
template <int D, int ROWS>
__device__ __forceinline__ void f32_rows_async(float* dst, const float* src,
                                               long long stride, int r0,
                                               int limit) {
  constexpr int LD = D + 4, CH = D / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += F32A_THREADS) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool in = r0 + r < limit;
    const float* from = in ? src + (long long)(r0 + r) * stride + c : src;
    cp_async16(dst + r * LD + c, from, in);
  }
}

__device__ __forceinline__ float row16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
__global__ void __launch_bounds__(F32A_THREADS)
    flash_f32_kernel(const float* q, const float* k, const float* v,
                     AttnArgs a) {
  using C = F32AttnCfg<D>;
  constexpr int LD = C::LD, LDP = C::LDP, DC = C::DC;
  extern __shared__ __align__(16) unsigned char attn_f32_smem[];
  float* qs = reinterpret_cast<float*>(attn_f32_smem);
  float* kvs = qs + F32A_BQ * LD;          // two buffers of (K, V) blocks
  float* ps = kvs + 4 * FA_BKV * LD;

  const int nq = gridDim.x;
  const int qi = a.causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / a.n_split, split = blockIdx.z % a.n_split;
  const int kvh = h / a.group;
  const int q0 = qi * F32A_BQ;

  // attn_k_bounds(qi, nk, bq=64, bk=64, ...), as the wgmma kernel (the
  // full grid, bound = 0: all nk blocks)
  const int nk = (a.Sk + FA_BKV - 1) / FA_BKV;
  int hi = nk;
  if (a.bound && a.causal) {
    const long long t = (long long)a.q_offset + (long long)(qi + 1) * F32A_BQ;
    hi = (int)min((long long)nk, (t + FA_BKV - 1) / FA_BKV);
    hi = max(hi, 1);
  }
  int lo = 0;
  if (a.bound && a.window > 0) {
    const long long t =
        (long long)a.q_offset + (long long)qi * F32A_BQ - (a.window - 1);
    lo = t > 0 ? (int)(t / FA_BKV) : 0;
    lo = min(lo, hi - 1);
  }
  if (a.n_split > 1) {
    lo += split * a.per_split;
    hi = min(hi, lo + a.per_split);
  }
  const int nkb = max(hi - lo, 0);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long qstride = (long long)a.H * D;
  const long long kvstride = (long long)a.KVH * D;
  const float* qb = q + ((long long)b * a.Sq * a.H + h) * D;
  const float* kb = k + ((long long)b * a.Sk * a.KVH + kvh) * D;
  const float* vb = v + ((long long)b * a.Sk * a.KVH + kvh) * D;

  auto load_kv = [&](int i) {
    float* ks = kvs + (i & 1) * 2 * FA_BKV * LD;
    const int k0 = (lo + i) * FA_BKV;
    f32_rows_async<D, FA_BKV>(ks, kb, kvstride, k0, a.Sk);
    f32_rows_async<D, FA_BKV>(ks + FA_BKV * LD, vb, kvstride, k0, a.Sk);
  };
  f32_rows_async<D, F32A_BQ>(qs, qb, qstride, q0, a.Sq);
  if (nkb > 0) load_kv(0);
  cp_async_commit();

  float o[4][DC];
  float mrow[4], lrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DC; ++e) o[i][e] = 0.f;
  }
  const int qlo = a.q_offset + q0, qhi = qlo + F32A_BQ - 1;

  for (int it = 0; it < nkb; ++it) {
    if (it + 1 < nkb) {
      load_kv(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = kvs + (it & 1) * 2 * FA_BKV * LD;
    const float* vs = ks + FA_BKV * LD;

    // S = Q K^T, a 4 x 4 micro-tile a thread
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
    }

    // online softmax (log2 domain), P into shared memory, O rescaled
    const int k0 = (lo + it) * FA_BKV;
    const bool need_mask = k0 + FA_BKV > a.Sk || a.valid != nullptr ||
                           (a.causal && k0 + FA_BKV - 1 > qlo) ||
                           (a.window > 0 && qhi - k0 >= a.window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const long long qpos = (long long)a.q_offset + q0 + r;
      float t[4], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t[j] = sc[i][j] * a.scale_log2;
        if (need_mask) {
          const int kpos = k0 + tx + 16 * j;
          bool live = kpos < a.Sk;
          if (a.causal) live = live && qpos >= kpos;
          if (a.window > 0) live = live && (qpos - kpos < a.window);
          if (a.valid != nullptr && live)
            live = a.valid[(long long)b * a.Sk + kpos] != 0;
          if (!live) t[j] = -INFINITY;
        }
        mx = fmaxf(mx, t[j]);
      }
      const float m_new = fmaxf(mrow[i], row16_max(mx));
      // masked-block guard: no live slot yet, the row contributes zeros
      const bool dead = m_new == -INFINITY;
      const float corr = dead ? 1.f : exp2f(mrow[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = dead ? 0.f : exp2f(t[j] - m_new);
        ps[r * LDP + tx + 16 * j] = p;
        psum += p;
      }
      lrow[i] = lrow[i] * corr + row16_sum(psum);
      mrow[i] = m_new;
#pragma unroll
      for (int e = 0; e < DC; ++e) o[i][e] *= corr;
    }
    __syncthreads();

    // O += P V: the same 4 rows by DC contiguous columns a thread
#pragma unroll 4
    for (int c = 0; c < FA_BKV; ++c) {
      float pr[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * LDP + c];
      const float* vr = vs + c * LD + tx * DC;
      if constexpr (DC % 4 == 0) {
#pragma unroll
        for (int e = 0; e < DC; e += 4) {
          const float4 w = *reinterpret_cast<const float4*>(vr + e);
          vv[e] = w.x; vv[e + 1] = w.y; vv[e + 2] = w.z; vv[e + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < DC; e += 2) {
          const float2 w = *reinterpret_cast<const float2*>(vr + e);
          vv[e] = w.x; vv[e + 1] = w.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < DC; ++e) o[i][e] = fmaf(pr[i], vv[e], o[i][e]);
    }
    __syncthreads();  // the next iteration's loads overwrite this buffer
  }

  // The store: O through shared memory (the Q tile, read by now), so the
  // epilogue is one loop, not inlined once per register.  (With no live
  // block the Q tile's copy is still in flight: wait for it first.)
  cp_async_wait<0>();
  __syncthreads();
  float* ot = qs;                      // (64, D + 4) floats
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DC; ++e)
      ot[(ty + 16 * i) * LD + tx * DC + e] = o[i][e];
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ps[(ty + 16 * i) * LDP] = mrow[i];
      ps[(ty + 16 * i) * LDP + 1] = lrow[i];
    }
  __syncthreads();
#pragma unroll 1
  for (int idx = threadIdx.x; idx < F32A_BQ * (D / 2); idx += F32A_THREADS) {
    const int r = idx / (D / 2), d = 2 * (idx % (D / 2));
    const int s = q0 + r;
    if (s >= a.Sq) continue;
    const float2 v = *reinterpret_cast<const float2*>(ot + r * LD + d);
    const float m = ps[r * LDP], l = ps[r * LDP + 1];
    if (a.n_split > 1) {
      // fp32 partial of this split: unnormalised O, m (log2 domain), l
      const long long row =
          (((long long)b * a.H + h) * a.Sq + s) * a.n_split + split;
      *reinterpret_cast<float2*>(a.ws_o + row * D + d) = v;
      if (d == 0)
        *reinterpret_cast<float2*>(a.ws_ml + row * 2) = make_float2(m, l);
    } else {
      attn_store2(a, b, s, h, d, v.x, v.y, l);
    }
  }
}

template <int D>
static int launch_flash_f32(const void* q, const void* k, const void* v,
                            const AttnArgs& a, cudaStream_t stream) {
  using C = F32AttnCfg<D>;
  static bool smem_ok = false;
  auto kernel = flash_f32_kernel<D>;
  cudaError_t e = allow_smem(kernel, C::smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + F32A_BQ - 1) / F32A_BQ, a.H, a.B * a.n_split);
  kernel<<<grid, F32A_THREADS, C::smem, stream>>>(
      reinterpret_cast<const float*>(q), reinterpret_cast<const float*>(k),
      reinterpret_cast<const float*>(v), a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return (int)e;
  flash_combine_kernel<<<dim3(a.Sq, a.H, a.B), D / 2, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

static int launch_f32_by_depth(const void* q, const void* k, const void* v,
                               const AttnArgs& a, int bq, cudaStream_t s) {
  if (bq != F32A_BQ) return (int)cudaErrorInvalidValue;
  if (a.D == 160) return launch_flash_f32<160>(q, k, v, a, s);
  if (a.D == 128) return launch_flash_f32<128>(q, k, v, a, s);
  if (a.D == 64) return launch_flash_f32<64>(q, k, v, a, s);
  if (a.D == 32) return launch_flash_f32<32>(q, k, v, a, s);
  return (int)cudaErrorInvalidValue;
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

// The split-KV mode: the 64-row tile, then the merge.
template <typename T, int D>
static int launch_split(const void* q, const void* k, const void* v,
                        const AttnArgs& a, cudaStream_t stream) {
  using C = FlashCfg<D, 1>;
  CUtensorMap tq, tk, tv;
  int rc = attn_maps<D>(&tq, &tk, &tv, q, k, v, a, C::BQ, FA_BKV, C::SWB);
  if (rc) return rc;
  static bool smem_ok = false;
  auto kernel = flash_wgmma_kernel<T, D, 1>;
  cudaError_t e = allow_smem(kernel, C::smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + C::BQ - 1) / C::BQ, a.H, a.B * a.n_split);
  kernel<<<grid, C::THREADS, C::smem, stream>>>(tq, tk, tv, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_combine_kernel<<<dim3(a.Sq, a.H, a.B), D / 2, 0, stream>>>(a);
  return (int)cudaGetLastError();
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
    return bq == 64 ? launch_split<T, D>(q, k, v, a, s)
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
    const void* bias, const void* res, void* out, float* ws_o, float* ws_ml,
    int in_dt, int bias_dt, int res_dt, int out_dt, int B, int Sq, int Sk,
    int H, int KVH, int D, int causal, int q_offset, int window, float scale,
    int act, int bq, int n_split, int per_split, int bound, void* stream) {
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorInvalidValue;
  if (n_split < 1 || (n_split > 1 && (!ws_o || !ws_ml || per_split < 1)))
    return (int)cudaErrorInvalidValue;
  AttnArgs a;
  a.valid = reinterpret_cast<const unsigned char*>(valid);
  a.bias = bias; a.res = res; a.out = out; a.ws_o = ws_o; a.ws_ml = ws_ml;
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
