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
// only (4 ring stages, 222,280 bytes of shared memory; 232 registers a
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
// Design.
//   * One block owns (b, h, a 128-row q tile) -- 64 rows where the grid
//     would not fill the card -- and walks its live KV blocks of 64 with
//     attn_k_bounds' arithmetic (the causal bound above, the window bound
//     below); causal grids start with the longest rows.
//   * Warpgroup 0 is the producer: one thread loads the Q tile once and
//     K and V blocks into a ring of up to 8 stages by TMA, from 4-D
//     tensor maps (D, H, S, B) -- the KV head coordinate is h / group, so GQA repeats
//     nothing, and TMA zero-fills the ragged S edge.  Boxes are 128-byte
//     swizzled rows of 64 elements (64-byte rows for D = 32).
//   * Each consumer warpgroup owns 64 query rows.  S = Q K^T runs on
//     wgmma (both operands K-major in D); the online softmax runs in
//     registers in the exp2 domain with the scale folded in, masking only
//     the blocks that cross the diagonal, the window edge, the Sk fringe
//     or a valid predicate; P is rounded to the input type (as the
//     reference rounds it) and fed from registers as the A operand of
//     O += P V (V is MN-major: tnspB).  O, m and l stay in registers for
//     the whole KV loop.  The loop is software-pipelined: S of block i is
//     issued with O += P V of block i - 1, and block i's softmax runs
//     while the tensor cores finish the latter.
//   * The masked-block guard stays: p = 0 where the running max is still
//     -inf, and a row with l = 0 stores 0 before the epilogue.
//   * The full grid (K2d: the reference's mma_flash_attention(bound_grid=
//     False), its attn_grid_plan(bound=False)): with AttnArgs.bound = 0
//     every q tile walks all nk KV blocks, lo = 0 and hi = nk, the
//     rectangular schedule the bounded one is measured against.  A block
//     with no live slot leaves the state untouched: its row max is -inf,
//     so m keeps its value, the correction is exp2(0) = 1, every p is 0,
//     l gains 0 and O gains P V = 0 exactly.  So the full grid's tile mode
//     is the bounded launch bit for bit.  In split-KV mode the splits
//     partition [0, nk) instead of the live range [lo, hi): bit for bit
//     too where lo = 0 (the blocks past hi are dead, a split of them only
//     contributes m = -inf, l = 0: weight 0), else the live blocks group
//     otherwise and P rounds against other split maxima (within the
//     wrapper's stated budget).
//   * Split-KV (n_split > 1, chosen by the wrapper for Sq <= 64 from H
//     and Sk alone, so that a row sums in one order at any batch): block
//     (.., split) walks its share of the KV blocks and writes an fp32
//     partial -- unnormalised O, its running max m (log2 domain) and sum
//     l -- to a workspace; a
//     second kernel merges the partials of each row in split order by
//     log-sum-exp, then applies the guard, the normalisation and the
//     epilogue once.
//
// The fp32 tile (K2e: f32 q, k, v, the tight-parity F32GER config).  The
// tensor cores would round fp32 to TF32, which F32GER forbids, so it runs
// true fp32 FMAs on the CUDA cores (67 TFLOP/s bound it past a few
// hundred tokens, bytes for one query over a long cache), as F32GER's
// GEMM does (mma_gemm.cu's gemm_f32_kernel).
//   * One block of 256 threads owns (b, h, a 64-row q tile) and walks the
//     same live KV blocks of 64 as the wgmma kernel with BQ = 64; the
//     split-KV mode is the same, its partials merged by
//     flash_combine_kernel.
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
  static_assert(Q_BYTES + STAGES * STAGE >= BQ * (D + 8) * 4, "O tile");
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
    if (a.n_split > 1) {
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
    } else {
      // normalised O through shared memory (Q and the ring, once every
      // consumer is done with them): one loop of paired stores
      named_bar_sync(1, NC * 128);
      constexpr int LDO = D + 8;
      float* ot = reinterpret_cast<float*>(smem) + c * 64 * LDO;
      const int rl = r0 - q0 - c * 64;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float den = lrow[r] == 0.f ? 1.f : lrow[r];
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(ot + (rl + 8 * r) * LDO + 8 * j + 2 * t) =
              make_float2(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
      }
      named_bar_sync(2 + c, 128);
      for (int i = wl; i < 64 * (D / 2); i += 128) {
        const int rr = i / (D / 2), d = 2 * (i % (D / 2));
        const int s = q0 + c * 64 + rr;
        if (s >= a.Sq) continue;
        const float2 v = *reinterpret_cast<const float2*>(ot + rr * LDO + d);
        attn_store2(a, b, s, h, d, v.x, v.y, 1.f);
      }
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

template <typename T, int D, int NC>
static int launch_flash(const void* q, const void* k, const void* v,
                        const AttnArgs& a, cudaStream_t stream) {
  using C = FlashCfg<D, NC>;
  const uint64_t Dd = D, H = a.H, KVH = a.KVH, Sq = a.Sq, Sk = a.Sk, B = a.B;
  const uint64_t q_dims[4] = {Dd, H, Sq, B};
  const uint64_t q_str[3] = {Dd * 2, H * Dd * 2, Sq * H * Dd * 2};
  const uint64_t kv_dims[4] = {Dd, KVH, Sk, B};
  const uint64_t kv_str[3] = {Dd * 2, KVH * Dd * 2, Sk * KVH * Dd * 2};
  const uint32_t q_box[4] = {(uint32_t)C::CH, 1, (uint32_t)C::BQ, 1};
  const uint32_t kv_box[4] = {(uint32_t)C::CH, 1, (uint32_t)FA_BKV, 1};
  CUtensorMap tq, tk, tv;
  int rc = tmap_16bit(&tq, q, 4, q_dims, q_str, q_box, C::SWB);
  if (rc) return rc;
  rc = tmap_16bit(&tk, k, 4, kv_dims, kv_str, kv_box, C::SWB);
  if (rc) return rc;
  rc = tmap_16bit(&tv, v, 4, kv_dims, kv_str, kv_box, C::SWB);
  if (rc) return rc;
  static bool smem_ok = false;
  auto kernel = flash_wgmma_kernel<T, D, NC>;
  cudaError_t e = allow_smem(kernel, C::smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + C::BQ - 1) / C::BQ, a.H, a.B * a.n_split);
  kernel<<<grid, C::THREADS, C::smem, stream>>>(tq, tk, tv, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return (int)e;
  flash_combine_kernel<<<dim3(a.Sq, a.H, a.B), D / 2, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int launch_by_tile(const void* q, const void* k, const void* v,
                          const AttnArgs& a, int bq, cudaStream_t s) {
  if (bq == 128) return launch_flash<T, D, 2>(q, k, v, a, s);
  if (bq == 64) return launch_flash<T, D, 1>(q, k, v, a, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int launch_by_depth(const void* q, const void* k, const void* v,
                           const AttnArgs& a, int bq, cudaStream_t s) {
  if (a.D == 192)  // the 64-row tile only (the wrapper asks for no other)
    return bq == 64 ? launch_flash<T, 192, 1>(q, k, v, a, s)
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
