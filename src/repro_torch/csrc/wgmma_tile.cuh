// One (128, BN) output tile of a product on wgmma, fed through a ring of
// shared-memory stages: the stage layout, the tile order, and the consumer
// side (the K loop on two consumer warpgroups and the staged epilogue).
// Shared by the TMA GEMM (gemm_wgmma.cu) and K3's implicit GEMM
// (mma_conv.cu), which differ only in their producers: TMA boxes of X, or
// an A panel gathered from the image.
//
// A stage holds a (128 x 64) A panel, K-major, and BN / 64 (64 x 64) B
// boxes, MN-major (tnspB), all in the 128-byte swizzled layout TMA writes:
// the 16-byte chunk c of a 128-byte row r sits at chunk c ^ (r % 8), so
// every stage starts on a 1024-byte boundary.  full[s] completes when the
// stage has landed, empty[s] when both consumer warpgroups are done with
// it (2 x 128 arrivals).
#pragma once

#include "gemm_common.cuh"
#include "hopper.cuh"

constexpr int WG_BM = 128, WG_BK = 64, WG_THREADS = 384, WG_GROUP_M = 8;
constexpr int WG_SMEM_MAX = 232448;  // a block's shared memory (opt-in)
// The deepest ring, the GEMM's and K3's conv's.
constexpr int WG_MAX_STAGES = 8;

// The ring: as many stages as a block's shared memory holds beside 1 KB
// of alignment slack, 1 KB of K3's row offsets and two mbarriers a stage,
// at most WG_MAX_STAGES: 8 at BN = 64, 7 at 128, 5 at 192, 4 at 256, for
// the GEMM and K3's conv alike (core/tiling.py's wgmma_stages).  The ring
// also holds the fp32 tile the epilogue stages through it.  At
// deepseek-7b's M = 256 prefill, on BN = 64, 8 stages beat 6 by 5-8%
// (PERF.md, X17).
template <int BN>
struct WgCfg {
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;  // 16 KB
  static constexpr int B_BYTES = WG_BK * BN * 2;     // 8 to 32 KB
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int FIT = (WG_SMEM_MAX - 2048) / (STAGE + 16);
  static constexpr int STAGES = FIT < WG_MAX_STAGES ? FIT : WG_MAX_STAGES;
  static_assert(STAGES * STAGE >= WG_BM * (BN + 8) * 4, "epilogue tile");
  static constexpr size_t smem = (size_t)STAGES * STAGE + 1024 + 2 * STAGES * 8;
};

// The origin (m0, n0) of block `id`'s tile: tiles rastered in groups of
// WG_GROUP_M tile rows, so that the blocks on the card at one time share
// their B panels in L2.
template <int BN>
__device__ __forceinline__ void wg_tile_origin(int id, int M, int N, int& m0,
                                               int& n0) {
  const int num_m = (M + WG_BM - 1) / WG_BM, num_n = (N + BN - 1) / BN;
  const int per_group = WG_GROUP_M * num_n;
  const int first_m = (id / per_group) * WG_GROUP_M;
  const int gsize = min(num_m - first_m, WG_GROUP_M);
  m0 = (first_m + (id % per_group) % gsize) * WG_BM;
  n0 = ((id % per_group) / gsize) * BN;
}

// A consumer warpgroup (wg 1 or 2 of the block): 64 rows of the tile as
// m64nBNk16 wgmma accumulators in registers, one wgmma group in flight, a
// stage released when the group after it is issued; then the accumulators
// go through the ring (idle once both consumers are done with it) as an
// fp32 tile, and gemm_store8 stores eight columns a thread, each element
// once, with the GEMM's epilogue.  With the ABFT sidecar (e.ck_col set,
// the GEMM only) each thread writes its finished values back over the
// staged tile, and the two consumer warpgroups then sum the tile's columns
// and rows before they leave (tile_checksums).
template <typename T, int BN, typename C = WgCfg<BN>>
__device__ __forceinline__ void wg_consume(unsigned char* smem, uint64_t* full,
                                           uint64_t* empty, int kiters,
                                           const GemmEpi& e, int bz, int m0,
                                           int n0) {
  constexpr int STAGES = C::STAGES;
  const int c = threadIdx.x / 128 - 1;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < kiters; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const unsigned char* as = smem + s * C::STAGE + c * 64 * 128;
    const unsigned char* bs = smem + s * C::STAGE + C::A_BYTES;
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      const uint64_t da = wgmma_desc(as + kk * 32, 16, 1024, 128);
      const uint64_t db = wgmma_desc(bs + kk * 16 * 128, 64 * 128, 1024, 128);
      Wgmma<BN, T>::template ss<1>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(acc);
    if (it > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  reg_fence(acc);

  // Through shared memory (the ring, once both consumers are done with
  // it) as an fp32 tile: coalesced, paired stores from one loop.
  named_bar_sync(1, 256);
  constexpr int LDC = BN + 8;
  float* ct = reinterpret_cast<float*>(smem) + c * 64 * LDC;
  const int wl = threadIdx.x % 128, lane = wl % 32;
  const int r = (wl / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(ct + r * LDC + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(ct + (r + 8) * LDC + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_bar_sync(2 + c, 128);
  for (int i = wl; i < 64 * (BN / 8); i += 128) {
    const int rr = i / (BN / 8), col = 8 * (i % (BN / 8));
    const float4 lo = *reinterpret_cast<const float4*>(ct + rr * LDC + col);
    const float4 hi = *reinterpret_cast<const float4*>(ct + rr * LDC + col + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    gemm_store8(e, bz, m0 + c * 64 + rr, n0 + col, v);
    if (e.ck_col) {
      *reinterpret_cast<float4*>(ct + rr * LDC + col) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(ct + rr * LDC + col + 4) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
  }
  if (e.ck_col) {
    named_bar_sync(1, 256);  // both 64-row halves of the tile are final
    const int gm = (e.M + WG_BM - 1) / WG_BM, gn = (e.N + BN - 1) / BN;
    tile_checksums<float>(reinterpret_cast<const float*>(smem), LDC,
                          min(WG_BM, e.M - m0), min(BN, e.N - n0),
                          e.ck_col + ((long long)bz * gm + m0 / WG_BM) * e.N +
                              n0,
                          e.ck_row + ((long long)bz * e.M + m0) * gn + n0 / BN,
                          gn, threadIdx.x - 128, 256);
  }
}
