// The NetFuse merged matmul, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/fused_matmul.py
// (_kernel and _bias_kernel, via fused_matmul; fused_matmul_sharded runs
// the same on a rank's block): x (M,T,D) @ w (M,D,F) [+ b (M,F)] ->
// (M,T,F).  Instance m's rows only ever meet instance m's weights.  As
// kernels/ref.py::fused_matmul: w in x's dtype, the sum in f32, the bias
// added in f32, the result cast to x's dtype once.
//
// What bounds it on this card: the weight bytes.  A weight byte feeds T
// rows, so the intensity is T FLOP per byte of w -- at most 128 on the
// paper's BERT shape (T = 128) and 4 at serving (T = a few slots), both
// below the ~295 FLOP per byte where the H100's bf16 tensor cores would
// be the limit.  What matters is reading w once, with enough bytes in
// flight.  The bf16 design (rows 16-byte aligned: D and F multiples of 8):
//   * a ring of 5 (wide) or 4 (skinny) stages of x and w tiles in dynamic
//     shared memory, filled by 16-byte cp.async copies in the 128-byte
//     swizzle, k-step i + stages - 1 in flight while step i is multiplied;
//   * products by wgmma straight from those tiles (x K-major, w MN-major),
//     f32 accumulators in registers;
//   * wide (T > 16): one persistent block per SM walks the 128-row x
//     128-column output tiles, the ring running on from one tile into the
//     next; at T <= 128 one tile row covers the instance, so each w tile
//     is read once;
//   * skinny (T <= 16): out^T = w^T x^T, so the 64 rows of a wgmma run
//     along F and T is its N (8 or 16): at most half of the tensor work is
//     padding, not 60 of 64 rows.  Where the instances' column tiles are
//     fewer than the SMs, D is split over up to 8 blocks (the split is
//     chosen in fused_matmul.py's launch_plan), one cluster per output
//     tile; the cluster's first block sums the f32 partials over
//     distributed shared memory in split order, no atomics, so a call is
//     deterministic;
//   * the epilogue adds the bias in f32 and writes 16-byte vectors.
// f32 keeps FMA on CUDA cores (TF32 would not hold f32 to 1e-4): thread
// tiles of 8 x 4 over 64 x 64 blocks, the next BK-deep tiles fetched into
// registers while the current ones are multiplied.  Rows that are not
// 16-byte aligned (D or F not a multiple of 8, fused_matmul_sharded's
// replicated F = 77 case) gather their pieces element by element, for
// either dtype (bf16 there on wmma).  The Pallas kernel walks D on a
// sequential grid axis and carries the sum in a VMEM scratch; here a block
// loops over D itself.  Rows past T and columns past F are masked.

#include <cooperative_groups.h>
#include <cuda.h>
#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;          // rows of x per block
constexpr int BN = 64;          // output columns per block
constexpr int THREADS = 128;

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int BK = 64; };
template <> struct Cfg<float> { static constexpr int BK = 32; };

// EL elements row[c .. c + EL) of a row of n as one 16-byte piece, element
// by element, zero past n: for rows that are not 16-byte aligned.
template <typename T>
__device__ __forceinline__ uint4 gather_piece(const T* __restrict__ row, int c, int n) {
  constexpr int EL = 16 / sizeof(T);
  uint4 u = make_uint4(0, 0, 0, 0);
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < EL; ++i)
    if (c + i < n) e[i] = row[c + i];
  return u;
}

// One BK-deep step's tiles in registers: x (BM x BK) and w (BK x BN) as
// 16-byte pieces, zero where out of range.
template <typename T, bool VEC>
struct Frag {
  static constexpr int BK = Cfg<T>::BK;
  static constexpr int EL = 16 / sizeof(T);                 // elements per piece
  static constexpr int NX = BM * BK / EL / THREADS;
  static constexpr int NW = BK * BN / EL / THREADS;
  uint4 x[NX], w[NW];

  // VEC: D and F are multiples of EL and the rows 16-byte aligned, so a
  // piece lies wholly inside or past its row: one vector load.  Else each
  // piece is gathered element by element.
  __device__ __forceinline__ void load(const T* __restrict__ xm, const T* __restrict__ wm,
                                       int T_, int D, int F, int t0, int f0, int k0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int p = threadIdx.x + i * THREADS;
      const int r = p / (BK / EL), c = (p % (BK / EL)) * EL;
      if (VEC) {
        const bool ok = (t0 + r < T_) && (k0 + c < D);
        x[i] = ok ? *reinterpret_cast<const uint4*>(xm + (size_t)(t0 + r) * D + k0 + c)
                  : make_uint4(0, 0, 0, 0);
      } else {
        x[i] = (t0 + r < T_) ? gather_piece(xm + (size_t)(t0 + r) * D, k0 + c, D)
                             : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int p = threadIdx.x + i * THREADS;
      const int r = p / (BN / EL), c = (p % (BN / EL)) * EL;
      if (VEC) {
        const bool ok = (k0 + r < D) && (f0 + c < F);
        w[i] = ok ? *reinterpret_cast<const uint4*>(wm + (size_t)(k0 + r) * F + f0 + c)
                  : make_uint4(0, 0, 0, 0);
      } else {
        w[i] = (k0 + r < D) ? gather_piece(wm + (size_t)(k0 + r) * F, f0 + c, F)
                            : make_uint4(0, 0, 0, 0);
      }
    }
  }

  // xs: BM rows of stride xr elements; ws: BK rows of stride wr elements
  __device__ __forceinline__ void store(T* xs, int xr, T* ws, int wr) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int p = threadIdx.x + i * THREADS;
      const int r = p / (BK / EL), c = (p % (BK / EL)) * EL;
      *reinterpret_cast<uint4*>(xs + r * xr + c) = x[i];
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int p = threadIdx.x + i * THREADS;
      const int r = p / (BN / EL), c = (p % (BN / EL)) * EL;
      *reinterpret_cast<uint4*>(ws + r * wr + c) = w[i];
    }
  }
};

// Epilogue: acc tile (BM x BN, row stride cr) + bias -> out, masked.
template <typename T>
__device__ __forceinline__ void epilogue(const float* cs, int cr, const float* __restrict__ bias,
                                         T* __restrict__ om, int T_, int F, int t0, int f0) {
  for (int p = threadIdx.x; p < BM * BN; p += THREADS) {
    const int r = p / BN, c = p % BN;
    if (t0 + r < T_ && f0 + c < F) {
      float y = cs[r * cr + c];
      if (bias) y += bias[f0 + c];
      om[(size_t)(t0 + r) * F + f0 + c] = Ty<T>::from_f(y);
    }
  }
}

// bf16 rows that are not 16-byte aligned (D or F not a multiple of 8):
// wmma 16x16x16 on tensor cores, 4 warps, each a 32 x 32 quarter of the
// 64 x 64 tile as 2 x 2 accumulators.  Aligned bf16 takes the Hopper path
// below.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
fused_matmul_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int T_,
                  int D, int F) {
  using namespace nvcuda;
  using T = __nv_bfloat16;
  constexpr int BK = Cfg<T>::BK, XR = BK + 8, WR = BN + 8, CR = BN + 4;
  constexpr int AB_BYTES = (BM * XR + BK * WR) * 2;
  constexpr int SMEM = AB_BYTES > BM * CR * 4 ? AB_BYTES : BM * CR * 4;
  __shared__ __align__(32) unsigned char smem[SMEM];
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = xs + BM * XR;
  float* cs = reinterpret_cast<float*>(smem);     // reused after the last step

  const int f0 = blockIdx.x * BN, t0 = blockIdx.y * BM, m = blockIdx.z;
  const T* xm = x + (size_t)m * T_ * D;
  const T* wm = w + (size_t)m * D * F;
  const int warp = threadIdx.x / 32, wr0 = (warp / 2) * 32, wc0 = (warp % 2) * 32;
  // warps whose 32 rows all lie past T skip the products (T <= 32: half)
  const bool rows_live = t0 + wr0 < T_;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Frag<T, VEC> fr;
  fr.load(xm, wm, T_, D, F, t0, f0, 0);
  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();                       // the previous step's reads are done
    fr.store(xs, XR, ws, WR);
    __syncthreads();
    if (k0 + BK < D) fr.load(xm, wm, T_, D, F, t0, f0, k0 + BK);   // in flight meanwhile
    if (rows_live) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], xs + (wr0 + 16 * i) * XR + kk, XR);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], ws + kk * WR + wc0 + 16 * j, WR);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wr0 + 16 * i) * CR + wc0 + 16 * j, acc[i][j], CR,
                              wmma::mem_row_major);
  __syncthreads();
  epilogue<T>(cs, CR, bias ? bias + (size_t)m * F : nullptr, out + (size_t)m * T_ * F, T_, F,
              t0, f0);
}

// f32: FMA.  Thread (ty, tx) of a 8 x 16 grid owns rows ty*8 .. +8 and
// columns tx*4 .. +4 of the tile.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
fused_matmul_f32(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out, int T_, int D,
                 int F) {
  using T = float;
  constexpr int BK = Cfg<T>::BK, XR = BK + 4, WR = BN + 4;
  __shared__ __align__(16) float xs[BM * XR];
  __shared__ __align__(16) float ws[BK * WR];

  const int f0 = blockIdx.x * BN, t0 = blockIdx.y * BM, m = blockIdx.z;
  const T* xm = x + (size_t)m * T_ * D;
  const T* wm = w + (size_t)m * D * F;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][4] = {};

  Frag<T, VEC> fr;
  fr.load(xm, wm, T_, D, F, t0, f0, 0);
  for (int k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();
    fr.store(xs, XR, ws, WR);
    __syncthreads();
    if (k0 + BK < D) fr.load(xm, wm, T_, D, F, t0, f0, k0 + BK);
    if (t0 + ty * 8 < T_) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(ws + kk * WR + tx * 4);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float a = xs[(ty * 8 + r) * XR + kk];
          acc[r][0] = fmaf(a, b.x, acc[r][0]);
          acc[r][1] = fmaf(a, b.y, acc[r][1]);
          acc[r][2] = fmaf(a, b.z, acc[r][2]);
          acc[r][3] = fmaf(a, b.w, acc[r][3]);
        }
      }
    }
  }
  float* om = out + (size_t)m * T_ * F;
  const float* bm = bias ? bias + (size_t)m * F : nullptr;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = t0 + ty * 8 + r;
    if (t >= T_) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int f = f0 + tx * 4 + c;
      if (f < F) om[(size_t)t * F + f] = acc[r][c] + (bm ? bm[f] : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA fills a ring of 128-byte-swizzled shared-memory tiles
// from one producer warp (an mbarrier pair per stage); two consumer
// warpgroups multiply them with wgmma (rows 16-byte aligned: D and F
// multiples of 8, as TMA's strides need)
// ---------------------------------------------------------------------------

constexpr int WIDE_ROWS = 128;               // rows of x per wide tile: two warpgroups of 64
constexpr int X_WIDE = WIDE_ROWS * HK * 2;   // 16 KB: x (WIDE_ROWS x HK)
constexpr int X_SKINNY = 16 * HK * 2;        // 2 KB: x (<= 16 rows x HK)
constexpr int MAX_SPLIT = 8;                 // blocks of a cluster (the portable limit)

// D (64 x BN) += A (64 x 16) B (16 x BN): x K-major, w MN-major
template <int BN>
__device__ __forceinline__ void wide_mma(float (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_n128<0, 1>(acc, da, db);
  else wgmma_n256<0, 1>(acc, da, db);
}

// Wide (T > 16): a block of two consumer warpgroups and a producer warp
// walks the output tiles blockIdx.x, + gridDim.x, ... (a tile: rows [t0,
// t0 + 128) x columns [f0, f0 + BN) of one instance, BN = 256, or 128
// where the launch plan finds 256 would leave SMs idle; warpgroup g the
// rows t0 + 64g .. + 64, skipped where they all lie past T).  The producer
// runs ahead across tiles, so the next tile's first stages arrive while
// this one's epilogue runs.  At T <= 128 one tile row covers the
// instance, so each w tile is read once.  A = x (K-major), B = w
// (MN-major, BN / 64 chunks of 64 columns).  Each warp fetches the tile's
// bias into shared memory at the tile's first k-step (cp.async), so the
// epilogue does not wait on loads queued behind the weight stream.
// Epilogue: each warp rounds its 16 x BN accumulators (+ bias) into its
// own staging rows, 128 columns at a time, and stores them as 16-byte
// vectors.
constexpr int WIDE_ES = 128 + 8;                            // bf16 staging stride
constexpr int WIDE_EPI = 8 * 16 * WIDE_ES * 2;              // 8 consumer warps
template <int BN, int STAGES>
struct WideCfg {
  static constexpr int STAGE = X_WIDE + BN * HK * 2;
  using R = Ring<STAGES, STAGE, 256>;
  static constexpr int BIAS = 8 * BN * 4;                   // each warp's copy of a tile's bias
  static constexpr int SMEM = 1024 + R::BYTES + WIDE_EPI + BIAS;
  static_assert(SMEM <= MAX_SMEM, "wide shared memory");
};

template <int BN, int STAGES>
__global__ void __launch_bounds__(288, 1)
matmul_wide(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int T_,
            int D, int F) {
  using Cfg = WideCfg<BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  typename Cfg::R ring;
  ring.init(smem);
  const int ft = (F + BN - 1) / BN, rt = (T_ + WIDE_ROWS - 1) / WIDE_ROWS;
  const int tiles = ft * rt * M, nk = (D + HK - 1) / HK;
  const int mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = mine * nk;
  // tile i of this block -> (instance, first row, first column)
  auto tile = [&](int i, int& m, int& t0, int& f0) {
    const int id = blockIdx.x + i * gridDim.x;
    f0 = (id % ft) * BN;
    t0 = (id / ft % rt) * WIDE_ROWS;
    m = id / (ft * rt);
  };

  if (threadIdx.x >= 256) {                  // the producer warp
    if (threadIdx.x == 256) {
      for (int g = 0; g < steps; ++g) {
        int m, t0, f0;
        tile(g / nk, m, t0, f0);
        const int k0 = (g % nk) * HK;
        ring.wait_empty(g);
        const uint32_t s = ring.stage(g), bar = ring.full(g);
        mbar_expect(bar, Cfg::STAGE);
        tma3(s, &xmap, k0, t0, m, bar);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma3_once(s + X_WIDE + c * W_CHUNK, &wmap, f0 + 64 * c, k0, m, bar);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* es = reinterpret_cast<__nv_bfloat16*>(smem + Cfg::R::BYTES) + warp * 16 * WIDE_ES;
  float* sbias = reinterpret_cast<float*>(smem + Cfg::R::BYTES + WIDE_EPI) + warp * BN;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int g = 0; g < steps; ++g) {
    int m, t0, f0;
    tile(g / nk, m, t0, f0);
    if (bias && g % nk == 0)         // this tile's bias, in flight until its epilogue
      for (int c = 4 * lane; c < BN; c += 128)
        cp16(smem_addr(sbias + c), f0 + c < F ? bias + (size_t)m * F + f0 + c : bias, f0 + c < F);
    ring.wait_full(g);
    if (t0 + 64 * wg < T_) {
      const uint32_t s = ring.stage(g), xs = s + wg * 64 * 128, ws = s + X_WIDE;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HK / 16; ++kk)
        wide_mma<BN>(acc, gdesc(xs + kk * 32, 16, 1024), gdesc(ws + kk * 2048, W_CHUNK, 1024));
      wg_commit();
      wg_wait0();
    }
    mbar_arrive(ring.empty(g));
    if (g % nk != nk - 1) continue;
    // epilogue of the tile: rows r0 + lane / 4 (+ 8) of this warp, columns
    // 8 j + 2 (lane % 4) (+ 1), 128 at a time through the staging rows
    const int r0 = t0 + 64 * wg + 16 * (warp & 3);
    __nv_bfloat16* om = out + (size_t)m * T_ * F;
    if (bias) {
      cp_wait_all();
      __syncwarp();                  // the warp's bias copy has landed
    }
#pragma unroll
    for (int h = 0; h < BN / 128; ++h) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * (lane & 3), a = 4 * (16 * h + j);
        const float2 b = bias ? *reinterpret_cast<const float2*>(sbias + 128 * h + c)
                              : make_float2(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(es + (lane >> 2) * WIDE_ES + c) =
            __floats2bfloat162_rn(acc[a] + b.x, acc[a + 1] + b.y);
        *reinterpret_cast<__nv_bfloat162*>(es + ((lane >> 2) + 8) * WIDE_ES + c) =
            __floats2bfloat162_rn(acc[a + 2] + b.x, acc[a + 3] + b.y);
        acc[a] = acc[a + 1] = acc[a + 2] = acc[a + 3] = 0.f;
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i) {   // 16 rows x 16 pieces of 16 bytes
        const int p = lane + 32 * i, rr = p >> 4, c = (p & 15) * 8;
        const int t = r0 + rr, f = f0 + 128 * h + c;
        if (t < T_ && f < F)
          *reinterpret_cast<uint4*>(om + (size_t)t * F + f) =
              *reinterpret_cast<const uint4*>(es + rr * WIDE_ES + c);
      }
      __syncwarp();                  // staging rows free again
    }
  }
}

// Skinny (T <= 16): the operands swap, out^T (F x T) = w^T x^T, so the 64
// rows of a wgmma run along F and T is its N (8 or 16): A = w (MN-major),
// B = x (K-major).  A block of two consumer warpgroups and a producer warp
// owns columns [f0, f0 + 128) of one instance (warpgroup g the 64 at f0 +
// 64g) over k-steps [kb, ke) of D, a ring of 6 stages.  split > 1: the split
// blocks of an output tile form one cluster; each leaves its f32 partial
// in its shared memory, and the cluster's first block sums them over
// distributed shared memory in split order (the remote loads all in
// flight at once), adds the bias and writes the tile (no scratch, no
// second launch, no atomics).
struct SkinnyCfg {
  static constexpr int TILE = 128, STAGES = 6, STAGE = 2 * W_CHUNK + X_SKINNY;
  static constexpr int CS = TILE + 4;        // f32 partial stride: conflict-free writes
  using R = Ring<STAGES, STAGE, 256>;
  static constexpr int SMEM = 1024 + R::BYTES;
  static_assert(16 * CS * 4 <= STAGES * STAGE && SMEM <= MAX_SMEM, "skinny shared memory");
};

template <int N>
__global__ void __launch_bounds__(288)
matmul_skinny(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
              const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int T_, int D,
              int F, int split) {
  using Cfg = SkinnyCfg;
  constexpr int CONSUMERS = 256;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1k(smem_raw);
  typename Cfg::R ring;
  ring.init(smem);
  const int f0 = blockIdx.x * Cfg::TILE, sp = blockIdx.y, m = blockIdx.z;
  const int nk_all = (D + HK - 1) / HK;
  const int kb = sp * nk_all / split, nk = (sp + 1) * nk_all / split - kb;
  cg::cluster_group cl = cg::this_cluster();

  if (threadIdx.x >= CONSUMERS) {            // the producer warp
    if (threadIdx.x == CONSUMERS) {
      for (int i = 0; i < nk; ++i) {
        const int k0 = (kb + i) * HK;
        ring.wait_empty(i);
        const uint32_t s = ring.stage(i), bar = ring.full(i);
        mbar_expect(bar, 2 * W_CHUNK + N * HK * 2);
        tma3_once(s, &wmap, f0, k0, m, bar);
        tma3_once(s + W_CHUNK, &wmap, f0 + 64, k0, m, bar);
        tma3(s + 2 * W_CHUNK, &xmap, k0, 0, m, bar);
      }
    }
  } else {
    const int wg = threadIdx.x >> 7;
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < nk; ++i) {
      ring.wait_full(i);
      const uint32_t s = ring.stage(i), ws = s + wg * W_CHUNK, xs = s + 2 * W_CHUNK;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HK / 16; ++kk) {
        if constexpr (N == 8)
          wgmma_n8<1, 0>(acc, gdesc(ws + kk * 2048, W_CHUNK, 1024), gdesc(xs + kk * 32, 16, 1024));
        else
          wgmma_n16<1, 0>(acc, gdesc(ws + kk * 2048, W_CHUNK, 1024), gdesc(xs + kk * 32, 16, 1024));
      }
      wg_commit();
      wg_wait0();
      mbar_arrive(ring.empty(i));
    }
    // every stage is consumed (and no more arrive): the partial goes where
    // the ring was.  f = 64 wg + 16 warp + lane / 4 (+ 8), t = 8 j + 2
    // (lane % 4) (+ 1) -> cs[t][f]
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    float* cs = reinterpret_cast<float*>(smem);
    const int lane = threadIdx.x & 31;
    const int fr = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int t = 8 * j + 2 * (lane & 3);
      cs[t * Cfg::CS + fr] = acc[4 * j];
      cs[(t + 1) * Cfg::CS + fr] = acc[4 * j + 1];
      cs[t * Cfg::CS + fr + 8] = acc[4 * j + 2];
      cs[(t + 1) * Cfg::CS + fr + 8] = acc[4 * j + 3];
    }
  }
  if (split > 1)
    cl.sync();                       // every split's partial is in its shared memory
  else
    __syncthreads();
  if (cl.block_rank() == 0 && threadIdx.x < CONSUMERS) {
    const float* cs = reinterpret_cast<const float*>(smem);
    const float* bm = bias ? bias + (size_t)m * F : nullptr;
    __nv_bfloat16* om = out + (size_t)m * T_ * F;
    for (int p = threadIdx.x; p < N * Cfg::TILE / 8; p += CONSUMERS) {
      const int t = p / (Cfg::TILE / 8), c = p % (Cfg::TILE / 8) * 8, f = f0 + c;
      if (t >= T_ || f >= F) continue;
      float a[8], b[MAX_SPLIT][8];
#pragma unroll
      for (int r = 1; r < MAX_SPLIT; ++r)     // every remote load in flight at once
        if (r < split) Load8<float>::run(cl.map_shared_rank(cs, r) + t * Cfg::CS + c, b[r]);
      Load8<float>::run(cs + t * Cfg::CS + c, a);
#pragma unroll
      for (int r = 1; r < MAX_SPLIT; ++r)
        if (r < split) {
#pragma unroll
          for (int q = 0; q < 8; ++q) a[q] += b[r][q];
        }
      if (bm) {
        Load8<float>::run(bm + f, b[0]);
#pragma unroll
        for (int q = 0; q < 8; ++q) a[q] += b[0][q];
      }
      *reinterpret_cast<uint4*>(om + (size_t)t * F + f) = pack8(a);
    }
  }
  if (split > 1) cl.sync();          // the first block is done reading the others
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The FMA (f32) and element-wise (bf16 rows not 16-byte aligned) kernels on
// instances [0, g.z) of x, w, bias, out (already offset).
cudaError_t launch_simt(int dt, const dim3& g, cudaStream_t s, const void* x, const void* w,
                        const float* bias, void* out, int T_, int D, int F) {
  const bool vec = D % 8 == 0 && F % 8 == 0;
  if (dt == 0 && vec)
    fused_matmul_f32<true><<<g, THREADS, 0, s>>>((const float*)x, (const float*)w, bias,
                                                   (float*)out, T_, D, F);
  else if (dt == 0)
    fused_matmul_f32<false><<<g, THREADS, 0, s>>>((const float*)x, (const float*)w, bias,
                                                    (float*)out, T_, D, F);
  else
    fused_matmul_bf16<false><<<g, THREADS, 0, s>>>((const __nv_bfloat16*)x,
                                                     (const __nv_bfloat16*)w, bias,
                                                     (__nv_bfloat16*)out, T_, D, F);
  return cudaGetLastError();
}


// The wide instantiations the launch plan picks from: 128 or 256 columns.
#define WIDE_KERNELS(X) X(128, 5) X(256, 3)

// Raise the dynamic shared-memory limit of the wgmma kernels, once per
// device.
cudaError_t allow_hopper_smem() {
  static unsigned done = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (done & bit) return cudaSuccess;
#define ALLOW_WIDE(BN, ST) \
  if ((e = allow_smem(matmul_wide<BN, ST>, WideCfg<BN, ST>::SMEM)) != cudaSuccess) return e;
  WIDE_KERNELS(ALLOW_WIDE)
  if ((e = allow_smem(matmul_skinny<8>, SkinnyCfg::SMEM)) != cudaSuccess) return e;
  if ((e = allow_smem(matmul_skinny<16>, SkinnyCfg::SMEM)) != cudaSuccess) return e;
  done |= bit;
  return cudaSuccess;
}

// The wgmma path on instances [0, mc): variant 1 wide (cols 128 or 256) on
// `grid` blocks; variant 2 skinny (cols 128; N 8 where T <= 8, else 16) in
// clusters of `split` blocks along y.
cudaError_t launch_hopper(int variant, int cols, int grid, int mc, cudaStream_t s, const void* x,
                          const void* w, const void* wmap_host, const float* bias,
                          __nv_bfloat16* out, int T_, int D, int F, int split) {
  const int n = T_ <= 8 ? 8 : 16;
  CUtensorMap xmap, wmap;
  cudaError_t e = tensor_map(&xmap, x, D, T_, mc, variant == 1 ? WIDE_ROWS : n);
  if (e == cudaSuccess && wmap_host != nullptr)
    memcpy(&wmap, wmap_host, sizeof(wmap));
  else if (e == cudaSuccess)
    e = tensor_map(&wmap, w, F, D, mc, HK);
  if (e != cudaSuccess) return e;
  if (variant == 1) {
#define LAUNCH_WIDE(BN, ST)                                                                \
  if (cols == BN) {                                                                        \
    matmul_wide<BN, ST><<<grid, 288, WideCfg<BN, ST>::SMEM, s>>>(xmap, wmap, bias, out, mc, \
                                                                 T_, D, F);                \
    return cudaGetLastError();                                                             \
  }
    WIDE_KERNELS(LAUNCH_WIDE)
    return cudaErrorInvalidValue;
  }
  if (cols != SkinnyCfg::TILE) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((F + cols - 1) / cols, split, mc);
  cfg.blockDim = dim3(288);
  cfg.dynamicSmemBytes = SkinnyCfg::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = n == 8 ? cudaLaunchKernelEx(&cfg, matmul_skinny<8>, xmap, wmap, bias, out, T_, D, F, split)
             : cudaLaunchKernelEx(&cfg, matmul_skinny<16>, xmap, wmap, bias, out, T_, D, F, split);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M,T,D), w (M,D,F) of one dtype (dt: 0 = float32, 1 = bfloat16), bias
// (M,F) float32 or null -> out (M,T,F) in x's dtype, any M, T, D, F >= 1.
// variant, cols, grid and split come from fused_matmul.py's launch_plan:
// 0 the FMA / element-wise kernel (split 1); bf16 with D and F multiples
// of 8 only: 1 wide, tiles of 128 rows x cols (128 or 256) walked by
// `grid` blocks (split 1); 2 skinny, T <= 16, tiles of cols = 128
// columns, 1 <= split <= min(8, ceil(D / 64)) blocks (a cluster) per
// tile.  wmap: w's tensor map (tensor_map_encode: bf16, boxes of 64 x 64,
// 128-byte swizzle; 128 bytes on the host), or null to encode it here; used where all M instances run in
// one pass.  Returns the first error of the tensor-map, attribute and
// launch calls.
int fused_matmul(int dt, const void* x, const void* w, const void* wmap, const void* bias,
                 void* out, int M, int T_, int D, int F, int variant, int cols, int grid,
                 int split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M < 1 || T_ < 1 || D < 1 || F < 1 || (dt != 0 && dt != 1) || variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  if (variant == 0 ? split != 1
                   : (dt != 1 || D % 8 || F % 8 || split < 1 || split > MAX_SPLIT ||
                      split > (D + HK - 1) / HK || (variant == 2 && T_ > 16) ||
                      (variant == 1 && (split != 1 || grid < 1))))
    return (int)cudaErrorInvalidValue;
  if (variant != 0) {
    const cudaError_t e = allow_hopper_smem();
    if (e != cudaSuccess) return (int)e;
  }
  const size_t esz = dt == 0 ? 4 : 2;
  for (int m = 0; m < M; m += 65535) {
    // gridDim.z is at most 65535; M never comes near it, but stay correct
    const int mc = M - m < 65535 ? M - m : 65535;
    const char* xm = (const char*)x + m * esz * T_ * D;
    const char* wm = (const char*)w + m * esz * D * F;
    char* om = (char*)out + m * esz * T_ * F;
    const float* b = bias ? (const float*)bias + (size_t)m * F : nullptr;
    cudaError_t e;
    if (variant == 0)
      e = launch_simt(dt, dim3((F + BN - 1) / BN, (T_ + BM - 1) / BM, mc), s, xm, wm, b, om, T_,
                      D, F);
    else
      e = launch_hopper(variant, cols, grid, mc, s, xm, wm, M <= 65535 ? wmap : nullptr, b,
                        (__nv_bfloat16*)om, T_, D, F, split);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// hopper.cuh's encode_map: a tensor map into out (128 bytes on the host).
// The wrappers encode each weight's map once (kernels/build.py, TensorMaps).
int tensor_map_encode(void* out, const void* base, int dt, int n0, int n1, int n2, int b0, int b1,
                      int swizzle) {
  return (int)encode_map(out, base, dt, n0, n1, n2, b0, b1, swizzle);
}

}  // extern "C"
