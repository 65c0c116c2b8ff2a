// The NetFuse merged matmul, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/fused_matmul.py
// (_kernel and _bias_kernel, via fused_matmul): x (M,T,D) @ w (M,D,F)
// [+ b (M,F)] -> (M,T,F).  Instance m's rows only ever meet instance m's
// weights.  As kernels/ref.py::fused_matmul: w in x's dtype, the sum in
// f32, the bias added in f32, the result cast to x's dtype once.
//
// What bounds it on this card depends on T:
//   * skinny (the serving shape, T = a few slots): bytes -- every weight byte
//     is used by only T rows.  A block owns BN output columns of one
//     instance for BM >= T rows, so each weight byte is read once per
//     instance; the next BK-deep tiles are fetched into registers while the
//     current ones are multiplied, so a block keeps a load in flight.
//   * wide (the paper's BERT shape, T = 128): operations -- 19.3 GFLOP at
//     M = 32.  bf16 tiles go through the tensor cores (wmma 16x16x16 with
//     f32 accumulators); f32 uses plain FMA (TF32 would not hold f32 to
//     1e-4), each thread an 8 x 4 register tile.
// The Pallas kernel walks D on a sequential grid axis and carries the sum in
// a VMEM scratch; here a block loops over D itself.  Rows past T and columns
// past F are masked; D and F must be multiples of 8 (16-byte loads).

#include <mma.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;          // rows of x per block
constexpr int BN = 64;          // output columns per block
constexpr int THREADS = 128;

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int BK = 64; };
template <> struct Cfg<float> { static constexpr int BK = 32; };

// One BK-deep step's tiles in registers: x (BM x BK) and w (BK x BN) as
// 16-byte pieces, zero where out of range.
template <typename T>
struct Frag {
  static constexpr int BK = Cfg<T>::BK;
  static constexpr int EL = 16 / sizeof(T);                 // elements per piece
  static constexpr int NX = BM * BK / EL / THREADS;
  static constexpr int NW = BK * BN / EL / THREADS;
  uint4 x[NX], w[NW];

  __device__ __forceinline__ void load(const T* __restrict__ xm, const T* __restrict__ wm,
                                       int T_, int D, int F, int t0, int f0, int k0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int p = threadIdx.x + i * THREADS;
      const int r = p / (BK / EL), c = (p % (BK / EL)) * EL;
      const bool ok = (t0 + r < T_) && (k0 + c < D);
      x[i] = ok ? *reinterpret_cast<const uint4*>(xm + (size_t)(t0 + r) * D + k0 + c)
                : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int p = threadIdx.x + i * THREADS;
      const int r = p / (BN / EL), c = (p % (BN / EL)) * EL;
      const bool ok = (k0 + r < D) && (f0 + c < F);
      w[i] = ok ? *reinterpret_cast<const uint4*>(wm + (size_t)(k0 + r) * F + f0 + c)
                : make_uint4(0, 0, 0, 0);
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

// bf16: tensor cores.  4 warps, each a 32 x 32 quarter of the 64 x 64 tile
// as 2 x 2 wmma accumulators.
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

  Frag<T> fr;
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

  Frag<T> fr;
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

}  // namespace

extern "C" {

// x (M,T,D), w (M,D,F) of one dtype (dt: 0 = float32, 1 = bfloat16), bias
// (M,F) float32 or null -> out (M,T,F) in x's dtype.  D % 8 == 0 and
// F % 8 == 0.  Returns cudaGetLastError() after the launch.
int fused_matmul(int dt, const void* x, const void* w, const void* bias, void* out, int M,
                 int T_, int D, int F, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M < 1 || T_ < 1 || D < 1 || F < 1 || D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((F + BN - 1) / BN, (T_ + BM - 1) / BM, M);
  for (int m = 0; m < M; m += 65535) {
    // gridDim.z is at most 65535; M never comes near it, but stay correct
    const int mc = M - m < 65535 ? M - m : 65535;
    const dim3 g(grid.x, grid.y, mc);
    const float* b = bias ? (const float*)bias + (size_t)m * F : nullptr;
    if (dt == 0)
      fused_matmul_f32<<<g, THREADS, 0, s>>>(
          (const float*)x + (size_t)m * T_ * D, (const float*)w + (size_t)m * D * F, b,
          (float*)out + (size_t)m * T_ * F, T_, D, F);
    else if (dt == 1)
      fused_matmul_bf16<<<g, THREADS, 0, s>>>(
          (const __nv_bfloat16*)x + (size_t)m * T_ * D,
          (const __nv_bfloat16*)w + (size_t)m * D * F, b,
          (__nv_bfloat16*)out + (size_t)m * T_ * F, T_, D, F);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
