// The merged per-instance RMS norm, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/group_norm.py (_kernel,
// via group_rms_norm): x (M,T,D), scale (M,D) -> (M,T,D); row (m, t) is
// normalised with its own f32 mean square and instance m's scale (the
// paper's layer-norm -> group-norm merge in instance-axis form).  As
// kernels/ref.py::group_rms_norm: y = x * rsqrt(mean(x^2) + eps) * scale in
// f32, cast to x's dtype on write.
//
// What bounds it on this card: bytes (each row is read once and written
// once; a few FLOP per element).  At the paper's BERT shape (M=32, T=128,
// D=768, bf16) that is 12.6 MB, 3.8 us at 3.35 TB/s: one launch costs about
// as much, so latency dominates there.  The TPU kernel keeps (bt rows, D) in
// VMEM; here one warp owns a row: it reads the row in 16-byte pieces, sums
// the squares with a warp reduction, and reads the row again (from L1) to
// write the scaled row.  No block waits on another.  D must be a multiple
// of 8.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;           // one warp per row
constexpr int MAX_D = 8192;

template <typename T> struct Store8;
template <> struct Store8<__nv_bfloat16> {
  static __device__ __forceinline__ void run(__nv_bfloat16* p, const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};
template <> struct Store8<float> {
  static __device__ __forceinline__ void run(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// grid: (ceil(T / ROWS), M).  S is the scale's dtype.
template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
group_rms_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
                 int T_, int D, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x * ROWS + warp, m = blockIdx.y;
  if (t >= T_) return;
  const size_t row = ((size_t)m * T_ + t) * D;
  const S* sm = scale + (size_t)m * D;
  float ss = 0.f;
  for (int c = lane * 8; c < D; c += 32 * 8) {
    float v[8];
    Load8<T>::run(x + row + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss = fmaf(v[e], v[e], ss);
  }
  const float r = rsqrtf(warp_sum(ss) / (float)D + eps);
  // second pass over the row: the warp read it just now, so it comes from L1
  for (int c = lane * 8; c < D; c += 32 * 8) {
    float v[8], s8[8], y[8];
    Load8<T>::run(x + row + c, v);
    Load8<S>::run(sm + c, s8);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = v[e] * r * s8[e];
    Store8<T>::run(out + row + c, y);
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int M, int T_, int D, float eps,
           cudaStream_t s) {
  const dim3 grid((T_ + ROWS - 1) / ROWS, M);
  group_rms_kernel<T, S><<<grid, THREADS, 0, s>>>((const T*)x, (const S*)scale, (T*)out, T_,
                                                  D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M,T,D) in dt, scale (M,D) in sdt (0 = float32, 1 = bfloat16) -> out
// (M,T,D) in dt.  D % 8 == 0, D <= 8192.  Returns cudaGetLastError().
int group_rms_norm(int dt, int sdt, const void* x, const void* scale, void* out, int M, int T_,
                   int D, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M < 1 || M > 65535 || T_ < 1 || D < 8 || D % 8 || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  if (dt == 0 && sdt == 0) return launch<float, float>(x, scale, out, M, T_, D, eps, s);
  if (dt == 0 && sdt == 1) return launch<float, __nv_bfloat16>(x, scale, out, M, T_, D, eps, s);
  if (dt == 1 && sdt == 0) return launch<__nv_bfloat16, float>(x, scale, out, M, T_, D, eps, s);
  if (dt == 1 && sdt == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, M, T_, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
