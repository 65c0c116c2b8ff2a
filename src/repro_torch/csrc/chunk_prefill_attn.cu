// Chunked-prefill GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/chunk_prefill_attn.py
// (_kernel, via chunk_prefill_attention): a C-token query chunk attends over
// [ring cache before the chunk, the chunk], all masking derived from the
// lane's offset (pinned-prefix ring positions, causality, sliding window,
// attention sink), online softmax in f32.
//
// What bounds it on this card: bytes of the cache it must read at the
// serving shapes (one C=32 chunk against up to S=1024 cached keys per lane
// and kv head; a few hundred FLOP per key byte in f32 CUDA-core math).  The
// design reads only what the offset makes visible: one block per
// (m, b, kv head, 64 query rows of the C*G rows), a loop inside the block
// over 64-key tiles of the S+C keys (the TPU kernel's sequential grid axis
// and its scratch carry) with a 4 x 4 register tile of (query, key) scores
// per thread.  A tile none of whose keys any row of the block may see --
// empty ring slots, keys after the chunk's last query, keys outside the
// window -- is skipped before it is loaded.  Skipping is
// exact: such keys would get p = exp(-1e30 - m) = 0.

#include "common.cuh"

namespace {

constexpr int QR = 64;          // query rows (C-major over G) per block
constexpr int TK = 64;          // keys per tile
constexpr int KS = TK + 1;      // padded stride of the transposed key tile
constexpr int PSS = TK + 4;     // stride of the transposed p tile (16-byte rows)
constexpr int THREADS = 256;    // 16 x 16
constexpr int MAX_HD = 128;

// Absolute position of key slot j: ring slots of the cache as it stood
// before the chunk (layers.cache_positions_after(off - 1, S, pin)), then
// the chunk's own rows at off + (j - S).  -1 marks an empty slot.
__device__ __forceinline__ int key_pos(int j, int off, int S, int pin) {
  if (j >= S) return off + j - S;
  const int last = off - 1;
  const int pinned = j <= last ? j : -1;
  const int w = S - pin;
  if (w <= 0) return pinned;
  if (j < pin) return pinned;
  const int qq = last - pin;
  const int cur = floormod(qq, w);
  const int base = qq - cur;
  const int i2 = j - pin;
  const int ring = (i2 <= cur ? base + i2 : base - w + i2) + pin;
  return (qq >= 0 && ring >= pin) ? ring : -1;
}

__device__ __forceinline__ bool visible(int p, int qp, int causal, int window, int sink) {
  bool v = p >= 0;
  if (causal) v = v && p <= qp;
  if (window > 0) v = v && (qp - p < window || (sink > 0 && p < sink));
  return v;
}

// Thread (ty, tx) of the 16 x 16 block owns query rows 4ty..4ty+3; for the
// scores it owns keys 4tx..4tx+3 of the tile (a 4 x 4 register tile), for
// P.V the head dims tx, tx+16, ...  Queries and keys sit transposed in
// shared memory (d-major) so a step of the d loop reads 4 rows with one
// 16-byte load.
template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ offset, T* __restrict__ out, int C, int H, int KVH,
                  int hd, int S, int pin, int window, int sink, int causal, float sqrt_hd) {
  extern __shared__ float sm[];
  const int G = H / KVH, CG = C * G, T_all = S + C;
  const int r0 = blockIdx.x * QR, kh = blockIdx.y;
  const size_t lane = blockIdx.z;
  const int off = offset[lane];
  float* qsT = sm;                         // hd x QR
  float* ksT = qsT + hd * QR;              // hd x KS (padded: conflict-free writes)
  float* vs = ksT + hd * KS;               // TK x hd
  float* psT = vs + TK * hd;               // TK x PSS
  int* kp = (int*)(psT + TK * PSS);        // TK

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int per = hd / 8;                  // 16-byte chunks per row (bf16)
  const int nrow = min(QR, CG - r0);
  for (int i = tid; i < QR * per; i += THREADS) {
    const int rr = i / per, d0 = (i - rr * per) * 8;
    float x8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (rr < nrow) {
      const int row = r0 + rr, c = row / G, g = row - c * G;
      const T* src = q + ((lane * C + c) * H + kh * G + g) * (size_t)hd + d0;
#pragma unroll
      for (int e = 0; e < 8; ++e) x8[e] = Ty<T>::to_f(src[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) qsT[(d0 + e) * QR + rr] = x8[e];
  }
  int qp[4];                                // positions of this thread's rows
#pragma unroll
  for (int i = 0; i < 4; ++i) qp[i] = off + (r0 + min(4 * ty + i, nrow - 1)) / G;
  const int qmin = off + r0 / G, qmax = off + (r0 + nrow - 1) / G;
  const int nu = (hd + 15) / 16;

  float m_r[4], l_r[4], acc[4][MAX_HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = NEG_INF_F;
    l_r[i] = 0.f;
#pragma unroll
    for (int u = 0; u < MAX_HD / 16; ++u) acc[i][u] = 0.f;
  }

  for (int j0 = 0; j0 < T_all; j0 += TK) {
    __syncthreads();   // previous tile's smem reads are done
    int any = 0;
    if (tid < TK) {
      const int j = j0 + tid;
      const int p = j < T_all ? key_pos(j, off, S, pin) : -1;
      kp[tid] = p;
      any = p >= 0 && (!causal || p <= qmax) &&
            (window <= 0 || qmin - p < window || (sink > 0 && p < sink));
    }
    if (!__syncthreads_or(any)) continue;
    for (int i = tid; i < TK * per; i += THREADS) {
      const int jj = i / per, d0 = (i - jj * per) * 8;
      const int j = j0 + jj;
      float k8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (j < T_all) {
        const size_t o = ((lane * T_all + j) * KVH + kh) * (size_t)hd + d0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          k8[e] = Ty<T>::to_f(k[o + e]);
          v8[e] = Ty<T>::to_f(v[o + e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ksT[(d0 + e) * KS + jj] = k8[e];
        vs[jj * hd + d0 + e] = v8[e];
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 q4 = *reinterpret_cast<const float4*>(qsT + d * QR + 4 * ty);
      const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
      float kv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = ksT[d * KS + 4 * tx + jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = NEG_INF_F;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = visible(kp[4 * tx + jj], qp[i], causal, window, sink) ? s[i][jj] / sqrt_hd
                                                                         : NEG_INF_F;
        tmax = fmaxf(tmax, s[i][jj]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m_r[i], tmax);
      const float corr = expf(m_r[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        psT[(4 * tx + jj) * PSS + 4 * ty + i] = p;
        psum += p;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l_r[i] = l_r[i] * corr + psum;
      m_r[i] = m_new;
#pragma unroll
      for (int u = 0; u < MAX_HD / 16; ++u) acc[i][u] *= corr;
    }
    __syncthreads();   // every row's p of this tile is in psT
    for (int jj = 0; jj < TK; ++jj) {
      const float4 p4 = *reinterpret_cast<const float4*>(psT + jj * PSS + 4 * ty);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int u = 0; u < MAX_HD / 16; ++u) {
        if (u < nu && tx + 16 * u < hd) {
          const float vv = vs[jj * hd + tx + 16 * u];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][u] = fmaf(pv[i], vv, acc[i][u]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = 4 * ty + i;
    if (rr >= nrow) continue;
    const int row = r0 + rr, c = row / G, g = row - c * G;
    T* o = out + ((lane * C + c) * H + kh * G + g) * (size_t)hd;
    const float inv = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int u = 0; u < MAX_HD / 16; ++u)
      if (u < nu && tx + 16 * u < hd) o[tx + 16 * u] = Ty<T>::from_f(acc[i][u] / inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* offset, void* out, int lanes,
           int C, int H, int KVH, int hd, int S, int pin, int window, int sink, int causal,
           float sqrt_hd, cudaStream_t stream) {
  if (hd > MAX_HD || hd % 8 || H % KVH) return (int)cudaErrorInvalidValue;
  const int smem = (hd * QR + hd * KS + TK * hd + TK * PSS + TK) * 4;
  auto kern = chunk_attn_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int CG = C * (H / KVH);
  dim3 grid((CG + QR - 1) / QR, KVH, lanes);
  kern<<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, offset, (T*)out,
                                        C, H, KVH, hd, S, pin, window, sink, causal, sqrt_hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (lanes,C,H,hd), k/v (lanes,S+C,KVH,hd), offset (lanes,) int32 ->
// out (lanes,C,H,hd); lanes = M*B.  dt: 0 = float32, 1 = bfloat16.
int chunk_prefill_attention(int dt, const void* q, const void* k, const void* v,
                            const void* offset, void* out, int lanes, int C, int H, int KVH,
                            int hd, int S, int pin, int window, int sink, int causal,
                            float sqrt_hd, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dt == 0)
    return launch<float>(q, k, v, (const int*)offset, out, lanes, C, H, KVH, hd, S, pin,
                         window, sink, causal, sqrt_hd, s);
  if (dt == 1)
    return launch<__nv_bfloat16>(q, k, v, (const int*)offset, out, lanes, C, H, KVH, hd, S,
                                 pin, window, sink, causal, sqrt_hd, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
