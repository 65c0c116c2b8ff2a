// sLSTM cell for Hopper (sm_90a): the whole recurrent scan of one sLSTM
// block in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/slstm_cell.py (_kernel,
// via slstm_cell).  Per step t and head (block-diagonal recurrence):
//   rec_g = h_{t-1} @ r_g (g in z, i, f, o), gates = pre_t + rec,
//   lf = log_sigmoid(f), m_t = max(lf + m, i), c/n exponential gating with
//   the m-stabilizer, h_t = sigmoid(o) c_t / max(n_t, 1e-6).
// Gate math in f32; h is rounded to its storage dtype every step (as
// kernels/ref.py does); log_sigmoid is the stable min(x,0) - log1p(exp(-|x|))
// so that the neutral gates of padded steps (i = -1e30, f = +1e30) leave
// c, n and m exactly unchanged.  Built without fast math for that reason.
//
// What bounds it on this card: the recurrent weights.  r is 4 x hd x hd per
// (instance, head), 4 MB in f32 at hd = 512, and every step needs all of it
// (the recurrence runs through h, so steps cannot be batched).  The TPU
// kernel holds one (instance, head) in VMEM and walks S on its sequential
// grid; a Hopper SM has 227 KB and its blocks carry nothing between them.
// So one thread-block cluster of CL CTAs owns one (instance, head): CTA k
// owns hd/CL columns of each of the four gates for all B lanes, streams its
// r slice from L2/HBM every step (16-byte loads, the k reduction split over
// thread groups and summed in a fixed order), keeps c/n/m of its columns in
// shared memory across all S steps, and writes its new h columns into the
// double-buffered h of every CTA of the cluster through distributed shared
// memory; one cluster barrier per step.  Bytes per step are the r of all
// (instance, head) units, so a call costs about S times the r bytes.
//
// The state is updated in place; `alive` (nullable, (M, B) bool) leaves the
// state of a dead lane untouched.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;         // CTAs per (instance, head) = cluster size
constexpr int THREADS = 256;
constexpr int BT = 4;         // lanes per register tile of the recurrent matvec

template <typename R> struct RQuad;  // four neighbouring weights as floats

template <> struct RQuad<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
};

template <> struct RQuad<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// grid: M * H clusters of CL CTAs; blockIdx.x / CL = m * H + head.
// Shared memory (floats): hbuf [2][B][hd] | part [KG][BT][4*CW] | c, n, m [B][CW].
template <typename T, typename R>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS)
    slstm_kernel(const T* __restrict__ pre, const R* __restrict__ r, float* c, float* n, T* h,
                 float* mst, const bool* __restrict__ alive, T* __restrict__ hs, int B, int S,
                 int H, int hd) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int unit = blockIdx.x / CL;
  const int mi = unit / H, head = unit - mi * H;
  const int D = H * hd;
  const int CW = hd / CL;          // columns of each gate owned by this CTA
  const int c0 = rank * CW;        // first owned column within the head
  const int NQ = CW;               // float4 column quads over the four gates
  const int KG = THREADS / NQ;     // thread groups splitting the k reduction
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* hbuf = smem;
  float* part = hbuf + 2 * B * hd;
  float* cs = part + KG * BT * 4 * CW;
  float* ns = cs + B * CW;
  float* ms = ns + B * CW;

  const size_t row0 = (size_t)mi * B;           // (m, b) row of lane 0
  const size_t col = (size_t)head * hd;         // first column of the head in D
  for (int e = tid; e < B * hd; e += THREADS) {
    const int b = e / hd, k = e - b * hd;
    hbuf[e] = Ty<T>::to_f(h[(row0 + b) * D + col + k]);
  }
  for (int e = tid; e < B * CW; e += THREADS) {
    const int b = e / CW, j = e - b * CW;
    const size_t g = (row0 + b) * D + col + c0 + j;
    cs[e] = c[g];
    ns[e] = n[g];
    ms[e] = mst[g];
  }
  // every CTA of the cluster has started (its shared memory may be
  // written by its peers) and holds the initial state
  cluster.sync();

  // this thread's quad: gate gq, columns c0 + jq .. c0 + jq + 3; rows kg, kg + KG, ...
  const int q = tid % NQ, kg = tid / NQ;
  const int gq = q / (CW / 4), jq = (q - gq * (CW / 4)) * 4;
  const R* rq = r + (((size_t)mi * 4 + gq) * H + head) * hd * hd + c0 + jq;

  int cur = 0;
  for (int t = 0; t < S; ++t) {
    const float* hc = hbuf + cur * B * hd;
    float* hn = hbuf + (cur ^ 1) * B * hd;
    for (int b0 = 0; b0 < B; b0 += BT) {
      const int nb = min(BT, B - b0);
      if (kg < KG) {
        float acc[BT][4];
#pragma unroll
        for (int bb = 0; bb < BT; ++bb)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[bb][i] = 0.f;
#pragma unroll 8
        for (int k = kg; k < hd; k += KG) {
          const float4 w = RQuad<R>::load(rq + (size_t)k * hd);
#pragma unroll
          for (int bb = 0; bb < BT; ++bb) {
            const float hv = bb < nb ? hc[(b0 + bb) * hd + k] : 0.f;
            acc[bb][0] += hv * w.x;
            acc[bb][1] += hv * w.y;
            acc[bb][2] += hv * w.z;
            acc[bb][3] += hv * w.w;
          }
        }
#pragma unroll
        for (int bb = 0; bb < BT; ++bb)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[(kg * BT + bb) * 4 * CW + q * 4 + i] = acc[bb][i];
      }
      __syncthreads();
      for (int e = tid; e < nb * CW; e += THREADS) {
        const int bb = e / CW, j = e - bb * CW, b = b0 + bb;
        float rec[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = 0.f;
          for (int kk = 0; kk < KG; ++kk) sum += part[(kk * BT + bb) * 4 * CW + g * CW + j];
          rec[g] = sum;
        }
        const T* pt = pre + ((row0 + b) * S + t) * 4 * (size_t)D + col + c0 + j;
        const float zt = Ty<T>::to_f(pt[0]) + rec[0];
        const float it = Ty<T>::to_f(pt[D]) + rec[1];
        const float ft = Ty<T>::to_f(pt[2 * D]) + rec[2];
        const float ot = Ty<T>::to_f(pt[3 * D]) + rec[3];
        const int si = b * CW + j;
        const float lf = log_sigmoid(ft);
        const float mp = ms[si];
        const float mt = fmaxf(lf + mp, it);
        const float fp = expf(lf + mp - mt);
        const float ip = expf(it - mt);
        const float cn = fp * cs[si] + ip * tanhf(zt);
        const float nn = fp * ns[si] + ip;
        const float hv = rnd<T>(sigmoid(ot) * cn / fmaxf(nn, 1e-6f));
        cs[si] = cn;
        ns[si] = nn;
        ms[si] = mt;
        hs[((row0 + b) * S + t) * (size_t)D + col + c0 + j] = Ty<T>::from_f(hv);
        for (int p = 0; p < CL; ++p) cluster.map_shared_rank(hn, p)[b * hd + c0 + j] = hv;
      }
      __syncthreads();  // the partials are reused by the next lane tile
    }
    // h_t is complete in every CTA's buffer, and no CTA still reads h_{t-1}
    cluster.sync();
    cur ^= 1;
  }

  for (int e = tid; e < B * CW; e += THREADS) {
    const int b = e / CW, j = e - b * CW;
    if (alive != nullptr && !alive[row0 + b]) continue;
    const size_t g = (row0 + b) * D + col + c0 + j;
    c[g] = cs[e];
    n[g] = ns[e];
    mst[g] = ms[e];
    h[g] = Ty<T>::from_f(hbuf[cur * B * hd + b * hd + c0 + j]);
  }
}

template <typename T, typename R>
int launch(const void* pre, const void* r, void* c, void* n, void* h, void* m, const void* alive,
           void* hs, int M, int B, int S, int H, int hd, cudaStream_t stream) {
  if (hd % (4 * CL) || hd / CL > THREADS || B < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const int CW = hd / CL, KG = THREADS / CW;
  const size_t smem = sizeof(float) * (2 * (size_t)B * hd + (size_t)KG * BT * 4 * CW + 3 * (size_t)B * CW);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = slstm_kernel<T, R>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<M * H * CL, THREADS, smem, stream>>>((const T*)pre, (const R*)r, (float*)c, (float*)n,
                                               (T*)h, (float*)m, (const bool*)alive, (T*)hs, B,
                                               S, H, hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pre (M,B,S,4,D) dt; r (M,4,H,hd,hd) rdt; c/n/m (M,B,D) f32 and h (M,B,D)
// dt, updated in place; alive (M,B) bool or null; hs (M,B,S,D) dt.
// dt, rdt: 0 = float32, 1 = bfloat16.
int slstm_cell(int dt, int rdt, const void* pre, const void* r, void* c, void* n, void* h,
               void* m, const void* alive, void* hs, int M, int B, int S, int H, int hd,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dt == 0 && rdt == 0)
    return launch<float, float>(pre, r, c, n, h, m, alive, hs, M, B, S, H, hd, s);
  if (dt == 0 && rdt == 1)
    return launch<float, __nv_bfloat16>(pre, r, c, n, h, m, alive, hs, M, B, S, H, hd, s);
  if (dt == 1 && rdt == 0)
    return launch<__nv_bfloat16, float>(pre, r, c, n, h, m, alive, hs, M, B, S, H, hd, s);
  if (dt == 1 && rdt == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(pre, r, c, n, h, m, alive, hs, M, B, S, H, hd,
                                                s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
