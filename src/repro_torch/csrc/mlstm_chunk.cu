// The chunkwise mLSTM from zero state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_chunk.py (_kernel,
// via mlstm_chunkwise): q, k, v (M,B,H,S,hd) in their storage dtype, the
// log-forget and input-gate pre-activations lf, li (M,B,H,S) f32; from C = 0,
// n = 0, m = -1e30 it walks the S steps in chunks of cs and returns
// h (M,B,H,S,hd) in q's dtype and the final C (M,B,H,hd,hd), n (M,B,H,hd) and
// m (M,B,H), all f32.  Per chunk, as models/ssm.py::_mlstm_chunk (the plain
// version and the reference's kernels/ref.py oracle):
//
//   b = cumsum(lf);  g = cummax(li - b);  mt = b + max(m0, g)
//   D[t,s] = exp(li_s - b_s + b_t - mt_t) for s <= t, else 0
//   w = (q k^T / sqrt(hd)) * D
//   h = [round(w) v + exp(b + m0 - mt) (q C0) / sqrt(hd)] / max(|den|, exp(-mt))
//   den = sum_s w + exp(b + m0 - mt) (q . n0) / sqrt(hd)
//   C' = decay0 C0 + (round(w_end) k)^T v,  n' = decay0 n0 + sum_s round(w_end) k
//   w_end = exp(li + b_end - b - m_end),  decay0 = exp(b_end + m0 - m_end)
//
// where round() is a rounding to the storage dtype, as the plain version does.
//
// What bounds it on this card: operations, 4 cs hd^2 FLOP per chunk and
// lane (q C0 and the update of C) in f32.  The TPU kernel keeps one
// (instance, head)'s (hd, hd) C in VMEM across the chunks; at xlstm-1.3b's
// hd = 1024 that is 4 MB, far past the 227 KB of shared memory a block may
// hold.  But C's update is local to each (d, j) entry, and q C0 is a sum
// over d.  So two kernels:
//   * state: one block per (TD x TJ tile of C, lane) walks all chunks with
//     its 16 KB tile in shared memory.  Per chunk it writes its tile's share
//     of q C0 (the sum over its TD rows) to a partials buffer, then moves
//     the tile on to the chunk's end.  The blocks of the first column of
//     tiles also write their share of q k^T and q . n0 and carry n.  Each
//     thread owns a 4 x 4 (or up to 4 x 4 rows x columns) register tile of
//     every product, so a shared-memory load feeds several FMAs.
//   * output: one block per (TJ columns of h, lane) walks the chunks, sums
//     the partials over the d tiles in order, and forms w, den and h.
// No block waits on another within a kernel, nothing is recomputed, and
// the sums run in a fixed order.  Gate-neutral padded steps (li = -1e30,
// lf = 0) get w_end = 0 and D = 0 exactly, so whatever q, k, v they hold
// adds +-0.  cs <= 64, hd a multiple of 64.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TD = 64;            // rows (d) of a C tile
constexpr int TJ = 64;            // columns (j) of a C tile and of an h tile
constexpr int MAX_CS = 64;
constexpr int XR = TD + 4;        // padded row of a q / k tile (16-byte aligned)
constexpr int MA = MAX_CS / 16;   // rows t per thread in the chunk products

// The chunk's running sums, in step order (one thread), then the per-step
// gate terms.  g: lis, lfs (inputs); bsum, mt, ain, wend (outputs); sc[0]
// holds m0 and receives decay0 in sc[1] and m_end in sc[2].
template <typename T>
__device__ void chunk_gates(int cs, const float* lis, const float* lfs, float* bsum, float* mt,
                            float* ain, float* wend, float* sc) {
  if (threadIdx.x == 0) {
    const float m0 = sc[0];
    float bacc = 0.f, g = 0.f;
    for (int t = 0; t < cs; ++t) {
      bacc += lfs[t];
      bsum[t] = bacc;
      g = t == 0 ? lis[t] - bacc : fmaxf(g, lis[t] - bacc);
      mt[t] = bacc + fmaxf(m0, g);
    }
    sc[2] = mt[cs - 1];
    sc[1] = expf(bsum[cs - 1] + m0 - sc[2]);
  }
  __syncthreads();
  const float m0 = sc[0], m_end = sc[2], b_end = bsum[cs - 1];
  for (int t = threadIdx.x; t < cs; t += THREADS) {
    ain[t] = expf(bsum[t] + m0 - mt[t]);
    if (wend) wend[t] = rnd<T>(expf(lis[t] + b_end - bsum[t] - m_end));
  }
  __syncthreads();
}

__host__ __device__ inline int state_smem_floats(int cs) {
  return TD * TJ + 2 * cs * XR + cs * TJ + TD + 6 * cs + 4;
}

// grid: (lanes, hd / TJ, hd / TD).  Partials per (lane, chunk, d tile):
// pc (cs, hd) of q C0, ps (cs, cs) of q k^T, pn (cs) of q . n0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_state_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ lf, const float* __restrict__ li,
                   float* __restrict__ pc, float* __restrict__ ps, float* __restrict__ pn,
                   float* __restrict__ cf, float* __restrict__ nf, float* __restrict__ mf, int S,
                   int hd, int cs) {
  extern __shared__ __align__(16) float sm[];
  const size_t lane = blockIdx.x;
  const int j0 = blockIdx.y * TJ, dt = blockIdx.z, d0 = dt * TD, ndt = gridDim.z;
  const bool first_col = blockIdx.y == 0;       // carries n and the q k^T, q . n0 partials
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float* Cs = sm;                         // TD x TJ
  float* qs = Cs + TD * TJ;               // cs x XR: q[:, d tile]
  float* ks = qs + cs * XR;               // cs x XR: k[:, d tile]
  float* vs = ks + cs * XR;               // cs x TJ: v[:, j tile]
  float* ns = vs + cs * TJ;               // TD: n[d tile]
  float* lis = ns + TD;
  float* lfs = lis + cs;
  float* bsum = lfs + cs;
  float* mt = bsum + cs;
  float* ain = mt + cs;
  float* wend = ain + cs;
  float* sc = wend + cs;

  for (int i = tid; i < TD * TJ; i += THREADS) Cs[i] = 0.f;
  for (int i = tid; i < TD; i += THREADS) ns[i] = 0.f;
  if (tid == 0) sc[0] = NEG_INF_F;
  const T* qb = q + lane * S * hd;
  const T* kb = k + lane * S * hd;
  const T* vb = v + lane * S * hd;
  const int nch = S / cs;

  for (int c = 0; c < nch; ++c) {
    const int c0 = c * cs;
    __syncthreads();                      // the previous chunk is done with everything
    for (int i = tid; i < cs; i += THREADS) {
      lis[i] = li[lane * S + c0 + i];
      lfs[i] = lf[lane * S + c0 + i];
    }
    for (int p = tid; p < cs * (TD / 8); p += THREADS) {
      const int t = p / (TD / 8), e = (p % (TD / 8)) * 8;
      Load8<T>::run(qb + (size_t)(c0 + t) * hd + d0 + e, qs + t * XR + e);
      Load8<T>::run(kb + (size_t)(c0 + t) * hd + d0 + e, ks + t * XR + e);
    }
    for (int p = tid; p < cs * (TJ / 8); p += THREADS) {
      const int t = p / (TJ / 8), e = (p % (TJ / 8)) * 8;
      Load8<T>::run(vb + (size_t)(c0 + t) * hd + j0 + e, vs + t * TJ + e);
    }
    __syncthreads();
    chunk_gates<T>(cs, lis, lfs, bsum, mt, ain, wend, sc);

    const size_t part = (lane * nch + c) * ndt + dt;
    // q C0 over this tile's rows: thread (ty, tx) owns rows ty + 16a,
    // columns tx*4 .. +4
    {
      float acc[MA][4] = {};
#pragma unroll 4
      for (int d = 0; d < TD; ++d) {
        const float4 cv = *reinterpret_cast<const float4*>(Cs + d * TJ + tx * 4);
#pragma unroll
        for (int a = 0; a < MA; ++a) {
          if (ty + 16 * a < cs) {
            const float qv = qs[(ty + 16 * a) * XR + d];
            acc[a][0] = fmaf(qv, cv.x, acc[a][0]);
            acc[a][1] = fmaf(qv, cv.y, acc[a][1]);
            acc[a][2] = fmaf(qv, cv.z, acc[a][2]);
            acc[a][3] = fmaf(qv, cv.w, acc[a][3]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < MA; ++a) {
        const int t = ty + 16 * a;
        if (t < cs)
          *reinterpret_cast<float4*>(pc + (part * cs + t) * hd + j0 + tx * 4) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
    }
    if (first_col) {
      // q k^T and q . n0 over this tile's rows: rows ty + 16a, columns tx + 16b
      float acc[MA][MA] = {};
#pragma unroll 4
      for (int d = 0; d < TD; ++d) {
        float kv[MA];
#pragma unroll
        for (int b = 0; b < MA; ++b) kv[b] = tx + 16 * b < cs ? ks[(tx + 16 * b) * XR + d] : 0.f;
#pragma unroll
        for (int a = 0; a < MA; ++a) {
          if (ty + 16 * a < cs) {
            const float qv = qs[(ty + 16 * a) * XR + d];
#pragma unroll
            for (int b = 0; b < MA; ++b) acc[a][b] = fmaf(qv, kv[b], acc[a][b]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < MA; ++a)
#pragma unroll
        for (int b = 0; b < MA; ++b)
          if (ty + 16 * a < cs && tx + 16 * b < cs)
            ps[(part * cs + ty + 16 * a) * cs + tx + 16 * b] = acc[a][b];
      for (int t = tid; t < cs; t += THREADS) {
        float a = 0.f;
        for (int d = 0; d < TD; ++d) a = fmaf(qs[t * XR + d], ns[d], a);
        pn[part * cs + t] = a;
      }
    }
    __syncthreads();                      // C0 and n0 are read; now move them on
    const float decay0 = sc[1];
    {
      // C[d, j] = decay0 C0 + sum_s (round(w_end_s) k[s, d]) v[s, j]: thread
      // (ty, tx) owns rows ty*4 .. +4, columns tx*4 .. +4
      float u[4][4] = {};
#pragma unroll 4
      for (int s = 0; s < cs; ++s) {
        const float w = wend[s];
        const float4 kv = *reinterpret_cast<const float4*>(ks + s * XR + ty * 4);
        const float4 vv = *reinterpret_cast<const float4*>(vs + s * TJ + tx * 4);
        const float kw[4] = {w * kv.x, w * kv.y, w * kv.z, w * kv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          u[r][0] = fmaf(kw[r], vv.x, u[r][0]);
          u[r][1] = fmaf(kw[r], vv.y, u[r][1]);
          u[r][2] = fmaf(kw[r], vv.z, u[r][2]);
          u[r][3] = fmaf(kw[r], vv.w, u[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4* cp = reinterpret_cast<float4*>(Cs + (ty * 4 + r) * TJ + tx * 4);
        float4 cv = *cp;
        cv.x = decay0 * cv.x + u[r][0];
        cv.y = decay0 * cv.y + u[r][1];
        cv.z = decay0 * cv.z + u[r][2];
        cv.w = decay0 * cv.w + u[r][3];
        *cp = cv;
      }
    }
    if (first_col && tid < TD) {
      float a = 0.f;
      for (int s = 0; s < cs; ++s) a += wend[s] * ks[s * XR + tid];
      ns[tid] = decay0 * ns[tid] + a;
    }
    if (tid == 0) sc[0] = sc[2];          // m0 of the next chunk
  }
  __syncthreads();
  float* cl = cf + lane * hd * hd;
  for (int i = tid; i < TD * (TJ / 4); i += THREADS) {
    const int r = i / (TJ / 4), e = (i % (TJ / 4)) * 4;
    *reinterpret_cast<float4*>(cl + (size_t)(d0 + r) * hd + j0 + e) =
        *reinterpret_cast<const float4*>(Cs + r * TJ + e);
  }
  if (first_col) {
    for (int i = tid; i < TD; i += THREADS) nf[lane * hd + d0 + i] = ns[i];
    if (dt == 0 && tid == 0) mf[lane] = sc[0];
  }
}

__host__ __device__ inline int out_smem_floats(int cs) {
  return cs * (cs + 1) + cs * TJ + 8 * cs + 4;
}

// grid: (lanes, hd / TJ): h[:, j tile] of every chunk from the partials.
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_out_kernel(const T* __restrict__ v, const float* __restrict__ lf,
                 const float* __restrict__ li, const float* __restrict__ pc,
                 const float* __restrict__ ps, const float* __restrict__ pn, T* __restrict__ hs,
                 int S, int hd, int cs, int ndt, float sqrt_hd) {
  extern __shared__ __align__(16) float sm[];
  const size_t lane = blockIdx.x;
  const int j0 = blockIdx.y * TJ, tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int WR = cs + 1;
  float* vs = sm;                         // cs x TJ (first: float4 reads stay aligned)
  float* Ws = vs + cs * TJ;               // cs x WR: w
  float* lis = Ws + cs * WR;
  float* lfs = lis + cs;
  float* bsum = lfs + cs;
  float* mt = bsum + cs;
  float* ain = mt + cs;
  float* qn = ain + cs;
  float* den = qn + cs;
  float* sc = den + cs;
  if (tid == 0) sc[0] = NEG_INF_F;
  const T* vb = v + lane * S * hd;
  T* hb = hs + lane * S * hd;
  const int nch = S / cs;

  for (int c = 0; c < nch; ++c) {
    const int c0 = c * cs;
    __syncthreads();
    for (int i = tid; i < cs; i += THREADS) {
      lis[i] = li[lane * S + c0 + i];
      lfs[i] = lf[lane * S + c0 + i];
    }
    for (int p = tid; p < cs * (TJ / 8); p += THREADS) {
      const int t = p / (TJ / 8), e = (p % (TJ / 8)) * 8;
      Load8<T>::run(vb + (size_t)(c0 + t) * hd + j0 + e, vs + t * TJ + e);
    }
    __syncthreads();
    chunk_gates<T>(cs, lis, lfs, bsum, mt, ain, nullptr, sc);
    const size_t part0 = (lane * nch + c) * ndt;
    // w = (q k^T / sqrt(hd)) * D, masked to s <= t; q k^T summed over the d
    // tiles in order
    for (int o = tid; o < cs * cs; o += THREADS) {
      const int t = o / cs, s = o - t * cs;
      float w = 0.f;
      if (s <= t) {
        float a = 0.f;
        for (int dt = 0; dt < ndt; ++dt) a += ps[((part0 + dt) * cs + t) * cs + s];
        w = (a / sqrt_hd) * expf(lis[s] - bsum[s] + bsum[t] - mt[t]);
      }
      Ws[t * WR + s] = w;
    }
    for (int t = tid; t < cs; t += THREADS) {
      float a = 0.f;
      for (int dt = 0; dt < ndt; ++dt) a += pn[(part0 + dt) * cs + t];
      qn[t] = a;
    }
    __syncthreads();
    for (int t = tid; t < cs; t += THREADS) {
      float sum = 0.f;
      for (int s = 0; s < cs; ++s) sum += Ws[t * WR + s];
      den[t] = sum + ain[t] * qn[t] / sqrt_hd;
    }
    __syncthreads();
    // h: thread (ty, tx) owns rows ty + 16a, columns tx*4 .. +4
#pragma unroll
    for (int a = 0; a < MA; ++a) {
      const int t = ty + 16 * a;
      if (t >= cs) continue;
      float num[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s <= t; ++s) {
        const float w = rnd<T>(Ws[t * WR + s]);
        const float4 vv = *reinterpret_cast<const float4*>(vs + s * TJ + tx * 4);
        num[0] = fmaf(w, vv.x, num[0]);
        num[1] = fmaf(w, vv.y, num[1]);
        num[2] = fmaf(w, vv.z, num[2]);
        num[3] = fmaf(w, vv.w, num[3]);
      }
      float qc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int dt = 0; dt < ndt; ++dt) {
        const float4 p = *reinterpret_cast<const float4*>(
            pc + ((part0 + dt) * cs + t) * hd + j0 + tx * 4);
        qc[0] += p.x;
        qc[1] += p.y;
        qc[2] += p.z;
        qc[3] += p.w;
      }
      const float lim = fmaxf(fabsf(den[t]), expf(-mt[t]));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hb[(size_t)(c0 + t) * hd + j0 + tx * 4 + e] =
            Ty<T>::from_f((num[e] + ain[t] * qc[e] / sqrt_hd) / lim);
    }
    if (tid == 0) sc[0] = sc[2];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lf, const void* li,
           void* hs, void* cf, void* nf, void* mf, void* scratch, int lanes, int S, int hd,
           int cs, float sqrt_hd, cudaStream_t s) {
  const int ndt = hd / TD, nch = S / cs;
  float* pc = (float*)scratch;
  float* ps = pc + (size_t)lanes * nch * ndt * cs * hd;
  float* pn = ps + (size_t)lanes * nch * ndt * cs * cs;
  const int b1 = state_smem_floats(cs) * (int)sizeof(float);
  const int b2 = out_smem_floats(cs) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(mlstm_state_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, b1);
  if (e != cudaSuccess) return (int)e;
  mlstm_state_kernel<T><<<dim3(lanes, hd / TJ, ndt), THREADS, b1, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)lf, (const float*)li, pc, ps, pn,
      (float*)cf, (float*)nf, (float*)mf, S, hd, cs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mlstm_out_kernel<T><<<dim3(lanes, hd / TJ), THREADS, b2, s>>>(
      (const T*)v, (const float*)lf, (const float*)li, pc, ps, pn, (T*)hs, S, hd, cs, ndt,
      sqrt_hd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 elements of the partials buffer the wrapper allocates.
long long mlstm_chunkwise_scratch_elems(int lanes, int S, int hd, int cs) {
  if (cs < 1 || hd < TD) return 0;
  const long long parts = (long long)lanes * (S / cs) * (hd / TD) * cs;
  return parts * (hd + cs + 1);
}

// q, k, v (lanes,S,hd) in dt (0 = float32, 1 = bfloat16), lf, li (lanes,S)
// f32 -> hs (lanes,S,hd) in dt, cf (lanes,hd,hd), nf (lanes,hd), mf (lanes)
// f32; lanes = M*B*H; scratch of mlstm_chunkwise_scratch_elems f32.
// S % cs == 0, 1 <= cs <= 64, hd % 64 == 0.  Returns cudaGetLastError()
// after the two launches.
int mlstm_chunkwise(int dt, const void* q, const void* k, const void* v, const void* lf,
                    const void* li, void* hs, void* cf, void* nf, void* mf, void* scratch,
                    int lanes, int S, int hd, int cs, float sqrt_hd, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes < 1 || lanes > (1 << 30) || cs < 1 || cs > MAX_CS || S < cs || S % cs ||
      hd < TD || hd % TD || hd / TD > 65535)
    return (int)cudaErrorInvalidValue;
  if (dt == 0)
    return launch<float>(q, k, v, lf, li, hs, cf, nf, mf, scratch, lanes, S, hd, cs, sqrt_hd, s);
  if (dt == 1)
    return launch<__nv_bfloat16>(q, k, v, lf, li, hs, cf, nf, mf, scratch, lanes, S, hd, cs,
                                 sqrt_hd, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
