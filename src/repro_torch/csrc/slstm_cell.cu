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
// grid; a Hopper SM has 227 KB of shared memory and 256 KB of registers,
// and its blocks carry nothing between them.  The design:
//   * one thread-block cluster of CL CTAs owns one (instance, head) for all
//     S steps: CTA k owns hd/CL columns of each of the four gates for all B
//     lanes and keeps c/n/m of its columns on chip; each step it writes its
//     new h columns into the double-buffered h of every CTA of the cluster
//     through distributed shared memory, and one cluster barrier, split into
//     arrive and wait, ends the step;
//   * r stays on chip across the steps of a call, as far as it fits: each
//     consumer thread holds its fixed (rows, column quad) of the first rows
//     in registers, the next rows sit in shared memory, both loaded once per
//     call.  At xlstm-1.3b's prefill shape (f32 r, hd 512) a cluster of 16
//     CTAs (a non-portable size) holds a unit's 4 MB whole, 256 KB a CTA;
//     an H100 runs 7 such clusters at once, so 16 units take 3 waves, and
//     no row is re-read from L2 or HBM.  Where r does not fit, only the
//     remaining rows stream each step, through a ring of
//     shared-memory stages that one producer warp fills with TMA copies, a
//     box of the stage's rows of each gate's owned columns (a full and an
//     empty mbarrier per stage; bulk copies of each 256-byte row piece were
//     bound by the copy count, not the bytes).  The streamed copies carry
//     an L2 evict_last policy, so the streamed share (~27 MB over the grid
//     at xlstm-1.3b's prefill shape, f32 r) stays in the 50 MB L2 from one
//     step to the next; the last step's copies take evict_first.  r does
//     not depend on h, so the producer runs ahead into the next step's
//     stages while the consumers wait at the step's barrier;
//   * decode (S = 1) has no reuse: everything streams, through a ring of
//     two 32 KB stages, at the HBM rate, two CTAs to an SM;
//   * each thread sums its rows (k = kg, kg + KG, ...) in increasing k, and
//     the KG partials are added in a fixed order, whatever share of r is
//     resident: the result does not depend on the plan, and a call is
//     deterministic.
// The split of rows (registers / shared memory / streamed), the ring and
// the lanes per pass come from slstm_cell.py's launch_plan; the kernel
// checks them.
//
// The state is updated in place; `alive` (nullable, (M, B) bool) leaves the
// state of a dead lane untouched; `rows` (nullable, int32 per row of pre)
// names the instance of r each row reads.

#include "common.cuh"
#include "hopper.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 8;                    // consumer warps
constexpr int CONSUMERS = NW * 32;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int MAX_STAGES = 16;

template <typename R> struct RQuad;  // four neighbouring weights

template <> struct RQuad<float> {
  using raw = float4;
  static __device__ __forceinline__ raw ld_global(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ raw ld_shared(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float4 f(raw v) { return v; }
};

template <> struct RQuad<__nv_bfloat16> {
  using raw = uint2;
  static __device__ __forceinline__ raw ld_global(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ raw ld_shared(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  static __device__ __forceinline__ float4 f(raw u) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// Where r's rows of one call live: rows [0, kr) in registers (kr = KG * NRR),
// [kr, kr + ks) in shared memory, [kr + ks, hd) streamed each step in
// stages of sr rows through a ring of `stages` stages; cl CTAs (8, or 16
// in a non-portable cluster) share one (row, head).
struct Plan {
  int kr, ks, sr, stages, cl;
};

__host__ __device__ inline size_t round128(size_t b) { return (b + 127) / 128 * 128; }

// Dynamic shared memory of a launch, in the order of the carve below.
__host__ __device__ inline size_t smem_bytes(int B, int hd, int rsz, int LT, const Plan& p) {
  const int CW = hd / p.cl, KG = CONSUMERS / CW, ROWB = 4 * CW * rsz;
  return 128                                          // alignment slack
         + round128(16 * (size_t)p.stages)             // full / empty mbarriers
         + round128((size_t)p.stages * p.sr * ROWB)   // the ring
         + round128((size_t)p.ks * ROWB)              // resident rows
         + round128(2 * (size_t)B * hd * 4)           // h, double-buffered
         + round128((size_t)KG * LT * 4 * CW * 4)     // the KG partials of a lane pass
         + 3 * (size_t)B * CW * 4;                    // c, n, m of the owned columns
}

// acc[bb][i] += h[b0 + bb][k] * w.i for the LT lanes of this pass
template <int LT>
__device__ __forceinline__ void fma_row(float (&acc)[LT][4], float4 w, const float* hc, int b0,
                                        int nb, int hd, int k) {
#pragma unroll
  for (int bb = 0; bb < LT; ++bb) {
    const float hv = (LT == 1 || bb < nb) ? hc[(b0 + bb) * hd + k] : 0.f;
    acc[bb][0] += hv * w.x;
    acc[bb][1] += hv * w.y;
    acc[bb][2] += hv * w.z;
    acc[bb][3] += hv * w.w;
  }
}

// grid: M * H clusters of CL CTAs; blockIdx.x / CL = m * H + head.  The
// cluster dimension comes with the launch (16 is beyond the portable 8).
// Threads 0 .. CONSUMERS-1 compute; the last warp is the ring's producer.
// Without register rows a CTA fits in half an SM (decode's plan), so the
// 16 clusters of a serve shape are all resident at once; with them, one
// CTA fills an SM, and an H100 holds 15 clusters of 8 such CTAs, 7 of 16.
template <typename T, typename R, int NRR, int LT, int CL>
__global__ void __launch_bounds__(THREADS, NRR > 0 ? 1 : 2)
    slstm_kernel(const __grid_constant__ CUtensorMap rmap, const T* __restrict__ pre,
                 const R* __restrict__ r, const int* __restrict__ rows, float* c, float* n, T* h,
                 float* mst, const bool* __restrict__ alive, T* __restrict__ hs, int B, int S,
                 int H, int hd, Plan p) {
  using Q = RQuad<R>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int unit = blockIdx.x / CL;
  const int mi = unit / H, head = unit - mi * H;
  const int rm = rows != nullptr ? rows[mi] : mi;   // the instance of r this row reads
  const int D = H * hd;
  const int CW = hd / CL;          // columns of each gate owned by this CTA
  const int c0 = rank * CW;        // first owned column within the head
  const int NQ = CW;               // float4 column quads over the four gates
  const int KG = CONSUMERS / NQ;   // thread groups splitting the k reduction
  const int ROWE = 4 * CW;         // elements of one row of this CTA's slice
  const int ROWB = ROWE * (int)sizeof(R);
  const int tid = threadIdx.x;
  const int ntiles = (B + LT - 1) / LT;
  const int k_stream = p.kr + p.ks;
  const int nst = k_stream < hd ? (hd - k_stream + p.sr - 1) / p.sr : 0;   // stages per pass
  const size_t gate_stride = (size_t)H * hd * hd;               // r[m, g + 1] - r[m, g]
  const R* runit = r + ((size_t)rm * 4 * H + head) * hd * hd + c0;   // gate 0, row 0

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sp = reinterpret_cast<unsigned char*>(((uintptr_t)smem_raw + 127) & ~(uintptr_t)127);
  const uint32_t bars = smem_addr(sp);
  sp += round128(16 * (size_t)p.stages);
  unsigned char* ring = sp;
  sp += round128((size_t)p.stages * p.sr * ROWB);
  const R* res = reinterpret_cast<const R*>(sp);
  sp += round128((size_t)p.ks * ROWB);
  float* hbuf = reinterpret_cast<float*>(sp);
  sp += round128(2 * (size_t)B * hd * 4);
  float* part = reinterpret_cast<float*>(sp);
  sp += round128((size_t)KG * LT * 4 * CW * 4);
  float* cs = reinterpret_cast<float*>(sp);
  float* ns = cs + B * CW;
  float* ms = ns + B * CW;
  auto full = [&](int i) { return bars + 8 * (i % p.stages); };
  auto empty = [&](int i) { return bars + 8 * (p.stages + i % p.stages); };

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Cluster barrier phases: 0 when every CTA has started and holds its
  // initial state (its shared memory may be written by its peers), t + 1
  // when h_t is complete in every CTA and no CTA still reads h_{t-1}.
  if (tid >= CONSUMERS) {
    // ---- the producer warp: the streamed rows, pass after pass ----
    const int lane = tid & 31;
    cluster_arrive();  // phase 0: before the first copy, so a full ring never blocks it
    const uint64_t keep = policy_evict_last(), once = policy_evict_first();
    int g = 0;
    for (int t = 0; t < S; ++t) {
      const uint64_t pol = t + 1 < S ? keep : once;
      for (int tile = 0; tile < ntiles; ++tile) {
        for (int st = 0; st < nst; ++st, ++g) {
          if (lane != 0) continue;
          // a box of sr rows x CW columns per gate: [gate][row][column] in
          // the stage; rows past hd are zero-filled and still counted
          const int k0 = k_stream + st * p.sr;
          if (g >= p.stages) mbar_wait(empty(g), (g / p.stages - 1) & 1);
          mbar_expect(full(g), p.sr * ROWB);
          const uint32_t dst = smem_addr(ring) + (g % p.stages) * p.sr * ROWB;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            tma3_hint(dst + gate * p.sr * CW * (int)sizeof(R), &rmap, c0, k0,
                      (rm * 4 + gate) * H + head, full(g), pol);
        }
        __syncwarp();
      }
      // phase t + 1 once step t's copies are out: its wait for phase t
      // comes first (arrive and wait alternate) and never blocks long, as
      // the consumers had to pass phase t to free this step's stages
      cluster_wait();
      cluster_arrive();
    }
    cluster_wait();
    return;
  }

  // ---- consumers: the initial state, the resident rows ----
  const size_t row0 = (size_t)mi * B;           // (m, b) row of lane 0
  const size_t col = (size_t)head * hd;         // first column of the head in D
  for (int e = tid; e < B * hd; e += CONSUMERS) {
    const int b = e / hd, k = e - b * hd;
    hbuf[e] = Ty<T>::to_f(h[(row0 + b) * D + col + k]);
  }
  for (int e = tid; e < B * CW; e += CONSUMERS) {
    const int b = e / CW, j = e - b * CW;
    const size_t gi = (row0 + b) * D + col + c0 + j;
    cs[e] = c[gi];
    ns[e] = n[gi];
    ms[e] = mst[gi];
  }
  // shared-memory rows [kr, kr + ks): (row, gate) pieces of CW elements
  {
    R* dst = const_cast<R*>(res);
    if ((CW * sizeof(R)) % 16 == 0) {
      const int per = CW * (int)sizeof(R) / 16;    // 16-byte chunks per piece
      const int total = p.ks * 4 * per;
#pragma unroll 4
      for (int e = tid; e < total; e += CONSUMERS) {
        const int piece = e / per, ch = e - piece * per;
        const int rr = piece >> 2, gate = piece & 3;
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                            runit + gate * gate_stride + (size_t)(p.kr + rr) * hd) + ch);
        reinterpret_cast<uint4*>(dst + rr * ROWE + gate * CW)[ch] = v;
      }
    } else {
      for (int e = tid; e < p.ks * ROWE; e += CONSUMERS) {
        const int rr = e / ROWE, q = e - rr * ROWE, gate = q / CW, j = q - gate * CW;
        dst[e] = runit[gate * gate_stride + (size_t)(p.kr + rr) * hd + j];
      }
    }
  }

  // this thread's quad: gate gq, columns c0 + jq .. c0 + jq + 3; rows kg, kg + KG, ...
  const int q = tid % NQ, kg = tid / NQ;
  const bool active = kg < KG;
  const int gq = q / (CW / 4), jq = (q - gq * (CW / 4)) * 4;
  const R* rq = runit + gq * gate_stride + jq;
  typename Q::raw rr[NRR > 0 ? NRR : 1];
  if (NRR > 0 && active) {
#pragma unroll
    for (int i = 0; i < NRR; ++i) rr[i] = Q::ld_global(rq + (size_t)(kg + KG * i) * hd);
  }
  cluster_arrive();    // phase 0
  cluster_wait();

  const int lane = tid & 31;
  int g = 0, cur = 0;
  for (int t = 0; t < S; ++t) {
    const float* hc = hbuf + cur * B * hd;
    float* hn = hbuf + (cur ^ 1) * B * hd;
    for (int b0 = 0; b0 < B; b0 += LT) {
      const int nb = min(LT, B - b0);
      // this thread's first epilogue element: its gate inputs in flight
      // while the recurrent product runs
      float pz = 0.f, pi = 0.f, pf = 0.f, po = 0.f;
      if (tid < nb * CW) {
        const int bb = tid / CW, j = tid - bb * CW;
        const T* pt = pre + ((row0 + b0 + bb) * S + t) * 4 * (size_t)D + col + c0 + j;
        pz = Ty<T>::to_f(pt[0]);
        pi = Ty<T>::to_f(pt[D]);
        pf = Ty<T>::to_f(pt[2 * D]);
        po = Ty<T>::to_f(pt[3 * D]);
      }
      float acc[LT][4];
#pragma unroll
      for (int bb = 0; bb < LT; ++bb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[bb][i] = 0.f;
      if (active) {
        if (NRR > 0) {
#pragma unroll
          for (int i = 0; i < NRR; ++i) fma_row<LT>(acc, Q::f(rr[i]), hc, b0, nb, hd, kg + KG * i);
        }
#pragma unroll 4
        for (int k = p.kr + kg; k < k_stream; k += KG)
          fma_row<LT>(acc, Q::f(Q::ld_shared(res + (k - p.kr) * ROWE + q * 4)), hc, b0, nb, hd, k);
      }
      for (int st = 0; st < nst; ++st, ++g) {
        const int k0 = k_stream + st * p.sr, nr = min(p.sr, hd - k0);
        mbar_wait(full(g), (g / p.stages) & 1);
        if (active) {
          const R* stage = reinterpret_cast<const R*>(ring + (g % p.stages) * p.sr * ROWB) +
                           gq * p.sr * CW + jq;
          const int first = ((kg - k0 % KG) % KG + KG) % KG;
#pragma unroll 4
          for (int k = first; k < nr; k += KG)
            fma_row<LT>(acc, Q::f(Q::ld_shared(stage + k * CW)), hc, b0, nb, hd, k0 + k);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(g));
      }
      if (active) {
#pragma unroll
        for (int bb = 0; bb < LT; ++bb)
          *reinterpret_cast<float4*>(part + (kg * LT + bb) * 4 * CW + q * 4) =
              make_float4(acc[bb][0], acc[bb][1], acc[bb][2], acc[bb][3]);
      }
      consumers_sync();
      for (int e = tid; e < nb * CW; e += CONSUMERS) {
        const int bb = e / CW, j = e - bb * CW, b = b0 + bb;
        float rec[4];
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) {
          float sum = 0.f;
          for (int kk = 0; kk < KG; ++kk) sum += part[(kk * LT + bb) * 4 * CW + gg * CW + j];
          rec[gg] = sum;
        }
        if (e != tid) {
          const T* pt = pre + ((row0 + b) * S + t) * 4 * (size_t)D + col + c0 + j;
          pz = Ty<T>::to_f(pt[0]);
          pi = Ty<T>::to_f(pt[D]);
          pf = Ty<T>::to_f(pt[2 * D]);
          po = Ty<T>::to_f(pt[3 * D]);
        }
        const float zt = pz + rec[0];
        const float it = pi + rec[1];
        const float ft = pf + rec[2];
        const float ot = po + rec[3];
        const int si = b * CW + j;
        const float lf = log_sigmoid(ft);
        const float mp = ms[si];
        const float mt = fmaxf(lf + mp, it);
        const float fp = expf(lf + mp - mt);
        const float ip = expf(it - mt);
        const float cn = fp * cs[si] + ip * tanhf(zt);
        const float nn = fp * ns[si] + ip;
        const float hv = rnd<T>(sigmoid(ot) * cn / fmaxf(nn, 1e-6f));
        for (int pr = 0; pr < CL; ++pr) cluster.map_shared_rank(hn, pr)[b * hd + c0 + j] = hv;
        cs[si] = cn;
        ns[si] = nn;
        ms[si] = mt;
        hs[((row0 + b) * S + t) * (size_t)D + col + c0 + j] = Ty<T>::from_f(hv);
      }
      consumers_sync();  // the partials are reused by the next lane pass
    }
    cluster_arrive();    // phase t + 1: this thread's h_t writes are out
    cluster_wait();
    cur ^= 1;
  }

  for (int e = tid; e < B * CW; e += CONSUMERS) {
    const int b = e / CW, j = e - b * CW;
    if (alive != nullptr && !alive[row0 + b]) continue;
    const size_t gi = (row0 + b) * D + col + c0 + j;
    c[gi] = cs[e];
    n[gi] = ns[e];
    mst[gi] = ms[e];
    h[gi] = Ty<T>::from_f(hbuf[cur * B * hd + b * hd + c0 + j]);
  }
}

// Register rows per thread: at CL = 8, 28 float4 quads (f32, 112
// registers) or 48 bf16 quads (96): a block of 9 warps puts 3 on some SM
// sub-partition, so a thread has at most 168 registers, and the rest of
// the kernel needs ~50.  At CL = 16 a CTA's slice is half as wide: 16 f32
// quads or 24 bf16 (64 and 48 registers) leave the rest to shared memory.
template <typename R, int CL> constexpr int nrr_max() {
  return CL == 16 ? (sizeof(R) == 4 ? 16 : 24) : (sizeof(R) == 4 ? 28 : 48);
}

// The plan's checks: the rows partition [0, hd); register rows need a
// whole number of thread groups; streamed pieces are 16-byte bulk copies.
bool plan_ok(int B, int hd, int rsz, int nrr, int LT, const Plan& p, size_t* smem) {
  if (p.cl != 8 && p.cl != 16) return false;
  const int CW = hd / p.cl, KG = CONSUMERS / CW;
  if (hd % (4 * p.cl) || CW > CONSUMERS || B < 1) return false;
  if (p.kr < 0 || p.ks < 0 || p.kr + p.ks > hd || p.stages < 1 || p.stages > MAX_STAGES)
    return false;
  if (nrr > 0 && (CONSUMERS % CW || p.kr != KG * nrr)) return false;
  if (nrr == 0 && p.kr != 0) return false;
  // streamed boxes: rows in 16-byte pieces, each gate's box 128-byte aligned
  if (p.kr + p.ks < hd && (p.sr < 1 || p.sr > 256 || (CW * rsz) % 16 || (p.sr * CW * rsz) % 128))
    return false;
  if (LT != 1 && LT != 4) return false;
  *smem = smem_bytes(B, hd, rsz, LT, p);
  return *smem <= (size_t)MAX_SMEM;
}

// The launch configuration of a grid of `units` clusters of CL CTAs, the
// kernel's attributes raised once per device (`allowed`: the shared
// memory each device's limit allows so far, per instantiation).
template <typename K>
cudaError_t cluster_config(K kern, int CL, int units, size_t smem, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, size_t* allowed) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && allowed[dev & 15] < smem) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e == cudaSuccess && CL > 8)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) allowed[dev & 15] = MAX_SMEM;
  }
  if (e != cudaSuccess) return e;
  *cfg = {};
  cfg->gridDim = dim3(units * CL);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename T, typename R, int NRR, int LT, int CL>
int launch_t(const CUtensorMap& rmap, const void* pre, const void* r, const void* rows, void* c,
             void* n, void* h, void* m, const void* alive, void* hs, int M, int B, int S, int H,
             int hd, const Plan& p, size_t smem, cudaStream_t stream) {
  auto kern = slstm_kernel<T, R, NRR, LT, CL>;
  static size_t allowed[16] = {};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config(kern, CL, M * H, smem, stream, &cfg, attr, allowed);
  if (e == cudaSuccess)
    e = cudaLaunchKernelEx(&cfg, kern, rmap, (const T*)pre, (const R*)r, (const int*)rows,
                           (float*)c, (float*)n, (T*)h, (float*)m, (const bool*)alive, (T*)hs, B,
                           S, H, hd, p);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, typename R>
int launch(const void* rmap_host, const void* pre, const void* r, const void* rows, void* c,
           void* n, void* h, void* m, const void* alive, void* hs, int M, int B, int S, int H,
           int hd, int nrr, int LT, const Plan& p, cudaStream_t stream) {
  size_t smem = 0;
  const bool streams = p.kr + p.ks < hd;
  // the instantiations: CL = 8 with no register rows or the most, CL = 16
  // (prefill, r whole on chip) with the most
  const bool known = p.cl == 8 ? (nrr == 0 || nrr == nrr_max<R, 8>()) : nrr == nrr_max<R, 16>();
  if (S < 1 || M < 1 || !known || !plan_ok(B, hd, sizeof(R), nrr, LT, p, &smem) ||
      (streams && rmap_host == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap rmap;
  memset(&rmap, 0, sizeof(rmap));
  if (streams) memcpy(&rmap, rmap_host, sizeof(rmap));
#define SL(NRR_, LT_, CL_)                                                                       \
  launch_t<T, R, NRR_, LT_, CL_>(rmap, pre, r, rows, c, n, h, m, alive, hs, M, B, S, H, hd, p, \
                                 smem, stream)
  if (p.cl == 16) return LT == 1 ? SL((nrr_max<R, 16>()), 1, 16) : SL((nrr_max<R, 16>()), 4, 16);
  if (nrr == 0) return LT == 1 ? SL(0, 1, 8) : SL(0, 4, 8);
  return LT == 1 ? SL((nrr_max<R, 8>()), 1, 8) : SL((nrr_max<R, 8>()), 4, 8);
#undef SL
}

template <typename T, typename R, int NRR, int LT, int CL>
int clusters_t(size_t smem) {
  auto kern = slstm_kernel<T, R, NRR, LT, CL>;
  size_t allowed[16] = {};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config(kern, CL, 1, smem, nullptr, &cfg, attr, allowed);
  int count = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&count, kern, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

}  // namespace

extern "C" {

// rmap: r's tensor map as (M_r*4*H, hd, hd), boxes of (1, sr, hd/cl), dense
// (tensor_map_encode; 128 bytes on the host), null where no row streams.
// pre (M,B,S,4,D) dt; r (M_r,4,H,hd,hd) rdt; rows (M) int32 or null: row m
// reads r[rows[m]] (else r[m]); c/n/m (M,B,D) f32 and h (M,B,D) dt, updated
// in place; alive (M,B) bool or null; hs (M,B,S,D) dt.  dt, rdt: 0 =
// float32, 1 = bfloat16.  cl (8 or 16 CTAs per cluster), nrr (register rows
// per thread: at cl 8, 0 or 28 f32 / 48 bf16; at cl 16, 16 f32 / 24 bf16),
// kr = CONSUMERS / (hd / cl) * nrr, ks, sr, stages and lt (1 or 4 lanes per
// pass) are slstm_cell.py's launch_plan.
int slstm_cell(int dt, int rdt, const void* rmap, const void* pre, const void* r, const void* rows,
               void* c, void* n, void* h, void* m, const void* alive, void* hs, int M, int B,
               int S, int H, int hd, int cl, int nrr, int kr, int ks, int sr, int stages, int lt,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Plan p{kr, ks, sr, stages, cl};
#define LA(T, R) \
  launch<T, R>(rmap, pre, r, rows, c, n, h, m, alive, hs, M, B, S, H, hd, nrr, lt, p, s)
  if (dt == 0 && rdt == 0) return LA(float, float);
  if (dt == 0 && rdt == 1) return LA(float, __nv_bfloat16);
  if (dt == 1 && rdt == 0) return LA(__nv_bfloat16, float);
  if (dt == 1 && rdt == 1) return LA(__nv_bfloat16, __nv_bfloat16);
#undef LA
  return (int)cudaErrorInvalidValue;
}

// How many clusters of the kernel a plan launches can be resident at once
// (cudaOccupancyMaxActiveClusters); negative: the CUDA error.
int slstm_cell_max_clusters(int dt, int rdt, int B, int hd, int cl, int nrr, int lt, int kr,
                            int ks, int sr, int stages) {
  size_t smem = 0;
  const int rsz = rdt == 0 ? 4 : 2;
  if (!plan_ok(B, hd, rsz, nrr, lt, Plan{kr, ks, sr, stages, cl}, &smem)) return -1;
#define MC(T, R)                                                                          \
  (cl == 16 ? (lt == 1 ? clusters_t<T, R, nrr_max<R, 16>(), 1, 16>(smem)                  \
                       : clusters_t<T, R, nrr_max<R, 16>(), 4, 16>(smem))                 \
   : nrr == 0 ? (lt == 1 ? clusters_t<T, R, 0, 1, 8>(smem) : clusters_t<T, R, 0, 4, 8>(smem)) \
              : (lt == 1 ? clusters_t<T, R, nrr_max<R, 8>(), 1, 8>(smem)                  \
                         : clusters_t<T, R, nrr_max<R, 8>(), 4, 8>(smem)))
  if (dt == 0 && rdt == 0) return MC(float, float);
  if (dt == 0 && rdt == 1) return MC(float, __nv_bfloat16);
  if (dt == 1 && rdt == 0) return MC(__nv_bfloat16, float);
  return MC(__nv_bfloat16, __nv_bfloat16);
#undef MC
}

int tensor_map_encode(void* out, const void* base, int dt, int n0, int n1, int n2, int b0, int b1,
                      int swizzle) {
  return (int)encode_map(out, base, dt, n0, n1, n2, b0, b1, swizzle);
}

}  // extern "C"
