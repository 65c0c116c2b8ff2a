// Single-token GQA decode attention over a prefix-valid KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attn.py (_kernel,
// via decode_attention; decode_attention_sharded runs it on a rank's block):
// q (M,B,H,hd) attends over the first kv_len[m,b] slots of k/v
// (M,B,S,KVH,hd), f32 scores and softmax, f32 accumulation, output in q's
// dtype.  The hybrid family's global-attention layers run it in every
// decode step.
//
// Contract: 1 <= kv_len[m,b] <= S (the serving path appends the new token
// before it attends, kv_len = min(pos + 1, S)).  At kv_len = 0 the reference
// returns the mean of V over all S slots; this kernel is not defined there.
//
// What bounds it on this card: latency.  At hymba-1.5b's serve shape (16
// lanes, 25 / 5 heads, hd 64, S 1536, kv_len 144-672) it reads ~8.4 MB of
// K and V, 2.5 us at 3.35 TB/s, about one launch's latency; what is left
// is the length of the longest serial chain in a block and the number of
// launches.  The design:
//   * one launch.  A (lane, kv head)'s valid slots [0, kv_len) are split,
//     in whole 64-slot tiles, into contiguous ranges over a cluster of up to
//     8 CTAs (decode_attn.py's launch_plan: the split count is a function of
//     S, the ranges of kv_len, so a lane's result depends only on its own
//     q, k, v, kv_len and S, never on M, B or K); kv_len stays on the device.
//     Every CTA of a cluster works where kv_len allows; a CTA left without a
//     tile loads nothing, leaves an empty partial (m = -1e30, l = 0, acc =
//     0) and still takes part in every cluster barrier;
//   * the cluster merges its partials (m, l, acc) in distributed shared
//     memory: each CTA pushes its partial of every output to the CTA that
//     owns it, one cluster barrier, and each owner sums the splits in
//     order.  No HBM partials, no second launch, no atomics, so replays are
//     bit-identical;
//   * bf16: K and V tiles stay bf16 in shared memory, copied in 16-byte
//     cp.async pieces with the next tile in flight while the current one is
//     multiplied, one pass per tile with an online softmax (log2 units).
//     Warp w takes slots 16w .. 16w + 15 of every tile: q.K^T on tensor
//     cores (mma.sync m16n8k16, the kv head's G <= 16 query heads padded to
//     the 16 rows of one fragment, q's fragments loaded once), P.V with P
//     split into bf16 hi + lo (two products, the reference's f32 accuracy);
//     the four warps' partials merge in the CTA, then the CTAs' in the
//     cluster;
//   * f32: CUDA cores (TF32 would not hold 1e-4), the same split and merge,
//     32-slot tiles in the same cp.async double buffer (small enough that
//     five CTAs share an SM), an online softmax.
// Slots at or past kv_len are never loaded (their copies zero-fill) and get
// p = 0 exactly, so NaN there changes nothing.

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int TK = 64;           // slots per tile
constexpr int THREADS = 128;     // 4 warps
constexpr int NWARP = THREADS / 32;
constexpr int MAX_G = 16;        // query heads per kv head (one mma fragment's rows)
constexpr int MAX_HD = 128;
constexpr int MAX_SPLITS = 8;    // CTAs of a cluster (the portable limit)
constexpr float LOG2E = 1.4426950408889634f;

// first tile of split sp's range of the len valid slots' tiles
// (decode_attn.py's split_slots)
__device__ __forceinline__ int range_start(int sp, int len, int splits) {
  return (int)((long long)sp * ((len + TK - 1) / TK) / splits);
}

// items (4 outputs each) a CTA owns in the merge: i = slot * splits + rank
__host__ __device__ inline int merge_cap(int G, int hd, int splits) {
  return (G * hd / 4 + splits - 1) / splits;
}

template <typename T> struct Out4;
template <> struct Out4<float> {
  static __device__ __forceinline__ void store(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
};
template <> struct Out4<bf16> {
  static __device__ __forceinline__ void store(bf16* p, float a, float b, float c, float d) {
    uint2 u;
    u.x = pack2(a, b);
    u.y = pack2(c, d);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// out (G x hd, this kv head's q heads of the lane) from the partials of
// the cluster's `splits` CTAs: this CTA's in pacc (G x hd, unnormalised
// P.V) and pml (G x 2: max, sum), max in log2 units (LOG2) or natural.  Each
// CTA pushes the partial of output item i (4 outputs) into the recv buffer
// of the CTA that owns it (i % splits), as (m, l, acc) in its split's row;
// after one cluster barrier each owner merges its items, the splits in
// order.  The barrier that opens the kernel (arrived at its start) makes
// sure every CTA is running before the first push; after the second no CTA
// touches another's shared memory.
template <typename T, bool LOG2>
__device__ void cluster_merge(const float* pacc, const float* pml, float* recv, int G, int hd,
                              int splits, T* out) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), hq = hd / 4, items = G * hq;
  const int cap = merge_cap(G, hd, splits);
  __syncthreads();                          // the CTA's partial is complete
  cluster_wait();                           // every CTA of the cluster is running
  for (int i = threadIdx.x; i < items; i += THREADS) {
    const int g = i / hq, d = (i - g * hq) * 4;
    float* dst = cl.map_shared_rank(recv, i % splits) + ((size_t)rank * cap + i / splits) * 8;
    const float2 ml = *reinterpret_cast<const float2*>(pml + 2 * g);
    *reinterpret_cast<float4*>(dst) = make_float4(ml.x, ml.y, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + 4) = *reinterpret_cast<const float4*>(pacc + g * hd + d);
  }
  cluster_arrive();                         // pushed (release) ...
  cluster_wait();                           // ... and every push received (acquire)
  for (int slot = threadIdx.x; slot < cap; slot += THREADS) {
    const int i = slot * splits + rank;
    if (i >= items) break;
    const int g = i / hq, d = (i - g * hq) * 4;
    float4 e[MAX_SPLITS], x[MAX_SPLITS];
    float mx = NEG_INF_F;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) {
        e[r] = *reinterpret_cast<const float4*>(recv + ((size_t)r * cap + slot) * 8);
        x[r] = *reinterpret_cast<const float4*>(recv + ((size_t)r * cap + slot) * 8 + 4);
        mx = fmaxf(mx, e[r].x);
      }
    float l = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) {
        const float w = LOG2 ? exp2f(e[r].x - mx) : expf(e[r].x - mx);
        l += e[r].y * w;
        a0 += x[r].x * w;
        a1 += x[r].y * w;
        a2 += x[r].z * w;
        a3 += x[r].w * w;
      }
    const float inv = fmaxf(l, 1e-30f);
    Out4<T>::store(out + g * hd + d, a0 / inv, a1 / inv, a2 / inv, a3 / inv);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// grid (splits, KVH, lanes), clusters of `splits` along x.  Shared memory:
// q (16 rows), K and V (two buffers of TK rows each), bf16 rows of HDP
// (head_dim padded with zeros to 16, 32, 64 or 128) at a stride of HDP + 8
// (ldmatrix without bank conflicts); after the tiles, over K / V, the four
// warps' partials and the CTA's; then the merge's recv buffer.
__host__ __device__ inline int tc_smem_bytes(int hdp, int G, int hd, int splits) {
  return (16 + 4 * TK) * (hdp + 8) * 2 + (splits > 1 ? 32 * splits * merge_cap(G, hd, splits) : 0);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS)
decode_attn_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ kv_len, bf16* __restrict__ out,
               int S, int H, int KVH, int hd, float sqrt_hd, int splits) {
  constexpr int RS = HDP + 8;
  extern __shared__ __align__(16) bf16 tsm[];
  bf16* qs = tsm;                          // 16 x RS
  bf16* ks = qs + 16 * RS;                 // 2 x TK x RS
  bf16* vs = ks + 2 * TK * RS;             // 2 x TK x RS

  if (splits > 1) cluster_arrive();         // this CTA runs (the merge's first barrier)
  const int G = H / KVH, sp = blockIdx.x, kh = blockIdx.y;
  const size_t lane = blockIdx.z;
  const int len = min(kv_len[lane], S);
  const int ta = range_start(sp, len, splits), te = range_start(sp + 1, len, splits);
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31, g4 = ln >> 2, t4 = ln & 3;
  const int per = hd / 8;
  const size_t rs = (size_t)KVH * hd;      // slot stride
  const bf16* kl = k + lane * S * rs + (size_t)kh * hd;
  const bf16* vl = v + lane * S * rs + (size_t)kh * hd;
  const bf16* qh = q + (lane * H + (size_t)kh * G) * hd;
  bf16* oh = out + (lane * H + (size_t)kh * G) * hd;

  // zero the padded head dims [hd, HDP) of every row once: never copied into
  if (hd < HDP) {
    const int pc = (HDP - hd) / 8;
    for (int i = tid; i < (16 + 4 * TK) * pc; i += THREADS) {
      const int row = i / pc, c = i - row * pc;
      *reinterpret_cast<uint4*>(tsm + row * RS + hd + 8 * c) = make_uint4(0, 0, 0, 0);
    }
  }
  auto load_tile = [&](int buf, int t) {
    const int j0 = t * TK;
    for (int i = tid; i < TK * per; i += THREADS) {
      const int jj = i / per, d0 = (i - jj * per) * 8, j = j0 + jj;
      const bool ok = j < len;
      const size_t o = ok ? (size_t)j * rs + d0 : 0;
      const int so = (buf * TK + jj) * RS + d0;
      cp_async16(saddr(ks + so), kl + o, ok);
      cp_async16(saddr(vs + so), vl + o, ok);
    }
  };
  if (ta < te) {
    for (int i = tid; i < 16 * per; i += THREADS) {
      const int r = i / per, d0 = (i - r * per) * 8;
      const bool ok = r < G;
      cp_async16(saddr(qs + r * RS + d0), qh + (ok ? (size_t)r * hd + d0 : 0), ok);
    }
    load_tile(0, ta);
    cp_commit();
  }

  // rows g4 (o[n][0..1]) and g4 + 8 (o[n][2..3]); scores in log2 units
  const float sc = LOG2E / sqrt_hd;
  float m0 = NEG_INF_F, m1 = NEG_INF_F, l0 = 0.f, l1 = 0.f;
  float o[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  uint32_t qa[HDP / 16][4];
  int buf = 0;
  for (int t = ta; t < te; ++t) {
    if (t + 1 < te) {
      load_tile(buf ^ 1, t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                        // tile t (and q) in shared memory
    if (t == ta) {
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        ldsm4(qa[kk], saddr(qs + (ln & 15) * RS + kk * 16 + (ln >> 4) * 8));
    }
    const bf16* kb = ks + buf * TK * RS;
    const bf16* vb = vs + buf * TK * RS;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t b[4];
      ldsm4(b, saddr(kb + (warp * 16 + (ln >> 4) * 8 + (ln & 7)) * RS + kk * 16 +
                     ((ln >> 3) & 1) * 8));
      mma16816(s[0], qa[kk], b[0], b[1]);
      mma16816(s[1], qa[kk], b[2], b[3]);
    }
    // this thread's slots: j = jb + 8n + e (rows g4: s[n][e], g4 + 8: s[n][2 + e])
    const int jb = t * TK + warp * 16 + 2 * t4;
    bool ok[2][2];
    float mx0 = NEG_INF_F, mx1 = NEG_INF_F;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ok[n][e] = jb + 8 * n + e < len;
        s[n][e] = ok[n][e] ? s[n][e] * sc : NEG_INF_F;
        s[n][2 + e] = ok[n][e] ? s[n][2 + e] * sc : NEG_INF_F;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = ok[n][e] ? exp2f(s[n][e] - mn0) : 0.f;
        s[n][2 + e] = ok[n][e] ? exp2f(s[n][2 + e] - mn1) : 0.f;
        ps0 += s[n][e];
        ps1 += s[n][2 + e];
      }
    l0 = l0 * c0 + ps0;                     // this thread's share; the quad sums at the end
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }
    // P.V over the warp's 16 slots: P's A fragment from the score
    // fragments (hi, then the bf16 remainder lo), V's B by ldmatrix.trans
    uint32_t ph[4], pl[4];
    split2(s[0][0], s[0][1], ph[0], pl[0]);
    split2(s[0][2], s[0][3], ph[1], pl[1]);
    split2(s[1][0], s[1][1], ph[2], pl[2]);
    split2(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < HDP / 16; ++dp) {
      uint32_t b[4];
      ldsm4t(b, saddr(vb + (warp * 16 + (ln & 8) + (ln & 7)) * RS + dp * 16 + (ln >> 4) * 8));
      mma16816(o[2 * dp], ph, b[0], b[1]);
      mma16816(o[2 * dp + 1], ph, b[2], b[3]);
      mma16816(o[2 * dp], pl, b[0], b[1]);
      mma16816(o[2 * dp + 1], pl, b[2], b[3]);
    }
    __syncthreads();                        // every warp is done with buffer buf
    buf ^= 1;
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }

  // the warps' partials (rows < G) over K / V, then the CTA's behind them
  float* pw = reinterpret_cast<float*>(ks);          // NWARP x G x hd
  float* pwml = pw + NWARP * G * hd;                 // NWARP x G x 2
  float* pacc = pwml + 2 * NWARP * G;                // G x hd
  float* pml = pacc + G * hd;                        // G x 2
  __syncthreads();
  {
    const int rows[2] = {g4, g4 + 8};
    const float ms[2] = {m0, m1}, ls[2] = {l0, l1};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = rows[h2];
      if (r >= G) continue;
      float* dst = pw + (warp * G + r) * hd;
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        const int d = 8 * n + 2 * t4;
        if (d < hd)
          *reinterpret_cast<float2*>(dst + d) = make_float2(o[n][2 * h2], o[n][2 * h2 + 1]);
      }
      if (t4 == 0)
        *reinterpret_cast<float2*>(pwml + 2 * (warp * G + r)) = make_float2(ms[h2], ls[h2]);
    }
  }
  __syncthreads();
  // the CTA's partial: the warps merged in order (one split: the output)
  const int hq = hd / 4;
  for (int i = tid; i < G * hq; i += THREADS) {
    const int g = i / hq, d = (i - g * hq) * 4;
    float2 e[NWARP];
    float4 x[NWARP];
    float mx = NEG_INF_F;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      e[w] = *reinterpret_cast<const float2*>(pwml + 2 * (w * G + g));
      x[w] = *reinterpret_cast<const float4*>(pw + (w * G + g) * hd + d);
      mx = fmaxf(mx, e[w].x);
    }
    float l = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float c = exp2f(e[w].x - mx);
      l += e[w].y * c;
      a0 += x[w].x * c;
      a1 += x[w].y * c;
      a2 += x[w].z * c;
      a3 += x[w].w * c;
    }
    if (splits == 1) {
      const float inv = fmaxf(l, 1e-30f);
      Out4<bf16>::store(oh + g * hd + d, a0 / inv, a1 / inv, a2 / inv, a3 / inv);
    } else {
      *reinterpret_cast<float4*>(pacc + g * hd + d) = make_float4(a0, a1, a2, a3);
      if (d == 0) *reinterpret_cast<float2*>(pml + 2 * g) = make_float2(mx, l);
    }
  }
  if (splits > 1)
    cluster_merge<bf16, true>(pacc, pml, reinterpret_cast<float*>(tsm + (16 + 4 * TK) * RS), G,
                              hd, splits, oh);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int TF = 32;           // f32: slots per tile

__host__ __device__ inline int f32_smem_floats(int G, int hd, int splits) {
  return G * hd + 4 * TF * (hd + 4) + G * TF + 4 * G + G * hd + 4 * G +
         (splits > 1 ? 8 * splits * merge_cap(G, hd, splits) : 0);
}

// grid (splits, KVH, lanes), clusters of `splits` along x.  The range's
// 32-slot tiles arrive by 16-byte cp.async into two buffers, rows at a
// stride of hd + 4 floats (16-byte rows: a quarter-warp's float4 reads of 8
// rows hit distinct banks), the next tile in flight while the current one
// is used.  Per tile: scores (thread per slot and every fourth head, float4
// steps over d, each dot summed in d order), the rows' online softmax (a
// warp per head, a lane per slot), P.V (thread per head and 4 dims, slots
// in order).
__global__ void __launch_bounds__(THREADS)
decode_attn_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ kv_len,
                float* __restrict__ out, int S, int H, int KVH, int hd, float sqrt_hd,
                int splits) {
  constexpr int MAXP = MAX_G * MAX_HD / 4 / THREADS;   // float4 outputs per thread
  extern __shared__ __align__(16) float sm[];
  if (splits > 1) cluster_arrive();         // this CTA runs (the merge's first barrier)
  const int G = H / KVH, RSF = hd + 4, sp = blockIdx.x, kh = blockIdx.y;
  const size_t lane = blockIdx.z;
  const int len = min(kv_len[lane], S);
  // the 64-slot tiles [ta, te) of the valid prefix, in 32-slot tiles
  const int js = range_start(sp, len, splits) * TK;
  const int je = min(range_start(sp + 1, len, splits) * TK, len);
  const int t0 = js / TF, t1 = (je + TF - 1) / TF;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31, per = hd / 4;
  float* qs = sm;                          // G x hd
  float* ks = qs + G * hd;                 // 2 x TF x RSF
  float* vs = ks + 2 * TF * RSF;           // 2 x TF x RSF
  float* sc = vs + 2 * TF * RSF;           // G x TF: scores, then p
  float* st = sc + G * TF;                 // G running max, G sum, G rescale (4G)
  float* pacc = st + 4 * G;                // G x hd
  float* pml = pacc + G * hd;              // G x 2 (4G: recv stays 16-byte aligned)
  float* recv = pml + 4 * G;               // the merge's (splits > 1)

  const float* qh = q + (lane * H + (size_t)kh * G) * hd;
  float* oh = out + (lane * H + (size_t)kh * G) * hd;
  const size_t rs = (size_t)KVH * hd;
  const float* kl = k + lane * S * rs + (size_t)kh * hd;
  const float* vl = v + lane * S * rs + (size_t)kh * hd;
  auto load_tile = [&](int buf, int t) {
    for (int i = tid; i < TF * per; i += THREADS) {
      const int jj = i / per, d0 = (i - jj * per) * 4, j = t * TF + jj;
      const bool ok = j < je;
      const size_t o = ok ? (size_t)j * rs + d0 : 0;
      cp_async16(saddr(ks + (buf * TF + jj) * RSF + d0), kl + o, ok);
      cp_async16(saddr(vs + (buf * TF + jj) * RSF + d0), vl + o, ok);
    }
  };
  if (t0 < t1) {
    load_tile(0, t0);
    cp_commit();
  }
  for (int i = tid; i < G * per; i += THREADS)
    *reinterpret_cast<float4*>(qs + 4 * i) = *reinterpret_cast<const float4*>(qh + 4 * i);
  if (tid < G) {
    st[tid] = NEG_INF_F;
    st[G + tid] = 0.f;
  }
  float4 acc[MAXP];
#pragma unroll
  for (int r = 0; r < MAXP; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  int buf = 0;
  for (int t = t0; t < t1; ++t) {
    if (t + 1 < t1) {
      load_tile(buf ^ 1, t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                       // tile t (and q, the stats) in shared memory
    const float* kb = ks + buf * TF * RSF;
    const float* vb = vs + buf * TF * RSF;
    const int nk = min(TF, je - t * TF);
    {
      const int jj = tid % TF, hg = tid / TF;   // heads hg, hg + 4, ...
      if (jj < nk) {
        float dot[MAX_G / 4];
#pragma unroll
        for (int i = 0; i < MAX_G / 4; ++i) dot[i] = 0.f;
#pragma unroll 4
        for (int d = 0; d < hd; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kb + jj * RSF + d);
#pragma unroll
          for (int i = 0; i < MAX_G / 4; ++i) {
            if (hg + 4 * i < G) {
              const float4 q4 = *reinterpret_cast<const float4*>(qs + (hg + 4 * i) * hd + d);
              float a = fmaf(q4.x, k4.x, dot[i]);
              a = fmaf(q4.y, k4.y, a);
              a = fmaf(q4.z, k4.z, a);
              dot[i] = fmaf(q4.w, k4.w, a);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MAX_G / 4; ++i)
          if (hg + 4 * i < G) sc[(hg + 4 * i) * TF + jj] = dot[i] / sqrt_hd;   // as ref.py
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += NWARP) {
      const float s0 = wl < nk ? sc[g * TF + wl] : NEG_INF_F;
      const float mx = warp_max(s0);
      const float mo = st[g], mn = fmaxf(mo, mx), corr = expf(mo - mn);
      const float p = wl < nk ? expf(s0 - mn) : 0.f;
      if (wl < nk) sc[g * TF + wl] = p;
      const float l = warp_sum(p);
      if (wl == 0) {
        st[g] = mn;
        st[G + g] = st[G + g] * corr + l;
        st[2 * G + g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAXP; ++r) {
      const int i = tid + r * THREADS;
      if (i < G * per) {
        const int g = i / per, d = (i - g * per) * 4;
        const float c = st[2 * G + g];
        const float* p = sc + g * TF;
        float4 a = make_float4(acc[r].x * c, acc[r].y * c, acc[r].z * c, acc[r].w * c);
#pragma unroll 8
        for (int jj = 0; jj < nk; ++jj) {
          const float4 v4 = *reinterpret_cast<const float4*>(vb + jj * RSF + d);
          a.x = fmaf(p[jj], v4.x, a.x);
          a.y = fmaf(p[jj], v4.y, a.y);
          a.z = fmaf(p[jj], v4.z, a.z);
          a.w = fmaf(p[jj], v4.w, a.w);
        }
        acc[r] = a;
      }
    }
    __syncthreads();                       // every thread is done with buffer buf
    buf ^= 1;
  }
#pragma unroll
  for (int r = 0; r < MAXP; ++r) {
    const int i = tid + r * THREADS;
    if (i < G * per) {
      const int g = i / per, d = (i - g * per) * 4;
      if (splits == 1) {
        const float inv = fmaxf(st[G + g], 1e-30f);
        Out4<float>::store(oh + g * hd + d, acc[r].x / inv, acc[r].y / inv, acc[r].z / inv,
                           acc[r].w / inv);
      } else {
        *reinterpret_cast<float4*>(pacc + g * hd + d) = acc[r];
      }
    }
  }
  if (tid < G) *reinterpret_cast<float2*>(pml + 2 * tid) = make_float2(st[tid], st[G + tid]);
  if (splits > 1) cluster_merge<float, false>(pacc, pml, recv, G, hd, splits, oh);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// raise a kernel's dynamic shared-memory limit once per device
template <typename K>
cudaError_t allow_smem(K kern, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= 32) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  if (done & (1u << dev)) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done |= 1u << dev;
  return e;
}

template <typename K, typename... Args>
int launch_cluster(K kern, int smem, int splits, int KVH, int lanes, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KVH, lanes);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Nothing, on a grid and cluster shape: the latency floor of a launch of
// that shape (benchmarks hold the kernel against its device time).
__global__ void decode_attn_floor() {}

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, const int* kv_len, void* out,
              int lanes, int S, int H, int KVH, int hd, float sqrt_hd, int splits,
              cudaStream_t stream) {
  static unsigned done = 0;
  const int smem = tc_smem_bytes(HDP, H / KVH, hd, splits);
  const cudaError_t e =
      allow_smem(decode_attn_tc<HDP>, tc_smem_bytes(HDP, MAX_G, MAX_HD, MAX_SPLITS), done);
  if (e != cudaSuccess) return (int)e;
  return launch_cluster(decode_attn_tc<HDP>, smem, splits, KVH, lanes, stream,
                        (const bf16*)q, (const bf16*)k, (const bf16*)v, kv_len, (bf16*)out, S, H,
                        KVH, hd, sqrt_hd, splits);
}

}  // namespace

extern "C" {

// q (lanes,H,hd), k/v (lanes,S,KVH,hd), kv_len (lanes,) int32 -> out
// (lanes,H,hd); lanes = M*B.  dt: 0 = float32, 1 = bfloat16.  The tiles of
// each lane's valid prefix split over a cluster of `splits` CTAs (1 <=
// splits <= min(8, ceil(S / 64)), decode_attn.py's launch_plan).  One
// launch; returns its cudaError_t.
int decode_attention(int dt, const void* q, const void* k, const void* v, const void* kv_len,
                     void* out, int lanes, int S, int H, int KVH, int hd, float sqrt_hd,
                     int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes < 1 || lanes > 65535 || KVH < 1 || KVH > 65535 || H % KVH || H / KVH > MAX_G ||
      hd < 8 || hd > MAX_HD || hd % 8 || S < 1 || splits < 1 || splits > MAX_SPLITS ||
      splits > (S + TK - 1) / TK)
    return (int)cudaErrorInvalidValue;
  const int* lens = (const int*)kv_len;
  if (dt == 0) {
    static unsigned done = 0;
    const int smem = f32_smem_floats(H / KVH, hd, splits) * (int)sizeof(float);
    const cudaError_t e = allow_smem(
        decode_attn_f32, f32_smem_floats(MAX_G, MAX_HD, MAX_SPLITS) * (int)sizeof(float), done);
    if (e != cudaSuccess) return (int)e;
    return launch_cluster(decode_attn_f32, smem, splits, KVH, lanes, s, (const float*)q,
                          (const float*)k, (const float*)v, lens, (float*)out, S, H, KVH, hd,
                          sqrt_hd, splits);
  }
  if (dt != 1) return (int)cudaErrorInvalidValue;
  if (hd <= 16) return launch_tc<16>(q, k, v, lens, out, lanes, S, H, KVH, hd, sqrt_hd, splits, s);
  if (hd <= 32) return launch_tc<32>(q, k, v, lens, out, lanes, S, H, KVH, hd, sqrt_hd, splits, s);
  if (hd <= 64) return launch_tc<64>(q, k, v, lens, out, lanes, S, H, KVH, hd, sqrt_hd, splits, s);
  return launch_tc<128>(q, k, v, lens, out, lanes, S, H, KVH, hd, sqrt_hd, splits, s);
}

// The empty kernel on the grid (splits, KVH, lanes) in clusters of
// `splits`, as decode_attention launches: one launch, its cudaError_t.
int decode_attention_floor(int splits, int KVH, int lanes, void* stream) {
  if (splits < 1 || splits > MAX_SPLITS || KVH < 1 || KVH > 65535 || lanes < 1 || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_cluster(decode_attn_floor, 0, splits, KVH, lanes, (cudaStream_t)stream);
}

}  // extern "C"
