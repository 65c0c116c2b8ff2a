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
// What bounds it on this card: bytes, the f32 write of the final C (M B H
// hd^2 x 4: 268 MB of the ~285 MB at the xlstm-1.3b profiler shape, 64
// lanes at hd 1024).  The products, ~4 cs hd^2 FLOP per chunk and lane,
// take a few microseconds on tensor cores; what costs time beyond the
// write is latency: serial steps inside a block, and work that every block
// of a lane repeats.  Two launches (mlstm_chunk.py's launch_plan sizes both):
//   * pass 1, once per (lane, chunk), a cluster splitting hd: w and its row
//     sums, the gates (a_inter, round(w_end), mt, decay0) and m.  w needs
//     q k^T over all hd, which no state term touches, so it is computed
//     once here and not by every strip of pass 2 (with 64-column strips at
//     cs 64 that recompute would cost as much as the state products).  The
//     m0 of a chunk is the gates' own recurrence over the chunks before it,
//     which each block replays from lf and li (a warp per chunk).  A (lane,
//     chunk) leaves cs^2 + 4 cs floats: no partial sum of q C0 or of the
//     state ever reaches memory;
//   * pass 2, the state: a CTA owns a block of 128 rows (64 where hd is not
//     a multiple of 128) by 64 columns of C, held in registers (36 floats a
//     thread) with n as one more column: v gets a column of ones, so C's
//     update also moves n on, and q C0 also yields q . n0.  Several chunks:
//     the cluster of hd / rows CTAs of a strip walks the chunks in order,
//     the block in registers from the first to the last; per chunk k, v
//     (and q) arrive by cp.async, q C0 runs over the block's rows (C0
//     staged through shared memory), then C's update; the cluster's q C0
//     partials meet over distributed shared memory in a fixed order, and
//     each CTA writes h's rows of its share for its columns.  One chunk (S
//     = cs): nothing crosses CTAs; a CTA loads its block's rows of k and the
//     record once and walks its strips, the next strip of v in flight while
//     the current one is multiplied and written;
//   * zero state is zero: in the first chunk C0 = 0, n0 = 0 and m0 = -1e30,
//     so q C0, q . n0 and the decay are dropped, which is exact (a_inter 0 =
//     0, decay0 0 = 0);
//   * bf16 inputs: tensor cores, mma.sync m16n8k16 with f32 sums.  q k^T and
//     round(w) v are single bf16 passes (bf16 x bf16 products are exact in
//     f32).  round(w_end) k, a product of two bf16 values, has at most a
//     16-bit significand: its bf16 hi + lo split is exact, two passes
//     reproduce it.  C0 (f32) splits into bf16 hi + lo, two passes: each
//     term of q C0 within 2^-17 of the f32 product;
//   * f32 inputs: CUDA-core FMAs (TF32 would not hold 1e-4) on register
//     tiles of 4 rows x 8 columns (the update) and 2 rows x 8 columns (q C0)
//     fed by float4 loads; q arrives after the update, over k's buffer, so
//     two CTAs share an SM;
//   * C is written from the registers with streaming (evict-first) stores.
// Gate-neutral padded steps (li = -1e30, lf = 0) get w_end = 0 and D = 0
// exactly, so whatever q, k, v they hold adds +-0.  cs <= 128; hd a multiple
// of 64, at most 8 blocks of rows.

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma_sync.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;     // 8 warps
constexpr int NW = THREADS / 32;
constexpr int MAX_CS = 128;
constexpr int MAX_CLUSTER = 8;
constexpr int STRIP = 64;        // pass 2: columns of C a CTA owns
constexpr int NFS = STRIP / 8;   // their n-fragments; fragment NFS holds n's column
constexpr int XS = STRIP + 8;    // pass 2: row of the q C0 partials (the strip, q . n0)
constexpr int CS0 = STRIP + 12;  // pass 2: row of C0 in shared memory (f32)
constexpr int CHAIN = 256;       // pass 1: earlier chunks whose ends one round reads

// Pass 1's piece rows, the row padding of q / k tiles and of v's rows (the
// strip and n's 8 columns) per dtype: bf16 rows of odd multiples of 16
// bytes (ldmatrix without bank conflicts).
template <typename T> struct Cfg;
template <> struct Cfg<bf16> { static constexpr int DP = 64, PAD = 8, VS = STRIP + 24; };
template <> struct Cfg<float> { static constexpr int DP = 32, PAD = 4, VS = STRIP + 12; };

__host__ __device__ inline int pad16(int cs) { return (cs + 15) / 16 * 16; }

// The record pass 1 leaves for a (lane, chunk), in floats: round(w) in
// csp x csp floats' room, then w's row sums, a_inter, round(w_end) and mt
// (csp each), then decay0 and three spare.  round(w) is kept as pass 2's
// round(w) v reads it: f32 rows; bf16 in mma A-fragment order, so a lane's
// fragment of a (t-tile, 16 steps) is one 16-byte load (w_index).
__host__ __device__ inline int rec_floats(int csp) { return csp * csp + 4 * csp + 4; }

// Where w[t][s] goes in a bf16 record (elements): fragment (t / 16, s / 16)
// of the 32 lanes' 4 registers of 2 halves, a0 = (g, 2q), a1 = (g + 8, 2q),
// a2 = (g, 2q + 8), a3 = (g + 8, 2q + 8) at lane 4 g + q.
__device__ __forceinline__ int w_index(int t, int s, int csp) {
  const int r = t & 15, cc = s & 15;
  const int ln = (r & 7) * 4 + ((cc & 7) >> 1), reg = (r >> 3) + 2 * (cc >> 3);
  return ((((t >> 4) * (csp >> 4) + (s >> 4)) * 32 + ln) * 4 + reg) * 2 + (cc & 1);
}

// Shared memory of the two passes (mlstm_chunk.py's smem_bytes is the same
// sum).  Pass 1: q / k pieces (two buffers; w over them afterwards), the
// warps' q k^T partials, the gates, the ends of earlier chunks.  Pass 2
// with one chunk: k's block, two buffers of v's strip with n's columns,
// the record's round(w), the gate vectors; with
// several: bf16 q (and the q C0 partials over it), k, v, C0 as hi and lo;
// f32 k (then q), v, C0 (and the partials over it); the same vectors.
__host__ __device__ inline int smem_pass1(int esz, int cs) {
  const int csp = pad16(cs), dp = esz == 2 ? 64 : 32, pad = esz == 2 ? 8 : 4;
  const int ks = NW / (csp / 16);
  return 4 * csp * (dp + pad) * esz + 4 * ks * csp * csp + 4 * (5 * csp + 2 * CHAIN + 4);
}
__host__ __device__ inline int smem_pass2(int esz, int cs, int rows, int P, bool resident) {
  const int csp = pad16(cs), pad = esz == 2 ? 8 : 4, vs = esz == 2 ? STRIP + 24 : STRIP + 12;
  const int kq = csp * (rows + pad) * esz, qcx = 4 * csp * XS;
  const int wsm = csp * csp * esz, vec = 4 * (5 * csp + 4);
  if (!resident) return kq + 2 * csp * vs * esz + wsm + vec;
  if (esz == 2) return (kq > qcx ? kq : qcx) + kq + csp * vs * 2 + 4 * rows * vs + wsm + vec;
  const int qt = 4 * rows * (csp + 2);
  return (kq > qt ? kq : qt) + csp * vs * 4 + (4 * rows * CS0 > qcx ? 4 * rows * CS0 : qcx) +
         wsm + vec;
}

template <typename T> struct St2;
template <> struct St2<float> {
  static __device__ __forceinline__ void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <> struct St2<bf16> {
  static __device__ __forceinline__ void store(bf16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack2(a, b);
  }
};

// d (16 x 8, the mma fragment layout) += A (16 x K) B (K x 8) with f32 FMAs:
// A(i, k) = a[i ai + k ak], B(k, j) = b[k bk + j bj].
__device__ __forceinline__ void fma_frag(float (&d)[4], const float* a, int ai, int ak,
                                         const float* b, int bk, int bj, int K) {
  const int ln = threadIdx.x & 31, g = ln >> 2, t = ln & 3;
  const float* a0 = a + g * ai;
  const float* a1 = a + (g + 8) * ai;
  const float* b0 = b + 2 * t * bj;
  const float* b1 = b + (2 * t + 1) * bj;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float x0 = a0[k * ak], x1 = a1[k * ak], y0 = b0[k * bk], y1 = b1[k * bk];
    d[0] = fmaf(x0, y0, d[0]);
    d[1] = fmaf(x0, y1, d[1]);
    d[2] = fmaf(x1, y0, d[2]);
    d[3] = fmaf(x1, y1, d[3]);
  }
}

// A chunk's gate scans by one warp: lane l holds steps l E .. l E + E - 1 (E
// = ceil(cs / 32)); b = cumsum(lf) and g = cummax(li - b) as warp scans.
struct Scan {
  float b[4], g[4], li[4];
};
__device__ __forceinline__ Scan gate_scan(int cs, const float* __restrict__ lf,
                                          const float* __restrict__ li) {
  const int ln = threadIdx.x & 31, E = (cs + 31) >> 5;
  Scan r;
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = ln * E + e;
    const bool ok = e < E && t < cs;
    run += ok ? lf[t] : 0.f;
    r.b[e] = run;
    r.li[e] = ok ? li[t] : 0.f;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (ln >= o) incl += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (ln == 0) excl = 0.f;
  float cm = -INFINITY;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    r.b[e] = excl + r.b[e];
    if (e < E && ln * E + e < cs) cm = fmaxf(cm, r.li[e] - r.b[e]);
    r.g[e] = cm;
  }
  float mincl = cm;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, mincl, o);
    if (ln >= o) mincl = fmaxf(mincl, y);
  }
  float mexcl = __shfl_up_sync(0xffffffffu, mincl, 1);
  if (ln == 0) mexcl = -INFINITY;
#pragma unroll
  for (int e = 0; e < 4; ++e) r.g[e] = fmaxf(mexcl, r.g[e]);
  return r;
}

// (b, g) at the chunk's last step, in every lane: m after the chunk is
// b_end + max(m0, g_end), mt's last entry
__device__ __forceinline__ float2 chunk_ends(int cs, const Scan& r) {
  const int E = (cs + 31) >> 5, owner = (cs - 1) / E, el = (cs - 1) - owner * E;
  float be = 0.f, ge = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e == el) {
      be = r.b[e];
      ge = r.g[e];
    }
  return make_float2(__shfl_sync(0xffffffffu, be, owner), __shfl_sync(0xffffffffu, ge, owner));
}

// ---------------------------------------------------------------------------
// pass 1: w, the gates, m
// ---------------------------------------------------------------------------

// grid (KC, nch, lanes), clusters of KC along x (KC splits hd).  NSF:
// n-fragments of q k^T a warp holds (csp / 8 at most).
template <typename T, int NSF>
__global__ void __launch_bounds__(THREADS)
mlstm_gates_kernel(const T* __restrict__ q, const T* __restrict__ k, const float* __restrict__ lf,
                   const float* __restrict__ li, float* __restrict__ rec, float* __restrict__ mf,
                   int S, int hd, int cs, float sqrt_hd) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int DP = Cfg<T>::DP, RS = DP + Cfg<T>::PAD;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int KC = gridDim.x, rank = blockIdx.x, c = blockIdx.y, nch = gridDim.y;
  const size_t lane = blockIdx.z;
  const int csp = pad16(cs), ntt = csp / 16, ks = NW / ntt, nsf = csp / 8, WS = csp + 4;
  const int dlo = rank * (hd / KC), npc = hd / KC / DP;
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31, g4 = ln >> 2, t4 = ln & 3;

  unsigned char* sp = smraw;
  T* pq = reinterpret_cast<T*>(sp);            // 2 x csp x RS: q pieces
  T* pk = pq + 2 * csp * RS;                   // 2 x csp x RS: k pieces
  float* ws = reinterpret_cast<float*>(sp);    // csp x WS: w, over the pieces afterwards
  sp += 4 * csp * RS * sizeof(T);
  float* xs = reinterpret_cast<float*>(sp);    // ks x csp x csp: this CTA's q k^T partials
  sp += ks * csp * csp * 4;
  float* lis = reinterpret_cast<float*>(sp);
  float* bsum = lis + csp;
  float* mt = bsum + csp;
  float* ain = mt + csp;
  float* we = ain + csp;
  float* be = we + csp;                        // CHAIN: b at the end of earlier chunks
  float* ge = be + CHAIN;                      // CHAIN: g at the end of earlier chunks
  float* sc = ge + CHAIN;                      // m0, decay0, m_end

  const size_t row0 = lane * S, c0 = row0 + (size_t)c * cs;
  auto load_piece = [&](int buf, int p) {
    const int d0 = dlo + p * DP;
    constexpr int per = DP * (int)sizeof(T) / 16;
    for (int i = tid; i < csp * per; i += THREADS) {
      const int t = i / per, e = (i - t * per) * (16 / (int)sizeof(T));
      const bool ok = t < cs;
      const size_t o = ok ? (c0 + t) * hd + d0 + e : 0;
      cp_async16(saddr(pq + (buf * csp + t) * RS + e), q + o, ok);
      cp_async16(saddr(pk + (buf * csp + t) * RS + e), k + o, ok);
    }
  };
  load_piece(0, 0);
  cp_commit();

  // m0 of this chunk: m <- b_end + max(m, g_end) over the chunks before it,
  // their ends a warp per chunk, the chain in order
  if (tid == 0) sc[0] = NEG_INF_F;
  for (int base = 0; base < c; base += CHAIN) {
    const int n = min(CHAIN, c - base);
    __syncthreads();                           // the last round's chain has read be / ge
    for (int i = warp; i < n; i += NW) {
      const size_t r0 = row0 + (size_t)(base + i) * cs;
      const float2 e = chunk_ends(cs, gate_scan(cs, lf + r0, li + r0));
      if (ln == 0) {
        be[i] = e.x;
        ge[i] = e.y;
      }
    }
    __syncthreads();
    if (tid == 0) {
      float m = sc[0];
      for (int i = 0; i < n; ++i) m = be[i] + fmaxf(m, ge[i]);
      sc[0] = m;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const Scan r = gate_scan(cs, lf + c0, li + c0);
    const float m0 = sc[0];
    const int E = (cs + 31) >> 5;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = ln * E + e;
      if (e < E && t < cs) {
        lis[t] = r.li[e];
        bsum[t] = r.b[e];
        mt[t] = r.b[e] + fmaxf(m0, r.g[e]);
      }
    }
    __syncwarp();
    const float m_end = mt[cs - 1], b_end = bsum[cs - 1];
    for (int t = ln; t < csp; t += 32) {
      const bool ok = t < cs;
      ain[t] = ok ? expf(bsum[t] + m0 - mt[t]) : 0.f;
      we[t] = ok ? rnd<T>(expf(lis[t] + b_end - bsum[t] - m_end)) : 0.f;
      if (!ok) mt[t] = 0.f;
    }
    if (ln == 0) {
      sc[1] = expf(b_end + m0 - m_end);
      sc[2] = m_end;
    }
  }

  // q k^T over this CTA's rows of hd: warp (tt, kk) takes rows tt * 16 ..,
  // the pieces' 16-deep steps kk, kk + ks, ...
  const bool s_role = warp < ntt * ks;
  const int tt = warp % ntt, kk = warp / ntt;
  float sacc[NSF][4];
#pragma unroll
  for (int n = 0; n < NSF; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
  for (int p = 0; p < npc; ++p) {
    const int buf = p & 1;
    if (p + 1 < npc) {
      load_piece(buf ^ 1, p + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                           // piece p in shared memory
    const T* qb = pq + buf * csp * RS;
    const T* kb = pk + buf * csp * RS;
    if (s_role) {
      for (int st = kk; st < DP / 16; st += ks) {
        if constexpr (BF) {
          uint32_t a[4];
          ldsm4(a, saddr(qb + (tt * 16 + (ln & 15)) * RS + st * 16 + (ln >> 4) * 8));
#pragma unroll
          for (int np = 0; np < NSF / 2; ++np) {
            if (2 * np < nsf) {
              uint32_t b[4];
              ldsm4(b, saddr(kb + (np * 16 + (ln >> 4) * 8 + (ln & 7)) * RS + st * 16 +
                             ((ln >> 3) & 1) * 8));
              mma16816(sacc[2 * np], a, b[0], b[1]);
              mma16816(sacc[2 * np + 1], a, b[2], b[3]);
            }
          }
        } else {
#pragma unroll
          for (int n = 0; n < NSF; ++n)
            if (n < nsf)
              fma_frag(sacc[n], qb + tt * 16 * RS + st * 16, RS, 1, kb + n * 8 * RS + st * 16, 1,
                       RS, 16);
        }
      }
    }
    __syncthreads();                           // every warp is done with piece p's buffer
  }
  if (s_role) {
#pragma unroll
    for (int n = 0; n < NSF; ++n)
      if (n < nsf)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          *reinterpret_cast<float2*>(xs + (kk * csp + tt * 16 + g4 + 8 * h2) * csp + n * 8 +
                                     2 * t4) = make_float2(sacc[n][2 * h2], sacc[n][2 * h2 + 1]);
  }
  cg::cluster_group cl = cg::this_cluster();
  if (KC > 1)
    cl.sync();                                 // every CTA's partials in place
  else
    __syncthreads();

  // w of the rows this CTA owns (t-tiles rank, rank + KC, ...): the
  // partials summed over the cluster's CTAs and the d splits in order
  float* rc = rec + (lane * nch + c) * (size_t)rec_floats(csp);
  const int own = (ntt - rank + KC - 1) / KC;
  for (int i = tid; i < own * 16 * csp; i += THREADS) {
    const int o = i / (16 * csp), r16 = i - o * 16 * csp;
    const int t = (rank + o * KC) * 16 + r16 / csp, s = r16 % csp;
    float w = 0.f;
    if (t < cs && s <= t) {
      float a = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < KC) {
          const float* x = KC > 1 ? cl.map_shared_rank(xs, r) : xs;
          for (int j = 0; j < ks; ++j) a += x[(j * csp + t) * csp + s];
        }
      w = (a / sqrt_hd) * expf(lis[s] - bsum[s] + bsum[t] - mt[t]);
    }
    ws[t * WS + s] = w;
    if constexpr (BF)
      reinterpret_cast<bf16*>(rc)[w_index(t, s, csp)] = __float2bfloat16(w);
    else
      rc[t * csp + s] = w;
  }
  __syncthreads();
  for (int i = tid; i < own * 16; i += THREADS) {
    const int t = (rank + (i / 16) * KC) * 16 + i % 16;
    float a = 0.f;
    for (int s = 0; s < cs; ++s) a += ws[t * WS + s];
    rc[csp * csp + t] = a;
  }
  if (rank == 0) {
    for (int t = tid; t < csp; t += THREADS) {
      rc[csp * csp + csp + t] = ain[t];
      rc[csp * csp + 2 * csp + t] = we[t];
      rc[csp * csp + 3 * csp + t] = mt[t];
    }
    if (tid == 0) {
      rc[csp * csp + 4 * csp] = sc[1];
      if (c == nch - 1) mf[lane] = sc[2];
    }
  }
  if (KC > 1) cl.sync();                       // no CTA leaves while another may read it
}

// ---------------------------------------------------------------------------
// pass 2: the state, h
// ---------------------------------------------------------------------------

// A CTA's block of C (rows x STRIP) and n's rows live in u[NFS + 1][4]:
//   bf16: mma fragments.  Warp (mi, gi) holds rows mi * 16 + (g, g + 8) of
//     fragments gi * nfg + f (8 columns each); the last group also n's
//     column (u[NFS], column 0 of its fragment).
//   f32: thread (tid / 8, tid % 8) holds rows 4 (tid / 8) .. + 3 (u[f][r]:
//     row 4 (tid / 8) + r) of columns 8 (tid % 8) + f; u[NFS][r] is n of
//     the row, held by the threads with tid % 8 == 0.  Each shared-memory
//     load feeds 8 or 32 FMAs (float4 rows of k, v and C0).
struct Tile {
  int rows, tid, ln, g4, t4, mi, gi, nfg;
  bool n_frag;
  __device__ Tile(int rows_, bool with_n) : rows(rows_) {
    tid = threadIdx.x;
    ln = tid & 31;
    g4 = ln >> 2;
    t4 = ln & 3;
    const int mtc = rows / 16, ngu = NW / mtc;
    mi = (tid >> 5) % mtc;
    gi = (tid >> 5) / mtc;
    nfg = NFS / ngu;
    n_frag = with_n && gi == ngu - 1;
  }
};

// u += (round(w_end) k)^T [v | 1] over the chunk's steps (n's column when
// with_n): ks (csp x RD) the block's columns of k, vs (csp x VS) v's strip
template <typename T>
__device__ __forceinline__ void update(float (&u)[NFS + 1][4], const Tile& b, const T* ks, int RD,
                                       const T* vs, const float* we, int cs, int csp,
                                       bool with_n) {
  constexpr int VS = Cfg<T>::VS;
  if constexpr (sizeof(T) == 2) {
    const int ln = b.ln, t4 = b.t4;
    for (int st = 0; st < csp / 16; ++st) {
      uint32_t a[4], ah[4], al[4];
      ldsm4t(a, saddr(ks + (st * 16 + ((ln >> 4) << 3) + (ln & 7)) * RD + b.mi * 16 +
                      ((ln >> 3) & 1) * 8));
      const float w0 = we[st * 16 + 2 * t4], w1 = we[st * 16 + 2 * t4 + 1];
      const float w2 = we[st * 16 + 8 + 2 * t4], w3 = we[st * 16 + 9 + 2 * t4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f2 = unpack2(a[i]);
        split2(f2.x * (i >= 2 ? w2 : w0), f2.y * (i >= 2 ? w3 : w1), ah[i], al[i]);
      }
#pragma unroll
      for (int f = 0; f < NFS; f += 2) {
        if (f < b.nfg) {
          uint32_t bb[4];
          ldsm4t(bb, saddr(vs + (st * 16 + (ln & 8) + (ln & 7)) * VS + (b.gi * b.nfg + f) * 8 +
                           (ln >> 4) * 8));
          mma16816(u[f], ah, bb[0], bb[1]);
          mma16816(u[f + 1], ah, bb[2], bb[3]);
          mma16816(u[f], al, bb[0], bb[1]);
          mma16816(u[f + 1], al, bb[2], bb[3]);
        }
      }
      if (b.n_frag && with_n) {
        uint32_t bb[2];
        ldsm2t(bb, saddr(vs + (st * 16 + (ln & 15)) * VS + STRIP));
        mma16816(u[NFS], ah, bb[0], bb[1]);
        mma16816(u[NFS], al, bb[0], bb[1]);
      }
    }
  } else {
    const int d0 = (b.tid >> 3) * 4, j0 = (b.tid & 7) * 8;
    const bool n_col = with_n && (b.tid & 7) == 0;
    if (d0 >= b.rows) return;                  // rows 64: half the threads hold no C
#pragma unroll 2
    for (int s = 0; s < cs; ++s) {
      const float4 k4 = *reinterpret_cast<const float4*>(ks + s * RD + d0);
      const float4 va = *reinterpret_cast<const float4*>(vs + s * VS + j0);
      const float4 vb = *reinterpret_cast<const float4*>(vs + s * VS + j0 + 4);
      const float kw[4] = {we[s] * k4.x, we[s] * k4.y, we[s] * k4.z, we[s] * k4.w};
      const float vv[8] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int f = 0; f < NFS; ++f) u[f][r] = fmaf(kw[r], vv[f], u[f][r]);
        if (n_col) u[NFS][r] += kw[r];
      }
    }
  }
}

// u's C0 and n0 for q C0: bf16 as hi and lo into c0h / c0l (rows x VS),
// then u decayed to decay0 u; f32 into c0s (rows x CS0), u reloaded
// decayed after q C0 (reload_c0)
template <typename T>
__device__ __forceinline__ void stage_c0(float (&u)[NFS + 1][4], const Tile& b, T* c0h, T* c0l,
                                         float* c0s, float decay0) {
  constexpr int VS = Cfg<T>::VS;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int f = 0; f <= NFS; ++f) {
      const bool mine = f < NFS ? f < b.nfg : b.n_frag;
      const int col = (f < NFS ? (b.gi * b.nfg + f) * 8 : STRIP) + 2 * b.t4;
      if (mine)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int o = (b.mi * 16 + b.g4 + 8 * h2) * VS + col;
          uint32_t hi, lo;
          split2(u[f][2 * h2], u[f][2 * h2 + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(c0h + o) = hi;
          *reinterpret_cast<uint32_t*>(c0l + o) = lo;
          u[f][2 * h2] *= decay0;
          u[f][2 * h2 + 1] *= decay0;
        }
    }
  } else {
    const int d0 = (b.tid >> 3) * 4, j0 = (b.tid & 7) * 8;
    if (d0 >= b.rows) return;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* row = c0s + (d0 + r) * CS0;
      *reinterpret_cast<float4*>(row + j0) = make_float4(u[0][r], u[1][r], u[2][r], u[3][r]);
      *reinterpret_cast<float4*>(row + j0 + 4) = make_float4(u[4][r], u[5][r], u[6][r], u[7][r]);
      if (j0 == 0) *reinterpret_cast<float4*>(row + STRIP) = make_float4(u[NFS][r], 0.f, 0.f, 0.f);
    }
  }
}

// f32: u = decay0 C0 from c0s (the registers are free while q C0 runs)
__device__ __forceinline__ void reload_c0(float (&u)[NFS + 1][4], const Tile& b, const float* c0s,
                                          float decay0) {
  const int d0 = (b.tid >> 3) * 4, j0 = (b.tid & 7) * 8;
  if (d0 >= b.rows) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* row = c0s + (d0 + r) * CS0;
    const float4 a = *reinterpret_cast<const float4*>(row + j0);
    const float4 c = *reinterpret_cast<const float4*>(row + j0 + 4);
    const float x[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int f = 0; f < NFS; ++f) u[f][r] = decay0 * x[f];
    u[NFS][r] = j0 == 0 ? decay0 * row[STRIP] : 0.f;
  }
}

// q C0 and q . n0 over the block's rows into qcx (csp x XS, column STRIP:
// q . n0), after a barrier that frees the buffers it goes over; f32 also
// brings u back (reload_c0) before the partials go over C0
template <typename T>
__device__ __forceinline__ void q_c0(float (&u)[NFS + 1][4], const Tile& b, const T* qs, int RD,
                                     const T* c0h, const T* c0l, const float* c0s, float* qcx,
                                     int csp, float decay0) {
  constexpr int VS = Cfg<T>::VS;
  const int rows = b.rows, ntt = csp / 16, warp = b.tid >> 5;
  if constexpr (sizeof(T) == 2) {
    // warp (tq, gq): t-tile tq, fragments fa .. fb of the nine
    const int ngq = NW / ntt, tq = warp % ntt, gq = warp / ntt;
    const bool q_role = warp < ntt * ngq;
    const int fa = gq * (NFS + 1) / ngq, fb = (gq + 1) * (NFS + 1) / ngq;
    const int ln = b.ln;
    float qa[NFS + 1][4];
#pragma unroll
    for (int f = 0; f <= NFS; ++f) qa[f][0] = qa[f][1] = qa[f][2] = qa[f][3] = 0.f;
    if (q_role) {
      for (int kd = 0; kd < rows / 16; ++kd) {
        uint32_t a[4];
        ldsm4(a, saddr(qs + (tq * 16 + (ln & 15)) * RD + kd * 16 + (ln >> 4) * 8));
        const int bo = (kd * 16 + (ln & 15)) * VS;
#pragma unroll
        for (int f = 0; f <= NFS; ++f) {
          if (f >= fa && f < fb) {
            uint32_t bh[2], bl[2];
            ldsm2t(bh, saddr(c0h + bo + f * 8));
            ldsm2t(bl, saddr(c0l + bo + f * 8));
            mma16816(qa[f], a, bh[0], bh[1]);
            mma16816(qa[f], a, bl[0], bl[1]);
          }
        }
      }
    }
    __syncthreads();                           // q and C0 are read: the partials go over them
    if (q_role) {
#pragma unroll
      for (int f = 0; f <= NFS; ++f)
        if (f >= fa && f < fb)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            *reinterpret_cast<float2*>(qcx + (tq * 16 + b.g4 + 8 * h2) * XS + f * 8 + 2 * b.t4) =
                make_float2(qa[f][2 * h2], qa[f][2 * h2 + 1]);
    }
  } else {
    // qs: q transposed (rows x QT, qT[d][t]); warp w: columns 8w .. 8w + 7
    // (warp 0 also n0's), lane: rows 2 p, 2 p + 1 of t-pairs p = lane,
    // lane + 32, ...: a C0 load is a broadcast, a q load a float2 row
    constexpr int MAXP = MAX_CS / 2 / 32;
    const int j0 = warp * 8, QT = csp + 2, np = csp / 2;
    float qa[MAXP][2][9];
#pragma unroll
    for (int i = 0; i < MAXP; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int f = 0; f < 9; ++f) qa[i][r][f] = 0.f;
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      const int pp = b.ln + 32 * i;
      if (pp < np) {
#pragma unroll 4
        for (int d = 0; d < rows; ++d) {
          const float2 x = *reinterpret_cast<const float2*>(qs + d * QT + 2 * pp);
          const float4 ca = *reinterpret_cast<const float4*>(c0s + d * CS0 + j0);
          const float4 cb = *reinterpret_cast<const float4*>(c0s + d * CS0 + j0 + 4);
          const float cn = warp == 0 ? c0s[d * CS0 + STRIP] : 0.f;
          const float cc[9] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w, cn};
#pragma unroll
          for (int f = 0; f < 9; ++f) {
            qa[i][0][f] = fmaf(x.x, cc[f], qa[i][0][f]);
            qa[i][1][f] = fmaf(x.y, cc[f], qa[i][1][f]);
          }
        }
      }
    }
    __syncthreads();                           // q and C0 are read
    reload_c0(u, b, c0s, decay0);                // f32: C0 back into the registers, decayed
    __syncthreads();                           // ... and C0 read: the partials go over it
#pragma unroll
    for (int i = 0; i < MAXP; ++i) {
      const int pp = b.ln + 32 * i;
      if (pp < np) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float* o = qcx + (2 * pp + r) * XS;
          *reinterpret_cast<float4*>(o + j0) =
              make_float4(qa[i][r][0], qa[i][r][1], qa[i][r][2], qa[i][r][3]);
          *reinterpret_cast<float4*>(o + j0 + 4) =
              make_float4(qa[i][r][4], qa[i][r][5], qa[i][r][6], qa[i][r][7]);
          if (warp == 0) o[STRIP] = qa[i][r][8];
        }
      }
    }
  }
}

// C's block and n's rows from the registers (C with streaming stores)
template <typename T>
__device__ __forceinline__ void store_c(const float (&u)[NFS + 1][4], const Tile& b, float* cf,
                                        float* nf, size_t lane, int hd, int dlo, int j0,
                                        bool n_out) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int f = 0; f < NFS; ++f) {
      if (f < b.nfg) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const size_t d = lane * hd + dlo + b.mi * 16 + b.g4 + 8 * h2;
          __stcs(reinterpret_cast<float2*>(cf + d * hd + j0 + (b.gi * b.nfg + f) * 8 + 2 * b.t4),
                 make_float2(u[f][2 * h2], u[f][2 * h2 + 1]));
        }
      }
    }
    if (n_out && b.n_frag && b.t4 == 0) {
      nf[lane * hd + dlo + b.mi * 16 + b.g4] = u[NFS][0];
      nf[lane * hd + dlo + b.mi * 16 + b.g4 + 8] = u[NFS][2];
    }
  } else {
    const int d0 = (b.tid >> 3) * 4, jj = (b.tid & 7) * 8;
    if (d0 >= b.rows) return;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* row = cf + (lane * hd + dlo + d0 + r) * hd + j0 + jj;
      __stcs(reinterpret_cast<float4*>(row), make_float4(u[0][r], u[1][r], u[2][r], u[3][r]));
      __stcs(reinterpret_cast<float4*>(row + 4), make_float4(u[4][r], u[5][r], u[6][r], u[7][r]));
      if (n_out && jj == 0) nf[lane * hd + dlo + d0 + r] = u[NFS][r];
    }
  }
}

// h for the strip: (round(w) v + a_inter q C0 / sqrt(hd)) / lim, a unit =
// one t-tile x two n-fragments, units rank, rank + P, ... of the ntt x 4
// (spread over the cluster's CTAs, so none waits on another's share at the
// next barrier).  round(w) staged in wsm: bf16 fragments, f32 rows;
// qsum(t, j) the cluster's q C0 when state.
template <typename T, typename Q>
__device__ __forceinline__ void h_rows(const Tile& b, const T* vs, const uint4* wsm,
                                       const float* ain, const float* lim,
                                       T* hs, size_t c0, int hd, int j0, int cs, int csp,
                                       int rank, int P, bool state, float sqrt_hd, Q qsum) {
  constexpr int VS = Cfg<T>::VS;
  const int nst = csp / 16, ln = b.ln, units = nst * (NFS / 2);
  for (int un = rank + P * (b.tid >> 5); un < units; un += P * NW) {
    const int tt = un / (NFS / 2), fp = un % (NFS / 2);
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if constexpr (sizeof(T) == 2) {
      for (int st = 0; st <= tt; ++st) {
        const uint4 a4 = wsm[(tt * nst + st) * 32 + ln];
        const uint32_t a[4] = {a4.x, a4.y, a4.z, a4.w};
        uint32_t bb[4];
        ldsm4t(bb, saddr(vs + (st * 16 + (ln & 8) + (ln & 7)) * VS + fp * 16 + (ln >> 4) * 8));
        mma16816(acc[0], a, bb[0], bb[1]);
        mma16816(acc[1], a, bb[2], bb[3]);
      }
    } else {
      const int kmax = min(cs, tt * 16 + 16);
#pragma unroll
      for (int f = 0; f < 2; ++f)
        fma_frag(acc[f], reinterpret_cast<const float*>(wsm) + tt * 16 * csp, csp, 1,
                 vs + (2 * fp + f) * 8, VS, 1, kmax);
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int t = tt * 16 + b.g4 + 8 * h2;
      if (t >= cs) continue;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        const int j = (2 * fp + f) * 8 + 2 * b.t4;
        float n0 = acc[f][2 * h2], n1 = acc[f][2 * h2 + 1];
        if (state) {
          const float2 qc = qsum(t, j);
          n0 = n0 + ain[t] * qc.x / sqrt_hd;
          n1 = n1 + ain[t] * qc.y / sqrt_hd;
        }
        St2<T>::store(hs + (c0 + t) * hd + j0 + j, n0 / lim[t], n1 / lim[t]);
      }
    }
  }
}

// cp.async of a record's gate vectors (wsum, a_inter, round(w_end), mt:
// 4 csp floats) and its round(w) into wsm: bf16 fragments, f32 rows
template <typename T>
__device__ __forceinline__ void load_record(const float* rc, float* vec, uint4* wsm, int csp) {
  for (int i = threadIdx.x; i < csp; i += THREADS)
    cp_async16(saddr(vec + 4 * i), rc + csp * csp + 4 * i, true);
  for (int i = threadIdx.x; i < csp * csp * (int)sizeof(T) / 16; i += THREADS)
    cp_async16(saddr(wsm + i), reinterpret_cast<const uint4*>(rc) + i, true);
}

// lim[t] = max(|den|, exp(-mt)) of the chunk's rows; den = w's row sum
// (+ a_inter q . n0 / sqrt(hd) when state)
template <typename Q>
__device__ __forceinline__ void row_limits(const float* vec, float* lim, int cs, int csp,
                                           bool state, float sqrt_hd, Q qsum) {
  const float* wsum = vec;
  const float* ain = vec + csp;
  const float* mt = vec + 3 * csp;
  for (int t = threadIdx.x; t < cs; t += THREADS) {
    const float den = state ? wsum[t] + ain[t] * qsum(t, STRIP).x / sqrt_hd : wsum[t];
    lim[t] = fmaxf(fabsf(den), expf(-mt[t]));
  }
}

// v's n columns: a one at each of the chunk's steps, zeros after
template <typename T>
__device__ __forceinline__ void ones_column(T* vs, int cs, int csp) {
  for (int i = threadIdx.x; i < csp * 8; i += THREADS) {
    const int t = i / 8, e = i % 8;
    vs[t * Cfg<T>::VS + STRIP + e] = Ty<T>::from_f(e == 0 && t < cs ? 1.f : 0.f);
  }
}

// One chunk (S = cs): grid (P, G2, lanes), no cluster.  CTA (r, g, lane)
// owns C's rows [r rows, (r + 1) rows) of strips g, g + G2, ...: k's block
// and the record load once, v's strips arrive in a cp.async double buffer,
// the next in flight while the current one is multiplied and written.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
mlstm_one_chunk_kernel(const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ rec, T* __restrict__ hs, float* __restrict__ cf,
                       float* __restrict__ nf, int hd, int cs, float sqrt_hd) {
  constexpr int PAD = Cfg<T>::PAD, VS = Cfg<T>::VS, E16 = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smraw[];
  const int P = gridDim.x, rank = blockIdx.x, G2 = gridDim.y;
  const size_t lane = blockIdx.z;
  const int csp = pad16(cs), ns = hd / STRIP;
  const int rows = hd / P, dlo = rank * rows, RD = rows + PAD;
  const size_t c0 = lane * cs;
  const float* rc = rec + lane * (size_t)rec_floats(csp);

  unsigned char* sp = smraw;
  T* ks = reinterpret_cast<T*>(sp);            // csp x RD
  sp += csp * RD * sizeof(T);
  T* vbuf = reinterpret_cast<T*>(sp);          // 2 x csp x VS
  sp += 2 * csp * VS * sizeof(T);
  uint4* wsm = reinterpret_cast<uint4*>(sp);   // the record's round(w)
  sp += csp * csp * sizeof(T);
  float* vec = reinterpret_cast<float*>(sp);   // wsum, a_inter, round(w_end), mt
  float* lim = vec + 4 * csp;

  auto load_v = [&](int buf, int strip) {
    constexpr int pv = STRIP / E16;
    for (int i = threadIdx.x; i < csp * pv; i += THREADS) {
      const int t = i / pv, e = (i - t * pv) * E16;
      const bool ok = t < cs;
      cp_async16(saddr(vbuf + (buf * csp + t) * VS + e),
                 v + (ok ? (c0 + t) * hd + strip * STRIP + e : 0), ok);
    }
  };
  {
    const int per = rows / E16;
    for (int i = threadIdx.x; i < csp * per; i += THREADS) {
      const int t = i / per, e = (i - t * per) * E16;
      const bool ok = t < cs;
      cp_async16(saddr(ks + t * RD + e), k + (ok ? (c0 + t) * hd + dlo + e : 0), ok);
    }
  }
  load_record<T>(rc, vec, wsm, csp);
  load_v(0, blockIdx.y);
  cp_commit();
  ones_column(vbuf, cs, csp);
  ones_column(vbuf + csp * VS, cs, csp);

  const Tile b(rows, true);
  auto none = [](int, int) { return make_float2(0.f, 0.f); };
  int buf = 0;
  for (int strip = blockIdx.y; strip < ns; strip += G2, buf ^= 1) {
    if (strip + G2 < ns) {
      load_v(buf ^ 1, strip + G2);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                           // k, the record and this strip of v in place
    if (strip == blockIdx.y) row_limits(vec, lim, cs, csp, false, sqrt_hd, none);
    const T* vs = vbuf + buf * csp * VS;
    float u[NFS + 1][4];
#pragma unroll
    for (int f = 0; f <= NFS; ++f) u[f][0] = u[f][1] = u[f][2] = u[f][3] = 0.f;
    update<T>(u, b, ks, RD, vs, vec + 2 * csp, cs, csp, strip == 0);
    store_c<T>(u, b, cf, nf, lane, hd, dlo, strip * STRIP, strip == 0);
    __syncthreads();                           // lim in place
    h_rows<T>(b, vs, wsm, vec + csp, lim, hs, c0, hd, strip * STRIP, cs, csp, rank, P, false,
              sqrt_hd, none);
    __syncthreads();                           // every warp is done with this buffer
  }
}

// Several chunks: grid (P, hd / STRIP, lanes), clusters of P along x.  CTA
// r of a strip owns C's rows [r rows, (r + 1) rows) and walks the chunks,
// its block of C in registers from the first to the last.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
mlstm_state_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ rec, T* __restrict__ hs, float* __restrict__ cf,
                   float* __restrict__ nf, int S, int hd, int cs, float sqrt_hd) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int PAD = Cfg<T>::PAD, VS = Cfg<T>::VS, E16 = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smraw[];
  const int P = gridDim.x, rank = blockIdx.x, j0 = blockIdx.y * STRIP;
  const size_t lane = blockIdx.z;
  const int csp = pad16(cs), nch = S / cs;
  const int rows = hd / P, dlo = rank * rows, RD = rows + PAD;
  const int kq = csp * RD * (int)sizeof(T);
  // f32: q arrives transposed (rows x (csp + 2)) over k's buffer
  const int kqb = BF ? kq : (kq > rows * (csp + 2) * 4 ? kq : rows * (csp + 2) * 4);

  // bf16: q (and the q C0 partials over it), k, v, C0 as hi and lo; f32:
  // q transposed (prefetched during the last chunk) then k in one buffer,
  // v, C0 (and the q C0 partials over it)
  unsigned char* sp = smraw;
  T* qs = reinterpret_cast<T*>(sp);
  T* ks = qs;
  float* qcx = reinterpret_cast<float*>(sp);
  if (BF) {
    sp += kq > 4 * csp * XS ? kq : 4 * csp * XS;
    ks = reinterpret_cast<T*>(sp);
  }
  sp += kqb;
  T* vs = reinterpret_cast<T*>(sp);
  sp += csp * VS * sizeof(T);
  T* c0h = reinterpret_cast<T*>(sp);
  T* c0l = c0h + rows * VS;
  float* c0s = reinterpret_cast<float*>(sp);
  if (BF) {
    sp += 2 * rows * VS * 2;
  } else {
    qcx = c0s;
    sp += rows * CS0 * 4 > 4 * csp * XS ? rows * CS0 * 4 : 4 * csp * XS;
  }
  uint4* wsm = reinterpret_cast<uint4*>(sp);   // the record's round(w)
  sp += csp * csp * sizeof(T);
  float* vec = reinterpret_cast<float*>(sp);   // wsum, a_inter, round(w_end), mt
  float* lim = vec + 4 * csp;

  cg::cluster_group cl = cg::this_cluster();
  // q C0 of row t, columns j and j + 1, summed over the cluster's CTAs in order
  auto qsum = [&](int t, int j) {
    float2 a = make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < P) {
        const float* x = P > 1 ? cl.map_shared_rank(qcx, r) : qcx;
        const float2 y = *reinterpret_cast<const float2*>(x + t * XS + j);
        a.x += y.x;
        a.y += y.y;
      }
    return a;
  };
  // f32 q, transposed: qT[d][t] (4-byte copies; lanes on consecutive d)
  auto load_qt = [&](size_t c0) {
    const int QT = csp + 2;
    for (int i = threadIdx.x; i < csp * rows; i += THREADS) {
      const int t = i / rows, d = i - t * rows;
      if (t < cs) cp_async4(saddr(qs + d * QT + t), q + (c0 + t) * hd + dlo + d);
      else qs[d * QT + t] = Ty<T>::from_f(0.f);
    }
  };
  auto load_rows = [&](T* dst, const T* src, size_t c0) {
    const int per = rows / E16;
    for (int i = threadIdx.x; i < csp * per; i += THREADS) {
      const int t = i / per, e = (i - t * per) * E16;
      const bool ok = t < cs;
      cp_async16(saddr(dst + t * RD + e), src + (ok ? (c0 + t) * hd + dlo + e : 0), ok);
    }
  };

  const Tile b(rows, true);
  float u[NFS + 1][4];
#pragma unroll
  for (int f = 0; f <= NFS; ++f) u[f][0] = u[f][1] = u[f][2] = u[f][3] = 0.f;

  for (int c = 0; c < nch; ++c) {
    const bool state = c > 0, last = c == nch - 1;
    const size_t c0 = lane * S + (size_t)c * cs;
    const float* rc = rec + (lane * nch + c) * (size_t)rec_floats(csp);
    __syncthreads();                           // the last chunk is done with shared memory
    if (P > 1 && c >= 2) cluster_wait();      // ... and the cluster with its q C0 partials
    if (BF || !state) load_rows(ks, k, c0);   // f32: q, prefetched, is there after chunk 0
    if (BF && state) load_rows(qs, q, c0);
    {
      constexpr int pv = STRIP / E16;
      for (int i = threadIdx.x; i < csp * pv; i += THREADS) {
        const int t = i / pv, e = (i - t * pv) * E16;
        const bool ok = t < cs;
        cp_async16(saddr(vs + t * VS + e), v + (ok ? (c0 + t) * hd + j0 + e : 0), ok);
      }
    }
    load_record<T>(rc, vec, wsm, csp);
    cp_commit();
    ones_column(vs, cs, csp);
    const float decay0 = state ? rc[csp * csp + 4 * csp] : 0.f;
    if (state) stage_c0<T>(u, b, c0h, c0l, c0s, decay0);
    cp_wait<0>();
    __syncthreads();                           // the chunk's copies and C0 in shared memory

    if (state) q_c0<T>(u, b, qs, RD, c0h, c0l, c0s, qcx, csp, decay0);
    if (!BF && state) {
      load_rows(ks, k, c0);                    // f32: k over q
      cp_commit();
      cp_wait<0>();
      __syncthreads();
    }
    update<T>(u, b, ks, RD, vs, vec + 2 * csp, cs, csp, true);
    if (!BF && !last) {
      __syncthreads();                         // every warp is done with k: the next q goes over it
      load_qt(c0 + cs);
      cp_commit();
    }
    if (last) store_c<T>(u, b, cf, nf, lane, hd, dlo, j0, blockIdx.y == 0);

    // h's rows of this CTA (t-tiles rank, rank + P, ...) for the strip
    if (state && P > 1) {
      cluster_arrive();                        // every CTA's q C0 partials in place
      cluster_wait();
    } else {
      __syncthreads();
    }
    row_limits(vec, lim, cs, csp, state, sqrt_hd, qsum);
    __syncthreads();
    h_rows<T>(b, vs, wsm, vec + csp, lim, hs, c0, hd, j0, cs, csp, rank, P, state, sqrt_hd, qsum);
    if (state && P > 1) cluster_arrive();     // done reading the others' partials
  }
  if (P > 1 && nch >= 2) cluster_wait();      // no CTA leaves while another may read it
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kern, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= 32) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  if (done & (1u << dev)) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e == cudaSuccess) done |= 1u << dev;
  return e;
}

template <typename K, typename... Args>
cudaError_t launch_cluster(K kern, dim3 grid, int cluster, int smem, cudaStream_t stream,
                           Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, int NSF>
cudaError_t launch_pass1(const T* q, const T* k, const float* lf, const float* li, float* rec,
                         float* mf, int lanes, int S, int hd, int cs, float sqrt_hd, int kc,
                         int smem, cudaStream_t s) {
  static unsigned done = 0;
  const cudaError_t e = allow_smem(mlstm_gates_kernel<T, NSF>, done);
  if (e != cudaSuccess) return e;
  return launch_cluster(mlstm_gates_kernel<T, NSF>, dim3(kc, S / cs, lanes), kc, smem, s, q, k,
                        lf, li, rec, mf, S, hd, cs, sqrt_hd);
}

template <typename T>
cudaError_t launch_pass2(const T* q, const T* k, const T* v, const float* rec, T* hs, float* cf,
                         float* nf, int lanes, int S, int hd, int cs, float sqrt_hd, int p, int g2,
                         int smem, cudaStream_t s) {
  if (S / cs > 1) {
    static unsigned done = 0;
    const cudaError_t e = allow_smem(mlstm_state_kernel<T>, done);
    if (e != cudaSuccess) return e;
    return launch_cluster(mlstm_state_kernel<T>, dim3(p, hd / STRIP, lanes), p, smem, s, q, k, v,
                          rec, hs, cf, nf, S, hd, cs, sqrt_hd);
  }
  static unsigned done = 0;
  const cudaError_t e = allow_smem(mlstm_one_chunk_kernel<T>, done);
  if (e != cudaSuccess) return e;
  return launch_cluster(mlstm_one_chunk_kernel<T>, dim3(p, g2, lanes), 1, smem, s, k, v, rec, hs,
                        cf, nf, hd, cs, sqrt_hd);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, const void* lf, const void* li,
             void* hs, void* cf, void* nf, void* mf, void* rec, int lanes, int S, int hd, int cs,
             float sqrt_hd, int kc, int rows, int g2, int smem1, int smem2, cudaStream_t s) {
  const int esz = (int)sizeof(T), nch = S / cs, p = rows > 0 ? hd / rows : 0;
  if (kc < 1 || kc > MAX_CLUSTER || hd % kc || (hd / kc) % Cfg<T>::DP ||
      (rows != 64 && rows != 128) ||
      hd % rows || p > MAX_CLUSTER || hd % STRIP || g2 < 1 || g2 > hd / STRIP || nch > 65535 ||
      smem1 != smem_pass1(esz, cs) || smem2 != smem_pass2(esz, cs, rows, p, nch > 1) ||
      smem1 > MAX_SMEM || smem2 > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const T* tq = (const T*)q;
  const T* tk = (const T*)k;
  const int csp = pad16(cs);
  cudaError_t e;
  if (csp <= 32)
    e = launch_pass1<T, 4>(tq, tk, (const float*)lf, (const float*)li, (float*)rec, (float*)mf,
                           lanes, S, hd, cs, sqrt_hd, kc, smem1, s);
  else if (csp <= 64)
    e = launch_pass1<T, 8>(tq, tk, (const float*)lf, (const float*)li, (float*)rec, (float*)mf,
                           lanes, S, hd, cs, sqrt_hd, kc, smem1, s);
  else
    e = launch_pass1<T, 16>(tq, tk, (const float*)lf, (const float*)li, (float*)rec, (float*)mf,
                            lanes, S, hd, cs, sqrt_hd, kc, smem1, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_pass2<T>(tq, tk, (const T*)v, (const float*)rec, (T*)hs, (float*)cf,
                              (float*)nf, lanes, S, hd, cs, sqrt_hd, p, g2, smem2, s);
}

}  // namespace

extern "C" {

// q, k, v (lanes,S,hd) in dt (0 = float32, 1 = bfloat16), lf, li (lanes,S)
// f32 -> hs (lanes,S,hd) in dt, cf (lanes,hd,hd), nf (lanes,hd), mf (lanes)
// f32; lanes = M*B*H; rec: lanes * S / cs * (csp^2 + 4 csp + 4) f32, csp = cs
// rounded up to 16 (mlstm_chunk.py's record_floats).  S % cs == 0,
// 1 <= cs <= 128, hd % 64 == 0; kc (pass 1's cluster), rows (pass 2's
// block rows), g2 (with one chunk, the CTAs sharing a block's strips) and
// the two passes' shared memory as mlstm_chunk.py's launch_plan gives them
// (shared memory that is not this file's own sum is refused).  Two
// launches; returns the first failure's cudaError_t.
int mlstm_chunkwise(int dt, const void* q, const void* k, const void* v, const void* lf,
                    const void* li, void* hs, void* cf, void* nf, void* mf, void* rec, int lanes,
                    int S, int hd, int cs, float sqrt_hd, int kc, int rows, int g2, int smem1,
                    int smem2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes < 1 || lanes > 65535 || cs < 1 || cs > MAX_CS || S < cs || S % cs || hd < 64 ||
      hd % 64)
    return (int)cudaErrorInvalidValue;
  if (dt == 0)
    return launch_t<float>(q, k, v, lf, li, hs, cf, nf, mf, rec, lanes, S, hd, cs, sqrt_hd, kc,
                           rows, g2, smem1, smem2, s);
  if (dt == 1)
    return launch_t<bf16>(q, k, v, lf, li, hs, cf, nf, mf, rec, lanes, S, hd, cs, sqrt_hd, kc,
                          rows, g2, smem1, smem2, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
