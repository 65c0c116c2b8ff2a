// Chunked-prefill GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/chunk_prefill_attn.py
// (_kernel, via chunk_prefill_attention; the sharded form reaches it
// through ops.chunk_prefill_attention): a C-token query chunk attends over
// [ring cache before the chunk, the chunk], all masking derived from the
// lane's offset (pinned-prefix ring positions, causality, sliding window,
// attention sink), online softmax in f32.
//
// What bounds it on this card: not bytes or operations -- at the serving
// shape (4 lanes, C = 32, S = 1024, 32/4 heads, hd 64) the visible q, k, v
// and out are ~2 MB and the products 0.25 GFLOP, a few microseconds of
// either.  The wall is latency and parallelism: how many blocks run at
// once and how long the longest walk over key tiles is.  The bf16 design:
//   * a fixed number of blocks per (lane, kv head, 64 query rows), one
//     cluster of up to 8, split the 64-key tiles of [0, S + C) into
//     contiguous ranges (the count chosen in chunk_prefill_attn.py's
//     launch_plan from S + C and the grid, so the grid fills the card; the
//     offsets stay on the device); the cluster's blocks merge the partials
//     (m, l, acc) over distributed shared memory, each a share of the
//     rows, the splits in order, no atomics, no scratch, no second launch,
//     so replays are bit-identical;
//   * a tile none of whose keys any row of the block may see -- empty ring
//     slots, keys after the chunk's last query, keys outside the window --
//     is skipped before it is loaded (exact: such keys would get
//     p = exp(-1e30 - m) = 0); a block with no visible tile leaves an
//     empty partial; a tile every row sees in full skips the mask;
//   * Q, K and V tiles stay bf16 in shared memory, copied in 16-byte
//     cp.async pieces, the next visible key tile in flight while the
//     current one is multiplied;
//   * each warp owns 16 query rows; QK^T and P.V run on tensor cores
//     (mma.sync m16n8k16, ldmatrix / ldmatrix.trans), P split into bf16 hi
//     + lo to keep P.V at the reference's f32 accuracy; the online softmax
//     runs in registers on the accumulator fragments.
// f32 keeps the CUDA-core kernel (TF32 would not hold 1e-4): one block per
// (lane, kv head, 64 query rows), a loop over 64-key tiles with a 4 x 4
// register tile of (query, key) scores per thread, the same tile skipping.

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma_sync.cuh"

namespace cg = cooperative_groups;

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

// f32 (CUDA cores).  Thread (ty, tx) of the 16 x 16 block owns query rows 4ty..4ty+3; for the
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

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), tiles in bf16, cp.async double
// buffer, a deterministic split of the key range over blocks
// ---------------------------------------------------------------------------

constexpr int TROWS = 64;       // query rows per block: 4 warps of 16
constexpr int TKEYS = 64;       // keys per tile
constexpr int TTHREADS = 128;
constexpr int MAX_SPLITS = 8;   // blocks of a cluster (the portable limit)

// Block (split sp of row block rb, kv head kh, lane): query rows r0 .. r0 +
// 64 of the C*G rows (C-major over G), warp w the 16 at r0 + 16w; key tiles
// [ta, tb) of the S + C keys (csrc and chunk_prefill_attn.py's
// split_ranges).  Q, K and V tiles sit in shared memory in bf16, rows of
// HDP (head_dim padded with zeros to 16, 32, 64 or 128) at a stride of HDP
// + 8 (ldmatrix without bank conflicts).  A tile no row of the block sees
// is never loaded; the next visible one is in flight while the current one
// is multiplied.  Scores and P.V are mma.sync m16n8k16 with f32 sums (the
// bf16 products exact, as the reference's f32 dot of bf16 values); P is
// split into bf16 hi + lo parts, two products, to keep P.V at f32
// accuracy.  The online softmax runs on the accumulator fragments, in
// log2 units.  splits == 1: the block writes out; else the cluster of the
// row block's splits merges their partials (below).
template <int HDP>
__global__ void __launch_bounds__(TTHREADS)
chunk_attn_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ offset,
              __nv_bfloat16* __restrict__ out, int C, int H, int KVH, int hd, int S, int pin,
              int window, int sink, int causal, float sqrt_hd, int splits) {
  constexpr int RS = HDP + 8;
  extern __shared__ __align__(16) __nv_bfloat16 tsm[];
  __shared__ int kps[2][TKEYS];                  // key positions of the two buffers' tiles
  __nv_bfloat16* qs = tsm;                       // TROWS x RS
  __nv_bfloat16* ks = qs + TROWS * RS;           // 2 x TKEYS x RS
  __nv_bfloat16* vs = ks + 2 * TKEYS * RS;       // 2 x TKEYS x RS

  const int G = H / KVH, CG = C * G, T_all = S + C;
  const int rb = blockIdx.x / splits, sp = blockIdx.x - rb * splits;
  const int r0 = rb * TROWS, kh = blockIdx.y;
  const size_t lane = blockIdx.z;
  const int off = offset[lane];
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31, g4 = ln >> 2, t4 = ln & 3;
  const int nrow = min(TROWS, CG - r0), per = hd / 8;
  const int nt_all = (T_all + TKEYS - 1) / TKEYS;
  const int ta = (int)((long long)sp * nt_all / splits);
  const int tb = (int)((long long)(sp + 1) * nt_all / splits);
  const int qmin = off + r0 / G, qmax = off + (r0 + nrow - 1) / G;

  // zero the padded head dims [hd, HDP) of every row once: never copied into
  if (hd < HDP) {
    const int pc = (HDP - hd) / 8;
    for (int i = tid; i < (TROWS + 4 * TKEYS) * pc; i += TTHREADS) {
      const int row = i / pc, c = i - row * pc;
      *reinterpret_cast<uint4*>(tsm + row * RS + hd + 8 * c) = make_uint4(0, 0, 0, 0);
    }
  }

  // Does any row of the block see a key of tile t?  If so, the tile's key
  // positions go to kps[b] (after the barrier: every thread is done with
  // the tile that buffer held) and `full` says whether every row sees every
  // key (no mask needed).
  auto tile_seen = [&](int t, int b, bool& full) {
    int p = -1, any = 0, all = 1;
    if (tid < TKEYS) {
      const int j = t * TKEYS + tid;
      p = j < T_all ? key_pos(j, off, S, pin) : -1;
      any = p >= 0 && (!causal || p <= qmax) &&
            (window <= 0 || qmin - p < window || (sink > 0 && p < sink));
      all = p >= 0 && (!causal || p <= qmin) &&
            (window <= 0 || qmax - p < window || (sink > 0 && p < sink));
    }
    if (!__syncthreads_or(any)) return false;
    if (tid < TKEYS) kps[b][tid] = p;
    full = __syncthreads_and(all) != 0;
    return true;
  };
  auto next_seen = [&](int t, int b, bool& full) {
    while (t < tb && !tile_seen(t, b, full)) ++t;
    return t;
  };
  auto load_kv = [&](int buf, int t) {
    const int j0 = t * TKEYS;
    for (int i = tid; i < TKEYS * per; i += TTHREADS) {
      const int jj = i / per, d0 = (i - jj * per) * 8, j = j0 + jj;
      const bool ok = j < T_all;
      const size_t o = ok ? ((lane * T_all + j) * KVH + kh) * (size_t)hd + d0 : 0;
      const int so = (buf * TKEYS + jj) * RS + d0;
      cp_async16(saddr(ks + so), k + o, ok);
      cp_async16(saddr(vs + so), v + o, ok);
    }
  };

  // this warp's rows and their positions (rows past CG: the last row's)
  const int row0 = r0 + 16 * warp + g4, row1 = row0 + 8;
  const int qp0 = off + min(row0, r0 + nrow - 1) / G, qp1 = off + min(row1, r0 + nrow - 1) / G;
  const bool warp_live = 16 * warp < nrow;

  // scores in log2 units (exp2 of them is exp of the reference's), the
  // running max m too
  const float sc = 1.4426950408889634f / sqrt_hd;
  float m0 = NEG_INF_F, m1 = NEG_INF_F, l0 = 0.f, l1 = 0.f;
  float o[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  bool full = false, full_nxt = false;
  int cur = next_seen(ta, 0, full);
  if (cur < tb) {
    for (int i = tid; i < TROWS * per; i += TTHREADS) {
      const int rr = i / per, d0 = (i - rr * per) * 8, row = r0 + rr;
      const bool ok = rr < nrow;
      const int c = ok ? row / G : 0, g = ok ? row - c * G : 0;
      const size_t src = ok ? ((lane * C + c) * H + kh * G + g) * (size_t)hd + d0 : 0;
      cp_async16(saddr(qs + rr * RS + d0), q + src, ok);
    }
    load_kv(0, cur);
    cp_commit();
  }
  int buf = 0;
  while (cur < tb) {
    // a barrier inside where a tile follows: tile cur - 1's reads are done
    const int nxt = next_seen(cur + 1, buf ^ 1, full_nxt);
    if (nxt < tb) {
      load_kv(buf ^ 1, nxt);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();                        // tile cur (and Q) in shared memory

    if (warp_live) {
      const __nv_bfloat16* kb = ks + buf * TKEYS * RS;
      const __nv_bfloat16* vb = vs + buf * TKEYS * RS;
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        uint32_t a[4];
        ldsm4(a, saddr(qs + (16 * warp + (ln & 15)) * RS + kk * 16 + (ln >> 4) * 8));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm4(b, saddr(kb + (np * 16 + (ln >> 4) * 8 + (ln & 7)) * RS + kk * 16 +
                         ((ln >> 3) & 1) * 8));
          mma16816(s[2 * np], a, b[0], b[1]);
          mma16816(s[2 * np + 1], a, b[2], b[3]);
        }
      }
      // scale, mask from the offset, online softmax on the fragments: this
      // thread holds rows row0 (s[n][0..1]) and row1 (s[n][2..3]) at keys
      // j0 + 8n + 2 t4 (+ 1)
      const int* kp = kps[buf];
      float mx0 = NEG_INF_F, mx1 = NEG_INF_F;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[n][e] *= sc;
          s[n][2 + e] *= sc;
          if (!full) {
            const int p = kp[8 * n + 2 * t4 + e];
            if (!visible(p, qp0, causal, window, sink)) s[n][e] = NEG_INF_F;
            if (!visible(p, qp1, causal, window, sink)) s[n][2 + e] = NEG_INF_F;
          }
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
      for (int n = 0; n < 8; ++n) {
        s[n][0] = exp2f(s[n][0] - mn0);
        s[n][1] = exp2f(s[n][1] - mn0);
        s[n][2] = exp2f(s[n][2] - mn1);
        s[n][3] = exp2f(s[n][3] - mn1);
        ps0 += s[n][0] + s[n][1];
        ps1 += s[n][2] + s[n][3];
      }
      l0 = l0 * c0 + ps0;                   // this thread's share; the quad sums at the end
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }
      // P.V over 16 keys at a time: P's A fragments from the score
      // fragments (hi, then the bf16 remainder lo), V's B fragments by
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < TKEYS / 16; ++kk) {
        uint32_t ph[4], pl[4];
        const float f[4][2] = {{s[2 * kk][0], s[2 * kk][1]}, {s[2 * kk][2], s[2 * kk][3]},
                               {s[2 * kk + 1][0], s[2 * kk + 1][1]},
                               {s[2 * kk + 1][2], s[2 * kk + 1][3]}};
#pragma unroll
        for (int i = 0; i < 4; ++i) split2(f[i][0], f[i][1], ph[i], pl[i]);
#pragma unroll
        for (int dp = 0; dp < HDP / 16; ++dp) {
          uint32_t b[4];
          ldsm4t(b, saddr(vb + (kk * 16 + (ln & 8) + (ln & 7)) * RS + dp * 16 + (ln >> 4) * 8));
          mma16816(o[2 * dp], ph, b[0], b[1]);
          mma16816(o[2 * dp + 1], ph, b[2], b[3]);
          mma16816(o[2 * dp], pl, b[0], b[1]);
          mma16816(o[2 * dp + 1], pl, b[2], b[3]);
        }
      }
    }
    cur = nxt;
    full = full_nxt;
    buf ^= 1;
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  if (splits == 1) {
    const int rows[2] = {row0, row1};
    const float ls[2] = {l0, l1};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = rows[h2];
      if (row >= CG) continue;
      const int c = row / G, g = row - c * G;
      __nv_bfloat16* dst = out + ((lane * C + c) * H + kh * G + g) * (size_t)hd;
      const float inv = fmaxf(ls[h2], 1e-30f);
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        const int d = 8 * n + 2 * t4;
        if (d < hd)
          *reinterpret_cast<uint32_t*>(dst + d) =
              pack2(o[n][2 * h2] / inv, o[n][2 * h2 + 1] / inv);
      }
    }
    return;
  }

  // splits > 1: the blocks of a row block's splits form one cluster.  Each
  // leaves its partial (acc, then m and l, of its 64 rows; an empty range
  // m = -1e30, l = 0, acc = 0) where its K / V tiles were; then block r of
  // the cluster merges rows r, r + splits, ... over distributed shared
  // memory, the splits in order: out = sum_s acc_s e_s / max(sum_s l_s e_s,
  // 1e-30), e_s = 2^(m_s - max m).
  __syncthreads();                            // every warp is done with K / V
  float* pacc = reinterpret_cast<float*>(ks);                 // TROWS x hd
  float* pml = pacc + TROWS * hd;                              // TROWS x 2
  {
    const int rr0 = 16 * warp + g4;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      const int d = 8 * n + 2 * t4;
      if (d < hd) {
        *reinterpret_cast<float2*>(pacc + rr0 * hd + d) = make_float2(o[n][0], o[n][1]);
        *reinterpret_cast<float2*>(pacc + (rr0 + 8) * hd + d) = make_float2(o[n][2], o[n][3]);
      }
    }
    if (t4 == 0) {
      *reinterpret_cast<float2*>(pml + 2 * rr0) = make_float2(m0, l0);
      *reinterpret_cast<float2*>(pml + 2 * (rr0 + 8)) = make_float2(m1, l1);
    }
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();                                  // every split's partial is in place
  const int hq = hd / 4, rank = (int)cl.block_rank();
  const int mine = (TROWS - rank + splits - 1) / splits;      // rows rank, rank + splits, ...
  for (int i = tid; i < mine * hq; i += TTHREADS) {
    const int rr = rank + splits * (i / hq), d = (i % hq) * 4, row = r0 + rr;
    if (row >= CG) continue;
    float2 e[MAX_SPLITS];
    float4 x[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)      // every remote load in flight at once
      if (r < splits) {
        e[r] = *reinterpret_cast<const float2*>(cl.map_shared_rank(pml, r) + 2 * rr);
        x[r] = *reinterpret_cast<const float4*>(cl.map_shared_rank(pacc, r) + rr * hd + d);
      }
    float mx = NEG_INF_F;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) mx = fmaxf(mx, e[r].x);
    float l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) {
        const float wgt = exp2f(e[r].x - mx);
        l += e[r].y * wgt;
        a[0] += x[r].x * wgt;
        a[1] += x[r].y * wgt;
        a[2] += x[r].z * wgt;
        a[3] += x[r].w * wgt;
      }
    const float inv = fmaxf(l, 1e-30f);
    const int c = row / G, g = row - c * G;
    __nv_bfloat16* dst = out + ((lane * C + c) * H + kh * G + g) * (size_t)hd + d;
    uint2 u;
    u.x = pack2(a[0] / inv, a[1] / inv);
    u.y = pack2(a[2] / inv, a[3] / inv);
    *reinterpret_cast<uint2*>(dst) = u;
  }
  cl.sync();                                  // every block is done reading the others
}

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, const int* offset, void* out,
              int lanes, int C, int H, int KVH, int hd, int S, int pin, int window, int sink,
              int causal, float sqrt_hd, int splits, cudaStream_t stream) {
  const int smem = (TROWS + 4 * TKEYS) * (HDP + 8) * 2;
  auto kern = chunk_attn_tc<HDP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int CG = C * (H / KVH);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((CG + TROWS - 1) / TROWS) * splits, KVH, lanes);
  cfg.blockDim = dim3(TTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                         (const __nv_bfloat16*)v, offset, (__nv_bfloat16*)out, C, H, KVH, hd, S,
                         pin, window, sink, causal, sqrt_hd, splits);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
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
// out (lanes,C,H,hd); lanes = M*B.  dt: 0 = float32 (splits must be 1),
// 1 = bfloat16: the key tiles split over a cluster of `splits` blocks
// (1 <= splits <= min(8, ceil((S+C)/64))).  Returns the first cudaError_t
// of the attribute call and the launch.
int chunk_prefill_attention(int dt, const void* q, const void* k, const void* v,
                            const void* offset, void* out, int lanes, int C, int H, int KVH,
                            int hd, int S, int pin, int window, int sink, int causal,
                            float sqrt_hd, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes < 1 || C < 1 || KVH < 1 || hd < 8 || hd > MAX_HD || hd % 8 || H % KVH || S < 0 ||
      splits < 1 || splits > MAX_SPLITS || splits > (S + C + TKEYS - 1) / TKEYS)
    return (int)cudaErrorInvalidValue;
  if (dt == 0)
    return splits != 1 ? (int)cudaErrorInvalidValue
                       : launch<float>(q, k, v, (const int*)offset, out, lanes, C, H, KVH, hd,
                                       S, pin, window, sink, causal, sqrt_hd, s);
  if (dt != 1) return (int)cudaErrorInvalidValue;
  const int* off = (const int*)offset;
  if (hd <= 16)
    return launch_tc<16>(q, k, v, off, out, lanes, C, H, KVH, hd, S, pin, window, sink, causal,
                         sqrt_hd, splits, s);
  if (hd <= 32)
    return launch_tc<32>(q, k, v, off, out, lanes, C, H, KVH, hd, S, pin, window, sink, causal,
                         sqrt_hd, splits, s);
  if (hd <= 64)
    return launch_tc<64>(q, k, v, off, out, lanes, C, H, KVH, hd, S, pin, window, sink, causal,
                         sqrt_hd, splits, s);
  return launch_tc<128>(q, k, v, off, out, lanes, C, H, KVH, hd, S, pin, window, sink, causal,
                        sqrt_hd, splits, s);
}

}  // extern "C"
