// Dense decode layer and fused greedy logits for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/decode_layer.py:
//   * _layer_kernel, phase "full" (via _layer_call / decode_layer): one
//     dense decode layer for the whole (M, B) lane grid;
//   * _logits_kernel (via _logits_argmax_parts / logits_sample): final RMS
//     norm + f32 logits + greedy argmax with first-occurrence ties.
//
// What bounds them on this card: bytes.  One decode step reads every layer
// weight once per instance (tinyllama-1.1b: 88 MB per instance and layer in
// bf16) and the f32 head (262 MB per instance), against a few MFLOP per lane
// -- far below the ~295 FLOP/byte where the tensor cores would become the
// limit.  The TPU kernel keeps one lane's whole layer in VMEM; an SM's
// 227 KB cannot, so the design here streams the weights instead:
//   * every matrix product is a "lanes matvec": a block owns 256 output
//     columns of one instance and one slice of the reduction dimension,
//     and computes them for all B lanes of that instance (up to 4 per
//     block), so each weight byte is read once per instance per step, not
//     once per lane.  Each lane of a warp loads 16 bytes per weight row;
//     the reduction dimension is split over blocks as well as over the 8
//     warps of a block, so some 500 blocks keep enough loads in flight to
//     approach the HBM rate.  Partial sums are added in a fixed order by
//     a small epilogue kernel (deterministic: K=1 and K=8 greedy streams
//     agree bit for bit), which also applies bias, residual or SiLU*up;
//   * the layer runs as ten launches: rms + QKV (+bias) and its epilogue;
//     RoPE + in-place ring append at pos % S + attention per
//     (m, b, kv-head, split of the ring's slots), with keys and values
//     staged through shared memory in 64-slot tiles and empty slots never
//     read, and a kernel merging the splits; out-proj + residual;
//     rms + gate/up + SiLU*up; down-proj + residual (each with epilogue);
//   * the logits use a 64-column form of the matvec (2 columns per lane, the
//     reduction split over warps only) over V tiles, each block reducing its
//     tile to a (max, first index) per lane; a second pass walks the tiles
//     in order with a strict `>` (blocks run in no order on the card, so the
//     TPU kernel's sequential-grid carry becomes this explicit two-pass
//     reduction).  Every column's dot product has the same summation order,
//     so duplicated head columns give bit-equal logits.
// Intermediate values are rounded to the activation dtype where the plain
// PyTorch version (src/repro_torch/kernels/decode_layer.py) stores them.

#include "common.cuh"

namespace {

constexpr int NW = 8;    // warps per block; they split the reduction dim
constexpr int TN = 64;   // output columns per tile (2 per lane of a warp)
constexpr int LB = 4;    // most lanes one block computes
constexpr int THREADS = NW * 32;

enum { MODE_PLAIN = 0, MODE_RESIDUAL = 1, MODE_SWIGLU = 2 };

// Load nb lane rows of x (K wide) into xs as floats; with a norm scale,
// replace them by rms_norm(x) rounded to TX (f32 statistics).
template <typename TX>
__device__ void load_rows(const TX* __restrict__ x, const float* __restrict__ norm,
                          float eps, float* xs, float* red, int nb, int K) {
  const int tid = threadIdx.x;
  for (int i = tid; i < nb * K; i += THREADS) xs[i] = Ty<TX>::to_f(x[i]);
  if (norm == nullptr) {
    __syncthreads();
    return;
  }
  float ss[LB];
#pragma unroll
  for (int b = 0; b < LB; ++b) ss[b] = 0.f;
  __syncthreads();
#pragma unroll
  for (int b = 0; b < LB; ++b)
    if (b < nb)
      for (int k = tid; k < K; k += THREADS) ss[b] = fmaf(xs[b * K + k], xs[b * K + k], ss[b]);
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int b = 0; b < LB; ++b) {
    float v = warp_sum(ss[b]);
    if (lane == 0) red[warp * LB + b] = v;
  }
  __syncthreads();
  if (tid < LB) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += red[w * LB + tid];
    red[NW * LB + tid] = rsqrtf(s / (float)K + eps);
  }
  __syncthreads();
  for (int i = tid; i < nb * K; i += THREADS) {
    const int b = i / K, k = i - b * K;
    xs[i] = rnd<TX>((xs[i] * red[NW * LB + b]) * norm[k]);
  }
  __syncthreads();
}

// Accumulate this thread's two columns (col, col + 1) of w (K x N) against
// the nb lane rows of xs.  Warp w takes rows w, w + NW, ...
template <typename TW>
__device__ __forceinline__ void tile_accum(const TW* __restrict__ w, int K, int N, int col,
                                           const float* xs, int nb, float acc[LB][2]) {
  const int warp = threadIdx.x >> 5;
  if (col >= N) return;
  const bool vec = (N % 2) == 0;
  const bool two = col + 1 < N;
#pragma unroll 4
  for (int k = warp; k < K; k += NW) {
    const TW* p = w + (size_t)k * N + col;
    float2 wv;
    if (vec) {
      wv = Ty<TW>::pair(p);
    } else {
      wv.x = Ty<TW>::to_f(p[0]);
      wv.y = two ? Ty<TW>::to_f(p[1]) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      if (b < nb) {
        const float xv = xs[b * K + k];
        acc[b][0] = fmaf(xv, wv.x, acc[b][0]);
        acc[b][1] = fmaf(xv, wv.y, acc[b][1]);
      }
    }
  }
}

// Park per-warp partials in red[NW][LB][TN]; the caller then sums them in
// warp order (fixed, so every column adds its partials the same way).
__device__ __forceinline__ void park(float* red, const float acc[LB][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < LB; ++b) {
    red[(warp * LB + b) * TN + 2 * lane] = acc[b][0];
    red[(warp * LB + b) * TN + 2 * lane + 1] = acc[b][1];
  }
}

__device__ __forceinline__ float unpark(const float* red, int b, int c) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) s += red[(w * LB + b) * TN + c];
  return s;
}

// ---------------------------------------------------------------------------
// lanes matvec, split over the reduction dimension
// ---------------------------------------------------------------------------
//
// Block (tile, m, lane group x k-split): 8 warps split the block's k-slice,
// each lane owns VEC = 8 neighbouring output columns (one 16-byte load per
// row in bf16), so a tile is 256 columns.  Blocks of different k-slices
// write f32 partial sums; matvec_epilogue adds them in k-slice order and
// applies the rounding and the epilogue (bias / residual / SiLU*up).
constexpr int VEC = 8;
constexpr int MTN = 32 * VEC;    // columns per matvec tile

template <typename T> struct Load8;
template <> struct Load8<__nv_bfloat16> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};
template <> struct Load8<float> {
  static __device__ __forceinline__ void run(const float* p, float* o) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

// acc[b][v] += sum over rows k of this block's slice of xs[b][k] * w[k][col+v]
template <typename T>
__device__ __forceinline__ void slice_accum(const T* __restrict__ w, int N, int col, int k0,
                                            int k1, const float* xs, int nb,
                                            float acc[LB][VEC]) {
  const int warp = threadIdx.x >> 5;
  if (col >= N) return;
  const bool vec = (N % VEC) == 0;
#pragma unroll 4
  for (int k = k0 + warp; k < k1; k += NW) {
    const T* p = w + (size_t)k * N + col;
    float wv[VEC];
    if (vec) {
      Load8<T>::run(p, wv);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) wv[v] = col + v < N ? Ty<T>::to_f(p[v]) : 0.f;
    }
    const int kk = k - k0;
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      if (b < nb) {
        const float xv = xs[b * (k1 - k0) + kk];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[b][v] = fmaf(xv, wv[v], acc[b][v]);
      }
    }
  }
}

// Sum the 8 warps' accumulators (warp order) and store the block's partial.
__device__ __forceinline__ void store_partial(float* red, const float acc[LB][VEC], int nb,
                                              float* __restrict__ part, size_t row0,
                                              int nout, int colbase, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < LB; ++b)
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[(warp * LB + b) * MTN + lane * VEC + v] = acc[b][v];
  __syncthreads();
  for (int i = threadIdx.x; i < nb * MTN; i += THREADS) {
    const int b = i / MTN, c = i - b * MTN;
    if (colbase + c >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[(w * LB + b) * MTN + c];
    part[(row0 + b) * nout + colbase + c] = s;
  }
  __syncthreads();
}

// grid: (tiles, M, lane groups * ksplit).  part: (ksplit, nch, M, B, nout)
// f32 with nch = 2 for MODE_SWIGLU (gate, up), else 1.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
matvec_partial_kernel(const T* __restrict__ x, const float* __restrict__ norm, float eps,
                      const T* __restrict__ w0, const T* __restrict__ w1,
                      const T* __restrict__ w2, int n0, int n1, int n2, float* __restrict__ part,
                      int M, int B, int K, int lanes_per_block, int ksplit, int kchunk) {
  extern __shared__ float smem[];
  const int m = blockIdx.y;
  const int group = blockIdx.z / ksplit, ks = blockIdx.z - group * ksplit;
  const int lane0 = group * lanes_per_block;
  const int nb = min(lanes_per_block, B - lane0);
  const int k0 = ks * kchunk, k1 = min(K, k0 + kchunk);
  const int nch = MODE == MODE_SWIGLU ? 2 : 1;
  const int nout = MODE == MODE_PLAIN ? n0 + n1 + n2 : n0;
  float* xs = smem;                         // nb x (k1 - k0)
  float* red = smem + lanes_per_block * kchunk;
  float* stat = red + NW * LB * MTN;        // (NW + 1) x LB
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)m * B + lane0;
  const int kw = k1 - k0;

  // this block's slice of the lanes' rows (rms-normalised when norm is set:
  // the statistic needs the whole row, the slice only its part)
  float inv[LB];
#pragma unroll
  for (int b = 0; b < LB; ++b) inv[b] = 1.f;
  if (norm != nullptr) {
    float ss[LB];
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      ss[b] = 0.f;
      if (b < nb)
        for (int k = tid; k < K; k += THREADS) {
          const float v = Ty<T>::to_f(x[(row0 + b) * K + k]);
          ss[b] = fmaf(v, v, ss[b]);
        }
    }
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int b = 0; b < LB; ++b) {
      const float v = warp_sum(ss[b]);
      if (lane == 0) stat[warp * LB + b] = v;
    }
    __syncthreads();
    if (tid < LB) {
      float s = 0.f;
      for (int w = 0; w < NW; ++w) s += stat[w * LB + tid];
      stat[NW * LB + tid] = rsqrtf(s / (float)K + eps);
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < LB; ++b) inv[b] = stat[NW * LB + b];
  }
  for (int i = tid; i < nb * kw; i += THREADS) {
    const int b = i / kw, k = k0 + i - b * kw;
    const float v = Ty<T>::to_f(x[(row0 + b) * K + k]);
    xs[i] = norm != nullptr ? rnd<T>((v * inv[b]) * norm[(size_t)m * K + k]) : v;
  }
  __syncthreads();

  int tile = blockIdx.x;
  const T* w = w0;
  int N = n0, out_off = 0;
  if (MODE == MODE_PLAIN) {
    const int t0 = (n0 + MTN - 1) / MTN, t1 = (n1 + MTN - 1) / MTN;
    if (tile >= t0 + t1) {
      tile -= t0 + t1; w = w2; N = n2; out_off = n0 + n1;
    } else if (tile >= t0) {
      tile -= t0; w = w1; N = n1; out_off = n0;
    }
  }
  const int col = tile * MTN + VEC * (tid & 31);
  for (int ch = 0; ch < nch; ++ch) {
    const T* wc = ch == 0 ? w : w1;
    float acc[LB][VEC];
#pragma unroll
    for (int b = 0; b < LB; ++b)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[b][v] = 0.f;
    slice_accum<T>(wc + (size_t)m * K * N, N, col, k0, k1, xs, nb, acc);
    float* pc = part + ((size_t)(ks * nch + ch) * M) * B * nout;
    // store_partial indexes columns within this segment; shift to the
    // segment's place in the output row
    store_partial(red, acc, nb, pc + out_off, row0, nout, tile * MTN, N);
  }
}

// Sum the k-slices in order, round where the plain version rounds, apply
// the epilogue.  One thread per output element of (M, B, nout).
template <typename T, int MODE>
__global__ void matvec_epilogue_kernel(const float* __restrict__ part, int ksplit, int M, int B,
                                       int n0, int n1, int n2, const T* __restrict__ b0,
                                       const T* __restrict__ b1, const T* __restrict__ b2,
                                       const T* __restrict__ res, T* __restrict__ out) {
  const int nout = MODE == MODE_PLAIN ? n0 + n1 + n2 : n0;
  const size_t total = (size_t)M * B * nout;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int nch = MODE == MODE_SWIGLU ? 2 : 1;
  float s = 0.f, s2 = 0.f;
  for (int ks = 0; ks < ksplit; ++ks) {
    s += part[(size_t)(ks * nch) * total + i];
    if (MODE == MODE_SWIGLU) s2 += part[(size_t)(ks * nch + 1) * total + i];
  }
  float y = rnd<T>(s);
  if (MODE == MODE_PLAIN) {
    const int col = (int)(i % nout);
    const int m = (int)(i / ((size_t)B * nout));
    const T* bias = col < n0 ? b0 : col < n0 + n1 ? b1 : b2;
    const int bc = col < n0 ? col : col < n0 + n1 ? col - n0 : col - n0 - n1;
    const int bn = col < n0 ? n0 : col < n0 + n1 ? n1 : n2;
    if (bias != nullptr) y = rnd<T>(y + Ty<T>::to_f(bias[(size_t)m * bn + bc]));
  } else if (MODE == MODE_RESIDUAL) {
    y = rnd<T>(Ty<T>::to_f(res[i]) + y);
  } else {
    const float u = rnd<T>(s2);
    const float sl = rnd<T>(y / (1.f + expf(-y)));
    y = rnd<T>(sl * u);
  }
  out[i] = Ty<T>::from_f(y);
}

// RoPE at pos, in-place ring append at slot pos % S (skipped for lanes whose
// alive flag is 0), then decode attention of the G query heads of one kv
// head over one split of the ring's slots.  grid: (KVH, B, M * splits).
// Keys and values stream through shared memory in tiles of AT slots
// (coalesced 16-byte loads); a tile with no valid slot is not read.  Each
// split writes its (max, sum, unnormalised P.V) and ring_combine_kernel
// merges the splits in order.  Only split 0 appends; every split reads the
// new token's key and value from shared memory, never from the ring.
constexpr int AT = 64;

template <typename T>
__global__ void __launch_bounds__(THREADS)
ring_attn_kernel(const T* __restrict__ qkv, T* __restrict__ ck, T* __restrict__ cv,
                 const int* __restrict__ pos_arr, const uint8_t* __restrict__ alive,
                 float* __restrict__ pmax, float* __restrict__ psum,
                 float* __restrict__ pacc, int B, int S, int H, int KVH, int hd,
                 float neg_log_theta, int use_rope, int window, float scale, int splits,
                 int sk) {
  extern __shared__ float sm[];
  const int kh = blockIdx.x, b = blockIdx.y;
  const int m = blockIdx.z / splits, split = blockIdx.z - m * splits;
  const int js = split * sk, je = min(S, js + sk);
  const int G = H / KVH;
  const int tid = threadIdx.x;
  const size_t li = (size_t)m * B + b;
  const int pos = pos_arr[li];
  const int HS = hd + 1;
  float* qs = sm;               // G * hd
  float* kn = qs + G * hd;      // hd
  float* vn = kn + hd;          // hd
  float* stat = vn + hd;        // 2 * G: max, sum
  float* tl = stat + 2 * G;     // AT * HS: the current key or value tile
  float* sc = tl + AT * HS;     // G * sk, slots js.. of this split

  const T* row = qkv + li * (size_t)(H + 2 * KVH) * hd;
  for (int i = tid; i < G * hd; i += THREADS) qs[i] = Ty<T>::to_f(row[kh * G * hd + i]);
  for (int i = tid; i < hd; i += THREADS) {
    kn[i] = Ty<T>::to_f(row[H * hd + kh * hd + i]);
    vn[i] = Ty<T>::to_f(row[(H + KVH) * hd + kh * hd + i]);
  }
  __syncthreads();
  if (use_rope) {
    const int half = hd / 2;
    for (int i = tid; i < (G + 1) * half; i += THREADS) {
      const int h = i / half, d = i - h * half;
      float* v = h < G ? qs + h * hd : kn;
      const float freq = expf((neg_log_theta * (float)d) / (float)half);
      const float ang = (float)pos * freq;
      const float c = rnd<T>(cosf(ang)), s = rnd<T>(sinf(ang));
      const float x1 = v[d], x2 = v[d + half];
      v[d] = rnd<T>(rnd<T>(x1 * c) - rnd<T>(x2 * s));
      v[d + half] = rnd<T>(rnd<T>(x2 * c) + rnd<T>(x1 * s));
    }
    __syncthreads();
  }

  const int slot = pos % S;
  const size_t rs = (size_t)KVH * hd;                  // ring slot stride
  T* ckl = ck + li * S * rs + kh * hd;
  T* cvl = cv + li * S * rs + kh * hd;
  if (split == 0 && (alive == nullptr || alive[li])) {
    for (int i = tid; i < hd; i += THREADS) {
      ckl[slot * rs + i] = Ty<T>::from_f(kn[i]);
      cvl[slot * rs + i] = Ty<T>::from_f(vn[i]);
    }
  }

  // validity of ring slot j after writing pos (cache_slot_positions + window)
  const int base = pos - slot;
  auto valid = [&](int j) {
    const int p = j <= slot ? base + j : base - S + j;
    return p >= 0 && (window <= 0 || pos - p < window);
  };
  // stage rows j0.. of a ring (the new token's row from kn / vn) into tl
  auto stage = [&](const T* ring, const float* fresh, int j0) {
    const int per = hd / VEC;                          // 16-byte chunks per row
    for (int i = tid; i < AT * per; i += THREADS) {
      const int jj = i / per, d0 = (i - jj * per) * VEC;
      const int j = j0 + jj;
      float v8[VEC];
      if (j >= je || !valid(j)) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) v8[v] = 0.f;
      } else if (j == slot) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) v8[v] = fresh[d0 + v];
      } else {
        Load8<T>::run(ring + j * rs + d0, v8);
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) tl[jj * HS + d0 + v] = v8[v];
    }
  };
  auto tile_live = [&](int j0) {
    int any = 0;
    if (tid < AT) any = j0 + tid < je && valid(j0 + tid);
    return __syncthreads_or(any);
  };

  // scores, tile by tile
  for (int j0 = js; j0 < je; j0 += AT) {
    if (!tile_live(j0)) {
      for (int i = tid; i < G * AT; i += THREADS) {
        const int g = i / AT, j = j0 + i - g * AT;
        if (j < je) sc[g * sk + j - js] = NEG_INF_F;
      }
      continue;
    }
    stage(ckl, kn, j0);
    __syncthreads();
    for (int i = tid; i < G * AT; i += THREADS) {
      const int g = i / AT, jj = i - g * AT, j = j0 + jj;
      if (j >= je) continue;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qs[g * hd + d], tl[jj * HS + d], dot);
      sc[g * sk + j - js] = valid(j) ? dot * scale : NEG_INF_F;
    }
    __syncthreads();
  }

  // softmax statistics: warp w reduces heads w, w + NW, ...
  const int warp = tid >> 5, lane = tid & 31;
  const int nk = je - js;
  for (int g = warp; g < G; g += NW) {
    float mx = NEG_INF_F;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, sc[g * sk + j]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float p = expf(sc[g * sk + j] - mx);
      sc[g * sk + j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      stat[g] = mx;
      stat[G + g] = l;
    }
  }
  __syncthreads();

  // P.V with p rounded to V's dtype, f32 accumulation in slot order; an
  // invalid slot has p = 0 and a zero row, adding nothing
  constexpr int MAXO = 16 * 128 / THREADS;
  float acc[MAXO];
#pragma unroll
  for (int r = 0; r < MAXO; ++r) acc[r] = 0.f;
  for (int j0 = js; j0 < je; j0 += AT) {
    if (!tile_live(j0)) continue;
    stage(cvl, vn, j0);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAXO; ++r) {
      const int i = tid + r * THREADS;
      if (i < G * hd) {
        const int g = i / hd, d = i - g * hd;
        const int jn = min(AT, je - j0);
        float a = acc[r];
        for (int jj = 0; jj < jn; ++jj)
          a = fmaf(rnd<T>(sc[g * sk + j0 - js + jj]), tl[jj * HS + d], a);
        acc[r] = a;
      }
    }
    __syncthreads();
  }
  const size_t part = (li * KVH + kh) * splits + split;     // (lane, kv head, split)
#pragma unroll
  for (int r = 0; r < MAXO; ++r) {
    const int i = tid + r * THREADS;
    if (i < G * hd) pacc[part * G * hd + i] = acc[r];
  }
  if (tid < G) {
    pmax[part * G + tid] = stat[tid];
    psum[part * G + tid] = stat[G + tid];
  }
}

// Merge the splits of each (lane, query head) in split order: rescale each
// split's sum and P.V by exp(max_split - max), normalise, round to T.
template <typename T>
__global__ void ring_combine_kernel(const float* __restrict__ pmax, const float* __restrict__ psum,
                                    const float* __restrict__ pacc, T* __restrict__ out,
                                    int lanes, int H, int KVH, int hd, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;   // (lane, head, d)
  if (i >= (size_t)lanes * H * hd) return;
  const int G = H / KVH;
  const int d = (int)(i % hd);
  const int h = (int)((i / hd) % H);
  const size_t li = i / ((size_t)H * hd);
  const int kh = h / G, g = h - kh * G;
  const size_t base = (li * KVH + kh) * splits;
  float mx = NEG_INF_F;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, pmax[(base + s) * G + g]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float c = expf(pmax[(base + s) * G + g] - mx);
    l += psum[(base + s) * G + g] * c;
    a += pacc[((base + s) * G + g) * hd + d] * c;
  }
  out[i] = Ty<T>::from_f(a / fmaxf(l, 1e-30f));
}

// Pass 1 of the greedy logits: per (V tile, instance, lane group), the
// lanes' rms-normed rows against tiles_per_block consecutive 64-column
// tiles of the head, each reduced to (max, first index) per lane.
template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS)
logits_partial_kernel(const TX* __restrict__ x, const float* __restrict__ norm, float eps,
                      const TW* __restrict__ head, float* __restrict__ pval,
                      int* __restrict__ pidx, int B, int K, int V, int ntiles,
                      int tiles_per_block, int lanes_per_block) {
  extern __shared__ float smem[];
  const int m = blockIdx.y;
  const int lane0 = blockIdx.z * lanes_per_block;
  const int nb = min(lanes_per_block, B - lane0);
  float* xs = smem;
  float* red = smem + lanes_per_block * K;
  float* lg = red + NW * LB * TN;     // LB * TN logits of the tile
  const size_t row0 = (size_t)m * B + lane0;
  load_rows<TX>(x + row0 * K, norm + (size_t)m * K, eps, xs, red, nb, K);
  const TW* hm = head + (size_t)m * K * V;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int t = 0; t < tiles_per_block; ++t) {
    const int tile = blockIdx.x * tiles_per_block + t;
    if (tile >= ntiles) break;
    float acc[LB][2];
#pragma unroll
    for (int b = 0; b < LB; ++b) acc[b][0] = acc[b][1] = 0.f;
    tile_accum<TW>(hm, K, V, tile * TN + 2 * lane, xs, nb, acc);
    park(red, acc);
    __syncthreads();
    for (int i = threadIdx.x; i < nb * TN; i += THREADS) {
      const int b = i / TN, c = i - b * TN;
      lg[i] = unpark(red, b, c);
    }
    __syncthreads();
    if (warp < nb) {
      // lane holds columns 2*lane, 2*lane+1; the earlier index wins ties
      float best = NEG_INF_F;
      int bi = 0x7fffffff;
      for (int c = 2 * lane; c < 2 * lane + 2; ++c) {
        const int col = tile * TN + c;
        if (col < V) {
          const float v = lg[warp * TN + c];
          if (v > best || (v == best && col < bi)) {
            best = v;
            bi = col;
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > best || (ov == best && oi < bi)) {
          best = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        pval[(row0 + warp) * ntiles + tile] = best;
        pidx[(row0 + warp) * ntiles + tile] = bi;
      }
    }
    __syncthreads();
  }
}

// Pass 2: walk each lane's tiles in order, strict `>` keeping the earliest
// tile's max -- with the first index inside a tile, exactly argmax's ties.
__global__ void logits_reduce_kernel(const float* __restrict__ pval, const int* __restrict__ pidx,
                                     int lanes, int ntiles, int* __restrict__ tok,
                                     float* __restrict__ val) {
  const int li = blockIdx.x * blockDim.x + threadIdx.x;
  if (li >= lanes) return;
  float best = NEG_INF_F;
  int bi = 0;
  for (int t = 0; t < ntiles; ++t) {
    const float v = pval[(size_t)li * ntiles + t];
    if (v > best) {
      best = v;
      bi = pidx[(size_t)li * ntiles + t];
    }
  }
  tok[li] = bi;
  val[li] = best;
}

// Column tiles of a matvec call, and how many k-slices it is split into:
// about four blocks per SM, each warp keeping at least 8 rows of its slice.
int matvec_tiles(int mode, int n0, int n1, int n2) {
  return (n0 + MTN - 1) / MTN + (mode == MODE_PLAIN ? (n1 + MTN - 1) / MTN + (n2 + MTN - 1) / MTN : 0);
}

int matvec_ksplit(int tiles, int M, int B, int K) {
  const int groups = (B + LB - 1) / LB;
  const int blocks = tiles * M * groups;
  int ksplit = (528 + blocks - 1) / blocks;
  const int kmax = K / (NW * 8) > 1 ? K / (NW * 8) : 1;
  ksplit = ksplit < kmax ? ksplit : kmax;
  return ksplit < 1 ? 1 : ksplit;
}

template <typename T, int MODE>
int launch_matvec(const void* x, const void* norm, float eps, const void* w0, const void* w1,
                  const void* w2, const void* b0, const void* b1, const void* b2, int n0,
                  int n1, int n2, const void* res, void* out, void* part, int part_elems,
                  int M, int B, int K, cudaStream_t stream) {
  const int red_bytes = (NW * LB * MTN + (NW + 1) * LB) * 4;
  const int lpb = B < LB ? B : LB;
  const int groups = (B + lpb - 1) / lpb;
  const int tiles = matvec_tiles(MODE, n0, n1, n2);
  const int ksplit = matvec_ksplit(tiles, M, B, K);
  const int kchunk = (K + ksplit - 1) / ksplit;
  const int smem = lpb * kchunk * 4 + red_bytes;
  const int nch = MODE == MODE_SWIGLU ? 2 : 1;
  const int nout = MODE == MODE_PLAIN ? n0 + n1 + n2 : n0;
  if (smem > MAX_SMEM || (long long)ksplit * nch * M * B * nout > part_elems)
    return (int)cudaErrorInvalidValue;
  auto kern = matvec_partial_kernel<T, MODE>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(tiles, M, groups * ksplit);
  kern<<<grid, THREADS, smem, stream>>>((const T*)x, (const float*)norm, eps, (const T*)w0,
                                        (const T*)w1, (const T*)w2, n0, n1, n2, (float*)part,
                                        M, B, K, lpb, ksplit, kchunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)M * B * nout;
  matvec_epilogue_kernel<T, MODE><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      (const float*)part, ksplit, M, B, n0, n1, n2, (const T*)b0, (const T*)b1, (const T*)b2,
      (const T*)res, (T*)out);
  return (int)cudaGetLastError();
}

// Slot splits of the decode attention: enough blocks to fill the card
// (about two per SM), at least two key tiles per split.
int attn_splits(int M, int B, int S, int KVH) {
  const int blocks = M * B * KVH;
  int splits = (264 + blocks - 1) / blocks;
  const int most = (S + 2 * AT - 1) / (2 * AT);
  splits = splits < most ? splits : most;
  return splits < 1 ? 1 : splits;
}

template <typename T>
int launch_attn(const void* qkv, void* ck, void* cv, const int* pos, const uint8_t* alive,
                void* out, float* part, long long part_elems, int M, int B, int S, int H,
                int KVH, int hd, float neg_log_theta, int use_rope, int window, float scale,
                cudaStream_t stream) {
  const int G = H / KVH;
  if (G > 16 || hd > 128 || hd % VEC) return (int)cudaErrorInvalidValue;
  const int splits = attn_splits(M, B, S, KVH);
  const int sk = ((S + splits - 1) / splits + AT - 1) / AT * AT;
  const size_t smem =
      ((size_t)G * hd + 2 * hd + 2 * G + (size_t)AT * (hd + 1) + (size_t)G * sk) * 4;
  const long long nrow = (long long)M * B * KVH * splits * G;
  if (smem > (size_t)MAX_SMEM || nrow * (2 + hd) > part_elems) return (int)cudaErrorInvalidValue;
  auto kern = ring_attn_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  float* pmax = part;
  float* psum = part + nrow;
  float* pacc = part + 2 * nrow;
  dim3 grid(KVH, B, M * splits);
  kern<<<grid, THREADS, smem, stream>>>((const T*)qkv, (T*)ck, (T*)cv, pos, alive, pmax, psum,
                                        pacc, B, S, H, KVH, hd, neg_log_theta, use_rope,
                                        window, scale, splits, sk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)M * B * H * hd;
  ring_combine_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      pmax, psum, pacc, (T*)out, M * B, H, KVH, hd, splits);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int launch_logits(const void* x, const float* norm, float eps, const void* head, float* pval,
                  int* pidx, int* tok, float* val, int M, int B, int K, int V,
                  cudaStream_t stream) {
  const int ntiles = (V + TN - 1) / TN;
  const int red_bytes = NW * LB * TN * 4 + LB * TN * 4 + (NW + 1) * LB * 4;
  int lpb = (MAX_SMEM - red_bytes) / (K * 4);
  lpb = lpb < LB ? lpb : LB;
  lpb = lpb < B ? lpb : B;
  if (lpb < 1) return (int)cudaErrorInvalidValue;
  const int groups = (B + lpb - 1) / lpb;
  // about four blocks per SM; each block amortises its row load over tiles
  int tpb = (ntiles * M * groups + 527) / 528;
  tpb = tpb < 1 ? 1 : tpb;
  const int smem = lpb * K * 4 + red_bytes;
  auto kern = logits_partial_kernel<TX, TW>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((ntiles + tpb - 1) / tpb, M, groups);
  kern<<<grid, THREADS, smem, stream>>>((const TX*)x, norm, eps, (const TW*)head, pval, pidx, B,
                                        K, V, ntiles, tpb, lpb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int lanes = M * B;
  logits_reduce_kernel<<<(lanes + 127) / 128, 128, 0, stream>>>(pval, pidx, lanes, ntiles, tok, val);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes).  dt: 0 = float32, 1 = bfloat16.  Every entry point
// returns cudaGetLastError() after its launches; the wrapper raises on != 0.
// ---------------------------------------------------------------------------

extern "C" {

// mode 0: out (M,B,n0+n1+n2) = [x@w0 (+b0), x@w1 (+b1), x@w2 (+b2)]
// mode 1: out (M,B,n0) = res + x@w0
// mode 2: out (M,B,n0) = silu(x@w0) * (x@w1)
// x is rms-normalised with norm (M,K) f32 first when norm is not null.
// f32 scratch elements lanes_matvec needs for its k-split partial sums.
int matvec_scratch_elems(int mode, int n0, int n1, int n2, int M, int B, int K) {
  const int nout = mode == MODE_PLAIN ? n0 + n1 + n2 : n0;
  const int ksplit = matvec_ksplit(matvec_tiles(mode, n0, n1, n2), M, B, K);
  return ksplit * (mode == MODE_SWIGLU ? 2 : 1) * M * B * nout;
}

// part: f32 scratch of part_elems elements for the k-split partial sums
// (matvec_scratch_elems gives the size a call needs).
int lanes_matvec(int dt, int mode, const void* x, const void* norm, float eps, const void* w0,
                 const void* w1, const void* w2, const void* b0, const void* b1, const void* b2,
                 int n0, int n1, int n2, const void* res, void* out, void* part, int part_elems,
                 int M, int B, int K, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define MV(T, MODE)                                                                         \
  launch_matvec<T, MODE>(x, norm, eps, w0, w1, w2, b0, b1, b2, n0, n1, n2, res, out, part, \
                         part_elems, M, B, K, s)
  if (dt == 0) {
    if (mode == MODE_PLAIN) return MV(float, MODE_PLAIN);
    if (mode == MODE_RESIDUAL) return MV(float, MODE_RESIDUAL);
    if (mode == MODE_SWIGLU) return MV(float, MODE_SWIGLU);
  } else if (dt == 1) {
    if (mode == MODE_PLAIN) return MV(__nv_bfloat16, MODE_PLAIN);
    if (mode == MODE_RESIDUAL) return MV(__nv_bfloat16, MODE_RESIDUAL);
    if (mode == MODE_SWIGLU) return MV(__nv_bfloat16, MODE_SWIGLU);
  }
#undef MV
  return (int)cudaErrorInvalidValue;
}

// f32 scratch elements ring_attention needs for its split partials.
long long ring_attention_scratch_elems(int M, int B, int S, int H, int KVH, int hd) {
  return (long long)M * B * KVH * attn_splits(M, B, S, KVH) * (H / KVH) * (2 + hd);
}

int ring_attention(int dt, const void* qkv, void* ck, void* cv, const void* pos,
                   const void* alive, void* out, void* part, long long part_elems, int M, int B,
                   int S, int H, int KVH, int hd, float neg_log_theta, int use_rope, int window,
                   float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dt == 0)
    return launch_attn<float>(qkv, ck, cv, (const int*)pos, (const uint8_t*)alive, out,
                              (float*)part, part_elems, M, B, S, H, KVH, hd, neg_log_theta,
                              use_rope, window, scale, s);
  if (dt == 1)
    return launch_attn<__nv_bfloat16>(qkv, ck, cv, (const int*)pos, (const uint8_t*)alive, out,
                                      (float*)part, part_elems, M, B, S, H, KVH, hd,
                                      neg_log_theta, use_rope, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// pval/pidx: scratch of M*B*ceil(V/64) entries.
int logits_argmax(int dt_x, int dt_w, const void* x, const void* norm, float eps,
                  const void* head, void* pval, void* pidx, void* tok, void* val, int M, int B,
                  int K, int V, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define LG(TX, TW)                                                                         \
  launch_logits<TX, TW>(x, (const float*)norm, eps, head, (float*)pval, (int*)pidx, (int*)tok, \
                        (float*)val, M, B, K, V, s)
  if (dt_x == 0 && dt_w == 0) return LG(float, float);
  if (dt_x == 1 && dt_w == 0) return LG(__nv_bfloat16, float);
  if (dt_x == 0 && dt_w == 1) return LG(float, __nv_bfloat16);
  if (dt_x == 1 && dt_w == 1) return LG(__nv_bfloat16, __nv_bfloat16);
#undef LG
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
