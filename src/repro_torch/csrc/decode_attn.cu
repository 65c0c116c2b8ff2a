// Single-token GQA decode attention over a prefix-valid KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attn.py (_kernel,
// via decode_attention): q (M,B,H,hd) attends over the first kv_len[m,b]
// slots of k/v (M,B,S,KVH,hd), f32 scores and softmax, f32 accumulation,
// output in q's dtype.  The hybrid family's global-attention layers run it
// in every decode step.
//
// Contract: 1 <= kv_len[m,b] <= S (the serving path appends the new token
// before it attends, kv_len = min(pos + 1, S)).  At kv_len = 0 the reference
// returns the mean of V over all S slots; this kernel is not defined there.
//
// What bounds it on this card: bytes.  Each valid K and V row is read once
// (hymba-1.5b: 64-wide heads in bf16, 256 bytes of K and V per slot and kv
// head) against 2 * G * hd FLOP per row pair, a few FLOP per byte.  The TPU
// kernel walks the slots on a sequential grid axis and carries the online
// softmax in VMEM; Hopper blocks carry nothing between them, and one block
// per (lane, kv head) -- 80 at M = B = 4, KVH = 5 -- would leave most of the
// 132 SMs idle.  So the slots are split:
//   * one block per (split of SK slots, kv head, lane); a split wholly past
//     kv_len exits at once, so a short prefix costs few blocks and no bytes;
//   * the G x hd query tile of the kv head sits in shared memory (G need not
//     be a power of two), K and V rows of the split stream through shared
//     memory in tiles of TK slots with 16-byte loads, slots at or past kv_len
//     are never loaded;
//   * each split writes its (max, sum, unnormalised P.V) in f32 and a second
//     kernel combines the splits of a (lane, head) in split order.  The order
//     is fixed, so K=1 and K=8 greedy streams agree bit for bit.

#include "common.cuh"

namespace {

constexpr int TK = 64;          // slots per shared-memory tile
constexpr int SK = 2 * TK;      // slots per split (one block)
constexpr int THREADS = 128;
constexpr int NWARP = THREADS / 32;
constexpr int MAX_G = 16;       // query heads per kv head
constexpr int MAX_HD = 128;
constexpr int MAXO = MAX_G * MAX_HD / THREADS;   // P.V outputs per thread

// Stage rows j0 .. j0 + TK of one kv head's k or v into tile (row stride
// rs floats); rows at or past je are zero and never read from memory.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, size_t slot_stride, int j0,
                                      int je, int hd, float* tile, int rs) {
  const int per = hd / 8;
  for (int i = threadIdx.x; i < TK * per; i += THREADS) {
    const int jj = i / per, d0 = (i - jj * per) * 8;
    float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (j0 + jj < je) Load8<T>::run(src + (size_t)(j0 + jj) * slot_stride + d0, v8);
#pragma unroll
    for (int e = 0; e < 8; ++e) tile[jj * rs + d0 + e] = v8[e];
  }
}

// grid: (splits, KVH, lanes).  Partials are indexed (lane, kv head, split).
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ kv_len, float* __restrict__ pmax,
                   float* __restrict__ psum, float* __restrict__ pacc, int S, int H, int KVH,
                   int hd, float sqrt_hd, int splits) {
  extern __shared__ float sm[];
  const int split = blockIdx.x, kh = blockIdx.y;
  const size_t lane = blockIdx.z;
  const int len = min(kv_len[lane], S);
  const int js = split * SK;
  if (js >= len) return;                   // past the valid prefix
  const int je = min(len, js + SK), nk = je - js;
  const int G = H / KVH, HS = hd + 1;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  float* qs = sm;                          // G x hd
  float* ks = qs + G * hd;                 // TK x HS (padded: conflict-free reads)
  float* vs = ks + TK * HS;                // TK x hd
  float* sc = vs + TK * hd;                // G x SK scores, then p
  float* stat = sc + G * SK;               // G max, G sum

  const T* qh = q + (lane * H + (size_t)kh * G) * hd;     // the G heads of kv head kh
  for (int i = tid; i < G * hd; i += THREADS) qs[i] = Ty<T>::to_f(qh[i]);
  const size_t rs = (size_t)KVH * hd;                       // slot stride
  const T* kl = k + lane * S * rs + (size_t)kh * hd;
  const T* vl = v + lane * S * rs + (size_t)kh * hd;

  // scores of the split, tile by tile
  for (int j0 = js; j0 < je; j0 += TK) {
    __syncthreads();                       // q staged / previous tile consumed
    stage(kl, rs, j0, je, hd, ks, HS);
    __syncthreads();
    for (int i = tid; i < G * TK; i += THREADS) {
      const int g = i / TK, jj = i - g * TK;
      if (j0 + jj >= je) continue;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qs[g * hd + d], ks[jj * HS + d], dot);
      sc[g * SK + j0 - js + jj] = dot / sqrt_hd;   // as ref.py: / sqrt(hd)
    }
  }
  __syncthreads();

  // softmax statistics of the split: warp w reduces heads w, w + NWARP, ...
  for (int g = warp; g < G; g += NWARP) {
    float mx = NEG_INF_F;
    for (int j = wl; j < nk; j += 32) mx = fmaxf(mx, sc[g * SK + j]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int j = wl; j < nk; j += 32) {
      const float p = expf(sc[g * SK + j] - mx);
      sc[g * SK + j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (wl == 0) {
      stat[g] = mx;
      stat[G + g] = l;
    }
  }

  // unnormalised P.V in f32, slots in order
  float acc[MAXO];
#pragma unroll
  for (int r = 0; r < MAXO; ++r) acc[r] = 0.f;
  for (int j0 = js; j0 < je; j0 += TK) {
    __syncthreads();                       // p written / previous tile consumed
    stage(vl, rs, j0, je, hd, vs, hd);
    __syncthreads();
    const int jn = min(TK, je - j0);
#pragma unroll
    for (int r = 0; r < MAXO; ++r) {
      const int i = tid + r * THREADS;
      if (i < G * hd) {
        const int g = i / hd, d = i - g * hd;
        const float* p = sc + g * SK + j0 - js;
        float a = acc[r];
        for (int jj = 0; jj < jn; ++jj) a = fmaf(p[jj], vs[jj * hd + d], a);
        acc[r] = a;
      }
    }
  }

  const size_t part = (lane * KVH + kh) * splits + split;
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

// Combine the splits that ran for each (lane, query head, d), in split
// order: rescale each split's sum and P.V by exp(max_split - max),
// normalise, round to T.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ pmax,
                                      const float* __restrict__ psum,
                                      const float* __restrict__ pacc,
                                      const int* __restrict__ kv_len, T* __restrict__ out,
                                      int lanes, int S, int H, int KVH, int hd, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;   // (lane, head, d)
  if (i >= (size_t)lanes * H * hd) return;
  const int G = H / KVH;
  const int d = (int)(i % hd);
  const int h = (int)((i / hd) % H);
  const size_t lane = i / ((size_t)H * hd);
  const int kh = h / G, g = h - kh * G;
  const int n = min((min(kv_len[lane], S) + SK - 1) / SK, splits);
  const size_t base = (lane * KVH + kh) * splits;
  float mx = NEG_INF_F;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, pmax[(base + s) * G + g]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n; ++s) {
    const float c = expf(pmax[(base + s) * G + g] - mx);
    l += psum[(base + s) * G + g] * c;
    a += pacc[((base + s) * G + g) * hd + d] * c;
  }
  out[i] = Ty<T>::from_f(a / fmaxf(l, 1e-30f));
}

int num_splits(int S) { return (S + SK - 1) / SK; }

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_len, void* out,
           float* part, long long part_elems, int lanes, int S, int H, int KVH, int hd,
           float sqrt_hd, cudaStream_t stream) {
  if (KVH < 1 || H % KVH || H / KVH > MAX_G || hd > MAX_HD || hd % 8 || S < 1)
    return (int)cudaErrorInvalidValue;
  const int G = H / KVH, splits = num_splits(S);
  const long long nrow = (long long)lanes * KVH * splits * G;
  if (nrow * (2 + hd) > part_elems) return (int)cudaErrorInvalidValue;
  const int smem = (G * hd + TK * (hd + 1) + TK * hd + G * SK + 2 * G) * 4;
  auto kern = decode_attn_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  float* pmax = part;
  float* psum = part + nrow;
  float* pacc = part + 2 * nrow;
  dim3 grid(splits, KVH, lanes);
  kern<<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, kv_len, pmax,
                                        psum, pacc, S, H, KVH, hd, sqrt_hd, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)lanes * H * hd;
  decode_combine_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      pmax, psum, pacc, kv_len, (T*)out, lanes, S, H, KVH, hd, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 elements of the split partials the wrapper allocates.
long long decode_attention_scratch_elems(int lanes, int S, int H, int KVH, int hd) {
  if (KVH < 1) return 0;
  return (long long)lanes * KVH * num_splits(S) * (H / KVH) * (2 + hd);
}

// q (lanes,H,hd), k/v (lanes,S,KVH,hd), kv_len (lanes,) int32 -> out
// (lanes,H,hd); lanes = M*B.  dt: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the two launches.
int decode_attention(int dt, const void* q, const void* k, const void* v, const void* kv_len,
                     void* out, void* part, long long part_elems, int lanes, int S, int H,
                     int KVH, int hd, float sqrt_hd, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dt == 0)
    return launch<float>(q, k, v, (const int*)kv_len, out, (float*)part, part_elems, lanes, S,
                         H, KVH, hd, sqrt_hd, s);
  if (dt == 1)
    return launch<__nv_bfloat16>(q, k, v, (const int*)kv_len, out, (float*)part, part_elems,
                                 lanes, S, H, KVH, hd, sqrt_hd, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
