// Per-page attention partials read straight out of a paged KV pool: the
// body of the speculative-verify kernel (paged_verify.cu, B4, S = 2 ..
// spec_len + 1).  Paged decode (B1, S = 1) runs on decode_walk.cuh.
//
// One block per (row b, page slot j, kv head).  The block resolves its
// physical page through the block table itself (the TPU kernels did that
// in a scalar-prefetch index_map), stages the page's K/V head slice
// (bs x D) in shared memory as f32, and scores the S * G query rows of
// its kv head against it, one warp per query row.  Each row emits the
// unnormalized partial (o, l, m) of this page; the exact softmax over all
// pages is reconstructed afterwards by combine_partials.
//
// int8 pools (the int8-KV serving path) carry one f32 scale per (token
// entry, kv head) in two scale pools.  The pool element type TK is a
// template parameter of its own: an int8 page converts to f32 as it is
// staged (sixteen values per 16-byte load), its scales are staged beside
// it, and they fold in where the JAX kernel folds them: the K scale
// multiplies the score after * scale and before the soft cap, l is summed
// from p before the V scale multiplies p ahead of the PV product.
//
// Bound on the H100: bytes.  Each page's K/V are read once per kv head
// and each query row does 4 * bs * D flops against them, far below the
// card's ~295 flop/byte ridge.  This first design reads every page in
// place (no gathered linear view, no second pass over the pool) and writes
// one small partial per (page, row); dead table entries skip the page read
// (and its scales) entirely.  The page's rows are staged in 16-byte words
// (common.cuh stage_kv) where the head_dim and alignment allow.  Not yet
// done: several pages per block to amortize the partial writes, TMA.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kPageWarps = 4;
constexpr int kPageThreads = 32 * kPageWarps;
constexpr int kPageMaxD = 256;   // head_dim limit (q row in registers)
constexpr int kPageMaxBs = 64;   // page size limit (two keys per lane)

inline size_t page_partials_smem(int bs, int D, bool quant) {
  return (2 * static_cast<size_t>(bs) * D + kPageWarps * bs +
          (quant ? 2 * bs : 0)) * sizeof(float) + bs * sizeof(int);
}

// q: (B, S, H, D); k/v_pages: (P, bs, KV, D) of TK (T, or int8 with
// k/v_scale (P, bs, KV) f32; null otherwise); pos_pages: (P, bs);
// tables: (B, nb) (-1 = dead); pos_q: (B, S) absolute query positions.
// o: (B, nb, S, H, D) f32; l, m: (B, nb, S, H) f32.
// Tag is an empty type named after the entry point that launches the
// kernel (PagedVerify), so the kernel symbol names it in a trace; the int8
// instantiations differ from the others in TK.
template <typename T, typename TK, typename Tag>
__global__ void __launch_bounds__(kPageThreads)
page_partials_kernel(const T* __restrict__ q, const TK* __restrict__ k_pages,
                     const TK* __restrict__ v_pages,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int* __restrict__ pos_pages,
                     const int* __restrict__ tables,
                     const int* __restrict__ pos_q, float* __restrict__ o,
                     float* __restrict__ l, float* __restrict__ m, int S,
                     int H, int KV, int D, int bs, int nb, float scale,
                     int window, float soft_cap, int vec) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // (bs, D)
  float* vs = ks + bs * D;             // (bs, D)
  float* probs = vs + bs * D;          // (warps, bs)
  float* ksc = probs + kPageWarps * bs;            // (bs,) int8 pools only
  float* vsc = ksc + (kQuant ? bs : 0);            // (bs,)
  int* pos = reinterpret_cast<int*>(vsc + (kQuant ? bs : 0));   // (bs,)

  const int b = blockIdx.x, j = blockIdx.y, kvh = blockIdx.z;
  const int G = H / KV;
  const int rows = S * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int page = tables[static_cast<size_t>(b) * nb + j];

  if (page < 0) {
    // Dead entry: the all-masked partial (o = 0, l = 0, m = NEG_INF),
    // exactly what scoring the scratch page under the table mask gives.
    for (int r = warp; r < rows; r += kPageWarps) {
      const int s = r / G, h = kvh * G + r % G;
      const size_t row = ((static_cast<size_t>(b) * nb + j) * S + s) * H + h;
      for (int d = lane; d < D; d += 32) o[row * D + d] = 0.f;
      if (lane == 0) {
        l[row] = 0.f;
        m[row] = NEG_INF;
      }
    }
    return;
  }

  const size_t page_base = static_cast<size_t>(page) * bs;
  const size_t head0 = (page_base * KV + kvh) * D;
  stage_kv(k_pages + head0, v_pages + head0, static_cast<size_t>(KV) * D,
           bs, D, ks, vs, vec != 0, kPageThreads);
  for (int t = threadIdx.x; t < bs; t += kPageThreads) {
    pos[t] = pos_pages[page_base + t];
    if constexpr (kQuant) {
      ksc[t] = k_scale[(page_base + t) * KV + kvh];
      vsc[t] = v_scale[(page_base + t) * KV + kvh];
    }
  }
  __syncthreads();

  float* pw = probs + warp * bs;
  for (int r = warp; r < rows; r += kPageWarps) {
    const int s = r / G, h = kvh * G + r % G;
    const int pq = pos_q[static_cast<size_t>(b) * S + s];
    const T* qrow = q + ((static_cast<size_t>(b) * S + s) * H + h) * D;
    float qr[kPageMaxD / 32];
#pragma unroll
    for (int i = 0; i < kPageMaxD / 32; ++i) {
      const int d = lane + 32 * i;
      qr[i] = d < D ? to_f32(qrow[d]) : 0.f;
    }
    // masked scores; lane t keeps key t, lane t also keeps key t + 32
    float s_lo = NEG_INF, s_hi = NEG_INF;
    for (int t = 0; t < bs; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kPageMaxD / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc += qr[i] * ks[t * D + d];
      }
      acc = warp_sum(acc) * scale;
      if constexpr (kQuant) acc *= ksc[t];
      acc = cap_score(acc, soft_cap);
      acc = key_visible(pos[t], pq, window) ? acc : NEG_INF;
      if (t == lane) s_lo = acc;
      if (t == lane + 32) s_hi = acc;
    }
    const bool ok_lo = lane < bs && key_visible(pos[lane], pq, window);
    const bool ok_hi =
        lane + 32 < bs && key_visible(pos[lane + 32], pq, window);
    const float mx = warp_max(fmaxf(s_lo, s_hi));
    // p is zeroed by the mask after exp: a fully masked page gives l = 0
    const float p_lo = ok_lo ? expf(s_lo - mx) : 0.f;
    const float p_hi = ok_hi ? expf(s_hi - mx) : 0.f;
    const float lsum = warp_sum(p_lo + p_hi);   // l before the V scale
    if (lane < bs) pw[lane] = kQuant ? p_lo * vsc[lane] : p_lo;
    if (lane + 32 < bs) pw[lane + 32] = kQuant ? p_hi * vsc[lane + 32] : p_hi;
    __syncwarp();
    const size_t row = ((static_cast<size_t>(b) * nb + j) * S + s) * H + h;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int t = 0; t < bs; ++t) acc += pw[t] * vs[t * D + d];
      o[row * D + d] = acc;
    }
    if (lane == 0) {
      l[row] = lsum;
      m[row] = mx;
    }
    __syncwarp();   // pw is rewritten by this warp's next row
  }
}

template <typename T, typename TK, typename Tag>
cudaError_t launch_page_partials(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scale,
                                 const void* v_scale, const void* pos_pages,
                                 const void* tables, const void* pos_q,
                                 void* o, void* l, void* m, int B, int S,
                                 int H, int KV, int D, int bs, int nb,
                                 float scale, int window, float soft_cap,
                                 cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  if (B <= 0 || nb <= 0 || S <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || D > kPageMaxD || bs <= 0 ||
      bs > kPageMaxBs || nb > 65535 || KV > 65535 ||
      (kQuant && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  const size_t smem = page_partials_smem(bs, D, kQuant);
  cudaError_t err = allow_smem(page_partials_kernel<T, TK, Tag>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, nb, KV);
  page_partials_kernel<T, TK, Tag><<<grid, kPageThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TK*>(k_pages),
      static_cast<const TK*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(pos_pages),
      static_cast<const int*>(tables), static_cast<const int*>(pos_q),
      static_cast<float*>(o), static_cast<float*>(l), static_cast<float*>(m),
      S, H, KV, D, bs, nb, scale, window, soft_cap,
      vec_ok<TK>(D, k_pages, v_pages));
  return cudaGetLastError();
}

// Pools of q's type (f32 or bf16).
template <typename Tag>
int page_partials_entry(const void* q, const void* k_pages,
                        const void* v_pages, const void* pos_pages,
                        const void* tables, const void* pos_q, void* o,
                        void* l, void* m, int B, int S, int H, int KV, int D,
                        int bs, int nb, float scale, int window,
                        float soft_cap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return launch_page_partials<float, float, Tag>(
        q, k_pages, v_pages, nullptr, nullptr, pos_pages, tables, pos_q, o,
        l, m, B, S, H, KV, D, bs, nb, scale, window, soft_cap, st);
  if (dtype == DTYPE_BF16)
    return launch_page_partials<__nv_bfloat16, __nv_bfloat16, Tag>(
        q, k_pages, v_pages, nullptr, nullptr, pos_pages, tables, pos_q, o,
        l, m, B, S, H, KV, D, bs, nb, scale, window, soft_cap, st);
  return cudaErrorInvalidValue;
}

// int8 pools with f32 scale pools; dtype is q's (f32 or bf16).
template <typename Tag>
int page_partials_q8_entry(const void* q, const void* k_pages,
                           const void* v_pages, const void* k_scale,
                           const void* v_scale, const void* pos_pages,
                           const void* tables, const void* pos_q, void* o,
                           void* l, void* m, int B, int S, int H, int KV,
                           int D, int bs, int nb, float scale, int window,
                           float soft_cap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return launch_page_partials<float, int8_t, Tag>(
        q, k_pages, v_pages, k_scale, v_scale, pos_pages, tables, pos_q, o,
        l, m, B, S, H, KV, D, bs, nb, scale, window, soft_cap, st);
  if (dtype == DTYPE_BF16)
    return launch_page_partials<__nv_bfloat16, int8_t, Tag>(
        q, k_pages, v_pages, k_scale, v_scale, pos_pages, tables, pos_q, o,
        l, m, B, S, H, KV, D, bs, nb, scale, window, soft_cap, st);
  return cudaErrorInvalidValue;
}

}  // namespace repro
