// Page-fused split-KV decode: one query token per sequence scored against
// its KV pages in place, read through the block table, emitting one
// (o, l, m) partial per split of `pages_per_split` page slots, which
// ops.paged_decode_attention combines exactly.
//
// Replaces the TPU kernel src/repro/kernels/split_kv_decode.py
// (_paged_decode_kernel / paged_decode_partials): bf16 and f32 pools
// (paged_decode_partials) and int8 pools with per-entry f32 scales
// (paged_decode_partials_q8, the int8-KV serving path).  pages_per_split
// = 1 is the TPU kernel's contract (one partial per page); a larger split
// is the exact online-softmax merge of its pages' partials.
//
// One block of 4 warps owns (row b, kv head, a group of up to 8 of the
// kv head's G query heads, split j).  It resolves its split's page slots
// through the block table itself, 128 slots a round, keeps the live ones
// in table order (a dead entry, -1, is never read: neither its page nor
// its positions or scales), and walks their keys with the key walk of
// decode_walk.cuh (walk_pages, which B4 shares; B5 shares the walk):
// K/V tiles cp.async'd from the pool's strided layout (rows KV * D apart)
// into a four-stage ring in the pool's type, each key's position (and,
// for int8, its two scales) copied beside it; the keys spread over the
// four warps, one warp-wide max per tile and row.  A key is visible when
// its position is live, not after the query and inside the window.
//
// Bound on the H100: bytes.  Decode reads every live page once per kv
// head and does 4 * G * D flops per key, about G flops per byte of bf16
// KV (2 G of int8 KV), far below the card's ~295 flop/byte ridge.  The
// partials are (D + 2) f32 per split and query head; at one partial per
// page they are an eighth of the bytes (bf16, bs 16), at the serving
// path's split (kernels/split_kv_decode.py decode_pages_per_split: each
// row cut into enough splits for about 8 blocks per SM, which evens out
// rows of different lengths) under 1 % of them.
#include <climits>

#include "decode_walk.cuh"

namespace repro {

// q: (B, H, D); k/v_pages: (P, bs, KV, D) of TK (T, or int8 with
// k/v_scale (P, bs, KV) f32, null otherwise); pos_pages: (P, bs); tables:
// (B, nb) (-1 = dead); pos_q: (B,).  o: (B, nsplit, H, D) f32; l, m:
// (B, nsplit, H) f32, nsplit = ceil(nb / pps).  blockIdx.x = split *
// n_grp + query-head group.
template <typename T, typename TK, int DP, int RG>
__global__ void __launch_bounds__(dec::kThreads)
paged_decode_kernel(const T* __restrict__ q, const TK* __restrict__ k_pages,
                    const TK* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ pos_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos_q, float* __restrict__ o,
                    float* __restrict__ l, float* __restrict__ m, int H,
                    int KV, int D, int bs, int nb, int pps, int n_grp,
                    int stages, float scale, int window, float soft_cap) {
  using W = dec::Walk<T, TK, DP, RG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* pages_s =   // (kThreads,)
      reinterpret_cast<int*>(smem_raw + W::smem_bytes(stages));
  __shared__ int warp_count[dec::kWarps];

  const int split = blockIdx.x / n_grp, grp = blockIdx.x % n_grp;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, g0 = grp * RG, n_rows = min(RG, G - g0);
  const int nsplit = (nb + pps - 1) / pps;
  const int pq = pos_q[b];
  const size_t head0 = static_cast<size_t>(b) * H + kvh * G + g0;

  W walk;
  walk.init(smem_raw, stages, n_rows, D,
            [&](int r) { return q + (head0 + r) * D; });
  const int p_begin = split * pps, p_end = min(nb, p_begin + pps);
  dec::walk_pages(walk, pages_s, warp_count,
                  tables + static_cast<size_t>(b) * nb, p_begin, p_end,
                  k_pages, v_pages, k_scale, v_scale, pos_pages, bs, KV, D,
                  kvh,
                  [&](int pos, int) { return key_visible(pos, pq, window); },
                  scale, soft_cap);
  const size_t row0 =
      (static_cast<size_t>(b) * nsplit + split) * H + kvh * G + g0;
  walk.store(n_rows, D, [&](int r) { return row0 + r; }, o, l, m);
}

template <typename T, typename TK>
cudaError_t launch_paged_decode(const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scale,
                                const void* v_scale, const void* pos_pages,
                                const void* tables, const void* pos_q,
                                void* o, void* l, void* m, int B, int H,
                                int KV, int D, int bs, int nb, int pps,
                                float scale, int window, float soft_cap,
                                cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  if (B <= 0 || nb <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || D > 256 ||
      D % (16 / sizeof(TK)) != 0 || D % 8 != 0 || bs <= 0 || pps <= 0 ||
      pps > nb || KV > 65535 || B > 65535 ||
      !aligned16(k_pages, v_pages) ||
      (kQuant && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  const int G = H / KV, rg = dec::rows_per_block(G);
  const int n_grp = (G + rg - 1) / rg;
  const long long nsplit = (nb + pps - 1) / pps;
  if (nsplit * n_grp > INT_MAX) return cudaErrorInvalidValue;
  return dec::dispatch_shape(D, G, [&](auto sh) -> cudaError_t {
    constexpr int DP = decltype(sh)::kDp, RG = decltype(sh)::kRg;
    using W = dec::Walk<T, TK, DP, RG>;
    auto kernel = paged_decode_kernel<T, TK, DP, RG>;
    // a one-stage ring when a split's keys fit one tile
    const int stages =
        static_cast<long long>(pps) * bs <= W::kBk ? 1 : W::kStages;
    const size_t smem = W::smem_bytes(stages) + dec::kThreads * sizeof(int);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(nsplit * n_grp), KV, B);
    kernel<<<grid, dec::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const TK*>(k_pages),
        static_cast<const TK*>(v_pages), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale),
        static_cast<const int*>(pos_pages), static_cast<const int*>(tables),
        static_cast<const int*>(pos_q), static_cast<float*>(o),
        static_cast<float*>(l), static_cast<float*>(m), H, KV, D, bs, nb,
        pps, n_grp, stages, scale, window, soft_cap);
    return cudaGetLastError();
  });
}

}  // namespace repro

// q: (B, H, D); pools (P, bs, KV, D) of q's dtype; pos_pages (P, bs);
// tables (B, nb); pos_q (B,).  o: (B, ceil(nb / pps), H, D) f32; l, m:
// (B, ceil(nb / pps), H) f32.  S is 1 (the argument keeps the page
// entries' signatures alike).  D a multiple of 8 up to 256, 1 <= pps <= nb,
// the pools 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int paged_decode_partials(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* pos_pages,
                                     const void* tables, const void* pos_q,
                                     void* o, void* l, void* m, int B, int S,
                                     int H, int KV, int D, int bs, int nb,
                                     int pps, float scale, int window,
                                     float soft_cap, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S != 1) return cudaErrorInvalidValue;
  if (dtype == repro::DTYPE_F32)
    return repro::launch_paged_decode<float, float>(
        q, k_pages, v_pages, nullptr, nullptr, pos_pages, tables, pos_q, o, l,
        m, B, H, KV, D, bs, nb, pps, scale, window, soft_cap, st);
  if (dtype == repro::DTYPE_BF16)
    return repro::launch_paged_decode<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, pos_pages, tables, pos_q, o, l,
        m, B, H, KV, D, bs, nb, pps, scale, window, soft_cap, st);
  return cudaErrorInvalidValue;
}

// int8 pools (P, bs, KV, D) with k/v_scale (P, bs, KV) f32; q of dtype.
// D a multiple of 16.
extern "C" int paged_decode_partials_q8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* pos_pages,
    const void* tables, const void* pos_q, void* o, void* l, void* m, int B,
    int S, int H, int KV, int D, int bs, int nb, int pps, float scale,
    int window, float soft_cap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S != 1) return cudaErrorInvalidValue;
  if (dtype == repro::DTYPE_F32)
    return repro::launch_paged_decode<float, int8_t>(
        q, k_pages, v_pages, k_scale, v_scale, pos_pages, tables, pos_q, o, l,
        m, B, H, KV, D, bs, nb, pps, scale, window, soft_cap, st);
  if (dtype == repro::DTYPE_BF16)
    return repro::launch_paged_decode<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, k_scale, v_scale, pos_pages, tables, pos_q, o, l,
        m, B, H, KV, D, bs, nb, pps, scale, window, soft_cap, st);
  return cudaErrorInvalidValue;
}
