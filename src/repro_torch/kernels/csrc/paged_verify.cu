// Page-fused speculative verification: the pending token plus its S - 1
// proposals per sequence, scored against the sequence's KV pages in place,
// read through the block table, emitting one (o, l, m) partial per split
// of `pages_per_split` page slots, which ops.paged_verify_attention
// combines exactly.
//
// Replaces the TPU kernel src/repro/kernels/split_kv_decode.py
// (_paged_verify_kernel / paged_verify_partials): bf16 and f32 pools
// (paged_verify_partials) and int8 pools with per-entry f32 scales
// (paged_verify_partials_q8, int8-KV speculation).  pages_per_split = 1 is
// the TPU kernel's contract (one partial per page); a larger split is the
// exact online-softmax merge of its pages' partials.
//
// Bound on the H100: bytes.  Verification reads the same live pages as a
// decode step and does 4 * S * G * D flops per key (S = spec_len + 1 = 5:
// about 5 G flops per byte of bf16 KV, 10 G of int8), far below the
// card's ~295 flop/byte ridge, so the design spends its effort on reading
// each page as few times as it can and writing few partials.
//
// Layout.  One block of 4 warps owns (row b, kv head, a group of the kv
// head's S * G query rows packed s-major, split j): packed row p is query
// s = p / G of head kv_head * G + p % G, at position pos_q[b, s].  The
// block resolves its split's page slots through the table and walks their
// keys with B1's page stream (decode_walk.cuh walk_pages: 128 slots a
// round, live pages kept in table order, dead entries never read, K/V
// tiles in the pool's own type in a cp.async ring, the keys spread over
// the four warps, which merge their softmax states once at the end).
// Visibility is decided per (key, row), so the in-flight tokens at
// pos_q[b, s'] > pos_q[b, s], already written into their pages, are
// hidden from query s by the same pos <= pos_q test that masks history,
// and rolled-back tokens left in kept pages stay masked until overwritten.
//
// Three bodies, picked per launch from the types and the S * G rows:
//
// * bf16 queries over bf16 pools up to 16 rows, and over int8 pools at any
//   count: MmaWalk, one row tile of 16 that all four warps share, each
//   warp scoring its own 16 keys of a 64-key tile on mma.sync (Q K^T, then
//   P V with P split into bf16 high and low halves for the 1e-4 parity).
//   int8 tiles land in the ring as int8 and each warp converts its keys to
//   bf16 (exact) before ldmatrix reads them.  The FMA walk of B1 spends
//   FMAs and shared-memory reads of the query on every row and key, which
//   at 5 rows held it far from its bound on the card; the tensor cores
//   take 16 rows for the price of one.  int8 has no tile body, so
//   its kv heads of more than 16 rows take several walk blocks, each
//   reading the pages again.
// * f32 queries (the tests' type): B1's FMA walk, RG =
//   fma_walk_rows(S * G, D) rows a block (4, 8 or 16; 8 at
//   head_dim 256), over f32 pools up to 16 rows and int8 pools at any
//   count.
// * bf16/f32 pools above 16 rows: B3's tensor-core tile body
//   (paged_prefix.cuh, prefix_kernel under this entry's PagedVerify tag),
//   one block per kv head of up to 128 rows (64 at head_dim 256), so a
//   page is read once per kv head, where a walk would read it once per 16
//   rows.  chip_smoke.py times the walk against this body on the same
//   verify inputs at 5, 20 and 80 rows (PERF.md keeps the numbers).
//
// int8 scales fold where JAX folds them (K after * scale and before the
// soft cap, l summed before the V scale multiplies p), and the V scale
// multiplies p only where the key is visible to that row: a key can be
// visible to row s and masked for row s - 1, and a masked entry's scale
// slot may be stale.
//
// A page is read per kv head at spec_len 4 (S = 5) once for bf16 pools at
// every G of the registry (llama-13b, opt-13b, gemma-7b 5 rows: one
// MmaWalk block, 11 rows of it padding; granite-moe 15; granite-8b and
// minitron-8b 20, grok-1 30, chameleon-34b 40, llama3-405b 80: one
// tile-body block).  int8 pools read it once up to G = 3, twice at G = 4
// and G = 6, three times at G = 8 and five times at G = 16.
//
// Split.  The serving path asks for split_kv_decode.verify_pages_per_split:
// on a walk B1's rule, each row cut into enough splits for about 8 blocks
// per SM, counting B * KV * ceil(S * G / rows per block) blocks; on the
// tile body B3's rule.  At the smoke's llama-13b verify step (8 rows x 64
// slots x S = 5, 40 heads) that is 16 pages a split and 0.66 MB of
// partials; one partial per page would write 53 MB, a third of the bytes
// the kernel moves.
#include <climits>

#include "decode_walk.cuh"
#include "paged_prefix.cuh"

namespace repro {

struct PagedVerify {};   // names this entry's tile-body kernel symbol

// The most query rows per kv head that bf16/f32 pools score on a walk;
// above, B3's tile body.  chip_smoke.py builds a copy with every row count
// on the walk (-DREPRO_VERIFY_WALK_ROWS=1024) to time the bodies on the
// same inputs.
#ifndef REPRO_VERIFY_WALK_ROWS
#define REPRO_VERIFY_WALK_ROWS 16
#endif
constexpr int kVerifyWalkRows = REPRO_VERIFY_WALK_ROWS;

// Walk rows per block on the FMA walk (f32 and int8 pools): 4, 8 or 16 up
// to head_dim 128, 8 at 256, where 16 rows of o would not fit the
// registers; a kv head of more rows takes ceil(S * G / RG) blocks.
inline int fma_walk_rows(int rows, int D) {
  return rows <= 4 ? 4 : (rows <= 8 || D > 128 ? 8 : 16);
}

template <typename F>
cudaError_t dispatch_verify_shape(int D, int rows, F f) {
  using dec::Shape;
  const int rg = fma_walk_rows(rows, D);
  if (D <= 64) {
    if (rg == 4) return f(Shape<64, 4>{});
    if (rg == 8) return f(Shape<64, 8>{});
    return f(Shape<64, 16>{});
  }
  if (D <= 128) {
    if (rg == 4) return f(Shape<128, 4>{});
    if (rg == 8) return f(Shape<128, 8>{});
    return f(Shape<128, 16>{});
  }
  if (rg == 4) return f(Shape<256, 4>{});
  return f(Shape<256, 8>{});
}

// A launch's arguments (one kernel parameter).  q: (B, S, H, D) of
// W::Query; k/v_pages: (P, bs, KV, D) of W::Key (q's type, or int8 with
// k/v_scale (P, bs, KV) f32, null otherwise); pos_pages: (P, bs); tables:
// (B, nb) (-1 = dead); pos_q: (B, S).  o: (B, nsplit, S, H, D) f32;
// l, m: (B, nsplit, S, H) f32, nsplit = ceil(nb / pps).
struct VerifyArgs {
  const void *q, *k_pages, *v_pages;
  const float *k_scale, *v_scale;
  const int *pos_pages, *tables, *pos_q;
  float *o, *l, *m;
  int S, H, KV, D, bs, nb, pps, n_grp, stages;
  float scale;
  int window;
  float soft_cap;
};

// One block of walk W (dec::Walk, dec::MmaWalk): blockIdx.x = split *
// n_grp + row group.
template <typename W>
__device__ __forceinline__ void verify_block(const VerifyArgs& a) {
  using TQ = typename W::Query;
  using TK = typename W::Key;
  constexpr int RG = W::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int* pages_s =   // (kThreads,)
      reinterpret_cast<int*>(smem_raw + W::smem_bytes(a.stages));
  __shared__ int warp_count[dec::kWarps];
  __shared__ int pq_s[RG];   // each row's query position (-1: padding)

  const int split = blockIdx.x / a.n_grp, grp = blockIdx.x % a.n_grp;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int S = a.S, H = a.H, G = H / a.KV, g0 = grp * RG;
  const int n_rows = min(RG, S * G - g0);
  const int nsplit = (a.nb + a.pps - 1) / a.pps;
  // packed row g0 + r: query s = (g0 + r) / G of head kvh * G + (g0 + r) % G
  auto head_row = [&](int r) -> size_t {   // (b, s, h) of row r
    const int p = g0 + r;
    return (static_cast<size_t>(b) * S + p / G) * H + kvh * G + p % G;
  };
  if (threadIdx.x < RG)
    pq_s[threadIdx.x] =
        static_cast<int>(threadIdx.x) < n_rows
            ? a.pos_q[static_cast<size_t>(b) * S + (g0 + threadIdx.x) / G]
            : -1;

  const TQ* q = static_cast<const TQ*>(a.q);
  W walk;   // walk_pages's first barrier publishes q and pq_s
  walk.init(smem_raw, a.stages, n_rows, a.D,
            [&](int r) { return q + head_row(r) * a.D; });
  const int p_begin = split * a.pps, p_end = min(a.nb, p_begin + a.pps);
  const int window = a.window;
  dec::walk_pages(
      walk, pages_s, warp_count, a.tables + static_cast<size_t>(b) * a.nb,
      p_begin, p_end, static_cast<const TK*>(a.k_pages),
      static_cast<const TK*>(a.v_pages), a.k_scale, a.v_scale, a.pos_pages,
      a.bs, a.KV, a.D, kvh,
      [&](int pos, int r) { return key_visible(pos, pq_s[r], window); },
      a.scale, a.soft_cap);
  // (b, s, h) -> (b, split, s, h)
  const size_t split_off = (static_cast<size_t>(b) * (nsplit - 1) + split) *
                           static_cast<size_t>(S) * H;
  walk.store(n_rows, a.D, [&](int r) { return split_off + head_row(r); },
             a.o, a.l, a.m);
}

// The FMA walk keeps ptxas's own choice of registers.  MmaWalk asks for
// three blocks an SM, which is what its shared memory allows up to
// head_dim 128: left to itself ptxas held it to 128 registers and spilled,
// and the spill-free build was the faster on the card (one block at 256).
template <typename W>
__global__ void __launch_bounds__(dec::kThreads)
paged_verify_kernel(const VerifyArgs a) {
  verify_block<W>(a);
}

template <int DP, typename TK>
__global__ void __launch_bounds__(dec::kThreads, DP <= 128 ? 3 : 1)
paged_verify_mma_kernel(const VerifyArgs a) {
  verify_block<dec::MmaWalk<DP, TK>>(a);
}

// Launch walk W over `rows` = S * G packed rows a kv head.
template <typename W>
cudaError_t launch_walk(VerifyArgs a, int B, long long rows,
                        cudaStream_t stream) {
  void (*kernel)(VerifyArgs);
  if constexpr (W::kTensorCores)
    kernel = paged_verify_mma_kernel<W::kDp, typename W::Key>;
  else
    kernel = paged_verify_kernel<W>;
  const long long n_grp = (rows + W::kRows - 1) / W::kRows;
  const long long nsplit = (a.nb + a.pps - 1) / a.pps;
  if (nsplit * n_grp > INT_MAX) return cudaErrorInvalidValue;
  a.n_grp = static_cast<int>(n_grp);
  // a one-stage ring when a split's keys fit one tile
  a.stages = static_cast<long long>(a.pps) * a.bs <= W::kBk ? 1 : W::kStages;
  const size_t smem =
      W::smem_bytes(a.stages) + dec::kThreads * sizeof(int);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(nsplit * n_grp), a.KV, B);
  kernel<<<grid, dec::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename TK>
cudaError_t launch_paged_verify(const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scale,
                                const void* v_scale, const void* pos_pages,
                                const void* tables, const void* pos_q,
                                void* o, void* l, void* m, int B, int S,
                                int H, int KV, int D, int bs, int nb, int pps,
                                float scale, int window, float soft_cap,
                                cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  if (B <= 0 || S <= 0 || nb <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || D > 256 ||
      D % (16 / sizeof(TK)) != 0 || D % 8 != 0 || bs <= 0 || pps <= 0 ||
      pps > nb || KV > 65535 || B > 65535 ||
      !aligned16(q, k_pages, v_pages, o) ||
      (kQuant && (k_scale == nullptr || v_scale == nullptr)))
    return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(S) * (H / KV);
  if (rows > INT_MAX) return cudaErrorInvalidValue;
  if constexpr (!kQuant)
    if (rows > kVerifyWalkRows)
      return dispatch_prefix<PagedVerify, T>(
          q, k_pages, v_pages, pos_pages, tables, pos_q, o, l, m, B, S, H,
          KV, D, bs, nb, pps, scale, window, soft_cap, stream);
  const VerifyArgs a{q, k_pages, v_pages,
                     static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale),
                     static_cast<const int*>(pos_pages),
                     static_cast<const int*>(tables),
                     static_cast<const int*>(pos_q), static_cast<float*>(o),
                     static_cast<float*>(l), static_cast<float*>(m), S, H,
                     KV, D, bs, nb, pps, 0, 0, scale, window, soft_cap};
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (D <= 64) return launch_walk<dec::MmaWalk<64, TK>>(a, B, rows, stream);
    if (D <= 128)
      return launch_walk<dec::MmaWalk<128, TK>>(a, B, rows, stream);
    return launch_walk<dec::MmaWalk<256, TK>>(a, B, rows, stream);
  } else {
    return dispatch_verify_shape(
        D, static_cast<int>(rows), [&](auto sh) -> cudaError_t {
          constexpr int DP = decltype(sh)::kDp, RG = decltype(sh)::kRg;
          return launch_walk<dec::Walk<T, TK, DP, RG>>(a, B, rows, stream);
        });
  }
}

}  // namespace repro

// q: (B, S, H, D); pools (P, bs, KV, D) of q's dtype; pos_pages (P, bs);
// tables (B, nb); pos_q (B, S).  o: (B, ceil(nb / pps), S, H, D) f32;
// l, m: (B, ceil(nb / pps), S, H) f32.  D a multiple of 8 up to 256,
// 1 <= pps <= nb, q, the pools and o 16-byte aligned.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int paged_verify_partials(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* pos_pages,
                                     const void* tables, const void* pos_q,
                                     void* o, void* l, void* m, int B, int S,
                                     int H, int KV, int D, int bs, int nb,
                                     int pps, float scale, int window,
                                     float soft_cap, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return repro::launch_paged_verify<float, float>(
        q, k_pages, v_pages, nullptr, nullptr, pos_pages, tables, pos_q, o, l,
        m, B, S, H, KV, D, bs, nb, pps, scale, window, soft_cap, st);
  if (dtype == repro::DTYPE_BF16)
    return repro::launch_paged_verify<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, pos_pages, tables, pos_q, o, l,
        m, B, S, H, KV, D, bs, nb, pps, scale, window, soft_cap, st);
  return cudaErrorInvalidValue;
}

// int8 pools (P, bs, KV, D) with k/v_scale (P, bs, KV) f32; q of dtype.
// D a multiple of 16.
extern "C" int paged_verify_partials_q8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* pos_pages,
    const void* tables, const void* pos_q, void* o, void* l, void* m, int B,
    int S, int H, int KV, int D, int bs, int nb, int pps, float scale,
    int window, float soft_cap, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return repro::launch_paged_verify<float, int8_t>(
        q, k_pages, v_pages, k_scale, v_scale, pos_pages, tables, pos_q, o, l,
        m, B, S, H, KV, D, bs, nb, pps, scale, window, soft_cap, st);
  if (dtype == repro::DTYPE_BF16)
    return repro::launch_paged_verify<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, k_scale, v_scale, pos_pages, tables, pos_q, o, l,
        m, B, S, H, KV, D, bs, nb, pps, scale, window, soft_cap, st);
  return cudaErrorInvalidValue;
}
