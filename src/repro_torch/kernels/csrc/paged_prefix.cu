// Paged-prefix attention of chunked prefill: S resume-chunk queries per
// sequence against the already published prefix pages, read in place
// through the block table, emitting one (o, l, m) partial per split of
// `pages_per_split` page slots, which ops.paged_prefill_attention combines
// with the suffix's flash partials.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py
// (_paged_prefix_kernel / paged_prefix_partials).  pages_per_split = 1 is
// the TPU kernel's contract (one partial per page); a larger split is the
// exact online-softmax merge of its pages' partials.
//
// One block of 4 warps owns (row b, kv head, a tile of 128 of the S * G
// query rows of that kv head (64 at head_dim 256), packed s-major, split
// j).  It resolves its split's page slots through the block table itself,
// 128 slots a round, keeps the live pages that hold a key some of its
// queries may see (position, causality and window against the tile's
// query range; dead entries and pages of the chunk not written yet are
// never read), and walks their keys in tiles of 32 (two pages of 16; 64
// keys at head_dim 64, 16 at 256): each page's token rows for this kv
// head are cp.async'd from the pool's strided layout (rows KV * D apart)
// into a two-stage ring with their positions beside them, and scored with
// the tile walk of attn_tile.cuh that flash_prefill.cu (B2) also runs;
// the online-softmax state carries across tiles and rounds.  A split with
// no visible key writes the all-masked partial (o = 0, l = 0,
// m = NEG_INF).
//
// Bound on the H100: bytes.  The live K/V pages are read once per (kv
// head, row tile) and the partials written once: S * H * (D + 2) f32 per
// split, which at one partial per page outweighs the pages themselves
// (the TPU contract, kept at pages_per_split = 1); the serving path picks
// one split per row unless that leaves SMs idle.  bf16 runs both products
// on the tensor cores, f32 (tests only) on the FMA units.  The kernel
// lives in paged_prefix.cuh: B4 runs it too, under its own symbol.
#include "paged_prefix.cuh"

namespace repro {
struct PagedPrefix {};   // names this entry's kernel symbol
}  // namespace repro

// q: (B, S, H, D); pools (P, bs, KV, D); pos_pages (P, bs); tables
// (B, nb); positions (B, S).  o: (B, ceil(nb / pps), S, H, D) f32;
// l, m: (B, ceil(nb / pps), S, H).  D must be a multiple of 8 and at most
// 256, 1 <= pps <= nb, and q, the pools and o 16-byte aligned.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_prefix_partials(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* pos_pages,
                                     const void* tables,
                                     const void* positions, void* o, void* l,
                                     void* m, int B, int S, int H, int KV,
                                     int D, int bs, int nb, int pps,
                                     float scale, int window, float soft_cap,
                                     int dtype, void* stream) {
  if (B <= 0 || S <= 0 || nb <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      bs <= 0 || pps <= 0 || pps > nb || KV > 65535 || B > 65535 ||
      !repro::aligned16(q, k_pages, v_pages, o))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return repro::dispatch_prefix<repro::PagedPrefix, float>(
        q, k_pages, v_pages, pos_pages, tables, positions, o, l, m, B, S, H,
        KV, D, bs, nb, pps, scale, window, soft_cap, st);
  if (dtype == repro::DTYPE_BF16)
    return repro::dispatch_prefix<repro::PagedPrefix, __nv_bfloat16>(
        q, k_pages, v_pages, pos_pages, tables, positions, o, l, m, B, S, H,
        KV, D, bs, nb, pps, scale, window, soft_cap, st);
  return cudaErrorInvalidValue;
}
