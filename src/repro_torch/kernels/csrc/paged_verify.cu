// Page-fused speculative verification: the pending token plus its S - 1
// proposals per sequence, scored against the sequence's KV pages in place,
// emitting per-page (o, l, m) partials that ops.paged_verify_attention
// combines over the page axis.
//
// Replaces the TPU kernel src/repro/kernels/split_kv_decode.py
// (_paged_verify_kernel / paged_verify_partials): bf16 and f32 pools
// (paged_verify_partials) and int8 pools with per-entry f32 scales
// (paged_verify_partials_q8, int8-KV speculation).  The arithmetic is the paged-prefix
// kernel's, so the body is the shared page kernel of paged_partials.cuh,
// instantiated under its own tag (own kernel symbol in a trace):
// one block per (sequence, page slot, kv head), the page's K/V head slice
// staged once in shared memory and scored by all S * G query rows of that
// kv head, one warp per row (rows past the warp count loop).  Each query
// carries its own absolute position pos_q[s]: the in-flight tokens at
// pos_q[s'] > pos_q[s] are already written into their pages and are hidden
// by the same pos <= pos_q[s] test that masks history, not by ordering.
// Rolled-back tokens left in kept pages sit past every later query's
// position and stay masked until overwritten.
//
// Bound on the H100: bytes.  Verification reads the same live pages as a
// decode step and does S times the arithmetic on them (4 * S * G * D flops
// per key, ~5 G flops per byte of bf16 KV at S = 5), still far below the
// card's ~295 flop/byte ridge; the per-page partials it writes grow with
// S.  Dead table entries skip the page read.
#include "paged_partials.cuh"

namespace repro {
struct PagedVerify {};   // names this entry's kernel symbol
}  // namespace repro

// q: (B, S, H, D); pools (P, bs, KV, D); pos_pages (P, bs); tables
// (B, nb); pos_q (B, S).  o: (B, nb, S, H, D) f32; l, m: (B, nb, S, H).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_verify_partials(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* pos_pages,
                                     const void* tables, const void* pos_q,
                                     void* o, void* l, void* m, int B, int S,
                                     int H, int KV, int D, int bs, int nb,
                                     float scale, int window, float soft_cap,
                                     int dtype, void* stream) {
  return repro::page_partials_entry<repro::PagedVerify>(
      q, k_pages, v_pages, pos_pages, tables, pos_q, o, l, m, B, S, H, KV, D,
      bs, nb, scale, window, soft_cap, dtype, stream);
}

// int8 pools (P, bs, KV, D) with k/v_scale (P, bs, KV) f32; q of dtype.
extern "C" int paged_verify_partials_q8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* pos_pages,
    const void* tables, const void* pos_q, void* o, void* l, void* m, int B,
    int S, int H, int KV, int D, int bs, int nb, float scale, int window,
    float soft_cap, int dtype, void* stream) {
  return repro::page_partials_q8_entry<repro::PagedVerify>(
      q, k_pages, v_pages, k_scale, v_scale, pos_pages, tables, pos_q, o, l,
      m, B, S, H, KV, D, bs, nb, scale, window, soft_cap, dtype, stream);
}
