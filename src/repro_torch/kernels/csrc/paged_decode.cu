// Page-fused split-KV decode: one query row per sequence scored against
// its KV pages in place, emitting per-page (o, l, m) partials.
//
// Replaces the TPU kernel src/repro/kernels/split_kv_decode.py
// (_paged_decode_kernel / paged_decode_partials): bf16 and f32 pools
// (paged_decode_partials) and int8 pools with per-entry f32 scales
// (paged_decode_partials_q8, the int8-KV serving path).  The body is the
// shared page kernel of paged_partials.cuh run with S = 1: one block per
// (sequence, page slot, kv head), the page's K/V staged in shared memory
// (int8 converted at the load, scales staged beside it), the G query heads
// of the kv head scored one warp each.
//
// Bound on the H100: bytes.  Decode reads every live page once and does
// 4 * G * D flops per key, about G flops per byte of bf16 KV (2 G of int8
// KV), so the card's memory rate is the limit; int8 pages halve the page
// bytes, leaving the f32 partials as the larger share.  The design reads
// pages in place through the block table (no gathered dense view) and
// skips dead table entries without touching the pool or its scales.
#include "paged_partials.cuh"

namespace repro {
struct PagedDecode {};   // names this entry's kernel symbol
}  // namespace repro

// q: (B, H, D); pools (P, bs, KV, D); pos_pages (P, bs); tables (B, nb);
// pos_q (B,).  o: (B, nb, H, D) f32; l, m: (B, nb, H) f32.  S is 1 (the
// argument keeps the page entries' signatures alike).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_decode_partials(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* pos_pages,
                                     const void* tables, const void* pos_q,
                                     void* o, void* l, void* m, int B, int S,
                                     int H, int KV, int D, int bs, int nb,
                                     float scale, int window, float soft_cap,
                                     int dtype, void* stream) {
  if (S != 1) return cudaErrorInvalidValue;
  return repro::page_partials_entry<repro::PagedDecode>(
      q, k_pages, v_pages, pos_pages, tables, pos_q, o, l, m, B, 1, H, KV, D,
      bs, nb, scale, window, soft_cap, dtype, stream);
}

// int8 pools (P, bs, KV, D) with k/v_scale (P, bs, KV) f32; q of dtype.
extern "C" int paged_decode_partials_q8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* pos_pages,
    const void* tables, const void* pos_q, void* o, void* l, void* m, int B,
    int S, int H, int KV, int D, int bs, int nb, float scale, int window,
    float soft_cap, int dtype, void* stream) {
  if (S != 1) return cudaErrorInvalidValue;
  return repro::page_partials_q8_entry<repro::PagedDecode>(
      q, k_pages, v_pages, k_scale, v_scale, pos_pages, tables, pos_q, o, l,
      m, B, 1, H, KV, D, bs, nb, scale, window, soft_cap, dtype, stream);
}
