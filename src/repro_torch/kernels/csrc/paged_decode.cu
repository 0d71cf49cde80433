// Page-fused split-KV decode: one query row per sequence scored against
// its KV pages in place, emitting per-page (o, l, m) partials.
//
// Replaces the TPU kernel src/repro/kernels/split_kv_decode.py
// (_paged_decode_kernel / paged_decode_partials, bf16 and f32 pools; the
// int8-page variant is not ported yet).  The body is the shared page
// kernel of paged_partials.cuh run with S = 1: one block per (sequence,
// page slot, kv head), the page's K/V staged in shared memory, the G query
// heads of the kv head scored one warp each.
//
// Bound on the H100: bytes.  Decode reads every live page once and does
// 4 * G * D flops per key, about G flops per byte of bf16 KV, so the card's
// memory rate is the limit.  The design reads pages in place through the
// block table (no gathered dense view) and skips dead table entries
// without touching the pool.
#include "paged_partials.cuh"

// q: (B, H, D); pools (P, bs, KV, D); pos_pages (P, bs); tables (B, nb);
// pos_q (B,).  o: (B, nb, H, D) f32; l, m: (B, nb, H) f32.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_decode_partials(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* pos_pages,
                                     const void* tables, const void* pos_q,
                                     void* o, void* l, void* m, int B, int H,
                                     int KV, int D, int bs, int nb,
                                     float scale, int window, float soft_cap,
                                     int dtype, void* stream) {
  return repro::page_partials_entry(q, k_pages, v_pages, pos_pages, tables,
                                    pos_q, o, l, m, B, 1, H, KV, D, bs, nb,
                                    scale, window, soft_cap, dtype, stream);
}
