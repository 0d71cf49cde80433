// Paged-prefix attention of chunked prefill: S resume-chunk queries per
// sequence against the already published prefix pages, read in place
// through the block table, emitting per-page (o, l, m) partials that
// ops.paged_prefill_attention combines with the suffix's flash partials.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py
// (_paged_prefix_kernel / paged_prefix_partials).  Shared page kernel of
// paged_partials.cuh: one block per (sequence, page slot, kv head), the
// page staged once in shared memory and reused by all S * G query rows.
//
// Bound on the H100: bytes at the slice's shapes.  A 16-token page serves
// S * G query rows, 4 * S * G * bs * D flops against 4 * bs * D bytes of
// bf16 K/V, but the per-page partials it writes, (S * H * (D + 2)) f32 per
// page, outweigh the page itself; this first design keeps the JAX
// per-page contract and pays that write.  Dead table entries skip the
// page read.
#include "paged_partials.cuh"

namespace repro {
struct PagedPrefix {};   // names this entry's kernel symbol
}  // namespace repro

// q: (B, S, H, D); pools (P, bs, KV, D); pos_pages (P, bs); tables
// (B, nb); positions (B, S).  o: (B, nb, S, H, D) f32; l, m: (B, nb, S, H).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_prefix_partials(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* pos_pages,
                                     const void* tables,
                                     const void* positions, void* o, void* l,
                                     void* m, int B, int S, int H, int KV,
                                     int D, int bs, int nb, float scale,
                                     int window, float soft_cap, int dtype,
                                     void* stream) {
  return repro::page_partials_entry<repro::PagedPrefix>(
      q, k_pages, v_pages, pos_pages, tables, positions, o, l, m, B, S, H, KV,
      D, bs, nb, scale, window, soft_cap, dtype, stream);
}
