// The body of B3 (paged_prefix.cu), which B4 (paged_verify.cu) also runs
// for bf16/f32 pools above 8 query rows per kv head: S queries per
// sequence against the pages of its block table, read in place, one
// (o, l, m) partial per split of `pages_per_split` page slots.  The
// layout and the reasons for it are in paged_prefix.cu.
#pragma once

#include <climits>

#include "attn_tile.cuh"

namespace repro {

// Two row tiles of 16 per warp up to head_dim 128 (128 query rows per
// block: each K/V fragment feeds two MMAs), one at 256; keys per tile 64
// at head_dim 64, 32 at 128, 16 at 256 (registers).
template <typename T, int DP>
using PrefixTile = tile::WarpAttn<T, DP, DP <= 64 ? 64 : (DP <= 128 ? 32 : 16),
                                  DP <= 128 ? 2 : 1>;

// q: (B, S, H, D); k/v_pages: (P, bs, KV, D); pos_pages: (P, bs); tables:
// (B, nb) (-1 = dead); pos_q: (B, S) absolute query positions.
// o: (B, nsplit, S, H, D) f32; l, m: (B, nsplit, S, H) f32, nsplit =
// ceil(nb / pps).  Tag is an empty type named after the entry point that
// launches the kernel (PagedPrefix, PagedVerify), so a trace tells B3's
// launches from B4's.
template <typename Tag, typename T, int DP>
__global__ void __launch_bounds__(tile::kThreads)
prefix_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
              const T* __restrict__ v_pages,
              const int* __restrict__ pos_pages,
              const int* __restrict__ tables, const int* __restrict__ pos_q,
              float* __restrict__ o, float* __restrict__ l,
              float* __restrict__ m, int S, int H, int KV, int D, int bs,
              int nb, int pps, float scale, int window, float soft_cap) {
  using namespace tile;
  using WA = PrefixTile<T, DP>;
  constexpr int BK = WA::kBk, MT = WA::kMt, R = WA::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);   // (R, DP)
  T* kv_ring = qs + R * DP;                 // stage i: K, then V (BK, DP)
  float* p_scr = reinterpret_cast<float*>(kv_ring + 4 * BK * DP);
  // (2, BK) key positions, then up to kThreads useful pages of a round
  int* pos_s = reinterpret_cast<int*>(p_scr + p_scratch_floats<WA>());
  int* pages_s = pos_s + 2 * BK;
  __shared__ int q_lo, q_hi, warp_count[kWarps];

  const int G = H / KV, rows = S * G;
  const int n_rt = (rows + R - 1) / R;
  const int split = blockIdx.x / n_rt, r0 = (blockIdx.x % n_rt) * R;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int nsplit = (nb + pps - 1) / pps;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Q tile: packed row r0 + r is query s = (r0 + r) / G of head
  // kvh * G + (r0 + r) % G
  load_rows<T, DP, R>(
      qs, nullptr, q, q, D, [&](int r) -> long long {
        const int pr = r0 + r;
        if (pr >= rows) return -1;
        return ((static_cast<long long>(b) * S + pr / G) * H + kvh * G +
                pr % G) * D;
      });
  cp_async_commit();

  // this lane's rows r0 + row0 + 16 mt + 8 rr, their positions, and the
  // warp's range of them (rows past the tile excluded)
  if (tid == 0) {
    q_lo = INT_MAX;
    q_hi = INT_MIN;
  }
  const int row0 = r0 + WA::warp_row() + lane / 4;
  int pq[MT][2];
  int w_lo = INT_MAX, w_hi = INT_MIN;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int pr = row0 + 16 * mt + 8 * rr;
      pq[mt][rr] =
          pr < rows ? pos_q[static_cast<size_t>(b) * S + pr / G] : -1;
      if (pr < rows) {
        w_lo = min(w_lo, pq[mt][rr]);
        w_hi = max(w_hi, pq[mt][rr]);
      }
    }
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) {
    w_lo = min(w_lo, __shfl_xor_sync(0xffffffffu, w_lo, x));
    w_hi = max(w_hi, __shfl_xor_sync(0xffffffffu, w_hi, x));
  }
  __syncthreads();
  if (lane == 0 && w_lo <= w_hi) {
    atomicMin(&q_lo, w_lo);
    atomicMax(&q_hi, w_hi);
  }
  __syncthreads();
  const int lo = q_lo, hi = q_hi;

  WA wa;
  wa.init();
  const size_t head = static_cast<size_t>(kvh) * D;
  const int p_begin = split * pps, p_end = min(nb, p_begin + pps);
  // The split's page slots in rounds of kThreads: each round keeps the
  // live pages holding a key some query of the tile may see, in table
  // order (a page is dropped only when no key can be visible), then walks
  // their keys (key i: row i % bs of kept page i / bs) in tiles of BK.
  for (int base = p_begin; base < p_end; base += kThreads) {
    const int j = base + tid;
    int page = -1;
    bool use = false;
    if (j < p_end) {
      page = tables[static_cast<size_t>(b) * nb + j];
      if (page >= 0) {
        const int* pp = pos_pages + static_cast<size_t>(page) * bs;
        for (int x = 0; x < bs; ++x) {
          const int p = pp[x];
          use |= p >= 0 && p <= hi && (window <= 0 || p > lo - window);
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, use);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();   // also: the previous round's tiles are consumed
    int at = 0, n_pages = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? warp_count[w] : 0;
      n_pages += warp_count[w];
    }
    if (use) pages_s[at + __popc(ballot & ((1u << lane) - 1u))] = page;
    __syncthreads();   // pages_s complete; warp_count free again

    const int n_keys = n_pages * bs;
    const int n_tiles = (n_keys + BK - 1) / BK;
    auto load_kv = [&](int i) {
      T* ks = kv_ring + (i & 1) * 2 * BK * DP;
      int* ps = pos_s + (i & 1) * BK;
      const int key0 = i * BK;
      load_rows<T, DP, BK>(
          ks, ks + BK * DP, k_pages + head, v_pages + head, D,
          [&](int r) -> long long {
            const int key = key0 + r;
            if (key >= n_keys) return -1;
            return (static_cast<long long>(pages_s[key / bs]) * bs +
                    key % bs) * KV * D;
          });
      if (tid < BK) {
        const int key = key0 + tid;
        if (key < n_keys)
          cp_async4(ps + tid,
                    pos_pages + static_cast<size_t>(pages_s[key / bs]) * bs +
                        key % bs);
        else
          ps[tid] = -1;
      }
    };
    if (n_tiles > 0) load_kv(0);
    cp_async_commit();

    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait_all();   // tile i (and, first, Q) has landed
      __syncthreads();       // ... for every thread; tile i - 1 is consumed
      if (i + 1 < n_tiles) load_kv(i + 1);
      cp_async_commit();
      const T* ks = kv_ring + (i & 1) * 2 * BK * DP;
      const int* ps = pos_s + (i & 1) * BK;
      float s[MT][BK / 8][4];
      wa.scores(s, qs, ks);
      // every key of the tile visible to every row of the warp (not
      // specialized at head_dim 256, where the registers are all taken)
      bool vis_all = DP < 256;
#pragma unroll
      for (int x = lane; x < BK; x += 32) {
        const int p = ps[x];
        vis_all &= p >= 0 && p <= w_lo && (window <= 0 || p > w_hi - window);
      }
      const bool full = DP < 256 && __all_sync(0xffffffffu, vis_all);
      wa.softmax(s, scale, soft_cap, full, [&](int mt, int rr, int key) {
        return key_visible(ps[key], pq[mt][rr], window);
      });
      wa.pv(s, ks + BK * DP, p_scr);
    }
  }
  cp_async_wait_all();
  wa.finish();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int pr = row0 + 16 * mt + 8 * rr;
      if (pr < rows)
        wa.store(mt, rr,
                 ((static_cast<size_t>(b) * nsplit + split) * S + pr / G) *
                         H +
                     kvh * G + pr % G,
                 D, o, l, m, nullptr);
    }
}

template <typename Tag, typename T, int DP>
cudaError_t launch_prefix(const void* q, const void* k_pages,
                          const void* v_pages, const void* pos_pages,
                          const void* tables, const void* pos_q, void* o,
                          void* l, void* m, int B, int S, int H, int KV, int D,
                          int bs, int nb, int pps, float scale, int window,
                          float soft_cap, cudaStream_t stream) {
  using WA = PrefixTile<T, DP>;
  constexpr int R = WA::kRows;
  const size_t smem = tile::tile_smem<WA>() +
                      (2 * WA::kBk + tile::kThreads) * sizeof(int);
  cudaError_t err = allow_smem(prefix_kernel<Tag, T, DP>, smem);
  if (err != cudaSuccess) return err;
  const long long n_rt = (static_cast<long long>(S) * (H / KV) + R - 1) / R;
  const long long nsplit = (nb + pps - 1) / pps;
  if (n_rt * nsplit > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(n_rt * nsplit), KV, B);
  prefix_kernel<Tag, T, DP><<<grid, tile::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(pos_pages),
      static_cast<const int*>(tables), static_cast<const int*>(pos_q),
      static_cast<float*>(o), static_cast<float*>(l), static_cast<float*>(m),
      S, H, KV, D, bs, nb, pps, scale, window, soft_cap);
  return cudaGetLastError();
}

template <typename Tag, typename T>
cudaError_t dispatch_prefix(const void* q, const void* k_pages,
                            const void* v_pages, const void* pos_pages,
                            const void* tables, const void* pos_q, void* o,
                            void* l, void* m, int B, int S, int H, int KV,
                            int D, int bs, int nb, int pps, float scale,
                            int window, float soft_cap, cudaStream_t stream) {
  auto go = [&](auto launch) {
    return launch(q, k_pages, v_pages, pos_pages, tables, pos_q, o, l, m, B,
                  S, H, KV, D, bs, nb, pps, scale, window, soft_cap, stream);
  };
  if (D <= 64) return go(launch_prefix<Tag, T, 64>);
  if (D <= 128) return go(launch_prefix<Tag, T, 128>);
  return go(launch_prefix<Tag, T, 256>);
}

}  // namespace repro
