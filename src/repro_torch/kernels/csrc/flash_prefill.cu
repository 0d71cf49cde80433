// Causal GQA flash attention for prefill, with sliding window, soft cap and
// a query position offset; writes the normalized output or the
// unnormalized (o, l, m) partials of chunked prefill's in-flight suffix.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py
// (_flash_kernel / flash_prefill).  The TPU kernel walks the KV blocks as
// a sequential grid axis with (m, l, acc) carried in VMEM scratch; here
// one block of 4 warps owns 64 query rows of one (sequence, head) and
// loops over key tiles itself (attn_tile.cuh): K/V tiles stay in their
// input type in a two-stage shared-memory ring filled by 16-byte
// cp.async, the next tile in flight while the current one is scored; each
// warp keeps its 16 rows' scores, running max/sum and accumulator in
// registers.  GQA goes through h / G in the K/V offsets.  Key tiles wholly
// in the future of the query tile (or before its window) are skipped,
// which leaves the result unchanged: a fully masked tile scales the
// running state by exp(0) = 1 and adds nothing.  Blocks start with the
// longest causal rows.
//
// Bound on the H100: bytes for short chunks (q, k, v read once, the output
// written once: 4 S D bytes per head in bf16 against 2 S^2 D flops), the
// tensor cores' rate at long sequences.  bf16 runs both products on the
// tensor cores (mma.sync m16n8k16; P V as two bf16 MMAs of P's high and
// low halves, to keep the f32 parity), f32 (tests only) on the FMA units.
// Not yet done: wgmma and TMA, a persistent grid.
#include "attn_tile.cuh"

namespace repro {

// One row tile of 16 per warp, 64 query rows per block (with two, a
// 256-token chunk gives 2 blocks per (sequence, head), too few for the
// card, and head_dim 128 spills); 64 keys per tile up to head_dim 128, 32
// at 256.
template <typename T, int DP>
using FlashTile = tile::WarpAttn<T, DP, DP <= 128 ? 64 : 32, 1>;

// q: (B, S, H, D); k, v: (B, L, KV, D).  Queries sit at positions
// seq_offset + r of the key axis.  partials: o_part (B, S, H, D) f32 and
// l, m (B, S, H) f32; otherwise out (B, S, H, D) in T.  DP is D padded to
// 64, 128 or 256.
template <typename T, int DP>
__global__ void __launch_bounds__(tile::kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ o_part,
             float* __restrict__ l_out, float* __restrict__ m_out,
             T* __restrict__ out, int S, int L, int H, int KV, int D,
             int seq_offset, float scale, int window, float soft_cap) {
  using namespace tile;
  using WA = FlashTile<T, DP>;
  constexpr int BK = WA::kBk, MT = WA::kMt, R = WA::kRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);   // (R, DP)
  T* kv_ring = qs + R * DP;                 // stage i: K, then V (BK, DP)
  float* p_scr = reinterpret_cast<float*>(kv_ring + 4 * BK * DP);

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x % 32;
  const int q0 = qt * R;

  // Q tile: row r is query q0 + r
  load_rows<T, DP, R>(
      qs, nullptr, q + (static_cast<size_t>(b) * S * H + h) * D, q, D,
      [&](int r) -> long long {
        return q0 + r < S ? static_cast<long long>(q0 + r) * H * D : -1;
      });

  // keys the tile's queries can see: causal end, window start
  const int r_last = min(q0 + R, S) - 1;
  const int k_end = min(L, seq_offset + r_last + 1);
  int k_begin = 0;
  if (window > 0) {
    k_begin = max(0, seq_offset + q0 - window + 1);
    k_begin -= k_begin % BK;
  }
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const size_t kv_base = static_cast<size_t>(b) * L * KV * D +
                         static_cast<size_t>(kvh) * D;
  auto load_kv = [&](int i) {
    T* ks = kv_ring + (i & 1) * 2 * BK * DP;
    const int k0 = k_begin + i * BK;
    load_rows<T, DP, BK>(ks, ks + BK * DP, k + kv_base, v + kv_base, D,
                         [&](int r) -> long long {
                           return k0 + r < L
                                      ? static_cast<long long>(k0 + r) * KV * D
                                      : -1;
                         });
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();   // Q and the first tile

  WA wa;
  wa.init();
  // this lane's rows: row0 + 16 mt + 8 rr; the warp's first and last
  // query positions
  const int row0 = q0 + WA::warp_row() + lane / 4;
  const int w_first = seq_offset + q0 + WA::warp_row();
  const int w_last = w_first + 16 * MT - 1;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();   // tile i (and, first, Q) has landed
    __syncthreads();       // ... for every thread; tile i - 1 is consumed
    if (i + 1 < n_tiles) load_kv(i + 1);
    cp_async_commit();
    const T* ks = kv_ring + (i & 1) * 2 * BK * DP;
    const int k0 = k_begin + i * BK;
    float s[MT][BK / 8][4];
    wa.scores(s, qs, ks);
    // every key of the tile visible to every row of the warp
    const bool full = k0 + BK <= L && k0 + BK - 1 <= w_first &&
                      (window <= 0 || k0 > w_last - window);
    wa.softmax(s, scale, soft_cap, full, [&](int mt, int rr, int key) {
      const int kk = k0 + key;
      return kk < L &&
             key_visible(kk, seq_offset + row0 + 16 * mt + 8 * rr, window);
    });
    wa.pv(s, ks + BK * DP, p_scr);
  }
  cp_async_wait_all();
  wa.finish();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = row0 + 16 * mt + 8 * rr;
      if (r < S)
        wa.store(mt, rr, (static_cast<size_t>(b) * S + r) * H + h, D,
                 o_part, l_out, m_out, out);
    }
}

template <typename T, int DP>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* o, void* l, void* m, int B, int S, int L,
                         int H, int KV, int D, int seq_offset, float scale,
                         int window, float soft_cap, int partials,
                         cudaStream_t stream) {
  using WA = FlashTile<T, DP>;
  const size_t smem = tile::tile_smem<WA>();
  cudaError_t err = allow_smem(flash_kernel<T, DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + WA::kRows - 1) / WA::kRows, H, B);
  flash_kernel<T, DP><<<grid, tile::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), partials ? static_cast<float*>(o) : nullptr,
      static_cast<float*>(l), static_cast<float*>(m),
      partials ? nullptr : static_cast<T*>(o), S, L, H, KV, D, seq_offset,
      scale, window, soft_cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(const void* q, const void* k, const void* v,
                           void* o, void* l, void* m, int B, int S, int L,
                           int H, int KV, int D, int seq_offset, float scale,
                           int window, float soft_cap, int partials,
                           cudaStream_t stream) {
  if (D <= 64)
    return launch_flash<T, 64>(q, k, v, o, l, m, B, S, L, H, KV, D,
                               seq_offset, scale, window, soft_cap, partials,
                               stream);
  if (D <= 128)
    return launch_flash<T, 128>(q, k, v, o, l, m, B, S, L, H, KV, D,
                                seq_offset, scale, window, soft_cap,
                                partials, stream);
  return launch_flash<T, 256>(q, k, v, o, l, m, B, S, L, H, KV, D,
                              seq_offset, scale, window, soft_cap, partials,
                              stream);
}

}  // namespace repro

// o is the f32 partial output when partials != 0 (then l, m are written),
// else the normalized output in the input type (l, m unused).  D must be
// a multiple of 8 and at most 256, and q, k, v, o 16-byte aligned.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* o, void* l, void* m, int B, int S, int L,
                             int H, int KV, int D, int seq_offset,
                             float scale, int window, float soft_cap,
                             int partials, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      H > 65535 || B > 65535 || L < 0 || !repro::aligned16(q, k, v, o))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return repro::dispatch_flash<float>(q, k, v, o, l, m, B, S, L, H, KV, D,
                                        seq_offset, scale, window, soft_cap,
                                        partials, st);
  if (dtype == repro::DTYPE_BF16)
    return repro::dispatch_flash<__nv_bfloat16>(
        q, k, v, o, l, m, B, S, L, H, KV, D, seq_offset, scale, window,
        soft_cap, partials, st);
  return cudaErrorInvalidValue;
}
