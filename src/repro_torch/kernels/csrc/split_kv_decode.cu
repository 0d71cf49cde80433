// Split-KV decode over a dense cache: one decode query per sequence scored
// against one block of block_k keys, emitting that block's (o, l, m)
// partial; ops.decode_attention combines the blocks exactly (flash
// decoding), and ops.decode_partials hands the raw partials to attention
// migration.
//
// Replaces the TPU kernel src/repro/kernels/split_kv_decode.py
// (_decode_kernel / split_kv_decode_partials).  On the TPU one grid step
// holds a whole 512-key block of K and V (all kv heads) in VMEM and scores
// it in one shot.  Here one block of 4 warps owns (sequence, key block j,
// kv head, a group of up to 8 of its G query heads) and walks the block's
// keys with the key walk of decode_walk.cuh, which B1 shares: K/V tiles in
// a four-stage cp.async ring in their storage type, the keys spread over
// the warps, one warp-wide max per tile and row, and the warps' running
// states merged exactly at the end into the same partial as the TPU
// kernel's, up to float association.  The block first copies its block_k
// validity flags to shared memory and walks only the tiles that hold a
// valid key: a tile with none is never read.  Masking follows the JAX
// kernel: a finite NEG_INF = -1e30, p zeroed where the key is invalid, so
// a fully invalid block gives l = 0; no soft cap and no window.
//
// K and V may be a contiguous range of kv heads of a wider cache: key t of
// row b starts (b * L + t) * KVS * D elements in, head h of the range h * D
// after that, with KVS >= KV the cache's own head count (KVS = KV for a
// whole cache).  Fig. 4's head offload scores each branch's heads in
// place that way, without copying them out.  Unlike the TPU kernel, L need
// not be a multiple of block_k: the last block is ragged, so a dense
// serving cache of any length (1000 keys at max_len 1000) is read in place
// with no padded copy.
//
// Bound on the H100: bytes.  Each key's K and V are read once per kv head
// and do 4 * G * D flops, about G flops per byte of bf16 cache, far below
// the card's ~295 flop/byte ridge; the walk keeps three tiles in flight
// while it scores a fourth.
#include <climits>

#include "decode_walk.cuh"

namespace repro {

// q: (B, H, D); k, v: (B, L, KV, D) with keys KVS heads apart; valid:
// (B, L) uint8; J = ceil(L / bk) key blocks, the last one ragged (its keys
// past L count as invalid).  o: (B, J, H, D) f32; l, m: (B, J, H) f32.
// blockIdx.x = j * n_grp + query-head group.
template <typename T, int DP, int RG>
__global__ void __launch_bounds__(dec::kThreads)
split_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const unsigned char* __restrict__ valid,
                    float* __restrict__ o, float* __restrict__ l,
                    float* __restrict__ m, int H, int KV, int KVS, int D,
                    int L, int bk, int J, int n_grp, int stages,
                    float scale) {
  using W = dec::Walk<T, T, DP, RG>;
  constexpr int BK = W::kBk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_all = (bk + BK - 1) / BK;   // tiles of the key block
  int* tile_any =   // (n_all,)
      reinterpret_cast<int*>(smem_raw + W::smem_bytes(stages));
  int* tiles_s = tile_any + n_all;     // indices of tiles with a valid key
  unsigned char* valid_s = reinterpret_cast<unsigned char*>(tiles_s + n_all);
  __shared__ int n_tiles_s;

  const int j = blockIdx.x / n_grp, grp = blockIdx.x % n_grp;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, g0 = grp * RG, n_rows = min(RG, G - g0);
  const int tid = threadIdx.x, lane = tid % 32;
  const int n_keys = min(bk, L - j * bk);   // the last block is ragged
  const size_t key0 = static_cast<size_t>(b) * L + static_cast<size_t>(j) * bk;

  for (int t = tid; t < n_all; t += dec::kThreads) tile_any[t] = 0;
  __syncthreads();
  for (int i = tid; i < bk; i += dec::kThreads) {
    const unsigned char f = i < n_keys ? valid[key0 + i] : 0;
    valid_s[i] = f;
    if (f) tile_any[i / BK] = 1;
  }
  const size_t head0 = static_cast<size_t>(b) * H + kvh * G + g0;
  W walk;
  walk.init(smem_raw, stages, n_rows, D,
            [&](int r) { return q + (head0 + r) * D; });
  __syncthreads();
  if (tid < 32) {   // compact the tiles with a valid key, in order
    int n = 0;
    for (int base = 0; base < n_all; base += 32) {
      const bool any = base + lane < n_all && tile_any[base + lane];
      const unsigned ballot = __ballot_sync(0xffffffffu, any);
      if (any) tiles_s[n + __popc(ballot & ((1u << lane) - 1u))] = base + lane;
      n += __popc(ballot);
    }
    if (lane == 0) n_tiles_s = n;
  }
  __syncthreads();

  const T* kh = k + static_cast<size_t>(kvh) * D;
  const T* vh = v + static_cast<size_t>(kvh) * D;
  auto issue = [&](int i, int st) {
    const int t0 = tiles_s[i] * BK;
    walk.issue(st, kh, vh, D, [&](int r) -> long long {
      const int key = t0 + r;
      return key < n_keys ? static_cast<long long>(key0 + key) * KVS * D
                          : -1;
    });
    if (tid < BK) {
      const int key = t0 + tid;
      walk.meta(st)[tid] = key < n_keys ? valid_s[key] : 0;
    }
  };
  walk.run(n_tiles_s, issue, [](int ok, int) { return ok != 0; }, scale,
           0.f);
  const size_t row0 = (static_cast<size_t>(b) * J + j) * H + kvh * G + g0;
  walk.store(n_rows, D, [&](int r) { return row0 + r; }, o, l, m);
}

// Dynamic shared memory of a launch: the walk's, then the tile flags and
// list (ints) and the block's validity flags.
template <typename W>
size_t split_decode_smem(int stages, int bk) {
  const size_t n_all = (bk + W::kBk - 1) / W::kBk;
  return W::smem_bytes(stages) + 2 * n_all * sizeof(int) + bk;
}

template <typename T>
cudaError_t launch_split_decode(const void* q, const void* k, const void* v,
                                const void* valid, void* o, void* l, void* m,
                                int B, int H, int KV, int KVS, int D, int L,
                                int bk, float scale, cudaStream_t stream) {
  if (B <= 0 || L <= 0) return cudaSuccess;
  if (KV <= 0 || KVS < KV || H % KV != 0 || D <= 0 || D > 256 ||
      D % 8 != 0 ||
      bk <= 0 || bk > 16384 || KV > 65535 || B > 65535 ||
      !aligned16(k, v))
    return cudaErrorInvalidValue;
  const int J = (L + bk - 1) / bk;
  const int G = H / KV, rg = dec::rows_per_block(G);
  const int n_grp = (G + rg - 1) / rg;
  if (static_cast<long long>(J) * n_grp > INT_MAX)
    return cudaErrorInvalidValue;
  return dec::dispatch_shape(D, G, [&](auto sh) -> cudaError_t {
    constexpr int DP = decltype(sh)::kDp, RG = decltype(sh)::kRg;
    using W = dec::Walk<T, T, DP, RG>;
    auto kernel = split_decode_kernel<T, DP, RG>;
    // a one-stage ring when a key block fits one tile
    const int stages = bk <= W::kBk ? 1 : W::kStages;
    const size_t smem = split_decode_smem<W>(stages, bk);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(J * n_grp), KV, B);
    kernel<<<grid, dec::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const unsigned char*>(valid),
        static_cast<float*>(o), static_cast<float*>(l),
        static_cast<float*>(m), H, KV, KVS, D, L, bk, J, n_grp, stages,
        scale);
    return cudaGetLastError();
  });
}

}  // namespace repro

// q: (B, H, D); k, v: (B, L, KV, D), consecutive keys kv_stride >= KV
// heads apart (a range of a wider cache's heads); valid: (B, L) uint8;
// bk <= 16384, the last block of keys ragged when bk does not divide L; D a
// multiple of 8 up to 256; k and v 16-byte aligned.
// o: (B, ceil(L / bk), H, D) f32; l, m: (B, ceil(L / bk), H) f32.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int split_kv_decode_partials(const void* q, const void* k,
                                        const void* v, const void* valid,
                                        void* o, void* l, void* m, int B,
                                        int H, int KV, int kv_stride, int D,
                                        int L, int bk, float scale,
                                        int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return repro::launch_split_decode<float>(q, k, v, valid, o, l, m, B, H,
                                             KV, kv_stride, D, L, bk, scale,
                                             st);
  if (dtype == repro::DTYPE_BF16)
    return repro::launch_split_decode<__nv_bfloat16>(
        q, k, v, valid, o, l, m, B, H, KV, kv_stride, D, L, bk, scale, st);
  return cudaErrorInvalidValue;
}
