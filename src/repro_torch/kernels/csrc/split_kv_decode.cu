// Split-KV decode over a dense cache: one decode query per sequence scored
// against one block of block_k keys, emitting that block's (o, l, m)
// partial; ops.decode_attention combines the blocks exactly (flash
// decoding), and ops.decode_partials hands the raw partials to attention
// migration.
//
// Replaces the TPU kernel src/repro/kernels/split_kv_decode.py
// (_decode_kernel / split_kv_decode_partials).  On the TPU one grid step
// holds a whole 512-key block of K and V (all kv heads) in VMEM and scores
// it in one shot.  512 keys x D 128 of K and V in f32 would take 512 KB of
// shared memory per kv head, so here one block owns (sequence, key block
// j, kv head) and walks its keys in 32-key tiles staged in shared memory
// as f32, keeping a running max, sum and output inside the block (the
// online softmax) and writing one partial per key block at the end: the
// same partial as the TPU kernel's, up to float association.  A tile's
// phases spread over all four warps whatever G is: scores one (query row,
// key) pair per warp, the softmax update one query row per warp, the PV
// product one (query row, dimension) per thread.  Masking follows the JAX
// kernel: a finite NEG_INF = -1e30, p zeroed where the key is invalid, so
// a fully invalid block gives l = 0; no soft cap and no window.
//
// Bound on the H100: bytes.  Each key's K and V are read once per kv head
// and do 4 * G * D flops, about G flops per byte of bf16 cache, far below
// the card's ~295 flop/byte ridge.  Tiles are staged in 16-byte words
// (common.cuh stage_kv) where the head_dim and alignment allow.  Not yet
// done: a double-buffered tile ring (cp.async / TMA) so loads overlap the
// math.
#include "common.cuh"

namespace repro {

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecTile = 32;     // keys per shared-memory tile (one per lane)

inline size_t split_decode_smem(int G, int D) {
  return (2 * static_cast<size_t>(kDecTile) * D    // K, V tile
          + 2 * static_cast<size_t>(G) * D         // q rows, accumulators
          + static_cast<size_t>(G) * kDecTile      // scores / probabilities
          + 3 * static_cast<size_t>(G)) * sizeof(float)   // m, l, alpha
         + kDecTile * sizeof(int);                 // tile validity
}

// q: (B, H, D); k, v: (B, L, KV, D); valid: (B, L) uint8; L = J * bk.
// o: (B, J, H, D) f32; l, m: (B, J, H) f32.
template <typename T>
__global__ void __launch_bounds__(kDecThreads)
split_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const unsigned char* __restrict__ valid,
                    float* __restrict__ o, float* __restrict__ l,
                    float* __restrict__ m, int H, int KV, int D, int L,
                    int bk, int J, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x, j = blockIdx.y, kvh = blockIdx.z;
  const int G = H / KV;
  float* ks = smem;                         // (kDecTile, D)
  float* vs = ks + kDecTile * D;            // (kDecTile, D)
  float* qs = vs + kDecTile * D;            // (G, D)
  float* acc = qs + G * D;                  // (G, D)
  float* sc = acc + G * D;                  // (G, kDecTile)
  float* m_run = sc + G * kDecTile;         // (G,)
  float* l_run = m_run + G;                 // (G,)
  float* alpha = l_run + G;                 // (G,)
  int* vm = reinterpret_cast<int*>(alpha + G);   // (kDecTile,)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t q_base = (static_cast<size_t>(b) * H + kvh * G) * D;
  for (int i = tid; i < G * D; i += kDecThreads) {
    qs[i] = to_f32(q[q_base + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < G; r += kDecThreads) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
  }
  const size_t key0 = static_cast<size_t>(b) * L + static_cast<size_t>(j) * bk;

  for (int t0 = 0; t0 < bk; t0 += kDecTile) {
    const int n = min(kDecTile, bk - t0);
    // 1. stage the tile (keys past the block's end are invalid zeros)
    const size_t head0 = ((key0 + t0) * KV + kvh) * D;
    stage_kv(k + head0, v + head0, static_cast<size_t>(KV) * D, n, D, ks, vs,
             vec != 0, kDecThreads);
    for (int i = n * D + tid; i < kDecTile * D; i += kDecThreads) {
      ks[i] = 0.f;
      vs[i] = 0.f;
    }
    for (int t = tid; t < kDecTile; t += kDecThreads)
      vm[t] = t < n ? valid[key0 + t0 + t] != 0 : 0;
    __syncthreads();
    // 2. masked scores, one (row, key) pair per warp at a time
    for (int pr = warp; pr < G * kDecTile; pr += kDecWarps) {
      const int r = pr / kDecTile, t = pr - r * kDecTile;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += qs[r * D + d] * ks[t * D + d];
      dot = warp_sum(dot) * scale;
      if (lane == 0) sc[pr] = vm[t] ? dot : NEG_INF;
    }
    __syncthreads();
    // 3. online softmax update, one row per warp, lane = key
    for (int r = warp; r < G; r += kDecWarps) {
      const float s = sc[r * kDecTile + lane];
      const float m_old = m_run[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = vm[lane] ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      sc[r * kDecTile + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[r] = a;
        l_run[r] = l_run[r] * a + psum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();
    // 4. rescale and accumulate P V, one (row, dimension) per thread
    for (int i = tid; i < G * D; i += kDecThreads) {
      const int r = i / D, d = i - r * D;
      const float* pr = sc + r * kDecTile;
      float a = acc[i] * alpha[r];
      for (int t = 0; t < kDecTile; ++t) a += pr[t] * vs[t * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  const size_t out_row = (static_cast<size_t>(b) * J + j) * H + kvh * G;
  for (int i = tid; i < G * D; i += kDecThreads) o[out_row * D + i] = acc[i];
  for (int r = tid; r < G; r += kDecThreads) {
    l[out_row + r] = l_run[r];
    m[out_row + r] = m_run[r];
  }
}

template <typename T>
cudaError_t launch_split_decode(const void* q, const void* k, const void* v,
                                const void* valid, void* o, void* l, void* m,
                                int B, int H, int KV, int D, int L, int bk,
                                float scale, cudaStream_t stream) {
  if (B <= 0 || L <= 0) return cudaSuccess;
  if (KV <= 0 || H % KV != 0 || D <= 0 || bk <= 0 || L % bk != 0 ||
      L / bk > 65535 || KV > 65535)
    return cudaErrorInvalidValue;
  const int J = L / bk;
  const size_t smem = split_decode_smem(H / KV, D);
  cudaError_t err = allow_smem(split_decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, J, KV);
  split_decode_kernel<T><<<grid, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(valid),
      static_cast<float*>(o), static_cast<float*>(l), static_cast<float*>(m),
      H, KV, D, L, bk, J, scale, vec_ok<T>(D, k, v));
  return cudaGetLastError();
}

}  // namespace repro

// q: (B, H, D); k, v: (B, L, KV, D); valid: (B, L) uint8; L a multiple of
// bk.  o: (B, L / bk, H, D) f32; l, m: (B, L / bk, H) f32.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int split_kv_decode_partials(const void* q, const void* k,
                                        const void* v, const void* valid,
                                        void* o, void* l, void* m, int B,
                                        int H, int KV, int D, int L, int bk,
                                        float scale, int dtype,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32)
    return repro::launch_split_decode<float>(q, k, v, valid, o, l, m, B, H,
                                             KV, D, L, bk, scale, st);
  if (dtype == repro::DTYPE_BF16)
    return repro::launch_split_decode<__nv_bfloat16>(
        q, k, v, valid, o, l, m, B, H, KV, D, L, bk, scale, st);
  return cudaErrorInvalidValue;
}
