// Key walk of the two decode kernels (paged_decode.cu, B1, and
// split_kv_decode.cu, B5): one block of 4 warps scores the G query rows of
// one kv head (one token each: decode) against a stream of keys, and
// writes one (o, l, m) partial for the whole stream.  B1's stream is the
// live pages of a split of the block table, B5's the key tiles of one
// block_k block that hold a valid key; the walk itself does not know which.
//
// Keys are spread over the warps, not the query rows, so G = 1 (MHA)
// keeps every warp busy.  Key tiles of BK keys (about 8 KB of K: 64 keys
// at head_dim 64 in bf16, 32 at 128 and 256; 64 int8 keys at 128) sit in
// a four-stage cp.async ring (two stages for f32 at head_dim 256) in their
// storage type (bf16 stays bf16, int8 stays int8), so three tiles are in
// flight while one is scored; of the
// ring depths (2 to 4) and tile sizes (8 to 32 KB) timed on the card at
// the smoke's shapes, this was the fastest for B1 and B5 together.  Warp
// w takes rows w * BK / 4 .. of each tile; LPK = 128 / BK lanes share a
// key, each taking a contiguous share of its 16-byte chunks, so a tile
// costs one warp-wide max per row, not one warp-wide sum per key.  Each
// lane does its share of the dot product with FMAs from shared memory (the
// query rows sit there in f32 and are read as broadcasts); the lanes of a
// key meet in log2(LPK) shuffles.  Chunk c of tile row r sits at chunk
// c ^ (r mod 8), so the 8 lanes of one 16-byte load phase, 8 consecutive
// keys, hit 8 different bank groups.
//
// Why FMAs and not mma.sync (an MMA variant was not built or timed; this
// is the reasoning): decode has G query rows per kv head, 1 for
// llama-13b and 1 to 16 in the registry, and a block takes at most 8 of
// them; an m16n8k16 tile pads them to 16 rows, so at G = 1 fifteen
// sixteenths of every MMA would be padding, and int8 pools would need a
// convert-and-store pass through shared memory before ldmatrix could read
// them.  The walk does 4 * D flops per key and query row against 4 * D
// bytes of bf16 K and V, far below the card's ~295 flop/byte ridge: the
// kernels are bound by bytes (see the two sources).
//
// Each warp keeps its own running max m, sum l (one share per lane) and
// accumulator o (lane holds D / 32 head dims of every row) across tiles;
// after the last tile the four warps' states are merged exactly in shared
// memory (m the largest, o and l weighted by exp(m_warp - m)) and the
// partial written once.  Masking follows the JAX kernels: a masked score is
// NEG_INF and its p is 0, so a stream with no visible key writes the
// all-masked partial (o = 0, l = 0, m = NEG_INF).  int8 pools fold their
// per-key scales where JAX does: the K scale multiplies the score after
// * scale and before the soft cap, l sums p before the V scale multiplies
// p ahead of the P V product.
#pragma once

#include "attn_tile.cuh"

namespace repro {
namespace dec {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N elements of TK (N * sizeof(TK) <= 16 bytes, aligned to that size)
// loaded in one access and converted to f32.
template <typename TK, int N>
struct alignas(N * sizeof(TK)) Vec {
  TK v[N];
};

template <typename TK, int N>
__device__ __forceinline__ void load_f32(const TK* p, float (&out)[N]) {
  const Vec<TK, N> w = *reinterpret_cast<const Vec<TK, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(w.v[i]);
}

// A tile of rows of DP elements of TK as 16-byte chunks; chunk c of row r
// at c ^ (r mod 8) (with 4 chunks a row, int8 at head_dim 64: two rows
// share a 128-byte line and the swizzle is (r / 2) mod 4).
template <typename TK, int DP>
struct Tile {
  static constexpr int kEpc = 16 / sizeof(TK);   // elements per chunk
  static constexpr int kCh = DP / kEpc;          // chunks per row
  static_assert(kCh == 4 || kCh % 8 == 0, "chunks per row");
  __device__ static __forceinline__ int at(int r, int c) {
    const int sw = kCh >= 8 ? (r & 7) : ((r >> 1) & (kCh - 1));
    return (r * kCh + (c ^ sw)) * kEpc;
  }
};

// The walk of one block: query rows of type TQ (RG of them, rows past the
// kv head's G zero), keys of type TK, head_dim padded to DP.
template <typename TQ, typename TK, int DP, int RG>
struct Walk {
  using L = Tile<TK, DP>;
  static constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  static constexpr int kEpc = L::kEpc, kCh = L::kCh;
  static constexpr int kBk0 = 8192 / (DP * static_cast<int>(sizeof(TK)));
  static constexpr int kBk = kBk0 < 32 ? 32 : (kBk0 > 128 ? 128 : kBk0);
  static constexpr int kLpk = kThreads / kBk;   // lanes per key: 1, 2, 4
  static constexpr int kKpw = 32 / kLpk;        // keys per warp and tile
  static constexpr int kCpl = kCh / kLpk;       // chunks per lane and key
  static constexpr int kDpl = DP / 32;          // head dims per lane in P V
  static constexpr int kPiece = kDpl < kEpc ? kDpl : kEpc;
  static_assert(kCh % kLpk == 0 && (kBk * kCh) % kThreads == 0, "tile");

  // Dynamic shared memory, in this order: the f32 query rows, the warps'
  // p scratch, the per-key meta (stage, key), for int8 pools the K and V
  // scales (stage, 2, key), then the ring of `stages` stages (stage s: K
  // then V tile), which after the walk holds the warps' states for the
  // merge.  A launch whose streams fit one tile takes a one-stage ring: it
  // has nothing to overlap, and the smaller footprint keeps more blocks on
  // an SM.
  static constexpr size_t kTileElems = static_cast<size_t>(kBk) * DP;
  // Stages of the ring: four, or two where four would not fit the SM's
  // shared memory (f32 at head_dim 256: 32 KB tiles).
  static constexpr int kStages =
      4 * 2 * kTileElems * sizeof(TK) <= 128 * 1024 ? 4 : 2;
  static constexpr size_t kPOff = RG * DP * sizeof(float);
  static constexpr size_t kMetaOff = kPOff + kWarps * RG * kKpw * sizeof(float);
  static constexpr size_t kSclOff = kMetaOff + kStages * kBk * sizeof(int);
  static constexpr size_t kRingOff =
      (kSclOff + (kQuant ? kStages * 2 * kBk * sizeof(float) : 0) + 15) / 16 *
      16;
  static constexpr size_t kMergeBytes = kWarps * RG * (DP + 2) * sizeof(float);

  // Bytes of dynamic shared memory with a ring of `stages` (1 or kStages).
  __host__ __device__ static constexpr size_t smem_bytes(int stages) {
    return kRingOff + (stages * 2 * kTileElems * sizeof(TK) > kMergeBytes
                           ? stages * 2 * kTileElems * sizeof(TK)
                           : kMergeBytes);
  }

  float o[RG][kDpl];
  float m[RG], l[RG];   // l: this lane's share until store

  unsigned char* smem;
  int stages;

  __device__ TK* k_tile(int st) const {
    return reinterpret_cast<TK*>(smem + kRingOff) + 2 * st * kTileElems;
  }
  __device__ int* meta(int st) const {
    return reinterpret_cast<int*>(smem + kMetaOff) + st * kBk;
  }
  __device__ float* scales(int st) const {
    return reinterpret_cast<float*>(smem + kSclOff) + 2 * st * kBk;
  }

  // Zero the state and stage the n_rows query rows at q (D apart) as f32
  // (plain loads; the walk's first barrier publishes them).
  __device__ void init(unsigned char* s, int n_stages,
                       const TQ* __restrict__ q, int n_rows, int D) {
    smem = s;
    stages = n_stages;
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kDpl; ++i) o[r][i] = 0.f;
    }
    float* qs = reinterpret_cast<float*>(smem);
    for (int i = threadIdx.x; i < RG * DP; i += kThreads) {
      const int r = i / DP, d = i - r * DP;
      qs[i] = r < n_rows && d < D ? to_f32(q[static_cast<size_t>(r) * D + d])
                                  : 0.f;
    }
  }

  // Issue the copies of tile rows 0 .. BK-1 into stage st: row r of K and
  // V from element offset off(r) of k / v (off < 0: zero-filled, nothing
  // read); chunks at or past D are zero-filled.  All threads take part; the
  // caller writes the stage's meta (and scales) and commits the group.
  template <typename Off>
  __device__ __forceinline__ void issue(int st, const TK* __restrict__ k,
                                        const TK* __restrict__ v, int D,
                                        Off off) const {
    TK* ks = k_tile(st);
    TK* vs = ks + kTileElems;
#pragma unroll
    for (int it = 0; it < kBk * kCh / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kCh, c = i % kCh;
      const long long o_r = off(r);
      const bool ok = o_r >= 0 && c * kEpc < D;
      const long long src = ok ? o_r + c * kEpc : 0;
      tile::cp_async16(ks + L::at(r, c), k + src, ok);
      tile::cp_async16(vs + L::at(r, c), v + src, ok);
    }
  }

  // The ring over n_tiles tiles: issue(i, st) fills stage st with tile i
  // (copies, meta and scales; it does not commit); vis(meta) says whether
  // a key is visible to every query row of the block (decode: one token,
  // one position).
  template <typename Issue, typename Vis>
  __device__ void run(int n_tiles, Issue issue_tile, Vis vis, float scale,
                      float soft_cap) {
    if (stages == 1) {
      for (int i = 0; i < n_tiles; ++i) {
        __syncthreads();   // the previous tile is consumed
        issue_tile(i, 0);
        tile::cp_async_commit();
        tile::cp_async_wait_all();
        __syncthreads();
        score(0, vis, scale, soft_cap);
      }
      return;
    }
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_tiles) issue_tile(s, s);
      tile::cp_async_commit();
    }
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<kStages - 2>();   // tile i has landed (this thread)
      __syncthreads();                // ... for all; tile i - 1 consumed
      const int nxt = i + kStages - 1;
      if (nxt < n_tiles) issue_tile(nxt, nxt % kStages);
      tile::cp_async_commit();
      score(i % kStages, vis, scale, soft_cap);
    }
  }

  template <typename Vis>
  __device__ __forceinline__ void score(int st, Vis vis, float scale,
                                        float soft_cap) {
    if (soft_cap > 0.f)
      step<true>(st, vis, scale, soft_cap);
    else
      step<false>(st, vis, scale, soft_cap);
  }

  template <bool kCap, typename Vis>
  __device__ __forceinline__ void step(int st, Vis vis, float scale,
                                       float soft_cap) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int kl = lane % kKpw, part = lane / kKpw;
    const int t = warp * kKpw + kl;   // the tile row this lane scores
    const TK* ks = k_tile(st);
    const TK* vs = ks + kTileElems;
    const float* qs = reinterpret_cast<const float*>(smem);

    float dot[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) dot[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kCpl; ++i) {
      const int c = part * kCpl + i;
      float kf[kEpc];
      load_f32<TK, kEpc>(ks + L::at(t, c), kf);
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const float* qr = qs + r * DP + c * kEpc;
#pragma unroll
        for (int e = 0; e < kEpc; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          dot[r] += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2] +
                    qv.w * kf[e + 3];
        }
      }
    }
#pragma unroll
    for (int x = kKpw; x < 32; x <<= 1)
#pragma unroll
      for (int r = 0; r < RG; ++r)
        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], x);

    const bool ok = vis(meta(st)[t]);
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      ksc = scales(st)[t];
      vsc = scales(st)[kBk + t];
    }
    float* pw = reinterpret_cast<float*>(smem + kPOff) + warp * RG * kKpw;
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      float s = dot[r] * scale;
      if constexpr (kQuant) s *= ksc;
      if constexpr (kCap) s = tanhf(s / soft_cap) * soft_cap;
      s = ok ? s : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float alpha = __expf(m[r] - m_new);
      m[r] = m_new;
      const float p = ok ? __expf(s - m_new) : 0.f;
      l[r] = l[r] * alpha + (part == 0 ? p : 0.f);
#pragma unroll
      for (int i = 0; i < kDpl; ++i) o[r][i] *= alpha;
      // a masked key's scales may be stale (rows past the stream's end
      // are not copied): its p stays exactly 0
      if (part == 0) pw[r * kKpw + kl] = kQuant && ok ? p * vsc : p;
    }
    __syncwarp();
    // o += P V over the warp's keys; lane holds head dims kDpl * lane ..
#pragma unroll 4
    for (int kk = 0; kk < kKpw; ++kk) {
      const int tv = warp * kKpw + kk;
      float vf[kDpl];
#pragma unroll
      for (int pc = 0; pc < kDpl / kPiece; ++pc) {
        const int e = lane * kDpl + pc * kPiece;
        float part_v[kPiece];
        load_f32<TK, kPiece>(vs + L::at(tv, e / kEpc) + e % kEpc, part_v);
#pragma unroll
        for (int x = 0; x < kPiece; ++x) vf[pc * kPiece + x] = part_v[x];
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const float p = pw[r * kKpw + kk];
#pragma unroll
        for (int i = 0; i < kDpl; ++i) o[r][i] += p * vf[i];
      }
    }
    __syncwarp();   // pw is rewritten by the next tile
  }

  // Merge the four warps' states and write rows 0 .. n_rows-1 of the
  // partial: o at o_out + (row0 + r) * D, l / m at row0 + r.
  __device__ void store(int n_rows, size_t row0, int D,
                        float* __restrict__ o_out, float* __restrict__ l_out,
                        float* __restrict__ m_out) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int r = 0; r < RG; ++r) l[r] = warp_sum(l[r]);
    tile::cp_async_wait_all();
    __syncthreads();   // every warp is done with the ring
    float* so = reinterpret_cast<float*>(smem + kRingOff);   // (warps, RG, DP)
    float* sm = so + kWarps * RG * DP;            // (warps, RG)
    float* sl = sm + kWarps * RG;                 // (warps, RG)
#pragma unroll
    for (int r = 0; r < RG; ++r) {
#pragma unroll
      for (int i = 0; i < kDpl; ++i)
        so[(warp * RG + r) * DP + lane * kDpl + i] = o[r][i];
      if (lane == 0) {
        sm[warp * RG + r] = m[r];
        sl[warp * RG + r] = l[r];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_rows * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w * RG + r]);
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        acc += so[(w * RG + r) * DP + d] * __expf(sm[w * RG + r] - mx);
      o_out[(row0 + r) * D + d] = acc;
    }
    for (int r = threadIdx.x; r < n_rows; r += kThreads) {
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w * RG + r]);
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        acc += sl[w * RG + r] * __expf(sm[w * RG + r] - mx);
      l_out[row0 + r] = acc;
      m_out[row0 + r] = mx;
    }
  }
};

// Query rows per block for a kv head of G query heads (RG of the walk):
// 1, 4 or 8; G > 8 takes ceil(G / 8) blocks per kv head.
inline int rows_per_block(int G) { return G == 1 ? 1 : (G <= 4 ? 4 : 8); }

// Instantiate f(Walk-shaped tag) for the head_dim and rows per block of a
// launch: DP = 64, 128 or 256 (D <= DP), RG = rows_per_block(G).
template <int DP, int RG>
struct Shape {
  static constexpr int kDp = DP, kRg = RG;
};

template <typename F>
cudaError_t dispatch_shape(int D, int G, F f) {
  const int rg = rows_per_block(G);
  if (D <= 64) {
    if (rg == 1) return f(Shape<64, 1>{});
    if (rg == 4) return f(Shape<64, 4>{});
    return f(Shape<64, 8>{});
  }
  if (D <= 128) {
    if (rg == 1) return f(Shape<128, 1>{});
    if (rg == 4) return f(Shape<128, 4>{});
    return f(Shape<128, 8>{});
  }
  if (rg == 1) return f(Shape<256, 1>{});
  if (rg == 4) return f(Shape<256, 4>{});
  return f(Shape<256, 8>{});
}

}  // namespace dec
}  // namespace repro
