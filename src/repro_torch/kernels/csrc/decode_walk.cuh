// Key walk of the decode kernels (paged_decode.cu, B1, split_kv_decode.cu,
// B5) and of speculative verify (paged_verify.cu, B4): one block of 4
// warps scores up to RG query rows of one kv head against a stream of
// keys, and writes one (o, l, m) partial per row for the whole stream.
// B1's rows are the G query heads of one decode token, B4's the S * G
// (query, head) pairs of a verify step, each at its own position; B1's and
// B4's stream is the live pages of a split of the block table
// (walk_pages), B5's the key tiles of one block_k block that hold a valid
// key; the walk itself does not know which.
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
// Why FMAs for decode and not mma.sync: decode has G query rows per kv
// head, 1 for llama-13b and 1 to 16 in the registry, and a block takes at
// most 8 of them; an m16n8k16 tile pads them to 16 rows, so at G = 1
// fifteen sixteenths of every MMA would be padding, and int8 pools would
// need a convert-and-store pass through shared memory before ldmatrix
// could read them.  The walk does 4 * D flops per key and query row
// against 4 * D bytes of bf16 K and V, far below the card's ~295
// flop/byte ridge: the kernels are bound by bytes (see the sources).  But
// every row costs the FMA walk its FMAs and its shared-memory reads of the
// query per key, which at B4's 5 to 16 rows held it far from its bound
// on the card; so B4's bf16 queries run MmaWalk, the same ring with the
// two products on mma.sync (below).
//
// Each warp keeps its own running max m, sum l (one share per lane) and
// accumulator o (lane holds D / 32 head dims of every row) across tiles;
// after the last tile the four warps' states are merged exactly in shared
// memory (m the largest, o and l weighted by exp(m_warp - m)) and the
// partial written once.  Visibility is decided per (key, query row): the
// caller's vis(meta, r) sees the key's meta (its position, or B5's
// validity flag) and the row, so B4's queries each keep their own causal
// horizon; B1 and B5 ignore r.  Masking follows the JAX kernels: a masked
// score is NEG_INF and its p is 0, so a row that sees no key of the
// stream writes the all-masked partial (o = 0, l = 0, m = NEG_INF).  int8
// pools fold their per-key scales where JAX does: the K scale multiplies
// the score after * scale and before the soft cap, l sums p before the V
// scale multiplies p ahead of the P V product.
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

// The K/V ring of a walk W (Walk or MmaWalk), which provides the layout
// constants (kBk keys a tile, kTileElems, kStages, kRows query rows, the
// shared-memory offsets kMetaOff, kSclOff, kRingOff) and score(st, vis,
// scale, soft_cap).  Keys of type TK, head_dim padded to DP.
template <typename W, typename TK, int DP>
struct Ring {
  using L = Tile<TK, DP>;
  static constexpr int kEpc = L::kEpc, kCh = L::kCh;

  unsigned char* smem;
  int stages;

  __device__ TK* k_tile(int st) const {
    return reinterpret_cast<TK*>(smem + W::kRingOff) +
           2 * st * W::kTileElems;
  }
  __device__ int* meta(int st) const {
    return reinterpret_cast<int*>(smem + W::kMetaOff) + st * W::kBk;
  }
  __device__ float* scales(int st) const {
    return reinterpret_cast<float*>(smem + W::kSclOff) + 2 * st * W::kBk;
  }

  // Bytes of dynamic shared memory with a ring of `stages` (1 or kStages):
  // after the walk the ring holds the warps' states for the merge.
  __host__ __device__ static constexpr size_t smem_bytes(int stages) {
    return W::kRingOff +
           (stages * 2 * W::kTileElems * sizeof(TK) > merge_bytes()
                ? stages * 2 * W::kTileElems * sizeof(TK)
                : merge_bytes());
  }
  __host__ __device__ static constexpr size_t merge_bytes() {
    return kWarps * W::kRows * (DP + 2) * sizeof(float);
  }

  // Issue the copies of tile rows 0 .. BK-1 into stage st: row r of K and
  // V from element offset off(r) of k / v (off < 0: zero-filled, nothing
  // read); chunks at or past D are zero-filled.  All threads take part; the
  // caller writes the stage's meta (and scales) and commits the group.
  template <typename Off>
  __device__ __forceinline__ void issue(int st, const TK* __restrict__ k,
                                        const TK* __restrict__ v, int D,
                                        Off off) const {
    static_assert((W::kBk * kCh) % kThreads == 0, "whole copy rounds");
    TK* ks = k_tile(st);
    TK* vs = ks + W::kTileElems;
#pragma unroll
    for (int it = 0; it < W::kBk * kCh / kThreads; ++it) {
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
  // (copies, meta and scales; it does not commit); vis(meta, r) says
  // whether a key is visible to query row r.
  template <typename Issue, typename Vis>
  __device__ void run(int n_tiles, Issue issue_tile, Vis vis, float scale,
                      float soft_cap) {
    W& w = static_cast<W&>(*this);
    if (stages == 1) {
      for (int i = 0; i < n_tiles; ++i) {
        __syncthreads();   // the previous tile is consumed
        issue_tile(i, 0);
        tile::cp_async_commit();
        tile::cp_async_wait_all();
        __syncthreads();
        w.score(0, vis, scale, soft_cap);
      }
      return;
    }
#pragma unroll
    for (int s = 0; s < W::kStages - 1; ++s) {
      if (s < n_tiles) issue_tile(s, s);
      tile::cp_async_commit();
    }
    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<W::kStages - 2>();   // tile i has landed (this thread)
      __syncthreads();                   // ... for all; tile i - 1 consumed
      const int nxt = i + W::kStages - 1;
      if (nxt < n_tiles) issue_tile(nxt, nxt % W::kStages);
      tile::cp_async_commit();
      w.score(i % W::kStages, vis, scale, soft_cap);
    }
  }

  // The warps' states, once the ring is drained: o (warps, rows, DP), then
  // m and l (warps, rows).
  __device__ float* state_o() const {
    return reinterpret_cast<float*>(smem + W::kRingOff);
  }
  __device__ float* state_m() const {
    return state_o() + kWarps * W::kRows * DP;
  }
  __device__ float* state_l() const { return state_m() + kWarps * W::kRows; }

  // Merge the four warps' states (written by the caller, then a barrier)
  // exactly and write rows 0 .. n_rows-1 of the partial: o at
  // o_out + out_row(r) * D, l / m at out_row(r).
  template <typename Row>
  __device__ void merge(int n_rows, int D, Row out_row,
                        float* __restrict__ o_out, float* __restrict__ l_out,
                        float* __restrict__ m_out) const {
    constexpr int R = W::kRows;
    const float* so = state_o();
    const float* sm = state_m();
    const float* sl = state_l();
    for (int i = threadIdx.x; i < n_rows * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w * R + r]);
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        acc += so[(w * R + r) * DP + d] * __expf(sm[w * R + r] - mx);
      o_out[out_row(r) * D + d] = acc;
    }
    for (int r = threadIdx.x; r < n_rows; r += kThreads) {
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[w * R + r]);
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        acc += sl[w * R + r] * __expf(sm[w * R + r] - mx);
      l_out[out_row(r)] = acc;
      m_out[out_row(r)] = mx;
    }
  }
};

// The walk of one block: query rows of type TQ (RG of them, rows past the
// block's rows zero), keys of type TK, head_dim padded to DP.
template <typename TQ, typename TK, int DP, int RG>
struct Walk : Ring<Walk<TQ, TK, DP, RG>, TK, DP> {
  using Query = TQ;
  using Key = TK;
  using L = Tile<TK, DP>;
  static constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  static constexpr bool kTensorCores = false;
  static constexpr int kRows = RG;
  static constexpr int kEpc = L::kEpc, kCh = L::kCh;
  static constexpr int kBk0 = 8192 / (DP * static_cast<int>(sizeof(TK)));
  static constexpr int kBk = kBk0 < 32 ? 32 : (kBk0 > 128 ? 128 : kBk0);
  static constexpr int kLpk = kThreads / kBk;   // lanes per key: 1, 2, 4
  static constexpr int kKpw = 32 / kLpk;        // keys per warp and tile
  static constexpr int kCpl = kCh / kLpk;       // chunks per lane and key
  static constexpr int kDpl = DP / 32;          // head dims per lane in P V
  static constexpr int kPiece = kDpl < kEpc ? kDpl : kEpc;
  static_assert(kCh % kLpk == 0, "tile");

  // Dynamic shared memory, in this order: the f32 query rows, the warps'
  // p scratch, the per-key meta (stage, key), for int8 pools the K and V
  // scales (stage, 2, key), then the ring of `stages` stages (stage s: K
  // then V tile).  A launch whose streams fit one tile takes a one-stage
  // ring: it has nothing to overlap, and the smaller footprint keeps more
  // blocks on an SM.
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

  float o[RG][kDpl];
  float m[RG], l[RG];   // l: this lane's share until store

  // Zero the state and stage the n_rows query rows, row r at q_row(r)
  // (D elements), as f32 (plain loads; the walk's first barrier publishes
  // them).
  template <typename QRow>
  __device__ void init(unsigned char* s, int n_stages, int n_rows, int D,
                       QRow q_row) {
    this->smem = s;
    this->stages = n_stages;
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kDpl; ++i) o[r][i] = 0.f;
    }
    float* qs = reinterpret_cast<float*>(s);
    for (int i = threadIdx.x; i < RG * DP; i += kThreads) {
      const int r = i / DP, d = i - r * DP;
      qs[i] = r < n_rows && d < D ? to_f32(q_row(r)[d]) : 0.f;
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
    const TK* ks = this->k_tile(st);
    const TK* vs = ks + kTileElems;
    const float* qs = reinterpret_cast<const float*>(this->smem);

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

    const int key_meta = this->meta(st)[t];
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      ksc = this->scales(st)[t];
      vsc = this->scales(st)[kBk + t];
    }
    float* pw =
        reinterpret_cast<float*>(this->smem + kPOff) + warp * RG * kKpw;
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      const bool ok = vis(key_meta, r);
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
      // a key masked for this row may carry stale scales (rows past the
      // stream's end are not copied): its p stays exactly 0
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
  // partial: o at o_out + out_row(r) * D, l / m at out_row(r).
  template <typename Row>
  __device__ void store(int n_rows, int D, Row out_row,
                        float* __restrict__ o_out, float* __restrict__ l_out,
                        float* __restrict__ m_out) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int r = 0; r < RG; ++r) l[r] = warp_sum(l[r]);
    tile::cp_async_wait_all();
    __syncthreads();   // every warp is done with the ring
    float* so = this->state_o();
    float* sm = this->state_m();
    float* sl = this->state_l();
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
    this->merge(n_rows, D, out_row, o_out, l_out, m_out);
  }
};

// The walk on the tensor cores, for bf16 query rows over bf16 or int8
// pools (B4): one row tile of 16 query rows that every warp shares, each
// warp taking its own 16 keys of each 64-key tile (the keys spread over
// the warps, as in Walk).  Q K^T and P V run on mma.sync through
// attn_tile.cuh's warp tile (P split into bf16 high and low halves, as B2
// and B3 do, for the 1e-4 parity with the f32 plain version); Q stays in
// shared memory in bf16, swizzled like the K/V tiles, and is read as A
// fragments per tile.  int8 tiles land in the ring as int8 and each warp
// converts its 16 keys to bf16 (exact) in a copy of its own before
// ldmatrix reads them; the scales fold where JAX folds them.  The FMA
// walk's cost grows with its rows (FMAs and shared-memory reads of the
// query per key and row), the tile's hardly at all up to 16.
template <int DP, typename TK = __nv_bfloat16>
struct MmaWalk : Ring<MmaWalk<DP, TK>, TK, DP> {
  using T = __nv_bfloat16;
  using Query = T;
  using Key = TK;
  using L = Tile<TK, DP>;   // the ring's tiles
  using LQ = Tile<T, DP>;   // the query tile and converted int8 tiles
  using WA = tile::WarpAttn<T, DP, 16, 1, true>;
  static constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  static constexpr bool kTensorCores = true;
  static constexpr int kDp = DP;
  static constexpr int kRows = 16;
  static constexpr int kKpw = 16;                 // keys per warp and tile
  static constexpr int kBk = kWarps * kKpw;
  static constexpr size_t kTileElems = static_cast<size_t>(kBk) * DP;
  // Four stages up to 8 KB tiles (head_dim 64 in bf16, 128 in int8), else
  // two: 64 KB of ring at head_dim 128 keeps three bf16 blocks on an SM.
  static constexpr int kStages =
      4 * 2 * kTileElems * sizeof(TK) <= 64 * 1024 ? 4 : 2;
  // Dynamic shared memory: the bf16 query tile, for int8 pools each warp's
  // bf16 copy of its 16 keys of K and V, the per-key meta (stage, key),
  // for int8 pools the K and V scales (stage, 2, key), then the ring.
  static constexpr size_t kCvtOff = kRows * DP * sizeof(T);
  static constexpr size_t kMetaOff =
      kCvtOff + (kQuant ? kWarps * 2 * kKpw * DP * sizeof(T) : 0);
  static constexpr size_t kSclOff = kMetaOff + kStages * kBk * sizeof(int);
  static constexpr size_t kRingOff =
      (kSclOff + (kQuant ? kStages * 2 * kBk * sizeof(float) : 0) + 15) / 16 *
      16;

  WA wa;

  // Zero the state and issue the copies of the n_rows query rows, row r at
  // q_row(r) (D elements, 16-byte aligned), as one cp.async group that
  // lands before the first tile.
  template <typename QRow>
  __device__ void init(unsigned char* s, int n_stages, int n_rows, int D,
                       QRow q_row) {
    this->smem = s;
    this->stages = n_stages;
    wa.init();
    T* qs = reinterpret_cast<T*>(s);
    for (int i = threadIdx.x; i < kRows * LQ::kCh; i += kThreads) {
      const int r = i / LQ::kCh, c = i % LQ::kCh;
      const bool ok = r < n_rows && c * LQ::kEpc < D;
      tile::cp_async16(qs + LQ::at(r, c),
                       ok ? q_row(r) + c * LQ::kEpc : q_row(0), ok);
    }
    tile::cp_async_commit();
  }

  template <typename Vis>
  __device__ __forceinline__ void score(int st, Vis vis, float scale,
                                        float soft_cap) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int k0 = warp * kKpw, t = lane % 4;
    const T* qs = reinterpret_cast<const T*>(this->smem);
    // the warp's keys k0 .. k0 + 15: a row offset that keeps the swizzle
    const TK* ks = this->k_tile(st) + k0 * DP;
    const TK* vs = ks + kTileElems;
    const int* mt = this->meta(st) + k0;
    typename WA::Scores s;
    if constexpr (kQuant) {
      // the warp's 16 keys of K and V as bf16 (int8 values are exact in
      // bf16), swizzled for ldmatrix
      T* k16 = reinterpret_cast<T*>(this->smem + kCvtOff) +
               warp * 2 * kKpw * DP;
      T* v16 = k16 + kKpw * DP;
      __syncwarp();   // the previous tile's products are done with them
      for (int i = lane; i < kKpw * L::kCh; i += 32) {
        const int r = i / L::kCh, c = i % L::kCh;
        to_bf16(ks + L::at(r, c), k16 + LQ::at(r, 2 * c),
                k16 + LQ::at(r, 2 * c + 1));
        to_bf16(vs + L::at(r, c), v16 + LQ::at(r, 2 * c),
                v16 + LQ::at(r, 2 * c + 1));
      }
      __syncwarp();
      wa.scores(s, qs, k16);
      // the K scale after * scale and before the soft cap, as JAX folds it
      const float* ksc = this->scales(st) + k0;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[0][j][e] = s[0][j][e] * scale * ksc[8 * j + 2 * t + (e & 1)];
      softmax(s, mt, vis, 1.f, soft_cap);
      // l is summed; the V scale multiplies p only for a key the row sees
      // (p = 0 otherwise, and a masked entry's scale slot may be stale)
      const float* vsc = this->scales(st) + kBk + k0;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[0][j][e] = s[0][j][e] != 0.f
                           ? s[0][j][e] * vsc[8 * j + 2 * t + (e & 1)]
                           : 0.f;
      wa.pv(s, v16, nullptr);
    } else {
      wa.scores(s, qs, ks);
      softmax(s, mt, vis, scale, soft_cap);
      wa.pv(s, vs, nullptr);
    }
  }

  template <typename Vis>
  __device__ __forceinline__ void softmax(typename WA::Scores& s,
                                          const int* mt, Vis vis, float scale,
                                          float soft_cap) {
    const int g = threadIdx.x % 32 / 4;
    wa.softmax(s, scale, soft_cap, false, [&](int, int rr, int key) {
      return vis(mt[key], g + 8 * rr);
    });
  }

  // 16 int8 values at src as bf16, the first 8 at lo, the rest at hi.
  __device__ static __forceinline__ void to_bf16(const int8_t* src, T* lo,
                                                 T* hi) {
    const int4 w = *reinterpret_cast<const int4*>(src);
    const int u[4] = {w.x, w.y, w.z, w.w};
    uint32_t out[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const char4 c = *reinterpret_cast<const char4*>(&u[i]);
      const __nv_bfloat162 a = __floats2bfloat162_rn(c.x, c.y);
      const __nv_bfloat162 b = __floats2bfloat162_rn(c.z, c.w);
      out[2 * i] = *reinterpret_cast<const uint32_t*>(&a);
      out[2 * i + 1] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(lo) = make_uint4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<uint4*>(hi) = make_uint4(out[4], out[5], out[6], out[7]);
  }

  template <typename Row>
  __device__ void store(int n_rows, int D, Row out_row,
                        float* __restrict__ o_out, float* __restrict__ l_out,
                        float* __restrict__ m_out) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    wa.finish();
    tile::cp_async_wait_all();
    __syncthreads();   // every warp is done with the ring
    float* so = this->state_o();
    float* sm = this->state_m();
    float* sl = this->state_l();
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * kRows + g + 8 * rr;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        so[r * DP + 8 * n + 2 * t] = wa.o[0][n][2 * rr];
        so[r * DP + 8 * n + 2 * t + 1] = wa.o[0][n][2 * rr + 1];
      }
      if (t == 0) {
        sm[r] = wa.m[0][rr];
        sl[r] = wa.l[0][rr];
      }
    }
    __syncthreads();
    this->merge(n_rows, D, out_row, o_out, l_out, m_out);
  }
};

// The paged stream of B1 and B4: the keys of page slots p_begin ..
// p_end - 1 of one block-table row (table, nb wide).  The block resolves
// the slots itself, kThreads a round, and keeps the live ones in table
// order (a dead entry, -1, is never read: neither its page nor its
// positions or scales); key i of a round is row i % bs of kept page
// i / bs.  K/V rows are cp.async'd from the pool's strided layout (rows
// KV * D apart, kv head kvh) into the walk's ring, each key's position
// (and, for int8 pools, its two scales) copied beside it; vis(pos, r)
// decides per query row.  pages_s holds kThreads ints of shared memory,
// warp_count kWarps.
template <typename W, typename TK, typename Vis>
__device__ void walk_pages(W& walk, int* pages_s, int* warp_count,
                           const int* __restrict__ table, int p_begin,
                           int p_end, const TK* __restrict__ k_pages,
                           const TK* __restrict__ v_pages,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ pos_pages, int bs, int KV,
                           int D, int kvh, Vis vis, float scale,
                           float soft_cap) {
  constexpr int BK = W::kBk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const TK* kh = k_pages + static_cast<size_t>(kvh) * D;
  const TK* vh = v_pages + static_cast<size_t>(kvh) * D;
  for (int base = p_begin; base < p_end; base += kThreads) {
    const int j = base + tid;
    const int page = j < p_end ? table[j] : -1;
    const bool use = page >= 0;
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
    auto entry = [&](int key) -> long long {   // pool entry of a kept key
      return static_cast<long long>(pages_s[key / bs]) * bs + key % bs;
    };
    auto issue = [&](int i, int st) {
      const int key0 = i * BK;
      walk.issue(st, kh, vh, D, [&](int r) -> long long {
        const int key = key0 + r;
        return key < n_keys ? entry(key) * KV * D : -1;
      });
      if (tid < BK) {
        const int key = key0 + tid;
        int* meta = walk.meta(st);
        if (key < n_keys) {
          const long long e = entry(key);
          tile::cp_async4(meta + tid, pos_pages + e);
          if constexpr (W::kQuant) {
            float* sc = walk.scales(st);
            tile::cp_async4(sc + tid, k_scale + e * KV + kvh);
            tile::cp_async4(sc + BK + tid, v_scale + e * KV + kvh);
          }
        } else {
          meta[tid] = -1;   // past the kept keys: masked
        }
      }
    };
    walk.run((n_keys + BK - 1) / BK, issue, vis, scale, soft_cap);
  }
}

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
