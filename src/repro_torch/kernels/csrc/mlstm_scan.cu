// The mLSTM recurrence over a whole sequence, forward and backward: the
// port's counterpart of the jax.lax.scan in src/repro/models/layers.py
// (mlstm_apply).  No TPU kernel: XLA compiles that scan into one loop on
// the device and differentiates through it; PyTorch has no scan, and a
// loop stepped from Python costs ~14 small kernels per token and layer.
//
// Forward, per (b, h) and step t, in f32 and in JAX's order:
//   a = log_f + m;  m' = max(a, log_i);
//   f' = exp(a - m');  i' = exp(log_i - m')
//   C = f' C + i' v k^T;  n = f' n + i' k;  s = n . q
//   y = C q / max(|s|, exp(-m'))
// Two designs, chosen by shape before any launch (xlstm_scan.mlstm_route):
//
// * The chunkwise forward (mlstm_scan_forward_chunkwise), for S > 1: the
//   xLSTM paper's chunkwise form (arXiv:2405.04517), parallel within a
//   chunk of L = 32 steps, recurrent between chunks.  Three launches:
//   - gates_kernel: m_t by the sequential recurrence above, exactly as JAX
//     steps it (a scalar per (b, h) and step, one warp each, the next
//     chunk's gates loaded while one is walked), and F_t, the running sum
//     of log f within t's chunk.  Since prod_{r=s+1..t} f'_r = exp(F_t -
//     F_s + m_s - m_t), the weight of v_s k_s^T in C_t within a chunk is
//     W_ts = exp(log_i_s + F_t - F_s - m_t), and the carried state decays
//     by exp(F_t + m_prev - m_t), m_prev the m before the chunk: every
//     exponent is <= 0 in exact arithmetic (m_t >= log_i_s + F_t - F_s), so
//     nothing overflows.  It also writes each chunk's state weights g_s =
//     W_{last,s} and its decay a = exp(F_last + m_prev - m_last).
//   - states_kernel: the chain of chunk states, the only sequential part,
//     over S / L chunks instead of S steps: C_{j+1} = a_j C_j + sum_s g_s
//     v_s k_s^T, n alike.  A block keeps a 32 x 64 tile of C (value rows x
//     key columns) in registers and walks the chunks, its tiles of v and k
//     and the chunk's g and a brought into shared memory by cp.async two
//     chunks ahead (a ring of three); it stores the state before every
//     chunk, which a recorded forward keeps as its checkpoints (ckC, ckn)
//     and the outputs read.
//   - out_kernel, every chunk at once: P = Q K^T and n_j . q over D in
//     slabs of up to 256 columns (cp.async; one slab at xlstm-350m's D =
//     256, so each phase waits for its copies once: smaller slabs left the
//     kernel waiting a memory latency per slab), A = W o P (causal), s_t =
//     decay_t n_j . q_t + sum_s A_ts, den_t = max(|s_t|, exp(-m_t)); then per
//     tile of 64 value rows, Y = Q C_j^T and y_t = (decay_t Y_t + (A V)_t) /
//     den_t.
//   The products run on the FMA units in f32: at xlstm-350m's widths the
//   whole call is ~2-5 GFLOP (~30-75 us at the f32 FMA peak), and the
//   plain version's 1e-4 parity rules out plain TF32 on the tensor cores;
//   split TF32 (three products each) is the next step if the products, not
//   the state chain, come to set the time.
// * The one-pass forward (mlstm_scan_forward), for S = 1 (a decode step:
//   one plain launch, which a captured CUDA graph replays) and shapes the
//   chunkwise kernels do not take (D not a multiple of 4, or a recorded
//   chunk other than L).  One block owns kFwdRows value rows of one (b,
//   h)'s C (D x D) in registers, one column per thread.  The stabilizer m
//   and the normalizer n are computed redundantly by every block of (b, h):
//   the same operations in the same order give the same bits, so blocks
//   share nothing.  Per step a block reduces s and its rows of C q over its
//   threads (one barrier); the next step's q, k, v and gates are loaded
//   while this one computes.  Bound: S times the latency of one step.
// A recorded forward (chunk > 0) writes the carries before every chunk-th
// step and every step's m' and s for the backward, in either design.
//
// Backward, given dy (the gradient of y; the carries take none), in two
// designs chosen by shape (xlstm_scan.mlstm_bwd_route):
//
// * The chunkwise backward (mlstm_scan_backward_chunkwise), for every
//   forward recorded with chunk L = 32 (the wrapper zero-pads a D that is
//   no multiple of 4 to one): the chunkwise forward differentiated,
//   reading only what the forward saved (the state before every chunk,
//   each step's m' and s, y).  Within chunk j, with x_t
//   = log f'_t and z_s = log i'_s, C_t = dec_t C_j + sum_{s<=t} W_ts v_s
//   k_s^T (n alike; dec_t = exp(F_t + m_prev - m_t), W_ts = exp(log_i_s +
//   F_t - F_s - m_t) as the forward has them) and C_{j+1} = a_j C_j +
//   sum_s g_s v_s k_s^T.  Five launches (three a window of chunk-end
//   gradients):
//   - bgates_kernel, all steps at once: bwd_prep_kernel's ds and dmg, den,
//     F, dec from the saved m (never recomputed), the chunk decays a_j.
//   - dstates_kernel, the only sequential part, S / L chunks: G_j =
//     dC_{j+1} arrives at chunk j's end, dC_j = a_j G_j + sum_t (dec_t /
//     den_t) dy_t q_t^T (dn alike with dec_t ds_t q_t), states_kernel's
//     tiling and cp.async ring run in reverse; it stores every G_j, a
//     window of them at a time (xlstm_scan.mlstm_window's 64 MiB).
//   - bsmall_kernel, every chunk at once: the 32 x 32 in-chunk matrices
//     P = Q K^T, X = dY V^T / den + ds, A = W o P, E = W o X, R = A o X.
//   - bchunk_kernel, every chunk and column tile at once: U = dY C_j / den
//     and VG = V G_j in one pass over C_j's and G_j's rows, G_j k in a
//     second; dq_t = dec_t (U_t + ds_t n_j) + (E K)_t, dk_s = g_s (VG_s +
//     dn_{j+1}) + (E^T Q)_s, dv_s = g_s G_j k_s + (A^T dY / den)_s, each
//     written once (no per-block partials of dq, dk); the log gates' terms
//     Delta_t = dec_t (U_t . q_t + ds_t n_j . q_t), Rout_s = g_s (VG_s . k_s +
//     dn_{j+1} . k_s) and Delta_out = a_j (<G_j, C_j> + dn_{j+1} . n_j) as
//     a partial sum per column tile.
//   - cmrev_kernel: d z_s = sum_{t>=s} R_ts + Rout_s and d x_r = sum_{t>=r}
//     Delta_t + Delta_out + sum_{t>=r, s<r} R_ts + sum_{s<r} Rout_s within
//     each chunk, then mrev_kernel's scalar reverse of the m recurrence
//     with d x and d z in place of dF f' and dI i' (the same function: the
//     intermediate m's cancel in the chunk's exponents).
//   The products run on the FMA units in f32, as the forward's do.  Bound:
//   the chain's S / L chunks of latency and the products' 4 D^2 FMAs a
//   step (the chain's rank-1 update, U, VG, G_j k; the in-chunk matrices
//   add ~5 L D / 2); tests/test_torch_xlstm_scan.py holds the same
//   arithmetic in plain PyTorch (chunkwise_mlstm_backward) to JAX's vjp.
// * The step backward (mlstm_scan_backward), the first design, for a
//   forward recorded with another chunk, D up to 256 (a thread a column;
//   past 256 threads its registers exceed an SM's): the chunks are walked
//   from last to first.  Each block recomputes its rows of the chunk's
//   C_t (and n_t) from the checkpoint into a scratch buffer of its own,
//   then steps dC (its rows, registers) and dn (redundantly, every block)
//   back through the chunk.  Per step:
//   dden = -(dy . y) / den splits through den = max(|s|, g), g = exp(-m'),
//     into ds (to s, times sign s; 0 at s = 0) and dg (to m', times -g),
//     half each at a tie (bwd_prep_kernel, all steps at once: it needs only
//     the saved y, m' and s);
//   dC_t = dC + (dy / den) q^T;  dn_t = dn + ds q;
//   dq = C_t^T dy / den + ds n_t;  dv = i' dC_t k;  dk = i' (dC_t^T v + dn_t)
//   dF = <dC_t, C_{t-1}> + dn_t . n_{t-1};  dI = k . (dC_t^T v + dn_t)
//   dC = f' dC_t;  dn = f' dn_t.
// dq, dk, dF and dI sum over the value rows of every block of (b, h): each
// block writes its partial (block 0 adds the n terms once), reduce_kernel
// and mrev_kernel add them up.  mrev_kernel then runs the scalar reverse of
// the m recurrence, dm carried from step to step through max and exp back
// to log_i, log_f and m.  Bound: latency, S times one step (a block
// reduction and its barrier).
//
// Built without fast math: exp(-1e30) is 0 and m is carried exactly, as in
// the plain version.
#include "attn_tile.cuh"
#include "common.cuh"

namespace repro {
namespace mlstm {

constexpr int kFwdRows = 8;    // value rows of C per forward block
constexpr int kBwdRows = 16;   // per backward block (the caller passes
                               // the rows it sized its scratch for)
constexpr int kMaxWarps = 32;  // D <= 1024, one thread per column
constexpr int kRevTile = 1024; // steps per tile of mrev_kernel

struct Gates {
  float a, mn, fe, ie;
};

// One step's stabilizer from the gates and the previous m.
__device__ __forceinline__ Gates gates(float lf, float li, float mprev) {
  Gates g;
  g.a = lf + mprev;
  g.mn = fmaxf(g.a, li);
  g.fe = expf(g.a - g.mn);
  g.ie = expf(li - g.mn);
  return g;
}

// x's share of the gradient of max(x, y): 1, 0.5 at a tie, 0.
__device__ __forceinline__ float tie_weight(float x, float y) {
  return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

// q, k, v, y: (B, S, H, D); li, lf, ms, ss: (B, S, H); C0, Cout: (B, H, D,
// D); n0, nout: (B, H, D); m0, mout: (B, H); ckC: (B, NC, H, D, D), ckn:
// (B, NC, H, D), NC = ceil(S / chunk) (unused when chunk = 0).
// grid (B * H, ceil(D / kFwdRows)), block round_up(D, 32) threads.
__global__ void fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ li,
    const float* __restrict__ lf, const float* __restrict__ C0,
    const float* __restrict__ n0, const float* __restrict__ m0,
    float* __restrict__ y, float* __restrict__ Cout,
    float* __restrict__ nout, float* __restrict__ mout,
    float* __restrict__ ckC, float* __restrict__ ckn,
    float* __restrict__ ms, float* __restrict__ ss, int S, int H, int D,
    int chunk) {
  constexpr int RB = kFwdRows;
  __shared__ float red[2][kMaxWarps][RB + 1];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r0 = blockIdx.y * RB;
  const int kk = threadIdx.x, lane = kk & 31, warp = kk >> 5;
  const int nw = blockDim.x >> 5;
  const bool col = kk < D;
  const long long DD = static_cast<long long>(D) * D;
  const int NC = chunk > 0 ? (S + chunk - 1) / chunk : 0;

  float c[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r)
    c[r] = (col && r0 + r < D) ? C0[bh * DD + (long long)(r0 + r) * D + kk]
                               : 0.f;
  float nv = col ? n0[(long long)bh * D + kk] : 0.f;
  float mm = m0[bh];

  // step t's inputs, loaded one step ahead
  float qn = 0.f, kn = 0.f, lin = 0.f, lfn = 0.f, vn[RB];
  auto load = [&](int t) {
    const long long i = ((long long)b * S + t) * H + h;
    qn = col ? q[i * D + kk] : 0.f;
    kn = col ? k[i * D + kk] : 0.f;
#pragma unroll
    for (int r = 0; r < RB; ++r) vn[r] = r0 + r < D ? v[i * D + r0 + r] : 0.f;
    lin = li[i];
    lfn = lf[i];
  };
  load(0);
  for (int t = 0; t < S; ++t) {
    const long long i = ((long long)b * S + t) * H + h;
    const float qt = qn, kt = kn, lit = lin, lft = lfn;
    float vt[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) vt[r] = vn[r];
    if (t + 1 < S) load(t + 1);
    if (chunk > 0 && t % chunk == 0 && col) {
      const long long ck = ((long long)b * NC + t / chunk) * H + h;
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r0 + r < D) ckC[ck * DD + (long long)(r0 + r) * D + kk] = c[r];
      if (blockIdx.y == 0) ckn[ck * D + kk] = nv;
    }
    const Gates g = gates(lft, lit, mm);
    float part[RB + 1];
    nv = g.fe * nv + g.ie * kt;
    part[RB] = nv * qt;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      c[r] = g.fe * c[r] + g.ie * (vt[r] * kt);
      part[r] = c[r] * qt;
    }
#pragma unroll
    for (int j = 0; j <= RB; ++j) part[j] = warp_sum(part[j]);
    float(*buf)[RB + 1] = red[t & 1];
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j <= RB; ++j) buf[warp][j] = part[j];
    }
    // one barrier a step: a buffer is written again two steps later, after
    // every reader of it has passed the next step's barrier
    __syncthreads();
    if (kk < RB && r0 + kk < D) {
      float s = 0.f, acc = 0.f;
      for (int w = 0; w < nw; ++w) {
        s += buf[w][RB];
        acc += buf[w][kk];
      }
      const float den = fmaxf(fabsf(s), expf(-g.mn));
      y[i * D + r0 + kk] = acc / den;
      if (kk == 0 && blockIdx.y == 0 && chunk > 0) {
        ms[i] = g.mn;
        ss[i] = s;
      }
    }
    mm = g.mn;
  }
#pragma unroll
  for (int r = 0; r < RB; ++r)
    if (col && r0 + r < D) Cout[bh * DD + (long long)(r0 + r) * D + kk] = c[r];
  if (blockIdx.y == 0) {
    if (col) nout[(long long)bh * D + kk] = nv;
    if (kk == 0) mout[bh] = mm;
  }
}

// Per (b, t, h), one warp each: dden = -(dy . y) / den, split into ds (to
// s) and dmg (to m', through g = exp(-m')).  N = B * S * H.
__global__ void bwd_prep_kernel(const float* __restrict__ dy,
                                const float* __restrict__ y,
                                const float* __restrict__ ms,
                                const float* __restrict__ ss,
                                float* __restrict__ ds,
                                float* __restrict__ dmg, long long N, int D) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x
                       + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= N) return;
  float acc = 0.f;
  for (int x = lane; x < D; x += 32) acc += dy[i * D + x] * y[i * D + x];
  acc = warp_sum(acc);
  if (lane == 0) {
    const float s = ss[i], g = expf(-ms[i]), as = fabsf(s);
    const float dden = -acc / fmaxf(as, g);
    const float ws = tie_weight(as, g);
    const float sg = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
    ds[i] = dden * ws * sg;
    dmg[i] = dden * (1.f - ws) * -g;
  }
}

// grid (B * H, NB = ceil(D / RB)), block DP = round_up(D, 32) threads.
// Cs: (B * H * NB, chunk + 1, RB, DP) and Ns: (B * H * NB, chunk + 1, DP),
// each thread's own states of the current chunk (step 0: the checkpoint).
// dv: (B, S, H, D); dq_part, dk_part: (B, S, H, NB, D); dF_part, dI_part:
// (B, S, H, NB).
template <int RB>
__global__ void bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ li,
    const float* __restrict__ lf, const float* __restrict__ m0,
    const float* __restrict__ ckC, const float* __restrict__ ckn,
    const float* __restrict__ ms, const float* __restrict__ ss,
    const float* __restrict__ dy, const float* __restrict__ ds,
    float* __restrict__ Cs, float* __restrict__ Ns, float* __restrict__ dv,
    float* __restrict__ dq_part, float* __restrict__ dk_part,
    float* __restrict__ dF_part, float* __restrict__ dI_part, int S, int H,
    int D, int chunk) {
  __shared__ float red[2][kMaxWarps][RB + 2];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int blk = blockIdx.y, NB = gridDim.y, r0 = blk * RB;
  const bool lead = blk == 0;
  const int kk = threadIdx.x, lane = kk & 31, warp = kk >> 5;
  const int nw = blockDim.x >> 5, DP = blockDim.x;
  const bool col = kk < D;
  const long long DD = static_cast<long long>(D) * D;
  const int NC = (S + chunk - 1) / chunk;
  const long long own = static_cast<long long>(bh * NB + blk) * (chunk + 1);
  float* cs = Cs + own * RB * DP;
  float* ns = Ns + own * DP;
  auto idx = [&](int t) { return ((long long)b * S + t) * H + h; };

  float dC[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) dC[r] = 0.f;
  float dn = 0.f;
  int step = 0;
  for (int j = NC - 1; j >= 0; --j) {
    const int t0 = j * chunk, t1 = min(S, t0 + chunk);
    // the chunk's states, recomputed from its checkpoint
    const long long ck = ((long long)b * NC + j) * H + h;
    float c[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      c[r] = (col && r0 + r < D) ? ckC[ck * DD + (long long)(r0 + r) * D + kk]
                                 : 0.f;
      cs[r * DP + kk] = c[r];
    }
    float nv = col ? ckn[ck * D + kk] : 0.f;
    ns[kk] = nv;
    float mm = t0 == 0 ? m0[bh] : ms[idx(t0 - 1)];
    for (int t = t0; t < t1; ++t) {
      const long long i = idx(t);
      const float kt = col ? k[i * D + kk] : 0.f;
      const Gates g = gates(lf[i], li[i], mm);
      nv = g.fe * nv + g.ie * kt;
      const int u = t - t0 + 1;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float vr = r0 + r < D ? v[i * D + r0 + r] : 0.f;
        c[r] = g.fe * c[r] + g.ie * (vr * kt);
        cs[(u * RB + r) * DP + kk] = c[r];
      }
      ns[u * DP + kk] = nv;
      mm = g.mn;
    }
    // dC and dn stepped back through the chunk
    for (int t = t1 - 1; t >= t0; --t) {
      const long long i = idx(t);
      const int u = t - t0;
      const float qt = col ? q[i * D + kk] : 0.f;
      const float kt = col ? k[i * D + kk] : 0.f;
      const Gates g = gates(lf[i], li[i], t == 0 ? m0[bh] : ms[idx(t - 1)]);
      const float den = fmaxf(fabsf(ss[i]), expf(-g.mn));
      const float dst = ds[i];
      const float dnt = dn + dst * qt;
      float part[RB + 2];
      float w = lead ? dnt : 0.f, dqp = 0.f, dfp = 0.f;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const bool row = r0 + r < D;
        const float vr = row ? v[i * D + r0 + r] : 0.f;
        const float dnum = row ? dy[i * D + r0 + r] / den : 0.f;
        const float ct = cs[((u + 1) * RB + r) * DP + kk];
        const float cp = cs[(u * RB + r) * DP + kk];
        const float dct = dC[r] + dnum * qt;
        dqp += ct * dnum;
        w += dct * vr;
        dfp += dct * cp;
        part[r] = dct * kt;
        dC[r] = g.fe * dct;
      }
      if (lead) {
        dqp += dst * ns[(u + 1) * DP + kk];
        dfp += dnt * ns[u * DP + kk];
      }
      part[RB] = dfp;
      part[RB + 1] = kt * w;
      if (col) {
        dq_part[(i * NB + blk) * D + kk] = dqp;
        dk_part[(i * NB + blk) * D + kk] = g.ie * w;
      }
      dn = g.fe * dnt;
#pragma unroll
      for (int x = 0; x < RB + 2; ++x) part[x] = warp_sum(part[x]);
      float(*buf)[RB + 2] = red[step & 1];
      if (lane == 0) {
#pragma unroll
        for (int x = 0; x < RB + 2; ++x) buf[warp][x] = part[x];
      }
      __syncthreads();
      if (kk < RB + 2) {
        float tot = 0.f;
        for (int x = 0; x < nw; ++x) tot += buf[x][kk];
        if (kk < RB) {
          if (r0 + kk < D) dv[i * D + r0 + kk] = g.ie * tot;
        } else if (kk == RB) {
          dF_part[i * NB + blk] = tot;
        } else {
          dI_part[i * NB + blk] = tot;
        }
      }
      ++step;
    }
  }
}

// dq, dk = the sums of the blocks' partials.  grid B * S * H.
__global__ void reduce_kernel(const float* __restrict__ dq_part,
                              const float* __restrict__ dk_part,
                              float* __restrict__ dq, float* __restrict__ dk,
                              int NB, int D) {
  const long long i = blockIdx.x;
  for (int x = threadIdx.x; x < D; x += blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int j = 0; j < NB; ++j) {
      a += dq_part[(i * NB + j) * D + x];
      c += dk_part[(i * NB + j) * D + x];
    }
    dq[i * D + x] = a;
    dk[i * D + x] = c;
  }
}

// One thread's walk of the m recurrence's reverse over the steps [lo, hi)
// of (b, h), from the gradient dm arriving after step hi - 1; sA, sB, sW
// and sG hold each step's dA (the gradient of log f' at fixed m), dB (of
// log i'), max's tie weight and dmg (to m' through den), from index 0 at
// step lo:
//   dm' = dm + dmg - dA - dB;  dlog_f = da = dA + w dm';
//   dlog_i = dB + (1 - w) dm';  dm = da.
// Returns the dm arriving before step lo.
__device__ float mrev_tile(const float* sA, const float* sB, const float* sW,
                           const float* sG, float* __restrict__ dli,
                           float* __restrict__ dlf, int b, int h, int S,
                           int H, int lo, int hi, float dm) {
  for (int t = hi - 1; t >= lo; --t) {
    const int u = t - lo;
    const long long i = (static_cast<long long>(b) * S + t) * H + h;
    const float dmt = dm + sG[u] - sA[u] - sB[u];
    const float da = sA[u] + sW[u] * dmt;
    dli[i] = sB[u] + (1.f - sW[u]) * dmt;
    dlf[i] = da;
    dm = da;
  }
  return dm;
}

// The reverse of the m recurrence, one block per (b, h): the threads turn
// a tile of steps' dF and dI (summed over the blocks' partials) into
// dA = dF f', dB = dI i' and max's tie weight, then one thread carries dm
// from the last step to the first (mrev_tile).
__global__ void mrev_kernel(const float* __restrict__ li,
                            const float* __restrict__ lf,
                            const float* __restrict__ m0,
                            const float* __restrict__ ms,
                            const float* __restrict__ dF_part,
                            const float* __restrict__ dI_part,
                            const float* __restrict__ dmg,
                            float* __restrict__ dli, float* __restrict__ dlf,
                            int S, int H, int NB) {
  __shared__ float sA[kRevTile], sB[kRevTile], sW[kRevTile], sG[kRevTile];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  float dm = 0.f;
  for (int hi = S; hi > 0; hi -= kRevTile) {
    const int lo = max(0, hi - kRevTile);
    for (int t = lo + threadIdx.x; t < hi; t += blockDim.x) {
      const long long i = ((long long)b * S + t) * H + h;
      float dF = 0.f, dI = 0.f;
      for (int j = 0; j < NB; ++j) {
        dF += dF_part[i * NB + j];
        dI += dI_part[i * NB + j];
      }
      const Gates g = gates(lf[i], li[i], t == 0 ? m0[bh] : ms[i - H]);
      sA[t - lo] = dF * g.fe;
      sB[t - lo] = dI * g.ie;
      sW[t - lo] = tie_weight(g.a, li[i]);
      sG[t - lo] = dmg[i];
    }
    __syncthreads();
    if (threadIdx.x == 0)
      dm = mrev_tile(sA, sB, sW, sG, dli, dlf, b, h, S, H, lo, hi, dm);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The chunkwise forward
// ---------------------------------------------------------------------------
namespace chunkwise {

constexpr int L = 32;            // steps per chunk (xlstm_scan.MLSTM_CHUNK)
constexpr int kThreads = 256;
constexpr int TV = 32, TK = 64;  // states_kernel's tile of C
constexpr int kStages = 3;       // states_kernel's ring of chunk tiles
constexpr int KC = 256;          // columns of D per slab of out_kernel
constexpr int VT = 64;           // value rows per tile of out_kernel
static_assert(L == 32, "gates_kernel walks a chunk with one warp");

using tile::cp_async16;
using tile::cp_async_commit;

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4-byte asynchronous copy; with ok false nothing is read and the 4 bytes
// are zero-filled.
__device__ __forceinline__ void cp_async4z(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tile::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The pitch of a slab row of kc floats: 16-byte aligned, and 4 banks on
// from the row before (rows 8 apart in a phase never share a bank).
__host__ __device__ __forceinline__ int slab_pitch(int kc) {
  return (kc + 7) / 8 * 8 + 4;
}

// One warp per (b, h): m_t by JAX's recurrence, step after step, and F_t,
// the sum of log f from t's chunk start to t, in order; at a chunk's end
// its state weights g_s = exp(log_i_s + F_L - F_s - m_L) (L its last step)
// and its decay a = exp(F_L + m_prev - m_L).  Lane l holds step l of each
// of the next kAhead chunks' gates in registers (a ring, filled kAhead
// chunks ahead, so the walk never waits for memory).  li, lf, mbuf, Fbuf,
// Gbuf: (B, S, H); m0: (B, H); Abuf: (B, NC, H).
constexpr int kAhead = 8;

__global__ void gates_kernel(const float* __restrict__ li,
                             const float* __restrict__ lf,
                             const float* __restrict__ m0,
                             float* __restrict__ mbuf,
                             float* __restrict__ Fbuf,
                             float* __restrict__ Gbuf,
                             float* __restrict__ Abuf, int B, int S, int H) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= B * H) return;
  const int b = w / H, h = w % H, NC = (S + L - 1) / L;
  const long long base = static_cast<long long>(b) * S * H + h;
  float m = m0[w];
  float lfr[kAhead], lir[kAhead];
#pragma unroll
  for (int r = 0; r < kAhead; ++r) {
    const int t = r * L + lane;
    lfr[r] = t < S ? lf[base + static_cast<long long>(t) * H] : 0.f;
    lir[r] = t < S ? li[base + static_cast<long long>(t) * H] : 0.f;
  }
  for (int j0 = 0; j0 < NC; j0 += kAhead) {
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      const int j = j0 + r;
      if (j >= NC) break;
      const int t0 = j * L, t = t0 + lane, n = min(L, S - t0);
      const long long i = base + static_cast<long long>(t) * H;
      const float lfv = lfr[r], liv = lir[r];
      // refill the slot with chunk j + kAhead
      const int tn = t + kAhead * L;
      const long long in = i + static_cast<long long>(kAhead) * L * H;
      lfr[r] = tn < S ? lf[in] : 0.f;
      lir[r] = tn < S ? li[in] : 0.f;
      const float mp = m;
      // every step's gates first (no shuffle waits inside the m chain)
      float av[L], lv[L];
#pragma unroll
      for (int u = 0; u < L; ++u) {
        av[u] = __shfl_sync(0xffffffffu, lfv, u);
        lv[u] = __shfl_sync(0xffffffffu, liv, u);
      }
      float mt = 0.f, Ft = 0.f, F = 0.f;
#pragma unroll
      for (int u = 0; u < L; ++u) {
        if (u < n) {
          m = fmaxf(av[u] + m, lv[u]);
          F = u == 0 ? av[u] : F + av[u];
          if (lane == u) {
            mt = m;
            Ft = F;
          }
        }
      }
      const float FL = __shfl_sync(0xffffffffu, Ft, n - 1);
      if (lane < n) {
        mbuf[i] = mt;
        Fbuf[i] = Ft;
        Gbuf[i] = expf(liv + FL - Ft - m);
      }
      if (lane == 0)
        Abuf[(static_cast<long long>(b) * NC + j) * H + h] = expf(FL + mp - m);
    }
  }
}

// grid (B * H, ceil(D / TV), ceil(D / TK)), kThreads.  The chain of chunk
// states over the window of chunks [jb, jb + W) (cut at NC) for one TV x
// TK tile of C: thread (ry, cx) holds rows v0 + 2 ry, + 1 and columns c0 +
// 4 cx .. + 3 in registers (D % 4 == 0: a column group is all inside D or
// all outside), from the carries C0, n0 (the caller's, or the last
// window's Cout, nout: each thread reads its own elements before it
// writes them).  A ring of kStages chunks of v, k and g comes in by
// cp.async, two chunks ahead.  Writes the state before chunk j to Cst (B,
// W, H, D, D) at j - jb and, from the first row tile, n to Nst (B, W, H,
// D); the window's last C, n and the sequence's last m to Cout (B, H, D,
// D), nout (B, H, D), mout (B, H).
__global__ void __launch_bounds__(kThreads) states_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ Gbuf, const float* __restrict__ Abuf,
    const float* __restrict__ mbuf, const float* C0, const float* n0,
    float* __restrict__ Cst, float* __restrict__ Nst, float* Cout,
    float* nout, float* __restrict__ mout, int S, int H, int D, int jb,
    int W) {
  __shared__ __align__(16) float Vs[kStages][L][TV];
  __shared__ __align__(16) float Ks[kStages][L][TK];
  __shared__ float Gs[kStages][L];
  __shared__ float As[kStages];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * TV, c0 = blockIdx.z * TK;
  const int tid = threadIdx.x, ry = tid >> 4, cx = tid & 15;
  const int r = v0 + 2 * ry, c = c0 + 4 * cx;
  const bool cok = c < D;
  const bool lead = blockIdx.y == 0 && ry == 0;  // keeps n, its 4 columns
  const long long DD = static_cast<long long>(D) * D;
  const int NC = (S + L - 1) / L, je = min(NC, jb + W);
  const long long base = static_cast<long long>(b) * S * H + h;  // step t:
                                                                 // + t H
  float C[2][4], n[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 x = (cok && r + i < D)
                         ? ld4(C0 + bh * DD + static_cast<long long>(r + i) * D + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    C[i][0] = x.x; C[i][1] = x.y; C[i][2] = x.z; C[i][3] = x.w;
  }
  {
    const float4 x = (lead && cok) ? ld4(n0 + static_cast<long long>(bh) * D + c)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    n[0] = x.x; n[1] = x.y; n[2] = x.z; n[3] = x.w;
  }
  // chunk j's v, k, g and decay into stage (j - jb) % kStages (a group
  // even when j is past the window, so that the waits count alike)
  auto load = [&](int j) {
    if (j < je) {
      const int t0 = j * L, st = (j - jb) % kStages;
      for (int x = tid; x < L * (TV / 4); x += kThreads) {
        const int s = x / (TV / 4), col = v0 + 4 * (x % (TV / 4));
        const bool ok = t0 + s < S && col < D;
        cp_async16(&Vs[st][s][col - v0],
                   ok ? v + (base + static_cast<long long>(t0 + s) * H) * D + col : v,
                   ok);
      }
      for (int x = tid; x < L * (TK / 4); x += kThreads) {
        const int s = x / (TK / 4), col = c0 + 4 * (x % (TK / 4));
        const bool ok = t0 + s < S && col < D;
        cp_async16(&Ks[st][s][col - c0],
                   ok ? k + (base + static_cast<long long>(t0 + s) * H) * D + col : k,
                   ok);
      }
      if (tid < L) {
        const bool ok = t0 + tid < S;
        cp_async4z(&Gs[st][tid],
                   ok ? Gbuf + base + static_cast<long long>(t0 + tid) * H : Gbuf,
                   ok);
      }
      if (tid == L)
        cp_async4z(&As[st], Abuf + (static_cast<long long>(b) * NC + j) * H + h,
                   true);
    }
    cp_async_commit();
  };
  for (int j = jb; j < jb + kStages - 1; ++j) load(j);
  for (int j = jb; j < je; ++j) {
    const int nt = min(L, S - j * L), st = (j - jb) % kStages;
    const long long ck = (static_cast<long long>(b) * W + j - jb) * H + h;
    load(j + kStages - 1);
    // the state before chunk j
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (cok && r + i < D)
        *reinterpret_cast<float4*>(Cst + ck * DD + static_cast<long long>(r + i) * D + c) =
            make_float4(C[i][0], C[i][1], C[i][2], C[i][3]);
    if (lead && cok)
      *reinterpret_cast<float4*>(Nst + ck * D + c) =
          make_float4(n[0], n[1], n[2], n[3]);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float a = As[st];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      C[0][q] *= a;
      C[1][q] *= a;
      n[q] *= a;
    }
#pragma unroll 8
    for (int s = 0; s < nt; ++s) {
      const float g = Gs[st][s];
      const float2 vv = *reinterpret_cast<const float2*>(&Vs[st][s][2 * ry]);
      const float4 kk = ld4(&Ks[st][s][4 * cx]);
      const float g0 = g * vv.x, g1 = g * vv.y;
      C[0][0] = fmaf(g0, kk.x, C[0][0]);
      C[0][1] = fmaf(g0, kk.y, C[0][1]);
      C[0][2] = fmaf(g0, kk.z, C[0][2]);
      C[0][3] = fmaf(g0, kk.w, C[0][3]);
      C[1][0] = fmaf(g1, kk.x, C[1][0]);
      C[1][1] = fmaf(g1, kk.y, C[1][1]);
      C[1][2] = fmaf(g1, kk.z, C[1][2]);
      C[1][3] = fmaf(g1, kk.w, C[1][3]);
      if (lead) {
        n[0] = fmaf(g, kk.x, n[0]);
        n[1] = fmaf(g, kk.y, n[1]);
        n[2] = fmaf(g, kk.z, n[2]);
        n[3] = fmaf(g, kk.w, n[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (cok && r + i < D)
      *reinterpret_cast<float4*>(Cout + bh * DD + static_cast<long long>(r + i) * D + c) =
          make_float4(C[i][0], C[i][1], C[i][2], C[i][3]);
  if (lead && cok)
    *reinterpret_cast<float4*>(nout + static_cast<long long>(bh) * D + c) =
        make_float4(n[0], n[1], n[2], n[3]);
  if (blockIdx.y == 0 && blockIdx.z == 0 && tid == 0)
    mout[bh] = mbuf[base + static_cast<long long>(S - 1) * H];
}

// rows x 16-byte pieces of the slab [cb, cb + kc) of rows src + base +
// rr stride (rr < rows) into dst, a row every kp floats; rows from live on
// are zero-filled.
__device__ __forceinline__ void copy_slab(float* dst, int kp,
                                          const float* src, long long base,
                                          long long stride, int live,
                                          int rows, int cb, int kc) {
  const int per = kc / 4;
  for (int x = threadIdx.x; x < rows * per; x += kThreads) {
    const int rr = x / per, cc = 4 * (x % per);
    const bool ok = rr < live;
    cp_async16(dst + rr * kp + cc,
               ok ? src + base + rr * stride + cb + cc : src, ok);
  }
}

// Dynamic shared memory of out_kernel, in floats: Q's slab (L rows), K's
// or C_j's slab (VT rows), V's tile.
__host__ __device__ __forceinline__ int out_floats(int D) {
  return (L + VT) * slab_pitch(D < KC ? D : KC) + L * VT;
}

// grid (B * H, chunks of the window [jb, jb + W), VZ), kThreads,
// out_floats(D) floats of dynamic shared memory.  Chunk j = jb +
// blockIdx.y of (b, h), every chunk of the window at once: P = Q K^T and n_j . q
// over D in slabs of up to KC columns (one slab at D <= 256: each phase
// waits for its copies once), then A, s and den; then, for value tiles z,
// z + VZ, ..: Y = Q C_j^T over the same slabs (Q's slab kept from the first
// phase when there is one) and y = (decay Y + A V) / den.  Warp w holds
// steps 4 w .. 4 w + 3 (Q's rows read as broadcasts), lane l key l of P and
// value rows l, l + 32 of Y (K's and C's rows, one a lane, 4 banks apart).
// q, k, v, y: (B, S, H, D); li, mbuf, Fbuf, ss: (B, S, H);
// Cst, Nst: the states before each chunk of the window (states_kernel's,
// (B, W, H, ..)).  With save, writes s to ss.
__global__ void __launch_bounds__(kThreads, 2) out_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ li,
    const float* __restrict__ mbuf, const float* __restrict__ Fbuf,
    const float* __restrict__ m0, const float* __restrict__ Cst,
    const float* __restrict__ Nst, float* __restrict__ y,
    float* __restrict__ ss, int S, int H, int D, int save, int jb, int W) {
  extern __shared__ __align__(16) float osm[];
  __shared__ __align__(16) float Ns[KC];
  __shared__ float As[L][L + 1];
  __shared__ float Fs[L], Is[L], Ms[L], dec[L], den[L], nq[L];
  __shared__ float mprev;
  const int KP = slab_pitch(D < KC ? D : KC);
  float* Qs = osm;                   // [L][KP]
  float* Bs = Qs + L * KP;           // [VT][KP]: K's rows, then C_j's
  float* Vs = Bs + VT * KP;          // [L][VT]
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = jb + blockIdx.y;
  const int t0 = j * L, nt = min(L, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, tw = 4 * (tid >> 5);
  const long long row0 = (static_cast<long long>(b) * S + t0) * H + h;
  const long long ck = (static_cast<long long>(b) * W + blockIdx.y) * H + h;
  const long long DD = static_cast<long long>(D) * D;
  const int nslab = (D + KC - 1) / KC;
  static_assert(kThreads / 32 * 4 == L && VT == 64, "out_kernel's tiling");

  // a chunk's steps of q or k: rows row0 + s H of D floats
  const long long qrow = row0 * D, qstride = static_cast<long long>(H) * D;

  // P = Q K^T and n . q
  float p[4] = {0.f, 0.f, 0.f, 0.f}, nqa = 0.f;
  for (int sl = 0; sl < nslab; ++sl) {
    const int cb = sl * KC, kc = min(KC, D - cb);
    copy_slab(Qs, KP, q, qrow, qstride, nt, L, cb, kc);
    copy_slab(Bs, KP, k, qrow, qstride, nt, L, cb, kc);
    for (int x = tid; x < kc / 4; x += kThreads)
      cp_async16(&Ns[4 * x], Nst + ck * D + cb + 4 * x, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 8
    for (int c4 = 0; c4 < kc; c4 += 4) {
      const float4 kr = ld4(Bs + lane * KP + c4);
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = dot4(ld4(Qs + (tw + a) * KP + c4), kr, p[a]);
      if (lane < 4)
        nqa = dot4(ld4(Qs + (tw + lane) * KP + c4), ld4(&Ns[c4]), nqa);
    }
    __syncthreads();
  }
  if (tid < L) {
    const bool ok = tid < nt;
    const long long it = row0 + static_cast<long long>(tid) * H;
    Fs[tid] = ok ? Fbuf[it] : 0.f;
    Is[tid] = ok ? li[it] : 0.f;
    Ms[tid] = ok ? mbuf[it] : 0.f;
  }
  if (tid == 0) mprev = j == 0 ? m0[bh] : mbuf[row0 - H];
  if (lane < 4) nq[tw + lane] = nqa;
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = tw + a, s = lane;
    As[t][s] = (s <= t && t < nt)
                   ? expf(Is[s] + Fs[t] - Fs[s] - Ms[t]) * p[a]
                   : 0.f;
  }
  if (tid < L) dec[tid] = expf(Fs[tid] + mprev - Ms[tid]);
  __syncthreads();
  if (tid < nt) {
    float si = 0.f;
    for (int s = 0; s <= tid; ++s) si += As[tid][s];
    const float st = dec[tid] * nq[tid] + si;
    den[tid] = fmaxf(fabsf(st), expf(-Ms[tid]));
    if (save && blockIdx.z == 0) ss[row0 + static_cast<long long>(tid) * H] = st;
  }
  __syncthreads();

  // y, one tile of value rows at a time
  const int nvt = (D + VT - 1) / VT;
  for (int vt = blockIdx.z; vt < nvt; vt += gridDim.z) {
    const int r0 = vt * VT;
    for (int x = tid; x < L * (VT / 4); x += kThreads) {
      const int s = x / (VT / 4), col = r0 + 4 * (x % (VT / 4));
      const bool ok = s < nt && col < D;
      cp_async16(Vs + s * VT + col - r0,
                 ok ? v + (row0 + static_cast<long long>(s) * H) * D + col : v,
                 ok);
    }
    float acc[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = 0.f;
    for (int sl = 0; sl < nslab; ++sl) {
      const int cb = sl * KC, kc = min(KC, D - cb);
      if (nslab > 1) copy_slab(Qs, KP, q, qrow, qstride, nt, L, cb, kc);
      copy_slab(Bs, KP, Cst, ck * DD + static_cast<long long>(r0) * D, D,
                D - r0, VT, cb, kc);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 4
      for (int c4 = 0; c4 < kc; c4 += 4) {
        const float4 c0r = ld4(Bs + lane * KP + c4);
        const float4 c1r = ld4(Bs + (lane + 32) * KP + c4);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 qa = ld4(Qs + (tw + a) * KP + c4);
          acc[a][0] = dot4(qa, c0r, acc[a][0]);
          acc[a][1] = dot4(qa, c1r, acc[a][1]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = tw + a;
      if (t >= nt) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = lane + 32 * i;
        if (r0 + rr >= D) continue;
        float av = 0.f;
        for (int s = 0; s <= t; ++s) av = fmaf(As[t][s], Vs[s * VT + rr], av);
        y[(row0 + static_cast<long long>(t) * H) * D + r0 + rr] =
            (dec[t] * acc[a][i] + av) / den[t];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The chunkwise backward
// ---------------------------------------------------------------------------

constexpr int CT = 128;    // bchunk_kernel's columns (and dv's rows) a block
constexpr int RS = 16;     // rows of C_j and G_j per slab of its first pass
constexpr int CS = 16;     // columns of G_j per slab of its dv pass
constexpr int SK = 64;     // columns of D per slab of bsmall_kernel
constexpr int EP = L + 4;  // pitch of the in-chunk matrices E, E^T, A'
constexpr int CP = CT + 4; // pitch of a row of the column tile
constexpr int YP = RS + 4; // pitch of a row slab of dY and V
constexpr int GP = CS + 4; // pitch of a column slab of G_j and K
static_assert(CT == 4 * 32 && kThreads / 32 * 4 == L,
              "bchunk_kernel: a lane owns 4 columns, a warp 4 steps");

__device__ __forceinline__ float comp(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ void fma4(float (&acc)[4], float s,
                                     const float4& x) {
  acc[0] = fmaf(s, x.x, acc[0]);
  acc[1] = fmaf(s, x.y, acc[1]);
  acc[2] = fmaf(s, x.z, acc[2]);
  acc[3] = fmaf(s, x.w, acc[3]);
}

__device__ __forceinline__ float dot4a(const float (&a)[4], const float4& b) {
  return a[0] * b.x + a[1] * b.y + a[2] * b.z + a[3] * b.w;
}

// One block per (b, chunk j, h): dd = dy . y, warp w over D for steps 4 w
// .. 4 w + 3 (their loads in flight together); then warp 0, lane u step t0
// + u: den = max(|s|, exp(-m)) and dden = -dd / den split into ds and dmg
// as bwd_prep_kernel splits it; F, the sum of log f from the chunk's start
// (in order, as gates_kernel sums it), and dec = exp(F + m_prev - m) from
// the saved m; for the chain of chunk-end gradients e = dec / den and hh =
// dec ds, and the chunk's decay a = dec_last.  Fb, decb, denb, dsb, dmgb,
// eb, hb: (B, S, H); Ab: (B, NC, H).  grid B NC H, kThreads.
__global__ void __launch_bounds__(kThreads) bgates_kernel(
    const float* __restrict__ dy, const float* __restrict__ y,
    const float* __restrict__ lf, const float* __restrict__ m0,
    const float* __restrict__ ms, const float* __restrict__ ss,
    float* __restrict__ Fb, float* __restrict__ decb,
    float* __restrict__ denb, float* __restrict__ dsb,
    float* __restrict__ dmgb, float* __restrict__ eb,
    float* __restrict__ hb, float* __restrict__ Ab, int S, int H, int D) {
  __shared__ float sdd[L];
  const int w = blockIdx.x, NC = (S + L - 1) / L;
  const int lane = threadIdx.x & 31, tw = 4 * (threadIdx.x >> 5);
  const int h = w % H, j = (w / H) % NC, b = w / (H * NC);
  const int t0 = j * L, n = min(L, S - t0);
  const long long base = static_cast<long long>(b) * S * H + h;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int x = lane; x < D; x += 32) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (tw + a < n) {
        const long long r =
            (base + static_cast<long long>(t0 + tw + a) * H) * D + x;
        acc[a] += dy[r] * y[r];
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a] = warp_sum(acc[a]);
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) sdd[tw + a] = acc[a];
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const long long i = base + static_cast<long long>(t0 + lane) * H;
  const float dd = sdd[lane];
  const float lfv = lane < n ? lf[i] : 0.f;
  float F = 0.f, Ft = 0.f;
  for (int u = 0; u < n; ++u) {
    const float a = __shfl_sync(0xffffffffu, lfv, u);
    F = u == 0 ? a : F + a;
    if (lane == u) Ft = F;
  }
  if (lane >= n) return;
  const float mp = j == 0 ? m0[static_cast<long long>(b) * H + h]
                          : ms[base + static_cast<long long>(t0 - 1) * H];
  const float s = ss[i], m = ms[i], g = expf(-m), as = fabsf(s);
  const float den = fmaxf(as, g), dden = -dd / den;
  const float ws = tie_weight(as, g);
  const float sg = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
  const float ds = dden * ws * sg, dec = expf(Ft + mp - m);
  Fb[i] = Ft;
  decb[i] = dec;
  denb[i] = den;
  dsb[i] = ds;
  dmgb[i] = dden * (1.f - ws) * -g;
  eb[i] = dec / den;
  hb[i] = dec * ds;
  if (lane == n - 1) Ab[(static_cast<long long>(b) * NC + j) * H + h] = dec;
}

// grid (B * H, ceil(D / TV), ceil(D / TK)), kThreads.  states_kernel's
// chain run in reverse: the gradients arriving at the chunks' ends, over
// the window of chunks [jb, jb + W) (cut at NC) from its last chunk to its
// first, for one TV x TK tile (thread (ry, cx): rows v0 + 2 ry, + 1,
// columns c0 + 4 cx .. + 3, in registers):
//   G_j = dC_{j+1} stored; dC_j = a_j G_j + sum_t e_t dy_t q_t^T;
//   dn alike with hh_t q_t (the first row tile).
// The carry comes from dC, dn (the later window's; zero with first) and
// goes back there.  A ring of kStages chunks of dy, q, e and hh comes in by
// cp.async, two chunks ahead.  Gst (B, W, H, D, D), Gnst (B, W, H, D) at
// chunk j - jb.
__global__ void __launch_bounds__(kThreads) dstates_kernel(
    const float* __restrict__ dy, const float* __restrict__ q,
    const float* __restrict__ eb, const float* __restrict__ hb,
    const float* __restrict__ Ab, float* dC, float* dn,
    float* __restrict__ Gst, float* __restrict__ Gnst, int S, int H, int D,
    int jb, int W, int first) {
  __shared__ __align__(16) float Ys[kStages][L][TV];
  __shared__ __align__(16) float Qs[kStages][L][TK];
  __shared__ float Es[kStages][L], Hs[kStages][L];
  __shared__ float As[kStages];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * TV, c0 = blockIdx.z * TK;
  const int tid = threadIdx.x, ry = tid >> 4, cx = tid & 15;
  const int r = v0 + 2 * ry, c = c0 + 4 * cx;
  const bool cok = c < D;
  const bool lead = blockIdx.y == 0 && ry == 0;  // keeps dn, its 4 columns
  const long long DD = static_cast<long long>(D) * D;
  const int NC = (S + L - 1) / L, je = min(NC, jb + W);
  const long long base = static_cast<long long>(b) * S * H + h;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float G[2][4], g[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 x = (!first && cok && r + i < D)
                         ? ld4(dC + bh * DD + static_cast<long long>(r + i) * D + c)
                         : zero;
    G[i][0] = x.x; G[i][1] = x.y; G[i][2] = x.z; G[i][3] = x.w;
  }
  {
    const float4 x = (!first && lead && cok)
                         ? ld4(dn + static_cast<long long>(bh) * D + c)
                         : zero;
    g[0] = x.x; g[1] = x.y; g[2] = x.z; g[3] = x.w;
  }
  // chunk jj's dy, q, e, hh and decay into stage (je - 1 - jj) % kStages
  // (a group even before the window, so that the waits count alike)
  auto load = [&](int jj) {
    if (jj >= jb) {
      const int t0 = jj * L, st = (je - 1 - jj) % kStages;
      for (int x = tid; x < L * (TV / 4); x += kThreads) {
        const int s = x / (TV / 4), col = v0 + 4 * (x % (TV / 4));
        const bool ok = t0 + s < S && col < D;
        cp_async16(&Ys[st][s][col - v0],
                   ok ? dy + (base + static_cast<long long>(t0 + s) * H) * D + col : dy,
                   ok);
      }
      for (int x = tid; x < L * (TK / 4); x += kThreads) {
        const int s = x / (TK / 4), col = c0 + 4 * (x % (TK / 4));
        const bool ok = t0 + s < S && col < D;
        cp_async16(&Qs[st][s][col - c0],
                   ok ? q + (base + static_cast<long long>(t0 + s) * H) * D + col : q,
                   ok);
      }
      if (tid < 2 * L) {
        const int u = tid % L;
        const bool ok = t0 + u < S;
        const float* src = tid < L ? eb : hb;
        cp_async4z(tid < L ? &Es[st][u] : &Hs[st][u],
                   ok ? src + base + static_cast<long long>(t0 + u) * H : src,
                   ok);
      }
      if (tid == 2 * L)
        cp_async4z(&As[st], Ab + (static_cast<long long>(b) * NC + jj) * H + h,
                   true);
    }
    cp_async_commit();
  };
  for (int jj = je - 1; jj > je - kStages; --jj) load(jj);
  for (int jj = je - 1; jj >= jb; --jj) {
    const int nt = min(L, S - jj * L), st = (je - 1 - jj) % kStages;
    const long long ck = (static_cast<long long>(b) * W + jj - jb) * H + h;
    load(jj - (kStages - 1));
    // the gradient arriving at chunk jj's end
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (cok && r + i < D)
        *reinterpret_cast<float4*>(Gst + ck * DD + static_cast<long long>(r + i) * D + c) =
            make_float4(G[i][0], G[i][1], G[i][2], G[i][3]);
    if (lead && cok)
      *reinterpret_cast<float4*>(Gnst + ck * D + c) =
          make_float4(g[0], g[1], g[2], g[3]);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float a = As[st];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      G[0][x] *= a;
      G[1][x] *= a;
      g[x] *= a;
    }
#pragma unroll 8
    for (int s = 0; s < nt; ++s) {
      const float e = Es[st][s];
      const float2 yy = *reinterpret_cast<const float2*>(&Ys[st][s][2 * ry]);
      const float4 qq = ld4(&Qs[st][s][4 * cx]);
      fma4(G[0], e * yy.x, qq);
      fma4(G[1], e * yy.y, qq);
      if (lead) fma4(g, Hs[st][s], qq);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (cok && r + i < D)
      *reinterpret_cast<float4*>(dC + bh * DD + static_cast<long long>(r + i) * D + c) =
          make_float4(G[i][0], G[i][1], G[i][2], G[i][3]);
  if (lead && cok)
    *reinterpret_cast<float4*>(dn + static_cast<long long>(bh) * D + c) =
        make_float4(g[0], g[1], g[2], g[3]);
}

// grid (B * H, chunks of the window [jb, jb + W)), kThreads.  Chunk j = jb
// + blockIdx.y of (b, h): P = Q K^T, Vd = dY V^T, n_j . q_t, dn_{j+1} . k_s
// and n_j . dn_{j+1} over D in slabs of SK columns (warp w steps 4 w .. 4 w
// + 3, lane l step l of K and V, Q's and dY's rows read as broadcasts);
// then with X = Vd / den + ds: A = W o P, E = W o X, R = A o X.  Writes E
// and A' = A / den (B, W, H, L, L) at (t, s), each step's rect_r = sum_{t
// >= r, s < r} R_ts and col_s = sum_{t >= s} R_ts (B, S, H), and the terms
// of n into slot Z1 - 1 of the partial sums: pd (dec_t ds_t n_j . q_t), pr
// (g_s dn_{j+1} . k_s), pc (a n_j . dn_{j+1}).
__global__ void __launch_bounds__(kThreads) bsmall_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dy,
    const float* __restrict__ li, const float* __restrict__ ms,
    const float* __restrict__ Fb, const float* __restrict__ denb,
    const float* __restrict__ dsb, const float* __restrict__ decb,
    const float* __restrict__ ckn, const float* __restrict__ Gnst,
    float* __restrict__ Eg, float* __restrict__ Ag, float* __restrict__ rectb,
    float* __restrict__ colb, float* __restrict__ pd, float* __restrict__ pr,
    float* __restrict__ pc, int S, int H, int D, int jb, int W, int Z1) {
  constexpr int SP = SK + 4;
  __shared__ __align__(16) float Qs[L][SP], Ks[L][SP], Ys[L][SP], Vs[L][SP];
  __shared__ __align__(16) float Ns[SK], Gn[SK];
  __shared__ float Rs[L][L + 1];
  __shared__ float Fs[L], Is[L], Ms[L], dens[L], dss[L], decs[L];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = jb + blockIdx.y;
  const int NC = (S + L - 1) / L, t0 = j * L, nt = min(L, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, tw = 4 * (tid >> 5);
  const long long row0 = (static_cast<long long>(b) * S + t0) * H + h;
  const long long qrow = row0 * D, qstride = static_cast<long long>(H) * D;
  const long long ckg = (static_cast<long long>(b) * NC + j) * H + h;
  const long long ckw = (static_cast<long long>(b) * W + blockIdx.y) * H + h;
  // dot: n_j . q (lanes 0-3), dn_{j+1} . k (lanes 4-7), n_j . dn_{j+1}
  // (thread 8)
  float p[4] = {0.f, 0.f, 0.f, 0.f}, vd[4] = {0.f, 0.f, 0.f, 0.f}, dot = 0.f;
  for (int cb = 0; cb < D; cb += SK) {
    const int kc = min(SK, D - cb);
    copy_slab(&Qs[0][0], SP, q, qrow, qstride, nt, L, cb, kc);
    copy_slab(&Ks[0][0], SP, k, qrow, qstride, nt, L, cb, kc);
    copy_slab(&Ys[0][0], SP, dy, qrow, qstride, nt, L, cb, kc);
    copy_slab(&Vs[0][0], SP, v, qrow, qstride, nt, L, cb, kc);
    if (tid < kc / 4) {
      cp_async16(&Ns[4 * tid], ckn + ckg * D + cb + 4 * tid, true);
      cp_async16(&Gn[4 * tid], Gnst + ckw * D + cb + 4 * tid, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int c4 = 0; c4 < kc; c4 += 4) {
      const float4 kr = ld4(&Ks[lane][c4]), vr = ld4(&Vs[lane][c4]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        p[a] = dot4(ld4(&Qs[tw + a][c4]), kr, p[a]);
        vd[a] = dot4(ld4(&Ys[tw + a][c4]), vr, vd[a]);
      }
      if (lane < 4)
        dot = dot4(ld4(&Qs[tw + lane][c4]), ld4(&Ns[c4]), dot);
      else if (lane < 8)
        dot = dot4(ld4(&Ks[tw + lane - 4][c4]), ld4(&Gn[c4]), dot);
      else if (tid == 8)
        dot = dot4(ld4(&Ns[c4]), ld4(&Gn[c4]), dot);
    }
    __syncthreads();
  }
  if (tid < L) {
    const bool ok = tid < nt;
    const long long it = row0 + static_cast<long long>(tid) * H;
    Fs[tid] = ok ? Fb[it] : 0.f;
    Is[tid] = ok ? li[it] : 0.f;
    Ms[tid] = ok ? ms[it] : 0.f;
    dens[tid] = ok ? denb[it] : 1.f;
    dss[tid] = ok ? dsb[it] : 0.f;
    decs[tid] = ok ? decb[it] : 0.f;
  }
  __syncthreads();
  const int last = nt - 1;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = tw + a, s = lane;
    const float wt = (s <= t && t < nt)
                         ? expf(Is[s] + Fs[t] - Fs[s] - Ms[t])
                         : 0.f;
    const float x = vd[a] / dens[t] + dss[t], am = wt * p[a];
    const long long e = (ckw * L + t) * L + s;
    Eg[e] = wt * x;
    Ag[e] = am / dens[t];
    Rs[t][s] = am * x;
  }
  if (lane < 4) {
    const int t = tw + lane;
    if (t < nt)
      pd[(row0 + static_cast<long long>(t) * H) * Z1 + Z1 - 1] =
          decs[t] * dss[t] * dot;
  } else if (lane < 8) {
    const int s = tw + lane - 4;
    if (s < nt)
      pr[(row0 + static_cast<long long>(s) * H) * Z1 + Z1 - 1] =
          expf(Is[s] + Fs[last] - Fs[s] - Ms[last]) * dot;
  } else if (tid == 8) {
    pc[ckg * Z1 + Z1 - 1] = decs[last] * dot;
  }
  __syncthreads();
  if (tid < nt) {
    float c = 0.f;
    for (int t = tid; t < nt; ++t) c += Rs[t][tid];
    colb[row0 + static_cast<long long>(tid) * H] = c;
  } else if (tid >= L && tid - L < nt) {
    const int r = tid - L;
    float c = 0.f;
    for (int t = r; t < nt; ++t)
      for (int s = 0; s < r; ++s) c += Rs[t][s];
    rectb[row0 + static_cast<long long>(r) * H] = c;
  }
}

// Dynamic shared memory of bchunk_kernel, in floats: q's (then dy's) and
// k's rows of the column tile, E, E^T and A', two stages of the ring
// (C_j's and G_j's rows and dY's and V's slabs in the first pass, G_j's
// rows of the tile and K's slab in the second), n_j and dn_{j+1}.
constexpr int kStageB = 2 * RS * CP + 2 * L * YP;
constexpr int kStageC = CT * GP + L * GP;
constexpr int kStage = kStageB > kStageC ? kStageB : kStageC;
constexpr int kChunkFloats = 2 * L * CP + 3 * L * EP + 2 * kStage + 2 * CT;

// grid (B * H, chunks of the window [jb, jb + W), ceil(D / CT)), kThreads,
// kChunkFloats floats of dynamic shared memory.  Chunk j = jb + blockIdx.y
// of (b, h) and the column tile [c0, c0 + CT), c0 = CT blockIdx.z; warp w
// owns steps 4 w .. 4 w + 3, lane l columns c0 + 4 l .. + 3 (first pass) or
// rows c0 + l + 32 i (dv).
//   First pass, over C_j's and G_j's rows in slabs of RS (cp.async, two
//   stages): U = dY C_j and VG = V G_j on the tile's columns, and (warp 0)
//   <G_j, C_j> there.  Then dq_t = dec_t (U_t / den_t + ds_t n_j) + sum_s
//   E_ts k_s and dk_s = g_s (VG_s + dn_{j+1}) + sum_t E_ts q_t; the decays'
//   term dec_t U_t . q_t / den_t into pd, the state weights'
//   g_s VG_s . k_s into pr and a <G_j, C_j> into pc, each at slot
//   blockIdx.z.
//   Second pass, over G_j's columns in slabs of CS: dv_s = g_s G_j k_s +
//   sum_t A'_ts dy_t on the tile's rows.
// q, k, v, dy: (B, S, H, D); li, ms and the per-step buffers: (B, S, H);
// ckC, ckn: the recorded checkpoints; Gst, Gnst: dstates_kernel's; Eg, Ag:
// bsmall_kernel's.
__global__ void __launch_bounds__(kThreads, 2) bchunk_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dy,
    const float* __restrict__ li, const float* __restrict__ ms,
    const float* __restrict__ Fb, const float* __restrict__ denb,
    const float* __restrict__ dsb, const float* __restrict__ decb,
    const float* __restrict__ ckC, const float* __restrict__ ckn,
    const float* __restrict__ Gst, const float* __restrict__ Gnst,
    const float* __restrict__ Eg, const float* __restrict__ Ag,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ pd, float* __restrict__ pr, float* __restrict__ pc,
    int S, int H, int D, int jb, int W, int Z1) {
  extern __shared__ __align__(16) float bsm[];
  float* Qt = bsm;              // [L][CP]: q's columns of the tile, then dy's
  float* Kt = Qt + L * CP;      // [L][CP]: k's
  float* Et = Kt + L * CP;      // [L][EP]: E (t, s)
  float* ETt = Et + L * EP;     // [L][EP]: E^T (s, t)
  float* At = ETt + L * EP;     // [L][EP]: A' (t, s)
  float* ring = At + L * EP;    // 2 stages of kStage
  float* nj = ring + 2 * kStage;  // [CT]
  float* gn = nj + CT;            // [CT]
  __shared__ float decs[L], dss[L], dens[L], gs[L];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = jb + blockIdx.y;
  const int NC = (S + L - 1) / L, t0 = j * L, nt = min(L, S - t0);
  const int c0 = blockIdx.z * CT, ct = min(CT, D - c0), z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, tw = 4 * (tid >> 5);
  const bool cok = 4 * lane < ct;
  const long long row0 = (static_cast<long long>(b) * S + t0) * H + h;
  const long long qrow = row0 * D, qstride = static_cast<long long>(H) * D;
  const long long DD = static_cast<long long>(D) * D;
  const long long ckg = (static_cast<long long>(b) * NC + j) * H + h;
  const long long ckw = (static_cast<long long>(b) * W + blockIdx.y) * H + h;
  const float* Cj = ckC + ckg * DD;
  const float* Gj = Gst + ckw * DD;

  // q's and k's columns of the tile, n_j and dn_{j+1} (the first slab's
  // group); E, E^T, A' and the step scalars by plain loads
  copy_slab(Qt, CP, q, qrow, qstride, nt, L, c0, ct);
  copy_slab(Kt, CP, k, qrow, qstride, nt, L, c0, ct);
  if (tid < ct / 4) {
    cp_async16(nj + 4 * tid, ckn + ckg * D + c0 + 4 * tid, true);
    cp_async16(gn + 4 * tid, Gnst + ckw * D + c0 + 4 * tid, true);
  }
  for (int x = tid; x < L * L; x += kThreads) {
    const int t = x / L, s = x % L;
    const float e = Eg[ckw * L * L + x];
    Et[t * EP + s] = e;
    ETt[s * EP + t] = e;
    At[t * EP + s] = Ag[ckw * L * L + x];
  }
  if (tid < L) {
    const bool ok = tid < nt;
    const long long it = row0 + static_cast<long long>(tid) * H;
    const long long il = row0 + static_cast<long long>(nt - 1) * H;
    decs[tid] = ok ? decb[it] : 0.f;
    dss[tid] = ok ? dsb[it] : 0.f;
    dens[tid] = ok ? denb[it] : 1.f;
    gs[tid] = ok ? expf(li[it] + Fb[il] - Fb[it] - ms[il]) : 0.f;
  }

  // first pass: U = dY C_j, VG = V G_j over the rows of D
  const int nrs = (D + RS - 1) / RS;
  auto stage_b = [&](int sl) {
    float* Cs = ring + (sl & 1) * kStage;
    float* Gs = Cs + RS * CP;
    float* Ys = Gs + RS * CP;
    float* Vs = Ys + L * YP;
    const int r0 = sl * RS, kr = min(RS, D - r0);
    copy_slab(Cs, CP, Cj, static_cast<long long>(r0) * D, D, kr, RS, c0, ct);
    copy_slab(Gs, CP, Gj, static_cast<long long>(r0) * D, D, kr, RS, c0, ct);
    copy_slab(Ys, YP, dy, qrow, qstride, nt, L, r0, kr);
    copy_slab(Vs, YP, v, qrow, qstride, nt, L, r0, kr);
    cp_async_commit();
  };
  float U[4][4], VG[4][4], cg = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) U[a][e] = VG[a][e] = 0.f;
  stage_b(0);
  for (int sl = 0; sl < nrs; ++sl) {
    if (sl + 1 < nrs)
      stage_b(sl + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Cs = ring + (sl & 1) * kStage;
    const float* Gs = Cs + RS * CP;
    const float* Ys = Gs + RS * CP;
    const float* Vs = Ys + L * YP;
    const int kr = min(RS, D - sl * RS);
    for (int r4 = 0; r4 < kr; r4 += 4) {
      float4 ya[4], va[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ya[a] = ld4(Ys + (tw + a) * YP + r4);
        va[a] = ld4(Vs + (tw + a) * YP + r4);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float4 cr = ld4(Cs + (r4 + rr) * CP + 4 * lane);
        const float4 gr = ld4(Gs + (r4 + rr) * CP + 4 * lane);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          fma4(U[a], comp(ya[a], rr), cr);
          fma4(VG[a], comp(va[a], rr), gr);
        }
        if (tw == 0) cg = dot4(cr, gr, cg);
      }
    }
    __syncthreads();
  }

  // dq and the decays' term
  {
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = tw + a;
      const float inv = 1.f / dens[t];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        U[a][e] *= inv;
        acc[a][e] = decs[t] * fmaf(dss[t], nj[4 * lane + e], U[a][e]);
      }
    }
#pragma unroll 4
    for (int s = 0; s < L; ++s) {
      const float4 et = ld4(ETt + s * EP + tw);
      const float4 kr = ld4(Kt + s * CP + 4 * lane);
#pragma unroll
      for (int a = 0; a < 4; ++a) fma4(acc[a], comp(et, a), kr);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = tw + a;
      const float part = warp_sum(cok ? dot4a(U[a], ld4(Qt + t * CP + 4 * lane))
                                      : 0.f);
      if (t < nt) {
        const long long it = row0 + static_cast<long long>(t) * H;
        if (cok)
          *reinterpret_cast<float4*>(dq + it * D + c0 + 4 * lane) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        if (lane == 0) pd[it * Z1 + z] = decs[t] * part;
      }
    }
    // dk and the state weights' term
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int s = tw + a;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[a][e] = gs[s] * (VG[a][e] + gn[4 * lane + e]);
    }
#pragma unroll 4
    for (int t = 0; t < L; ++t) {
      const float4 er = ld4(Et + t * EP + tw);
      const float4 qr = ld4(Qt + t * CP + 4 * lane);
#pragma unroll
      for (int a = 0; a < 4; ++a) fma4(acc[a], comp(er, a), qr);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int s = tw + a;
      const float part = warp_sum(cok ? dot4a(VG[a], ld4(Kt + s * CP + 4 * lane))
                                      : 0.f);
      if (s < nt) {
        const long long it = row0 + static_cast<long long>(s) * H;
        if (cok)
          *reinterpret_cast<float4*>(dk + it * D + c0 + 4 * lane) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        if (lane == 0) pr[it * Z1 + z] = gs[s] * part;
      }
    }
    if (tw == 0) {
      cg = warp_sum(cok ? cg : 0.f);
      if (lane == 0) pc[ckg * Z1 + z] = decs[nt - 1] * cg;
    }
  }
  __syncthreads();  // Qt and the ring are read no more

  // second pass: dv on the tile's rows, G_j k over the columns of D
  const int ncs = (D + CS - 1) / CS;
  auto stage_c = [&](int sl) {
    float* Gd = ring + (sl & 1) * kStage;
    float* Kc = Gd + CT * GP;
    const int cb = sl * CS, kc = min(CS, D - cb);
    copy_slab(Gd, GP, Gj, static_cast<long long>(c0) * D, D, ct, CT, cb, kc);
    copy_slab(Kc, GP, k, qrow, qstride, nt, L, cb, kc);
    cp_async_commit();
  };
  copy_slab(Qt, CP, dy, qrow, qstride, nt, L, c0, ct);  // slab 0's group
  stage_c(0);
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[a][i] = 0.f;
  for (int sl = 0; sl < ncs; ++sl) {
    if (sl + 1 < ncs)
      stage_c(sl + 1);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Gd = ring + (sl & 1) * kStage;
    const float* Kc = Gd + CT * GP;
    const int kc = min(CS, D - sl * CS);
    for (int c4 = 0; c4 < kc; c4 += 4) {
      float4 ka[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ka[a] = ld4(Kc + (tw + a) * GP + c4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 gr = ld4(Gd + (lane + 32 * i) * GP + c4);
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][i] = dot4(ka[a], gr, acc[a][i]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[a][i] *= gs[tw + a];
#pragma unroll 4
  for (int t = 0; t < L; ++t) {
    const float4 at = ld4(At + t * EP + tw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float yv = Qt[t * CP + lane + 32 * i];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][i] = fmaf(comp(at, a), yv, acc[a][i]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int s = tw + a;
    if (s >= nt) continue;
    const long long it = row0 + static_cast<long long>(s) * H;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (lane + 32 * i < ct) dv[it * D + c0 + lane + 32 * i] = acc[a][i];
  }
}

// The reverse of the m recurrence over the chunkwise terms, one block per
// (b, h), a tile of up to kRevTile / L chunks at a time: each step's
// partial sums (the column tiles' and slot Z1 - 1) give Delta_t and
// Rout_t, each chunk's give Delta_out; within the chunk, d x_r = sum_{t >=
// r} Delta_t + Delta_out + rect_r + sum_{s < r} Rout_s and d z_s = col_s +
// Rout_s; then one thread carries dm from the last step to the first
// (mrev_tile, as mrev_kernel does with d x = dF f' and d z = dI i').
__global__ void cmrev_kernel(const float* __restrict__ li,
                             const float* __restrict__ lf,
                             const float* __restrict__ m0,
                             const float* __restrict__ ms,
                             const float* __restrict__ dmgb,
                             const float* __restrict__ pd,
                             const float* __restrict__ pr,
                             const float* __restrict__ pc,
                             const float* __restrict__ rectb,
                             const float* __restrict__ colb,
                             float* __restrict__ dli, float* __restrict__ dlf,
                             int S, int H, int Z1) {
  constexpr int kTileChunks = kRevTile / L;
  __shared__ float sD[kRevTile], sR[kRevTile], sA[kRevTile], sB[kRevTile],
      sW[kRevTile], sG[kRevTile], sO[kTileChunks];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, NC = (S + L - 1) / L;
  auto idx = [&](int t) { return (static_cast<long long>(b) * S + t) * H + h; };
  float dm = 0.f;
  for (int jh = NC; jh > 0; jh -= kTileChunks) {
    const int jl = max(0, jh - kTileChunks), lo = jl * L, hi = min(S, jh * L);
    for (int t = lo + threadIdx.x; t < hi; t += blockDim.x) {
      const long long i = idx(t);
      float d = 0.f, r = 0.f;
      for (int x = 0; x < Z1; ++x) {
        d += pd[i * Z1 + x];
        r += pr[i * Z1 + x];
      }
      sD[t - lo] = d;
      sR[t - lo] = r;
      sW[t - lo] = tie_weight(lf[i] + (t == 0 ? m0[bh] : ms[i - H]), li[i]);
      sG[t - lo] = dmgb[i];
    }
    for (int jj = jl + threadIdx.x; jj < jh; jj += blockDim.x) {
      const long long ck = (static_cast<long long>(b) * NC + jj) * H + h;
      float o = 0.f;
      for (int x = 0; x < Z1; ++x) o += pc[ck * Z1 + x];
      sO[jj - jl] = o;
    }
    __syncthreads();
    for (int t = lo + threadIdx.x; t < hi; t += blockDim.x) {
      const int u = t - lo, jj = t / L;
      const int cs = jj * L - lo, ce = min(hi, (jj + 1) * L) - lo;
      float suf = 0.f, pre = 0.f;
      for (int x = u; x < ce; ++x) suf += sD[x];
      for (int x = cs; x < u; ++x) pre += sR[x];
      const long long i = idx(t);
      sA[u] = suf + sO[jj - jl] + rectb[i] + pre;
      sB[u] = colb[i] + sR[u];
    }
    __syncthreads();
    if (threadIdx.x == 0)
      dm = mrev_tile(sA, sB, sW, sG, dli, dlf, b, h, S, H, lo, hi, dm);
    __syncthreads();
  }
}

}  // namespace chunkwise

inline int round_warp(int d) { return (d + 31) / 32 * 32; }

}  // namespace mlstm
}  // namespace repro

// q, k, v: (B, S, H, D) f32; li, lf: (B, S, H); C0: (B, H, D, D); n0: (B, H,
// D); m0: (B, H).  Writes y (B, S, H, D), C, n, m (the last carries) and,
// for chunk > 0, ckC (B, ceil(S / chunk), H, D, D), ckn (B, .., H, D), ms,
// ss (B, S, H).  D <= 1024.  Returns the cudaError_t of the launch.
extern "C" int mlstm_scan_forward(
    const void* q, const void* k, const void* v, const void* li,
    const void* lf, const void* C0, const void* n0, const void* m0, void* y,
    void* C, void* n, void* m, void* ckC, void* ckn, void* ms, void* ss,
    int B, int S, int H, int D, int chunk, void* stream) {
  using namespace repro::mlstm;
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > 32 * kMaxWarps || chunk < 0)
    return cudaErrorInvalidValue;
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto f = [](void* p) { return static_cast<float*>(p); };
  fwd_kernel<<<dim3(B * H, (D + kFwdRows - 1) / kFwdRows), round_warp(D), 0,
               static_cast<cudaStream_t>(stream)>>>(
      cf(q), cf(k), cf(v), cf(li), cf(lf), cf(C0), cf(n0), cf(m0), f(y), f(C),
      f(n), f(m), f(ckC), f(ckn), f(ms), f(ss), S, H, D, chunk);
  return cudaGetLastError();
}

// The chunkwise forward: the one-pass forward's inputs and outputs, with
// Cst (B, W, H, D, D) and Nst (B, W, H, D), the states before each 32-step
// chunk of a window of W chunks (W = NC = ceil(S / 32) for a recorded
// forward: its ckC and ckn; otherwise scratch, reused window after window),
// mbuf (B, S, H), every step's m' (its ms, or scratch), ss (B, S, H,
// written with save), scratch 2 B S H + B NC H floats.  D a multiple of 4
// up to 1024; q, k, v, C0, n0, C, n, Cst and Nst 16-byte aligned.  One
// launch for the stabilizer, then two a window (the chain of its states,
// its outputs), on the stream.  Returns the first cudaError_t.
extern "C" int mlstm_scan_forward_chunkwise(
    const void* q, const void* k, const void* v, const void* li,
    const void* lf, const void* C0, const void* n0, const void* m0, void* y,
    void* C, void* n, void* m, void* Cst, void* Nst, void* mbuf, void* ss,
    void* scratch, int B, int S, int H, int D, int save, int W,
    void* stream) {
  using namespace repro::mlstm::chunkwise;
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > 32 * repro::mlstm::kMaxWarps
      || D % 4 || W < 1)
    return cudaErrorInvalidValue;
  if (!repro::aligned16(q, k, v, C0, n0, C, n, Cst, Nst))
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto f = [](void* p) { return static_cast<float*>(p); };
  const int BH = B * H, NC = (S + L - 1) / L;
  if (save && W < NC) return cudaErrorInvalidValue;
  // scratch: F and g (B, S, H) each, then the chunks' decays (B, NC, H)
  float* Fbuf = f(scratch);
  float* Gbuf = Fbuf + static_cast<long long>(B) * S * H;
  float* Abuf = Gbuf + static_cast<long long>(B) * S * H;
  gates_kernel<<<(BH * 32 + 127) / 128, 128, 0, st>>>(
      cf(li), cf(lf), cf(m0), f(mbuf), Fbuf, Gbuf, Abuf, B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // value tiles split over blocks until a window's grid covers the SMs
  // twice
  const int sms = repro::sm_count();
  if (sms < 1) return cudaGetLastError();
  const int nvt = (D + VT - 1) / VT, wc = W < NC ? W : NC;
  int vz = 1;
  while (2 * vz <= nvt && static_cast<long long>(BH) * wc * vz < 2LL * sms)
    vz *= 2;
  // out_kernel's shared-memory limit, raised once a device when a larger D
  // asks (the attribute calls on every launch cost host time)
  static size_t smem_set[repro::kMaxDevices];
  const int dev = repro::device_slot();
  if (dev < 0) return cudaErrorInvalidDevice;
  const size_t smem = sizeof(float) * out_floats(D);
  if (smem > smem_set[dev]) {
    if ((err = repro::allow_smem(out_kernel, smem)) != cudaSuccess)
      return err;
    smem_set[dev] = smem;
  }
  for (int jb = 0; jb < NC; jb += wc) {
    // the carries: the caller's, then the last window's C and n
    states_kernel<<<dim3(BH, (D + TV - 1) / TV, (D + TK - 1) / TK),
                    kThreads, 0, st>>>(
        cf(k), cf(v), Gbuf, Abuf, cf(mbuf), jb ? cf(C) : cf(C0),
        jb ? cf(n) : cf(n0), f(Cst), f(Nst), f(C), f(n), f(m), S, H, D, jb,
        wc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int cnt = NC - jb < wc ? NC - jb : wc;
    out_kernel<<<dim3(BH, cnt, vz), kThreads, smem, st>>>(
        cf(q), cf(k), cf(v), cf(li), cf(mbuf), Fbuf, cf(m0), cf(Cst),
        cf(Nst), f(y), f(ss), S, H, D, save, jb, wc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// dy, q, k, v, y: (B, S, H, D) f32; li, lf, ms, ss: (B, S, H); m0: (B, H);
// ckC, ckn: the forward's checkpoints every chunk steps.  Writes dq, dk,
// dv (B, S, H, D) and dli, dlf (B, S, H).  Scratch (xlstm_scan.py allocates
// it for `rows` value rows a block, which must be kBwdRows; NB = ceil(D /
// rows), DP = round_up(D, 32)): Cs (B H NB, chunk + 1, rows, DP), Ns (B H
// NB, chunk + 1, DP), dq_part and dk_part (B, S, H, NB, D), dF_part and
// dI_part (B, S, H, NB), ds and dmg (B, S, H).  Four launches on the
// stream.  Returns the first cudaError_t.
extern "C" int mlstm_scan_backward(
    const void* dy, const void* q, const void* k, const void* v,
    const void* li, const void* lf, const void* m0, const void* ckC,
    const void* ckn, const void* ms, const void* ss, const void* y, void* dq,
    void* dk, void* dv, void* dli, void* dlf, void* Cs, void* Ns,
    void* dq_part, void* dk_part, void* dF_part, void* dI_part, void* ds,
    void* dmg, int B, int S, int H, int D, int chunk, int rows,
    void* stream) {
  using namespace repro::mlstm;
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > 32 * kMaxWarps || chunk < 1
      || rows != kBwdRows)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto f = [](void* p) { return static_cast<float*>(p); };
  const long long N = static_cast<long long>(B) * S * H;
  const int NB = (D + kBwdRows - 1) / kBwdRows;
  bwd_prep_kernel<<<static_cast<unsigned>((N * 32 + 255) / 256), 256, 0,
                    st>>>(cf(dy), cf(y), cf(ms), cf(ss), f(ds), f(dmg), N,
                          D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_kernel<kBwdRows><<<dim3(B * H, NB), round_warp(D), 0, st>>>(
      cf(q), cf(k), cf(v), cf(li), cf(lf), cf(m0), cf(ckC), cf(ckn), cf(ms),
      cf(ss), cf(dy), cf(ds), f(Cs), f(Ns), f(dv), f(dq_part), f(dk_part),
      f(dF_part), f(dI_part), S, H, D, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_kernel<<<static_cast<unsigned>(N), min(round_warp(D), 256), 0,
                  st>>>(cf(dq_part), cf(dk_part), f(dq), f(dk), NB, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mrev_kernel<<<B * H, 256, 0, st>>>(cf(li), cf(lf), cf(m0), cf(ms),
                                     cf(dF_part), cf(dI_part), cf(dmg),
                                     f(dli), f(dlf), S, H, NB);
  return cudaGetLastError();
}

// The chunkwise backward (mlstm_scan_backward_chunkwise): the first
// design's inputs and outputs, for a forward recorded with chunk L (its ckC,
// ckn: the state before every 32-step chunk).  The chunk-end gradients are
// kept for a window of W chunks at a time (W = NC when they fit the
// caller's budget), the windows walked from the last.  scratch, in floats:
// B W H (D^2 + D + 2 L^2) + B H (D^2 + D) + B S H (9 + 2 Z1) + B NC H (1 +
// Z1), Z1 = ceil(D / CT) + 1 (xlstm_scan.mlstm_bwd_scratch counts the
// same).  D a multiple of 4 up to 1024; dy, q, k, v, ckC, ckn, dq, dk and
// scratch 16-byte aligned.  Launches: the per-step terms, then three a
// window (the chain of chunk-end gradients, the in-chunk matrices, the
// products with C_j and G_j), then the m reverse, on the stream.  Returns
// the first cudaError_t.
extern "C" int mlstm_scan_backward_chunkwise(
    const void* dy, const void* q, const void* k, const void* v,
    const void* li, const void* lf, const void* m0, const void* ckC,
    const void* ckn, const void* ms, const void* ss, const void* y, void* dq,
    void* dk, void* dv, void* dli, void* dlf, void* scratch, int B, int S,
    int H, int D, int W, void* stream) {
  using namespace repro::mlstm::chunkwise;
  if (B < 1 || S < 1 || H < 1 || D < 1 || D > 32 * repro::mlstm::kMaxWarps
      || D % 4 || W < 1)
    return cudaErrorInvalidValue;
  if (!repro::aligned16(dy, q, k, v, ckC, ckn, dq, dk, scratch))
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto cf = [](const void* p) { return static_cast<const float*>(p); };
  const auto f = [](void* p) { return static_cast<float*>(p); };
  const int BH = B * H, NC = (S + L - 1) / L, wc = W < NC ? W : NC;
  const int NZ = (D + CT - 1) / CT, Z1 = NZ + 1;
  const long long N = static_cast<long long>(B) * S * H;
  const long long NCH = static_cast<long long>(B) * NC * H;
  const long long DD = static_cast<long long>(D) * D;
  const long long BWH = static_cast<long long>(B) * wc * H;
  float* Gst = f(scratch);
  float* dCc = Gst + BWH * DD;
  float* Gnst = dCc + static_cast<long long>(BH) * DD;
  float* dnc = Gnst + BWH * D;
  float* Eg = dnc + static_cast<long long>(BH) * D;
  float* Ag = Eg + BWH * L * L;
  float* Fb = Ag + BWH * L * L;
  float* decb = Fb + N;
  float* denb = decb + N;
  float* dsb = denb + N;
  float* dmgb = dsb + N;
  float* eb = dmgb + N;
  float* hb = eb + N;
  float* rectb = hb + N;
  float* colb = rectb + N;
  float* pd = colb + N;
  float* pr = pd + N * Z1;
  float* Ab = pr + N * Z1;
  float* pc = Ab + NCH;
  bgates_kernel<<<static_cast<unsigned>(NCH), kThreads, 0, st>>>(
      cf(dy), cf(y), cf(lf), cf(m0), cf(ms), cf(ss), Fb, decb, denb, dsb,
      dmgb, eb, hb, Ab, S, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // bchunk_kernel's shared-memory limit, raised once a device
  static bool smem_set[repro::kMaxDevices];
  const int dev = repro::device_slot();
  if (dev < 0) return cudaErrorInvalidDevice;
  const size_t smem = sizeof(float) * kChunkFloats;
  if (!smem_set[dev]) {
    if ((err = repro::allow_smem(bchunk_kernel, smem)) != cudaSuccess)
      return err;
    smem_set[dev] = true;
  }
  const int nwin = (NC + wc - 1) / wc;
  for (int wi = nwin - 1; wi >= 0; --wi) {
    const int jb = wi * wc, cnt = NC - jb < wc ? NC - jb : wc;
    dstates_kernel<<<dim3(BH, (D + TV - 1) / TV, (D + TK - 1) / TK),
                     kThreads, 0, st>>>(
        cf(dy), cf(q), eb, hb, Ab, dCc, dnc, Gst, Gnst, S, H, D, jb, wc,
        wi == nwin - 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bsmall_kernel<<<dim3(BH, cnt), kThreads, 0, st>>>(
        cf(q), cf(k), cf(v), cf(dy), cf(li), cf(ms), Fb, denb, dsb, decb,
        cf(ckn), Gnst, Eg, Ag, rectb, colb, pd, pr, pc, S, H, D, jb, wc, Z1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bchunk_kernel<<<dim3(BH, cnt, NZ), kThreads, smem, st>>>(
        cf(q), cf(k), cf(v), cf(dy), cf(li), cf(ms), Fb, denb, dsb, decb,
        cf(ckC), cf(ckn), Gst, Gnst, Eg, Ag, f(dq), f(dk), f(dv), pd, pr, pc,
        S, H, D, jb, wc, Z1);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  cmrev_kernel<<<BH, 256, 0, st>>>(cf(li), cf(lf), cf(m0), cf(ms), dmgb, pd,
                                   pr, pc, rectb, colb, f(dli), f(dlf), S, H,
                                   Z1);
  return cudaGetLastError();
}
