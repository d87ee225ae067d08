// The attention kernels for head dims without tiles of their own: every
// multiple of 64 but 64, 128 and 256 (192, 320, 384, 448, 512, ...), with D a
// runtime argument. One instantiation a dtype serves every such D: the two-pass
// and the online forward, the recompute backward's dq launch, and the lse
// backward's dq and dk/dv launches, for simple_attention.cu (which
// qblock_attention launches too), causal_attention.cu and blocked_flash.cu
// (its bf_* and lf_* entry points alike).
//
// What is hard at these dims: a warp's 16 x D f32 accumulator is D / 2
// registers a thread (192 at D = 384, 256 at 512), which do not fit beside
// the scores; and Q with double-buffered K and V at a pitch of D + 8 needs
// ~200 KB of shared memory at D = 512 in bf16, twice that in f32.
//
// What this design does about it: the grid gets a column-chunk axis. A block
// owns one 64-row tile (q rows; kv rows for dk/dv) and one chunk of 64
// columns of what it accumulates (o, dq, or dk and dv), and computes every
// score product (Q K^T, dO V^T, or K Q^T and V dO^T for dk/dv) over the
// whole of D by streaming D in 64-column slices of both operands through
// shared memory, adding each slice's product into the score fragments. The
// block's own chunk is the last slice of each visit (slices run from chunk
// c + 1 around to c), so the K (dq) or the Q and dO (dk/dv) columns that the
// accumulating product needs are the ones in shared memory when the scores
// are complete. Every tile is 64 x 64 at the pitch, registers and shared
// memory of the D = 64 tiles, whatever D. The row statistics lse and delta
// are written by chunk 0 only; every chunk computes the same ones.
//
// The function and its rounding points are those of the kernels for the
// dims with tiles of their own (attention_mma.cuh's header): only the f32
// order in which a score sums its D products differs (slice by slice).
// bf16 and f16 run on the tensor cores (mma.sync, ldmatrix, cp.async with
// the stage of slice t + 1 in flight while slice t is multiplied; 4 warps,
// 16 rows each); f32 on the CUDA cores (attention_tiles.cuh's 16 x 16
// threads and f32 tiles, loaded synchronously), chosen by dtype at compile
// time in the launchers.
//
// What it costs: every chunk recomputes the score products, D / 64 times
// what the function needs of them: at D = 512 the two-pass forward does
// 8 x (2 Q K^T) + P V where the function needs Q K^T + P V. Keeping the
// accumulator in shared memory, or wider chunks where D allows, is later
// work (ROADMAP queue 2).
#pragma once

#include "attention_mma.cuh"

namespace {

using WideCfg = MmaCfg<kWideChunk>;       // 64-row tiles at a pitch of 72
constexpr int kWideTile = WideCfg::BM * WideCfg::LD;
static_assert(WideCfg::BM == kWideChunk && WideCfg::BN == kWideChunk &&
                  WideCfg::KN == kWideChunk && WideCfg::BQ == kWideChunk,
              "the wide kernels' tiles are square");
using WideTile = Tile<kWideChunk>;        // the CUDA-core tiles (f32)

// kv tiles a q tile at q0 sees: causal is top-left, and with Sq > Skv (the
// library tier) the rows past Skv see every kv tile.
__device__ __forceinline__ int wide_kend(int q0, int Skv, int causal) {
  const int diag = (q0 + kWideChunk) / kWideChunk, all = Skv / kWideChunk;
  return causal && diag < all ? diag : all;
}

// The forward on the tensor cores (bf16, f16): one block per (q tile, chunk,
// head, batch), heaviest causal q tiles first. ONLINE: blocked_flash's
// online softmax (the unnormalized p rounded before P V, the division by l at
// the end). Otherwise the two-pass forward: a statistics pass over the kv
// tiles for m and l, then p = exp(s - m) / l rounded before P V. Stage st
// streams slice st % nd of visit st / nd (a kv tile of a pass), and the last
// slice of a P V visit brings the tile's V chunk. lse (when not null) is
// m + log l, [B, H, Sq] f32 contiguous.
template <typename T, bool ONLINE>
__global__ void __launch_bounds__(kMmaThreads)
    mma_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        T* __restrict__ o, float* __restrict__ lse, Layout lq, Layout lkv,
                        Layout lo, int Sq, int Skv, int D, float scale, int causal) {
  constexpr int BM = WideCfg::BM, BN = WideCfg::BN, LD = WideCfg::LD, DC = kWideChunk;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* sQ = reinterpret_cast<T*>(mma_smem);  // two buffers each of a Q slice,
  T* sK = sQ + 2 * kWideTile;              // a K slice
  T* sV = sK + 2 * kWideTile;              // and a V chunk
  const int nd = D / DC, c = blockIdx.x % nd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (Sq / BM - 1 - static_cast<int>(blockIdx.x) / nd) * BM, r0 = warp * 16;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long qbase = b * lq.sb + h * lq.sh + static_cast<long long>(q0) * lq.ss;
  const long long kvbase = b * lkv.sb + h * lkv.sh;
  const int kend = wide_kend(q0, Skv, causal);
  const int pass = ONLINE ? 0 : kend;  // visits of the statistics pass
  const int stages = (pass + kend) * nd;

  auto prefetch = [&](int st) {
    if (st < stages) {
      const int visit = st / nd, ds = st % nd, buf = (st & 1) * kWideTile;
      const long long off = kvbase + static_cast<long long>(visit < pass ? visit : visit - pass) * BN * lkv.ss;
      copy_tile<T, DC, BM>(sQ + buf, q + qbase + ds * DC, lq.ss);
      copy_tile<T, DC, BN>(sK + buf, k + off + ds * DC, lkv.ss);
      if (visit >= pass && ds == nd - 1) copy_tile<T, DC, BN>(sV + buf, v + off + c * DC, lkv.ss);
    }
    cp_async_commit();
  };
  prefetch(0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2] = {0.f, 0.f};
  float acc[DC / 8][4], s[BN / 8][4];
  zero_frags<DC / 8>(acc);
  for (int st = 0; st < stages; ++st) {
    prefetch(st + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int visit = st / nd, ds = st % nd, buf = (st & 1) * kWideTile;
    if (ds == 0) zero_frags<BN / 8>(s);
    warp_abt_add<T, DC, BN>(s, sQ + buf + r0 * LD, sK + buf);
    if (ds == nd - 1) {
      const int k0 = (visit < pass ? visit : visit - pass) * BN;
      scale_mask<BN / 8, false>(s, scale, causal && k0 + BN - 1 > q0 + r0, q0 + r0, k0);
      if (visit < pass) {
        stats_step<BN / 8>(s, m, l);
        if (visit == pass - 1) {
          rl[0] = 1.f / l[0];
          rl[1] = 1.f / l[1];
        }
      } else {
        if constexpr (ONLINE) {
          online_step<BN / 8, DC / 8>(s, acc, m, l);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = __expf(s[j][e] - m[e >> 1]) * rl[e >> 1];
        }
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          uint32_t af[4];
          a_frag<T>(af, s, kk);  // p rounded to the input dtype
          warp_ab<T, LD, DC>(acc, af, sV + buf + kk * 16 * LD);
        }
      }
    }
    __syncthreads();
  }
  if constexpr (ONLINE) {
#pragma unroll
    for (int j = 0; j < DC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] /= l[e >> 1];
  }
  store_rows<T, DC>(o + b * lo.sb + h * lo.sh, lo.ss, acc, q0 + r0, c * DC);
  if (lse != nullptr && c == 0 && (lane & 3) == 0) {
    const long long row = (static_cast<long long>(b) * gridDim.y + h) * Sq + q0 + r0 + (lane >> 2);
    lse[row] = m[0] + logf(l[0]);
    lse[row + 8] = m[1] + logf(l[1]);
  }
}

// Backward launch A on the tensor cores, one block per (q tile, chunk, head,
// batch): dS = P (dP - delta) scale with P = exp(s - lse), dq's chunk =
// dS K[:, chunk], over the kv tiles; stage st streams slice (c + 1 + st) % nd
// of Q, dO, K and V. LSE: lse is the forward's, delta = rowsum(dO * O) over
// the whole row. Otherwise (the recompute backward) a first pass finds m, l
// and delta = rowsum(dP * P) together, as mma_dq_kernel's does.
template <typename T, bool LSE>
__global__ void __launch_bounds__(kMmaThreads) mma_wide_dq_kernel(BwdArgs a, T* __restrict__ dq,
                                                                  Layout ldq) {
  constexpr int BM = WideCfg::BM, BN = WideCfg::BN, LD = WideCfg::LD, DC = kWideChunk;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* sQ = reinterpret_cast<T*>(mma_smem);  // two buffers each of Q, dO, K and V slices
  T* sDO = sQ + 2 * kWideTile;
  T* sK = sDO + 2 * kWideTile;
  T* sV = sK + 2 * kWideTile;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int nd = a.D / DC, c = blockIdx.x % nd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (a.Sq / BM - 1 - static_cast<int>(blockIdx.x) / nd) * BM, r0 = warp * 16;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long kvbase = b * a.lkv.sb + h * a.lkv.sh;
  const long long row = (static_cast<long long>(b) * a.H + h) * a.Sq + q0 + r0 + (lane >> 2);
  const T* qb = static_cast<const T*>(a.q) + b * a.lq.sb + h * a.lq.sh +
                static_cast<long long>(q0) * a.lq.ss;
  const T* g = static_cast<const T*>(a.dout) + b * a.lg.sb + h * a.lg.sh +
               static_cast<long long>(q0) * a.lg.ss;
  const int kend = wide_kend(q0, a.Skv, a.causal);
  const int pass = LSE ? 0 : kend;
  const int stages = (pass + kend) * nd;

  auto prefetch = [&](int st) {
    if (st < stages) {
      const int visit = st / nd, ds = (c + 1 + st % nd) % nd, buf = (st & 1) * kWideTile;
      const long long off = kvbase +
                            static_cast<long long>(visit < pass ? visit : visit - pass) * BN * a.lkv.ss +
                            ds * DC;
      copy_tile<T, DC, BM>(sQ + buf, qb + ds * DC, a.lq.ss);
      copy_tile<T, DC, BM>(sDO + buf, g + ds * DC, a.lg.ss);
      copy_tile<T, DC, BN>(sK + buf, k + off, a.lkv.ss);
      copy_tile<T, DC, BN>(sV + buf, v + off, a.lkv.ss);
    }
    cp_async_commit();
  };
  prefetch(0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  if constexpr (LSE) {
    quad_row_dots<T>(delta, static_cast<const T*>(a.o) + b * a.lo.sb + h * a.lo.sh +
                                static_cast<long long>(q0 + r0) * a.lo.ss, a.lo.ss,
                     g + r0 * a.lg.ss, a.lg.ss, a.D);
    lse[0] = a.lse[row];
    lse[1] = a.lse[row + 8];
  }
  float acc[DC / 8][4], s[BN / 8][4], dp[BN / 8][4];
  zero_frags<DC / 8>(acc);
  for (int st = 0; st < stages; ++st) {
    prefetch(st + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int visit = st / nd, i = st % nd, buf = (st & 1) * kWideTile;
    if (i == 0) {
      zero_frags<BN / 8>(s);
      zero_frags<BN / 8>(dp);
    }
    warp_abt_add<T, DC, BN>(s, sQ + buf + r0 * LD, sK + buf);
    warp_abt_add<T, DC, BN>(dp, sDO + buf + r0 * LD, sV + buf);
    if (i == nd - 1) {
      const int k0 = (visit < pass ? visit : visit - pass) * BN;
      scale_mask<BN / 8, false>(s, a.scale, a.causal && k0 + BN - 1 > q0 + r0, q0 + r0, k0);
      if (visit < pass) {
        stats_delta_step<BN / 8>(s, dp, m, l, dd);
        if (visit == pass - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            lse[r] = m[r] + logf(l[r]);
            delta[r] = dd[r] / l[r];
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            s[j][e] = __expf(s[j][e] - lse[r]) * (dp[j][e] - delta[r]) * a.scale;
          }
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          uint32_t af[4];
          a_frag<T>(af, s, kk);
          warp_ab<T, LD, DC>(acc, af, sK + buf + kk * 16 * LD);  // K's chunk c
        }
      }
    }
    __syncthreads();
  }
  store_rows<T, DC>(dq + b * ldq.sb + h * ldq.sh, ldq.ss, acc, q0 + r0, c * DC);
  if (c == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!LSE) a.lse[row + 8 * r] = lse[r];
      a.delta[row + 8 * r] = delta[r];
    }
  }
}

// Backward launch B on the tensor cores, one block per (kv tile, chunk, head,
// batch), low kv tiles first: over the q tiles at and below the diagonal,
// P^T = exp(K Q^T - lse) and dS^T = P^T (V dO^T - delta) scale, with dv's
// chunk += P^T dO[:, chunk] and dk's chunk += dS^T Q[:, chunk]. Stage st
// streams slice (c + 1 + st) % nd of K, V, Q and dO; the last slice of a
// visit brings the q tile's lse and delta.
template <typename T>
__global__ void __launch_bounds__(kMmaThreads)
    mma_wide_dkv_kernel(BwdArgs a, T* __restrict__ dk, T* __restrict__ dv, Layout ldkv) {
  constexpr int KN = WideCfg::KN, BQ = WideCfg::BQ, LD = WideCfg::LD, DC = kWideChunk;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* sK = reinterpret_cast<T*>(mma_smem);  // two buffers each of K, V, Q and dO slices
  T* sV = sK + 2 * kWideTile;
  T* sQ = sV + 2 * kWideTile;
  T* sDO = sQ + 2 * kWideTile;
  float* sStat = reinterpret_cast<float*>(sDO + 2 * kWideTile);  // two buffers of lse, delta [2][BQ]
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const int nd = a.D / DC, c = blockIdx.x % nd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = static_cast<int>(blockIdx.x) / nd * KN;
  const long long qbase = b * a.lq.sb + h * a.lq.sh, gbase = b * a.lg.sb + h * a.lg.sh;
  const long long kvbase = b * a.lkv.sb + h * a.lkv.sh + static_cast<long long>(k0) * a.lkv.ss;
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const int qbeg = a.causal ? k0 / BQ : 0, visits = a.Sq / BQ - qbeg;
  float acc_k[DC / 8][4], acc_v[DC / 8][4];
  zero_frags<DC / 8>(acc_k);
  zero_frags<DC / 8>(acc_v);
  T* dkb = dk + b * ldkv.sb + h * ldkv.sh;
  T* dvb = dv + b * ldkv.sb + h * ldkv.sh;
  if (visits <= 0) {
    // causal, Sq < Skv (the library tier): no q row sees this kv tile
    store_rows<T, DC>(dkb, ldkv.ss, acc_k, k0 + r0, c * DC);
    store_rows<T, DC>(dvb, ldkv.ss, acc_v, k0 + r0, c * DC);
    return;
  }
  const int stages = visits * nd;

  auto prefetch = [&](int st) {
    if (st < stages) {
      const int i = st % nd, ds = (c + 1 + i) % nd, buf = (st & 1) * kWideTile;
      const int q0 = (qbeg + st / nd) * BQ;
      copy_tile<T, DC, KN>(sK + buf, static_cast<const T*>(a.k) + kvbase + ds * DC, a.lkv.ss);
      copy_tile<T, DC, KN>(sV + buf, static_cast<const T*>(a.v) + kvbase + ds * DC, a.lkv.ss);
      copy_tile<T, DC, BQ>(sQ + buf, q + qbase + static_cast<long long>(q0) * a.lq.ss + ds * DC,
                           a.lq.ss);
      copy_tile<T, DC, BQ>(sDO + buf,
                           dout + gbase + static_cast<long long>(q0) * a.lg.ss + ds * DC, a.lg.ss);
      if (i == nd - 1 && threadIdx.x < 2 * BQ / 4) {  // lse, delta: 16 bytes a thread
        const int w = threadIdx.x / (BQ / 4), cc = (threadIdx.x % (BQ / 4)) * 4;
        cp_async16(sStat + (st & 1) * 2 * BQ + w * BQ + cc, (w == 0 ? a.lse : a.delta) + row0 + q0 + cc);
      }
    }
    cp_async_commit();
  };
  prefetch(0);

  const int fc = 2 * (lane & 3);
  float p[BQ / 8][4], dsc[BQ / 8][4];
  for (int st = 0; st < stages; ++st) {
    prefetch(st + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int i = st % nd, buf = (st & 1) * kWideTile;
    if (i == 0) {
      zero_frags<BQ / 8>(p);
      zero_frags<BQ / 8>(dsc);
    }
    warp_abt_add<T, DC, BQ>(p, sK + buf + r0 * LD, sQ + buf);
    warp_abt_add<T, DC, BQ>(dsc, sV + buf + r0 * LD, sDO + buf);
    if (i == nd - 1) {
      const int q0 = (qbeg + st / nd) * BQ;
      const float* sm = sStat + (st & 1) * 2 * BQ;
      scale_mask<BQ / 8, true>(p, a.scale, a.causal && q0 < k0 + r0 + 15, k0 + r0, q0);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = __expf(p[j][e] - sm[8 * j + fc + (e & 1)]);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t af[4];
        a_frag<T>(af, p, kk);
        warp_ab<T, LD, DC>(acc_v, af, sDO + buf + kk * 16 * LD);  // dO's chunk c
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dsc[j][e] = p[j][e] * (dsc[j][e] - sm[BQ + 8 * j + fc + (e & 1)]) * a.scale;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t af[4];
        a_frag<T>(af, dsc, kk);
        warp_ab<T, LD, DC>(acc_k, af, sQ + buf + kk * 16 * LD);  // Q's chunk c
      }
    }
    __syncthreads();
  }
  store_rows<T, DC>(dkb, ldkv.ss, acc_k, k0 + r0, c * DC);
  store_rows<T, DC>(dvb, ldkv.ss, acc_v, k0 + r0, c * DC);
}

// ---------------------------------------------------------------- f32
// The same three kernels on the CUDA cores (f32 FMA from f32 tiles,
// attention_tiles.cuh): 256 threads, 16 x 16, a thread holding rows
// ty + 16 i and columns tx + 16 j of every fragment; tiles loaded
// synchronously.

// Scores of q rows q0.. against kv rows k0.. over the whole of D, slice by
// slice through sA and sB (slices from chunk c + 1 around to c: on return sA
// and sB hold chunk c). A2/B2, when not null, get the same treatment for a
// second product (dO V^T beside Q K^T) into s2.
template <typename T>
__device__ __forceinline__ void wide_dot_slices(float (&s)[WideTile::RM][WideTile::RM],
                                                float (&s2)[WideTile::RM][WideTile::RM],
                                                float* sA, float* sB, float* sA2, float* sB2,
                                                const T* A, long long as, const T* B, long long bs,
                                                const T* A2, long long as2, const T* B2,
                                                long long bs2, int nd, int c) {
  constexpr int DC = kWideChunk;
#pragma unroll
  for (int i = 0; i < WideTile::RM; ++i)
#pragma unroll
    for (int j = 0; j < WideTile::RM; ++j) {
      s[i][j] = 0.f;
      s2[i][j] = 0.f;
    }
  for (int i = 0; i < nd; ++i) {
    const int ds = (c + 1 + i) % nd;
    __syncthreads();
    load_tile<T, DC>(sA, A + ds * DC, as);
    load_tile<T, DC>(sB, B + ds * DC, bs);
    if (A2 != nullptr) {
      load_tile<T, DC>(sA2, A2 + ds * DC, as2);
      load_tile<T, DC>(sB2, B2 + ds * DC, bs2);
    }
    __syncthreads();
    dot_rows_add<DC>(s, sA, sB);
    if (A2 != nullptr) dot_rows_add<DC>(s2, sA2, sB2);
  }
}

// The forward on the CUDA cores (f32): one block per (q tile, chunk, head,
// batch), heaviest causal q tiles first; ONLINE as mma_wide_fwd_kernel.
template <typename T, bool ONLINE>
__global__ void __launch_bounds__(kThreads)
    wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, float* __restrict__ lse, Layout lq, Layout lkv, Layout lo,
                    int Sq, int Skv, int D, float scale, int causal) {
  using C = WideTile;
  constexpr int DC = kWideChunk;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + C::BM * C::LD;
  float* sV = sK + C::BM * C::LD;
  float* sP = sV + C::BM * C::LD;
  const int nd = D / DC, c = blockIdx.x % nd;
  const int q0 = (Sq / C::BM - 1 - static_cast<int>(blockIdx.x) / nd) * C::BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* qb = q + b * lq.sb + h * lq.sh + static_cast<long long>(q0) * lq.ss;
  const long long kvbase = b * lkv.sb + h * lkv.sh;
  const int kend = wide_kend(q0, Skv, causal);

  float m[C::RM], l[C::RM], acc[C::RM][C::RD], s[C::RM][C::RM], unused[C::RM][C::RM];
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::RD; ++j) acc[i][j] = 0.f;
  }
  for (int pass = ONLINE ? 1 : 0; pass < 2; ++pass) {
    for (int kt = 0; kt < kend; ++kt) {
      const long long off = kvbase + static_cast<long long>(kt) * C::BM * lkv.ss;
      wide_dot_slices<T>(s, unused, sQ, sK, nullptr, nullptr, qb, lq.ss, k + off, lkv.ss,
                         nullptr, 0, nullptr, 0, nd, c);
      scale_mask_rows<DC>(s, scale, causal, q0, kt * C::BM);
      if (pass == 0) {  // the two-pass forward's statistics
        tile_stats_step<DC>(s, m, l);
      } else if (ONLINE) {
        tile_online_step<T, DC>(s, m, l, acc, sP);
      } else {
#pragma unroll
        for (int i = 0; i < C::RM; ++i)
#pragma unroll
          for (int j = 0; j < C::RM; ++j)
            sP[(ty + 16 * i) * C::LS + tx + 16 * j] = to_f32(from_f32<T>(expf(s[i][j] - m[i]) / l[i]));
      }
      if (pass == 1) {
        __syncthreads();
        load_tile<T, DC>(sV, v + off + c * DC, lkv.ss);
        __syncthreads();
        tile_matmul<DC, false>(acc, sP, sV);
      }
    }
  }
  T* ob = o + b * lo.sb + h * lo.sh + c * DC;
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j)
      ob[(q0 + ty + 16 * i) * lo.ss + tx + 16 * j] = from_f32<T>(ONLINE ? acc[i][j] / l[i] : acc[i][j]);
  if (lse != nullptr && c == 0 && tx == 0) {
    const long long row = (static_cast<long long>(b) * gridDim.y + h) * Sq + q0;
#pragma unroll
    for (int i = 0; i < C::RM; ++i) lse[row + ty + 16 * i] = m[i] + logf(l[i]);
  }
}

// Backward launch A on the CUDA cores (f32), as mma_wide_dq_kernel.
template <typename T, bool LSE>
__global__ void __launch_bounds__(kThreads) wide_dq_kernel(BwdArgs a, T* __restrict__ dq,
                                                           Layout ldq) {
  using C = WideTile;
  constexpr int DC = kWideChunk;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + C::BM * C::LD;
  float* sK = sDO + C::BM * C::LD;
  float* sV = sK + C::BM * C::LD;
  float* sDS = sV + C::BM * C::LD;
  const int nd = a.D / DC, c = blockIdx.x % nd;
  const int q0 = (a.Sq / C::BM - 1 - static_cast<int>(blockIdx.x) / nd) * C::BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long row = (static_cast<long long>(b) * a.H + h) * a.Sq + q0;
  const T* qb = static_cast<const T*>(a.q) + b * a.lq.sb + h * a.lq.sh +
                static_cast<long long>(q0) * a.lq.ss;
  const T* g = static_cast<const T*>(a.dout) + b * a.lg.sb + h * a.lg.sh +
               static_cast<long long>(q0) * a.lg.ss;
  const long long kvbase = b * a.lkv.sb + h * a.lkv.sh;
  const int kend = wide_kend(q0, a.Skv, a.causal);

  float lse[C::RM], delta[C::RM], s[C::RM][C::RM], dp[C::RM][C::RM];
  if constexpr (LSE) {
    row_delta<T, DC>(delta, static_cast<const T*>(a.o) + b * a.lo.sb + h * a.lo.sh +
                                static_cast<long long>(q0) * a.lo.ss,
                     a.lo.ss, g, a.lg.ss, a.D);
#pragma unroll
    for (int i = 0; i < C::RM; ++i) lse[i] = a.lse[row + ty + 16 * i];
  } else {
    // m, l and dd = sum dP exp(s - m), rescaled with the running max
    float m[C::RM], l[C::RM], dd[C::RM];
#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
      dd[i] = 0.f;
    }
    for (int kt = 0; kt < kend; ++kt) {
      const long long off = kvbase + static_cast<long long>(kt) * C::BM * a.lkv.ss;
      wide_dot_slices<T>(s, dp, sQ, sK, sDO, sV, qb, a.lq.ss, static_cast<const T*>(a.k) + off,
                         a.lkv.ss, g, a.lg.ss, static_cast<const T*>(a.v) + off, a.lkv.ss, nd, c);
      scale_mask_rows<DC>(s, a.scale, a.causal, q0, kt * C::BM);
#pragma unroll
      for (int i = 0; i < C::RM; ++i) {
        float tmax = s[i][0];
#pragma unroll
        for (int j = 1; j < C::RM; ++j) tmax = fmaxf(tmax, s[i][j]);
        const float mn = fmaxf(m[i], row_max16(tmax));
        float se = 0.f, sd = 0.f;
#pragma unroll
        for (int j = 0; j < C::RM; ++j) {
          const float p = expf(s[i][j] - mn);
          se += p;
          sd += p * dp[i][j];
        }
        const float cf = expf(m[i] - mn);
        l[i] = l[i] * cf + row_sum16(se);
        dd[i] = dd[i] * cf + row_sum16(sd);
        m[i] = mn;
      }
    }
#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      lse[i] = m[i] + logf(l[i]);
      delta[i] = dd[i] / l[i];
    }
  }

  float acc[C::RM][C::RD];
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < kend; ++kt) {
    const long long off = kvbase + static_cast<long long>(kt) * C::BM * a.lkv.ss;
    wide_dot_slices<T>(s, dp, sQ, sK, sDO, sV, qb, a.lq.ss, static_cast<const T*>(a.k) + off,
                       a.lkv.ss, g, a.lg.ss, static_cast<const T*>(a.v) + off, a.lkv.ss, nd, c);
    scale_mask_rows<DC>(s, a.scale, a.causal, q0, kt * C::BM);
#pragma unroll
    for (int i = 0; i < C::RM; ++i)
#pragma unroll
      for (int j = 0; j < C::RM; ++j)
        sDS[(ty + 16 * i) * C::LS + tx + 16 * j] =
            expf(s[i][j] - lse[i]) * (dp[i][j] - delta[i]) * a.scale;
    __syncthreads();
    tile_matmul<DC, false>(acc, sDS, sK);  // K's chunk c
  }
  T* dqb = dq + b * ldq.sb + h * ldq.sh + c * DC;
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j) dqb[(q0 + ty + 16 * i) * ldq.ss + tx + 16 * j] = from_f32<T>(acc[i][j]);
  if (c == 0 && tx == 0) {
#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      if (!LSE) a.lse[row + ty + 16 * i] = lse[i];
      a.delta[row + ty + 16 * i] = delta[i];
    }
  }
}

// Backward launch B on the CUDA cores (f32), as mma_wide_dkv_kernel; s and dp
// are formed in (q row, kv row) orientation and read transposed.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wide_dkv_kernel(BwdArgs a, T* __restrict__ dk, T* __restrict__ dv, Layout ldkv) {
  using C = WideTile;
  constexpr int DC = kWideChunk;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + C::BM * C::LD;
  float* sQ = sV + C::BM * C::LD;
  float* sDO = sQ + C::BM * C::LD;
  float* sP = sDO + C::BM * C::LD;
  float* sDS = sP + C::BM * C::LS;
  const int nd = a.D / DC, c = blockIdx.x % nd;
  const int kt = static_cast<int>(blockIdx.x) / nd, k0 = kt * C::BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* kb = static_cast<const T*>(a.k) + b * a.lkv.sb + h * a.lkv.sh +
                static_cast<long long>(k0) * a.lkv.ss;
  const T* vb = static_cast<const T*>(a.v) + b * a.lkv.sb + h * a.lkv.sh +
                static_cast<long long>(k0) * a.lkv.ss;
  const long long qbase = b * a.lq.sb + h * a.lq.sh, gbase = b * a.lg.sb + h * a.lg.sh;
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;

  float acc_k[C::RM][C::RD], acc_v[C::RM][C::RD], s[C::RM][C::RM], dp[C::RM][C::RM];
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j) {
      acc_k[i][j] = 0.f;
      acc_v[i][j] = 0.f;
    }
  // causal, Sq < Skv: a kv tile at or past Sq has no q tile at or below its
  // diagonal; the loop is empty and the zeros below are its dk and dv
  for (int qt = a.causal ? kt : 0; qt < a.Sq / C::BM; ++qt) {
    const int q0 = qt * C::BM;
    wide_dot_slices<T>(s, dp, sQ, sK, sDO, sV,
                       static_cast<const T*>(a.q) + qbase + static_cast<long long>(q0) * a.lq.ss,
                       a.lq.ss, kb, a.lkv.ss,
                       static_cast<const T*>(a.dout) + gbase + static_cast<long long>(q0) * a.lg.ss,
                       a.lg.ss, vb, a.lkv.ss, nd, c);
    scale_mask_rows<DC>(s, a.scale, a.causal, q0, k0);
#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      const float lse = a.lse[row0 + q0 + ty + 16 * i], delta = a.delta[row0 + q0 + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < C::RM; ++j) {
        const float p = expf(s[i][j] - lse);
        sP[(ty + 16 * i) * C::LS + tx + 16 * j] = p;
        sDS[(ty + 16 * i) * C::LS + tx + 16 * j] = p * (dp[i][j] - delta) * a.scale;
      }
    }
    __syncthreads();
    tile_matmul<DC, true>(acc_v, sP, sDO);  // dO's chunk c
    tile_matmul<DC, true>(acc_k, sDS, sQ);  // Q's chunk c
  }
  T* dkb = dk + b * ldkv.sb + h * ldkv.sh + c * DC;
  T* dvb = dv + b * ldkv.sb + h * ldkv.sh + c * DC;
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j) {
      const long long off = (k0 + ty + 16 * i) * ldkv.ss + tx + 16 * j;
      dkb[off] = from_f32<T>(acc_k[i][j]);
      dvb[off] = from_f32<T>(acc_v[i][j]);
    }
}

// ------------------------------------------------------------ launchers
// Sq and Skv multiples of 64, D a multiple of kWideChunk; causal Sq != Skv
// is refused by the callers unless they admit it (the library tier).

template <typename T, bool ONLINE>
cudaError_t launch_wide_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                            Layout lq, Layout lkv, Layout lo, int B, int H, int Sq, int Skv, int D,
                            float scale, int causal, cudaStream_t st) {
  if (D % kWideChunk != 0 || Sq % kWideChunk != 0 || Skv % kWideChunk != 0)
    return cudaErrorInvalidValue;
  const dim3 grid(Sq / kWideChunk * (D / kWideChunk), H, B);
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = 4 * WideTile::BM * WideTile::LD * sizeof(float);
    cudaError_t e = allow_smem(wide_fwd_kernel<T, ONLINE>, smem);
    if (e != cudaSuccess) return e;
    wide_fwd_kernel<T, ONLINE><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, lq, lkv, lo, Sq, Skv, D, scale, causal);
  } else {
    constexpr size_t smem = 6 * kWideTile * sizeof(T);
    cudaError_t e = allow_smem(mma_wide_fwd_kernel<T, ONLINE>, smem);
    if (e != cudaSuccess) return e;
    mma_wide_fwd_kernel<T, ONLINE><<<grid, kMmaThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, lq, lkv, lo, Sq, Skv, D, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T, bool LSE>
cudaError_t launch_wide_dq(const BwdArgs& a, void* dq, Layout ldq, cudaStream_t st) {
  if (a.D % kWideChunk != 0 || a.Sq % kWideChunk != 0 || a.Skv % kWideChunk != 0)
    return cudaErrorInvalidValue;
  const dim3 grid(a.Sq / kWideChunk * (a.D / kWideChunk), a.H, a.B);
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = 5 * WideTile::BM * WideTile::LD * sizeof(float);
    cudaError_t e = allow_smem(wide_dq_kernel<T, LSE>, smem);
    if (e != cudaSuccess) return e;
    wide_dq_kernel<T, LSE><<<grid, kThreads, smem, st>>>(a, static_cast<T*>(dq), ldq);
  } else {
    constexpr size_t smem = 8 * kWideTile * sizeof(T);
    cudaError_t e = allow_smem(mma_wide_dq_kernel<T, LSE>, smem);
    if (e != cudaSuccess) return e;
    mma_wide_dq_kernel<T, LSE><<<grid, kMmaThreads, smem, st>>>(a, static_cast<T*>(dq), ldq);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide_dkv(const BwdArgs& a, void* dk, void* dv, Layout ldkv, cudaStream_t st) {
  if (a.D % kWideChunk != 0 || a.Sq % kWideChunk != 0 || a.Skv % kWideChunk != 0)
    return cudaErrorInvalidValue;
  const dim3 grid(a.Skv / kWideChunk * (a.D / kWideChunk), a.H, a.B);
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = 6 * WideTile::BM * WideTile::LD * sizeof(float);
    cudaError_t e = allow_smem(wide_dkv_kernel<T>, smem);
    if (e != cudaSuccess) return e;
    wide_dkv_kernel<T><<<grid, kThreads, smem, st>>>(a, static_cast<T*>(dk), static_cast<T*>(dv),
                                                     ldkv);
  } else {
    constexpr size_t smem = 8 * kWideTile * sizeof(T) + 2 * 2 * WideCfg::BQ * sizeof(float);
    cudaError_t e = allow_smem(mma_wide_dkv_kernel<T>, smem);
    if (e != cudaSuccess) return e;
    mma_wide_dkv_kernel<T><<<grid, kMmaThreads, smem, st>>>(a, static_cast<T*>(dk),
                                                            static_cast<T*>(dv), ldkv);
  }
  return cudaGetLastError();
}

}  // namespace
