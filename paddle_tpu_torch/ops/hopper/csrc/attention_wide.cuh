// The attention kernels for head dims without tiles of their own: every
// multiple of 64 but 64, 128 and 256 (192, 320, 384, 448, 512, 576, ...).
// They serve the two-pass and the online forward, the recompute backward's
// dq launch and the lse backward's dq and dk/dv launches, for
// simple_attention.cu (which qblock_attention launches too),
// causal_attention.cu and blocked_flash.cu (its bf_* and lf_* entry points
// alike), behind the same entry points. The launchers at the end choose the
// kernel by D and dtype before any launch (never a path taken on error):
//
//   bf16/f16, 192 <= D <= 512   forward, dq    wgmma_wide_fwd_kernel, wgmma_wide_dq_kernel
//   bf16/f16, D > 512           forward, dq    mma_wide_fwd_kernel, mma_wide_dq_kernel
//   bf16/f16, every wide D      dk/dv          mma_wide_dkv_kernel
//   f32, every wide D           all three      wide_fwd_kernel, wide_dq_kernel, wide_dkv_kernel
//
// Replaces (at wide D; paddle_tpu/ops/pallas/):
//   wgmma_wide_fwd_kernel<T, D, false>, the two-pass forward:
//     simple_attention.py:113 (fwd) and simple_attention2.py:131 (fwd,
//     qblock launches simple's kernels); causal_attention.py:164 (fwd, with lse)
//   wgmma_wide_fwd_kernel<T, D, true>, the online forward:
//     blocked_flash.py:210 (fwd); flash_attention.py:53 (fwd, JAX's library
//     kernel at jax/experimental/pallas/ops/tpu/flash_attention.py:758)
//   wgmma_wide_dq_kernel<T, D, false>, the recompute backward's dq launch:
//     simple_attention.py:130 and simple_attention2.py:151 (bwd)
//   wgmma_wide_dq_kernel<T, D, true>, the lse backward's dq launch:
//     causal_attention.py:184, blocked_flash.py:326, JAX's :1456
//   mma_wide_dkv_kernel: every family's dk/dv (blocked_flash.py:362, JAX's :1121, ...)
//
// What bounds them on this card (chip_smoke.bound_at: the function's own
// products, 2 D operations a causal pair each, against each input read and
// each output written once): operations at S = 2048 (the forward's 2
// products against q, k, v and o; dq's 3 against five tensors and two row
// statistics), and at S = 1024 the forward's bytes by a little (10.0 us
// against 8.7 us of products at B1 H8 D512) and dq's operations. What these
// kernels do beyond that: the two-pass forward 3 products a pair (Q K^T
// twice), the recompute dq 5, and every kv tile read again by each 64-row
// q tile that sees it.
//
// The Hopper design of the forward and dq (bf16, f16, 192 <= D <= 512):
//   - One block per (head, batch, 64-row q tile), heaviest causal q tiles
//     first across the whole grid (blockIdx.z walks the tiles from the
//     diagonal's end). Three warpgroups: two consumers and one producer.
//   - TMA for every tile: each operand is a 4-D tensor map over the
//     [B, H, S, D] view as the model hands it (a view into one
//     [B, S, 3 H D] activation; its strides are 16-byte multiples), in boxes
//     of 64 columns (128 bytes) at the 128-byte swizzle, each 1024-byte
//     aligned in shared memory. The maps are encoded on the host at every
//     launch, through cuTensorMapEncodeTiled from the runtime's driver entry
//     point query (the libraries link torch's libcudart only).
//   - One thread of the producer warpgroup loads the resident q tile (and dO
//     for dq) once, then keeps a ring of kv slots full: the K and V tiles
//     each visit needs, in the consumers' order, signalled on a full and an
//     empty mbarrier a slot. setmaxnreg gives the producer 24 registers a
//     thread and each consumer 240.
//   - Every product is wgmma: the scores (Q K^T; dO V^T) as m64n32k16 with
//     both operands K-major in shared memory over the whole of D, one chain
//     of D / 16 steps, so a score sums its D products in one order; P V and
//     dS K as m64n32k16 with P or dS in registers (rounded to the input
//     dtype: the rounding points of attention_mma.cuh) and V or K read
//     MN-major from the slot, in groups of 32 columns.
//   - The consumers split the output's columns: warpgroup g owns columns
//     [g D / 2, (g + 1) D / 2), a 64 x D / 2 f32 accumulator of D / 4
//     registers a thread (128 at D = 512).
//   - Each score product of a (q tile, kv tile) visit is computed ONCE
//     (against 2 D / 64 times in the chunk design): in the forward the two
//     warpgroups score the kv tile's two 32-row halves, in dq warpgroup 0
//     scores S = Q K^T and warpgroup 1 dP = dO V^T; each writes its 64 x 32
//     f32 tile to shared memory (8 KB, thread-major, double-buffered by
//     visit), one named barrier, and both read the whole of S (and dP) back.
//     Exchanging whole f32 scores rather than splitting D and summing
//     partials keeps the sum order and moves half the bytes; both
//     warpgroups then run the same softmax steps on the same values and
//     hold the same m and l. Products a 64 x 64 tile pair: 3 (two-pass
//     forward), 2 (online), 3 (lse dq), 5 (recompute dq).
//   - Shared memory (bf16 or f16, the 232,448 bytes a block may have): the
//     forward's q tile (64 D x 2 bytes) and kv slots of 64 rows (128 D bytes:
//     4 slots at D = 192, 3 at 320 and 384, 2 at 448 and 512, where q 64 KB
//     + 2 x 64 KB + the exchange's 32 KB = 224 KB); dq's q and dO (128 KB at
//     D = 512) and kv slots of 32 rows (4 slots at D <= 384, 2 at 448 and
//     512: 128 + 2 x 32 + 32 = 224 KB). Two slots are the least that lets
//     one tile load while the other is multiplied.
//   - Filling the card: one block an SM (shared memory and 384 x 168
//     registers). At B1 H8 S1024 the grid is 128 blocks on 132 SMs, one
//     wave whose time is the diagonal's last q tile's; more rows a block
//     would need a second accumulator (D = 512: 256 KB of registers), and
//     a persistent schedule cannot shorten a single wave, so neither is
//     done. At the 23b paths' B2 S2048 (512 blocks) the heaviest-first
//     order balances the waves.
//
// The chunk design (D > 512 forward and dq; dk/dv at every wide D): the grid
// gets a column-chunk axis. A block owns one 64-row tile (q rows; kv rows for
// dk/dv) and one chunk of 64 columns of what it accumulates (o, dq, or dk
// and dv), and computes every score product (Q K^T, dO V^T, or K Q^T and
// V dO^T for dk/dv) over the whole of D by streaming D in 64-column slices
// of both operands through shared memory, adding each slice's product into
// the score fragments. The block's own chunk is the last slice of each visit
// (slices run from chunk c + 1 around to c), so the K (dq) or the Q and dO
// (dk/dv) columns that the accumulating product needs are the ones in shared
// memory when the scores are complete. Every tile is 64 x 64 at the pitch,
// registers and shared memory of the D = 64 tiles, whatever D. The row
// statistics lse and delta are written by chunk 0 only; every chunk computes
// the same ones. bf16 and f16 run on mma.sync (ldmatrix, cp.async with the
// stage of slice t + 1 in flight while slice t is multiplied; 4 warps, 16
// rows each); f32 on the CUDA cores (attention_tiles.cuh's 16 x 16 threads
// and f32 tiles, loaded synchronously).
//
// The function and its rounding points are those of the kernels for the
// dims with tiles of their own (attention_mma.cuh's header): only the f32
// order in which a score sums its D products differs (slice by slice in the
// chunk design, wgmma's order in the Hopper one).
//
// What it costs: the chunk design recomputes every score product D / 64
// times what the function needs of them: at D = 640 the two-pass forward
// does 10 x (2 Q K^T) + P V where the function needs 2 Q K^T + P V, and the
// dk/dv launch (every wide D) does 2 D / 64 score products a tile pair
// where the function needs 2. Redesigning dk/dv as the forward and dq were
// is ROADMAP queue 2's next item.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda is linked)

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

// ------------------------------------------------------------ wgmma
// The forward and dq kernels for bf16 and f16 at 192 <= D <= 512 (the design
// in the header above): TMA tiles, mbarrier rings, one producer warp and two
// consumer warpgroups of wgmma.

constexpr int kWgThreads = 128;                // one warpgroup
constexpr int kWgmmaThreads = 3 * kWgThreads;  // two consumer warpgroups, then the producer's
constexpr int kWgBox = 64;                     // columns of a TMA box: 128 bytes, one swizzle row
constexpr int kSmemLimit = 232448;             // dynamic shared memory a block may have
constexpr int kWgFwdBN = 64, kWgDqBN = 32;    // kv rows of a slot: forward, dq

// The head dims that run the wgmma kernels (bf16 and f16).
__host__ __device__ constexpr bool wgmma_wide(int D) {
  return D >= 192 && D <= 512 && D % kWgBox == 0 && D != 256;
}

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Shared memory, from a 1024-byte aligned base: the resident 64-row tiles (Q;
// Q and dO for dq), NS slots of one BN x D kv tile each, the score exchange
// X (2 parities x 2 halves of a 64 x 32 f32 tile), the mbarriers. Every
// tile is D / 64 TMA boxes of [rows][64] at the 128-byte swizzle.
template <int D>
struct WgCfg {
  static constexpr int NB = D / kWgBox;   // boxes across D
  static constexpr int W = D / 2;         // columns of o or dq a consumer warpgroup owns
  static constexpr int TILE = 64 * D * 2;  // bytes of a resident 64-row tile
  static constexpr int X = 2 * 2 * 64 * 32 * 4;
  static constexpr int BARS = 128;
  static constexpr int FREE = kSmemLimit - 1024 - X - BARS;
  static constexpr int FWD_SLOT = kWgFwdBN * D * 2, DQ_SLOT = kWgDqBN * D * 2;
  static constexpr int FWD_NS = cmin(4, (FREE - TILE) / FWD_SLOT);
  static constexpr int DQ_NS = cmin(4, (FREE - 2 * TILE) / DQ_SLOT);
  static constexpr size_t FWD_SMEM = 1024 + TILE + FWD_NS * FWD_SLOT + X + BARS;
  static constexpr size_t DQ_SMEM = 1024 + 2 * TILE + DQ_NS * DQ_SLOT + X + BARS;
  static_assert(W % 32 == 0 && FWD_NS >= 2 && DQ_NS >= 2, "a wgmma head dim");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the completion of the barrier's phase of this parity (try_wait
// suspends the thread for a while before it returns false). No watchdog: a
// clock and a trap path in the waits cost D = 512's consumers 232-308 bytes
// of spills.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  while (!mbar_try(a, parity)) {
  }
}

// One TMA box of a [B, H, S, D] map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// The two consumer warpgroups' named barrier.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kWgThreads) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across a
// wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_frags(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(c[j][e])::"memory");
}

// A shared-memory matrix descriptor at the 128-byte swizzle: the start
// address, the leading byte offset lbo (MN-major: from one 64-column box to
// the next; K-major: unused) and 1024 bytes from one 8-row group to the
// next. The start may sit 32 or 64 bytes into a swizzle row (the k steps of
// a K-major tile, a 32-column group of an MN-major one): the swizzle is a
// function of the address, and every box starts 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 | static_cast<uint64_t>(1024 >> 4) << 32 |
         1ull << 62;
}

// The sixteen f32 registers of a warpgroup's m64n32 accumulator: element e of
// n8 fragment j of the warp's 16 rows, mma.sync's C layout (attention_mma.cuh).
#define WG_D16                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_OUT16(c, j)                                                                           \
  "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3]), "+f"(c[j + 1][0]),                 \
      "+f"(c[j + 1][1]), "+f"(c[j + 1][2]), "+f"(c[j + 1][3]), "+f"(c[j + 2][0]),                \
      "+f"(c[j + 2][1]), "+f"(c[j + 2][2]), "+f"(c[j + 2][3]), "+f"(c[j + 3][0]),                \
      "+f"(c[j + 3][1]), "+f"(c[j + 3][2]), "+f"(c[j + 3][3])

// c (+)= A B over one k16 step, A and B in shared memory, both K-major
// (B^T's rows are B's columns): scores Q K^T and dO V^T.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&c)[4][4], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16 ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : WG_OUT16(c, 0)
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " WG_D16 ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : WG_OUT16(c, 0)
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// c[j .. j + 3] += A B over one k16 step: 32 columns of the accumulator c
// from fragment j (a constant once the caller's loop is unrolled), A in
// registers (mma.sync's A layout for each warp's 16 rows), B in shared
// memory read MN-major (trans-b): P V and dS K.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&c)[N][4], int j, const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_OUT16(c, j)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " WG_D16
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_OUT16(c, j)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// c = A B^T over the whole of D for one warpgroup: A the 64 rows at a, B the
// 32 rows at b, each a row of D / 64 boxes a_box and b_box bytes apart,
// K-major. One chain of D / 16 wgmmas: a score's f32 sum runs over D in one
// order, as on the tensor-core tiles of the other dims.
template <typename T, int D>
__device__ __forceinline__ void wg_score(float (&c)[4][4], const unsigned char* a, int a_box,
                                         const unsigned char* b, int b_box) {
  const uint64_t da = sw128_desc(a, 16), db = sw128_desc(b, 16);
  zero_frags<4>(c);
  fence_frags<4>(c);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<T>(c, da + (((kk >> 2) * a_box + (kk & 3) * 32) >> 4),
                db + (((kk >> 2) * b_box + (kk & 3) * 32) >> 4), kk > 0);
  wg_commit();
  wg_wait_all();
  fence_frags<4>(c);
}

// acc += P B for one warpgroup's W columns from col0: P the 64 x 16 KS score
// tile in registers, rounded to T as the A operand; B the 16 KS rows of a
// slot of boxes box_bytes apart, W / 32 groups of 32 columns (a group sits
// in one box: 32 divides 64).
template <typename T, int W, int KS>
__device__ __forceinline__ void wg_acc(float (&acc)[W / 8][4], const float (&p)[2 * KS][4],
                                       const unsigned char* slot, int box_bytes, int col0) {
  uint32_t af[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) a_frag<T>(af[kk], p, kk);
  fence_frags<W / 8>(acc);
  wg_fence();
#pragma unroll
  for (int c = 0; c < W / 32; ++c) {
    const int col = col0 + 32 * c;
    const uint64_t db = sw128_desc(slot + (col / kWgBox) * box_bytes + (col % kWgBox) * 2, box_bytes);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<T>(acc, 4 * c, af[kk], db + ((kk * 16 * 128) >> 4));
  }
  wg_commit();
  wg_wait_all();
  fence_frags<W / 8>(acc);
}

// The score exchange: a warpgroup's 64 x 32 tile, thread-major, 16 bytes a
// thread a fragment (no bank conflicts); both warpgroups hold each tile
// element at the same thread index, so a tile read back lands in the
// reader's own fragment layout.
__device__ __forceinline__ void x_put(float4* x, const float (&c)[4][4]) {
  const int t = threadIdx.x % kWgThreads;
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j * kWgThreads + t] = make_float4(c[j][0], c[j][1], c[j][2], c[j][3]);
}

template <int N>
__device__ __forceinline__ void x_get(float (&s)[N][4], const float4* x) {
  const int t = threadIdx.x % kWgThreads;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float4 v = x[j * kWgThreads + t];
    s[j][0] = v.x;
    s[j][1] = v.y;
    s[j][2] = v.z;
    s[j][3] = v.w;
  }
}

// This thread's warpgroup, warp-uniform as the compiler sees it: a branch on
// it splits the block's roles, and setmaxnreg gives each role's region its
// own register count only where the compiler can tell the roles apart.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / kWgThreads, 0);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// The forward, one block per (head, batch, q tile), heaviest causal q tiles
// first. ONLINE: blocked_flash's online softmax; otherwise the two-pass
// forward (a statistics pass over the kv tiles for m and l, then
// p = exp(s - m) / l). The producer streams K (and, after the statistics
// pass, K and V by turns) through the slot ring; lse (when not null) is
// m + log l, [B, H, Sq] f32 contiguous.
template <typename T, int D, bool ONLINE>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    wgmma_wide_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                          float* __restrict__ lse, Layout lo, int Sq, int Skv, float scale,
                          int causal) {
  using C = WgCfg<D>;
  constexpr int BN = kWgFwdBN, NS = C::FWD_NS, SLOT = C::FWD_SLOT;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sQ = align1024(wg_smem);
  unsigned char* slots = sQ + C::TILE;
  float4* X = reinterpret_cast<float4*>(slots + NS * SLOT);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(X) + C::X);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (Sq / 64 - 1 - static_cast<int>(blockIdx.z)) * 64;
  const int kend = wide_kend(q0, Skv, causal);
  const int pass = ONLINE ? 0 : kend;  // visits of the statistics pass
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2 * kWgThreads / 32);  // every consumer warp releases
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 2 * kWgThreads) {
      mbar_expect_tx(qbar, C::TILE);
      for (int j = 0; j < C::NB; ++j) tma_load(sQ + j * 64 * 128, &tq, qbar, j * kWgBox, q0, h, b);
      for (int item = 0; item < pass + 2 * kend; ++item) {
        const int slot = item % NS;
        mbar_wait(&empty[slot], ((item / NS) & 1) ^ 1);
        const bool isv = item >= pass && ((item - pass) & 1);
        const int kt = item < pass ? item : (item - pass) / 2;
        unsigned char* dst = slots + slot * SLOT;
        mbar_expect_tx(&full[slot], SLOT);
        for (int j = 0; j < C::NB; ++j)
          tma_load(dst + j * BN * 128, isv ? &tv : &tk, &full[slot], j * kWgBox, kt * BN, h, b);
      }
    }
  } else {  // the consumers: warpgroup wg owns columns [wg W, wg W + W) of o
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int lane = threadIdx.x % 32, r0 = (threadIdx.x % kWgThreads) / 32 * 16;
    float acc[C::W / 8][4];
    zero_frags<C::W / 8>(acc);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2] = {0.f, 0.f};
    mbar_wait(qbar, 0);
    int item = 0;
    for (int visit = 0; visit < pass + kend; ++visit) {
      const int k0 = (visit < pass ? visit : visit - pass) * BN;
      // Q K^T, once: warpgroup wg scores the kv rows [32 wg, 32 wg + 32) of
      // the tile over the whole of D, and the two swap their halves.
      const int ks = item % NS;
      mbar_wait(&full[ks], (item / NS) & 1);
      float hs[4][4];
      wg_score<T, D>(hs, sQ, 64 * 128, slots + ks * SLOT + wg * 32 * 128, BN * 128);
      if (lane == 0) mbar_arrive(&empty[ks]);
      ++item;
      float4* x = X + (visit & 1) * 2 * 4 * kWgThreads;
      x_put(x + wg * 4 * kWgThreads, hs);
      consumers_sync();
      float s[BN / 8][4];
      x_get<BN / 8>(s, x);
      scale_mask<BN / 8, false>(s, scale, causal && k0 + BN - 1 > q0 + r0, q0 + r0, k0);
      if (visit < pass) {
        stats_step<BN / 8>(s, m, l);
        if (visit == pass - 1) {
          rl[0] = 1.f / l[0];
          rl[1] = 1.f / l[1];
        }
        continue;
      }
      if constexpr (ONLINE) {
        online_step<BN / 8, C::W / 8>(s, acc, m, l);  // s holds the unnormalized p from here
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = __expf(s[j][e] - m[e >> 1]) * rl[e >> 1];
      }
      const int vs = item % NS;
      mbar_wait(&full[vs], (item / NS) & 1);
      wg_acc<T, C::W, BN / 16>(acc, s, slots + vs * SLOT, BN * 128, wg * C::W);
      if (lane == 0) mbar_arrive(&empty[vs]);
      ++item;
    }
    if constexpr (ONLINE) {
      const float rl_end[2] = {1.f / l[0], 1.f / l[1]};  // a reciprocal, not W / 2 divisions
#pragma unroll
      for (int j = 0; j < C::W / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= rl_end[e >> 1];
    }
    store_rows<T, C::W>(o + b * lo.sb + h * lo.sh, lo.ss, acc, q0 + r0, wg * C::W);
    if (lse != nullptr && wg == 0 && (lane & 3) == 0) {
      const long long row = (static_cast<long long>(b) * gridDim.x + h) * Sq + q0 + r0 + (lane >> 2);
      lse[row] = m[0] + logf(l[0]);
      lse[row + 8] = m[1] + logf(l[1]);
    }
  }
}

// Backward launch A, one block per (head, batch, q tile), heaviest causal q
// tiles first: dS = P (dP - delta) scale with P = exp(s - lse), and
// dq = dS K over kv tiles of 32 rows. Warpgroup 0 scores S = Q K^T and
// warpgroup 1 dP = dO V^T, each over the whole of D, and the two swap them;
// each then adds dS K into its half of dq's columns. LSE: lse is the
// forward's and delta = rowsum(dO * O). Otherwise (the recompute backward) a
// first pass finds m, l and delta = rowsum(dP * P) together. Writes dq,
// delta and, recomputing, lse (f32 [B, H, Sq], once a row).
template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    wgmma_wide_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                         BwdArgs a, T* __restrict__ dq, Layout ldq) {
  using C = WgCfg<D>;
  constexpr int BN = kWgDqBN, NS = C::DQ_NS, SLOT = C::DQ_SLOT;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sQ = align1024(wg_smem);
  unsigned char* sDO = sQ + C::TILE;
  unsigned char* slots = sDO + C::TILE;
  float4* X = reinterpret_cast<float4*>(slots + NS * SLOT);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(X) + C::X);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (a.Sq / 64 - 1 - static_cast<int>(blockIdx.z)) * 64;
  const int diag = (q0 + 64) / BN, all = a.Skv / BN;
  const int kend = a.causal && diag < all ? diag : all;
  const int pass = LSE ? 0 : kend;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2 * kWgThreads / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 2 * kWgThreads) {
      mbar_expect_tx(qbar, 2 * C::TILE);
      for (int j = 0; j < C::NB; ++j) {
        tma_load(sQ + j * 64 * 128, &tq, qbar, j * kWgBox, q0, h, b);
        tma_load(sDO + j * 64 * 128, &tg, qbar, j * kWgBox, q0, h, b);
      }
      for (int item = 0; item < 2 * (pass + kend); ++item) {  // K, V of each visit
        const int slot = item % NS, visit = item / 2;
        mbar_wait(&empty[slot], ((item / NS) & 1) ^ 1);
        const int kt = visit < pass ? visit : visit - pass;
        unsigned char* dst = slots + slot * SLOT;
        mbar_expect_tx(&full[slot], SLOT);
        for (int j = 0; j < C::NB; ++j)
          tma_load(dst + j * BN * 128, (item & 1) ? &tv : &tk, &full[slot], j * kWgBox, kt * BN, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int lane = threadIdx.x % 32, r0 = (threadIdx.x % kWgThreads) / 32 * 16;
    const long long row = (static_cast<long long>(b) * a.H + h) * a.Sq + q0 + r0 + (lane >> 2);
    float acc[C::W / 8][4];
    zero_frags<C::W / 8>(acc);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
    float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
    if constexpr (LSE) {
      quad_row_dots<T>(delta, static_cast<const T*>(a.o) + b * a.lo.sb + h * a.lo.sh +
                                  static_cast<long long>(q0 + r0) * a.lo.ss, a.lo.ss,
                       static_cast<const T*>(a.dout) + b * a.lg.sb + h * a.lg.sh +
                           static_cast<long long>(q0 + r0) * a.lg.ss, a.lg.ss, D);
      lse[0] = a.lse[row];
      lse[1] = a.lse[row + 8];
    }
    mbar_wait(qbar, 0);
    int item = 0;
    for (int visit = 0; visit < pass + kend; ++visit, item += 2) {
      const int k0 = (visit < pass ? visit : visit - pass) * BN;
      const int ks = item % NS, vs = (item + 1) % NS;
      mbar_wait(&full[ks], (item / NS) & 1);
      mbar_wait(&full[vs], ((item + 1) / NS) & 1);
      float own[4][4];
      wg_score<T, D>(own, wg ? sDO : sQ, 64 * 128, slots + (wg ? vs : ks) * SLOT, BN * 128);
      if (lane == 0) {
        mbar_arrive(&empty[vs]);                  // V's one product is done
        if (visit < pass) mbar_arrive(&empty[ks]);  // as is K's, in the statistics pass
      }
      float4* x = X + (visit & 1) * 2 * 4 * kWgThreads;
      x_put(x + wg * 4 * kWgThreads, own);
      consumers_sync();
      float s[BN / 8][4], dp[BN / 8][4];
      x_get<BN / 8>(s, x);
      x_get<BN / 8>(dp, x + 4 * kWgThreads);
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
        continue;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          s[j][e] = __expf(s[j][e] - lse[r]) * (dp[j][e] - delta[r]) * a.scale;
        }
      wg_acc<T, C::W, BN / 16>(acc, s, slots + ks * SLOT, BN * 128, wg * C::W);
      if (lane == 0) mbar_arrive(&empty[ks]);
    }
    store_rows<T, C::W>(dq + b * ldq.sb + h * ldq.sh, ldq.ss, acc, q0 + r0, wg * C::W);
    if (wg == 0 && (lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!LSE) a.lse[row + 8 * r] = lse[r];
        a.delta[row + 8 * r] = delta[r];
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime's entry point
// query (the libraries link no libcuda); looked up once a library.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of one [B, H, rows, D] operand (element strides l, d
// unit-stride) as the model hands it, in boxes of box_rows x 64 at the
// 128-byte swizzle.
template <typename T>
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, Layout l, int B, int H, int rows, int D,
                       int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(l.ss) * sizeof(T),
                                 static_cast<cuuint64_t>(l.sh) * sizeof(T),
                                 static_cast<cuuint64_t>(l.sb) * sizeof(T)};
  const cuuint32_t box[4] = {kWgBox, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The forward's tensor maps: q in 64-row boxes, k and v in kWgFwdBN-row ones.
template <typename T>
cudaError_t fwd_tensor_maps(CUtensorMap (&m)[3], const void* q, const void* k, const void* v,
                            Layout lq, Layout lkv, int B, int H, int Sq, int Skv, int D) {
  cudaError_t e = tensor_map<T>(&m[0], q, lq, B, H, Sq, D, 64);
  if (e == cudaSuccess) e = tensor_map<T>(&m[1], k, lkv, B, H, Skv, D, kWgFwdBN);
  if (e == cudaSuccess) e = tensor_map<T>(&m[2], v, lkv, B, H, Skv, D, kWgFwdBN);
  return e;
}

// f(std::integral_constant<int, D>) for the head dims of the wgmma kernels.
template <typename F>
cudaError_t by_wgmma_d(int D, F&& f) {
  switch (D) {
    case 192: return f(std::integral_constant<int, 192>{});
    case 320: return f(std::integral_constant<int, 320>{});
    case 384: return f(std::integral_constant<int, 384>{});
    case 448: return f(std::integral_constant<int, 448>{});
    case 512: return f(std::integral_constant<int, 512>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool ONLINE>
cudaError_t launch_wgmma_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             Layout lq, Layout lkv, Layout lo, int B, int H, int Sq, int Skv, int D,
                             float scale, int causal, cudaStream_t st) {
  CUtensorMap m[3];
  cudaError_t e = fwd_tensor_maps<T>(m, q, k, v, lq, lkv, B, H, Sq, Skv, D);
  if (e != cudaSuccess) return e;
  return by_wgmma_d(D, [&](auto dc) {
    constexpr int DD = decltype(dc)::value;
    constexpr size_t smem = WgCfg<DD>::FWD_SMEM;
    cudaError_t e2 = allow_smem(wgmma_wide_fwd_kernel<T, DD, ONLINE>, smem);
    if (e2 != cudaSuccess) return e2;
    wgmma_wide_fwd_kernel<T, DD, ONLINE><<<dim3(H, B, Sq / 64), kWgmmaThreads, smem, st>>>(
        m[0], m[1], m[2], static_cast<T*>(o), lse, lo, Sq, Skv, scale, causal);
    return cudaGetLastError();
  });
}

template <typename T, bool LSE>
cudaError_t launch_wgmma_dq(const BwdArgs& a, void* dq, Layout ldq, cudaStream_t st) {
  CUtensorMap m[4];
  cudaError_t e = tensor_map<T>(&m[0], a.q, a.lq, a.B, a.H, a.Sq, a.D, 64);
  if (e == cudaSuccess) e = tensor_map<T>(&m[1], a.k, a.lkv, a.B, a.H, a.Skv, a.D, kWgDqBN);
  if (e == cudaSuccess) e = tensor_map<T>(&m[2], a.v, a.lkv, a.B, a.H, a.Skv, a.D, kWgDqBN);
  if (e == cudaSuccess) e = tensor_map<T>(&m[3], a.dout, a.lg, a.B, a.H, a.Sq, a.D, 64);
  if (e != cudaSuccess) return e;
  return by_wgmma_d(a.D, [&](auto dc) {
    constexpr int DD = decltype(dc)::value;
    constexpr size_t smem = WgCfg<DD>::DQ_SMEM;
    cudaError_t e2 = allow_smem(wgmma_wide_dq_kernel<T, DD, LSE>, smem);
    if (e2 != cudaSuccess) return e2;
    wgmma_wide_dq_kernel<T, DD, LSE><<<dim3(a.H, a.B, a.Sq / 64), kWgmmaThreads, smem, st>>>(
        m[0], m[1], m[2], m[3], a, static_cast<T*>(dq), ldq);
    return cudaGetLastError();
  });
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
  } else if (wgmma_wide(D)) {
    return launch_wgmma_fwd<T, ONLINE>(q, k, v, o, lse, lq, lkv, lo, B, H, Sq, Skv, D, scale, causal,
                                       st);
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
  } else if (wgmma_wide(a.D)) {
    return launch_wgmma_dq<T, LSE>(a, dq, ldq, st);
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
