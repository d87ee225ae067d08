// q x kv blocked flash attention for the S>=4096 rung, forward, dq and dk/dv,
// written for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/blocked_flash.py, the Pallas kernels
// `_fwd_kernel` (pl.pallas_call in `_fwd`), `_bwd_dq_kernel` (in `_bwd_dq`)
// and `_bwd_dkv_kernel` (in `_bwd_dkv`). Same function: an online softmax
// over kv blocks with (m, l, acc) in f32, the unnormalized p = exp(s - m_new)
// rounded to the input dtype before PV and the division by l at the end,
// lse = m + log l saved beside o; causal (top-left, Sq == Skv) or not, with
// Sq != Skv allowed when not. The backward is the lse pair of
// lse_backward.cuh, one launch each for dq and for dk/dv, as the reference;
// the dq launch also writes delta = rowsum(dO * O) (f32 [B, H, Sq]), once per
// row, for the dk/dv launch to read.
//
// What bounds it on this card: operations. At the rung's shape (B2 H8 S4096
// D128, bf16, causal) the forward moves ~67 MB and needs ~69 GFLOP, dq
// ~101 MB and ~103 GFLOP, dk/dv ~101 MB and ~138 GFLOP: at the card's peaks
// the products take 3.4-6.9x the time of the bytes.
//
// What the design does about it: bf16 and f16 run every product on the
// tensor cores (mma.sync, ldmatrix, cp.async; attention_mma.cuh, whose
// header gives the tiles, the backward's one rounding point and what it
// leaves for later); f32 runs the same function as f32 FMA on the CUDA
// cores, chosen by dtype at compile time. The TPU kernel ran a sequential
// grid (b, h, q block, kv block) and carried (m, l, acc) in VMEM scratch
// across the kv steps. Hopper blocks run in parallel and in no order, so
// each block owns one 64-row q tile and loops over the kv tiles itself:
// FlashAttention-2's single pass, one warp per 16 q rows with its running m
// and l and its 16 x D accumulator in f32 registers; K and V tiles stream
// double-buffered by cp.async. Each kv tile rescales acc by
// alpha = exp(m_old - m_new) in f32 and adds P V with the unnormalized p
// rounded to the input dtype as the mma operand, the reference's rounding.
// Causal kv tiles past the diagonal get neither compute nor a load, only the
// tiles that straddle it are masked, and the heaviest q tiles go first. The
// reference's block sizes (bq, bkv) set where its running max moves, and so
// where bf16 rounds p; these kernels' max moves every kv tile, 64 columns
// (32 at D=256 on the tensor cores, for the registers of the 16 x 256
// accumulator; 32 at D=256 on the CUDA cores too), which changes p's
// rounding within bf16's step and nothing else.
//
// What it leaves for later: wgmma with TMA and warp specialisation for all
// three launches (attention_mma.cuh); the dk/dv launch recomputes S and dP,
// so the backward does 7 products where the function needs 5.
//
// Interface: plain C, pointers as void*, strides in elements as a host array
// of (sb, sh, ss) triples; the head dim must be unit-stride, every row
// 16-byte aligned and lse, delta [B, H, Sq] f32 contiguous (the Python
// wrapper checks). Each entry point returns cudaGetLastError() after its
// launches.

#include "lse_backward.cuh"

namespace {

// The online forward on the CUDA cores (f32): one block of 256 threads per
// (q tile, head, batch), f32 tiles in shared memory (attention_tiles.cuh).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    online_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse, Layout lq, Layout lkv, Layout lo,
                      int Sq, int Skv, float scale, int causal) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sKV = sQ + C::BM * C::LD;
  float* sP = sKV + C::BM * C::LD;
  const int qt = Sq / C::BM - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * C::BM;
  const long long kvbase = b * lkv.sb + h * lkv.sh;
  const int kend = causal ? qt + 1 : Skv / C::BM;

  load_tile<T, D>(sQ, q + b * lq.sb + h * lq.sh + q0 * lq.ss, lq.ss);
  float m[C::RM], l[C::RM], acc[C::RM][C::RD];
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::RD; ++j) acc[i][j] = 0.f;
  }
  for (int kt = 0; kt < kend; ++kt) {
    __syncthreads();
    load_tile<T, D>(sKV, k + kvbase + kt * C::BM * lkv.ss, lkv.ss);
    __syncthreads();
    float s[C::RM][C::RM];
    scores<D>(s, sQ, sKV, scale, causal && kt == qt, q0, kt * C::BM);
#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      float tmax = s[i][0];
#pragma unroll
      for (int j = 1; j < C::RM; ++j) tmax = fmaxf(tmax, s[i][j]);
      const float mn = fmaxf(m[i], row_max16(tmax));
      const float alpha = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::RM; ++j) {
        const float p = expf(s[i][j] - mn);
        sum += p;
        sP[(ty + 16 * i) * C::LS + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
      l[i] = alpha * l[i] + row_sum16(sum);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < C::RD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    load_tile<T, D>(sKV, v + kvbase + kt * C::BM * lkv.ss, lkv.ss);
    __syncthreads();
    tile_matmul<D, false>(acc, sP, sKV);
  }
  T* ob = o + b * lo.sb + h * lo.sh;
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j)
      ob[(q0 + ty + 16 * i) * lo.ss + tx + 16 * j] = from_f32<T>(acc[i][j] / l[i]);
  if (tx == 0) {
    const long long row = (static_cast<long long>(b) * gridDim.y + h) * Sq + q0;
#pragma unroll
    for (int i = 0; i < C::RM; ++i) lse[row + ty + 16 * i] = m[i] + logf(l[i]);
  }
}

// The online forward on the tensor cores (bf16, f16): one block per
// (q tile, head, batch), heaviest causal tiles first, one pass over the kv
// tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
    mma_online_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                          Layout lq, Layout lkv, Layout lo, int Sq, int Skv, float scale,
                          int causal) {
  using C = MmaCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* sQ = reinterpret_cast<T*>(mma_smem);
  T* sK = sQ + BM * LD;      // two buffers of [BN][LD]
  T* sV = sK + 2 * BN * LD;  // two buffers of [BN][LD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qt = Sq / BM - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BM, r0 = warp * 16;
  const long long kvbase = b * lkv.sb + h * lkv.sh;
  const int kend = causal ? (q0 + BM) / BN : Skv / BN;

  auto prefetch = [&](int kt) {
    if (kt < kend) {
      const long long off = kvbase + static_cast<long long>(kt) * BN * lkv.ss;
      copy_tile<T, D, BN>(sK + (kt & 1) * BN * LD, k + off, lkv.ss);
      copy_tile<T, D, BN>(sV + (kt & 1) * BN * LD, v + off, lkv.ss);
    }
    cp_async_commit();
  };
  copy_tile<T, D, BM>(sQ, q + b * lq.sb + h * lq.sh + static_cast<long long>(q0) * lq.ss, lq.ss);
  prefetch(0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < kend; ++kt) {
    prefetch(kt + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * BN, buf = (kt & 1) * BN * LD;
    float s[BN / 8][4];
    warp_abt<T, D, BN>(s, sQ + r0 * LD, sK + buf);
    scale_mask<BN / 8, false>(s, scale, causal && k0 + BN - 1 > q0 + r0, q0 + r0, k0);
    // m_new, alpha = exp(m_old - m_new), p = exp(s - m_new) in f32 (s holds
    // p from here), l = alpha l + rowsum(p)
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = s[0][2 * i];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      const float mn = fmaxf(m[i], quad_max(mx));
      alpha[i] = __expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[j][e] = __expf(s[j][e] - mn);
          sum += s[j][e];
        }
      l[i] = alpha[i] * l[i] + quad_sum(sum);
      m[i] = mn;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t af[4];
      a_frag<T>(af, s, kk);  // p rounded to the input dtype
      warp_ab<T, LD, D>(acc, af, sV + buf + kk * 16 * LD);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] /= l[e >> 1];
  store_rows<T, D>(o + b * lo.sb + h * lo.sh, lo.ss, acc, q0 + r0, 0);
  if ((lane & 3) == 0) {
    const long long row = (static_cast<long long>(b) * gridDim.y + h) * Sq + q0 + r0 + (lane >> 2);
    lse[row] = m[0] + logf(l[0]);
    lse[row + 8] = m[1] + logf(l[1]);
  }
}

// The online forward: tensor cores for bf16 and f16, the CUDA-core kernel
// above for f32 (by dtype, at compile time).
template <typename T, int D>
cudaError_t launch_online_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              const long long* st, int B, int H, int Sq, int Skv, float scale,
                              int causal, cudaStream_t cs) {
  if (causal && Sq != Skv) return cudaErrorInvalidValue;
  const Layout lq = layout_at(st, 0), lkv = layout_at(st, 1), lo = layout_at(st, 2);
  if constexpr (std::is_same<T, float>::value) {
    using C = Tile<D>;
    if (Sq % C::BM != 0 || Skv % C::BM != 0) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(online_fwd_kernel<T, D>, fwd_smem<D>());
    if (e != cudaSuccess) return e;
    online_fwd_kernel<T, D><<<dim3(Sq / C::BM, H, B), kThreads, fwd_smem<D>(), cs>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, lq, lkv, lo, Sq, Skv, scale, causal);
  } else {
    using C = MmaCfg<D>;
    if (Sq % C::BM != 0 || Skv % C::BN != 0) return cudaErrorInvalidValue;
    constexpr size_t smem = mma_fwd_smem<T, D>();
    cudaError_t e = allow_smem(mma_online_fwd_kernel<T, D>, smem);
    if (e != cudaSuccess) return e;
    mma_online_fwd_kernel<T, D><<<dim3(Sq / C::BM, H, B), kMmaThreads, smem, cs>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, lq, lkv, lo, Sq, Skv, scale, causal);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// st: (sb, sh, ss) of q, kv, then o.
int bf_fwd(int dtype, int d, const void* q, const void* k, const void* v, void* o, void* lse,
           const long long* st, int B, int H, int Sq, int Skv, float scale, int causal,
           void* stream) {
  auto cs = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype_and_d(dtype, d, [&](auto t, auto dc) {
    using T = decltype(t);
    return launch_online_fwd<T, decltype(dc)::value>(q, k, v, o, static_cast<float*>(lse), st, B,
                                                       H, Sq, Skv, scale, causal, cs);
  }));
}

// st: (sb, sh, ss) of q, kv, o, dO, then dq. Writes dq and delta (f32
// [B, H, Sq]), which bf_bwd_dkv reads.
int bf_bwd_dq(int dtype, int d, const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* dout, void* dq, void* delta, const long long* st, int B,
              int H, int Sq, int Skv, float scale, int causal, void* stream) {
  auto cs = static_cast<cudaStream_t>(stream);
  const BwdArgs a{q, k, v, o, dout, static_cast<float*>(const_cast<void*>(lse)),
                  static_cast<float*>(delta), layout_at(st, 0), layout_at(st, 1),
                  layout_at(st, 2), layout_at(st, 3), B, H, Sq, Skv, scale, causal};
  return static_cast<int>(by_dtype_and_d(dtype, d, [&](auto t, auto dc) {
    return launch_lse_dq<decltype(t), decltype(dc)::value>(a, dq, layout_at(st, 4), cs);
  }));
}

// st: (sb, sh, ss) of q, kv, dO, then dk/dv. lse and delta: f32 [B, H, Sq],
// delta as bf_bwd_dq wrote it.
int bf_bwd_dkv(int dtype, int d, const void* q, const void* k, const void* v, const void* lse,
               const void* delta, const void* dout, void* dk, void* dv, const long long* st,
               int B, int H, int Sq, int Skv, float scale, int causal, void* stream) {
  auto cs = static_cast<cudaStream_t>(stream);
  const Layout lq = layout_at(st, 0);
  const BwdArgs a{q, k, v, nullptr, dout, static_cast<float*>(const_cast<void*>(lse)),
                  static_cast<float*>(const_cast<void*>(delta)), lq, layout_at(st, 1), lq,
                  layout_at(st, 2), B, H, Sq, Skv, scale, causal};
  return static_cast<int>(by_dtype_and_d(dtype, d, [&](auto t, auto dc) {
    return launch_lse_dkv<decltype(t), decltype(dc)::value>(a, dk, dv, layout_at(st, 3), cs);
  }));
}

const char* bf_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
