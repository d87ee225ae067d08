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
// lse_backward.cuh, one launch each for dq and for dk/dv, as the reference.
//
// What bounds it on this card: at the rung's shape (B2 H8 S4096 D128, bf16,
// causal) the forward moves ~67 MB and needs ~69 GFLOP, dq ~101 MB and
// ~103 GFLOP, dk/dv ~118 MB and ~138 GFLOP; with tensor cores all three would
// be bound by operations. This first version does its products with FMA on
// the CUDA cores, so it is bound by operations and by the shared-memory
// bandwidth feeding them.
//
// What the design does about it: the TPU kernel ran a sequential grid
// (b, h, q block, kv block) and carried (m, l, acc) in VMEM scratch across the
// kv steps. Hopper blocks run in parallel and in no order, so each block owns
// one 64-row q tile (32 at D=256) and loops over the kv tiles itself, the
// state in registers. Causal kv tiles past the diagonal get neither compute
// nor a load, and only the diagonal tile is masked. The reference's block
// sizes (bq, bkv) set where its running max moves, and so where bf16 rounds
// p; this kernel's max moves every 64 columns, which changes p's rounding
// within bf16's step and nothing else.
//
// Interface: plain C, pointers as void*, strides in elements as a host array
// of (sb, sh, ss) triples; the head dim must be unit-stride, every row
// 16-byte aligned and lse [B, H, Sq] f32 contiguous (the Python wrapper
// checks). Each entry point returns cudaGetLastError() after its launches.

#include "lse_backward.cuh"

namespace {

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

template <typename T, int D>
cudaError_t launch_online_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              const long long* st, int B, int H, int Sq, int Skv, float scale,
                              int causal, cudaStream_t cs) {
  using C = Tile<D>;
  if (Sq % C::BM != 0 || Skv % C::BM != 0 || (causal && Sq != Skv)) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(online_fwd_kernel<T, D>, fwd_smem<D>());
  if (e != cudaSuccess) return e;
  online_fwd_kernel<T, D><<<dim3(Sq / C::BM, H, B), kThreads, fwd_smem<D>(), cs>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, layout_at(st, 0), layout_at(st, 1), layout_at(st, 2), Sq, Skv,
      scale, causal);
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

// st: (sb, sh, ss) of q, kv, o, dO, then dq.
int bf_bwd_dq(int dtype, int d, const void* q, const void* k, const void* v, const void* o,
              const void* lse, const void* dout, void* dq, const long long* st, int B, int H,
              int Sq, int Skv, float scale, int causal, void* stream) {
  auto cs = static_cast<cudaStream_t>(stream);
  const LseArgs a = lse_args(q, k, v, o, lse, dout, st, B, H, Sq, Skv, scale, causal);
  return static_cast<int>(by_dtype_and_d(dtype, d, [&](auto t, auto dc) {
    using T = decltype(t);
    return launch_lse_dq<T, decltype(dc)::value>(a, dq, layout_at(st, 4), cs);
  }));
}

// st: (sb, sh, ss) of q, kv, o, dO, then dk/dv.
int bf_bwd_dkv(int dtype, int d, const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* dk, void* dv, const long long* st, int B,
               int H, int Sq, int Skv, float scale, int causal, void* stream) {
  auto cs = static_cast<cudaStream_t>(stream);
  const LseArgs a = lse_args(q, k, v, o, lse, dout, st, B, H, Sq, Skv, scale, causal);
  return static_cast<int>(by_dtype_and_d(dtype, d, [&](auto t, auto dc) {
    using T = decltype(t);
    return launch_lse_dkv<T, decltype(dc)::value>(a, dk, dv, layout_at(st, 4), cs);
  }));
}

const char* bf_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
