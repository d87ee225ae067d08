// The attention backward from a saved log-sum-exp, shared by
// causal_attention.cu (its one backward) and blocked_flash.cu (its dq and
// dk/dv launches); simple_attention.cu's recompute backward, whose dq
// launch writes lse and delta, shares the dk/dv launch. Same function as
// the references' backward kernels:
// p = exp(s - lse) in f32, delta = rowsum(dO * O) with O the saved output,
// dS = p (dP - delta) scale, dq = dS K, dk = dS^T Q, dv = P^T dO, every sum in
// f32 and cast to the input dtype at the end.
//
//   dq   one block per (q tile, head, batch), kv tiles inner; delta is
//        computed once for each row and written (f32 [B, H, Sq]) for the
//        dk/dv launch. Causal: kv tiles past the diagonal are skipped, and
//        only the tiles that straddle it are masked.
//   dkv  one block per (kv tile, head, batch), q tiles inner, starting at the
//        diagonal when causal; dk and dv stay in f32 registers.
// No atomics. Causal is top-left (col <= row, q and kv tiles counted from one
// origin, as the references); causal Sq != Skv only when the launcher is
// asked for it (cross_causal, the library tier): a q tile past Skv then sees
// every kv tile, and a kv tile wholly past the last q row sees no q tile and
// writes dk = dv = 0.
//
// bf16 and f16 run on the tensor cores: launches A (one pass, lse from the
// forward) and B of attention_mma.cuh, whose header gives the design and its
// one rounding point, P and dS rounded to the input dtype as mma operands.
// f32 runs the CUDA-core kernels below (f32 FMA from f32 tiles in shared
// memory, attention_tiles.cuh), chosen by dtype at compile time in
// launch_lse_dq and launch_lse_dkv; never a path taken on error.
#pragma once

#include "attention_mma.cuh"

namespace {

// delta[i] = rowsum(dO * O) of the rows ty + 16 i of one BM-row tile, read
// from device memory in 16-byte vectors.
template <typename T, int D>
__device__ __forceinline__ void row_delta(float (&delta)[Tile<D>::RM], const T* o, long long os,
                                          const T* g, long long gs) {
  using C = Tile<D>;
  constexpr int V = 16 / sizeof(T);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    const int r = ty + 16 * i;
    float part = 0.f;
    for (int c = tx * V; c < D; c += 16 * V) {
      const uint4 ro = *reinterpret_cast<const uint4*>(o + r * os + c);
      const uint4 rg = *reinterpret_cast<const uint4*>(g + r * gs + c);
      const T* eo = reinterpret_cast<const T*>(&ro);
      const T* eg = reinterpret_cast<const T*>(&rg);
#pragma unroll
      for (int j = 0; j < V; ++j) part += to_f32(eg[j]) * to_f32(eo[j]);
    }
    delta[i] = row_sum16(part);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) lse_dq_kernel(BwdArgs a, T* __restrict__ dq, Layout ldq) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + C::BM * C::LD;
  float* sK = sDO + C::BM * C::LD;
  float* sV = sK + C::BM * C::LD;
  float* sDS = sV + C::BM * C::LD;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int qt = a.Sq / C::BM - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * C::BM;
  const long long kvbase = b * a.lkv.sb + h * a.lkv.sh;
  const long long row = (static_cast<long long>(b) * a.H + h) * a.Sq + q0;
  const int kend = a.causal && qt + 1 < a.Skv / C::BM ? qt + 1 : a.Skv / C::BM;
  const T* g = static_cast<const T*>(a.dout) + b * a.lg.sb + h * a.lg.sh + q0 * a.lg.ss;

  load_tile<T, D>(sQ, q + b * a.lq.sb + h * a.lq.sh + q0 * a.lq.ss, a.lq.ss);
  load_tile<T, D>(sDO, g, a.lg.ss);
  float lse[C::RM], delta[C::RM];
  row_delta<T, D>(delta, static_cast<const T*>(a.o) + b * a.lo.sb + h * a.lo.sh + q0 * a.lo.ss,
                  a.lo.ss, g, a.lg.ss);
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    lse[i] = a.lse[row + ty + 16 * i];
    if (tx == 0) a.delta[row + ty + 16 * i] = delta[i];
  }

  float acc[C::RM][C::RD];
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < kend; ++kt) {
    __syncthreads();
    load_tile<T, D>(sK, k + kvbase + kt * C::BM * a.lkv.ss, a.lkv.ss);
    load_tile<T, D>(sV, v + kvbase + kt * C::BM * a.lkv.ss, a.lkv.ss);
    __syncthreads();
    float s[C::RM][C::RM], dp[C::RM][C::RM];
    scores<D>(s, sQ, sK, a.scale, a.causal && kt == qt, q0, kt * C::BM);
    dot_rows<D>(dp, sDO, sV);
#pragma unroll
    for (int i = 0; i < C::RM; ++i)
#pragma unroll
      for (int j = 0; j < C::RM; ++j)
        sDS[(ty + 16 * i) * C::LS + tx + 16 * j] =
            expf(s[i][j] - lse[i]) * (dp[i][j] - delta[i]) * a.scale;
    __syncthreads();
    tile_matmul<D, false>(acc, sDS, sK);
  }
  T* dqb = dq + b * ldq.sb + h * ldq.sh;
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j) dqb[(q0 + ty + 16 * i) * ldq.ss + tx + 16 * j] = from_f32<T>(acc[i][j]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    lse_dkv_kernel(BwdArgs a, T* __restrict__ dk, T* __restrict__ dv, Layout ldkv) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + C::BM * C::LD;
  float* sQ = sV + C::BM * C::LD;
  float* sDO = sQ + C::BM * C::LD;
  float* sP = sDO + C::BM * C::LD;
  float* sDS = sP + C::BM * C::LS;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int kt = blockIdx.x;  // low kv tiles see the most q tiles: first
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = kt * C::BM;
  const long long kvbase = b * a.lkv.sb + h * a.lkv.sh;
  const long long qbase = b * a.lq.sb + h * a.lq.sh;
  const long long gbase = b * a.lg.sb + h * a.lg.sh;
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;

  load_tile<T, D>(sK, k + kvbase + k0 * a.lkv.ss, a.lkv.ss);
  load_tile<T, D>(sV, v + kvbase + k0 * a.lkv.ss, a.lkv.ss);
  float acc_k[C::RM][C::RD], acc_v[C::RM][C::RD];
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
    __syncthreads();
    load_tile<T, D>(sQ, q + qbase + q0 * a.lq.ss, a.lq.ss);
    load_tile<T, D>(sDO, dout + gbase + q0 * a.lg.ss, a.lg.ss);
    __syncthreads();
    float s[C::RM][C::RM], dp[C::RM][C::RM];
    scores<D>(s, sQ, sK, a.scale, a.causal && qt == kt, q0, k0);
    dot_rows<D>(dp, sDO, sV);
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
    tile_matmul<D, true>(acc_v, sP, sDO);
    tile_matmul<D, true>(acc_k, sDS, sQ);
  }
  T* dkb = dk + b * ldkv.sb + h * ldkv.sh;
  T* dvb = dv + b * ldkv.sb + h * ldkv.sh;
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j) {
      const long long off = (k0 + ty + 16 * i) * ldkv.ss + tx + 16 * j;
      dkb[off] = from_f32<T>(acc_k[i][j]);
      dvb[off] = from_f32<T>(acc_v[i][j]);
    }
}

template <int D>
constexpr size_t lse_dq_smem() {
  return (4 * Tile<D>::BM * Tile<D>::LD + Tile<D>::BM * Tile<D>::LS) * sizeof(float);
}
template <int D>
constexpr size_t lse_dkv_smem() {
  return (4 * Tile<D>::BM * Tile<D>::LD + 2 * Tile<D>::BM * Tile<D>::LS) * sizeof(float);
}

template <int D>
bool lse_shapes_ok(const BwdArgs& a, bool cross_causal) {
  return a.Sq % Tile<D>::BM == 0 && a.Skv % Tile<D>::BM == 0 &&
         (!a.causal || a.Sq == a.Skv || cross_causal);
}

// The dq launch (it also writes delta): the tensor cores for bf16 and f16,
// the CUDA-core kernel for f32.
template <typename T, int D>
cudaError_t launch_lse_dq(const BwdArgs& a, void* dq, Layout ldq, cudaStream_t st,
                          bool cross_causal = false) {
  if constexpr (std::is_same<T, float>::value) {
    if (!lse_shapes_ok<D>(a, cross_causal)) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(lse_dq_kernel<T, D>, lse_dq_smem<D>());
    if (e != cudaSuccess) return e;
    lse_dq_kernel<T, D><<<dim3(a.Sq / Tile<D>::BM, a.H, a.B), kThreads, lse_dq_smem<D>(), st>>>(
        a, static_cast<T*>(dq), ldq);
    return cudaGetLastError();
  } else {
    return launch_mma_dq<T, D, true>(a, dq, ldq, st, cross_causal);
  }
}

// The dk/dv launch, after the dq launch on one stream (it reads delta).
template <typename T, int D>
cudaError_t launch_lse_dkv(const BwdArgs& a, void* dk, void* dv, Layout ldkv, cudaStream_t st,
                           bool cross_causal = false) {
  if constexpr (std::is_same<T, float>::value) {
    if (!lse_shapes_ok<D>(a, cross_causal)) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(lse_dkv_kernel<T, D>, lse_dkv_smem<D>());
    if (e != cudaSuccess) return e;
    lse_dkv_kernel<T, D><<<dim3(a.Skv / Tile<D>::BM, a.H, a.B), kThreads, lse_dkv_smem<D>(),
                           st>>>(a, static_cast<T*>(dk), static_cast<T*>(dv), ldkv);
    return cudaGetLastError();
  } else {
    return launch_mma_dkv<T, D>(a, dk, dv, ldkv, st, cross_causal);
  }
}

}  // namespace
