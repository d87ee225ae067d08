// CUDA-core tile primitives shared by the attention kernels of this
// directory, and the f32 two-pass softmax forward that simple_attention and
// causal_attention share. Products here are f32 FMA, for f32 inputs only:
// every kernel of this directory runs bf16 and f16 on the tensor cores
// (attention_mma.cuh).
//
// A block of 256 threads (16 x 16) owns one tile of BM rows. Tiles live in
// shared memory as f32 with an odd row pitch, which keeps every access
// pattern below free of bank conflicts; thread (ty, tx) holds rows
// ty + 16 i and columns tx + 16 j of every per-thread fragment.
//
// Every source that includes this header gets its own copy (anonymous
// namespace): each source is built into a shared library of its own.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;       // 16 x 16 threads
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// Element strides of one [B, H, S, D] operand; d is unit-stride.
struct Layout {
  long long sb, sh, ss;
};

// The i-th layout of a host array of (sb, sh, ss) triples.
inline Layout layout_at(const long long* st, int i) { return {st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

// What a backward launch reads besides its gradients' buffers: q [B, H, Sq,
// D], k and v [B, H, Skv, D] (one layout), dO, and two f32 row statistics
// [B, H, Sq] contiguous: lse (the forward's, or written by the recompute
// backward's dq launch) and delta = rowsum(dO * O) (written by the dq launch,
// read by the dk/dv launch). o, the saved output, is read by the lse
// backward's dq launch only. Causal needs Sq == Skv (top-left).
struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  float *lse, *delta;
  Layout lq, lkv, lo, lg;
  int B, H, Sq, Skv;
  float scale;
  int causal;
};

template <int D>
struct Tile {
  static constexpr int BM = D > 128 ? 32 : 64;  // rows of a q tile and of a kv tile
  static constexpr int RM = BM / 16;            // tile rows (or columns) per thread
  static constexpr int RD = D / 16;             // head-dim columns per thread
  static constexpr int LD = D + 1;              // shared pitch of a [BM][D] tile
  static constexpr int LS = BM + 1;             // shared pitch of a [BM][BM] tile
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copies BM rows (row stride ss) of one (b, h) slice into shared memory as f32.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss) {
  using C = Tile<D>;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = D / V;
  for (int i = threadIdx.x; i < C::BM * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * V;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * ss + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) dst[r * C::LD + c + j] = to_f32(e[j]);
  }
}

// acc[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d] for two [BM][D] tiles.
template <int D>
__device__ __forceinline__ void dot_rows(float (&acc)[Tile<D>::RM][Tile<D>::RM], const float* A,
                                         const float* B) {
  using C = Tile<D>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RM; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[C::RM], b[C::RM];
#pragma unroll
    for (int i = 0; i < C::RM; ++i) a[i] = A[(ty + 16 * i) * C::LD + d];
#pragma unroll
    for (int j = 0; j < C::RM; ++j) b[j] = B[(tx + 16 * j) * C::LD + d];
#pragma unroll
    for (int i = 0; i < C::RM; ++i)
#pragma unroll
      for (int j = 0; j < C::RM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Scaled, masked scores of q rows q0 + ty + 16i against kv rows k0 + tx + 16j,
// in the reference's order: dot, times scale, then the causal mask.
template <int D>
__device__ __forceinline__ void scores(float (&s)[Tile<D>::RM][Tile<D>::RM], const float* sQ,
                                       const float* sK, float scale, int causal, int q0, int k0) {
  using C = Tile<D>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  dot_rows<D>(s, sQ, sK);
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RM; ++j) {
      s[i][j] *= scale;
      if (causal && q0 + ty + 16 * i < k0 + tx + 16 * j) s[i][j] = kNegInf;
    }
}

// acc[i][j] += sum_c A(ty + 16i, c) * B[c][tx + 16j], A a [BM][BM] tile
// (read transposed when TRANS_A) and B a [BM][D] tile.
template <int D, bool TRANS_A>
__device__ __forceinline__ void tile_matmul(float (&acc)[Tile<D>::RM][Tile<D>::RD], const float* A,
                                            const float* B) {
  using C = Tile<D>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int c = 0; c < C::BM; ++c) {
    float a[C::RM], b[C::RD];
#pragma unroll
    for (int i = 0; i < C::RM; ++i)
      a[i] = TRANS_A ? A[c * C::LS + ty + 16 * i] : A[(ty + 16 * i) * C::LS + c];
#pragma unroll
    for (int j = 0; j < C::RD; ++j) b[j] = B[c * C::LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < C::RM; ++i)
#pragma unroll
      for (int j = 0; j < C::RD; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Row max m and row sum l = sum exp(s - m) over the kv tiles [0, kend).
template <typename T, int D>
__device__ __forceinline__ void row_stats(float (&m)[Tile<D>::RM], float (&l)[Tile<D>::RM],
                                          const float* sQ, float* sK, const T* k, long long ss,
                                          int kend, float scale, int causal, int q0) {
  using C = Tile<D>;
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int kt = 0; kt < kend; ++kt) {
    __syncthreads();
    load_tile<T, D>(sK, k + kt * C::BM * ss, ss);
    __syncthreads();
    float s[C::RM][C::RM];
    scores<D>(s, sQ, sK, scale, causal, q0, kt * C::BM);
#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      float tmax = s[i][0];
#pragma unroll
      for (int j = 1; j < C::RM; ++j) tmax = fmaxf(tmax, s[i][j]);
      const float mn = fmaxf(m[i], row_max16(tmax));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::RM; ++j) sum += expf(s[i][j] - mn);
      l[i] = l[i] * expf(m[i] - mn) + row_sum16(sum);
      m[i] = mn;
    }
  }
}

// Two-pass softmax forward: one block per (q tile, head, batch). Pass 1 finds
// the row max m and sum l over kv tiles; pass 2 forms p = exp(s - m) / l,
// rounds it to the input dtype exactly where the references do, and
// accumulates PV in f32. kv tiles past the diagonal are skipped when causal
// (exp(-1e30 - m) is exactly 0 in f32). When lse is not null it also writes
// lse = m + log l, [B, H, S] f32 contiguous.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ o, float* __restrict__ lse, Layout in, Layout out, int S,
               float scale, int causal) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sKV = sQ + C::BM * C::LD;
  float* sP = sKV + C::BM * C::LD;
  const int nt = S / C::BM;
  const int qt = nt - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * C::BM;
  const long long base = b * in.sb + h * in.sh;
  const int kend = causal ? qt + 1 : nt;

  load_tile<T, D>(sQ, q + base + q0 * in.ss, in.ss);
  float m[C::RM], l[C::RM];
  row_stats<T, D>(m, l, sQ, sKV, k + base, in.ss, kend, scale, causal, q0);

  float acc[C::RM][C::RD];
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < kend; ++kt) {
    __syncthreads();
    load_tile<T, D>(sKV, k + base + kt * C::BM * in.ss, in.ss);
    __syncthreads();
    float s[C::RM][C::RM];
    scores<D>(s, sQ, sKV, scale, causal, q0, kt * C::BM);
#pragma unroll
    for (int i = 0; i < C::RM; ++i)
#pragma unroll
      for (int j = 0; j < C::RM; ++j)
        sP[(ty + 16 * i) * C::LS + tx + 16 * j] = to_f32(from_f32<T>(expf(s[i][j] - m[i]) / l[i]));
    __syncthreads();
    load_tile<T, D>(sKV, v + base + kt * C::BM * in.ss, in.ss);
    __syncthreads();
    tile_matmul<D, false>(acc, sP, sKV);
  }
  T* ob = o + b * out.sb + h * out.sh;
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j) ob[(q0 + ty + 16 * i) * out.ss + tx + 16 * j] = from_f32<T>(acc[i][j]);
  if (lse != nullptr && tx == 0) {
    const long long row = (static_cast<long long>(b) * gridDim.y + h) * S + q0;
#pragma unroll
    for (int i = 0; i < C::RM; ++i) lse[row + ty + 16 * i] = m[i] + logf(l[i]);
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return (2 * Tile<D>::BM * Tile<D>::LD + Tile<D>::BM * Tile<D>::LS) * sizeof(float);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, Layout in,
                       Layout out, int B, int H, int S, float scale, int causal,
                       cudaStream_t st) {
  if (S % Tile<D>::BM != 0) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(fwd_kernel<T, D>, fwd_smem<D>());
  if (e != cudaSuccess) return e;
  dim3 grid(S / Tile<D>::BM, H, B);
  fwd_kernel<T, D><<<grid, kThreads, fwd_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, in, out, S, scale, causal);
  return cudaGetLastError();
}

// dtype codes shared with the Python wrappers: 0 f32, 1 bf16, 2 f16.
template <int D, typename F>
cudaError_t by_dtype(int dtype, F&& f) {
  switch (dtype) {
    case 0: return f(float{}, std::integral_constant<int, D>{});
    case 1: return f(__nv_bfloat16{}, std::integral_constant<int, D>{});
    case 2: return f(__half{}, std::integral_constant<int, D>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t by_dtype_and_d(int dtype, int d, F&& f) {
  switch (d) {
    case 64: return by_dtype<64>(dtype, f);
    case 128: return by_dtype<128>(dtype, f);
    case 256: return by_dtype<256>(dtype, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
