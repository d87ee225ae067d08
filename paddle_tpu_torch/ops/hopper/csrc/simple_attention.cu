// Monolithic-softmax attention for short sequences, forward and backward,
// written for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/simple_attention.py, the Pallas kernels
// `_fwd_kernel` (pl.pallas_call in `_fwd`) and `_bwd_kernel` (in `_bwd`).
// Same function: O = softmax(scale * Q K^T, top-left causal mask at -1e30) V
// with scores and softmax in f32, p rounded to the input dtype before PV, and
// a backward that recomputes P in f32 with delta = rowsum(dP * P).
//
// What bounds it on this card: at the training shape (S=1024, D=128, bf16)
// the forward moves ~67 MB and does ~17 GFLOP (causal half), the backward
// ~117 MB and ~43 GFLOP, so with tensor cores the forward would be bound by
// bytes and the backward by operations. This first version does its products
// with FMA on the CUDA cores (f32, 67 TFLOP/s peak), so it is bound by
// operations and by shared-memory bandwidth feeding them.
//
// What the design does about it: the TPU kernel held the whole [S, S] f32
// score matrix (4 MiB at S=1024) in VMEM; a Hopper block has 227 KB of shared
// memory, so here every block owns one tile of BM rows and loops over tiles:
//   forward      one block per (q tile, head, batch). Pass 1 finds the row max
//                m and sum l over kv tiles; pass 2 forms p = exp(s - m) / l,
//                rounds it to the input dtype exactly where the reference
//                does, and accumulates PV in f32. kv tiles past the diagonal
//                are skipped when causal (exp(-1e30 - m) is exactly 0 in f32).
//   backward A   one block per (q tile, head, batch): recomputes m and l,
//                then delta = rowsum(dP * P), then dq = sum dS K. Writes dq
//                and m, l, delta (f32 scratch [B, H, S]).
//   backward B   one block per (kv tile, head, batch): loops over the q tiles
//                at and below the diagonal, rebuilds P from m and l, and
//                accumulates dv = P^T dO and dk = dS^T Q in f32 registers.
// No atomics, so the result is deterministic. Heavy causal tiles are
// scheduled first. The forward and the tile code are in attention_tiles.cuh,
// which causal_attention.cu shares.
//
// These kernels also replace paddle_tpu/ops/pallas/simple_attention2.py
// (qblock_attention, the middle tier). Read side by side, its Pallas kernels
// compute this same function with the same rounding points and the same
// recompute backward; only the f32 order in which dk and dv are summed
// differs (it adds one q block's share at a time; launch B here loops over
// the q tiles). Its TPU design streams q in blocks and keeps k and v whole in
// VMEM, 1 MB of f32 each per (b, h) at its train shape (S=4096, D=64), which
// a Hopper block cannot hold: the tiling above is the Hopper counterpart.
// simple_attention2.py launches sa_fwd and sa_bwd under its own counters.
//
// Interface: plain C, pointers as void*, strides in elements; the head dim
// must be unit-stride and every row 16-byte aligned (the Python wrapper
// checks). Each entry point returns cudaGetLastError() after its launches.

#include "attention_tiles.cuh"

namespace {

// Backward launch A: dq, and the row statistics m, l, delta for launch B.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ m_out,
                  float* __restrict__ l_out, float* __restrict__ delta_out, Layout in, Layout g,
                  Layout out, int S, float scale, int causal) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + C::BM * C::LD;
  float* sK = sDO + C::BM * C::LD;
  float* sV = sK + C::BM * C::LD;
  float* sDS = sV + C::BM * C::LD;
  const int nt = S / C::BM;
  const int qt = nt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * C::BM;
  const long long base = b * in.sb + h * in.sh;
  const int kend = causal ? qt + 1 : nt;

  load_tile<T, D>(sQ, q + base + q0 * in.ss, in.ss);
  load_tile<T, D>(sDO, dout + b * g.sb + h * g.sh + q0 * g.ss, g.ss);
  float m[C::RM], l[C::RM];
  row_stats<T, D>(m, l, sQ, sK, k + base, in.ss, kend, scale, causal, q0);

  // delta = rowsum(dP * P) over the whole row.
  float delta[C::RM];
#pragma unroll
  for (int i = 0; i < C::RM; ++i) delta[i] = 0.f;
  for (int kt = 0; kt < kend; ++kt) {
    __syncthreads();
    load_tile<T, D>(sK, k + base + kt * C::BM * in.ss, in.ss);
    load_tile<T, D>(sV, v + base + kt * C::BM * in.ss, in.ss);
    __syncthreads();
    float s[C::RM][C::RM], dp[C::RM][C::RM];
    scores<D>(s, sQ, sK, scale, causal, q0, kt * C::BM);
    dot_rows<D>(dp, sDO, sV);
#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < C::RM; ++j) part += dp[i][j] * (expf(s[i][j] - m[i]) / l[i]);
      delta[i] += row_sum16(part);
    }
  }

  // dS = P (dP - delta) scale; dq = dS K.
  float acc[C::RM][C::RD];
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < kend; ++kt) {
    __syncthreads();
    load_tile<T, D>(sK, k + base + kt * C::BM * in.ss, in.ss);
    load_tile<T, D>(sV, v + base + kt * C::BM * in.ss, in.ss);
    __syncthreads();
    float s[C::RM][C::RM], dp[C::RM][C::RM];
    scores<D>(s, sQ, sK, scale, causal, q0, kt * C::BM);
    dot_rows<D>(dp, sDO, sV);
#pragma unroll
    for (int i = 0; i < C::RM; ++i)
#pragma unroll
      for (int j = 0; j < C::RM; ++j) {
        const float p = expf(s[i][j] - m[i]) / l[i];
        sDS[(ty + 16 * i) * C::LS + tx + 16 * j] = p * (dp[i][j] - delta[i]) * scale;
      }
    __syncthreads();
    tile_matmul<D, false>(acc, sDS, sK);
  }
  T* dqb = dq + b * out.sb + h * out.sh;
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j) dqb[(q0 + ty + 16 * i) * out.ss + tx + 16 * j] = from_f32<T>(acc[i][j]);
  if (tx == 0) {
    const long long row = (static_cast<long long>(b) * gridDim.y + h) * S + q0;
#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      m_out[row + ty + 16 * i] = m[i];
      l_out[row + ty + 16 * i] = l[i];
      delta_out[row + ty + 16 * i] = delta[i];
    }
  }
}

// Backward launch B: dk and dv of one kv tile, over the q tiles that see it.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                   const float* __restrict__ m_in, const float* __restrict__ l_in,
                   const float* __restrict__ delta_in, Layout in, Layout g, Layout out, int S,
                   float scale, int causal) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + C::BM * C::LD;
  float* sQ = sV + C::BM * C::LD;
  float* sDO = sQ + C::BM * C::LD;
  float* sP = sDO + C::BM * C::LD;
  float* sDS = sP + C::BM * C::LS;
  const int nt = S / C::BM;
  const int kt = blockIdx.x;  // low kv tiles see the most q tiles: first
  const int h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = kt * C::BM;
  const long long base = b * in.sb + h * in.sh;
  const long long gbase = b * g.sb + h * g.sh;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + h) * S;

  load_tile<T, D>(sK, k + base + k0 * in.ss, in.ss);
  load_tile<T, D>(sV, v + base + k0 * in.ss, in.ss);
  float acc_k[C::RM][C::RD], acc_v[C::RM][C::RD];
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j) {
      acc_k[i][j] = 0.f;
      acc_v[i][j] = 0.f;
    }
  for (int qt = causal ? kt : 0; qt < nt; ++qt) {
    const int q0 = qt * C::BM;
    __syncthreads();
    load_tile<T, D>(sQ, q + base + q0 * in.ss, in.ss);
    load_tile<T, D>(sDO, dout + gbase + q0 * g.ss, g.ss);
    __syncthreads();
    float s[C::RM][C::RM], dp[C::RM][C::RM];
    scores<D>(s, sQ, sK, scale, causal, q0, k0);
    dot_rows<D>(dp, sDO, sV);
#pragma unroll
    for (int i = 0; i < C::RM; ++i) {
      const long long r = row0 + q0 + ty + 16 * i;
      const float mi = m_in[r], li = l_in[r], di = delta_in[r];
#pragma unroll
      for (int j = 0; j < C::RM; ++j) {
        const float p = expf(s[i][j] - mi) / li;
        sP[(ty + 16 * i) * C::LS + tx + 16 * j] = p;
        sDS[(ty + 16 * i) * C::LS + tx + 16 * j] = p * (dp[i][j] - di) * scale;
      }
    }
    __syncthreads();
    tile_matmul<D, true>(acc_v, sP, sDO);
    tile_matmul<D, true>(acc_k, sDS, sQ);
  }
  T* dkb = dk + b * out.sb + h * out.sh;
  T* dvb = dv + b * out.sb + h * out.sh;
#pragma unroll
  for (int i = 0; i < C::RM; ++i)
#pragma unroll
    for (int j = 0; j < C::RD; ++j) {
      const long long off = (k0 + ty + 16 * i) * out.ss + tx + 16 * j;
      dkb[off] = from_f32<T>(acc_k[i][j]);
      dvb[off] = from_f32<T>(acc_v[i][j]);
    }
}

template <int D>
constexpr size_t dq_smem() {
  return (4 * Tile<D>::BM * Tile<D>::LD + Tile<D>::BM * Tile<D>::LS) * sizeof(float);
}
template <int D>
constexpr size_t dkv_smem() {
  return (4 * Tile<D>::BM * Tile<D>::LD + 2 * Tile<D>::BM * Tile<D>::LS) * sizeof(float);
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                       void* dk, void* dv, float* m, float* l, float* delta, Layout in, Layout g,
                       Layout out, int B, int H, int S, float scale, int causal,
                       cudaStream_t st) {
  if (S % Tile<D>::BM != 0) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(bwd_dq_kernel<T, D>, dq_smem<D>());
  if (e != cudaSuccess) return e;
  e = allow_smem(bwd_dkv_kernel<T, D>, dkv_smem<D>());
  if (e != cudaSuccess) return e;
  dim3 grid(S / Tile<D>::BM, H, B);
  bwd_dq_kernel<T, D><<<grid, kThreads, dq_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), m, l, delta, in, g, out, S, scale,
      causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkv_kernel<T, D><<<grid, kThreads, dkv_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dk), static_cast<T*>(dv), m, l, delta, in, g,
      out, S, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int sa_fwd(int dtype, int d, const void* q, const void* k, const void* v, void* o,
           long long in_sb, long long in_sh, long long in_ss, long long out_sb, long long out_sh,
           long long out_ss, int B, int H, int S, float scale, int causal, void* stream) {
  const Layout in{in_sb, in_sh, in_ss}, out{out_sb, out_sh, out_ss};
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype_and_d(dtype, d, [&](auto t, auto dc) {
    using T = decltype(t);
    return launch_fwd<T, decltype(dc)::value>(q, k, v, o, nullptr, in, out, B, H, S, scale,
                                                causal, st);
  }));
}

int sa_bwd(int dtype, int d, const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, void* m, void* l, void* delta, long long in_sb,
           long long in_sh, long long in_ss, long long g_sb, long long g_sh, long long g_ss,
           long long out_sb, long long out_sh, long long out_ss, int B, int H, int S,
           float scale, int causal, void* stream) {
  const Layout in{in_sb, in_sh, in_ss}, g{g_sb, g_sh, g_ss}, out{out_sb, out_sh, out_ss};
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype_and_d(dtype, d, [&](auto t, auto dc) {
    using T = decltype(t);
    return launch_bwd<T, decltype(dc)::value>(
        q, k, v, dout, dq, dk, dv, static_cast<float*>(m), static_cast<float*>(l),
        static_cast<float*>(delta), in, g, out, B, H, S, scale, causal, st);
  }));
}

const char* sa_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
