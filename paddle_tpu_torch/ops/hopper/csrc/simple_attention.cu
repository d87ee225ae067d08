// Monolithic-softmax attention for short sequences, forward and backward,
// written for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/simple_attention.py, the Pallas kernels
// `_fwd_kernel` (pl.pallas_call in `_fwd`) and `_bwd_kernel` (in `_bwd`), and
// paddle_tpu/ops/pallas/simple_attention2.py (qblock_attention, the middle
// tier), `_fwd_kernel` and `_bwd_kernel` (in its `_fwd` and `_bwd`).
// Same function: O = softmax(scale * Q K^T, top-left causal mask at -1e30) V
// with scores and softmax in f32, p rounded to the input dtype before PV, and
// a backward that recomputes P in f32 with delta = rowsum(dP * P).
//
// What bounds it on this card: operations. At the flagship's shape (B4 H16
// S1024 D128, bf16, causal) the forward needs ~17 GFLOP and moves ~67 MB
// (0.017 and 0.020 ms at the card's peaks), the backward ~43 GFLOP and
// ~117 MB; at qblock's (B2 H16 S4096 D64) 69 and 172 GFLOP for the same
// bytes. Doing 3 and 9 products where these count 2 and 5, on the 989
// TFLOP/s bf16 tensor cores, every launch is bound by operations.
//
// What the design does about it: bf16 and f16 run on the tensor cores
// (mma.sync, ldmatrix, cp.async; attention_mma.cuh, whose header gives the
// design, its one new rounding point and what it leaves for later):
//   forward      one block per (q tile, head, batch). Pass 1 finds the row max
//                m and sum l over kv tiles; pass 2 forms p = exp(s - m) / l,
//                rounds it to the input dtype exactly where the reference
//                does, and accumulates PV in f32. kv tiles past the diagonal
//                are skipped when causal, and (bf16, f16) only the tiles
//                that straddle the diagonal are masked.
//   backward A   one block per (q tile, head, batch): one pass for m, l and
//                delta = rowsum(dP * P), one for dq = sum dS K. Writes dq and
//                lse = m + log l, delta (f32 scratch [B, H, S]).
//   backward B   one block per (kv tile, head, batch): loops over the q tiles
//                at and below the diagonal, rebuilds P = exp(s - lse), and
//                accumulates dv = P^T dO and dk = dS^T Q in f32 registers.
//                These are the lse backward's launches too (causal_attention,
//                blocked_flash), A with its statistics pass switched off.
// f32 inputs run the same two-pass forward and recompute backward as
// products of f32 FMA on the CUDA cores (attention_tiles.cuh, launch A
// below, and launch B of lse_backward.cuh), chosen by dtype at compile time
// (launch_recompute_bwd).
// No atomics, so the result is deterministic. Heavy causal tiles are
// scheduled first. causal_attention.cu shares the forward.
//
// qblock_attention: read side by side, its Pallas kernels compute this same
// function with the same rounding points and the same recompute backward;
// only the f32 order in which dk and dv are summed differs (it adds one q
// block's share at a time; launch B here loops over the q tiles). Its TPU
// design streams q in blocks and keeps k and v whole in VMEM, 1 MB of f32
// each per (b, h) at its train shape (S=4096, D=64), which a Hopper block
// cannot hold: the tiling above is the Hopper counterpart.
// simple_attention2.py launches sa_fwd and sa_bwd under its own counters.
//
// What it leaves for later: wgmma with TMA and warp specialisation
// (attention_mma.cuh).
//
// Interface: plain C, pointers as void*, strides in elements; the head dim
// must be unit-stride and every row 16-byte aligned (the Python wrapper
// checks). Each entry point returns cudaGetLastError() after its launches.

#include "lse_backward.cuh"

namespace {

// f32 backward launch A: dq, and the row statistics lse, delta for launch B.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ lse_out,
                  float* __restrict__ delta_out, Layout in, Layout g,
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
      lse_out[row + ty + 16 * i] = m[i] + logf(l[i]);
      delta_out[row + ty + 16 * i] = delta[i];
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return (4 * Tile<D>::BM * Tile<D>::LD + Tile<D>::BM * Tile<D>::LS) * sizeof(float);
}

// The recompute backward: launch A (dq, lse, delta) on the tensor cores for
// bf16 and f16 (attention_mma.cuh, its statistics pass on) or as the f32
// kernel above, then the dk/dv launch that the lse backward shares
// (lse_backward.cuh); both chosen by dtype at compile time.
template <typename T, int D>
cudaError_t launch_recompute_bwd(const BwdArgs& a, void* dq, void* dk, void* dv, Layout out,
                                 cudaStream_t st) {
  cudaError_t e;
  if constexpr (std::is_same<T, float>::value) {
    if (a.Sq % Tile<D>::BM != 0) return cudaErrorInvalidValue;
    e = allow_smem(bwd_dq_kernel<T, D>, dq_smem<D>());
    if (e != cudaSuccess) return e;
    bwd_dq_kernel<T, D><<<dim3(a.Sq / Tile<D>::BM, a.H, a.B), kThreads, dq_smem<D>(), st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<T*>(dq), a.lse, a.delta, a.lq, a.lg, out,
        a.Sq, a.scale, a.causal);
    e = cudaGetLastError();
  } else {
    e = launch_mma_dq<T, D, false>(a, dq, out, st);
  }
  if (e != cudaSuccess) return e;
  return launch_lse_dkv<T, D>(a, dk, dv, out, st);
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
    return launch_two_pass_fwd<T, decltype(dc)::value>(q, k, v, o, nullptr, in, out, B, H, S,
                                                         scale, causal, st);
  }));
}

int sa_bwd(int dtype, int d, const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, void* lse, void* delta, long long in_sb,
           long long in_sh, long long in_ss, long long g_sb, long long g_sh, long long g_ss,
           long long out_sb, long long out_sh, long long out_ss, int B, int H, int S,
           float scale, int causal, void* stream) {
  const Layout in{in_sb, in_sh, in_ss}, g{g_sb, g_sh, g_ss}, out{out_sb, out_sh, out_ss};
  const BwdArgs a{q, k, v, nullptr, dout, static_cast<float*>(lse), static_cast<float*>(delta),
                  in, in, in, g, B, H, S, S, scale, causal};
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype_and_d(dtype, d, [&](auto t, auto dc) {
    return launch_recompute_bwd<decltype(t), decltype(dc)::value>(a, dq, dk, dv, out, st);
  }));
}

const char* sa_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
