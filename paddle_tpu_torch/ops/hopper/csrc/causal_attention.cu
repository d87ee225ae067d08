// Causal-skip attention for the S=2048 rung, forward and backward, written
// for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/causal_attention.py, the Pallas kernels
// `_fwd_kernel` (pl.pallas_call in `_fwd`) and `_bwd_kernel` (in `_bwd`).
// Same function: causal softmax attention with scores in f32, the normalized
// p rounded to the input dtype before PV, and lse = m + log l saved beside o;
// a backward from (q, k, v, o, lse) with p = exp(s - lse) in f32,
// delta = rowsum(dO * O) and dk, dv summed in f32.
//
// What bounds it on this card: operations. At the rung's shape (B4 H8 S2048
// D128, bf16) the forward needs ~34 GFLOP for the causal half and moves
// ~67 MB, the backward ~86 GFLOP and ~134 MB; on the tensor cores both are
// bound by operations.
//
// What the design does about it: the TPU kernel split q into nq static strips
// so that strip i scores only against kv[: (i+1) bq] and never computes the
// upper triangle. Here the same skip falls out of the tiling: every block owns
// one 64-row q tile and loops over the kv tiles up to the diagonal, masking
// only the tiles that straddle it. The forward is simple_attention's two-pass
// kernel with the lse output switched on; the backward is the lse pair of
// lse_backward.cuh, dq (which also writes delta = rowsum(dO * O), once per
// row) then dk/dv, two launches without atomics. Both run bf16 and f16 on
// the tensor cores (mma.sync, ldmatrix, cp.async; attention_mma.cuh) and f32
// as f32 FMA on the CUDA cores, chosen by dtype at compile time. The
// backward does 7 products where the function needs 5: the dk/dv launch
// recomputes S and dP. The strip count nq of the reference only gates which
// shapes this tier takes (the Python wrapper checks it).
//
// What it leaves for later: wgmma with TMA and warp specialisation for both
// (attention_mma.cuh).
//
// Interface: plain C, pointers as void*, strides in elements as a host array
// of (sb, sh, ss) triples; the head dim must be unit-stride, every row
// 16-byte aligned and lse [B, H, S] f32 contiguous (the Python wrapper
// checks). Each entry point returns cudaGetLastError() after its launches.

#include "lse_backward.cuh"

extern "C" {

// st: (sb, sh, ss) of q (k and v share it), then of o.
int ca_fwd(int dtype, int d, const void* q, const void* k, const void* v, void* o, void* lse,
           const long long* st, int B, int H, int S, float scale, void* stream) {
  auto cs = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype_and_d(dtype, d, [&](auto t, auto dc) {
    using T = decltype(t);
    constexpr int D = decltype(dc)::value;
    if constexpr (D == kWide)
      return launch_wide_fwd<T, false>(q, k, v, o, static_cast<float*>(lse), layout_at(st, 0),
                                       layout_at(st, 0), layout_at(st, 1), B, H, S, S, d, scale, 1,
                                       cs);
    else
      return launch_two_pass_fwd<T, D>(q, k, v, o, static_cast<float*>(lse), layout_at(st, 0),
                                       layout_at(st, 1), B, H, S, scale, 1, cs);
  }));
}

// st: (sb, sh, ss) of q, kv, o, dO, dq, then dk/dv. delta: f32 [B, H, S]
// scratch that the dq launch writes for the dk/dv launch.
int ca_bwd(int dtype, int d, const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv, void* delta,
           const long long* st, int B, int H, int S, float scale, void* stream) {
  auto cs = static_cast<cudaStream_t>(stream);
  const BwdArgs a{q, k, v, o, dout, static_cast<float*>(const_cast<void*>(lse)),
                  static_cast<float*>(delta), layout_at(st, 0), layout_at(st, 1),
                  layout_at(st, 2), layout_at(st, 3), B, H, S, S, scale, 1, d};
  return static_cast<int>(by_dtype_and_d(dtype, d, [&](auto t, auto dc) {
    using T = decltype(t);
    constexpr int D = decltype(dc)::value;
    cudaError_t e = launch_lse_dq<T, D>(a, dq, layout_at(st, 4), cs);
    if (e != cudaSuccess) return e;
    return launch_lse_dkv<T, D>(a, dk, dv, layout_at(st, 5), cs);
  }));
}

const char* ca_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
