// Tensor-core tile code for every bf16 and f16 attention kernel of this
// directory, written for Hopper (sm_90a): the two-pass forward and the
// recompute backward (simple_attention.cu, which qblock_attention launches
// too), causal_attention.cu's forward and lse backward, and blocked_flash.cu's
// online forward and lse backward.
//
// What bounds these kernels on this card: operations. A forward needs 2
// products of Sq x Skv x D per (batch, head) and a backward 5 (the lse
// backward's dq launch 3, its dk/dv launch 4). At the paths' shapes and the
// card's peaks those take 1.2-5x the time the HBM needs for the bytes, but
// for the S=1024 forward, whose bytes take 1.15x its products; and the
// products these kernels do put every one on the side of operations. Their
// first versions (attention_tiles.cuh, lse_backward.cuh) did every product as
// f32 FMA on the CUDA cores, fed from f32 tiles in shared memory, at 1-2 % of
// the bound.
//
// What this design does about it:
//   - Q, K, V and dO tiles stay in shared memory in the input dtype, at a row
//     pitch of D + 8 elements: eight consecutive rows start 16 bytes apart
//     modulo 128, so every ldmatrix below is free of bank conflicts.
//   - Tiles are copied with 16-byte cp.async.cg, and the tile that the inner
//     loop streams is double-buffered: tile t + 1 is in flight while tile t
//     is computed (commit_group / wait_group 1).
//   - Every product is mma.sync.m16n8k16 (bf16 or f16 operands, f32 sums)
//     with operands from ldmatrix; ldmatrix.trans reads the B operand of
//     P V, dS K, P^T dO and dS^T Q from row-major tiles.
//   - Each of the 4 warps owns 16 rows of the block's tile, so a row's max
//     and sum are two shuffles within a quad.
//   - P and dS never touch shared memory: the f32 accumulator fragment of S
//     (or dS) is rounded to bf16/f16 pairs and used as the A fragment of the
//     next mma (mma's C and A layouts agree). The dk/dv launch computes
//     S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T are A operands.
//   - Causal: kv tiles past the diagonal are skipped and only the tiles that
//     straddle it are masked.
//   - Both backwards share their launches: the dq launch writes the row
//     statistics lse and delta (f32 [B, H, Sq]) once per row, and the dk/dv
//     launch rebuilds P^T = exp(S^T - lse) from them. The lse backward reads
//     lse from the forward and sums delta = rowsum(dO * O) from the saved O,
//     so its dq launch makes one pass over the kv tiles; the recompute
//     backward's makes two: the first finds m, l and delta together (delta
//     summed against exp(s - m) with the running max, rescaled with it as l
//     is), the second forms dS and dq.
//
// The function, rounding point by rounding point. Scores are exact products
// of input-dtype operands summed in f32, times scale, then the causal mask at
// -1e30, as the references. Forward: p = exp(s - m) / l, rounded to the
// input dtype before P V, which is the references' rounding
// (paddle_tpu/ops/pallas/simple_attention.py:48) and what an mma operand
// needs; blocked_flash's online forward rounds its unnormalized p instead,
// as its reference (blocked_flash.cu). Backward: P = exp(s - lse) in f32 and
// delta in f32, as the references; the operands of dV = P^T dO, dQ = dS K
// and dK = dS^T Q are P and dS ROUNDED TO THE INPUT DTYPE, with f32 sums.
// That rounding is the one point where these kernels differ from the
// references, which multiply P and dS in f32; tests/test_torch_mma_rounding.py
// holds it against the references on the CPU, the recompute and the lse
// backward alike. exp is the fast hardware exp (ex2.approx), and 1/l a
// reciprocal, which differ from expf and a division in the last f32 bits
// only; the recompute backward's P = exp(s - (m + log l)) differs from
// exp(s - m) / l in the same bits.
//
// f32 inputs stay on the CUDA-core kernels of attention_tiles.cuh,
// lse_backward.cuh and blocked_flash.cu: tensor cores would need TF32, about
// three decimal digits, against the f32 checks' 1e-4. The choice is made by
// dtype at compile time in the launchers, inside by_dtype's instantiations;
// it is never a path taken on error.
//
// Tiles: forward and dq blocks own 64 q rows and stream kv tiles of 64 rows
// (32 at D=256, for the registers of the 16 x 256 f32 accumulator). A dk/dv
// block owns 64 kv rows and streams q tiles of 64 at D=64 and of 32 above
// (at D=128 a warp holds two 16 x 128 f32 accumulators; 64-row q tiles
// spilled there and were 2.5 % slower on an H100); at D=256 two warps share
// 16 kv rows, each with half of the dk/dv columns, so a block owns 32 kv
// rows. Sequence lengths are multiples of 64.
//
// What it leaves for later: wgmma (a warpgroup's 64-row products with B read
// from shared memory by the tensor cores themselves), TMA copies and
// warp-specialised producer and consumer warps, the design that reaches the
// card's full tensor-core rate; the Q and dO fragments are read again from
// shared memory for every kv tile rather than held in registers.
#pragma once

#include "attention_tiles.cuh"

namespace {

constexpr int kMmaThreads = 128;  // 4 warps

template <int D>
struct MmaCfg {
  static constexpr int LD = D + 8;               // shared pitch of a [rows][D] tile, elements
  static constexpr int BM = 64;                  // q rows of a forward or dq block
  static constexpr int BN = D > 128 ? 32 : 64;   // kv rows of a streamed tile (forward, dq)
  static constexpr int WD = D > 128 ? 2 : 1;     // dk/dv: warps that share 16 kv rows
  static constexpr int KN = 64 / WD;             // dk/dv: kv rows of a block
  static constexpr int BQ = D > 64 ? 32 : 64;    // dk/dv: q rows of a streamed tile
  static constexpr int DW = D / WD;              // dk/dv: columns of a warp's accumulators
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b for one m16n8k16 tile, f32 sums.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to the input dtype, lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Starts the copy of R rows (row stride ss elements) of D elements into
// shared memory at pitch LD, 16 bytes a thread at a time.
template <typename T, int D, int R>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, long long ss) {
  constexpr int V = 16 / sizeof(T), VPR = D / V, LD = MmaCfg<D>::LD;
  static_assert(R * VPR % kMmaThreads == 0, "whole 16-byte chunks per thread");
#pragma unroll
  for (int j = 0; j < R * VPR / kMmaThreads; ++j) {
    const int i = threadIdx.x + j * kMmaThreads;
    const int r = i / VPR, c = (i % VPR) * V;
    cp_async16(dst + r * LD + c, src + r * ss + c);
  }
}

// Fragment coordinates (mma's C layout): element e of n8 tile j of a warp's
// 16 x N accumulator lies at row (lane / 4) + 8 (e / 2), column
// 8 j + 2 (lane % 4) + e % 2.

// c[j] = A B^T for one warp: A the 16 rows at sA, B the N rows at sB, both
// [rows][D] tiles at pitch LD in shared memory.
template <typename T, int D, int N>
__device__ __forceinline__ void warp_abt(float (&c)[N / 8][4], const T* sA, const T* sB) {
  constexpr int LD = MmaCfg<D>::LD;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  // ldmatrix x4 row addresses: the A fragment's four 8 x 8 blocks
  // (rows 0-7 / 8-15, columns 0-7 / 8-15), and for B two n8 tiles' (b0, b1).
  const T* pa = sA + (lane & 15) * LD + (lane >> 4) * 8;
  const T* pb = sB + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, pa + kk * 16);
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, pb + j * 8 * LD + kk * 16);
      mma16816<T>(c[j], a, b[0], b[1]);
      mma16816<T>(c[j + 1], a, b[2], b[3]);
    }
  }
}

// c[j] += A B for one warp and one k16 step: A in registers, B the 16 rows at
// sB, W columns from there, a row-major tile at pitch LD in shared memory
// (ldmatrix.trans gives the col-major B fragments).
template <typename T, int LD, int W>
__device__ __forceinline__ void warp_ab(float (&c)[W / 8][4], const uint32_t (&a)[4], const T* sB) {
  const int lane = threadIdx.x % 32;
  const T* pb = sB + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < W / 8; j += 2) {
    uint32_t b[4];
    ldsm_x4_trans(b, pb + j * 8);
    mma16816<T>(c[j], a, b[0], b[1]);
    mma16816<T>(c[j + 1], a, b[2], b[3]);
  }
}

// The A fragment of k16 step kk from the f32 accumulator tiles 2 kk and
// 2 kk + 1, rounded to the input dtype.
template <typename T, int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack2<T>(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack2<T>(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack2<T>(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack2<T>(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// s = s * scale, then, when mask, -1e30 where the key index exceeds the query
// index: the reference's order. row0 and col0 index the warp's row 0 and
// column 0; TRANS when rows are keys and columns queries (dk/dv).
template <int N, bool TRANS>
__device__ __forceinline__ void scale_mask(float (&s)[N][4], float scale, bool mask, int row0,
                                           int col0) {
  const int lane = threadIdx.x % 32;
  const int r = row0 + (lane >> 2), c = col0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] *= scale;
      const int row = r + 8 * (e >> 1), col = c + 8 * j + (e & 1);
      if (mask && (TRANS ? col < row : col > row)) s[j][e] = kNegInf;
    }
}

// Stores a warp's 16 x W f32 accumulator, rounded to T, at rows row0.. and
// columns col0.. of dst (row stride ss).
template <typename T, int W>
__device__ __forceinline__ void store_rows(T* dst, long long ss, const float (&c)[W / 8][4],
                                           int row0, int col0) {
  const int lane = threadIdx.x % 32;
  const int r = row0 + (lane >> 2), col = col0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(dst + (r + 8 * i) * ss + col + 8 * j) =
          pack2<T>(c[j][2 * i], c[j][2 * i + 1]);
}

// Two-pass forward, one block per (q tile, head, batch), heaviest causal
// tiles first. Stage st < kend streams kv tile st's k (pass 1: m and l);
// stage kend + t streams tile t's k and v (pass 2: P V). When lse is not
// null it also writes lse = m + log l, [B, H, S] f32 contiguous.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
    mma_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, float* __restrict__ lse, Layout in, Layout out, int S,
                   float scale, int causal) {
  using C = MmaCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* sQ = reinterpret_cast<T*>(mma_smem);
  T* sK = sQ + BM * LD;      // two buffers of [BN][LD]
  T* sV = sK + 2 * BN * LD;  // two buffers of [BN][LD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qt = S / BM - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BM, r0 = warp * 16;
  const long long base = b * in.sb + h * in.sh;
  const int kend = causal ? (q0 + BM) / BN : S / BN;

  auto prefetch = [&](int st) {
    if (st < 2 * kend) {
      const int kt = st < kend ? st : st - kend;
      const long long off = base + static_cast<long long>(kt) * BN * in.ss;
      copy_tile<T, D, BN>(sK + (st & 1) * BN * LD, k + off, in.ss);
      if (st >= kend) copy_tile<T, D, BN>(sV + (st & 1) * BN * LD, v + off, in.ss);
    }
    cp_async_commit();
  };
  copy_tile<T, D, BM>(sQ, q + base + static_cast<long long>(q0) * in.ss, in.ss);
  prefetch(0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int st = 0; st < 2 * kend; ++st) {
    prefetch(st + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = (st < kend ? st : st - kend) * BN;
    const int buf = (st & 1) * BN * LD;
    float s[BN / 8][4];
    warp_abt<T, D, BN>(s, sQ + r0 * LD, sK + buf);
    scale_mask<BN / 8, false>(s, scale, causal && k0 + BN - 1 > q0 + r0, q0 + r0, k0);
    if (st < kend) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = s[0][2 * i];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        const float mn = fmaxf(m[i], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) sum += __expf(s[j][2 * i] - mn) + __expf(s[j][2 * i + 1] - mn);
        l[i] = l[i] * __expf(m[i] - mn) + quad_sum(sum);
        m[i] = mn;
      }
      if (st == kend - 1) {
        rl[0] = 1.f / l[0];
        rl[1] = 1.f / l[1];
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __expf(s[j][e] - m[e >> 1]) * rl[e >> 1];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[4];
        a_frag<T>(a, s, kk);
        warp_ab<T, LD, D>(acc, a, sV + buf + kk * 16 * LD);
      }
    }
    __syncthreads();
  }
  store_rows<T, D>(o + b * out.sb + h * out.sh, out.ss, acc, q0 + r0, 0);
  if (lse != nullptr && (lane & 3) == 0) {
    const long long row = (static_cast<long long>(b) * gridDim.y + h) * S + q0 + r0 + (lane >> 2);
    lse[row] = m[0] + logf(l[0]);
    lse[row + 8] = m[1] + logf(l[1]);
  }
}

// delta[i] = rowsum(x * y) of rows lane / 4 + 8 i of a warp's 16 rows at x
// and y (row strides xs, ys), in f32: each thread of a quad sums every
// fourth 16-byte chunk of the row, then the quad adds its four sums.
template <typename T, int D>
__device__ __forceinline__ void quad_row_dots(float (&delta)[2], const T* x, long long xs,
                                              const T* y, long long ys) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long r = (lane >> 2) + 8 * i;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < D / (4 * V); ++j) {
      const int c = ((lane & 3) + 4 * j) * V;
      const uint4 rx = *reinterpret_cast<const uint4*>(x + r * xs + c);
      const uint4 ry = *reinterpret_cast<const uint4*>(y + r * ys + c);
      const T* ex = reinterpret_cast<const T*>(&rx);
      const T* ey = reinterpret_cast<const T*>(&ry);
#pragma unroll
      for (int e = 0; e < V; ++e) part += to_f32(ex[e]) * to_f32(ey[e]);
    }
    delta[i] = quad_sum(part);
  }
}

// Backward launch A, one block per (q tile, head, batch), heaviest causal
// tiles first: dS = P (dP - delta) scale with P = exp(s - lse), and
// dq = dS K, over the kv tiles. LSE (the lse backward): lse is the
// forward's and delta = rowsum(dO * O) from the saved O, one pass.
// Otherwise (the recompute backward) a first pass finds m, l and
// delta = rowsum(dP * P) together and gives lse = m + log l. Writes dq,
// delta and, recomputing, lse, for launch B.
template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(kMmaThreads)
    mma_dq_kernel(BwdArgs a, T* __restrict__ dq, Layout ldq) {
  using C = MmaCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* sQ = reinterpret_cast<T*>(mma_smem);
  T* sDO = sQ + BM * LD;
  T* sK = sDO + BM * LD;     // two buffers of [BN][LD]
  T* sV = sK + 2 * BN * LD;  // two buffers of [BN][LD]
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qt = a.Sq / BM - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BM, r0 = warp * 16;
  const long long kvbase = b * a.lkv.sb + h * a.lkv.sh;
  const long long row = (static_cast<long long>(b) * a.H + h) * a.Sq + q0 + r0 + (lane >> 2);
  const int kend = a.causal ? (q0 + BM) / BN : a.Skv / BN;
  const int pass = LSE ? 0 : kend;  // stages of the statistics pass

  auto prefetch = [&](int st) {
    if (st < pass + kend) {
      const long long off = kvbase + static_cast<long long>(st < pass ? st : st - pass) * BN * a.lkv.ss;
      copy_tile<T, D, BN>(sK + (st & 1) * BN * LD, k + off, a.lkv.ss);
      copy_tile<T, D, BN>(sV + (st & 1) * BN * LD, v + off, a.lkv.ss);
    }
    cp_async_commit();
  };
  const T* g = static_cast<const T*>(a.dout) + b * a.lg.sb + h * a.lg.sh +
               static_cast<long long>(q0) * a.lg.ss;
  copy_tile<T, D, BM>(sQ, static_cast<const T*>(a.q) + b * a.lq.sb + h * a.lq.sh +
                              static_cast<long long>(q0) * a.lq.ss, a.lq.ss);
  copy_tile<T, D, BM>(sDO, g, a.lg.ss);
  prefetch(0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  if constexpr (LSE) {
    quad_row_dots<T, D>(delta, static_cast<const T*>(a.o) + b * a.lo.sb + h * a.lo.sh +
                                   static_cast<long long>(q0 + r0) * a.lo.ss, a.lo.ss,
                        g + r0 * a.lg.ss, a.lg.ss);
    lse[0] = a.lse[row];
    lse[1] = a.lse[row + 8];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int st = 0; st < pass + kend; ++st) {
    prefetch(st + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = (st < pass ? st : st - pass) * BN;
    const int buf = (st & 1) * BN * LD;
    float s[BN / 8][4], dp[BN / 8][4];
    warp_abt<T, D, BN>(s, sQ + r0 * LD, sK + buf);
    scale_mask<BN / 8, false>(s, a.scale, a.causal && k0 + BN - 1 > q0 + r0, q0 + r0, k0);
    warp_abt<T, D, BN>(dp, sDO + r0 * LD, sV + buf);
    if (st < pass) {
      // running m and l, and dd = sum dP exp(s - m) rescaled with them:
      // delta = dd / l once every tile is in.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = s[0][2 * i];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        const float mn = fmaxf(m[i], quad_max(mx));
        float se = 0.f, sd = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            const float p = __expf(s[j][e] - mn);
            se += p;
            sd += p * dp[j][e];
          }
        const float c = __expf(m[i] - mn);
        l[i] = l[i] * c + quad_sum(se);
        dd[i] = dd[i] * c + quad_sum(sd);
        m[i] = mn;
      }
      if (st == pass - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          lse[i] = m[i] + logf(l[i]);
          delta[i] = dd[i] / l[i];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          s[j][e] = __expf(s[j][e] - lse[i]) * (dp[j][e] - delta[i]) * a.scale;
        }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t af[4];
        a_frag<T>(af, s, kk);
        warp_ab<T, LD, D>(acc, af, sK + buf + kk * 16 * LD);
      }
    }
    __syncthreads();
  }
  store_rows<T, D>(dq + b * ldq.sb + h * ldq.sh, ldq.ss, acc, q0 + r0, 0);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!LSE) a.lse[row + 8 * i] = lse[i];
      a.delta[row + 8 * i] = delta[i];
    }
  }
}

// Backward launch B, one block per (kv tile, head, batch), low kv tiles (the
// most q tiles when causal) first: loops over the q tiles at and below the
// diagonal, rebuilds P^T = exp(S^T - lse) and reads delta from launch A, and
// accumulates dv = P^T dO and dk = dS^T Q in f32 registers.
template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
    mma_dkv_kernel(BwdArgs a, T* __restrict__ dk, T* __restrict__ dv, Layout ldkv) {
  using C = MmaCfg<D>;
  constexpr int KN = C::KN, BQ = C::BQ, LD = C::LD, DW = C::DW;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  T* sK = reinterpret_cast<T*>(mma_smem);
  T* sV = sK + KN * LD;
  T* sQ = sV + KN * LD;       // two buffers of [BQ][LD]
  T* sDO = sQ + 2 * BQ * LD;  // two buffers of [BQ][LD]
  float* sStat = reinterpret_cast<float*>(sDO + 2 * BQ * LD);  // two buffers of lse, delta [2][BQ]
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp / C::WD) * 16, c0 = (warp % C::WD) * DW;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * KN;
  const long long qbase = b * a.lq.sb + h * a.lq.sh, gbase = b * a.lg.sb + h * a.lg.sh;
  const long long kvbase = b * a.lkv.sb + h * a.lkv.sh;
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
  const int qbeg = a.causal ? k0 / BQ : 0, stages = a.Sq / BQ - qbeg;

  auto prefetch = [&](int st) {
    if (st < stages) {
      const int q0 = (qbeg + st) * BQ;
      copy_tile<T, D, BQ>(sQ + (st & 1) * BQ * LD, q + qbase + static_cast<long long>(q0) * a.lq.ss,
                          a.lq.ss);
      copy_tile<T, D, BQ>(sDO + (st & 1) * BQ * LD,
                          dout + gbase + static_cast<long long>(q0) * a.lg.ss, a.lg.ss);
      if (threadIdx.x < 2 * BQ / 4) {  // lse, delta of the tile's rows: 16 bytes a thread
        const int w = threadIdx.x / (BQ / 4), c = (threadIdx.x % (BQ / 4)) * 4;
        cp_async16(sStat + (st & 1) * 2 * BQ + w * BQ + c, (w == 0 ? a.lse : a.delta) + row0 + q0 + c);
      }
    }
    cp_async_commit();
  };
  copy_tile<T, D, KN>(sK, static_cast<const T*>(a.k) + kvbase + static_cast<long long>(k0) * a.lkv.ss,
                      a.lkv.ss);
  copy_tile<T, D, KN>(sV, static_cast<const T*>(a.v) + kvbase + static_cast<long long>(k0) * a.lkv.ss,
                      a.lkv.ss);
  prefetch(0);

  float acc_k[DW / 8][4], acc_v[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[j][e] = 0.f;
      acc_v[j][e] = 0.f;
    }
  const int fc = 2 * (lane & 3);
  for (int st = 0; st < stages; ++st) {
    prefetch(st + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qbeg + st) * BQ;
    const T* cQ = sQ + (st & 1) * BQ * LD;
    const T* cDO = sDO + (st & 1) * BQ * LD;
    const float* sm = sStat + (st & 1) * 2 * BQ;
    // P^T = exp(S^T - lse), S^T = K Q^T
    float p[BQ / 8][4];
    warp_abt<T, D, BQ>(p, sK + r0 * LD, cQ);
    scale_mask<BQ / 8, true>(p, a.scale, a.causal && q0 < k0 + r0 + 15, k0 + r0, q0);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = __expf(p[j][e] - sm[8 * j + fc + (e & 1)]);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t af[4];
      a_frag<T>(af, p, kk);
      warp_ab<T, LD, DW>(acc_v, af, cDO + kk * 16 * LD + c0);
    }
    // dS^T = P^T (dP^T - delta) scale, dP^T = V dO^T
    float ds[BQ / 8][4];
    warp_abt<T, D, BQ>(ds, sV + r0 * LD, cDO);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - sm[BQ + 8 * j + fc + (e & 1)]) * a.scale;
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t af[4];
      a_frag<T>(af, ds, kk);
      warp_ab<T, LD, DW>(acc_k, af, cQ + kk * 16 * LD + c0);
    }
    __syncthreads();
  }
  store_rows<T, DW>(dk + b * ldkv.sb + h * ldkv.sh, ldkv.ss, acc_k, k0 + r0, c0);
  store_rows<T, DW>(dv + b * ldkv.sb + h * ldkv.sh, ldkv.ss, acc_v, k0 + r0, c0);
}

template <typename T, int D>
constexpr size_t mma_fwd_smem() {
  return (MmaCfg<D>::BM + 4 * MmaCfg<D>::BN) * MmaCfg<D>::LD * sizeof(T);
}
template <typename T, int D>
constexpr size_t mma_dq_smem() {
  return (2 * MmaCfg<D>::BM + 4 * MmaCfg<D>::BN) * MmaCfg<D>::LD * sizeof(T);
}
template <typename T, int D>
constexpr size_t mma_dkv_smem() {
  return (2 * MmaCfg<D>::KN + 4 * MmaCfg<D>::BQ) * MmaCfg<D>::LD * sizeof(T) +
         2 * 2 * MmaCfg<D>::BQ * sizeof(float);
}

// The two-pass forward of attention_tiles.cuh's function: tensor cores for
// bf16 and f16, the CUDA-core template for f32 (by dtype, at compile time).
template <typename T, int D>
cudaError_t launch_two_pass_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                                Layout in, Layout out, int B, int H, int S, float scale,
                                int causal, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_fwd<T, D>(q, k, v, o, lse, in, out, B, H, S, scale, causal, st);
  } else {
    if (S % MmaCfg<D>::BM != 0) return cudaErrorInvalidValue;
    constexpr size_t smem = mma_fwd_smem<T, D>();
    cudaError_t e = allow_smem(mma_fwd_kernel<T, D>, smem);
    if (e != cudaSuccess) return e;
    mma_fwd_kernel<T, D><<<dim3(S / MmaCfg<D>::BM, H, B), kMmaThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, in, out, S, scale, causal);
    return cudaGetLastError();
  }
}

// Launch A on the tensor cores (bf16, f16): Sq a multiple of 64, Skv of
// 64 (of 32 at D=256), causal only with Sq == Skv.
template <typename T, int D, bool LSE>
cudaError_t launch_mma_dq(const BwdArgs& a, void* dq, Layout ldq, cudaStream_t st) {
  using C = MmaCfg<D>;
  if (a.Sq % C::BM != 0 || a.Skv % C::BN != 0 || (a.causal && a.Sq != a.Skv))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = mma_dq_smem<T, D>();
  cudaError_t e = allow_smem(mma_dq_kernel<T, D, LSE>, bytes);
  if (e != cudaSuccess) return e;
  mma_dq_kernel<T, D, LSE><<<dim3(a.Sq / C::BM, a.H, a.B), kMmaThreads, bytes, st>>>(
      a, static_cast<T*>(dq), ldq);
  return cudaGetLastError();
}

// Launch B on the tensor cores (bf16, f16), after launch A on one stream.
template <typename T, int D>
cudaError_t launch_mma_dkv(const BwdArgs& a, void* dk, void* dv, Layout ldkv, cudaStream_t st) {
  using C = MmaCfg<D>;
  if (a.Sq % C::BQ != 0 || a.Skv % C::KN != 0 || (a.causal && a.Sq != a.Skv))
    return cudaErrorInvalidValue;
  constexpr size_t bytes = mma_dkv_smem<T, D>();
  cudaError_t e = allow_smem(mma_dkv_kernel<T, D>, bytes);
  if (e != cudaSuccess) return e;
  mma_dkv_kernel<T, D><<<dim3(a.Skv / C::KN, a.H, a.B), kMmaThreads, bytes, st>>>(
      a, static_cast<T*>(dk), static_cast<T*>(dv), ldkv);
  return cudaGetLastError();
}

}  // namespace
