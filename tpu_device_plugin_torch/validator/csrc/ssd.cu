// S1: Mamba-2's chunked selective scan (SSD) for Hopper (sm_90a), plain C
// entry points. For each sequence and head h (group g of B and C), with
// a = a[h] < 0 and S_-1 = 0:
//
//     S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T      (S: head dim x state)
//     y_t = S_t C_t + D[h] x_t
//
// Replaces no TPU kernel: the JAX package has no state-space layer. The
// port's `mamba` mixer (Granite-4.0-H's Mamba-2 layers, `ssd.py`) brought
// it. Plain PyTorch does not fit there: the published chunked form builds
// a (b, chunks, l, l, heads) decay tensor and reads it several times.
//
// The algorithm is Mamba-2's chunked one (arXiv:2405.21060, section 6),
// in chunks of kQ = 64 tokens, with cum the running sum of dt a inside a
// chunk:
//   - inside a chunk, y_diag = M x, M[t][s] = exp(cum_t - cum_s) dt_s
//     (C_t . B_s) for s <= t;
//   - across chunks, the f32 state S passed in sequence, y_off[t] =
//     exp(cum_t) S_prev C_t, and S_end = exp(cum_end) S_prev + sum_s
//     exp(cum_end - cum_s) dt_s x_s B_s^T.
// The published chunk is 256. The chunk changes the roundings, not the
// result; 64 keeps a chunk's tiles (C, B at 64 x 128, M at 64 x 64) in
// shared memory beside the state at two blocks an SM, and one warp's
// 16-row strip of every product in registers.
//
// What bounds it: at chunk 64 a token costs some 4.2 MFLOP forward against
// ~34 bytes, above the H100's ~295 FLOP/byte ridge, so the tensor cores;
// but the chunks of a head follow each other, so latency too. Products
// run on the tensor cores (mma.sync m16n8k16: bf16 operands, f32 sums).
// The decays and the states passed between chunks stay f32; M, the state
// read by C and x dt exp(..) are rounded to bf16 as operands.
//
// - ssd_fwd_kernel, a block a (head-dim half, head, sequence), walks the
//   chunks in order, the state in registers, and writes y; it saves the
//   f32 state entering each chunk where `states` is given (training).
// - ssd_bwd_state_kernel walks the chunks backwards and saves R_c, the
//   gradient of the state leaving chunk c (f32, as `states`): R_{c-1} =
//   exp(cum_end) R_c + sum_t exp(cum_t) dy_t C_t^T.
// - ssd_bwd_chunk_kernel, a block a (chunk, sequence), takes the heads in
//   order and computes each one's dx, d dt and the parts of da and dD from
//   the chunk's saved S_prev and R_c; it sums dB and dC over the heads of
//   a group in registers and writes them once. No atomics: two runs give
//   the same bits.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kQ = 64;           // chunk length
constexpr int kP = 64;           // head dim
constexpr int kN = 128;          // state size
constexpr int kPt = 32;          // head dims a forward or state block holds
constexpr int kLdN = kN + 8;     // shared rows, padded (bf16 elements):
constexpr int kLdQ = kQ + 8;     // rows 4 banks apart
constexpr int kLdP = kP + 8;
constexpr int kFwdThreads = 128;
constexpr int kChunkThreads = 256;

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// two bf16 values S elements apart, the first in the low half
template <int S>
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  if constexpr (S == 1) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else {
    return pack_bf16(p[0], p[S]);
  }
}

// A operand (16 x 16) of A(m, k) = a[m * AM + k * AK] at (m0, k0)
template <int AM, int AK>
__device__ __forceinline__ void load_a(const bf16* a, int m0, int k0,
                                       uint32_t (&f)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const bf16* p = a + (m0 + g) * AM + (k0 + 2 * c) * AK;
  f[0] = ld_pair<AK>(p);
  f[1] = ld_pair<AK>(p + 8 * AM);
  f[2] = ld_pair<AK>(p + 8 * AK);
  f[3] = ld_pair<AK>(p + 8 * AM + 8 * AK);
}

// B operand (16 x 8) of B(k, n) = b[k * BK + n * BN] at (k0, n0)
template <int BK, int BN>
__device__ __forceinline__ void load_b(const bf16* b, int k0, int n0,
                                       uint32_t (&f)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const bf16* p = b + (k0 + 2 * c) * BK + (n0 + g) * BN;
  f[0] = ld_pair<BK>(p);
  f[1] = ld_pair<BK>(p + 8 * BK);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: acc[i][j] += A(m0 + 16 i .., k) B(k, n0 + 8 j ..), k < K. The
// element r of acc[i][j] is at row m0 + 16 i + lane / 4 + 8 (r / 2) and
// column n0 + 8 j + 2 (lane % 4) + r % 2.
template <int MT, int NT, int K, int AM, int AK, int BK, int BN>
__device__ __forceinline__ void gemm(const bf16* a, int m0, const bf16* b,
                                     int n0, float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[MT][4], bf[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) load_a<AM, AK>(a, m0 + 16 * i, k0, af[i]);
#pragma unroll
    for (int j = 0; j < NT; ++j) load_b<BK, BN>(b, k0, n0 + 8 * j, bf[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(acc[i][j], af[i], bf[j]);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

// the row and column within a warp's tile of element r of fragment (i, j)
__device__ __forceinline__ int frag_row(int i, int r) {
  return 16 * i + ((threadIdx.x & 31) >> 2) + 8 * (r >> 1);
}
__device__ __forceinline__ int frag_col(int j, int r) {
  return 8 * j + 2 * (threadIdx.x & 3) + (r & 1);
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// rows [0, kQ) of width W (bf16) into dst (row stride LD), source rows
// `stride` elements apart; rows past `valid` are 0
template <int W, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int valid) {
  for (int i = threadIdx.x; i < kQ * (W / 8); i += blockDim.x) {
    const int r = i / (W / 8), v = i % (W / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = load16(src + r * stride + v * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + v * 8) = val;
  }
}

// rows [0, kQ) of width W (bf16) transposed into dst[col][row] (row stride
// kLdQ); rows past `valid` are 0
template <int W>
__device__ __forceinline__ void load_rows_t(bf16* dst, const bf16* src,
                                            long long stride, int valid) {
  for (int i = threadIdx.x; i < kQ * (W / 8); i += blockDim.x) {
    const int r = i / (W / 8), v = i % (W / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = load16(src + r * stride + v * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[(v * 8 + k) * kLdQ + r] = e[k];
  }
}

// dt (rows past `valid` 0) and cum, the running sum of dt a in order
__device__ __forceinline__ void load_dt(float* dts, float* cum,
                                        const float* dt, long long row0,
                                        int H, int h, int valid, float a) {
  if (threadIdx.x < kQ)
    dts[threadIdx.x] =
        threadIdx.x < valid ? dt[(row0 + threadIdx.x) * H + h] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int t = 0; t < kQ; ++t) {
      run = __fadd_rn(run, __fmul_rn(dts[t], a));
      cum[t] = run;
    }
  }
  __syncthreads();
}

struct FwdSmem {
  bf16 b[kQ * kLdN];      // B (t, n)
  bf16 c[kQ * kLdN];      // C (t, n)
  bf16 xt[kPt * kLdQ];    // x (p, t)
  bf16 xw[kPt * kLdQ];    // x dt exp(cum_end - cum) (p, t)
  bf16 m[kQ * kLdQ];      // M (t, s)
  bf16 s[kPt * kLdN];     // the state entering the chunk (p, n)
  float cum[kQ];
  float dt[kQ];
};

// grid (kP / kPt, H, batch), kFwdThreads threads
__global__ void __launch_bounds__(kFwdThreads)
ssd_fwd_kernel(const bf16* __restrict__ x, long long x_t,
               const float* __restrict__ dt, const float* __restrict__ a,
               const bf16* __restrict__ bm, long long b_t,
               const bf16* __restrict__ cm, long long c_t,
               const float* __restrict__ dskip, bf16* __restrict__ y,
               float* __restrict__ states, int S, int H, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int p0 = blockIdx.x * kPt, h = blockIdx.y, bi = blockIdx.z;
  const int gi = h / (H / G), warp = threadIdx.x >> 5;
  const float ah = a[h], dh = dskip[h];
  const int nc = (S + kQ - 1) / kQ;
  float st[2][4][4];   // the state: rows p, columns n = 32 warp + ..
  zero(st);
  for (int i = threadIdx.x; i < kPt * kLdN; i += kFwdThreads)
    sm.s[i] = __float2bfloat16_rn(0.f);

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kQ, valid = min(kQ, S - t0);
    const long long row0 = static_cast<long long>(bi) * S + t0;
    __syncthreads();
    load_rows<kN, kLdN>(sm.b, bm + row0 * b_t + gi * kN, b_t, valid);
    load_rows<kN, kLdN>(sm.c, cm + row0 * c_t + gi * kN, c_t, valid);
    load_rows_t<kPt>(sm.xt, x + row0 * x_t + h * kP + p0, x_t, valid);
    load_dt(sm.dt, sm.cum, dt, row0, H, h, valid, ah);
    const float cum_end = sm.cum[kQ - 1];

    {  // M = exp(cum_t - cum_s) dt_s (C B^T)[t][s], s <= t
      float g[1][8][4];
      zero(g);
      gemm<1, 8, kN, kLdN, 1, 1, kLdN>(sm.c, 16 * warp, sm.b, 0, g);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = 16 * warp + frag_row(0, r), s = frag_col(j, r);
          const float v = s <= t ? expf(sm.cum[t] - sm.cum[s]) * sm.dt[s] *
                                       g[0][j][r]
                                 : 0.f;
          sm.m[t * kLdQ + s] = __float2bfloat16_rn(v);
        }
    }
    for (int i = threadIdx.x; i < kPt * kQ; i += kFwdThreads) {
      const int p = i / kQ, s = i % kQ;
      const float w = expf(cum_end - sm.cum[s]) * sm.dt[s];
      sm.xw[p * kLdQ + s] =
          __float2bfloat16_rn(__bfloat162float(sm.xt[p * kLdQ + s]) * w);
    }
    __syncthreads();

    {  // y = exp(cum_t) C_t S_prev^T + M x + D x
      float acc[1][4][4];
      zero(acc);
      gemm<1, 4, kN, kLdN, 1, 1, kLdN>(sm.c, 16 * warp, sm.s, 0, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[0][j][r] *= expf(sm.cum[16 * warp + frag_row(0, r)]);
      gemm<1, 4, kQ, kLdQ, 1, 1, kLdQ>(sm.m, 16 * warp, sm.xt, 0, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = 16 * warp + frag_row(0, 2 * half);
          const int p = frag_col(j, 0);
          if (t < valid) {
            const float x0 = __bfloat162float(sm.xt[p * kLdQ + t]);
            const float x1 = __bfloat162float(sm.xt[(p + 1) * kLdQ + t]);
            *reinterpret_cast<uint32_t*>(
                y + (row0 + t) * H * kP + h * kP + p0 + p) =
                pack_f32(acc[0][j][2 * half] + dh * x0,
                         acc[0][j][2 * half + 1] + dh * x1);
          }
        }
    }
    __syncthreads();

    // the state entering this chunk, then the one leaving it
    if (states != nullptr) {
      float* out = states +
                   ((static_cast<long long>(bi) * nc + c) * H + h) * kP * kN;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = p0 + frag_row(i, 2 * half);
            const int n = 32 * warp + frag_col(j, 0);
            *reinterpret_cast<float2*>(out + p * kN + n) =
                make_float2(st[i][j][2 * half], st[i][j][2 * half + 1]);
          }
    }
    const float decay = expf(cum_end);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) st[i][j][r] *= decay;
    gemm<2, 4, kQ, kLdQ, 1, kLdN, 1>(sm.xw, 0, sm.b, 32 * warp, st);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = frag_row(i, 2 * half);
          const int n = 32 * warp + frag_col(j, 0);
          *reinterpret_cast<uint32_t*>(sm.s + p * kLdN + n) =
              pack_f32(st[i][j][2 * half], st[i][j][2 * half + 1]);
        }
  }
}

struct StateSmem {
  bf16 c[kQ * kLdN];      // C (t, n)
  bf16 dyw[kPt * kLdQ];   // dy exp(cum) (p, t)
  float cum[kQ];
  float dt[kQ];
};

// grid (kP / kPt, H, batch), kFwdThreads threads
__global__ void __launch_bounds__(kFwdThreads)
ssd_bwd_state_kernel(const float* __restrict__ dt,
                     const float* __restrict__ a,
                     const bf16* __restrict__ cm, long long c_t,
                     const bf16* __restrict__ dy,
                     float* __restrict__ rstates, int S, int H, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_raw);
  const int p0 = blockIdx.x * kPt, h = blockIdx.y, bi = blockIdx.z;
  const int gi = h / (H / G), warp = threadIdx.x >> 5;
  const float ah = a[h];
  const int nc = (S + kQ - 1) / kQ;
  float rs[2][4][4];   // R: rows p, columns n = 32 warp + ..
  zero(rs);

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kQ, valid = min(kQ, S - t0);
    const long long row0 = static_cast<long long>(bi) * S + t0;
    __syncthreads();
    load_rows<kN, kLdN>(sm.c, cm + row0 * c_t + gi * kN, c_t, valid);
    load_rows_t<kPt>(sm.dyw, dy + row0 * H * kP + h * kP + p0, H * kP,
                     valid);
    load_dt(sm.dt, sm.cum, dt, row0, H, h, valid, ah);
    for (int i = threadIdx.x; i < kPt * kQ; i += kFwdThreads) {
      const int p = i / kQ, t = i % kQ;
      bf16& e = sm.dyw[p * kLdQ + t];
      e = __float2bfloat16_rn(__bfloat162float(e) * expf(sm.cum[t]));
    }
    __syncthreads();
    float* out =
        rstates + ((static_cast<long long>(bi) * nc + c) * H + h) * kP * kN;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = p0 + frag_row(i, 2 * half);
          const int n = 32 * warp + frag_col(j, 0);
          *reinterpret_cast<float2*>(out + p * kN + n) =
              make_float2(rs[i][j][2 * half], rs[i][j][2 * half + 1]);
        }
    const float decay = expf(sm.cum[kQ - 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) rs[i][j][r] *= decay;
    gemm<2, 4, kQ, kLdQ, 1, kLdN, 1>(sm.dyw, 0, sm.c, 32 * warp, rs);
  }
}

struct ChunkSmem {
  bf16 b[kQ * kLdN];       // B (s, n)
  bf16 c[kQ * kLdN];       // C (t, n)
  float g[kQ * (kQ + 4)];  // C B^T (t, s), f32
  bf16 x[kQ * kLdP];       // x (s, p)
  bf16 dy[kQ * kLdP];      // dy (t, p)
  bf16 sp[kP * kLdN];      // the state entering the chunk (p, n)
  bf16 rc[kP * kLdN];      // the gradient of the state leaving it (p, n)
  bf16 w[kQ * kLdQ];       // exp(cum_t - cum_s) (C B^T)[t][s], s <= t
  bf16 m[kQ * kLdQ];       // exp(cum_t - cum_s) dt_s (dy_t . x_s), s <= t
  float cum[kQ], dt[kQ], dec[kQ], gk[kQ];
  float rowv[2][kQ], colv[4][kQ];          // V's sums by half and by strip
  float r1[2][kQ], r2[2][kQ], r3[2][kQ], r4[2][kQ];
  float red[kChunkThreads / 32];
};

// Sums v over the 4 lanes of a fragment row; the lane with column 0 of
// the quad writes it to dst[row].
__device__ __forceinline__ void row_sum(float v, float* dst, int row) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  if ((threadIdx.x & 3) == 0) dst[row] = v;
}

// Row sums of a (1, NT) fragment tile of f(r, c) into dst[m0 + row].
template <int NT, typename F>
__device__ __forceinline__ void tile_row_sums(F f, float* dst, int m0) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) v += f(j, 2 * half + e);
    row_sum(v, dst, m0 + frag_row(0, 2 * half));
  }
}

// grid (chunks, batch), kChunkThreads threads: warp w owns rows
// 16 (w % 4) .. and the column half w / 4 of each product
__global__ void __launch_bounds__(kChunkThreads, 1)
ssd_bwd_chunk_kernel(const bf16* __restrict__ x, long long x_t,
                     const float* __restrict__ dt,
                     const float* __restrict__ a,
                     const bf16* __restrict__ bm, long long b_t,
                     const bf16* __restrict__ cm, long long c_t,
                     const float* __restrict__ dskip,
                     const float* __restrict__ states,
                     const float* __restrict__ rstates,
                     const bf16* __restrict__ dy, bf16* __restrict__ dx,
                     float* __restrict__ ddt, bf16* __restrict__ db,
                     bf16* __restrict__ dc, float* __restrict__ da_part,
                     float* __restrict__ dd_part, int S, int H, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem& sm = *reinterpret_cast<ChunkSmem*>(smem_raw);
  const int c = blockIdx.x, bi = blockIdx.y, nc = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2, m0 = 16 * wm;
  const int t0 = c * kQ, valid = min(kQ, S - t0);
  const long long row0 = static_cast<long long>(bi) * S + t0;
  const int per_group = H / G;

  for (int gi = 0; gi < G; ++gi) {
    __syncthreads();
    load_rows<kN, kLdN>(sm.b, bm + row0 * b_t + gi * kN, b_t, valid);
    load_rows<kN, kLdN>(sm.c, cm + row0 * c_t + gi * kN, c_t, valid);
    __syncthreads();
    {
      float g[1][4][4];
      zero(g);
      gemm<1, 4, kN, kLdN, 1, 1, kLdN>(sm.c, m0, sm.b, 32 * wn, g);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sm.g[(m0 + frag_row(0, r)) * (kQ + 4) + 32 * wn + frag_col(j, r)] =
              g[0][j][r];
    }
    float acc_db[1][8][4], acc_dc[1][8][4];
    zero(acc_db);
    zero(acc_dc);

    for (int h = gi * per_group; h < (gi + 1) * per_group; ++h) {
      const float ah = a[h], dh = dskip[h];
      __syncthreads();
      load_rows<kP, kLdP>(sm.x, x + row0 * x_t + h * kP, x_t, valid);
      load_rows<kP, kLdP>(sm.dy, dy + row0 * H * kP + h * kP, H * kP,
                          valid);
      {  // S_prev and R_c to bf16, and their f32 dot
        const long long at =
            ((static_cast<long long>(bi) * nc + c) * H + h) * kP * kN;
        float dot = 0.f;
        for (int i = threadIdx.x; i < kP * kN / 4; i += kChunkThreads) {
          const int p = (4 * i) / kN, n = (4 * i) % kN;
          const float4 s4 = __ldg(reinterpret_cast<const float4*>(
              states + at + 4 * i));
          const float4 r4 = __ldg(reinterpret_cast<const float4*>(
              rstates + at + 4 * i));
          dot += s4.x * r4.x + s4.y * r4.y + s4.z * r4.z + s4.w * r4.w;
          uint2* sp = reinterpret_cast<uint2*>(sm.sp + p * kLdN + n);
          uint2* rp = reinterpret_cast<uint2*>(sm.rc + p * kLdN + n);
          *sp = make_uint2(pack_f32(s4.x, s4.y), pack_f32(s4.z, s4.w));
          *rp = make_uint2(pack_f32(r4.x, r4.y), pack_f32(r4.z, r4.w));
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (lane == 0) sm.red[warp] = dot;
      }
      load_dt(sm.dt, sm.cum, dt, row0, H, h, valid, ah);
      const float cum_end = sm.cum[kQ - 1];
      if (threadIdx.x < kQ)
        sm.dec[threadIdx.x] = expf(cum_end - sm.cum[threadIdx.x]);

      {  // dy x^T -> W, M and V = M (C B^T), V's row and column sums
        float yx[1][4][4];
        zero(yx);
        gemm<1, 4, kP, kLdP, 1, 1, kLdP>(sm.dy, m0, sm.x, 32 * wn, yx);
        float col[4][2] = {};
        float row[2] = {};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int t = m0 + frag_row(0, r), s = 32 * wn + frag_col(j, r);
            float wv = 0.f, mv = 0.f, v = 0.f;
            if (s <= t) {
              const float e = expf(sm.cum[t] - sm.cum[s]);
              const float gts = sm.g[t * (kQ + 4) + s];
              wv = e * gts;
              mv = e * sm.dt[s] * yx[0][j][r];
              v = mv * gts;
            }
            sm.w[t * kLdQ + s] = __float2bfloat16_rn(wv);
            sm.m[t * kLdQ + s] = __float2bfloat16_rn(mv);
            row[r >> 1] += v;
            col[j][r & 1] += v;
          }
#pragma unroll
        for (int half = 0; half < 2; ++half)
          row_sum(row[half], sm.rowv[wn], m0 + frag_row(0, 2 * half));
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = col[j][e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if ((lane >> 2) == 0) sm.colv[wm][32 * wn + frag_col(j, e)] = v;
          }
      }
      __syncthreads();

      {  // dxdt = dec (B R_c^T) + W^T dy; dx, and the row sums r1 .. r3
        float acc[1][4][4];
        zero(acc);
        gemm<1, 4, kN, kLdN, 1, 1, kLdN>(sm.b, m0, sm.rc, 32 * wn, acc);
        tile_row_sums<4>(
            [&](int j, int r) {
              return __bfloat162float(
                         sm.x[(m0 + frag_row(0, r)) * kLdP + 32 * wn +
                              frag_col(j, r)]) *
                     acc[0][j][r];
            },
            sm.r3[wn], m0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[0][j][r] *= sm.dec[m0 + frag_row(0, r)];
        gemm<1, 4, kQ, 1, kLdQ, kLdP, 1>(sm.w, m0, sm.dy, 32 * wn, acc);
        tile_row_sums<4>(
            [&](int j, int r) {
              return __bfloat162float(
                         sm.x[(m0 + frag_row(0, r)) * kLdP + 32 * wn +
                              frag_col(j, r)]) *
                     acc[0][j][r];
            },
            sm.r1[wn], m0);
        tile_row_sums<4>(
            [&](int j, int r) {
              const int at = (m0 + frag_row(0, r)) * kLdP + 32 * wn +
                             frag_col(j, r);
              return __bfloat162float(sm.x[at]) *
                     __bfloat162float(sm.dy[at]);
            },
            sm.r2[wn], m0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int s = m0 + frag_row(0, 2 * half);
            const int p = 32 * wn + frag_col(j, 0);
            if (s < valid) {
              const float d0 = __bfloat162float(sm.dy[s * kLdP + p]);
              const float d1 = __bfloat162float(sm.dy[s * kLdP + p + 1]);
              *reinterpret_cast<uint32_t*>(dx + (row0 + s) * H * kP +
                                           h * kP + p) =
                  pack_f32(sm.dt[s] * acc[0][j][2 * half] + dh * d0,
                           sm.dt[s] * acc[0][j][2 * half + 1] + dh * d1);
            }
          }
      }

      {  // dC += exp(cum_t) dy S_prev + M B; dB += dt dec x R_c + M^T C
        float tmp[1][8][4];
        zero(tmp);
        gemm<1, 8, kP, kLdP, 1, kLdN, 1>(sm.dy, m0, sm.sp, 64 * wn, tmp);
        tile_row_sums<8>(
            [&](int j, int r) {
              return __bfloat162float(
                         sm.c[(m0 + frag_row(0, r)) * kLdN + 64 * wn +
                              frag_col(j, r)]) *
                     tmp[0][j][r];
            },
            sm.r4[wn], m0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc_dc[0][j][r] += expf(sm.cum[m0 + frag_row(0, r)]) *
                               tmp[0][j][r];
        gemm<1, 8, kQ, kLdQ, 1, kLdN, 1>(sm.m, m0, sm.b, 64 * wn, acc_dc);
        zero(tmp);
        gemm<1, 8, kP, kLdP, 1, kLdN, 1>(sm.x, m0, sm.rc, 64 * wn, tmp);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int s = m0 + frag_row(0, r);
            acc_db[0][j][r] += sm.dt[s] * sm.dec[s] * tmp[0][j][r];
          }
        gemm<1, 8, kQ, 1, kLdQ, kLdN, 1>(sm.m, m0, sm.c, 64 * wn, acc_db);
      }
      __syncthreads();

      // d cum_k, then d(dt a) as its reverse running sum
      if (threadIdx.x < kQ) {
        const int k = threadIdx.x;
        sm.gk[k] = (sm.rowv[0][k] + sm.rowv[1][k]) -
                   (sm.colv[0][k] + sm.colv[1][k] + sm.colv[2][k] +
                    sm.colv[3][k]) +
                   expf(sm.cum[k]) * (sm.r4[0][k] + sm.r4[1][k]) -
                   sm.dt[k] * sm.dec[k] * (sm.r3[0][k] + sm.r3[1][k]);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float rsdot = 0.f, q = 0.f, da = 0.f, dd = 0.f, run = 0.f;
        for (int w = 0; w < kChunkThreads / 32; ++w) rsdot += sm.red[w];
        for (int s = 0; s < kQ; ++s)
          q += sm.dt[s] * sm.dec[s] * (sm.r3[0][s] + sm.r3[1][s]);
        sm.gk[kQ - 1] += expf(cum_end) * rsdot + q;
        for (int k = kQ - 1; k >= 0; --k) {
          run += sm.gk[k];
          sm.gk[k] = run;
          da += run * sm.dt[k];
          dd += sm.r2[0][k] + sm.r2[1][k];
        }
        const long long at = (static_cast<long long>(bi) * nc + c) * H + h;
        da_part[at] = da;
        dd_part[at] = dd;
      }
      __syncthreads();
      if (threadIdx.x < valid) {
        const int k = threadIdx.x;
        ddt[(row0 + k) * H + h] =
            sm.gk[k] * ah + (sm.r1[0][k] + sm.r1[1][k]);
      }
    }

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = m0 + frag_row(0, 2 * half);
        const int n = 64 * wn + frag_col(j, 0);
        if (t < valid) {
          const long long at = (row0 + t) * G * kN + gi * kN + n;
          *reinterpret_cast<uint32_t*>(db + at) =
              pack_f32(acc_db[0][j][2 * half], acc_db[0][j][2 * half + 1]);
          *reinterpret_cast<uint32_t*>(dc + at) =
              pack_f32(acc_dc[0][j][2 * half], acc_dc[0][j][2 * half + 1]);
        }
      }
  }
}

bool shape_ok(int B, int S, int H, int G) {
  return B > 0 && B <= 65535 && S > 0 && H > 0 && H <= 65535 && G > 0 &&
         H % G == 0 && (S + kQ - 1) / kQ <= 65535;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// x: bf16 (B, S, H, 64), token stride x_t (elements), heads dense; dt: f32
// (B, S, H) contiguous; a, dskip: f32 (H); bm, cm: bf16 (B, S, G, 128),
// token strides b_t, c_t, groups dense; y: bf16 (B, S, H, 64) contiguous,
// written; states: f32 (B, ceil(S / 64), H, 64, 128), the state entering
// each chunk, written, or null. Rows 16-byte aligned. Returns a
// cudaError_t (0: launched).
extern "C" int ssd_fwd(const void* x, long long x_t, const void* dt,
                       const void* a, const void* bm, long long b_t,
                       const void* cm, long long c_t, const void* dskip,
                       void* y, void* states, int B, int S, int H, int G,
                       void* stream) {
  if (!shape_ok(B, S, H, G)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ssd_fwd_kernel, sizeof(FwdSmem));
  if (err != cudaSuccess) return err;
  ssd_fwd_kernel<<<dim3(kP / kPt, H, B), kFwdThreads, sizeof(FwdSmem),
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), x_t, static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(bm), b_t,
      static_cast<const bf16*>(cm), c_t, static_cast<const float*>(dskip),
      static_cast<bf16*>(y), static_cast<float*>(states), S, H, G);
  return cudaGetLastError();
}

// As ssd_fwd for x .. dskip; states: ssd_fwd's; dy: bf16 (B, S, H, 64)
// contiguous; rstates: f32 scratch of states' shape; dx: bf16 (B, S, H,
// 64), ddt: f32 (B, S, H), db, dc: bf16 (B, S, G, 128), all contiguous and
// written whole; da_part, dd_part: f32 (B, ceil(S / 64), H), each chunk's
// part of da and dD, written.
extern "C" int ssd_bwd(const void* x, long long x_t, const void* dt,
                       const void* a, const void* bm, long long b_t,
                       const void* cm, long long c_t, const void* dskip,
                       const void* states, const void* dy, void* rstates,
                       void* dx, void* ddt, void* db, void* dc,
                       void* da_part, void* dd_part, int B, int S, int H,
                       int G, void* stream) {
  if (!shape_ok(B, S, H, G)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(ssd_bwd_state_kernel, sizeof(StateSmem));
  if (err != cudaSuccess) return err;
  err = allow_smem(ssd_bwd_chunk_kernel, sizeof(ChunkSmem));
  if (err != cudaSuccess) return err;
  ssd_bwd_state_kernel<<<dim3(kP / kPt, H, B), kFwdThreads,
                         sizeof(StateSmem), st>>>(
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const bf16*>(cm), c_t, static_cast<const bf16*>(dy),
      static_cast<float*>(rstates), S, H, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<<<dim3((S + kQ - 1) / kQ, B), kChunkThreads,
                         sizeof(ChunkSmem), st>>>(
      static_cast<const bf16*>(x), x_t, static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(bm), b_t,
      static_cast<const bf16*>(cm), c_t, static_cast<const float*>(dskip),
      static_cast<const float*>(states), static_cast<const float*>(rstates),
      static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
      static_cast<float*>(ddt), static_cast<bf16*>(db),
      static_cast<bf16*>(dc), static_cast<float*>(da_part),
      static_cast<float*>(dd_part), S, H, G);
  return cudaGetLastError();
}
