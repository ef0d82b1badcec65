// Flash-attention forward for Hopper (sm_90a), plain C entry point.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (tpu_device_plugin/validator/flash_attention.py:61, launched by `_flash_3d`
// at :125). Computes causal or full softmax(Q K^T * scale) V over contiguous
// (hb, seq, d) tensors with the online-softmax recurrence, so the (seq, seq)
// score matrix never reaches device memory, and optionally writes the
// per-row logsumexp lse = m + log(l) as f32 (hb, seq).
//
// What bounds it on this card: at the serving shape (hb 128, seq 2048,
// d 128, bf16, causal) the work is ~0.14 TFLOP against ~0.27 GB of
// traffic, ~500 FLOP/byte, far above the H100's ~295 FLOP/byte ridge: it
// is bound by operations, which only the tensor cores (wgmma) reach.
//
// Two designs, chosen by dtype at compile time:
//
// bf16 (flash_fwd_wgmma_kernel, every head dim 16-128): tensor cores.
// - One block per (128-row query tile, hb), heavy causal tiles first: two
//   consumer warpgroups of 64 query rows each and one producer warpgroup
//   whose single thread keeps TMA loads of 128-key K and V tiles in flight
//   through a two-stage ring of mbarriers (full: bytes landed; empty: all
//   8 consumer warps are done with the stage). setmaxnreg moves registers
//   from the producer (24) to the consumers (240).
// - S = Q K^T is a wgmma SS product (Q resident in shared memory, both
//   K-major); the online softmax runs on the accumulator fragment, each
//   row's max and sum reduced over its quad with two shuffles; exp2 with
//   the scale folded into log2 units.
// - P is rounded to bf16 in registers and is the A operand of O += P V, a
//   wgmma RS product with V read MN-major: P never touches shared memory.
//   The rounding is the JAX kernel's (p.astype(v.dtype), :111), and the
//   plain version (`flash_attention_plain`) rounds the same P, key tile by
//   key tile of 128.
// - Key tiles above the diagonal are skipped; only the last tile of a
//   block (the diagonal one, or the one holding `seq`) is masked. TMA
//   fills rows past `seq` with zeros; stores are masked at `seq`.
// - Tiles are bf16 in shared memory, swizzled by TMA (sm90.cuh): 160 KB
//   at d 128, one block per SM.
//
// Latent attention (MLA) at head dims (192, 128): q and k have the
// query/key head dim (192), v and o the value head dim (128); the kernel
// takes them as two template dims, and every other instance is the same
// code at DQK = DV. S = Q K^T reduces over 12 k-steps, O += P V is an
// m64n128 product as at d 128, so the accumulators take the registers
// they take at d 128 (ptxas keeps 16 bytes of spill stores, outside the
// products: no wgmma serialized). Tiles: Q 48 KB, two stages of K and V
// 48 + 32 KB each: 208 KB of shared memory.
//
// f32 (flash_fwd_kernel, the first, scalar design; exact): f32 tiles in
// shared memory and scalar f32 FMAs with a 4x4 register tile per thread.
// On the tensor cores f32 would mean TF32, which the f32 bar refuses. The
// main path never runs it.
//
// Shared by both, against the TPU version:
// - The TPU grid walks key blocks as a sequential third axis and carries
//   m, l and the accumulator in VMEM scratch between steps. Hopper blocks
//   run in parallel with no carried state, so one block owns one
//   (query tile, hb) pair and loops over key tiles up to the diagonal,
//   keeping m, l and the accumulator in registers.
// - The TPU kernel's 128-lane replicated lse is a VMEM layout artifact;
//   here lse is one f32 per row.
// - Pallas pads ragged tails with garbage; here padded K/V/Q rows load as
//   zero, padded key columns get NEG_INF, padded query rows are never
//   stored.
// - NEG_INF stays finite (-1e30): a row that has seen only masked columns
//   must get exp(m_prev - m_new) == 1, not NaN. Key tiles run in order from
//   0 and tile 0 always holds column 0, which every row may attend to, so
//   no row's normalizer picks up masked columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // key rows per tile
constexpr int NT = 256;        // threads: a 16 x 16 grid, 4 x 4 outputs each
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// --- f32: the scalar kernel ---------------------------------------------

// Row strides in floats. D + 4 keeps rows 16-byte aligned for float4 reads
// and puts the 8 rows a quarter-warp reads in 8 distinct bank groups.
template <int D> struct Smem {
  static constexpr int LD = D + 4;
  static constexpr int LP = BK + 4;
  static constexpr int FLOATS = BQ * LD + BK * LD + BK * D + BQ * LP;
  static constexpr size_t BYTES = sizeof(float) * FLOATS;
};

// Copies rows [r0, r0 + ROWS) of a (seq, D) slab into shared memory as f32
// with row stride `ld`; rows at or past `seq` are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int r0, int seq) {
  for (int e = threadIdx.x; e < ROWS * D; e += NT) {
    const int r = e / D, c = e % D;
    const int row = r0 + r;
    dst[r * ld + c] = row < seq ? to_f32(src[(size_t)row * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq, int causal, float scale) {
  using S = Smem<D>;
  constexpr int CD = D / 16;   // output columns per thread
  extern __shared__ float4 smem_f4[];
  float* sq = reinterpret_cast<float*>(smem_f4);   // BQ x LD
  float* sk = sq + BQ * S::LD;                      // BK x LD
  float* sv = sk + BK * S::LD;                      // BK x D
  float* sp = sv + BK * D;                          // BQ x LP

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;        // heavy tiles first
  const int q0 = qt * BQ;
  const size_t slab = (size_t)blockIdx.y * seq * D;
  q += slab; k += slab; v += slab; o += slab;

  load_tile<T, D, BQ>(sq, S::LD, q, q0, seq);

  // this thread owns query rows ty + 16 i and output columns tx + 16 c
  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(seq, q0 + BQ) : seq;
  const int num_k = (k_end + BK - 1) / BK;
  for (int kt = 0; kt < num_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's readers are done with sk/sv/sp
    load_tile<T, D, BK>(sk, S::LD, k, k0, seq);
    load_tile<T, D, BK>(sv, D, v, k0, seq);
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, key columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sq[(ty + 16 * i) * S::LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(&sk[(tx + 16 * j) * S::LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // online softmax; a row's 64 columns live on the 16 lanes sharing ty,
    // which are one half of a warp, so xor-shuffles over 8..1 reduce a row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < seq && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(ty + 16 * i) * S::LP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(&sp[(ty + 16 * i) * S::LP + j]);
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float v0 = sv[(j + 0) * D + tx + 16 * c];
        const float v1 = sv[(j + 1) * D + tx + 16 * c];
        const float v2 = sv[(j + 2) * D + tx + 16 * c];
        const float v3 = sv[(j + 3) * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[i][c];
          a = fmaf(p[i].x, v0, a);
          a = fmaf(p[i].y, v1, a);
          a = fmaf(p[i].z, v2, a);
          a = fmaf(p[i].w, v3, a);
          acc[i][c] = a;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < CD; ++c)
      o[(size_t)row * D + tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
    if (lse != nullptr && tx == 0)
      lse[(size_t)blockIdx.y * seq + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int hb, int seq, int causal, float scale,
                   cudaStream_t stream) {
  const size_t bytes = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + BQ - 1) / BQ, hb);
  flash_fwd_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      seq, causal, scale);
  return cudaGetLastError();
}

// --- bf16: the tensor-core kernel ---------------------------------------

constexpr int TC_BQ = 128;              // query rows per block: 64 per consumer warpgroup
constexpr int TC_BK = 128;              // key rows per tile
constexpr int TC_STAGES = 2;            // K/V ring depth
constexpr int TC_THREADS = 384;         // consumer warpgroups 0 and 1, producer 2
constexpr int TC_CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// DQK: the query/key head dim, DV: the value head dim (equal but in latent
// attention)
template <int DQK, int DV> struct FwdSmem {
  using QT = sm90::Tile<TC_BQ, DQK>;
  using KT = sm90::Tile<TC_BK, DQK>;
  using VT = sm90::Tile<TC_BK, DV>;
  static constexpr int K_OFF = QT::BYTES;
  static constexpr int V_OFF = K_OFF + TC_STAGES * KT::BYTES;
  static constexpr int BAR_OFF = V_OFF + TC_STAGES * VT::BYTES;
  // q_full, full[TC_STAGES], empty[TC_STAGES]
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * TC_STAGES) + sm90::SMEM_ALIGN;
};

template <int DQK, int DV>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int seq, int causal, float scale_log2) {
  using L = FwdSmem<DQK, DV>;
  using QT = typename L::QT;
  using KT = typename L::KT;
  using VT = typename L::VT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::aligned_smem(smem_raw);
  uint8_t* sq = smem;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + TC_STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;   // heavy tiles first
  const int hb = blockIdx.y;
  const int k_end = causal ? min(seq, q0 + TC_BQ) : seq;
  const int num_k = (k_end + TC_BK - 1) / TC_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], TC_CONSUMER_WARPS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load
    sm90::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      sm90::mbar_arrive_expect_tx(q_full, QT::BYTES);
      for (int b = 0; b < QT::BOXES; ++b)
        sm90::tma_load_3d(sq + b * QT::BOX_BYTES, &mq, q_full, b * QT::W, q0, hb);
      for (int kt = 0; kt < num_k; ++kt) {
        const int s = kt % TC_STAGES;
        sm90::mbar_wait(&empty[s], ((kt / TC_STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], KT::BYTES + VT::BYTES);
        uint8_t* sk = smem + L::K_OFF + s * KT::BYTES;
        uint8_t* sv = smem + L::V_OFF + s * VT::BYTES;
        for (int b = 0; b < KT::BOXES; ++b)
          sm90::tma_load_3d(sk + b * KT::BOX_BYTES, &mk, &full[s], b * KT::W,
                            kt * TC_BK, hb);
        for (int b = 0; b < VT::BOXES; ++b)
          sm90::tma_load_3d(sv + b * VT::BOX_BYTES, &mv, &full[s], b * VT::W,
                            kt * TC_BK, hb);
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64);
    // this thread rows r0 and r0 + 8 (the accumulator layout, sm90.cuh)
    sm90::regs_alloc<240>();
    const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
    const int r0 = q0 + 64 * wg + 16 * w + l / 4;
    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};     // running max, log2 units
    float lsum[2] = {0.f, 0.f};          // this thread's part of the row sum

    const uint64_t q_desc = QT::kmajor(sq);
    sm90::mbar_wait(q_full, 0);
    for (int kt = 0; kt < num_k; ++kt) {
      const int s = kt % TC_STAGES;
      const uint8_t* sk = smem + L::K_OFF + s * KT::BYTES;
      const uint8_t* sv = smem + L::V_OFF + s * VT::BYTES;
      sm90::mbar_wait(&full[s], (kt / TC_STAGES) & 1);

      // S = Q K^T over this warpgroup's 64 rows and the tile's 128 keys
      float sc[TC_BK / 2];
#pragma unroll
      for (int i = 0; i < TC_BK / 2; ++i) sc[i] = 0.f;
      const uint64_t qd = sm90::opaque(q_desc), kd = sm90::opaque(KT::kmajor(sk));
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        sm90::Wgmma<TC_BK>::ss(sc, QT::kmajor_at(qd, 64 * wg, kk),
                               KT::kmajor_at(kd, 0, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // online softmax on the fragment; only the last tile needs the mask
      const int k0 = kt * TC_BK;
      const bool edge = kt == num_k - 1;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < TC_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * (l % 4) + (e & 1);
          const int row = r0 + 8 * (e >> 1);
          float x = sc[4 * j + e] * scale_log2;
          if (edge && (col >= seq || (causal && col > row))) x = NEG_INF;
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < TC_BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[4 * j + e] - m[e >> 1]);
          sc[4 * j + e] = p;
          rs[e >> 1] += p;
        }
      // P as bf16 A fragments: neighbouring columns paired, no transpose
      uint32_t pa[TC_BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = sm90::pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) lsum[h] = alpha[h] * lsum[h] + rs[h];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V, V read MN-major
      const uint64_t vd = sm90::opaque(VT::mnmajor(sv));
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk)
        sm90::Wgmma<DV>::rs(acc, pa[kk], VT::mnmajor_at(vd, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pa);
      if (l == 0) sm90::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
      const int row = r0 + 8 * h;
      if (row >= seq) continue;
      const float inv = 1.f / lsum[h];
      __nv_bfloat16* orow = o + ((size_t)hb * seq + row) * DV + 2 * (l % 4);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) = sm90::pack_bf16(
            acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      if (lse != nullptr && l % 4 == 0)
        lse[(size_t)hb * seq + row] = m[h] * LN2 + logf(lsum[h]);
    }
  }
}

template <int DQK, int DV>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         void* lse, int hb, int seq, int causal, float scale,
                         cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = sm90::tile_map<TC_BQ, DQK>(&mq, q, hb, seq);
  if (err == cudaSuccess) err = sm90::tile_map<TC_BK, DQK>(&mk, k, hb, seq);
  if (err == cudaSuccess) err = sm90::tile_map<TC_BK, DV>(&mv, v, hb, seq);
  if (err != cudaSuccess) return err;
  if (reinterpret_cast<uintptr_t>(o) % 4 != 0) return cudaErrorMisalignedAddress;
  const int bytes = FwdSmem<DQK, DV>::BYTES;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DQK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + TC_BQ - 1) / TC_BQ, hb);
  flash_fwd_wgmma_kernel<DQK, DV><<<grid, TC_THREADS, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      seq, causal, scale * LOG2E);
  return cudaGetLastError();
}

// the scalar kernel for f32, the tensor-core kernel for bf16
template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     void* lse, int hb, int seq, int causal, float scale,
                     cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return launch_wgmma<D, D>(q, k, v, o, lse, hb, seq, causal, scale, stream);
  else
    return launch<T, D>(q, k, v, o, lse, hb, seq, causal, scale, stream);
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int hb, int seq, int d, int dv, int causal,
                       float scale, cudaStream_t stream) {
  if (dv != d) {
    // latent attention's pair, on the tensor cores only
    if constexpr (std::is_same_v<T, __nv_bfloat16>)
      if (d == 192 && dv == 128)
        return launch_wgmma<192, 128>(q, k, v, o, lse, hb, seq, causal, scale,
                                      stream);
    return cudaErrorInvalidValue;
  }
  switch (d) {
    case 16: return launch_d<T, 16>(q, k, v, o, lse, hb, seq, causal, scale, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, lse, hb, seq, causal, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, lse, hb, seq, causal, scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, lse, hb, seq, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// d: the head dim of q and k, dv: that of v and o (d, or (192, 128) in
// bf16). dtype: 0 = float32, 1 = bfloat16. lse may be null. Returns the
// launch's cudaGetLastError() (0 on success), or the error of making the
// bf16 kernel's tensor maps (inputs must be 16-byte aligned); the kernel
// runs on `stream`, unsynced.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int hb, int seq, int d, int dv, int dtype,
                         int causal, float scale, void* stream) {
  if (hb <= 0 || hb > 65535 || seq <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, lse, hb, seq, d, dv, causal, scale, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, hb, seq, d, dv, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
