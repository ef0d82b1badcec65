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
// is bound by operations, and only the tensor cores (wgmma) reach the
// bound. This first version is deliberately simple and exact: f32 tiles in
// shared memory and scalar f32 FMAs with a 4x4 register tile per thread.
// It is far from the bound; tensor cores, TMA and pipelining come later.
//
// Design against the TPU version:
// - The TPU grid walks key blocks as a sequential third axis and carries
//   m, l and the accumulator in VMEM scratch between steps. Hopper blocks
//   run in parallel with no carried state, so one block owns one
//   (query tile, hb) pair and loops over key tiles up to the diagonal,
//   keeping m, l and the accumulator in registers.
// - The TPU kernel's 128-lane replicated lse is a VMEM layout artifact;
//   here lse is one f32 per row.
// - Pallas pads ragged tails with garbage; here every load and store is
//   masked at `seq` (padded K/V/Q rows load as zero, padded key columns get
//   NEG_INF, padded query rows are never stored).
// - NEG_INF stays finite (-1e30): a row that has seen only masked columns
//   must get exp(m_prev - m_new) == 1, not NaN. Key tiles run in order from
//   0 and tile 0 always holds column 0, which every row may attend to, so
//   no row's normalizer picks up masked columns.
// - Heavy causal query tiles (near the diagonal's end) launch first.
// - At d = 128 the tiles take ~118 KB of shared memory, past the 48 KB
//   static limit: dynamic shared memory, raised with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // key rows per tile
constexpr int NT = 256;        // threads: a 16 x 16 grid, 4 x 4 outputs each
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int hb, int seq, int d, int causal,
                       float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, hb, seq, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, hb, seq, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, hb, seq, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, hb, seq, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse may be null. Returns the launch's
// cudaGetLastError() (0 on success); the kernel runs on `stream`, unsynced.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int hb, int seq, int d, int dtype,
                         int causal, float scale, void* stream) {
  if (hb <= 0 || hb > 65535 || seq <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, lse, hb, seq, d, causal, scale, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, hb, seq, d, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
