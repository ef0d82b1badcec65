// Fused next-token NLL of bf16 logits for Hopper (sm_90a), plain C entry
// points: the training head's log-softmax, gather and sum, and its gradient.
//
// Replaces no TPU kernel. The JAX package writes the loss as
// `jax.nn.log_softmax(logits[:, :-1])` and a gather
// (tpu_device_plugin/validator/workload.py:328), which XLA fuses; PyTorch
// runs the same composition eagerly as separate passes over f32 copies of
// the logits (the cast, the slice's copy, log-softmax, the gather's
// zero-filled gradient, the cast's backward): some 100 GB a step at
// switch-base-8's head (128 x 512 x 32128), where the function needs 12.6.
//
// What bounds it on this card: bytes. A row is V bf16 logits read once and
// a few dozen FLOPs an element, far under the H100's ~295 FLOP/byte ridge.
// The least traffic is the logits read once forward, read once more and
// their bf16 gradient written once backward; these kernels move that and
// nothing else of the logits' size:
//
// - xent_fwd: one block of 256 threads a row (b, t < T). Each row is read
//   once with 16-byte loads (four in flight a thread), widened exactly to
//   f32, and folded into an online max m and sum of exponents s per thread
//   (s rescaled when m grows), then over the block. It writes the row's
//   lse = m + log(s) and lse - logit[target] (f32, (B, T)); the caller sums
//   the NLLs. A target outside [0, V) gives a NaN NLL.
// - xent_bwd: one block a row (b, t < S) of a fresh contiguous (B, S, V)
//   bf16 buffer: g (exp(logit - lse) - onehot(target)) computed in f32 and
//   rounded once to bf16, where g, the gradient of the sum, is read from
//   device memory (no host sync); rows t >= T are zeros, as the slice's
//   backward leaves them.
//
// Rows are addressed by strides (the logits' last dimension is dense); a
// row's elements before its first 16-byte boundary and after its last are
// read one by one, so any vocab and any bf16 alignment work. Where the
// logits' row and the gradient's row lie at different offsets from a
// 16-byte boundary, xent_bwd takes the whole row element by element.
// exp is `ex2.approx` in log2 units (relative error ~2^-22).

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;   // 16-byte loads in flight a thread
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the 8 bf16 values of a 16-byte vector, widened exactly to f32 (the
// element at the lower address is the low half of each word)
__device__ __forceinline__ void widen8(const uint4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Online (max, sum of exp(x - max)) of the values seen so far; m = -inf
// and s = 0 before the first.
struct Lse {
  float m = -INFINITY;
  float s = 0.f;

  __device__ __forceinline__ void add(float x) {
    if (x > m) {
      s *= ex2((m - x) * kLog2e);
      m = x;
    }
    s += ex2((x - m) * kLog2e);
  }

  __device__ __forceinline__ void add8(const float (&x)[8]) {
    float top = x[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) top = fmaxf(top, x[i]);
    if (top > m) {
      s *= ex2((m - top) * kLog2e);
      m = top;
    }
    const float ml = m * kLog2e;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += ex2(fmaf(x[i], kLog2e, -ml));
    s += acc;
  }

  __device__ __forceinline__ void merge(float m2, float s2) {
    const float top = fmaxf(m, m2);
    if (top == -INFINITY) return;   // both empty
    s = s * ex2((m - top) * kLog2e) + s2 * ex2((m2 - top) * kLog2e);
    m = top;
  }
};

// The block's (m, s), valid in thread 0.
__device__ __forceinline__ Lse block_lse(Lse v) {
  __shared__ float ms[kWarps], ss[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v.merge(__shfl_xor_sync(0xffffffffu, v.m, o),
            __shfl_xor_sync(0xffffffffu, v.s, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    ms[warp] = v.m;
    ss[warp] = v.s;
  }
  __syncthreads();
  if (warp == 0) {
    Lse w;
    if (lane < kWarps) {
      w.m = ms[lane];
      w.s = ss[lane];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      w.merge(__shfl_xor_sync(0xffffffffu, w.m, o),
              __shfl_xor_sync(0xffffffffu, w.s, o));
    v = w;
  }
  return v;
}

// Elements of a bf16 row at `p` before its first 16-byte boundary (at
// most n).
__device__ __forceinline__ int head_of(const void* p, int n) {
  const int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 1);
  return head < n ? head : n;
}

__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const __nv_bfloat16* __restrict__ logits,
                const int64_t* __restrict__ targets, float* __restrict__ lse,
                float* __restrict__ nll, int T, int V, long long stride_b,
                long long stride_s, long long tstride) {
  const long long r = blockIdx.x;
  const long long b = r / T, t = r % T;
  const __nv_bfloat16* row = logits + b * stride_b + t * stride_s;
  const int head = head_of(row, V);
  const int nvec = (V - head) >> 3;
  const int tail = head + nvec * 8;

  Lse acc;
  for (int i = threadIdx.x; i < head; i += kThreads) acc.add(widen(row[i]));
  for (int i = tail + threadIdx.x; i < V; i += kThreads) acc.add(widen(row[i]));
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);
  for (int base = threadIdx.x; base < nvec; base += kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = base + j * kThreads;
      if (i < nvec) v[j] = __ldg(vec + i);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (base + j * kThreads < nvec) {
        float x[8];
        widen8(v[j], x);
        acc.add8(x);
      }
    }
  }
  acc = block_lse(acc);
  if (threadIdx.x == 0) {
    const float l = acc.m + logf(acc.s);
    const int64_t target = targets[b * tstride + t];
    lse[r] = l;
    nll[r] = (target >= 0 && target < V) ? l - widen(row[target]) : NAN;
  }
}

__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const __nv_bfloat16* __restrict__ logits,
                const int64_t* __restrict__ targets,
                const float* __restrict__ lse, const float* __restrict__ g,
                __nv_bfloat16* __restrict__ dlogits, int S, int T, int V,
                long long stride_b, long long stride_s, long long tstride) {
  const long long r = blockIdx.x;
  const long long b = r / S, t = r % S;
  __nv_bfloat16* out = dlogits + r * V;
  const int head = head_of(out, V);
  const int nvec = (V - head) >> 3;
  const int tail = head + nvec * 8;

  if (t >= T) {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int i = threadIdx.x; i < head; i += kThreads) out[i] = zero;
    for (int i = tail + threadIdx.x; i < V; i += kThreads) out[i] = zero;
    uint4* vec = reinterpret_cast<uint4*>(out + head);
    for (int i = threadIdx.x; i < nvec; i += kThreads)
      vec[i] = make_uint4(0, 0, 0, 0);
    return;
  }

  const __nv_bfloat16* row = logits + b * stride_b + t * stride_s;
  const float scale = __ldg(g);
  const float ml = __ldg(lse + b * T + t) * kLog2e;
  const int64_t target = __ldg(targets + b * tstride + t);
  auto grad = [&](float x, long long i) {
    return scale * (ex2(fmaf(x, kLog2e, -ml)) - (i == target ? 1.f : 0.f));
  };

  if (head_of(row, V) != head) {   // rows at different 16-byte offsets
    for (int i = threadIdx.x; i < V; i += kThreads)
      out[i] = __float2bfloat16_rn(grad(widen(row[i]), i));
    return;
  }
  for (int i = threadIdx.x; i < head; i += kThreads)
    out[i] = __float2bfloat16_rn(grad(widen(row[i]), i));
  for (int i = tail + threadIdx.x; i < V; i += kThreads)
    out[i] = __float2bfloat16_rn(grad(widen(row[i]), i));
  const uint4* in = reinterpret_cast<const uint4*>(row + head);
  uint4* vec = reinterpret_cast<uint4*>(out + head);
  for (int base = threadIdx.x; base < nvec; base += kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = base + j * kThreads;
      if (i < nvec) v[j] = __ldg(in + i);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = base + j * kThreads;
      if (i < nvec) {
        float x[8];
        widen8(v[j], x);
        const long long e = head + 8LL * i;
        vec[i] = make_uint4(pack2(grad(x[0], e), grad(x[1], e + 1)),
                            pack2(grad(x[2], e + 2), grad(x[3], e + 3)),
                            pack2(grad(x[4], e + 4), grad(x[5], e + 5)),
                            pack2(grad(x[6], e + 6), grad(x[7], e + 7)));
      }
    }
  }
}

}  // namespace

// logits: bf16 rows at logits + b * stride_b + t * stride_s (elements),
// each V dense; targets: int64 at targets + b * tstride + t; lse, nll: f32
// (B, T) contiguous, written. Returns a cudaError_t (0: launched).
extern "C" int xent_fwd(const void* logits, const void* targets, void* lse,
                        void* nll, int B, int T, int V, long long stride_b,
                        long long stride_s, long long tstride, void* stream) {
  const long long rows = static_cast<long long>(B) * T;
  if (B <= 0 || T <= 0 || V <= 0 || rows > INT_MAX)
    return cudaErrorInvalidValue;
  xent_fwd_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits),
      static_cast<const int64_t*>(targets), static_cast<float*>(lse),
      static_cast<float*>(nll), T, V, stride_b, stride_s, tstride);
  return cudaGetLastError();
}

// As xent_fwd for logits, targets and the lse it wrote; g: the f32 gradient
// of the NLLs' sum (one value); dlogits: bf16 (B, S, V) contiguous,
// written whole.
extern "C" int xent_bwd(const void* logits, const void* targets,
                        const void* lse, const void* g, void* dlogits, int B,
                        int S, int T, int V, long long stride_b,
                        long long stride_s, long long tstride, void* stream) {
  const long long rows = static_cast<long long>(B) * S;
  if (B <= 0 || T <= 0 || T > S || V <= 0 || rows > INT_MAX)
    return cudaErrorInvalidValue;
  xent_bwd_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(logits),
      static_cast<const int64_t*>(targets), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dlogits), S,
      T, V, stride_b, stride_s, tstride);
  return cudaGetLastError();
}
