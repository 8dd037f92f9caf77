// LayerNorm-GRU gate kernel, forward (Hopper, sm_90a).
//
// Replaces sheeprl_tpu/ops/gru.py::_fused_fwd / _fwd_kernel, the Pallas kernel that the
// Dreamer family's LayerNormGRUCell runs after its fused [x, h] @ W projection:
//
//   n  = LayerNorm(proj) * gamma + beta      over the fused 3H axis, two-pass variance,
//                                            f32 statistics, eps given by the caller
//   r  = sigmoid(n[0:H])                      reset
//   c  = tanh(r * n[H:2H])                    candidate
//   u  = sigmoid(n[2H:3H] - 1)                update (Hafner's -1 bias)
//   h' = u * c + (1 - u) * h
//
// Shapes: proj [B, 3H], h [B, H], gamma/beta [3H] (f32), out [B, H]. proj, h and out are
// float32 or bfloat16 (out has h's type); the arithmetic is float32 throughout.
//
// What bounds it on an H100: memory. Each row reads 3H + H values and writes H, with
// about 40 float operations per hidden unit, far below the card's ~20 operations per
// byte break-even for f32 outside the tensor cores. At the player's batch (B <= 16,
// H = 512, ~176 KB) the bytes take ~0.05 us at 3.35 TB/s, so launch latency is the
// time; at B*T = 1024 rows (~10.5 MB) the bound is ~3.1 us.
//
// Design. One CTA of 256 threads per row, so the row statistics never leave the block.
// Thread t owns the hidden units j = t, t + 256, ...: it loads proj[j], proj[H + j],
// proj[2H + j] and keeps them in registers (up to CACHE units per thread, a template
// constant), so the gate math of unit j needs no exchange through shared memory. The
// mean, then the centred sum of squares, are reduced with warp shuffles and one pass
// through shared memory across the 8 warps. Units past CACHE * 256 (H > 4096) are
// re-read from global memory (L1/L2 hits) instead of cached. The kernel allocates
// nothing, runs on the caller's stream and masks the ragged edge (j < H).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + __expf(-x)); }

// Sum of `v` over the block; every thread gets the result. `scratch` holds kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += scratch[w];
  __syncthreads();  // scratch is reused by the next reduction
  return total;
}

template <typename T, int CACHE>
__global__ void __launch_bounds__(kThreads)
layernorm_gru_fwd_kernel(const T* __restrict__ proj, const T* __restrict__ h,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         T* __restrict__ out, int hidden, float eps) {
  __shared__ float scratch[kWarps];
  const int64_t row = blockIdx.x;
  const T* p = proj + row * 3 * (int64_t)hidden;
  const T* hr = h + row * (int64_t)hidden;
  T* o = out + row * (int64_t)hidden;
  const int tid = threadIdx.x;
  const int three_h = 3 * hidden;

  float pr[CACHE], pc[CACHE], pu[CACHE];

  // Pass 1: mean over 3H.
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < CACHE; ++i) {
    const int j = tid + i * kThreads;
    pr[i] = pc[i] = pu[i] = 0.0f;
    if (j < hidden) {
      pr[i] = to_f32(p[j]);
      pc[i] = to_f32(p[hidden + j]);
      pu[i] = to_f32(p[2 * hidden + j]);
      s += pr[i] + pc[i] + pu[i];
    }
  }
  for (int j = tid + CACHE * kThreads; j < hidden; j += kThreads)
    s += to_f32(p[j]) + to_f32(p[hidden + j]) + to_f32(p[2 * hidden + j]);
  const float mean = block_sum(s, scratch) / (float)three_h;

  // Pass 2: variance as the mean of squared deviations (two-pass, like the reference).
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < CACHE; ++i) {
    const int j = tid + i * kThreads;
    if (j < hidden) {
      const float a = pr[i] - mean, b = pc[i] - mean, c = pu[i] - mean;
      q += a * a + b * b + c * c;
    }
  }
  for (int j = tid + CACHE * kThreads; j < hidden; j += kThreads) {
    const float a = to_f32(p[j]) - mean, b = to_f32(p[hidden + j]) - mean,
                c = to_f32(p[2 * hidden + j]) - mean;
    q += a * a + b * b + c * c;
  }
  const float inv = rsqrtf(block_sum(q, scratch) / (float)three_h + eps);

  // Pass 3: gates and state blend for the units this thread owns.
  auto gate = [&](int j, float vr, float vc, float vu) {
    const float nr = (vr - mean) * inv * gamma[j] + beta[j];
    const float nc = (vc - mean) * inv * gamma[hidden + j] + beta[hidden + j];
    const float nu = (vu - mean) * inv * gamma[2 * hidden + j] + beta[2 * hidden + j];
    const float reset = sigmoidf(nr);
    const float cand = tanhf(reset * nc);
    const float update = sigmoidf(nu - 1.0f);
    const float hv = to_f32(hr[j]);
    o[j] = from_f32<T>(update * cand + (1.0f - update) * hv);
  };
#pragma unroll
  for (int i = 0; i < CACHE; ++i) {
    const int j = tid + i * kThreads;
    if (j < hidden) gate(j, pr[i], pc[i], pu[i]);
  }
  for (int j = tid + CACHE * kThreads; j < hidden; j += kThreads)
    gate(j, to_f32(p[j]), to_f32(p[hidden + j]), to_f32(p[2 * hidden + j]));
}

template <typename T>
void launch(const void* proj, const void* h, const float* gamma, const float* beta, void* out,
            int batch, int hidden, float eps, cudaStream_t stream) {
  const dim3 grid(batch), block(kThreads);
  const T* p = static_cast<const T*>(proj);
  const T* hh = static_cast<const T*>(h);
  T* o = static_cast<T*>(out);
  const int per_thread = (hidden + kThreads - 1) / kThreads;
  if (per_thread <= 1)
    layernorm_gru_fwd_kernel<T, 1><<<grid, block, 0, stream>>>(p, hh, gamma, beta, o, hidden, eps);
  else if (per_thread <= 2)
    layernorm_gru_fwd_kernel<T, 2><<<grid, block, 0, stream>>>(p, hh, gamma, beta, o, hidden, eps);
  else if (per_thread <= 4)
    layernorm_gru_fwd_kernel<T, 4><<<grid, block, 0, stream>>>(p, hh, gamma, beta, o, hidden, eps);
  else if (per_thread <= 8)
    layernorm_gru_fwd_kernel<T, 8><<<grid, block, 0, stream>>>(p, hh, gamma, beta, o, hidden, eps);
  else
    layernorm_gru_fwd_kernel<T, 16><<<grid, block, 0, stream>>>(p, hh, gamma, beta, o, hidden, eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (proj, h and out share it). Returns cudaGetLastError().
extern "C" int layernorm_gru_fwd(const void* proj, const void* h, const void* gamma,
                                 const void* beta, void* out, int batch, int hidden, float eps,
                                 int dtype, void* stream) {
  if (batch <= 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(proj, h, g, b, out, batch, hidden, eps, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(proj, h, g, b, out, batch, hidden, eps, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
