// LayerNorm-GRU gate kernels, forward and backward (Hopper, sm_90a).
//
// Replace sheeprl_tpu/ops/gru.py::_fused_fwd / _fwd_kernel and _fused_bwd / _bwd_kernel,
// the Pallas kernels that the Dreamer family's LayerNormGRUCell runs after its fused
// [x, h] @ W projection. The forward:
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

// ---------------------------------------------------------------------------------------
// Backward. Given g = dL/dh' [B, H], recompute LN and the gates from the saved (proj, h)
// and return dproj [B, 3H], dh [B, H] (the inputs' type) and dgamma, dbeta [3H] (f32):
//
//   dh    = g * (1 - u)
//   dn_u  = g * (c - h) * u * (1 - u)
//   dt    = g * u * (1 - c^2)             (through the tanh)
//   dn_c  = dt * r
//   dn_r  = dt * n_c * r * (1 - r)
//   dgamma += dn * unit,  dbeta += dn     (summed over rows; unit = (p - mean) * inv)
//   dp    = (dn * gamma - mean(dn * gamma) - unit * mean(dn * gamma * unit)) * inv
//
// with the row means over the fused 3H axis. All arithmetic is f32.
//
// What bounds it: memory, as the forward. A row reads 3H + 2H values and writes 3H + H;
// at B*T = 1024 rows, H = 512 in f32 that is ~16.8 MB, ~5 us at 3.35 TB/s.
//
// Design. The forward's layout: thread t owns units j = t, t + THREADS, ...; it keeps the
// three pre-activations and the three dn values of its units in registers, so a row needs
// four block reductions' worth of synchronisation (mean, variance, and the two dp means
// reduced together) and no shared-memory exchange of per-unit values. One CTA walks a
// tile of `rows_per_tile` consecutive rows and accumulates its units' dgamma and dbeta in
// registers across them; at the end it writes one partial row [3H] of each. A second
// launch sums the n_tiles partial rows per column in a fixed order, so dgamma and dbeta
// are deterministic (no float atomics) for any B. The caller allocates the partials.
// Hidden sizes up to 2048 run 256 threads per CTA; larger ones 1024 threads, up to
// H = 16384.
// ---------------------------------------------------------------------------------------

// Sums of `a` and `b` over the block; every thread gets both. `scratch` holds one float2
// per warp.
template <int THREADS>
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  float2 total = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    total.x += scratch[w].x;
    total.y += scratch[w].y;
  }
  __syncthreads();  // scratch is reused by the next reduction
  return total;
}

template <typename T, int THREADS, int CACHE>
__global__ void __launch_bounds__(THREADS)
layernorm_gru_bwd_kernel(const T* __restrict__ proj, const T* __restrict__ h,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         const T* __restrict__ g, T* __restrict__ dproj, T* __restrict__ dh,
                         float* __restrict__ part_gamma, float* __restrict__ part_beta,
                         int batch, int hidden, int rows_per_tile, float eps) {
  __shared__ float2 scratch[THREADS / 32];
  const int tid = threadIdx.x;
  const int three_h = 3 * hidden;
  const float inv_n = 1.0f / (float)three_h;
  const int row0 = blockIdx.x * rows_per_tile;
  const int row1 = min(row0 + rows_per_tile, batch);

  float acc_g[3][CACHE], acc_b[3][CACHE];
#pragma unroll
  for (int i = 0; i < CACHE; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) acc_g[k][i] = acc_b[k][i] = 0.0f;

  for (int row = row0; row < row1; ++row) {
    const T* p = proj + (int64_t)row * three_h;
    const T* hr = h + (int64_t)row * hidden;
    const T* gr = g + (int64_t)row * hidden;
    T* dp = dproj + (int64_t)row * three_h;
    T* dhr = dh + (int64_t)row * hidden;

    float pv[3][CACHE];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < CACHE; ++i) {
      const int j = tid + i * THREADS;
#pragma unroll
      for (int k = 0; k < 3; ++k) pv[k][i] = 0.0f;
      if (j < hidden) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          pv[k][i] = to_f32(p[k * hidden + j]);
          s += pv[k][i];
        }
      }
    }
    const float mean = block_sum2<THREADS>(s, 0.0f, scratch).x * inv_n;

    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < CACHE; ++i) {
      if (tid + i * THREADS < hidden) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float d = pv[k][i] - mean;
          q += d * d;
        }
      }
    }
    const float inv = rsqrtf(block_sum2<THREADS>(q, 0.0f, scratch).x * inv_n + eps);

    // Gate gradients of the units this thread owns, and its shares of the two dp means.
    float dn[3][CACHE];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CACHE; ++i) {
      const int j = tid + i * THREADS;
#pragma unroll
      for (int k = 0; k < 3; ++k) dn[k][i] = 0.0f;
      if (j < hidden) {
        float unit[3], n[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          unit[k] = (pv[k][i] - mean) * inv;
          n[k] = unit[k] * gamma[k * hidden + j] + beta[k * hidden + j];
        }
        const float reset = sigmoidf(n[0]);
        const float cand = tanhf(reset * n[1]);
        const float update = sigmoidf(n[2] - 1.0f);
        const float hv = to_f32(hr[j]);
        const float gv = to_f32(gr[j]);
        dhr[j] = from_f32<T>(gv * (1.0f - update));
        const float dt = gv * update * (1.0f - cand * cand);
        dn[0][i] = dt * n[1] * reset * (1.0f - reset);
        dn[1][i] = dt * reset;
        dn[2][i] = gv * (cand - hv) * update * (1.0f - update);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float dg_hat = dn[k][i] * gamma[k * hidden + j];
          s1 += dg_hat;
          s2 += dg_hat * unit[k];
          acc_g[k][i] += dn[k][i] * unit[k];
          acc_b[k][i] += dn[k][i];
        }
      }
    }
    const float2 m = block_sum2<THREADS>(s1, s2, scratch);
    const float m1 = m.x * inv_n, m2 = m.y * inv_n;

#pragma unroll
    for (int i = 0; i < CACHE; ++i) {
      const int j = tid + i * THREADS;
      if (j < hidden) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float unit = (pv[k][i] - mean) * inv;
          dp[k * hidden + j] = from_f32<T>((dn[k][i] * gamma[k * hidden + j] - m1 - unit * m2) * inv);
        }
      }
    }
  }

  float* pg = part_gamma + (int64_t)blockIdx.x * three_h;
  float* pb = part_beta + (int64_t)blockIdx.x * three_h;
#pragma unroll
  for (int i = 0; i < CACHE; ++i) {
    const int j = tid + i * THREADS;
    if (j < hidden) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pg[k * hidden + j] = acc_g[k][i];
        pb[k * hidden + j] = acc_b[k][i];
      }
    }
  }
}

// dgamma[c] = sum_t part_gamma[t, c] (and dbeta alike), t in order: one thread per column.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ part_gamma, const float* __restrict__ part_beta,
                    float* __restrict__ dgamma, float* __restrict__ dbeta, int n_tiles, int width) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= width) return;
  float sg = 0.0f, sb = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    sg += part_gamma[(int64_t)t * width + c];
    sb += part_beta[(int64_t)t * width + c];
  }
  dgamma[c] = sg;
  dbeta[c] = sb;
}

template <typename T, int THREADS, int CACHE>
void launch_bwd_tiles(const void* proj, const void* h, const float* gamma, const float* beta,
                      const void* g, void* dproj, void* dh, float* part_gamma, float* part_beta,
                      int batch, int hidden, int rows_per_tile, int n_tiles, float eps,
                      cudaStream_t stream) {
  layernorm_gru_bwd_kernel<T, THREADS, CACHE><<<n_tiles, THREADS, 0, stream>>>(
      static_cast<const T*>(proj), static_cast<const T*>(h), gamma, beta, static_cast<const T*>(g),
      static_cast<T*>(dproj), static_cast<T*>(dh), part_gamma, part_beta, batch, hidden,
      rows_per_tile, eps);
}

template <typename T>
int launch_bwd(const void* proj, const void* h, const float* gamma, const float* beta,
               const void* g, void* dproj, void* dh, float* dgamma, float* dbeta,
               float* partials, int batch, int hidden, int rows_per_tile, float eps,
               cudaStream_t stream) {
  const int n_tiles = (batch + rows_per_tile - 1) / rows_per_tile;
  float* part_gamma = partials;
  float* part_beta = partials + (int64_t)n_tiles * 3 * hidden;
  const int per256 = (hidden + 255) / 256;
  const int per1024 = (hidden + 1023) / 1024;
#define LNGRU_BWD(THREADS, CACHE)                                                            \
  launch_bwd_tiles<T, THREADS, CACHE>(proj, h, gamma, beta, g, dproj, dh, part_gamma,        \
                                      part_beta, batch, hidden, rows_per_tile, n_tiles, eps, \
                                      stream)
  if (per256 <= 1)
    LNGRU_BWD(256, 1);
  else if (per256 <= 2)
    LNGRU_BWD(256, 2);
  else if (per256 <= 4)
    LNGRU_BWD(256, 4);
  else if (per256 <= 8)
    LNGRU_BWD(256, 8);
  else if (per1024 <= 4)
    LNGRU_BWD(1024, 4);
  else if (per1024 <= 8)
    LNGRU_BWD(1024, 8);
  else if (per1024 <= 16)
    LNGRU_BWD(1024, 16);
  else
    return (int)cudaErrorInvalidValue;
#undef LNGRU_BWD
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = 3 * hidden;
  sum_partials_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_gamma, part_beta, dgamma, dbeta, n_tiles, width);
  return (int)cudaGetLastError();
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

// Backward. dtype as above (proj, h, g, dproj and dh share it); gamma, beta, dgamma, dbeta
// and partials are float32. partials holds 2 * ceil(batch / rows_per_tile) * 3 * hidden
// floats. Launches the tile kernel and the partial sums on `stream`; returns the first
// launch error, or 0.
extern "C" int layernorm_gru_bwd(const void* proj, const void* h, const void* gamma,
                                 const void* beta, const void* g, void* dproj, void* dh,
                                 void* dgamma, void* dbeta, void* partials, int batch, int hidden,
                                 int rows_per_tile, float eps, int dtype, void* stream) {
  if (batch <= 0 || hidden <= 0 || rows_per_tile <= 0) return (int)cudaErrorInvalidValue;
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(proj, h, gm, bt, g, dproj, dh, dg, db, part, batch, hidden,
                             rows_per_tile, eps, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(proj, h, gm, bt, g, dproj, dh, dg, db, part, batch, hidden,
                                     rows_per_tile, eps, s);
  return (int)cudaErrorInvalidValue;
}
