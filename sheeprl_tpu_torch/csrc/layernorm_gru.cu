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
// The backward, given g = dL/dh' [B, H], recomputes LN and the gates from the saved
// (proj, h) and returns dproj [B, 3H], dh [B, H] (the inputs' type) and dgamma, dbeta [3H]
// (f32, summed over the rows):
//
//   dh    = g * (1 - u)
//   dn_u  = g * (c - h) * u * (1 - u)
//   dt    = g * u * (1 - c^2)             (through the tanh)
//   dn_c  = dt * r
//   dn_r  = dt * n_c * r * (1 - r)
//   dgamma += dn * unit,  dbeta += dn     (unit = (p - mean) * inv)
//   dp    = (dn * gamma - mean(dn * gamma) - unit * mean(dn * gamma * unit)) * inv
//
// What bounds them on an H100. A forward row reads 3H + H values and writes H, a backward
// row reads 5H and writes 4H, with 40 to 80 float operations per hidden unit: far below
// the ~20 operations per byte at which f32 arithmetic outside the tensor cores would
// bound them, so the byte bound is the bound (at B*T = 1024 rows of H = 512: 5.64 us for
// the f32 backward at 3.35 TB/s, 3.13 us for the forward). At the model's batch (B = 16)
// the bytes take ~0.05 us; the time is the launch and each row's chain of dependent steps:
// its loads, three reductions over the row (mean, variance, the two dp means), the gate
// arithmetic between them, and for the backward the sum of dgamma/dbeta over the rows.
//
// Design. A row belongs to a group of threads_per_row threads (whole warps); thread t owns
// UNITS hidden units per segment of the 3H axis, as chunks c = t + i * threads_per_row of
// VEC consecutive units (VEC = UNITS, loaded in one piece, when every operand is 16-byte
// aligned and H allows it; else 1). Every load of a row (proj, h, g, the thread's gamma
// and beta) is issued before the first reduction. A reduction is warp shuffles and one
// exchange through shared memory across the group's warps. UNITS is 2 (H = 512: 256
// threads per row, one row per CTA, the shortest chain per row) where the batch's CTAs fit
// one cluster of 16, else 4 (128 threads per row, two rows per CTA: fewer instructions
// and exchanges per row where many rows share each SM). Two paths by threads_per_row:
//
// - narrow (<= 256): a CTA packs 256 / threads_per_row rows; gamma/beta stay in registers
//   for every row the thread sees, and the backward loads the group's next row before it
//   does this row's arithmetic;
// - wide (more, H > 1024): one row per CTA of 1024 threads, every pass streams the row
//   again from L1/L2 (the forward takes any H, the backward H <= 16384).
//
// The backward's dgamma/dbeta. A thread keeps its units' terms in registers over the rows
// its group walks. Where the batch's CTAs (one row a group) fit one thread-block cluster of
// at most 16, the call is one launch: right after its last row's gate arithmetic every
// thread sends its terms to the CTA of the cluster that owns those columns (a share of the
// 2 x 3H columns per CTA, one slot per group of the cluster) with st.async, which
// completes on the receiver's mbarrier; it then finishes the row (the dp means and dp)
// while the terms are in flight, and each CTA waits on its own mbarrier for its share's
// bytes, adds the slots in (rank, group) order and writes dgamma/dbeta. A single CTA with
// a single group writes its terms straight out. Larger batches are at most 128 CTAs
// walking rows_per_group rows a group, in clusters of 8 that each write one partial row
// [2][3H], and a second launch, programmatically dependent on the first, adds those rows
// in order. The wide path keeps its terms in its CTA's partial row in device memory (the
// outputs themselves when the batch is one CTA). Every sum runs in a fixed order without
// atomics: two calls give the same bits. Nothing is kept between calls: any stream, any
// CUDA-graph replay. A receiver whose bytes do not all land (the senders' layout and the
// expected count disagree) traps after 2 s of waiting, so that the launch fails with a
// CUDA error instead of hanging. The launch plan is `geometry` below, restated in
// ops/gru.py::geometry and exported as layernorm_gru_geometry.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int kSmallUnits = 2;       // units per thread where the batch fits one cluster
constexpr int kLargeUnits = 4;       // elsewhere
constexpr int kCtaThreads = 256;     // narrow: threads per CTA, rows packed
constexpr int kWideThreads = 1024;   // wide: one row per CTA, streamed
constexpr int kMaxCtas = 128;        // two-launch backward: at most this many CTAs hold rows
constexpr int kMaxCluster = 16;      // one-launch backward: the batch's CTAs in one cluster
constexpr int kMultiCluster = 8;     // two-launch backward: CTAs per cluster
constexpr int kWideVec = 4;          // wide path: units per load
constexpr int kSumThreads = 256;     // the second launch's CTA
constexpr int kMaxBwdHidden = 16384;
enum Path { kNarrow = 0, kWide = 1 };

// The launch plan of a shape. units: hidden units a thread owns per segment; vec: units
// per load; path; threads_per_row; rows_per_cta: row groups of a CTA; fwd_grid: the
// forward's CTAs (one row a group); rows_per_group: rows each backward group walks;
// bwd_grid: the backward's CTAs (a multiple of cluster); cluster: CTAs per cluster;
// bwd_launches: 1 or 2; partial_rows: rows [2][3H] f32 of scratch (0 with one launch);
// bwd_smem: dynamic shared memory of a backward CTA (its slots; 0 where a single CTA with
// a single group writes its terms straight out).
struct Geometry {
  int units, vec, path, threads_per_row, rows_per_cta, fwd_grid, rows_per_group, bwd_grid, cluster, bwd_launches,
      partial_rows, bwd_smem;
};
constexpr int kGeometryFields = 12;

int cdiv(int a, int b) { return (a + b - 1) / b; }
int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}
// A share of `cols` columns per CTA of a cluster of `size`: a multiple of 8 (a thread's
// VEC columns have one owner).
__host__ __device__ __forceinline__ int share_of(int cols, int size) { return ((cols + size - 1) / size + 7) / 8 * 8; }

// The rows' layout for `units` units per thread: path, threads_per_row, rows_per_cta, fwd_grid.
Geometry rows_layout(int batch, int hidden, int units) {
  Geometry g{};
  g.units = units;
  const int tpr = cdiv(cdiv(hidden, units), 32) * 32;
  g.path = tpr <= kCtaThreads ? kNarrow : kWide;
  g.threads_per_row = g.path == kWide ? kWideThreads : tpr;
  g.rows_per_cta = g.path == kNarrow ? (kCtaThreads / tpr < batch ? kCtaThreads / tpr : batch) : 1;
  g.fwd_grid = cdiv(batch, g.rows_per_cta);
  return g;
}

bool one_launch(const Geometry& g) { return g.path != kWide && g.fwd_grid <= kMaxCluster; }

Geometry geometry(int batch, int hidden, bool aligned) {
  Geometry g = rows_layout(batch, hidden, kSmallUnits);
  if (!one_launch(g)) g = rows_layout(batch, hidden, kLargeUnits);
  const int vec = g.path == kWide ? kWideVec : g.units;
  g.vec = (aligned && hidden % vec == 0) ? vec : 1;
  if (one_launch(g)) {
    g.cluster = pow2_at_least(g.fwd_grid);
    g.rows_per_group = 1;
    g.bwd_grid = g.cluster;
    g.bwd_launches = 1;
    g.partial_rows = 0;
  } else {
    g.rows_per_group = cdiv(batch, g.rows_per_cta * kMaxCtas);
    const int tiles = cdiv(batch, g.rows_per_cta * g.rows_per_group);
    g.cluster = g.path == kWide ? 1 : kMultiCluster;
    g.bwd_grid = cdiv(tiles, g.cluster) * g.cluster;
    g.bwd_launches = g.bwd_grid > 1 ? 2 : 1;
    g.partial_rows = g.bwd_launches == 2 ? g.bwd_grid / g.cluster : 0;
  }
  const bool slots = g.path == kNarrow && (g.cluster > 1 || g.rows_per_cta > 1);
  g.bwd_smem = slots ? g.cluster * g.rows_per_cta * share_of(6 * hidden, g.cluster) * 4 : 0;
  return g;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

// The gates' nonlinearities through exp and a fast reciprocal (a few ulp of f32): the
// gate chain is the longest stretch of each row's dependent arithmetic.
__device__ __forceinline__ float sigmoidf(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
__device__ __forceinline__ float tanh_f(float x) { return 1.0f - __fdividef(2.0f, __expf(2.0f * x) + 1.0f); }

// VEC consecutive values of type T, as loaded (one load of 2 to 16 bytes), converted to
// f32 where they are used, so that a load in flight holds no thread up until its use.
template <int BYTES>
struct Word;
template <>
struct Word<2> {
  using type = unsigned short;
};
template <>
struct Word<4> {
  using type = unsigned;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<16> {
  using type = uint4;
};
__device__ __forceinline__ void to_words(unsigned short v, unsigned* w) { w[0] = v; }
__device__ __forceinline__ void to_words(unsigned v, unsigned* w) { w[0] = v; }
__device__ __forceinline__ void to_words(uint2 v, unsigned* w) { w[0] = v.x, w[1] = v.y; }
__device__ __forceinline__ void to_words(uint4 v, unsigned* w) { w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w; }
template <typename W>
__device__ __forceinline__ W from_words(const unsigned* w);
template <>
__device__ __forceinline__ unsigned short from_words<unsigned short>(const unsigned* w) { return (unsigned short)w[0]; }
template <>
__device__ __forceinline__ unsigned from_words<unsigned>(const unsigned* w) { return w[0]; }
template <>
__device__ __forceinline__ uint2 from_words<uint2>(const unsigned* w) { return make_uint2(w[0], w[1]); }
template <>
__device__ __forceinline__ uint4 from_words<uint4>(const unsigned* w) { return make_uint4(w[0], w[1], w[2], w[3]); }

template <typename T, int VEC>
struct Pack {
  using W = typename Word<VEC * sizeof(T)>::type;
  static constexpr int kWords = VEC * sizeof(T) >= 4 ? VEC * sizeof(T) / 4 : 1;
  unsigned w[kWords];
  __device__ __forceinline__ void load(const T* p) { to_words(__ldg(reinterpret_cast<const W*>(p)), w); }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else {
      const unsigned x = w[i >> 1];
      return __uint_as_float((i & 1) ? (x & 0xffff0000u) : (x << 16));
    }
  }
  __device__ __forceinline__ static void store(T* p, const float* v) {
    unsigned out[kWords];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < kWords; ++i) out[i] = __float_as_uint(v[i]);
    } else if constexpr (VEC == 1) {
      out[0] = __bfloat16_as_ushort(__float2bfloat16(v[0]));
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i)
        out[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2 * i])) |
                 ((unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2 * i + 1])) << 16);
    }
    *reinterpret_cast<W*>(p) = from_words<W>(out);
  }
};

// N consecutive f32 values (gamma, beta, the dgamma/dbeta accumulators), moved 16 bytes at
// a time where N allows.
template <int N>
struct F32s {
  float v[N];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p) + j);
        v[4 * j] = t.x, v[4 * j + 1] = t.y, v[4 * j + 2] = t.z, v[4 * j + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = __ldg(p + j);
    }
  }
  // plain (not read-only cache) loads and stores, for memory the kernel writes
  __device__ __forceinline__ void read(const float* p) {
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        const float4 t = reinterpret_cast<const float4*>(p)[j];
        v[4 * j] = t.x, v[4 * j + 1] = t.y, v[4 * j + 2] = t.z, v[4 * j + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = p[j];
    }
  }
  __device__ __forceinline__ void write(float* p) const {
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        reinterpret_cast<float4*>(p)[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) p[j] = v[j];
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `v` over this thread's row group of `wpr` warps (consecutive in the CTA, the
// group's first at `first_warp`; at most MAXW); every thread gets it. Groups of one warp
// use shuffles only; wider groups add one exchange through `slots` (one value per warp of
// the CTA): up to eight slots are read at once, then added in warp order. Every thread
// of the CTA calls it the same number of times (all groups of a CTA have the same width).
template <int MAXW>
__device__ __forceinline__ float group_sum(float v, float* slots, int first_warp, int wpr) {
  constexpr int kBatch = MAXW < 8 ? MAXW : 8;
  v = warp_sum(v);
  if (wpr == 1) return v;
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int base = 0; base < MAXW; base += kBatch) {
    if (base >= wpr) break;
    float x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) x[j] = base + j < wpr ? slots[first_warp + base + j] : 0.0f;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (base + j < wpr) s += x[j];
  }
  return s;
}

// The sums of a and b over the row group, through one exchange.
template <int MAXW>
__device__ __forceinline__ float2 group_sum2(float a, float b, float2* slots, int first_warp, int wpr) {
  constexpr int kBatch = MAXW < 8 ? MAXW : 8;
  a = warp_sum(a);
  b = warp_sum(b);
  if (wpr == 1) return make_float2(a, b);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int base = 0; base < MAXW; base += kBatch) {
    if (base >= wpr) break;
    float2 x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) x[j] = base + j < wpr ? slots[first_warp + base + j] : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (base + j < wpr) s.x += x[j].x, s.y += x[j].y;
  }
  return s;
}

// Programmatic dependent launch: the first launch of a two-launch backward lets the
// second start at once; the second waits, before it reads anything, until the first has
// finished and its writes are visible. Both are no-ops in a launch without the attribute.
__device__ __forceinline__ void launch_dependents() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }
__device__ __forceinline__ void wait_for_prerequisites() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// The gates of one unit from its three normalised pre-activations.
struct Gates {
  float reset, cand, update;
  __device__ __forceinline__ Gates(float n0, float n1, float n2)
      : reset(sigmoidf(n0)), cand(tanh_f(reset * n1)), update(sigmoidf(n2 - 1.0f)) {}
};

// ---------------------------------------------------------------------------------------
// Forward, narrow path: one row per group, rows_per_cta groups per CTA.
// ---------------------------------------------------------------------------------------
template <typename T, int U, int VEC>
__global__ void __launch_bounds__(kCtaThreads)
layernorm_gru_fwd_kernel(const T* __restrict__ proj, const T* __restrict__ h, const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ out, int batch, int hidden, int tpr,
                         float eps) {
  constexpr int CH = U / VEC;
  __shared__ __align__(16) float slots[2][kCtaThreads / 32];
  const int grp = threadIdx.x / tpr, t = threadIdx.x - grp * tpr, wpr = tpr >> 5;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / tpr) + grp;
  const bool live = row < batch;
  const int chunks = hidden / VEC;
  const T* p = proj + row * 3 * hidden;
  const T* hr = h + row * hidden;

  // Every load of the row first: proj, h and the thread's gamma/beta slices.
  Pack<T, VEC> pv[3][CH], hv[CH];
  F32s<VEC> gv[3][CH], bv[3][CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = t + i * tpr;
    if (live && c < chunks) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pv[k][i].load(p + k * hidden + c * VEC);
        gv[k][i].load(gamma + k * hidden + c * VEC);
        bv[k][i].load(beta + k * hidden + c * VEC);
      }
      hv[i].load(hr + c * VEC);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) pv[k][i].zero();
    }
  }

  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += pv[k][i].get(j);
  const float mean = group_sum<kCtaThreads / 32>(s, slots[0], grp * wpr, wpr) / (float)(3 * hidden);

  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    if (t + i * tpr < chunks) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = pv[k][i].get(j) - mean;
          q += d * d;
        }
    }
  }
  const float inv = rsqrtf(group_sum<kCtaThreads / 32>(q, slots[1], grp * wpr, wpr) / (float)(3 * hidden) + eps);

  if (!live) return;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = t + i * tpr;
    if (c < chunks) {
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const Gates gt((pv[0][i].get(j) - mean) * inv * gv[0][i].v[j] + bv[0][i].v[j],
                       (pv[1][i].get(j) - mean) * inv * gv[1][i].v[j] + bv[1][i].v[j],
                       (pv[2][i].get(j) - mean) * inv * gv[2][i].v[j] + bv[2][i].v[j]);
        o[j] = gt.update * gt.cand + (1.0f - gt.update) * hv[i].get(j);
      }
      Pack<T, VEC>::store(out + row * hidden + c * VEC, o);
    }
  }
}

// Forward, wide path: one row per CTA of 1024 threads; each pass streams the row again.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWideThreads)
layernorm_gru_fwd_wide_kernel(const T* __restrict__ proj, const T* __restrict__ h, const float* __restrict__ gamma,
                              const float* __restrict__ beta, T* __restrict__ out, int hidden, float eps) {
  __shared__ __align__(16) float slots[2][kWideThreads / 32];
  const int64_t row = blockIdx.x;
  const int chunks = hidden / VEC;
  const T* p = proj + row * 3 * hidden;
  float s = 0.0f;
  for (int c = threadIdx.x; c < chunks; c += kWideThreads) {
    Pack<T, VEC> v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k].load(p + k * hidden + c * VEC);
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += v[k].get(j);
  }
  const float mean = group_sum<kWideThreads / 32>(s, slots[0], 0, kWideThreads / 32) / (float)(3 * hidden);
  float q = 0.0f;
  for (int c = threadIdx.x; c < chunks; c += kWideThreads) {
    Pack<T, VEC> v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k].load(p + k * hidden + c * VEC);
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[k].get(j) - mean;
        q += d * d;
      }
  }
  const float inv = rsqrtf(group_sum<kWideThreads / 32>(q, slots[1], 0, kWideThreads / 32) / (float)(3 * hidden) + eps);
  for (int c = threadIdx.x; c < chunks; c += kWideThreads) {
    Pack<T, VEC> v[3], hv;
    F32s<VEC> gv[3], bv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k].load(p + k * hidden + c * VEC);
      gv[k].load(gamma + k * hidden + c * VEC);
      bv[k].load(beta + k * hidden + c * VEC);
    }
    hv.load(h + row * hidden + c * VEC);
    float o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const Gates gt((v[0].get(j) - mean) * inv * gv[0].v[j] + bv[0].v[j],
                     (v[1].get(j) - mean) * inv * gv[1].v[j] + bv[1].v[j],
                     (v[2].get(j) - mean) * inv * gv[2].v[j] + bv[2].v[j]);
      o[j] = gt.update * gt.cand + (1.0f - gt.update) * hv.get(j);
    }
    Pack<T, VEC>::store(out + row * hidden + c * VEC, o);
  }
}

// ---------------------------------------------------------------------------------------
// Backward, narrow path. CTA b holds rows_per_cta groups; group k walks the rows
// b * rows_per_cta * rows_per_group + k + j * rows_per_cta, j < rows_per_group (rows past
// the batch are all-zero and store nothing, so every group makes the same barriers), and
// keeps its units' dgamma/dbeta terms and gamma/beta in registers for the whole walk,
// loading the group's next row before this row's arithmetic. `partials` is null in a
// one-launch call; otherwise cluster q writes partial row q ([2][3H]: dgamma's terms,
// then dbeta's).
// ---------------------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
// The address in CTA `rank`'s shared memory of the same offset as `addr` in this CTA's.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// Store N consecutive floats at a shared::cluster address, asynchronously: the store
// completes on the mbarrier at `bar` (in the same CTA as `addr`) with its byte count.
template <int N>
__device__ __forceinline__ void st_async(uint32_t addr, const float (&v)[N], uint32_t bar) {
  if constexpr (N == 1) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(addr), "f"(v[0]),
                 "r"(bar)
                 : "memory");
  } else if constexpr (N == 2) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(addr),
                 "f"(v[0]), "f"(v[1]), "r"(bar)
                 : "memory");
  } else {
#pragma unroll
    for (int j = 0; j < N; j += 4)
      asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                       addr + 4 * j),
                   "f"(v[j]), "f"(v[j + 1]), "f"(v[j + 2]), "f"(v[j + 3]), "r"(bar)
                   : "memory");
  }
}

// The receiving CTA's mbarrier: one arrival (its own, with the bytes it expects), then
// the senders' st.async bytes.
__device__ __forceinline__ void mbar_init_expect(uint64_t* bar, unsigned bytes) {
  const uint32_t addr = smem_u32(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(addr) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(addr), "r"(bytes) : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Wait until the mbarrier's first phase completes: every expected byte has landed, and
// the senders' stores are visible to this CTA. Bytes that never land trap after 2 s of
// waiting, so that the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait_first(uint64_t* bar) {
  const uint32_t addr = smem_u32(bar);
  const unsigned long long start = global_ns();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n selp.u32 %0, 1, 0, "
        "p;\n}\n"
        : "=r"(done)
        : "r"(addr)
        : "memory");
    if (done) return;
    if (global_ns() - start > 2000000000ull) __trap();
  }
}

// One row's inputs of a thread, as loaded.
template <typename T, int VEC, int CH>
struct RowIn {
  Pack<T, VEC> p[3][CH], h[CH], g[CH];
};

// The cluster barrier in two halves: a relaxed arrival at the start (after the CTA's
// mbarrier is initialised) and a wait before the first store into another CTA's shared
// memory, so that every CTA of the cluster runs and can take the stores.
__device__ __forceinline__ void cluster_arrive_relaxed() { asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }

template <typename T, int U, int VEC>
__global__ void __launch_bounds__(kCtaThreads, 2)
layernorm_gru_bwd_kernel(const T* __restrict__ proj, const T* __restrict__ h, const float* __restrict__ gamma,
                         const float* __restrict__ beta, const T* __restrict__ g, T* __restrict__ dproj,
                         T* __restrict__ dh, float* __restrict__ dgamma, float* __restrict__ dbeta,
                         float* __restrict__ partials, int batch, int hidden, int tpr, int rows_per_group, float eps) {
  constexpr int CH = U / VEC;
  extern __shared__ float4 smem[];
  // the exchanges of a row: mean, variance, the two dp means; reused row after row (a
  // warp writes a slot again only after the next exchange's barrier, which every warp
  // reaches after its read)
  __shared__ __align__(16) float slots[2][kCtaThreads / 32];
  __shared__ __align__(16) float2 pair_slots[kCtaThreads / 32];
  __shared__ __align__(8) uint64_t recv_bar;
  launch_dependents();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), size = cluster.num_blocks();
  const int rpc = blockDim.x / tpr;
  const int grp = threadIdx.x / tpr, t = threadIdx.x - grp * tpr, wpr = tpr >> 5;
  const int width = 3 * hidden, chunks = hidden / VEC, cols = 2 * width;
  const float n_inv = 1.0f / (float)width;
  const int64_t row0 = (int64_t)blockIdx.x * rpc * rows_per_group + grp;
  // where the terms go: straight out (a single CTA with a single group), else into the
  // slots of the CTA that owns each column, a share of the columns per CTA
  const bool direct = size == 1 && rpc == 1;
  const int share = share_of(cols, size), slot = rank * rpc + grp;
  float* recv = reinterpret_cast<float*>(smem);  // [size * rpc][share]
  float* out_row = partials == nullptr ? nullptr : partials + (int64_t)(blockIdx.x / size) * cols;
  const int first = rank * share, count = min(share, cols - first), slots_in = size * rpc;
  if (size > 1) {
    // this CTA's share arrives from every group of the cluster by st.async
    if (threadIdx.x == 0) mbar_init_expect(&recv_bar, 4u * (unsigned)(slots_in * max(count, 0)));
    cluster_arrive_relaxed();
  }

  auto load_row = [&](int j, RowIn<T, VEC, CH>& in) {
    const int64_t row = row0 + (int64_t)j * rpc;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = t + i * tpr;
      if (row < batch && c < chunks) {
#pragma unroll
        for (int k = 0; k < 3; ++k) in.p[k][i].load(proj + row * width + k * hidden + c * VEC);
        in.h[i].load(h + row * hidden + c * VEC);
        in.g[i].load(g + row * hidden + c * VEC);
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) in.p[k][i].zero();
        in.h[i].zero();
        in.g[i].zero();
      }
    }
  };

  RowIn<T, VEC, CH> cur;
  load_row(0, cur);
  F32s<VEC> gv[3][CH], bv[3][CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = t + i * tpr;
    if (c < chunks) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        gv[k][i].load(gamma + k * hidden + c * VEC);
        bv[k][i].load(beta + k * hidden + c * VEC);
      }
    }
  }
  F32s<VEC> ag[3][CH], ab[3][CH];  // this thread's dgamma/dbeta terms, over its rows
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) ag[k][i].v[j] = ab[k][i].v[j] = 0.0f;

  for (int jr = 0; jr < rows_per_group; ++jr) {
    RowIn<T, VEC, CH> next;
    if (jr + 1 < rows_per_group) load_row(jr + 1, next);
    const int64_t row = row0 + (int64_t)jr * rpc;

    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < CH; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) s += cur.p[k][i].get(j);
    const float mean = group_sum<kCtaThreads / 32>(s, slots[0], grp * wpr, wpr) * n_inv;
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (t + i * tpr < chunks) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float d = cur.p[k][i].get(j) - mean;
            q += d * d;
          }
      }
    }
    const float inv = rsqrtf(group_sum<kCtaThreads / 32>(q, slots[1], grp * wpr, wpr) * n_inv + eps);

    // The gate gradients of the thread's units, their dgamma/dbeta terms and shares of the
    // two dp means; dn * gamma is kept for dp.
    float dgh[3][CH][VEC];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = t + i * tpr;
      if (c < chunks) {
        float dhv[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float unit[3], n[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            unit[k] = (cur.p[k][i].get(j) - mean) * inv;
            n[k] = unit[k] * gv[k][i].v[j] + bv[k][i].v[j];
          }
          const Gates gt(n[0], n[1], n[2]);
          const float gvv = cur.g[i].get(j), hvv = cur.h[i].get(j);
          dhv[j] = gvv * (1.0f - gt.update);
          const float dt = gvv * gt.update * (1.0f - gt.cand * gt.cand);
          const float dn[3] = {dt * n[1] * gt.reset * (1.0f - gt.reset), dt * gt.reset,
                               gvv * (gt.cand - hvv) * gt.update * (1.0f - gt.update)};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            dgh[k][i][j] = dn[k] * gv[k][i].v[j];
            s1 += dgh[k][i][j];
            s2 += dgh[k][i][j] * unit[k];
            ag[k][i].v[j] += dn[k] * unit[k];
            ab[k][i].v[j] += dn[k];
          }
        }
        if (row < batch) Pack<T, VEC>::store(dh + row * hidden + c * VEC, dhv);
      }
    }

    if (jr + 1 == rows_per_group) {
      // The terms are complete: send them on now, so that their flight overlaps the rest
      // of the row. Column col of the 2 x 3H goes to CTA col / share, slot
      // (rank * rpc + grp) of its share.
      if (size > 1) cluster_wait();  // every CTA of the cluster runs
      // With two units a chunk, lanes 2m and 2m + 1 hold four consecutive columns: the even
      // lane sends dgamma's four, the odd lane dbeta's, in one 16-byte store each (every
      // lane takes part in the exchange; H % 4 == 0 keeps the pairs whole).
      const bool paired = VEC == 2 && size > 1 && chunks % 2 == 0;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = t + i * tpr;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if constexpr (VEC == 2) {
            if (paired) {
              const bool odd = threadIdx.x & 1;
              const float a0 = ag[k][i].v[0], a1 = ag[k][i].v[1], b0 = ab[k][i].v[0], b1 = ab[k][i].v[1];
              const float mine0 = odd ? b0 : a0, mine1 = odd ? b1 : a1;  // what this lane sends
              const float got0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
              const float got1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
              const float four[4] = {odd ? got0 : mine0, odd ? got1 : mine1, odd ? mine0 : got0, odd ? mine1 : got1};
              if (c < chunks) {
                const int col4 = (odd ? width : 0) + k * hidden + (c & ~1) * VEC;
                const int owner = col4 / share;
                float* dst = recv + slot * share + (col4 - owner * share);
                st_async<4>(map_rank(smem_u32(dst), owner), four, map_rank(smem_u32(&recv_bar), owner));
              }
              continue;
            }
          }
          if (c >= chunks) continue;
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            const F32s<VEC>& terms = part == 0 ? ag[k][i] : ab[k][i];
            const int col = part * width + k * hidden + c * VEC;
            if (direct) {
              if (out_row != nullptr)
                terms.write(out_row + col);
              else
                terms.write((part == 0 ? dgamma : dbeta) + k * hidden + c * VEC);
            } else {
              const int owner = col / share;
              float* dst = recv + slot * share + (col - owner * share);
              if (size > 1)
                st_async<VEC>(map_rank(smem_u32(dst), owner), terms.v, map_rank(smem_u32(&recv_bar), owner));
              else
                terms.write(dst);
            }
          }
        }
      }
    }

    const float2 m = group_sum2<kCtaThreads / 32>(s1, s2, pair_slots, grp * wpr, wpr);
    const float m1 = m.x * n_inv, m2 = m.y * n_inv;
    if (row < batch) {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = t + i * tpr;
        if (c < chunks) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            float d[VEC];
#pragma unroll
            for (int j = 0; j < VEC; ++j) d[j] = (dgh[k][i][j] - m1 - (cur.p[k][i].get(j) - mean) * inv * m2) * inv;
            Pack<T, VEC>::store(dproj + row * width + k * hidden + c * VEC, d);
          }
        }
      }
    }
    cur = next;
  }
  if (direct) return;

  // This CTA's share, added over the cluster's groups in (rank, group) order.
  if (size > 1)
    mbar_wait_first(&recv_bar);
  else
    __syncthreads();
  for (int off = threadIdx.x; off < count; off += blockDim.x) {
    float v = 0.0f;
    for (int base = 0; base < slots_in; base += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = base + j < slots_in ? recv[(base + j) * share + off] : 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (base + j < slots_in) v += x[j];
    }
    const int col = first + off;
    if (out_row != nullptr)
      out_row[col] = v;
    else if (col < width)
      dgamma[col] = v;
    else
      dbeta[col - width] = v;
  }
}

// Backward, wide path: one row group of 1024 threads per CTA walking the rows
// blockIdx.x * rows_per_group + j; every pass streams the row again. A thread adds its
// columns' dgamma/dbeta terms into `acc` ([2][3H]: the outputs when the grid is one CTA,
// else this CTA's partial row), read and written by that thread only.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWideThreads)
layernorm_gru_bwd_wide_kernel(const T* __restrict__ proj, const T* __restrict__ h, const float* __restrict__ gamma,
                              const float* __restrict__ beta, const T* __restrict__ g, T* __restrict__ dproj,
                              T* __restrict__ dh, float* __restrict__ dgamma, float* __restrict__ dbeta,
                              float* __restrict__ partials, int batch, int hidden, int rows_per_group, float eps) {
  __shared__ __align__(16) float slots[2][kWideThreads / 32];
  __shared__ __align__(16) float2 pair_slots[kWideThreads / 32];
  launch_dependents();
  const int width = 3 * hidden, chunks = hidden / VEC;
  const float n_inv = 1.0f / (float)width;
  float* acc_g = partials == nullptr ? dgamma : partials + (int64_t)blockIdx.x * 2 * width;
  float* acc_b = partials == nullptr ? dbeta : acc_g + width;
  for (int jr = 0; jr < rows_per_group; ++jr) {
    const int64_t row = (int64_t)blockIdx.x * rows_per_group + jr;
    if (row >= batch) break;  // the same for the whole CTA
    const T* p = proj + row * width;
    float s = 0.0f;
    for (int c = threadIdx.x; c < chunks; c += kWideThreads) {
      Pack<T, VEC> v[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k].load(p + k * hidden + c * VEC);
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) s += v[k].get(j);
    }
    const float mean = group_sum<kWideThreads / 32>(s, slots[0], 0, kWideThreads / 32) * n_inv;
    float q = 0.0f;
    for (int c = threadIdx.x; c < chunks; c += kWideThreads) {
      Pack<T, VEC> v[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) v[k].load(p + k * hidden + c * VEC);
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = v[k].get(j) - mean;
          q += d * d;
        }
    }
    const float inv = rsqrtf(group_sum<kWideThreads / 32>(q, slots[1], 0, kWideThreads / 32) * n_inv + eps);

    // Two passes over the units: first the dgamma/dbeta terms, dh and the dp means, then
    // dp, with the gates recomputed.
    float s1 = 0.0f, s2 = 0.0f, m1 = 0.0f, m2 = 0.0f;
    for (int pass = 0; pass < 2; ++pass) {
      for (int c = threadIdx.x; c < chunks; c += kWideThreads) {
        Pack<T, VEC> v[3], hv, gvec;
        F32s<VEC> gm[3], bt[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          v[k].load(p + k * hidden + c * VEC);
          gm[k].load(gamma + k * hidden + c * VEC);
          bt[k].load(beta + k * hidden + c * VEC);
        }
        hv.load(h + row * hidden + c * VEC);
        gvec.load(g + row * hidden + c * VEC);
        F32s<VEC> ag[3], ab[3];
        if (pass == 0 && jr > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            ag[k].read(acc_g + k * hidden + c * VEC);
            ab[k].read(acc_b + k * hidden + c * VEC);
          }
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int j = 0; j < VEC; ++j) ag[k].v[j] = ab[k].v[j] = 0.0f;
        }
        float dhv[VEC], dp[3][VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float unit[3], n[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            unit[k] = (v[k].get(j) - mean) * inv;
            n[k] = unit[k] * gm[k].v[j] + bt[k].v[j];
          }
          const Gates gt(n[0], n[1], n[2]);
          const float gvv = gvec.get(j), hvv = hv.get(j);
          dhv[j] = gvv * (1.0f - gt.update);
          const float dt = gvv * gt.update * (1.0f - gt.cand * gt.cand);
          const float dn[3] = {dt * n[1] * gt.reset * (1.0f - gt.reset), dt * gt.reset,
                               gvv * (gt.cand - hvv) * gt.update * (1.0f - gt.update)};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float dgh = dn[k] * gm[k].v[j];
            s1 += dgh;
            s2 += dgh * unit[k];
            ag[k].v[j] += dn[k] * unit[k];
            ab[k].v[j] += dn[k];
            dp[k][j] = (dgh - m1 - unit[k] * m2) * inv;
          }
        }
        if (pass == 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            ag[k].write(acc_g + k * hidden + c * VEC);
            ab[k].write(acc_b + k * hidden + c * VEC);
          }
          Pack<T, VEC>::store(dh + row * hidden + c * VEC, dhv);
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k) Pack<T, VEC>::store(dproj + row * width + k * hidden + c * VEC, dp[k]);
        }
      }
      if (pass == 0) {
        const float2 m = group_sum2<kWideThreads / 32>(s1, s2, pair_slots, 0, kWideThreads / 32);
        m1 = m.x * n_inv, m2 = m.y * n_inv;
      }
    }
  }
}

// The second launch of a two-launch backward: dgamma[c] = sum_r partials[r][c] and
// dbeta[c] = sum_r partials[r][3H + c], r in order; one thread per column.
__global__ void __launch_bounds__(kSumThreads)
layernorm_gru_bwd_sum_kernel(const float* __restrict__ partials, float* __restrict__ dgamma, float* __restrict__ dbeta,
                             int rows, int width) {
  wait_for_prerequisites();
  const int col = blockIdx.x * kSumThreads + threadIdx.x;
  if (col >= 2 * width) return;
  float v = 0.0f;
  for (int r = 0; r < rows; ++r) v += partials[(int64_t)r * 2 * width + col];
  if (col < width)
    dgamma[col] = v;
  else
    dbeta[col - width] = v;
}

// ---------------------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------------------

// The launch configuration of `grid` CTAs of `threads`, with `smem` bytes of dynamic
// shared memory, in clusters of `cluster` CTAs along x when it is positive; with
// `after_previous`, a programmatic dependent launch on the stream's previous kernel.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  Launch(int grid, int threads, int cluster, int smem, cudaStream_t stream, bool after_previous) : cfg{}, attr{} {
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    if (cluster > 0) {
      attr[cfg.numAttrs].id = cudaLaunchAttributeClusterDimension;
      attr[cfg.numAttrs].val.clusterDim.x = cluster;
      attr[cfg.numAttrs].val.clusterDim.y = 1;
      attr[cfg.numAttrs].val.clusterDim.z = 1;
      ++cfg.numAttrs;
    }
    if (after_previous) {
      attr[cfg.numAttrs].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr[cfg.numAttrs].val.programmaticStreamSerializationAllowed = 1;
      ++cfg.numAttrs;
    }
  }
};

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Launch& l, Args... args) {
  const cudaError_t err = cudaLaunchKernelEx(&l.cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// Calls f(T{}, Int<U>{}, Int<VEC>{}) for the type code (0 float32, 1 bfloat16), units
// (2 or 4) and vec (units, or 1): the narrow path's instantiations.
template <typename F>
int with_rows(int dtype, int units, int vec, F&& f) {
  auto by_units = [&](auto a) {
    if (units == kSmallUnits) return vec == 1 ? f(a, Int<kSmallUnits>{}, Int<1>{}) : f(a, Int<kSmallUnits>{}, Int<kSmallUnits>{});
    return vec == 1 ? f(a, Int<kLargeUnits>{}, Int<1>{}) : f(a, Int<kLargeUnits>{}, Int<kLargeUnits>{});
  };
  if (dtype == 0) return by_units(float{});
  if (dtype == 1) return by_units(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}

// Calls f(T{}, Int<VEC>{}) for the wide path (VEC kWideVec, or 1).
template <typename F>
int with_wide(int dtype, int vec, F&& f) {
  if (dtype == 0) return vec == 1 ? f(float{}, Int<1>{}) : f(float{}, Int<kWideVec>{});
  if (dtype == 1) return vec == 1 ? f(__nv_bfloat16{}, Int<1>{}) : f(__nv_bfloat16{}, Int<kWideVec>{});
  return (int)cudaErrorInvalidValue;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

int check(int batch, int hidden) { return batch <= 0 || hidden <= 0 ? (int)cudaErrorInvalidValue : 0; }
int check(int batch, int hidden, int dtype) { return dtype != 0 && dtype != 1 ? (int)cudaErrorInvalidValue : check(batch, hidden); }

}  // namespace

// Every entry returns 0 or a CUDA error code; cudaErrorInvalidValue for a shape, type or
// argument the kernels do not take. dtype: 0 = float32, 1 = bfloat16 (proj, h, g and the
// outputs of the same name share it; gamma, beta, dgamma, dbeta and partials are f32).
// aligned: 1 when every operand and output pointer is 16-byte aligned (the vector path;
// checked), else 0.

// Once per device, before the first backward launch: lets the backward's CTAs form
// clusters of 16 (more than the portable 8).
extern "C" int layernorm_gru_setup() {
  int err = 0;
  for (int dtype = 0; dtype < 2 && err == 0; ++dtype)
    for (int units : {kSmallUnits, kLargeUnits})
      for (int vec : {1, units})
        if (err == 0)
          err = with_rows(dtype, units, vec, [&](auto a, auto u, auto v) {
            return (int)cudaFuncSetAttribute(layernorm_gru_bwd_kernel<decltype(a), decltype(u)::value, decltype(v)::value>,
                                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
          });
  return err;
}

// The launch plan of a shape, kGeometryFields ints into `out` in the order of `Geometry`.
extern "C" int layernorm_gru_geometry(int batch, int hidden, int aligned, int* out) {
  if (const int bad = check(batch, hidden)) return bad;
  const Geometry g = geometry(batch, hidden, aligned != 0);
  const int fields[kGeometryFields] = {g.units,         g.vec,      g.path,         g.threads_per_row,
                                       g.rows_per_cta,  g.fwd_grid, g.rows_per_group, g.bwd_grid,
                                       g.cluster,       g.bwd_launches, g.partial_rows, g.bwd_smem};
  for (int i = 0; i < kGeometryFields; ++i) out[i] = fields[i];
  return 0;
}

// The forward: out [B, H] in h's type, one launch.
extern "C" int layernorm_gru_fwd(const void* proj, const void* h, const void* gamma, const void* beta, void* out,
                                 int batch, int hidden, float eps, int dtype, int aligned, void* stream) {
  if (const int bad = check(batch, hidden, dtype)) return bad;
  if (aligned && !aligned16({proj, h, gamma, beta, out})) return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(batch, hidden, aligned != 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  if (geo.path == kWide)
    return with_wide(dtype, geo.vec, [&](auto a, auto v) {
      using T = decltype(a);
      return launch(layernorm_gru_fwd_wide_kernel<T, decltype(v)::value>, Launch(batch, kWideThreads, 0, 0, s, false),
                    static_cast<const T*>(proj), static_cast<const T*>(h), gm, bt, static_cast<T*>(out), hidden, eps);
    });
  return with_rows(dtype, geo.units, geo.vec, [&](auto a, auto u, auto v) {
    using T = decltype(a);
    constexpr int U = decltype(u)::value, VEC = decltype(v)::value;
    const Launch l(geo.fwd_grid, geo.rows_per_cta * geo.threads_per_row, 0, 0, s, false);
    return launch(layernorm_gru_fwd_kernel<T, U, VEC>, l, static_cast<const T*>(proj), static_cast<const T*>(h), gm, bt, static_cast<T*>(out), batch,
                  hidden, geo.threads_per_row, eps);
  });
}

// The backward: dproj, dh, dgamma and dbeta written in full. `partials` holds
// geometry().partial_rows * 2 * 3H floats (null when that is 0).
extern "C" int layernorm_gru_bwd(const void* proj, const void* h, const void* gamma, const void* beta, const void* g,
                                 void* dproj, void* dh, void* dgamma, void* dbeta, void* partials, int batch, int hidden,
                                 float eps, int dtype, int aligned, void* stream) {
  if (const int bad = check(batch, hidden, dtype)) return bad;
  if (hidden > kMaxBwdHidden) return (int)cudaErrorInvalidValue;
  if (aligned && !aligned16({proj, h, gamma, beta, g, dproj, dh, dgamma, dbeta, partials})) return (int)cudaErrorInvalidValue;
  const Geometry geo = geometry(batch, hidden, aligned != 0);
  if ((geo.partial_rows > 0) != (partials != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* part = static_cast<float*>(partials);
  const int err =
      geo.path == kWide
          ? with_wide(dtype, geo.vec,
                      [&](auto a, auto v) {
                        using T = decltype(a);
                        return launch(layernorm_gru_bwd_wide_kernel<T, decltype(v)::value>,
                                      Launch(geo.bwd_grid, kWideThreads, 0, 0, s, false), static_cast<const T*>(proj),
                                      static_cast<const T*>(h), gm, bt, static_cast<const T*>(g), static_cast<T*>(dproj),
                                      static_cast<T*>(dh), dg, db, part, batch, hidden, geo.rows_per_group, eps);
                      })
          : with_rows(dtype, geo.units, geo.vec, [&](auto a, auto u, auto v) {
              using T = decltype(a);
              const Launch l(geo.bwd_grid, geo.rows_per_cta * geo.threads_per_row, geo.cluster, geo.bwd_smem, s, false);
              return launch(layernorm_gru_bwd_kernel<T, decltype(u)::value, decltype(v)::value>, l,
                            static_cast<const T*>(proj), static_cast<const T*>(h), gm, bt, static_cast<const T*>(g),
                            static_cast<T*>(dproj), static_cast<T*>(dh), dg, db, part, batch, hidden,
                            geo.threads_per_row, geo.rows_per_group, eps);
            });
  if (err != 0 || geo.bwd_launches == 1) return err;
  const int width = 3 * hidden;
  return launch(layernorm_gru_bwd_sum_kernel,
                Launch((2 * width + kSumThreads - 1) / kSumThreads, kSumThreads, 0, 0, s, true),
                static_cast<const float*>(part), dg, db, geo.partial_rows, width);
}

// cudaOccupancyMaxActiveClusters for the backward's main kernel at this shape: how many of
// its clusters (geometry().cluster CTAs each) the current device holds at once.
extern "C" int layernorm_gru_max_active_clusters(int batch, int hidden, int dtype, int aligned, int* out) {
  if (const int bad = check(batch, hidden, dtype)) return bad;
  const Geometry geo = geometry(batch, hidden, aligned != 0);
  if (geo.path == kWide)
    return with_wide(dtype, geo.vec, [&](auto a, auto v) {
      const Launch l(geo.bwd_grid, kWideThreads, 1, 0, nullptr, false);
      return (int)cudaOccupancyMaxActiveClusters(out, layernorm_gru_bwd_wide_kernel<decltype(a), decltype(v)::value>,
                                                 &l.cfg);
    });
  return with_rows(dtype, geo.units, geo.vec, [&](auto a, auto u, auto v) {
    const Launch l(geo.bwd_grid, geo.rows_per_cta * geo.threads_per_row, geo.cluster, geo.bwd_smem, nullptr, false);
    return (int)cudaOccupancyMaxActiveClusters(
        out, layernorm_gru_bwd_kernel<decltype(a), decltype(u)::value, decltype(v)::value>, &l.cfg);
  });
}
