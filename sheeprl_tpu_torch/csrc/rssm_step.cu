// Fused RSSM step, forward and backward (Hopper, sm_90a): the [B, K] @ [K, 3H] product,
// the LayerNorm over its 3H columns and the GRU gates in one kernel each way.
//
// Replace sheeprl_tpu/ops/rssm_step.py::_fused_step_fwd / _fwd_kernel and
// _fused_step_bwd / _bwd_kernel, the Pallas kernels that keep the whole step (weights
// included) in a TPU core's VMEM. The forward:
//
//   p  = xh @ w                               f32 accumulation of xh's and w's type
//   n  = LayerNorm(p) * gamma + beta          over the 3H axis, two-pass variance, f32
//   r  = sigmoid(n[0:H]); c = tanh(r * n[H:2H]); u = sigmoid(n[2H:3H] - 1)
//   h' = u * c + (1 - u) * h
//
// Shapes: xh [B, K], w [K, 3H] (the JAX layout), h [B, H], gamma/beta [3H], out [B, H].
// xh and w share float32 or bfloat16; h (and out) are float32 or bfloat16; gamma and beta
// share float32 or bfloat16. The projection is never written to device memory.
//
// What bounds it on an H100 (80 GB HBM3, 700 W). At the RSSM unroll's shape (B 16, K 1024,
// H 512) the step does 2 * 16 * 1024 * 1536 = 50 MFLOP against 3.1 MB of w in bf16 (6.3 MB
// in f32): ~16 operations per byte, far below the ~295 at which bf16 tensor cores stop
// waiting for memory, so moving w bounds it (0.94 us at 3.35 TB/s in bf16; less where w
// stays in the 50 MB L2 across a scan's 64 steps). f32 operands must not go through TF32,
// so their product runs as FFMA on the CUDA cores: 50 MFLOP at 67 TFLOP/s is 0.75 us,
// also below the 1.9 us of w's bytes.
//
// Design. The Pallas design holds w in VMEM; w does not fit in one SM's 227 KB, so here
// w streams through shared memory in K-tiles, and the LayerNorm's need for whole 3H rows
// is met by a thread-block cluster:
//
// * A cluster of C = H / 32 blocks (at most 16, a non-portable cluster size) takes a
//   tile of 16 rows. Block `rank` owns the 32 hidden units [32 rank, 32 rank + 32), that
//   is the 96 projection columns {j, H + j, 2H + j} of those units, so the gates of a
//   unit need only the block's own columns.
// * The block streams w[K-tile, its 96 columns] (one TMA box of w viewed as [K][3][H])
//   and xh[16 rows, K-tile] (2-D boxes of 128-byte rows) into shared memory, swizzled
//   by the TMA so that the fragment loads meet no bank conflict; bf16 in tiles of 128
//   along K, f32 in tiles of 32, three stages deep, each completing on an mbarrier. The
//   [16, 96] product stays in registers, each half of the warps taking half of every
//   K-tile: bf16 through ldmatrix and mma.sync m16n8k16 with f32 accumulators, f32 as
//   FFMA with the same fragment layout (no TF32). The gates' operands (gamma, beta, h)
//   are loaded before the K-loop, so that their latency hides behind it.
// * Each row's mean, then its centred sum of squares (the two-pass variance of the
//   reference), is a sum of the C blocks' partials, read through distributed shared
//   memory in rank order, so every block gets the same statistics, deterministically.
// * The forward's grid is C blocks per 16-row tile: at B = 16 one cluster of 16 SMs.
//
// Backward. Given g = dL/dh', it recomputes p, the statistics and the gates, then
//
//   dh = g (1 - u);  dn (the gate gradients, as in layernorm_gru.cu)
//   dgamma = sum_rows dn * unit,  dbeta = sum_rows dn      (f32, cast to gamma's type)
//   dp = (dn gamma - mean(dn gamma) - unit * mean(dn gamma unit)) * inv, rounded to xh's
//        type before both products, as the reference does
//   dxh = dp @ w^T  (xh's type),   dw = xh^T @ dp  (w's type)
//
// One cluster of C blocks walks all the row tiles, so the sums over rows (dw, dgamma,
// dbeta) stay inside the block that owns the columns: no partial rows in device memory,
// no second launch, no float atomics. Per row tile the block recomputes its [16, 96]
// projection (one pass over its w columns), reduces the row statistics and the two dp
// means through DSMEM, keeps dp for every row in shared memory, and forms its share of
// dxh = dp[:, its columns] @ w[:, its columns]^T over all K (a second pass over its w
// columns) in shared memory; block `rank` then sums slice `rank` of K over the C blocks
// in rank order and writes it. Last, dw[K-tile, its columns] = xh[:, K-tile]^T @ dp
// streams xh once more (each warp one 16-row slice of the K-tile, all 96 columns) and
// leaves through shared memory in 16-byte stores. The backward
// runs on C SMs whatever B is: at B = 16 as wide as the forward, at B = 256 16 row tiles
// in sequence (the JAX package's Pallas kernel is a single tile too).
//
// Limits (the wrapper's `fused_step_supported` holds the same numbers): H a multiple of
// 32 and at most 512, K a multiple of 8, and the backward's shared memory (dp for every
// row and a [16, K] f32 dxh share) within 232,448 bytes.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 32;                // hidden units per block
constexpr int kCols = 3 * kUnits;         // projection columns per block
constexpr int kColTiles = kCols / 8;      // mma n-tiles per block
constexpr int kRows = 16;                 // rows per tile (the mma's M)
// K per streamed tile, three stages deep: bf16 tiles of 128 (a 24 KB w box: TMA streams
// boxes of this size about twice as fast per SM as boxes of 64 rows), f32 tiles of 32 (f32
// at B = 256, K = 1024 fits the backward's budget so).
__host__ __device__ constexpr int tile_k(int elem) { return elem == 2 ? 128 : 32; }
__host__ __device__ constexpr int tile_stages(int) { return 3; }
// dp in shared memory is [rows][kCols + 16 bytes], so that the ldmatrix rows fall in
// distinct banks; the TMA tiles use the TMA's swizzle instead (x_at, w_at).
__host__ __device__ constexpr int ld_dp(int elem) { return kCols + 16 / elem; }
constexpr int kMaxCluster = 16;
constexpr int kSmemLimit = 232448;        // a block's shared memory on sm_90

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + __expf(-x)); }

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// ldmatrix: the lanes 8 i .. 8 i + 7 give the addresses of the 8 rows (16 bytes each) of
// matrix i, and register i of lane t receives row t / 4, elements 2 (t % 4) and 2 (t % 4) + 1
// of matrix i (of its transpose with .trans): the mma fragments below, in one instruction.
__device__ __forceinline__ unsigned smem_addr(const void* p) { return static_cast<unsigned>(__cvta_generic_to_shared(p)); }
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// c += a @ b for one m16n8k16 tile: bf16 operands, f32 accumulators. Fragments (PTX ISA):
// a[0] (row gid, k 2 tig..+1), a[1] (row gid + 8, same k), a[2] (row gid, k 2 tig + 8..+9),
// a[3] (row gid + 8, k 2 tig + 8..+9); b[0] (k 2 tig..+1, n gid), b[1] (k 2 tig + 8..+9,
// n gid); c[0..1] (row gid, n 2 tig..+1), c[2..3] (row gid + 8, n 2 tig..+1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The device's clock in ns, for mbar_wait's time limit.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The Tensor Memory Accelerator: one thread asks for a whole box of a tensor, and the
// copy's bytes complete a transaction on an mbarrier in shared memory.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Wait for the phase of parity `parity` to complete. A copy that never lands (a fault in a
// tensor map) traps after 2 s of waiting, so that the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  const unsigned long long start = global_ns();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (global_ns() - start > 2000000000ull) __trap();
  }
}
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// Load the box of `map` at `coords` (innermost first) into dst; completes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap& map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap& map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The tiles in shared memory, as the TMA writes them with its swizzle: within each 1024-byte
// span, the 16-byte chunk c of a 128-byte row r (64-byte rows: chunk c of row r) moves to
// chunk c ^ (r % 8) (c ^ ((r / 2) % 4)), so that 8 rows of one column chunk fall in
// distinct banks. The xh tile is BK * elem / 128 boxes of [kRows][128 bytes]
// (SWIZZLE_128B); the w tile is [BK][3][kUnits] of w viewed as [K][3][H], in 64-byte rows
// for bf16 (SWIZZLE_64B) and 128-byte rows for f32 (SWIZZLE_128B).
template <int Bits>
__device__ __forceinline__ int swizzle(int offset) {
  return offset ^ (((offset >> 7) & ((1 << Bits) - 1)) << 4);
}
template <typename TI>
constexpr int kXBoxCols = 128 / sizeof(TI);  // xh columns per 128-byte box row
// Element (r, k) of an xh tile, k in [0, BK).
template <typename TI>
__device__ __forceinline__ const TI* x_at(const TI* xs, int r, int k) {
  const int box = k / kXBoxCols<TI>, offset = r * 128 + (k % kXBoxCols<TI>)*(int)sizeof(TI);
  return reinterpret_cast<const TI*>(reinterpret_cast<const char*>(xs) + box * kRows * 128 + swizzle<3>(offset));
}
// Element (k, c) of a w tile, c a local column (gate c / 32, unit c % 32).
template <typename TI>
__device__ __forceinline__ const TI* w_at(const TI* ws, int k, int c) {
  const int offset = ((k * 3 + c / kUnits) * kUnits + c % kUnits) * (int)sizeof(TI);
  return reinterpret_cast<const TI*>(reinterpret_cast<const char*>(ws) +
                                     (sizeof(TI) == 2 ? swizzle<2>(offset) : swizzle<3>(offset)));
}
// The w tile of K offset k0: one box of w viewed as [K][3][H], units from unit0.
template <typename TI>
__device__ __forceinline__ void load_w(TI* dst, const CUtensorMap& w_map, uint64_t* bar, int unit0, int k0) {
  tma_load_3d(dst, w_map, bar, unit0, 0, k0);
}
// The xh tile of rows row0.. at K offset k0: one box per 128 bytes of columns.
template <typename TI>
__device__ __forceinline__ void load_x(TI* dst, const CUtensorMap& x_map, uint64_t* bar, int row0, int k0) {
  for (int box = 0; box < tile_k(sizeof(TI)) / kXBoxCols<TI>; ++box)
    tma_load_2d(reinterpret_cast<char*>(dst) + box * kRows * 128, x_map, bar, k0 + box * kXBoxCols<TI>, row0);
}
template <typename TI>
constexpr unsigned kWTileBytes = tile_k(sizeof(TI)) * kCols * sizeof(TI);
template <typename TI>
constexpr unsigned kXTileBytes = kRows * tile_k(sizeof(TI)) * sizeof(TI);

// A pipeline of `Stages` buffers, each with its mbarrier: issue(step, stage, bar), run by
// thread 0, starts the copies of a step and announces their bytes on `bar`;
// compute(step, stage) consumes them once they have landed, while the copies of the next
// Stages - 1 steps are in flight. `ring` counts the buffer uses of the kernel so far,
// which gives each barrier's phase. Ends with a barrier of the block.
template <int Stages, typename Issue, typename Compute>
__device__ __forceinline__ void pipeline(int steps, unsigned& ring, uint64_t* bars, Issue&& issue, Compute&& compute) {
  // The buffers are only read between copies (ldmatrix and loads), which the barriers
  // order before the next copy; a proxy fence first orders any earlier write of the block.
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < Stages - 1 && s < steps; ++s) issue(s, (ring + s) % Stages, bars + (ring + s) % Stages);
  for (int s = 0; s < steps; ++s) {
    const unsigned slot = ring + s;
    mbar_wait(bars + slot % Stages, (slot / Stages) & 1);  // step s has landed
    __syncthreads();  // ... and every thread is done with step s - 1's buffer
    if (threadIdx.x == 0 && s + Stages - 1 < steps) {
      const unsigned next = slot + Stages - 1;
      issue(s + Stages - 1, next % Stages, bars + next % Stages);
    }
    compute(s, slot % Stages);
  }
  ring += steps;
  __syncthreads();
}

// The global column of a block's local column c: gate c / 32, unit unit0 + c % 32.
__device__ __forceinline__ int global_col(int c, int hidden, int unit0) {
  return (c / kUnits) * hidden + unit0 + (c % kUnits);
}

// p_s [kRows][kCols] (f32) = xh[row0:row0+kRows] @ w[:, the block's columns]. Warp w owns
// the n-tiles w % 4, w % 4 + 4 and w % 4 + 8 over half of each K-tile (warps 0-3 the first,
// 4-7 the second), three independent accumulators each; the halves are added at the end,
// the first plus the second.
template <typename TI, int kBK = tile_k(sizeof(TI)), int kStages = tile_stages(sizeof(TI))>
__device__ void project(float* p_s, TI* w_s, TI* x_s, uint64_t* bars, unsigned& ring, const CUtensorMap& w_map,
                        const CUtensorMap& x_map, int row0, int K, int unit0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;  // the ldmatrix matrix and row this lane addresses
  const int half = warp / 4, k_lo = half * kBK / 2, k_hi = k_lo + kBK / 2;
  float acc[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  pipeline<kStages>(
      (K + kBK - 1) / kBK, ring, bars,
      [&](int step, int stage, uint64_t* bar) {
        mbar_expect(bar, kWTileBytes<TI> + kXTileBytes<TI>);
        load_w(w_s + stage * kBK * kCols, w_map, bar, unit0, step * kBK);
        load_x(x_s + stage * kRows * kBK, x_map, bar, row0, step * kBK);
      },
      [&](int, int stage) {
        const TI* ws = w_s + stage * kBK * kCols;
        const TI* xs = x_s + stage * kRows * kBK;
        if constexpr (kIsBf16<TI>) {
#pragma unroll
          for (int kb = k_lo; kb < k_hi; kb += 16) {
            // A = xs rows [0, 16) x k [kb, kb + 16); B = ws k [kb, kb + 16) x n [n0, n0 + 8), transposed
            uint32_t a[4];
            ldsm_x4(a, x_at(xs, mrow + 8 * (mat & 1), kb + 8 * (mat >> 1)));
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              uint32_t b[2];
              ldsm_x2_t(b, w_at(ws, kb + mrow + 8 * (mat & 1), (warp % 4 + 4 * i) * 8));
              mma_bf16(acc[i], a, b);
            }
          }
        } else {
          for (int k4 = k_lo; k4 < k_hi; k4 += 4) {  // a 16-byte chunk of xh, then w's rows one by one
            const float4 xa = *reinterpret_cast<const float4*>(x_at(xs, gid, k4));
            const float4 xb = *reinterpret_cast<const float4*>(x_at(xs, gid + 8, k4));
            const float x0[4] = {xa.x, xa.y, xa.z, xa.w}, x1[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int i = 0; i < 3; ++i) {
                const float2 wv = *reinterpret_cast<const float2*>(w_at(ws, k4 + e, (warp % 4 + 4 * i) * 8 + 2 * tig));
                acc[i][0] = fmaf(x0[e], wv.x, acc[i][0]);
                acc[i][1] = fmaf(x0[e], wv.y, acc[i][1]);
                acc[i][2] = fmaf(x1[e], wv.x, acc[i][2]);
                acc[i][3] = fmaf(x1[e], wv.y, acc[i][3]);
              }
          }
        }
      });
  for (int turn = 1; turn >= 0; --turn) {  // the second half stores, then the first adds
    if (half == turn) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int c = (warp % 4 + 4 * i) * 8 + 2 * tig;
        float* p0 = p_s + gid * kCols + c;
        float* p1 = p_s + (gid + 8) * kCols + c;
        if (turn == 1) {
          p0[0] = acc[i][0], p0[1] = acc[i][1], p1[0] = acc[i][2], p1[1] = acc[i][3];
        } else {
          p0[0] = acc[i][0] + p0[0], p0[1] = acc[i][1] + p0[1], p1[0] = acc[i][2] + p1[0], p1[1] = acc[i][3] + p1[1];
        }
      }
    }
    __syncthreads();
  }
}

// Row sums over the block's columns of f(r, c) into red[slot][r]; warp w takes rows 2w, 2w + 1.
template <typename F>
__device__ __forceinline__ void row_partials(float* red, int slot, F&& f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 2 * warp + rr;
    float s = 0.0f;
    for (int c = lane; c < kCols; c += 32) s += f(r, c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) red[slot * kRows + r] = s;
  }
}

// The sum over the cluster's blocks, in rank order, of `v[idx]` in each block's shared
// memory. All the remote loads are issued before the first add.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster, float* v, int idx) {
  const unsigned n = cluster.num_blocks();
  float part[kMaxCluster];
#pragma unroll
  for (unsigned q = 0; q < kMaxCluster; ++q) part[q] = q < n ? cluster.map_shared_rank(v, q)[idx] : 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) s += part[q];  // adding the zeros past n changes nothing
  return s;
}

// stat[slot][r] = scale * (the sum over the cluster's blocks, in rank order, of their
// red[slot][r]) for `nslots` slots from `slot`. Every block gets the same values.
__device__ __forceinline__ void cluster_row_sums(cg::cluster_group& cluster, float* red, float* stat, int slot,
                                                 int nslots, float scale) {
  cluster.sync();
  const int t = threadIdx.x;
  if (t < nslots * kRows) {
    const int idx = slot * kRows + t;
    stat[idx] = cluster_sum(cluster, red, idx) * scale;
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// The (row, unit) pairs of a tile: thread t takes the pairs t and t + kThreads.
constexpr int kPairs = kRows * kUnits / kThreads;
__device__ __forceinline__ int pair_row(int q) { return (threadIdx.x + q * kThreads) / kUnits; }
__device__ __forceinline__ int pair_unit(int q) { return (threadIdx.x + q * kThreads) % kUnits; }

// Thread 0 makes the pipeline's mbarriers, one arrival each, before any copy is issued.
template <int Stages>
__device__ __forceinline__ void init_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < Stages; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Shared-memory layout of both kernels, from a base aligned to 1024 bytes (the span of the
// TMA's swizzle): every region a multiple of 16 bytes, the TMA tiles and their stages at
// multiples of 1024, the mbarriers last.
struct Smem {
  int w_s, x_s, p_s, red, stat, dn_s, acc, dp_s, dx_s, bars, total;
};

__host__ __device__ inline Smem smem_layout(int elem, int batch, int K, bool backward) {
  Smem s{};
  s.w_s = 0;
  s.x_s = s.w_s + tile_stages(elem) * tile_k(elem) * kCols * elem;
  s.p_s = s.x_s + tile_stages(elem) * kRows * tile_k(elem) * elem;
  s.red = s.p_s + kRows * kCols * 4;
  s.stat = s.red + 4 * kRows * 4;
  s.total = s.stat + 4 * kRows * 4;
  if (backward) {
    const int padded = (batch + kRows - 1) / kRows * kRows;
    s.dn_s = s.total;
    s.acc = s.dn_s + kRows * kCols * 4;
    s.dp_s = s.acc + 4 * kCols * 4;
    s.dx_s = s.dp_s + padded * ld_dp(elem) * elem;
    s.total = s.dx_s + kRows * K * 4;
  }
  s.bars = s.total;
  s.total = s.bars + tile_stages(elem) * 8 + 1024;  // and the room to align the base to 1024
  return s;
}

template <typename TI, typename TH, typename TG>
__global__ void __launch_bounds__(kThreads)
rssm_step_fwd_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                     const TH* __restrict__ h, const TG* __restrict__ gamma, const TG* __restrict__ beta,
                     TH* __restrict__ out, int batch, int K, int hidden, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const Smem L = smem_layout(sizeof(TI), batch, K, false);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  unsigned ring = 0;
  init_barriers<tile_stages(sizeof(TI))>(bars);
  TI* w_s = reinterpret_cast<TI*>(smem + L.w_s);
  TI* x_s = reinterpret_cast<TI*>(smem + L.x_s);
  float* p_s = reinterpret_cast<float*>(smem + L.p_s);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* stat = reinterpret_cast<float*>(smem + L.stat);
  const int unit0 = cluster.block_rank() * kUnits;
  const int row0 = blockIdx.x / cluster.num_blocks() * kRows;
  const float inv_n = 1.0f / (3.0f * hidden);
  // The gates' operands of this thread's kPairs (row, unit) pairs, loaded before the
  // projection so that their latency hides behind it.
  float gam[kPairs][3], bet[kPairs][3], hv[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int r = pair_row(q), j = unit0 + pair_unit(q), row = row0 + r;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gam[q][k] = to_f32(gamma[k * hidden + j]);
      bet[q][k] = to_f32(beta[k * hidden + j]);
    }
    hv[q] = row < batch ? to_f32(h[(int64_t)row * hidden + j]) : 0.0f;
  }
  project(p_s, w_s, x_s, bars, ring, w_map, x_map, row0, K, unit0);
  row_partials(red, 0, [&](int r, int c) { return p_s[r * kCols + c]; });
  cluster_row_sums(cluster, red, stat, 0, 1, inv_n);  // stat[0] = mean
  row_partials(red, 1, [&](int r, int c) {
    const float d = p_s[r * kCols + c] - stat[r];
    return d * d;
  });
  cluster_row_sums(cluster, red, stat, 1, 1, inv_n);  // stat[1] = variance

#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int r = pair_row(q), u = pair_unit(q), row = row0 + r, j = unit0 + u;
    if (row >= batch) continue;
    const float mean = stat[r], inv = rsqrtf(stat[kRows + r] + eps);
    float n[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = (p_s[r * kCols + k * kUnits + u] - mean) * inv * gam[q][k] + bet[q][k];
    const float reset = sigmoidf(n[0]);
    const float cand = tanhf(reset * n[1]);
    const float update = sigmoidf(n[2] - 1.0f);
    out[(int64_t)row * hidden + j] = from_f32<TH>(update * cand + (1.0f - update) * hv[q]);
  }
  cluster.sync();  // the other blocks may still read this block's `red`
}

template <typename TI, typename TH, typename TG>
__global__ void __launch_bounds__(kThreads)
rssm_step_bwd_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                     const TH* __restrict__ h, const TG* __restrict__ gamma, const TG* __restrict__ beta,
                     const TH* __restrict__ g, TI* __restrict__ dxh, TH* __restrict__ dh, TI* __restrict__ dw,
                     TG* __restrict__ dgamma, TG* __restrict__ dbeta, int batch, int K, int hidden, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const Smem L = smem_layout(sizeof(TI), batch, K, true);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  unsigned ring = 0;
  init_barriers<tile_stages(sizeof(TI))>(bars);
  TI* w_s = reinterpret_cast<TI*>(smem + L.w_s);
  TI* x_s = reinterpret_cast<TI*>(smem + L.x_s);
  float* p_s = reinterpret_cast<float*>(smem + L.p_s);  // the projection, then `unit`
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* stat = reinterpret_cast<float*>(smem + L.stat);  // mean, variance, m1, m2 per row
  float* dn_s = reinterpret_cast<float*>(smem + L.dn_s);
  float* acc_g = reinterpret_cast<float*>(smem + L.acc);  // dgamma, then dbeta, per column
  float* acc_b = acc_g + kCols;
  float* gam_s = acc_b + kCols;  // gamma and beta of the block's columns, in f32
  float* bet_s = gam_s + kCols;
  TI* dp_s = reinterpret_cast<TI*>(smem + L.dp_s);  // [padded B][kLdP]
  float* dx_s = reinterpret_cast<float*>(smem + L.dx_s);  // [kRows][K]

  const int rank = cluster.block_rank(), nranks = cluster.num_blocks();
  const int unit0 = rank * kUnits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;
  const float inv_n = 1.0f / (3.0f * hidden);
  const int row_tiles = (batch + kRows - 1) / kRows;
  constexpr int kBK = tile_k(sizeof(TI)), kStages = tile_stages(sizeof(TI));
  constexpr int kLdP = ld_dp(sizeof(TI));
  const int k_tiles = (K + kBK - 1) / kBK;
  const int64_t three_h = 3 * (int64_t)hidden;

  for (int c = threadIdx.x; c < kCols; c += kThreads) {
    acc_g[c] = acc_b[c] = 0.0f;
    gam_s[c] = to_f32(gamma[global_col(c, hidden, unit0)]);
    bet_s[c] = to_f32(beta[global_col(c, hidden, unit0)]);
  }

  for (int rt = 0; rt < row_tiles; ++rt) {
    const int row0 = rt * kRows;
    float hv[kPairs], gv[kPairs];  // loaded before the projection, as in the forward
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int row = row0 + pair_row(q), j = unit0 + pair_unit(q);
      hv[q] = row < batch ? to_f32(h[(int64_t)row * hidden + j]) : 0.0f;
      gv[q] = row < batch ? to_f32(g[(int64_t)row * hidden + j]) : 0.0f;
    }
    project(p_s, w_s, x_s, bars, ring, w_map, x_map, row0, K, unit0);
    row_partials(red, 0, [&](int r, int c) { return p_s[r * kCols + c]; });
    cluster_row_sums(cluster, red, stat, 0, 1, inv_n);
    row_partials(red, 1, [&](int r, int c) {
      const float d = p_s[r * kCols + c] - stat[r];
      return d * d;
    });
    cluster_row_sums(cluster, red, stat, 1, 1, inv_n);

    // Gates and their gradients; p_s becomes `unit`, dn_s the gate gradients.
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int r = pair_row(q), u = pair_unit(q), row = row0 + r, j = unit0 + u;
      const float mean = stat[r], inv = rsqrtf(stat[kRows + r] + eps);
      float unit[3], n[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        unit[k] = (p_s[r * kCols + k * kUnits + u] - mean) * inv;
        n[k] = unit[k] * gam_s[k * kUnits + u] + bet_s[k * kUnits + u];
      }
      const float reset = sigmoidf(n[0]);
      const float cand = tanhf(reset * n[1]);
      const float update = sigmoidf(n[2] - 1.0f);
      if (row < batch) dh[(int64_t)row * hidden + j] = from_f32<TH>(gv[q] * (1.0f - update));
      const float dt = gv[q] * update * (1.0f - cand * cand);
      const float dn[3] = {dt * n[1] * reset * (1.0f - reset), dt * reset,
                           gv[q] * (cand - hv[q]) * update * (1.0f - update)};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p_s[r * kCols + k * kUnits + u] = unit[k];
        dn_s[r * kCols + k * kUnits + u] = dn[k];
      }
    }
    __syncthreads();

    // dgamma and dbeta, summed over the rows in order; the LayerNorm backward's two means.
    for (int c = threadIdx.x; c < kCols; c += kThreads) {
      float sg = acc_g[c], sb = acc_b[c];
      for (int r = 0; r < kRows; ++r) {
        sg += dn_s[r * kCols + c] * p_s[r * kCols + c];
        sb += dn_s[r * kCols + c];
      }
      acc_g[c] = sg;
      acc_b[c] = sb;
    }
    row_partials(red, 2, [&](int r, int c) { return dn_s[r * kCols + c] * gam_s[c]; });
    row_partials(red, 3, [&](int r, int c) { return dn_s[r * kCols + c] * gam_s[c] * p_s[r * kCols + c]; });
    cluster_row_sums(cluster, red, stat, 2, 2, inv_n);  // stat[2] = m1, stat[3] = m2

    // dp, rounded to xh's type; zero on the rows past B.
    TI* dp_t = dp_s + row0 * kLdP;
    for (int idx = threadIdx.x; idx < kRows * kCols; idx += kThreads) {
      const int r = idx / kCols, c = idx % kCols;
      const float inv = rsqrtf(stat[kRows + r] + eps);
      const float dg_hat = dn_s[idx] * gam_s[c];
      const float dp = (dg_hat - stat[2 * kRows + r] - p_s[idx] * stat[3 * kRows + r]) * inv;
      dp_t[r * kLdP + c] = from_f32<TI>(row0 + r < batch ? dp : 0.0f);
    }
    __syncthreads();

    // This block's share of dxh for the tile: dx_s [kRows][K] = dp_t @ w[:, its columns]^T.
    // Warp w takes the columns [8 w, 8 w + 8), [8 w + 64, 8 w + 72), ... of each K-tile.
    pipeline<kStages>(
        k_tiles, ring, bars,
        [&](int step, int stage, uint64_t* bar) {
          mbar_expect(bar, kWTileBytes<TI>);
          load_w(w_s + stage * kBK * kCols, w_map, bar, unit0, step * kBK);
        },
        [&](int step, int stage) {
          const TI* ws = w_s + stage * kBK * kCols;
          for (int n0 = warp * 8; n0 < kBK; n0 += kWarps * 8) {
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if constexpr (kIsBf16<TI>) {
#pragma unroll
              for (int kb = 0; kb < kCols; kb += 16) {
                // A = dp rows [0, 16) x columns [kb, kb + 16); B[col][k] = w[k][col], k in [n0, n0 + 8)
                uint32_t a[4], b[2];
                ldsm_x4(a, dp_t + (mrow + 8 * (mat & 1)) * kLdP + kb + 8 * (mat >> 1));
                ldsm_x2(b, w_at(ws, n0 + mrow, kb + 8 * (mat & 1)));
                mma_bf16(c, a, b);
              }
            } else {
              for (int c4 = 0; c4 < kCols; c4 += 4) {  // 16-byte chunks of dp's and w's rows
                const float4 da = *reinterpret_cast<const float4*>(dp_t + gid * kLdP + c4);
                const float4 db = *reinterpret_cast<const float4*>(dp_t + (gid + 8) * kLdP + c4);
                const float4 wa = *reinterpret_cast<const float4*>(w_at(ws, n0 + 2 * tig, c4));
                const float4 wb = *reinterpret_cast<const float4*>(w_at(ws, n0 + 2 * tig + 1, c4));
                const float d0[4] = {da.x, da.y, da.z, da.w}, d1[4] = {db.x, db.y, db.z, db.w};
                const float w0[4] = {wa.x, wa.y, wa.z, wa.w}, w1[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  c[0] = fmaf(d0[e], w0[e], c[0]);
                  c[1] = fmaf(d0[e], w1[e], c[1]);
                  c[2] = fmaf(d1[e], w0[e], c[2]);
                  c[3] = fmaf(d1[e], w1[e], c[3]);
                }
              }
            }
            const int k = step * kBK + n0 + 2 * tig;  // K % 8 == 0: an n-tile lies inside K or past it
            if (k < K) {
              dx_s[gid * K + k] = c[0];
              dx_s[gid * K + k + 1] = c[1];
              dx_s[(gid + 8) * K + k] = c[2];
              dx_s[(gid + 8) * K + k + 1] = c[3];
            }
          }
        });
    cluster.sync();
    // Block `rank` sums its slice of K over the cluster's blocks, in rank order.
    const int slice = (K + nranks - 1) / nranks;
    const int k_lo = rank * slice, k_hi = min(K, k_lo + slice);
    for (int idx = threadIdx.x; idx < kRows * slice; idx += kThreads) {
      const int r = idx / slice, k = k_lo + idx % slice;
      if (k >= k_hi || row0 + r >= batch) continue;
      dxh[(int64_t)(row0 + r) * K + k] = from_f32<TI>(cluster_sum(cluster, dx_s, r * K + k));
    }
    cluster.sync();  // dx_s, red and stat are rewritten by the next row tile
  }

  for (int c = threadIdx.x; c < kCols; c += kThreads) {
    const int gc = global_col(c, hidden, unit0);
    dgamma[gc] = from_f32<TG>(acc_g[c]);
    dbeta[gc] = from_f32<TG>(acc_b[c]);
  }

  // dw[K-tile, the block's columns] = xh[:, K-tile]^T @ dp, summed over the row tiles in
  // order. Per K-tile (BK / 16) x 12 output tiles of 16 x 8. bf16 (BK / 16 = 8 m-tiles):
  // warp w takes m-tile w and all 12 n-tiles, so that it loads its xh fragment once; f32:
  // warp w takes the tiles w, w + 8, w + 16.
  constexpr int kDwTiles = kBK / 16 * kColTiles / kWarps;
  auto dw_tile = [&](int i) {  // (first K row, first column) of warp's i-th tile
    if constexpr (kIsBf16<TI>) return make_int2(warp * 16, i * 8);
    const int t = warp + i * kWarps;
    return make_int2((t / kColTiles) * 16, (t % kColTiles) * 8);
  };
  float c[kDwTiles][4];
  pipeline<kStages>(
      k_tiles * row_tiles, ring, bars,
      [&](int step, int stage, uint64_t* bar) {
        mbar_expect(bar, kXTileBytes<TI>);
        load_x(x_s + stage * kRows * kBK, x_map, bar, (step % row_tiles) * kRows, (step / row_tiles) * kBK);
      },
      [&](int step, int stage) {
        const int kt = step / row_tiles, rt = step % row_tiles;
        const TI* xs = x_s + stage * kRows * kBK;
        const TI* dpr = dp_s + rt * kRows * kLdP;
        if (rt == 0) {
#pragma unroll
          for (int i = 0; i < kDwTiles; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[i][e] = 0.0f;
        }
        if constexpr (kIsBf16<TI>) {
          static_assert(tile_k(sizeof(TI)) / 16 == kWarps, "one m-tile per warp");
          // A[k][r] = xs[r][k], k in [16 warp, 16 warp + 16); B = dp rows [0, 16) x columns [8 i, 8 i + 8)
          uint32_t a[4];
          ldsm_x4_t(a, x_at(xs, mrow + 8 * (mat >> 1), warp * 16 + 8 * (mat & 1)));
#pragma unroll
          for (int i = 0; i < kDwTiles; ++i) {
            uint32_t b[2];
            ldsm_x2_t(b, dpr + (mrow + 8 * (mat & 1)) * kLdP + i * 8);
            mma_bf16(c[i], a, b);
          }
        } else {
#pragma unroll
          for (int i = 0; i < kDwTiles; ++i) {
            const int mb = dw_tile(i).x, nb = dw_tile(i).y;
#pragma unroll 4
            for (int r = 0; r < kRows; ++r) {
              const float x0 = *x_at(xs, r, mb + gid), x1 = *x_at(xs, r, mb + gid + 8);
              const float d0 = dpr[r * kLdP + nb + 2 * tig], d1 = dpr[r * kLdP + nb + 2 * tig + 1];
              c[i][0] = fmaf(x0, d0, c[i][0]);
              c[i][1] = fmaf(x0, d1, c[i][1]);
              c[i][2] = fmaf(x1, d0, c[i][2]);
              c[i][3] = fmaf(x1, d1, c[i][3]);
            }
          }
        }
        if (rt == row_tiles - 1) {
          // Through shared memory (the w stages are free here) into 16-byte stores.
          TI* st = w_s;
#pragma unroll
          for (int i = 0; i < kDwTiles; ++i) {
            const int m = dw_tile(i).x + gid, col = dw_tile(i).y + 2 * tig;
            st[m * kLdP + col] = from_f32<TI>(c[i][0]);
            st[m * kLdP + col + 1] = from_f32<TI>(c[i][1]);
            st[(m + 8) * kLdP + col] = from_f32<TI>(c[i][2]);
            st[(m + 8) * kLdP + col + 1] = from_f32<TI>(c[i][3]);
          }
          __syncthreads();
          constexpr int kVec = 16 / sizeof(TI), kPerRow = kCols / kVec;
          for (int v = threadIdx.x; v < kBK * kPerRow; v += kThreads) {
            const int m = v / kPerRow, col = (v % kPerRow) * kVec, k = kt * kBK + m;
            if (k < K)
              *reinterpret_cast<int4*>(dw + k * three_h + global_col(col, hidden, unit0)) =
                  *reinterpret_cast<const int4*>(st + m * kLdP + col);
          }
        }
      });
}

// Lets `Kernel` take a block's whole shared memory and clusters of more than 8 blocks, once
// for each instantiation of a kernel and each device (the first 64).
template <auto Kernel>
cudaError_t allow_large_clusters() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// Launch `Kernel` on `blocks` blocks in clusters of `cluster` blocks with `smem` bytes of
// dynamic shared memory; returns the launch's error code.
template <auto Kernel, typename... Args>
int launch_cluster(int blocks, int cluster, int smem, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_large_clusters<Kernel>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Calls f(T{}) with T = float (code 0) or __nv_bfloat16 (code 1).
template <typename F>
int with_type(int code, F&& f) {
  if (code == 0) return f(float{});
  if (code == 1) return f(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor maps of xh ([B, K], boxes of kRows rows by 128 bytes) and of w, viewed as
// [K][3][H] (boxes of tile_k rows by 3 gates by kUnits units), with the swizzles that
// x_at and w_at read. Out-of-range elements of a box read as zeros.
int make_maps(CUtensorMap* x_map, CUtensorMap* w_map, const void* xh, const void* w, int batch, int K, int hidden,
              int elem) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType type = elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint64_t x_dim[2] = {(cuuint64_t)K, (cuuint64_t)batch};
  const cuuint64_t x_stride[1] = {(cuuint64_t)K * elem};
  const cuuint32_t x_box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)kRows};
  const cuuint64_t w_dim[3] = {(cuuint64_t)hidden, 3, (cuuint64_t)K};
  const cuuint64_t w_stride[2] = {(cuuint64_t)hidden * elem, (cuuint64_t)3 * hidden * elem};
  const cuuint32_t w_box[3] = {(cuuint32_t)kUnits, 3, (cuuint32_t)tile_k(elem)};
  const CUtensorMapSwizzle w_swizzle = elem == 2 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  if (encode(x_map, type, 2, const_cast<void*>(xh), x_dim, x_stride, x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(w_map, type, 3, const_cast<void*>(w), w_dim, w_stride, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             w_swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

int check_shape(int batch, int K, int hidden, int elem, bool backward) {
  if (batch <= 0 || K <= 0 || K % 8 != 0 || hidden <= 0 || hidden % kUnits != 0 || hidden / kUnits > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  if (smem_layout(elem, batch, K, backward).total > kSmemLimit) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace


// Type codes: 0 = float32, 1 = bfloat16. `ti` is xh's and w's type, `th` h's (and the
// output's), `tg` gamma's and beta's. Returns 0 or the CUDA error of the launch;
// cudaErrorInvalidValue for a shape or type the kernel does not take.
extern "C" int rssm_step_fwd(const void* xh, const void* h, const void* w, const void* gamma, const void* beta,
                             void* out, int batch, int K, int hidden, float eps, int ti, int th, int tg,
                             void* stream) {
  const int elem = ti == 1 ? 2 : 4;
  if (const int bad = check_shape(batch, K, hidden, elem, false)) return bad;
  const int cluster = hidden / kUnits;
  const int blocks = cluster * ((batch + kRows - 1) / kRows);
  const int smem = smem_layout(elem, batch, K, false).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap x_map, w_map;
  if (const int bad = make_maps(&x_map, &w_map, xh, w, batch, K, hidden, elem)) return bad;
  return with_type(ti, [&](auto a) {
    using TI = decltype(a);
    return with_type(th, [&](auto b) {
      using TH = decltype(b);
      return with_type(tg, [&](auto c) {
        using TG = decltype(c);
        return launch_cluster<rssm_step_fwd_kernel<TI, TH, TG>>(blocks, cluster, smem, s, x_map, w_map,
                              static_cast<const TH*>(h), static_cast<const TG*>(gamma), static_cast<const TG*>(beta),
                              static_cast<TH*>(out), batch, K, hidden, eps);
      });
    });
  });
}

extern "C" int rssm_step_bwd(const void* xh, const void* h, const void* w, const void* gamma, const void* beta,
                             const void* g, void* dxh, void* dh, void* dw, void* dgamma, void* dbeta, int batch, int K,
                             int hidden, float eps, int ti, int th, int tg, void* stream) {
  const int elem = ti == 1 ? 2 : 4;
  if (const int bad = check_shape(batch, K, hidden, elem, true)) return bad;
  const int cluster = hidden / kUnits;
  const int smem = smem_layout(elem, batch, K, true).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap x_map, w_map;
  if (const int bad = make_maps(&x_map, &w_map, xh, w, batch, K, hidden, elem)) return bad;
  return with_type(ti, [&](auto a) {
    using TI = decltype(a);
    return with_type(th, [&](auto b) {
      using TH = decltype(b);
      return with_type(tg, [&](auto c) {
        using TG = decltype(c);
        return launch_cluster<rssm_step_bwd_kernel<TI, TH, TG>>(cluster, cluster, smem, s, x_map, w_map,
                              static_cast<const TH*>(h), static_cast<const TG*>(gamma), static_cast<const TG*>(beta),
                              static_cast<const TH*>(g), static_cast<TI*>(dxh),
                              static_cast<TH*>(dh), static_cast<TI*>(dw), static_cast<TG*>(dgamma),
                              static_cast<TG*>(dbeta), batch, K, hidden, eps);
      });
    });
  });
}
