// Fused RSSM step, forward and backward (Hopper, sm_90a): the [B, K] @ [K, 3H] product,
// the LayerNorm over its 3H columns and the GRU gates.
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
// share float32 or bfloat16.
//
// What bounds it on an H100 (80 GB HBM3, 700 W). At the RSSM unroll's shape (B 16, K 1024,
// H 512) the step does 2 * 16 * 1024 * 1536 = 50 MFLOP against 3.1 MB of w in bf16 (6.3 MB
// in f32): ~16 operations per byte, far below the ~295 at which bf16 tensor cores stop
// waiting for memory, so moving w bounds it (0.94 us at 3.35 TB/s in bf16; less where w
// stays in the 50 MB L2 across a scan's 64 steps). f32 operands must not go through TF32,
// so their product runs as FFMA on the CUDA cores. One SM pulls only a small share of
// what L2 gives the card, so w is spread over most of the 132 SMs, every tile of a block
// in flight at once. What is left at B = 16 is latency: the first tile, the cluster's
// exchange, the end of the product launch and the row pass's reads are round trips in
// sequence.
//
// Forward: two launches. The product pass's grid is (3H / 128 column blocks) x (S
// K-slices) x (row groups of up to 64 rows): 12 x 8 x 1 = 96 blocks at size S.
//
// * Block (c, s, g) owns the 128 projection columns [128 c, 128 c + 128) over the K-slice s
//   of w (K / S rows, 128 at size S, in two tiles) and the rows of group g. It streams
//   w[slice, its columns] and xh[group rows, slice] into shared memory as TMA boxes of
//   128-byte rows, swizzled so that the fragment loads meet no bank conflict, all tiles in
//   flight at once, and forms its [rows, 128] partial product in registers: bf16 through
//   ldmatrix and mma.sync m16n8k16 with f32 accumulators, f32 as FFMA (no TF32). Each warp
//   owns 16 columns over the whole slice.
// * The S blocks of one (c, g) are a thread-block cluster (S <= 8, a portable size).
//   Block s owns a share of the group's rows: every block stores its partial of those rows
//   into block s's shared memory (distributed shared memory), and block s sums them in
//   slice order and writes the projection `proj` [B, 3H] in f32.
// * A LayerNorm row needs all 3H columns, i.e. every column block, and DSMEM reaches one
//   cluster only. So the row pass is a second launch, one block per row: a programmatic
//   dependent launch that loads gamma, beta and h while the product pass runs, waits for
//   it to finish, then reads its row of `proj` (from L2), computes the mean, then the
//   centred sum of squares (the two-pass variance of the reference), and the gates. No
//   block waits for another cluster, so the product pass cannot deadlock whatever the
//   card co-schedules, and nothing is left in device memory between calls: any stream
//   and any CUDA graph replay runs it as it is.
// * `proj` is the wrapper's workspace and, under autograd, the backward's residual.
//
// Backward. Given g = dL/dh' and the forward's `proj`:
//
//   dh = g (1 - u);  dn (the gate gradients, as in layernorm_gru.cu)
//   dgamma = sum_rows dn * unit,  dbeta = sum_rows dn      (f32, cast to gamma's type)
//   dp = (dn gamma - mean(dn gamma) - unit * mean(dn gamma unit)) * inv, rounded to xh's
//        type before both products, as the reference does
//   dxh = dp @ w^T  (xh's type),   dw = xh^T @ dp  (w's type)
//
// Two launches, one per role, so that no sum crosses a block:
//
// * Rows: one block per row computes the statistics, the gates and their gradients from
//   the saved projection and writes dh, dp (xh's type, rows padded by 16 bytes, zero rows
//   up to the product pass's row tile) and the row's dgamma/dbeta terms.
// * Products: block i owns the 8 rows [8 i, 8 i + 8) of K. It reads w[those rows, :]
//   once, streams dp in row tiles (16 rows in bf16, 8 in f32; three stages by bulk copy)
//   with xh[tile rows, its 8 columns], and writes dxh[:, its columns] (summed over 3H
//   inside the block, the warps' shares in warp order) and dw[its rows, :] (summed over
//   every row inside the block: dw^T = dp^T xh, w's columns as M). bf16 through
//   ldmatrix and mma.sync, f32 as FFMA. It also sums dgamma and dbeta of its share of the
//   3H columns over the rows, in a fixed order. K / 8 = 128 blocks at size S. It is a
//   programmatic dependent launch: it starts while the row pass runs and fetches w's
//   rows, then waits for the row pass before it reads dp.
//
// Every sum runs in a fixed order and no float atomic is used: two calls give the same
// bits. Limits (the wrapper's `fused_step_supported` holds the same numbers): H a
// multiple of 32 up to 512 (a LayerNorm row's units over one block's 256 threads), K a
// multiple of 8, B up to 256 (the JAX package's own cap).

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
constexpr int kFwdCols = 128;             // projection columns per forward block
constexpr int kFwdNTiles = kFwdCols / 8 / kWarps;  // mma n-tiles of 8 columns per warp
constexpr int kRows = 16;                 // rows of an mma tile
constexpr int kMaxHidden = 512;
constexpr int kUnitsPerThread = kMaxHidden / kThreads;  // a row's units over a block
constexpr int kMaxSlices = 8;             // K-slices of the forward: its cluster size
constexpr int kMaxRowTiles = 4;           // 16-row tiles per forward block (groups of 64)
constexpr int kMaxBatch = 256;            // the JAX budget's batch cap: at most 4 row groups
constexpr int kFwdStages = 2;             // forward tiles in flight: the two of a K-slice
constexpr int kBwdK = 8;                  // K rows per block of the backward's products
constexpr int kBwdStages = 3;
constexpr int kMTiles = 3 * kMaxHidden / 16 / kWarps;  // dw^T m-tiles per warp
constexpr int kSmemLimit = 232448;        // a block's shared memory on sm_90
// K per forward tile: 64 rows of w in bf16, 32 in f32 (16 KB of w either way); a K-slice of
// 128 rows is two tiles, both in flight, the second landing while the first is multiplied.
__host__ __device__ constexpr int fwd_tile_k(int elem) { return elem == 2 ? 64 : 32; }
// dp rows per tile of the backward's product pass (48 KB of dp either way at H = 512).
__host__ __device__ constexpr int bwd_tile_rows(int elem) { return elem == 2 ? 16 : 8; }
// dp and w rows in the product pass's shared memory: 3H plus 16 bytes, so that the
// ldmatrix rows fall in distinct banks.
__host__ __device__ constexpr int dp_ld(int hidden, int elem) { return 3 * hidden + 16 / elem; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Shared-memory layouts, from a base aligned to 1024 bytes (the span of the TMA's swizzle):
// every region a multiple of 16 bytes, the TMA tiles at multiples of 1024 (forward) or
// 128 (backward), the mbarriers last, and 1,024 bytes of room to align the base.
struct FwdSmem {
  int w_s, x_s, recv, bars, total;
};
__host__ __device__ inline FwdSmem fwd_smem(int elem, int row_tiles) {
  const int bk = fwd_tile_k(elem);
  FwdSmem s{};
  s.w_s = 0;
  s.x_s = s.w_s + kFwdStages * bk * kFwdCols * elem;
  s.recv = s.x_s + kFwdStages * kRows * row_tiles * bk * elem;
  s.bars = s.recv + (kRows * row_tiles + kMaxSlices - 1) * kFwdCols * 4;  // slices * share rows at most
  s.total = s.bars + kFwdStages * 8 + 1024;
  return s;
}
struct ProdSmem {
  int w_s, dp_s, x_s, red, bars, total;
};
__host__ __device__ inline ProdSmem prod_smem(int elem, int hidden) {
  const int row = dp_ld(hidden, elem) * elem, tr = bwd_tile_rows(elem);
  ProdSmem s{};
  s.w_s = 0;
  s.dp_s = s.w_s + kBwdK * row;
  s.x_s = cdiv(s.dp_s + kBwdStages * tr * row, 128) * 128;
  s.red = s.x_s + kBwdStages * tr * kBwdK * elem;
  s.bars = s.red + 2 * kWarps * tr * kBwdK * 4;
  s.total = s.bars + (kBwdStages + 1) * 8 + 1024;
  return s;
}

// The launch geometry of a shape; rssm_step_geometry exports it in this order.
struct Geometry {
  int col_blocks;   // forward product pass: blocks of 128 projection columns (grid x)
  int slice_k;      // forward: K rows per slice
  int slices;       // forward: K-slices (grid y, the cluster)
  int row_tiles;    // forward: 16-row tiles per block
  int groups;       // forward: row groups (grid z)
  int fwd_smem;     // forward: dynamic shared memory per block
  int dp_rows;      // backward: B padded to the product pass's row tile
  int dp_ld;        // backward: elements per row of the dp workspace
  int prod_blocks;  // backward: product-pass blocks (the rows pass has dp_rows)
  int prod_smem;    // backward: product pass's dynamic shared memory per block
};
constexpr int kGeometryFields = 10;

__host__ __device__ inline Geometry geometry(int batch, int K, int hidden, int elem) {
  const int bk = fwd_tile_k(elem), tr = bwd_tile_rows(elem);
  Geometry g{};
  g.col_blocks = cdiv(3 * hidden, kFwdCols);
  g.slice_k = cdiv(cdiv(K, kMaxSlices), 2 * bk) * 2 * bk;
  g.slices = cdiv(K, g.slice_k);
  g.row_tiles = imin(kMaxRowTiles, cdiv(batch, kRows));
  g.groups = cdiv(batch, kRows * g.row_tiles);
  g.fwd_smem = fwd_smem(elem, g.row_tiles).total;
  g.dp_rows = cdiv(batch, tr) * tr;
  g.dp_ld = dp_ld(hidden, elem);
  g.prod_blocks = K / kBwdK;
  g.prod_smem = prod_smem(elem, hidden).total;
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

// 1 / (1 + e^-x); __frcp_rn is the correctly rounded reciprocal, the value of 1.0f / y.
__device__ __forceinline__ float sigmoidf(float x) { return __frcp_rn(1.0f + __expf(-x)); }

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

// The Tensor Memory Accelerator and the bulk copy engine: one thread asks for a whole box
// (or a contiguous run of bytes), and the copy's bytes complete a transaction on an
// mbarrier in shared memory.
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
// Load the box of `map` at (c0, c1) (innermost first) into dst; completes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap& map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from src to dst; completes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Fetch a tensor map into the TMA unit's cache ahead of its first copy.
__device__ __forceinline__ void prefetch_map(const CUtensorMap& map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map)) : "memory");
}

// Programmatic dependent launch, in both passes of a call: the first launch lets the
// second start at once, and the second waits, after the loads that do not depend on the
// first, until the first has finished and its writes are visible. Both are no-ops in a
// launch without the attribute.
__device__ __forceinline__ void launch_dependents() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }
__device__ __forceinline__ void wait_for_prerequisites() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// Thread 0 makes `n` mbarriers, one arrival each, before any copy is issued.
__device__ __forceinline__ void init_barriers(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The cluster barrier in two halves: arrive, then wait for every block of the cluster to
// have arrived. The first arrival (relaxed) only says that the block runs, so that the
// others may write its shared memory once their wait returns.
__device__ __forceinline__ void cluster_arrive_relaxed() { asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// The tiles in shared memory, as the TMA writes them with SWIZZLE_128B: a tile is boxes of
// [rows][128 bytes], one after the other along the columns, and within each 1024-byte span
// the 16-byte chunk c of row r moves to chunk c ^ (r % 8), so that 8 rows of one column
// chunk fall in distinct banks. The xh tile is [16 row tiles][BK] (r a row, c a k), the w
// tile [BK][kFwdCols] (r a k, c a column).
template <int Bits>
__device__ __forceinline__ int swizzle(int offset) {
  return offset ^ (((offset >> 7) & ((1 << Bits) - 1)) << 4);
}
template <typename T>
constexpr int kBoxCols = 128 / sizeof(T);  // columns per 128-byte box row
// Element (r, c) of a tile of `rows` rows.
template <typename T>
__device__ __forceinline__ const T* tile_at(const T* tile, int rows, int r, int c) {
  const int box = c / kBoxCols<T>, offset = r * 128 + (c % kBoxCols<T>)*(int)sizeof(T);
  return reinterpret_cast<const T*>(reinterpret_cast<const char*>(tile) + box * rows * 128 + swizzle<3>(offset));
}
// Load the tile of `map` with `rows` rows from (row0, col0), `cols` columns wide, into dst.
__device__ __forceinline__ void load_tile(void* dst, const CUtensorMap& map, uint64_t* bar, int row0, int col0, int rows,
                                          int cols, int elem) {
  const int box_cols = 128 / elem;
  for (int box = 0; box < cols / box_cols; ++box)
    tma_load_2d(static_cast<char*>(dst) + box * rows * 128, map, bar, col0 + box * box_cols, row0);
}

// A pipeline of `Stages` buffers, each with its mbarrier: issue(step, stage, bar), run by
// thread 0, starts the copies of a step and announces their bytes on `bar`;
// compute(step, stage) consumes them once they have landed. The first `Stages` steps are
// issued at once; a buffer is refilled as soon as every thread is done with it. The
// buffers are only read between copies (ldmatrix and loads), which the barriers order
// before the next copy into them.
template <int Stages, typename Issue, typename Compute>
__device__ __forceinline__ void pipeline(int steps, uint64_t* bars, Issue&& issue, Compute&& compute) {
  if (threadIdx.x == 0)
    for (int s = 0; s < Stages && s < steps; ++s) issue(s, s, bars + s);
  for (int s = 0; s < steps; ++s) {
    const int stage = s % Stages;
    mbar_wait(bars + stage, (s / Stages) & 1);
    compute(s, stage);
    __syncthreads();
    if (threadIdx.x == 0 && s + Stages < steps) issue(s + Stages, stage, bars + stage);
  }
}

// xh[row0 : row0 + 16 row_tiles, k_begin : k_begin + k_len] @ w[that K range, col0 :
// col0 + kFwdCols] in f32, handed to emit(r, c, v0, v1) as pairs of columns (c, c + 1) of
// a local row r, after every thread has called ready(). Warp w owns the kFwdNTiles n-tiles from column 8 kFwdNTiles w of every
// row tile over the whole K range, so that no two warps share an output.
template <typename TI, typename Ready, typename Emit>
__device__ void project(TI* w_s, TI* x_s, uint64_t* bars, const CUtensorMap& w_map, const CUtensorMap& x_map, int row0,
                        int col0, int k_begin, int k_len, int row_tiles, Ready&& ready, Emit&& emit) {
  constexpr int kBK = fwd_tile_k(sizeof(TI));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;  // the ldmatrix matrix and row this lane addresses
  const int n0 = warp * kFwdNTiles * 8, rows = kRows * row_tiles;
  float acc[kMaxRowTiles][kFwdNTiles][4] = {};
  pipeline<kFwdStages>(
      cdiv(k_len, kBK), bars,
      [&](int step, int stage, uint64_t* bar) {
        const int k0 = k_begin + step * kBK;
        mbar_expect(bar, (kBK * kFwdCols + rows * kBK) * sizeof(TI));
        load_tile(w_s + stage * kBK * kFwdCols, w_map, bar, k0, col0, kBK, kFwdCols, sizeof(TI));
        load_tile(x_s + stage * rows * kBK, x_map, bar, row0, k0, rows, kBK, sizeof(TI));
      },
      [&](int, int stage) {
        const TI* ws = w_s + stage * kBK * kFwdCols;
        const TI* xs = x_s + stage * rows * kBK;
        if constexpr (kIsBf16<TI>) {
#pragma unroll
          for (int kb = 0; kb < kBK; kb += 16) {
            // A = xs rows [16 rt, 16 rt + 16) x k [kb, kb + 16); B = ws k [kb, kb + 16) x n [n, n + 8), transposed
            uint32_t b[kFwdNTiles][2];
#pragma unroll
            for (int j = 0; j < kFwdNTiles; ++j) ldsm_x2_t(b[j], tile_at(ws, kBK, kb + mrow + 8 * (mat & 1), n0 + 8 * j));
#pragma unroll
            for (int rt = 0; rt < kMaxRowTiles; ++rt) {
              if (rt < row_tiles) {
                uint32_t a[4];
                ldsm_x4(a, tile_at(xs, rows, 16 * rt + mrow + 8 * (mat & 1), kb + 8 * (mat >> 1)));
#pragma unroll
                for (int j = 0; j < kFwdNTiles; ++j) mma_bf16(acc[rt][j], a, b[j]);
              }
            }
          }
        } else {
#pragma unroll
          for (int k4 = 0; k4 < kBK; k4 += 4) {  // w's four rows k4.., then a 16-byte chunk of each xh row
            float2 wv[4][kFwdNTiles];
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int j = 0; j < kFwdNTiles; ++j)
                wv[e][j] = *reinterpret_cast<const float2*>(tile_at(ws, kBK, k4 + e, n0 + 8 * j + 2 * tig));
#pragma unroll
            for (int rt = 0; rt < kMaxRowTiles; ++rt) {
              if (rt < row_tiles) {
                const float4 xa = *reinterpret_cast<const float4*>(tile_at(xs, rows, 16 * rt + gid, k4));
                const float4 xb = *reinterpret_cast<const float4*>(tile_at(xs, rows, 16 * rt + gid + 8, k4));
                const float x0[4] = {xa.x, xa.y, xa.z, xa.w}, x1[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
#pragma unroll
                  for (int j = 0; j < kFwdNTiles; ++j) {
                    acc[rt][j][0] = fmaf(x0[e], wv[e][j].x, acc[rt][j][0]);
                    acc[rt][j][1] = fmaf(x0[e], wv[e][j].y, acc[rt][j][1]);
                    acc[rt][j][2] = fmaf(x1[e], wv[e][j].x, acc[rt][j][2]);
                    acc[rt][j][3] = fmaf(x1[e], wv[e][j].y, acc[rt][j][3]);
                  }
              }
            }
          }
        }
      });
  ready();
#pragma unroll
  for (int rt = 0; rt < kMaxRowTiles; ++rt) {
    if (rt >= row_tiles) continue;
#pragma unroll
    for (int j = 0; j < kFwdNTiles; ++j) {
      emit(16 * rt + gid, n0 + 8 * j + 2 * tig, acc[rt][j][0], acc[rt][j][1]);
      emit(16 * rt + gid + 8, n0 + 8 * j + 2 * tig, acc[rt][j][2], acc[rt][j][3]);
    }
  }
}

// v[i] = the sum of v[i] over the block's threads, for each i, the same in every thread:
// each warp's lanes in a butterfly, then the warps' sums in warp order. red holds
// kWarps * N floats.
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
    if (lane == 0) red[warp * N + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += red[q * N + i];
    v[i] = s;
  }
  __syncthreads();  // red may be written again
}

// The GRU gates of one unit from its three normalised pre-activations.
struct Gates {
  float reset, cand, update;
};
__device__ __forceinline__ Gates gates(const float (&n)[3]) {
  Gates g;
  g.reset = sigmoidf(n[0]);
  g.cand = tanhf(g.reset * n[1]);
  g.update = sigmoidf(n[2] - 1.0f);
  return g;
}

// gamma and beta of this thread's units, in f32 (zeros past H).
template <typename TG>
__device__ __forceinline__ void load_affine(const TG* __restrict__ gamma, const TG* __restrict__ beta, int hidden,
                                            float (&gam)[kUnitsPerThread][3], float (&bet)[kUnitsPerThread][3]) {
#pragma unroll
  for (int q = 0; q < kUnitsPerThread; ++q) {
    const int u = threadIdx.x + q * kThreads;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gam[q][k] = u < hidden ? to_f32(gamma[k * hidden + u]) : 0.0f;
      bet[q][k] = u < hidden ? to_f32(beta[k * hidden + u]) : 0.0f;
    }
  }
}

// The LayerNorm statistics of a row whose 3H values the block holds, three per unit of
// each thread (zeros past H): the mean, then the centred sum of squares (the two-pass
// variance of the reference), each a block sum; red holds kWarps floats.
__device__ __forceinline__ void row_stats(const float (&p)[kUnitsPerThread][3], int hidden, float eps, float* red,
                                          float& mean, float& inv) {
  const float inv_n = 1.0f / (3.0f * hidden);
  float s[1] = {0.0f};
#pragma unroll
  for (int q = 0; q < kUnitsPerThread; ++q)
#pragma unroll
    for (int k = 0; k < 3; ++k) s[0] += p[q][k];
  block_sums<1>(s, red);
  mean = s[0] * inv_n;
  s[0] = 0.0f;
#pragma unroll
  for (int q = 0; q < kUnitsPerThread; ++q)
    if (threadIdx.x + q * kThreads < hidden)
#pragma unroll
      for (int k = 0; k < 3; ++k) s[0] += (p[q][k] - mean) * (p[q][k] - mean);
  block_sums<1>(s, red);
  inv = rsqrtf(s[0] * inv_n + eps);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// The forward's product pass: the projection `proj` [B, 3H] in f32. Two blocks per SM (at
// most 128 registers a thread), so that the card holds twice the clusters at once when
// the grid has more than one wave of them (B > 64).
template <typename TI>
__global__ void __launch_bounds__(kThreads, 2)
rssm_step_fwd_product_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                             float* __restrict__ proj, int batch, int K, int hidden, int slice_k, int row_tiles) {
  if (threadIdx.x == 0) prefetch_map(w_map), prefetch_map(x_map);
  launch_dependents();  // the row pass may be scheduled at once; it waits for this launch's end
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const FwdSmem L = fwd_smem(sizeof(TI), row_tiles);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  init_barriers(bars, kFwdStages);
  float* recv = reinterpret_cast<float*>(smem + L.recv);  // [slices][share][kFwdCols]
  const int slice = cluster.block_rank(), slices = cluster.num_blocks();
  const int col0 = blockIdx.x * kFwdCols, rows = kRows * row_tiles, row0 = blockIdx.z * rows;
  const int share = cdiv(rows, slices);  // the group's rows [slice * share, +share) are this block's
  const int k_begin = slice * slice_k;
  cluster_arrive_relaxed();  // this block runs

  // The partial product of this K-slice, each row sent to the shared memory of the block
  // that owns it, at this slice's place.
  project(reinterpret_cast<TI*>(smem + L.w_s), reinterpret_cast<TI*>(smem + L.x_s), bars, w_map, x_map, row0, col0,
          k_begin, min(slice_k, K - k_begin), row_tiles, [] { cluster_wait(); },  // every block of the cluster runs
          [&](int r, int c, float v0, float v1) {
            const int owner = r / share;
            float* dst = cluster.map_shared_rank(recv, owner) + ((slice * share + r - owner * share) * kFwdCols + c);
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          });
  cluster.sync();  // every slice's partial of this block's rows has landed

  // This block's rows, summed over the slices in rank order.
  const int valid = min(rows, batch - row0);
  const int r_lo = min(valid, slice * share), r_hi = min(valid, r_lo + share);
  const int64_t three_h = 3 * (int64_t)hidden;
  for (int idx = threadIdx.x; idx < (r_hi - r_lo) * kFwdCols; idx += kThreads) {
    const int r = idx / kFwdCols, c = idx % kFwdCols;
    if (col0 + c >= three_h) continue;
    float v = 0.0f;
    for (int q = 0; q < slices; ++q) v += recv[(q * share + r) * kFwdCols + c];
    proj[(row0 + r_lo + r) * three_h + col0 + c] = v;
  }
}

// The forward's row pass: block `row` normalises its row of the projection, applies gamma
// and beta and the gates, and writes out[row]. A programmatic dependent launch: it loads
// gamma, beta and h while the product pass runs, then waits for that pass to finish and
// its writes to be visible before it reads proj (from L2, ld.global.cg).
template <typename TH, typename TG>
__global__ void __launch_bounds__(kThreads)
rssm_step_fwd_rows_kernel(const float* __restrict__ proj, const TH* __restrict__ h, const TG* __restrict__ gamma,
                          const TG* __restrict__ beta, TH* __restrict__ out, int hidden, float eps) {
  __shared__ float red[kWarps];
  const int row = blockIdx.x;
  const int64_t three_h = 3 * (int64_t)hidden;
  float gam[kUnitsPerThread][3], bet[kUnitsPerThread][3], hv[kUnitsPerThread], p[kUnitsPerThread][3];
  load_affine(gamma, beta, hidden, gam, bet);
#pragma unroll
  for (int q = 0; q < kUnitsPerThread; ++q) {
    const int u = threadIdx.x + q * kThreads;
    hv[q] = u < hidden ? to_f32(h[(int64_t)row * hidden + u]) : 0.0f;
  }
  wait_for_prerequisites();  // the product pass's proj
#pragma unroll
  for (int q = 0; q < kUnitsPerThread; ++q) {
    const int u = threadIdx.x + q * kThreads;
#pragma unroll
    for (int k = 0; k < 3; ++k) p[q][k] = u < hidden ? __ldcg(proj + row * three_h + k * hidden + u) : 0.0f;
  }
  float mean, inv;
  row_stats(p, hidden, eps, red, mean, inv);
#pragma unroll
  for (int q = 0; q < kUnitsPerThread; ++q) {
    const int u = threadIdx.x + q * kThreads;
    if (u >= hidden) continue;
    float n[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = (p[q][k] - mean) * inv * gam[q][k] + bet[q][k];
    const Gates gt = gates(n);
    out[(int64_t)row * hidden + u] = from_f32<TH>(gt.update * gt.cand + (1.0f - gt.update) * hv[q]);
  }
}

// The backward's row pass: block `row` turns the saved projection of its row and the
// upstream gradient into dh, dp (xh's type) and the row's dgamma and dbeta terms
// (dgb[0][row] = dn * unit, dgb[1][row] = dn). The rows past B, up to the product pass's
// row tile, get zero dp.
template <typename TI, typename TH, typename TG>
__global__ void __launch_bounds__(kThreads)
rssm_step_bwd_rows_kernel(const float* __restrict__ proj, const TH* __restrict__ h, const TG* __restrict__ gamma,
                          const TG* __restrict__ beta, const TH* __restrict__ g, TH* __restrict__ dh,
                          TI* __restrict__ dp, float* __restrict__ dgb, int batch, int hidden, int ld, float eps) {
  __shared__ float red[kWarps * 2];
  launch_dependents();
  const int row = blockIdx.x;
  TI* dp_row = dp + (int64_t)row * ld;
  if (row >= batch) {
    for (int c = threadIdx.x; c < ld; c += kThreads) dp_row[c] = from_f32<TI>(0.0f);
    return;
  }
  const float inv_n = 1.0f / (3.0f * hidden);
  const int64_t three_h = 3 * (int64_t)hidden;
  float p[kUnitsPerThread][3], gam[kUnitsPerThread][3], bet[kUnitsPerThread][3], hv[kUnitsPerThread],
      gv[kUnitsPerThread];
  load_affine(gamma, beta, hidden, gam, bet);
#pragma unroll
  for (int q = 0; q < kUnitsPerThread; ++q) {
    const int u = threadIdx.x + q * kThreads;
    const bool ok = u < hidden;
#pragma unroll
    for (int k = 0; k < 3; ++k) p[q][k] = ok ? proj[row * three_h + k * hidden + u] : 0.0f;
    hv[q] = ok ? to_f32(h[(int64_t)row * hidden + u]) : 0.0f;
    gv[q] = ok ? to_f32(g[(int64_t)row * hidden + u]) : 0.0f;
  }
  float mean, inv;
  row_stats(p, hidden, eps, red, mean, inv);

  float unit[kUnitsPerThread][3], dn[kUnitsPerThread][3], m[2] = {0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < kUnitsPerThread; ++q) {
    const int u = threadIdx.x + q * kThreads;
    float n[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      unit[q][k] = (p[q][k] - mean) * inv;
      n[k] = unit[q][k] * gam[q][k] + bet[q][k];
    }
    const Gates gt = gates(n);
    const float dt = gv[q] * gt.update * (1.0f - gt.cand * gt.cand);
    dn[q][0] = dt * n[1] * gt.reset * (1.0f - gt.reset);
    dn[q][1] = dt * gt.reset;
    dn[q][2] = gv[q] * (gt.cand - hv[q]) * gt.update * (1.0f - gt.update);
    if (u >= hidden) continue;
    dh[(int64_t)row * hidden + u] = from_f32<TH>(gv[q] * (1.0f - gt.update));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      m[0] += dn[q][k] * gam[q][k];
      m[1] += dn[q][k] * gam[q][k] * unit[q][k];
    }
  }
  block_sums<2>(m, red);
  const float m1 = m[0] * inv_n, m2 = m[1] * inv_n;
#pragma unroll
  for (int q = 0; q < kUnitsPerThread; ++q) {
    const int u = threadIdx.x + q * kThreads;
    if (u >= hidden) continue;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c = k * hidden + u;
      dp_row[c] = from_f32<TI>((dn[q][k] * gam[q][k] - m1 - unit[q][k] * m2) * inv);
      dgb[row * three_h + c] = dn[q][k] * unit[q][k];
      dgb[(batch + row) * three_h + c] = dn[q][k];
    }
  }
}

// The backward's product pass: block i owns the K rows [8 i, 8 i + 8). w's rows land once
// (one bulk copy per row into rows padded by 16 bytes), dp streams in row tiles of kTR
// rows (the workspace's rows are padded alike, so a tile is one bulk copy) with xh[tile
// rows, the block's 8 columns] (a TMA box). Per tile: dw^T[3H, 8] += dp_tile^T @ xh_tile
// (warp w takes the 16-column m-tiles w, w + 8, ...), and dxh[tile rows, 8] = dp_tile @
// w_rows^T (warp w takes a contiguous share of the 3H columns; the warps' partials are
// summed in warp order).
template <typename TI, typename TG>
__global__ void __launch_bounds__(kThreads)
rssm_step_bwd_products_kernel(const __grid_constant__ CUtensorMap x_map, const TI* __restrict__ w,
                              const TI* __restrict__ dp, const float* __restrict__ dgb, TI* __restrict__ dxh,
                              TI* __restrict__ dw, TG* __restrict__ dgamma, TG* __restrict__ dbeta, int batch, int K,
                              int hidden, int dp_rows) {
  constexpr int kTR = bwd_tile_rows(sizeof(TI));
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const ProdSmem L = prod_smem(sizeof(TI), hidden);
  TI* w_s = reinterpret_cast<TI*>(smem + L.w_s);
  TI* dp_s = reinterpret_cast<TI*>(smem + L.dp_s);
  TI* x_s = reinterpret_cast<TI*>(smem + L.x_s);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);  // the dp stages', then w's
  init_barriers(bars, kBwdStages + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;
  const int k0 = blockIdx.x * kBwdK, three_h = 3 * hidden, ld = dp_ld(hidden, sizeof(TI));
  const int tiles = dp_rows / kTR;
  const unsigned tile_bytes = kTR * ld * sizeof(TI), x_bytes = kTR * kBwdK * sizeof(TI);
  auto issue = [&](int t, int stage) {
    uint64_t* bar = bars + stage;
    mbar_expect(bar, tile_bytes + x_bytes);
    bulk_load(dp_s + stage * kTR * ld, dp + (int64_t)t * kTR * ld, tile_bytes, bar);
    tma_load_2d(x_s + stage * kTR * kBwdK, x_map, bar, k0, t * kTR);
  };
  if (threadIdx.x == 0) {
    prefetch_map(x_map);
    uint64_t* wbar = bars + kBwdStages;
    mbar_expect(wbar, kBwdK * three_h * sizeof(TI));
    for (int i = 0; i < kBwdK; ++i) bulk_load(w_s + i * ld, w + (int64_t)(k0 + i) * three_h, three_h * sizeof(TI), wbar);
  }
  wait_for_prerequisites();  // dp and the dgamma/dbeta terms of the row pass
  if (threadIdx.x == 0)
    for (int t = 0; t < kBwdStages && t < tiles; ++t) issue(t, t);

  // While the copies land: dgamma and dbeta of this block's share of the 3H columns, one
  // warp per column and parameter, the rows in a fixed order (each lane a strided run,
  // then a butterfly).
  {
    constexpr int kItems = 4;  // columns in flight per warp
    const int per = cdiv(three_h, gridDim.x), c_lo = imin(three_h, blockIdx.x * per), c_hi = imin(three_h, c_lo + per);
    const int items = 2 * (c_hi - c_lo);
    for (int base = warp; base < items; base += kItems * kWarps) {
      float s[kItems] = {};
      for (int r = lane; r < batch; r += 32) {
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int item = base + j * kWarps;
          if (item < items) s[j] += dgb[((int64_t)(item % 2) * batch + r) * three_h + c_lo + item / 2];
        }
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int item = base + j * kWarps;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
        if (lane == 0 && item < items) (item % 2 ? dbeta : dgamma)[c_lo + item / 2] = from_f32<TG>(s[j]);
      }
    }
  }

  const int m_tiles = three_h / 16;
  float acc[kMTiles][4] = {};
  mbar_wait(bars + kBwdStages, 0);  // w's rows
  for (int t = 0; t < tiles; ++t) {
    const int stage = t % kBwdStages;
    mbar_wait(bars + stage, (t / kBwdStages) & 1);
    const TI* dpt = dp_s + stage * kTR * ld;
    const TI* xs = x_s + stage * kTR * kBwdK;
    float* red_t = red + (t & 1) * kWarps * kTR * kBwdK;
    if constexpr (kIsBf16<TI>) {
      // dw^T: A[m][r] = dp[r][m] (m-tile mt), B[r][n] = xs[r][n]
      uint32_t b[2];
      ldsm_x2_t(b, xs + (mrow + 8 * (mat & 1)) * kBwdK);
#pragma unroll
      for (int j = 0; j < kMTiles; ++j) {
        const int mt = warp + kWarps * j;
        if (mt < m_tiles) {
          uint32_t a[4];
          ldsm_x4_t(a, dpt + (mrow + 8 * (mat >> 1)) * ld + 16 * mt + 8 * (mat & 1));
          mma_bf16(acc[j], a, b);
        }
      }
      // dxh: A = dp rows [0, 16) x columns [kb, kb + 16); B[c][n] = w_s[n][c]
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int per_warp = cdiv(m_tiles, kWarps);
#pragma unroll
      for (int j = 0; j < kMTiles; ++j) {
        const int kb = 16 * (warp * per_warp + j);
        if (j < per_warp && kb < three_h) {
          uint32_t a[4], bw[2];
          ldsm_x4(a, dpt + (mrow + 8 * (mat & 1)) * ld + kb + 8 * (mat >> 1));
          ldsm_x2(bw, w_s + mrow * ld + kb + 8 * (mat & 1));
          mma_bf16(c, a, bw);
        }
      }
      red_t[(warp * kTR + gid) * kBwdK + 2 * tig] = c[0];
      red_t[(warp * kTR + gid) * kBwdK + 2 * tig + 1] = c[1];
      red_t[(warp * kTR + gid + 8) * kBwdK + 2 * tig] = c[2];
      red_t[(warp * kTR + gid + 8) * kBwdK + 2 * tig + 1] = c[3];
    } else {
      // dw^T as FFMA with the fragment layout of the bf16 path: (column 16 mt + gid (+8), n 2 tig (+1))
#pragma unroll
      for (int r = 0; r < kTR; ++r) {
        const float2 xv = *reinterpret_cast<const float2*>(xs + r * kBwdK + 2 * tig);
#pragma unroll
        for (int j = 0; j < kMTiles; ++j) {
          const int mt = warp + kWarps * j;
          if (mt < m_tiles) {
            const float d0 = dpt[r * ld + 16 * mt + gid], d1 = dpt[r * ld + 16 * mt + gid + 8];
            acc[j][0] = fmaf(d0, xv.x, acc[j][0]);
            acc[j][1] = fmaf(d0, xv.y, acc[j][1]);
            acc[j][2] = fmaf(d1, xv.x, acc[j][2]);
            acc[j][3] = fmaf(d1, xv.y, acc[j][3]);
          }
        }
      }
      // dxh: row gid, n 2 tig (+1), over the warp's contiguous share of the 3H columns
      float c0 = 0.0f, c1 = 0.0f;
      const int cw = three_h / kWarps;  // a multiple of 12
#pragma unroll 4
      for (int c4 = warp * cw; c4 < (warp + 1) * cw; c4 += 4) {
        const float4 d = *reinterpret_cast<const float4*>(dpt + gid * ld + c4);
        const float4 wa = *reinterpret_cast<const float4*>(w_s + (2 * tig) * ld + c4);
        const float4 wb = *reinterpret_cast<const float4*>(w_s + (2 * tig + 1) * ld + c4);
        c0 = fmaf(d.x, wa.x, c0), c0 = fmaf(d.y, wa.y, c0), c0 = fmaf(d.z, wa.z, c0), c0 = fmaf(d.w, wa.w, c0);
        c1 = fmaf(d.x, wb.x, c1), c1 = fmaf(d.y, wb.y, c1), c1 = fmaf(d.z, wb.z, c1), c1 = fmaf(d.w, wb.w, c1);
      }
      red_t[(warp * kTR + gid) * kBwdK + 2 * tig] = c0;
      red_t[(warp * kTR + gid) * kBwdK + 2 * tig + 1] = c1;
    }
    __syncthreads();  // every warp is done with the stage (and, on the last tile, with w_s)
    if (threadIdx.x == 0 && t + kBwdStages < tiles) issue(t + kBwdStages, stage);
    if (threadIdx.x < kTR * kBwdK) {
      const int r = threadIdx.x / kBwdK, n = threadIdx.x % kBwdK, row = t * kTR + r;
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red_t[(q * kTR + r) * kBwdK + n];
      if (row < batch) dxh[(int64_t)row * K + k0 + n] = from_f32<TI>(s);
    }
  }

  // dw[k0 + n][m] = dw^T[m][n], through shared memory (w's rows are free now) into 16-byte stores.
  TI* st = w_s;
#pragma unroll
  for (int j = 0; j < kMTiles; ++j) {
    const int mt = warp + kWarps * j;
    if (mt >= m_tiles) continue;
    const int m = 16 * mt + gid, n = 2 * tig;
    st[n * ld + m] = from_f32<TI>(acc[j][0]);
    st[(n + 1) * ld + m] = from_f32<TI>(acc[j][1]);
    st[n * ld + m + 8] = from_f32<TI>(acc[j][2]);
    st[(n + 1) * ld + m + 8] = from_f32<TI>(acc[j][3]);
  }
  __syncthreads();
  constexpr int kVec = 16 / sizeof(TI);
  const int per_row = three_h / kVec;
  for (int v = threadIdx.x; v < kBwdK * per_row; v += kThreads) {
    const int i = v / per_row, col = (v % per_row) * kVec;
    *reinterpret_cast<int4*>(dw + (int64_t)(k0 + i) * three_h + col) = *reinterpret_cast<const int4*>(st + i * ld + col);
  }
}

// Lets `Kernel` take a block's whole shared memory, once for each instantiation of a kernel
// and each device (the first 64).
template <auto Kernel>
cudaError_t allow_large_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// The launch configuration of `grid` blocks with `smem` bytes of dynamic shared memory, in
// clusters of `cluster_y` blocks along y when it is positive; with `after_previous`, a
// programmatic dependent launch on the stream's previous kernel.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  Launch(dim3 grid, int cluster_y, int smem, cudaStream_t stream, bool after_previous = false) : cfg{}, attr{} {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    if (cluster_y > 0) {
      attr[cfg.numAttrs].id = cudaLaunchAttributeClusterDimension;
      attr[cfg.numAttrs].val.clusterDim.x = 1;
      attr[cfg.numAttrs].val.clusterDim.y = cluster_y;
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

// Launch `Kernel`; returns the launch's error code.
template <auto Kernel, typename... Args>
int launch(dim3 grid, int cluster_y, int smem, bool after_previous, cudaStream_t stream, Args... args) {
  if (smem > 0) {
    const cudaError_t err = allow_large_smem<Kernel>();
    if (err != cudaSuccess) return (int)err;
  }
  Launch l(grid, cluster_y, smem, stream, after_previous);
  const cudaError_t err = cudaLaunchKernelEx(&l.cfg, Kernel, args...);
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

// The tensor map of a row-major [rows, cols] tensor in boxes of box_rows rows by box_cols
// columns, with the swizzle that tile_at reads (or none). Out-of-range elements of a box
// read as zeros.
int map_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int elem, int box_cols, int box_rows,
           CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType type = elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows}, ones[2] = {1, 1};
  if (fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

int check_shape(int batch, int K, int hidden, int elem) {
  if (batch <= 0 || K <= 0 || K % 8 != 0 || hidden <= 0 || hidden % 32 != 0 || hidden > kMaxHidden)
    return (int)cudaErrorInvalidValue;
  if (batch > kMaxBatch) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(batch, K, hidden, elem);
  if (g.fwd_smem > kSmemLimit || g.prod_smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  return 0;
}

int elem_of(int ti) { return ti == 1 ? 2 : 4; }

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16. `ti` is xh's and w's type, `th` h's (and the
// output's), `tg` gamma's and beta's. Every entry returns 0 or the CUDA error of its
// launch; cudaErrorInvalidValue for a shape or type the kernels do not take.

// The geometry of a shape, kGeometryFields ints into `out` in the order of `Geometry`.
extern "C" int rssm_step_geometry(int batch, int K, int hidden, int elem, int* out) {
  if (elem != 2 && elem != 4) return (int)cudaErrorInvalidValue;
  if (const int bad = check_shape(batch, K, hidden, elem)) return bad;
  const Geometry g = geometry(batch, K, hidden, elem);
  const int fields[kGeometryFields] = {g.col_blocks, g.slice_k, g.slices,      g.row_tiles, g.groups,
                                       g.fwd_smem,   g.dp_rows, g.dp_ld,       g.prod_blocks, g.prod_smem};
  for (int i = 0; i < kGeometryFields; ++i) out[i] = fields[i];
  return 0;
}

// The forward: out [B, H] (h's type) and proj [B, 3H] (f32, the backward's residual),
// written in full: the product pass, then the row pass.
extern "C" int rssm_step_fwd(const void* xh, const void* h, const void* w, const void* gamma, const void* beta,
                             void* out, void* proj, int batch, int K, int hidden, float eps, int ti, int th, int tg,
                             void* stream) {
  const int elem = elem_of(ti);
  if (const int bad = check_shape(batch, K, hidden, elem)) return bad;
  const Geometry geo = geometry(batch, K, hidden, elem);
  CUtensorMap x_map, w_map;
  if (const int bad = map_2d(&x_map, xh, batch, K, elem, 128 / elem, kRows * geo.row_tiles, CU_TENSOR_MAP_SWIZZLE_128B))
    return bad;
  if (const int bad = map_2d(&w_map, w, K, 3 * hidden, elem, 128 / elem, fwd_tile_k(elem), CU_TENSOR_MAP_SWIZZLE_128B))
    return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = with_type(ti, [&](auto a) {
    using TI = decltype(a);
    return launch<rssm_step_fwd_product_kernel<TI>>(dim3(geo.col_blocks, geo.slices, geo.groups), geo.slices,
                                                    geo.fwd_smem, false, s, x_map, w_map, static_cast<float*>(proj),
                                                    batch, K, hidden, geo.slice_k, geo.row_tiles);
  });
  if (err != 0) return err;
  return with_type(th, [&](auto b) {
    using TH = decltype(b);
    return with_type(tg, [&](auto c) {
      using TG = decltype(c);
      return launch<rssm_step_fwd_rows_kernel<TH, TG>>(
          dim3(batch), 0, 0, true, s, static_cast<const float*>(proj), static_cast<const TH*>(h),
          static_cast<const TG*>(gamma), static_cast<const TG*>(beta), static_cast<TH*>(out), hidden, eps);
    });
  });
}

// The backward from the forward's proj: the row pass, then the product pass. Workspaces:
// dp_ws [dp_rows, dp_ld] in xh's type and dgb_ws [2, B, 3H] in f32, both written in full
// before they are read.
extern "C" int rssm_step_bwd(const void* xh, const void* h, const void* w, const void* gamma, const void* beta,
                             const void* g, const void* proj, void* dxh, void* dh, void* dw, void* dgamma,
                             void* dbeta, void* dp_ws, void* dgb_ws, int batch, int K, int hidden, float eps, int ti,
                             int th, int tg, void* stream) {
  const int elem = elem_of(ti);
  if (const int bad = check_shape(batch, K, hidden, elem)) return bad;
  const Geometry geo = geometry(batch, K, hidden, elem);
  CUtensorMap x_map;
  if (const int bad = map_2d(&x_map, xh, batch, K, elem, kBwdK, bwd_tile_rows(elem), CU_TENSOR_MAP_SWIZZLE_NONE))
    return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_type(ti, [&](auto a) {
    using TI = decltype(a);
    return with_type(th, [&](auto b) {
      using TH = decltype(b);
      return with_type(tg, [&](auto c) {
        using TG = decltype(c);
        const int err = launch<rssm_step_bwd_rows_kernel<TI, TH, TG>>(
            dim3(geo.dp_rows), 0, 0, false, s, static_cast<const float*>(proj), static_cast<const TH*>(h),
            static_cast<const TG*>(gamma), static_cast<const TG*>(beta), static_cast<const TH*>(g), static_cast<TH*>(dh),
            static_cast<TI*>(dp_ws), static_cast<float*>(dgb_ws), batch, hidden, geo.dp_ld, eps);
        if (err != 0) return err;
        return launch<rssm_step_bwd_products_kernel<TI, TG>>(
            dim3(geo.prod_blocks), 0, geo.prod_smem, true, s, x_map, static_cast<const TI*>(w),
            static_cast<const TI*>(dp_ws), static_cast<const float*>(dgb_ws), static_cast<TI*>(dxh),
            static_cast<TI*>(dw), static_cast<TG*>(dgamma), static_cast<TG*>(dbeta), batch, K, hidden, geo.dp_rows);
      });
    });
  });
}

// cudaOccupancyMaxActiveClusters for the forward's product pass at this shape and type:
// how many of its clusters (geometry().slices blocks each) the card holds at once.
extern "C" int rssm_step_max_active_clusters(int batch, int K, int hidden, int ti, int* out) {
  const int elem = elem_of(ti);
  if (const int bad = check_shape(batch, K, hidden, elem)) return bad;
  const Geometry geo = geometry(batch, K, hidden, elem);
  return with_type(ti, [&](auto a) {
    using TI = decltype(a);
    const cudaError_t err = allow_large_smem<rssm_step_fwd_product_kernel<TI>>();
    if (err != cudaSuccess) return (int)err;
    Launch l(dim3(geo.col_blocks, geo.slices, geo.groups), geo.slices, geo.fwd_smem, nullptr);
    return (int)cudaOccupancyMaxActiveClusters(out, rssm_step_fwd_product_kernel<TI>, &l.cfg);
  });
}
