// Masked Hamming-distance matrices of 256-bit descriptors, for sm_90a.
//
// Replaces the Pallas TPU kernel _hamming_kernel
// (gfplslam_tpu/ops/pallas/hamming_pl.py:28; wrapper hamming_matrix_pallas,
// pallas_call at :55), plus the masking that gfplslam_tpu/ops/hamming.py::
// hamming_matrix applies after it: [N, 8] x [M, 8] 32-bit words -> [N, M]
// int32, the XOR popcount summed over the 8 words; a row with
// valid_a[row] == 0 or a column with valid_b[col] == 0 gets BIG = 65536.
// Exact against the reference and against the plain PyTorch version
// gfplslam_torch/ops/hamming.py::hamming_matrix_torch. Any N and M,
// including 0. One launch computes up to four such matrices (a "problem
// table" passed by value in the kernel's parameters), so a frame's pair of
// matrices costs one launch.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; rates measured
// by this file's microbenchmarks, kernel_bench.hamming_rates): the binary
// tensor cores run 1.41e11 m16n8k256 .and.popc products per second, 1.8e13
// 256-bit entries per second, while the CUDA cores run 4.0e12 __popc per
// second (16 per clock per SM), 5.0e11 entries per second at 8 per entry.
// On the tensor cores the popcounts of one SLAM keyframe's six matrices
// (27.6 M entries) take 1.5 us; the int32 matrices written and the
// descriptors read are 111.6 MB, 33.3 us at 3.35 TB/s. So every shape on
// the main path is bound by its bytes: a tracked frame's four matrices
// 3.19 us, train_vocab's [8192, 4096] block 40.2 us. The design this one
// replaced ran 8 __popc per entry on the CUDA cores and sat near that
// popcount ceiling at the back-end's shapes (0.070 ms per keyframe and per
// block).
//
// The design: popc(a & b) on the binary tensor cores, one m16n8k256 per
// 16 x 8 entries (a 256-bit descriptor is exactly one k step), and the
// distance popc(a) + popc(b) - 2 popc(a & b) with the row and column
// popcounts formed once per descriptor while a tile is staged. A block of
// 8 warps owns 64 x 128 output tiles; a persistent grid (as many blocks as
// fit on the card at once, at most one per tile) walks them, each block
// copying its next tile's descriptors with 16-byte cp.async into the other
// half of a double buffer while it computes the current one. The C
// fragments pass through a padded staging tile in shared memory so that
// each warp stores whole 128-byte rows with 16-byte stores; the masks are
// applied there (an invalid row or column carries a popcount that no valid
// sum reaches). No streaming or evict-first hints: the frame's matrices are
// read straight back by argmin/amin and the 50 MB L2 keeps them. Up to
// four problems share one launch, so a frame's pair of matrices (points
// and lines) costs one launch where the one-matrix design paid two. A
// carry-save (Harley-Seal) CUDA-core design with 4 __popc per entry was
// measured beside it and was slower than the 8-__popc design at every
// shape (PERF.md), so it is not kept.
// ptxas (sm_90a): hamming_kernel 40 registers, 33536 bytes shared memory,
// 1 barrier; the rate microbenchmarks 52 and 54 registers; 0 bytes stack
// frame, 0 spill stores, 0 spill loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 16;
constexpr int kThreads = 256;      // 8 warps
constexpr int kTileRows = 64;      // rows of `a` per output tile
constexpr int kTileCols = 128;     // rows of `b` (output columns) per tile
constexpr int kMaxProblems = 4;
// popcount stored for an invalid row or column: popc(a) + popc(b) -
// 2 popc(a & b) with it stays above 512, which no distance (at most 256)
// reaches, so one compare in the epilogue finds it
constexpr int kInvalid = 1 << 20;
// words per row of a warp's 16 x 32 epilogue tile: 8 words of padding put
// the 8 row groups of a fragment store on 8 different bank groups
constexpr int kStageStride = 40;

struct Problem {
  const uint32_t* a;
  const uint32_t* b;
  const uint8_t* valid_a;  // null: every row valid
  const uint8_t* valid_b;  // null: every column valid
  int32_t* out;
  int n, m;
  int col_tiles;
  int first_tile;          // prefix sum of the tile counts before it
  int vec;                 // rows of out start on 16 bytes: 16-byte stores
};

struct Problems {
  Problem p[kMaxProblems];
  int count;
  int tiles;
};

// A tile of descriptors lives in shared memory as 16-byte chunks, two per
// descriptor. The fragment loads read word w of rows r and r + 4 at once,
// so rows 4-7 of every 8 swap their two chunks: no bank conflicts.
__device__ __forceinline__ int chunk_of(int r, int c) {
  return r * 2 + (c ^ ((r >> 2) & 1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// d[0..3] = c[0..3] + popc(A & B) over k = 256 for the m16n8 tile (CUTLASS
// cutlass/arch/mma_sm80.h, GemmShape<16, 8, 256>, OpAndPopc): a lane
// (g = lane / 4, t = lane % 4) holds words t and 4 + t of rows g and g + 8
// of A and of column g of B, and d for rows g, g + 8 by columns 2t, 2t + 1.
__device__ __forceinline__ void mma_and_popc(int32_t d[4], const uint32_t a[4],
                                             const uint32_t b[2],
                                             const int32_t c[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

__device__ __forceinline__ int find_problem(const Problems& P, int tile) {
  int q = 0;
#pragma unroll
  for (int i = 1; i < kMaxProblems; ++i)
    q += (i < P.count && tile >= P.p[i].first_tile) ? 1 : 0;
  return q;
}

// Copies the `a` rows and `b` rows of one output tile into shared memory
// (one 16-byte cp.async per thread and chunk; rows past the edge are
// zero-filled and never stored).
__device__ __forceinline__ void stage(const Problem& p, int row0, int col0,
                                      uint4* sa, uint4* sb) {
  const int t = threadIdx.x;
  {
    const int r = t >> 1, c = t & 1;
    const bool ok = col0 + r < p.m;
    const uint4* src = reinterpret_cast<const uint4*>(p.b) +
                       (ok ? static_cast<size_t>(col0 + r) * 2 + c : 0);
    cp_async16(sb + chunk_of(r, c), src, ok);
  }
  if (t < kTileRows * 2) {
    const int r = t >> 1, c = t & 1;
    const bool ok = row0 + r < p.n;
    const uint4* src = reinterpret_cast<const uint4*>(p.a) +
                       (ok ? static_cast<size_t>(row0 + r) * 2 + c : 0);
    cp_async16(sa + chunk_of(r, c), src, ok);
  }
}

// Four consecutive entries of row `row` from column `col` on: one 16-byte
// store where the row allows it, else one entry at a time up to the edge.
__device__ __forceinline__ void store4(const Problem& p, int row, int col,
                                       int4 v) {
  if (row >= p.n || col >= p.m) return;
  int32_t* o = p.out + static_cast<size_t>(row) * p.m + col;
  if (p.vec) {  // m % 4 == 0, so col + 4 <= m
    *reinterpret_cast<int4*>(o) = v;
    return;
  }
  o[0] = v.x;
  if (col + 1 < p.m) o[1] = v.y;
  if (col + 2 < p.m) o[2] = v.z;
  if (col + 3 < p.m) o[3] = v.w;
}

__device__ __forceinline__ uint32_t word_of(const uint4* s, int chunk, int w) {
  return reinterpret_cast<const uint32_t*>(s + chunk)[w & 3];
}

// One output tile. distance = popc(a) + popc(b) - 2 popc(a & b): the row
// and column popcounts once per descriptor, popc(a & b) by one m16n8k256
// per 16 x 8 entries. Warps form a 2 x 4 grid of 32 x 32 entries; each m16
// half of a warp's block goes through its own 16 x 32 staging tile, from
// which the warp stores 4 whole 128-byte rows per 16-byte store.
__device__ __forceinline__ void compute_tile(const Problem& p, int row0,
                                            int col0, const uint4* sa,
                                            const uint4* sb, int* pop,
                                            int32_t* staging) {
  const int t = threadIdx.x;
  if (t < kTileRows + kTileCols) {
    const bool is_row = t < kTileRows;
    const int r = is_row ? t : t - kTileRows;
    const uint4* s = is_row ? sa : sb;
    const uint4 lo = s[chunk_of(r, 0)], hi = s[chunk_of(r, 1)];
    int c = __popc(lo.x) + __popc(lo.y) + __popc(lo.z) + __popc(lo.w) +
            __popc(hi.x) + __popc(hi.y) + __popc(hi.z) + __popc(hi.w);
    const uint8_t* v = is_row ? p.valid_a : p.valid_b;
    const int at = (is_row ? row0 : col0) + r;
    if (v != nullptr && at < (is_row ? p.n : p.m) && v[at] == 0) c = kInvalid;
    pop[t] = c;
  }
  __syncthreads();

  const int lane = t & 31, warp = t >> 5, g = lane >> 2, q = lane & 3;
  const int wr = (warp >> 2) * 32, wc = (warp & 3) * 32;
  int32_t* st = staging + warp * 16 * kStageStride;
  uint32_t bf[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = wc + j * 8 + g;
    bf[j][0] = word_of(sb, chunk_of(c, 0), q);
    bf[j][1] = word_of(sb, chunk_of(c, 1), q);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r0 = wr + i * 16 + g;
    const uint32_t af[4] = {word_of(sa, chunk_of(r0, 0), q),
                            word_of(sa, chunk_of(r0 + 8, 0), q),
                            word_of(sa, chunk_of(r0, 1), q),
                            word_of(sa, chunk_of(r0 + 8, 1), q)};
    const int p0 = pop[r0], p1 = pop[r0 + 8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int32_t zero[4] = {0, 0, 0, 0};
      int32_t d[4];
      mma_and_popc(d, af, bf[j], zero);
      const int c = wc + j * 8 + 2 * q;
      const int c0 = pop[kTileRows + c], c1 = pop[kTileRows + c + 1];
      int e[4] = {p0 + c0 - 2 * d[0], p0 + c1 - 2 * d[1], p1 + c0 - 2 * d[2],
                  p1 + c1 - 2 * d[3]};
#pragma unroll
      for (int k = 0; k < 4; ++k) e[k] = e[k] > 2 * 256 ? kBig : e[k];
      *reinterpret_cast<int2*>(st + g * kStageStride + j * 8 + 2 * q) =
          make_int2(e[0], e[1]);
      *reinterpret_cast<int2*>(st + (g + 8) * kStageStride + j * 8 + 2 * q) =
          make_int2(e[2], e[3]);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int rr = k * 4 + (lane >> 3), cc = (lane & 7) * 4;
      store4(p, row0 + wr + i * 16 + rr, col0 + wc + cc,
             *reinterpret_cast<const int4*>(st + rr * kStageStride + cc));
    }
    __syncwarp();
  }
}

// A persistent grid: block b computes tiles b, b + gridDim.x, ...; while it
// computes one tile, the cp.async copies of its next tile's descriptors are
// in flight into the other half of the double buffer.
__global__ void __launch_bounds__(kThreads)
hamming_kernel(const __grid_constant__ Problems P) {
  __shared__ uint4 sa[2][kTileRows * 2];
  __shared__ uint4 sb[2][kTileCols * 2];
  __shared__ int pop[kTileRows + kTileCols];
  __shared__ __align__(16) int32_t staging[kThreads / 32 * 16 * kStageStride];
  int tile = blockIdx.x;
  if (tile >= P.tiles) return;
  {
    const Problem& p = P.p[find_problem(P, tile)];
    const int local = tile - p.first_tile;
    stage(p, local / p.col_tiles * kTileRows, local % p.col_tiles * kTileCols,
          sa[0], sb[0]);
  }
  cp_async_commit();
  for (int buf = 0; tile < P.tiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < P.tiles) {
      const Problem& p = P.p[find_problem(P, next)];
      const int local = next - p.first_tile;
      stage(p, local / p.col_tiles * kTileRows, local % p.col_tiles * kTileCols,
            sa[buf ^ 1], sb[buf ^ 1]);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const Problem& p = P.p[find_problem(P, tile)];
    const int local = tile - p.first_tile;
    compute_tile(p, local / p.col_tiles * kTileRows,
                 local % p.col_tiles * kTileCols, sa[buf], sb[buf], pop, staging);
    __syncthreads();
  }
}

// Issue-rate microbenchmarks: every warp runs `iters` rounds of 8
// independent m16n8k256 .and.popc products (tensor cores), or every thread
// 8 independent __popc per round (CUDA cores); the sums go to `sink` so
// nothing is dead code. Launched with 4 blocks per SM, all resident at once
// (at most 64 registers a thread).
constexpr int kRateBlocksPerSm = 4;

__global__ void __launch_bounds__(kThreads, kRateBlocksPerSm)
bmma_rate_kernel(int iters, int32_t* sink) {
  uint32_t a[4] = {threadIdx.x, ~threadIdx.x, threadIdx.x * 7u, blockIdx.x};
  const uint32_t b[2] = {threadIdx.x * 3u, ~blockIdx.x};
  int32_t acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) mma_and_popc(acc[k], a, b, acc[k]);
    a[0] ^= static_cast<uint32_t>(i);
  }
  int32_t s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += acc[k][0] + acc[k][1] + acc[k][2] + acc[k][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads, kRateBlocksPerSm)
popc_rate_kernel(int iters, int32_t* sink) {
  uint32_t v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = (threadIdx.x + 1u) * (2654435761u + k) ^ blockIdx.x;
  int32_t acc[8] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] += __popc(v[k] ^ static_cast<uint32_t>(i));
  }
  int32_t s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += acc[k];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// `count` (1..4) problems, 7 int64 each in `table`: a, b ([n, 8] and
// [m, 8] 32-bit words, 16-byte aligned), valid_a, valid_b ([n] and [m]
// bytes, 0 = invalid, or 0 for "all valid"), out ([n, m] int32), n, m. All
// on the device, contiguous. One launch on `stream` for all of them (none
// if every matrix is empty) of as many blocks as fit on the card at once,
// at most one per tile; returns cudaGetLastError().
extern "C" int gfpl_hamming(int count, const int64_t* table, void* stream) {
  if (count < 1 || count > kMaxProblems) return cudaErrorInvalidValue;
  Problems P = {};
  P.count = count;
  for (int i = 0; i < count; ++i) {
    const int64_t* t = table + 7 * i;
    Problem& p = P.p[i];
    p.a = reinterpret_cast<const uint32_t*>(t[0]);
    p.b = reinterpret_cast<const uint32_t*>(t[1]);
    p.valid_a = reinterpret_cast<const uint8_t*>(t[2]);
    p.valid_b = reinterpret_cast<const uint8_t*>(t[3]);
    p.out = reinterpret_cast<int32_t*>(t[4]);
    p.n = static_cast<int>(t[5]);
    p.m = static_cast<int>(t[6]);
    if (p.n < 0 || p.m < 0 || ((t[0] | t[1]) & 15) != 0)
      return cudaErrorInvalidValue;
    p.col_tiles = (p.m + kTileCols - 1) / kTileCols;
    p.first_tile = P.tiles;
    p.vec = p.m % 4 == 0 && (t[4] & 15) == 0;
    P.tiles += (p.n + kTileRows - 1) / kTileRows * p.col_tiles;
  }
  if (P.tiles == 0) return cudaSuccess;
  // resident blocks (SMs x blocks per SM), per device, looked up once
  static int resident[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& slots = resident[dev & 63];
  if (slots == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hamming_kernel,
                                                  kThreads, 0);
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = P.tiles < slots ? P.tiles : slots;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  hamming_kernel<<<grid, kThreads, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// `blocks` blocks of 256 threads (4 per SM: one wave) of one rate
// microbenchmark (`tensor` 1: m16n8k256 .and.popc, 8 per warp per round; 0:
// __popc, 8 per thread per round) for `iters` rounds; `sink` holds
// blocks x 256 int32.
extern "C" int gfpl_hamming_rate(int tensor, int blocks, int iters, void* sink,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(sink);
  if (tensor)
    bmma_rate_kernel<<<blocks, kThreads, 0, s>>>(iters, out);
  else
    popc_rate_kernel<<<blocks, kThreads, 0, s>>>(iters, out);
  return static_cast<int>(cudaGetLastError());
}
