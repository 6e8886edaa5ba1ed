// Masked Hamming-distance matrix of 256-bit descriptors, for sm_90a.
//
// Replaces the Pallas TPU kernel _hamming_kernel
// (gfplslam_tpu/ops/pallas/hamming_pl.py:28; wrapper hamming_matrix_pallas,
// pallas_call at :55), plus the masking that gfplslam_tpu/ops/hamming.py::
// hamming_matrix applies after it: [N, 8] x [M, 8] 32-bit words -> [N, M]
// int32, XOR + __popc summed over the 8 words; a row with valid_a[row] == 0
// or a column with valid_b[col] == 0 gets BIG = 65536. Exact against the
// reference and against the plain PyTorch version
// gfplslam_torch/ops/hamming.py::hamming_matrix_torch. Any N and M: the
// ragged edge is masked here, where the Pallas wrapper fell back to XLA for
// shapes that did not tile.
//
// What bounds it on an H100: one tracked frame asks for 1024x1024, 512x512,
// 1024x1024 and 512x512 matrices, 2.62 M entries in four launches. The
// descriptors and masks read and the int32 matrices written are 10.7 MB,
// 3.19 us at 3.35 TB/s: that is the bound. The popcounts do not set it,
// because the card can run them on its binary tensor cores (see below). On
// the CUDA cores this design uses, each entry costs 8 __popc, which issue at
// 16 per clock per SM: 21 M popcounts, 5.0 us per frame. The kernel is not
// at half its bound (PERF.md): half the bound is 6.4 us, and the card's own
// Tensor.fill_ of the same four matrices already takes 8.1 us per frame
// (profile_torch_kernels.py), so the write and the four launches hold it
// back.
//
// The design: a block stages 32 rows of `a` and 32 rows of `b` (1 KB each)
// in shared memory, the `b` tile padded to 9 words per row so the 32 lanes
// of a warp hit 32 different banks; each thread holds one `b` descriptor in
// registers and computes 4 outputs of one column, reading the `a` words as
// warp-wide broadcasts, and consecutive lanes write consecutive columns
// (128 bytes per warp store). With 8 warps per block and 30 registers, 64
// warps fit on an SM, which hides the staging latency. Two Hopper designs
// were measured against it in the same chip calls and were slower per frame:
// binary tensor cores (mma.m16n8k256 .and.popc: popc(a) + popc(b) -
// 2 popc(a & b)) and a register-tiled 4x4 popcount kernel with 16-byte
// stores (PERF.md, "FAST-9 and Hamming on Hopper").
// ptxas (sm_90a, CUDA 12.9): 30 registers, 2176 bytes shared memory,
// 0 bytes stack frame, 0 spill stores, 0 spill loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 8;
constexpr int kTile = 32;      // rows of a and of b per block
constexpr int kRowsY = 8;      // blockDim.y; each thread covers kTile / kRowsY rows
constexpr int kBig = 1 << 16;

__global__ void __launch_bounds__(kTile * kRowsY)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               const uint8_t* __restrict__ valid_a,
               const uint8_t* __restrict__ valid_b, int32_t* __restrict__ out,
               int n, int m) {
  __shared__ uint32_t a_s[kTile][kWords];
  __shared__ uint32_t b_s[kTile][kWords + 1];
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;  // 0..255 = one word each
  {
    const int r = tid / kWords;
    const int k = tid % kWords;
    a_s[r][k] = row0 + r < n ? a[static_cast<size_t>(row0 + r) * kWords + k] : 0u;
    b_s[r][k] = col0 + r < m ? b[static_cast<size_t>(col0 + r) * kWords + k] : 0u;
  }
  __syncthreads();

  const int col = col0 + threadIdx.x;
  if (col >= m) return;
  uint32_t bw[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) bw[k] = b_s[threadIdx.x][k];
  const bool col_ok = valid_b == nullptr || valid_b[col] != 0;
#pragma unroll
  for (int i = 0; i < kTile / kRowsY; ++i) {
    const int r = threadIdx.y + kRowsY * i;
    const int row = row0 + r;
    if (row >= n) break;
    int d = 0;
#pragma unroll
    for (int k = 0; k < kWords; ++k) d += __popc(a_s[r][k] ^ bw[k]);
    if (!col_ok || (valid_a != nullptr && valid_a[row] == 0)) d = kBig;
    out[static_cast<size_t>(row) * m + col] = d;
  }
}

}  // namespace

// a: [n, 8], b: [m, 8] 32-bit words; valid_a: [n], valid_b: [m] bytes (0 =
// invalid) or null for "all valid"; out: [n, m] int32. All on the device,
// contiguous. Launches on `stream`; returns cudaGetLastError().
extern "C" int gfpl_hamming(const void* a, const void* b, const void* valid_a,
                            const void* valid_b, void* out, int n, int m,
                            void* stream) {
  const dim3 block(kTile, kRowsY);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint8_t*>(valid_a), static_cast<const uint8_t*>(valid_b),
      static_cast<int32_t*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}
