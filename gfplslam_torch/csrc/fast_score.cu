// FAST-9 corner score map for a batch of same-shape images, for sm_90a.
//
// Replaces the Pallas TPU kernel gfplslam_tpu/ops/pallas/fast_pl.py::
// _fast_score_kernel (wrapper fast_score_map_pallas). Bit-exact with
// gfplslam_tpu/ops/fast.py::fast_score_map_xla and with the plain PyTorch
// version gfplslam_torch/ops/fast.py::fast_score_map_torch:
//   - the image is rounded to bf16 (round to nearest even);
//   - d_k = I(p + c_k) - I(p) over the 16 radius-3 Bresenham taps, and the
//     margins d - t (bright, where d > t) and -d - t (dark, where d < -t) are
//     each computed in f32 and rounded to bf16, as bf16 arithmetic does;
//     comparisons run in f32 on the bf16 values (exact);
//   - score = max over the 16 circular 9-windows of the window min, for the
//     bright and the dark margins, the larger kept (min/max do not round);
//   - non-finite -> 0, negatives -> 0, the 3-px border -> 0. The score is
//     computed over the whole array, zero padding of pyramid levels included.
// The threshold is read from device memory, so the adaptive-FAST loop can
// change it every frame with no rebuild and no host read.
//
// What bounds it on an H100: not memory. One frame's eight maps (2x480x752 +
// 6x400x627 pixels) move ~18 MB, a few microseconds at 3.35 TB/s, while each
// pixel costs ~200 f32 ALU operations (16 subtractions with two bf16
// roundings, 32 selects, the two window-min trees). The design keeps every
// image byte read once from device memory: a block stages its 32x16 output
// tile plus a 3-px halo in shared memory (bf16-rounded once, held as f32),
// each thread keeps its 32 margins in registers, and the window mins use the
// reference's shift-min doubling tree (1, 2, 4, then the 9th tap), which
// halves the min count against a direct 9-wide min per window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kHalo = 3;
constexpr int kSmemW = kTileW + 2 * kHalo;
constexpr int kSmemH = kTileH + 2 * kHalo;
constexpr int kArc = 9;

// Bresenham circle of radius 3, clockwise from (0, -3).
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// max over the 16 circular 9-windows of the window min, by the reference's
// doubling tree over the circularly extended 24 entries
__device__ __forceinline__ float arc_score(const float (&x)[16]) {
  float m[24];
#pragma unroll
  for (int k = 0; k < 24; ++k) m[k] = x[k & 15];
#pragma unroll
  for (int s = 1; s <= 4; s <<= 1) {
#pragma unroll
    for (int k = 0; k < 24 - s; ++k) m[k] = fminf(m[k], m[k + s]);
  }
  float best = -INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) best = fmaxf(best, fminf(m[k], x[(k + kArc - 1) & 15]));
  return best;
}

__global__ void __launch_bounds__(kTileW * kTileH)
fast_score_kernel(const float* __restrict__ imgs, float* __restrict__ out,
                  int h, int w, const float* __restrict__ threshold) {
  __shared__ float tile[kSmemH][kSmemW];
  const size_t plane = static_cast<size_t>(h) * w;
  const float* img = imgs + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  // halo taps outside the image clamp to the edge; they only feed the
  // 3-px border, which is zeroed below
  for (int i = tid; i < kSmemH * kSmemW; i += kTileW * kTileH) {
    const int ty = i / kSmemW;
    const int tx = i - ty * kSmemW;
    const int gy = min(max(y0 + ty - kHalo, 0), h - 1);
    const int gx = min(max(x0 + tx - kHalo, 0), w - 1);
    tile[ty][tx] = bf16_round(img[static_cast<size_t>(gy) * w + gx]);
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  float score = 0.0f;
  if (y >= 3 && y < h - 3 && x >= 3 && x < w - 3) {
    const float t = bf16_round(*threshold);
    const int cy = threadIdx.y + kHalo;
    const int cx = threadIdx.x + kHalo;
    const float c = tile[cy][cx];
    float bright[16], dark[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float d = bf16_round(tile[cy + kDy[k]][cx + kDx[k]] - c);
      bright[k] = d > t ? bf16_round(d - t) : -INFINITY;
      dark[k] = d < -t ? bf16_round(-d - t) : -INFINITY;
    }
    score = fmaxf(arc_score(bright), arc_score(dark));
    score = isfinite(score) ? fmaxf(score, 0.0f) : 0.0f;
  }
  out[blockIdx.z * plane + static_cast<size_t>(y) * w + x] = score;
}

}  // namespace

// imgs, out: [b, h, w] f32 contiguous on the device; threshold: one f32 on
// the device. Launches on `stream`; returns cudaGetLastError().
extern "C" int gfpl_fast_score(const float* imgs, float* out, int b, int h,
                               int w, const float* threshold, void* stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      imgs, out, h, w, threshold);
  return static_cast<int>(cudaGetLastError());
}
