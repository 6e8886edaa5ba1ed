// FAST-9 corner score map for a batch of same-shape images, for sm_90a.
//
// Replaces the Pallas TPU kernel _fast_score_kernel
// (gfplslam_tpu/ops/pallas/fast_pl.py:41; wrapper fast_score_map_pallas,
// pallas_call at :98). Bit-exact with gfplslam_tpu/ops/fast.py::
// fast_score_map_xla and with the plain PyTorch version
// gfplslam_torch/ops/fast.py::fast_score_map_torch:
//   - the image is rounded to bf16 (round to nearest even);
//   - d_k = I(p + c_k) - I(p) over the 16 radius-3 Bresenham taps, rounded
//     to bf16; the bright margin d - t where d > t and the dark margin
//     -d - t where d < -t, each rounded to bf16;
//   - score = max over the 16 circular 9-windows of the window min, for the
//     bright and the dark margins, the larger kept;
//   - non-finite -> 0, negatives -> 0, the 3-px border -> 0. The whole array
//     is scored, zero padding of pyramid levels included.
// The threshold is read from device memory, so the adaptive-FAST loop can
// change it every frame with no rebuild and no host read.
//
// What bounds it on an H100: one full-width frame is 2x480x752 + 6x400x627
// = 2.23 Mpx in two launches. It moves 17.8 MB (f32 in and out), 5.3 us at
// 3.35 TB/s: that is the bound. The operations stay below it: 19 per pixel
// for the compass test below and 114 more for the ~9% of pixels that pass
// it at t = 20 (1.2 us at 67 T/s; 3.9 us if every pixel took the full
// score). The reference's recipe costs ~300 operations per pixel plus ~50
// f32 -> bf16 conversions, which issue at 16 per clock per SM. The design:
//   - All arithmetic is bf16x2, two horizontally neighbouring pixels per
//     register and per instruction (sub.rn / min / max / set.gt .bf16x2). A
//     bf16 subtraction rounds the exact difference once to nearest even,
//     which is what the reference's f32 subtraction followed by a bf16
//     rounding gives: the f32 difference of two bf16 values of image range
//     is exact. The only conversion is the input's (cvt.rn.bf16x2.f32, one
//     per two pixels, while staging).
//   - The margins leave the window trees. Rounding is monotone, so the best
//     bright window's margin min is bf16(M - t) with M = max_w min_{k in w}
//     d_k when M > t, and no window is all bright otherwise; the dark side is
//     the same on -d, with -M' = min_w max_k d_k. The trees run once on d.
//   - Neighbouring windows w_k, w_{k+1} share their 8 middle taps:
//     max(min w_k, min w_{k+1}) = min(m8_{k+1}, max(d_k, d_{k+9})), with the
//     8-tap mins m8 at odd starts built by doubling. One side takes 47
//     min/max, against 92 for the reference's tree.
//   - Exact early exit: any 9-arc holds two neighbouring compass taps (0, 4,
//     8, 12), so a pixel pair where no such couple is bright or dark scores
//     0. The pairs that pass are listed per warp (ballot) and scored densely
//     by the warp's lanes from shared memory, so the trees run only where a
//     pixel passes (9% of the main-path pixels at t = 20).
//   - A block stages a 128x16 output tile plus its halo (22 rows x 136 px)
//     in shared memory as bf16 pairs aligned to the pixel pairs, with 16-byte
//     loads where rows are 16-byte aligned and every load issued before the
//     first use. Scores are gathered in shared memory and leave as coalesced
//     stores: a float4 per lane where rows are 16-byte aligned, one f32 per
//     lane otherwise (the 627-px levels, or a view that starts off a 16-byte
//     boundary; the host checks the width and both addresses). Every register-array index is a
//     compile-time constant after unrolling: nothing lives in local memory.
// What holds it back (PERF.md): the card's own Tensor.copy_ of the same
// 17.8 MB takes 10.5 us, half the bound; staging with its halo and the
// write-out take most of the rest, and they overlap the scoring only across
// blocks.
// ptxas (sm_90a, CUDA 12.9): 48 registers, 12128 bytes shared memory,
// 0 bytes stack frame, 0 spill stores, 0 spill loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPx = 8;                         // pixels per thread, one row
constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kTileW = kThreadsX * kPx;        // 128 output columns
constexpr int kTileH = kThreadsY;              // 16 output rows
constexpr int kHalo = 3;
constexpr int kPad = 4;                        // staged columns left of the tile (even, 16 B)
constexpr int kStageW = kTileW + 2 * kPad;     // 136 px = 68 words per staged row
constexpr int kStageH = kTileH + 2 * kHalo;    // 22 rows
constexpr int kQuads = kStageW / 4;            // 16-byte input loads per staged row
constexpr int kQuadSteps = (kStageH * kQuads + kThreads - 1) / kThreads;
constexpr int kPairsW = kTileW / 2;            // pixel pairs per tile row

// Bresenham circle of radius 3, clockwise from (0, -3).
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int circle_dx(int k) {
  return (k & 8 ? -1 : 1) * imin(imin(k & 7, 8 - (k & 7)), 3);
}
__host__ __device__ constexpr int circle_dy(int k) { return -circle_dx((k + 4) & 15); }
static_assert(circle_dx(0) == 0 && circle_dy(0) == -3 && circle_dx(3) == 3 &&
              circle_dy(3) == -1 && circle_dx(6) == 2 && circle_dy(6) == 2 &&
              circle_dx(9) == -1 && circle_dy(9) == 3 && circle_dx(13) == -3 &&
              circle_dy(13) == -1 && circle_dx(15) == -1 && circle_dy(15) == -3,
              "not the FAST circle");

// bf16x2 arithmetic on raw 32-bit words: low half = left pixel of the pair
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t min2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("min.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t gt2(uint32_t a, uint32_t b) {  // 0xffff per half where a > b
  uint32_t r;
  asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// Tap k of the pixel pair at pair column pc of tile row `row`: staged word
// o/2 holds staged columns (o, o+1), so a tap at odd dx straddles two words.
__device__ __forceinline__ uint32_t tap(const uint32_t (*stage)[kStageW / 2],
                                        int row, int pc, int k) {
  const uint32_t* r = stage[row + kHalo + circle_dy(k)] + pc;
  const int o = kPad + circle_dx(k);
  return (o & 1) ? __byte_perm(r[o >> 1], r[(o >> 1) + 1], 0x5432) : r[o >> 1];
}

// Nonzero where a pixel of the pair can be a corner. A 9-arc holds two
// neighbouring compass taps (0, 4, 8, 12), so a pixel with no such couple
// of bright (d > t) or dark (d < -t) taps scores 0 exactly. n, e, s, w are
// the compass differences.
__device__ __forceinline__ uint32_t compass(uint32_t n, uint32_t e, uint32_t s,
                                            uint32_t w, uint32_t t2) {
  const uint32_t neg_t2 = t2 ^ 0x80008000u;
  const uint32_t bn = gt2(n, t2), be = gt2(e, t2), bs = gt2(s, t2), bw = gt2(w, t2);
  const uint32_t kn = gt2(neg_t2, n), ke = gt2(neg_t2, e), ks = gt2(neg_t2, s),
                 kw = gt2(neg_t2, w);
  return ((bn | bs) & (be | bw)) | ((kn | ks) & (ke | kw));
}

// FAST-9 score of one pixel pair as bf16x2 (+0 where not a corner), from
// its 16 circle differences.
__device__ __forceinline__ uint32_t pair_score(const uint32_t (&d)[16], uint32_t t2) {
  // m[i] / x[i]: min / max of d over the 8 taps from 2i+1 on, by doubling
  uint32_t m[8], x[8], mt[8], xt[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = min2(d[2 * i + 1], d[(2 * i + 2) & 15]);
    x[i] = max2(d[2 * i + 1], d[(2 * i + 2) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mt[i] = min2(m[i], m[(i + 1) & 7]);
    xt[i] = max2(x[i], x[(i + 1) & 7]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = min2(mt[i], mt[(i + 2) & 7]);
    x[i] = max2(xt[i], xt[(i + 2) & 7]);
  }
  // windows 2i and 2i+1 together, then a max / min tree over the 8 pairs
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mt[i] = min2(m[i], max2(d[2 * i], d[(2 * i + 9) & 15]));
    xt[i] = max2(x[i], min2(d[2 * i], d[(2 * i + 9) & 15]));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mt[i] = max2(mt[i], mt[i + 4]);
    xt[i] = min2(xt[i], xt[i + 4]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = max2(mt[i], mt[i + 2]);
    xt[i] = min2(xt[i], xt[i + 2]);
  }
  const uint32_t bright = max2(mt[0], mt[1]);
  const uint32_t dark = min2(xt[0], xt[1]) ^ 0x80008000u;  // -min_w max_k d_k = max_w min_k (-d_k), exact
  const uint32_t sb = sub2(bright, t2) & gt2(bright, t2);
  const uint32_t sd = sub2(dark, t2) & gt2(dark, t2);
  return max2(sb, sd);
}

__global__ void __launch_bounds__(kThreads, 4)
fast_score_kernel(const float* __restrict__ imgs, float* __restrict__ out,
                  int h, int w, const float* __restrict__ threshold, bool vec) {
  __shared__ __align__(16) uint32_t stage[kStageH][kStageW / 2];  // bf16 image pairs
  __shared__ __align__(16) uint32_t score[kTileH][kPairsW];       // bf16 score pairs
  __shared__ uint16_t cand[kThreads / 32][32 * kPx / 2];         // per-warp candidate pairs
  const size_t plane = static_cast<size_t>(h) * w;
  const float* img = imgs + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  // 1. stage the tile and its halo as bf16, 4 px per step (one 16-byte
  //    load where rows are 16-byte aligned), every load issued before the
  //    first use. Pixels outside the image read 0: they feed only the 3-px
  //    border, which is zeroed at the end.
#pragma unroll
  for (int it = 0; it < kQuadSteps; ++it) {
    const int q = tid + it * kThreads;
    if (q < kStageH * kQuads) {
      const int r = q / kQuads;
      const int gy = y0 - kHalo + r;
      const int gx = x0 - kPad + 4 * (q - r * kQuads);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < h) {
        const float* row = img + static_cast<size_t>(gy) * w;
        if (vec && gx >= 0 && gx + 3 < w) {
          v = __ldg(reinterpret_cast<const float4*>(row + gx));
        } else {
          if (gx >= 0 && gx < w) v.x = __ldg(row + gx);
          if (gx + 1 >= 0 && gx + 1 < w) v.y = __ldg(row + gx + 1);
          if (gx + 2 >= 0 && gx + 2 < w) v.z = __ldg(row + gx + 2);
          if (gx + 3 >= 0 && gx + 3 < w) v.w = __ldg(row + gx + 3);
        }
      }
      *reinterpret_cast<uint2*>(&stage[r][2 * (q - r * kQuads)]) =
          make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
    }
  }
  __syncthreads();

  // 2. exact early exit per pixel pair from the compass taps, then the
  //    full score of the surviving pairs, shared out densely over the lanes
  //    of the warp that found them; every other pair scores +0.
  const uint32_t t = __bfloat16_as_ushort(__float2bfloat16_rn(__ldg(threshold)));
  const uint32_t t2 = t | (t << 16);
  const int lane = tid & 31;
  uint16_t* list = cand[tid >> 5];
  const unsigned below = (1u << lane) - 1u;
  const int ty = threadIdx.y;
  const int pc0 = 4 * threadIdx.x;              // first of this thread's 4 pairs
  const uint2 n_lo = *reinterpret_cast<const uint2*>(&stage[ty][pc0 + 2]);
  const uint2 n_hi = *reinterpret_cast<const uint2*>(&stage[ty][pc0 + 4]);
  const uint2 s_lo = *reinterpret_cast<const uint2*>(&stage[ty + 2 * kHalo][pc0 + 2]);
  const uint2 s_hi = *reinterpret_cast<const uint2*>(&stage[ty + 2 * kHalo][pc0 + 4]);
  const uint4 lo = *reinterpret_cast<const uint4*>(&stage[ty + kHalo][pc0]);
  const uint4 hi = *reinterpret_cast<const uint4*>(&stage[ty + kHalo][pc0 + 4]);
  const uint32_t mid[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const uint32_t nn[4] = {n_lo.x, n_lo.y, n_hi.x, n_hi.y};
  const uint32_t ss[4] = {s_lo.x, s_lo.y, s_hi.x, s_hi.y};
  *reinterpret_cast<uint4*>(&score[ty][pc0]) = make_uint4(0u, 0u, 0u, 0u);
  int count = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t c = mid[j + 2];
    const uint32_t east = __byte_perm(mid[j + 3], mid[j + 4], 0x5432);  // dx = +3
    const uint32_t west = __byte_perm(mid[j], mid[j + 1], 0x5432);      // dx = -3
    const bool live = compass(sub2(nn[j], c), sub2(east, c), sub2(ss[j], c),
                              sub2(west, c), t2) != 0u;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (live) list[count + __popc(ballot & below)] = static_cast<uint16_t>(ty * kPairsW + pc0 + j);
    count += __popc(ballot);
  }
  __syncwarp();
  for (int i = lane; i < count; i += 32) {
    const int row = list[i] / kPairsW;
    const int pc = list[i] - row * kPairsW;
    const uint32_t c = stage[row + kHalo][pc + kPad / 2];
    uint32_t d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = sub2(tap(stage, row, pc, k), c);
    score[row][pc] = pair_score(d, t2);
  }
  __syncthreads();

  // 3. write the tile as f32 with the 3-px border zeroed, neighbouring lanes
  //    on neighbouring pixels: 16-byte stores where rows are aligned
  float* dst = out + blockIdx.z * plane;
  const uint16_t* score_px = reinterpret_cast<const uint16_t*>(&score[0][0]);
  if (vec) {
#pragma unroll
    for (int it = 0; it < kTileH * kTileW / 4 / kThreads; ++it) {
      const int q = tid + it * kThreads;
      const int row = q / (kTileW / 4);
      const int col = 4 * (q - row * (kTileW / 4));
      const int y = y0 + row, x = x0 + col;
      if (y < h && x < w) {
        const uint2 pk = *reinterpret_cast<const uint2*>(&score[row][col / 2]);
        const bool row_ok = y >= kHalo && y < h - kHalo;
        auto px = [&](int i, uint32_t bits) {
          return row_ok && x + i >= kHalo && x + i < w - kHalo ? __uint_as_float(bits) : 0.0f;
        };
        const float4 v = make_float4(px(0, pk.x << 16), px(1, pk.x & 0xffff0000u),
                                     px(2, pk.y << 16), px(3, pk.y & 0xffff0000u));
        *reinterpret_cast<float4*>(dst + static_cast<size_t>(y) * w + x) = v;
      }
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < kTileH * kTileW; i += kThreads) {
      const int row = i / kTileW;
      const int y = y0 + row, x = x0 + (i - row * kTileW);
      if (y < h && x < w) {
        const bool inner = y >= kHalo && y < h - kHalo && x >= kHalo && x < w - kHalo;
        dst[static_cast<size_t>(y) * w + x] =
            inner ? __uint_as_float(static_cast<uint32_t>(score_px[i]) << 16) : 0.0f;
      }
    }
  }
}

}  // namespace

// imgs, out: [b, h, w] f32 contiguous on the device, at any 4-byte
// address; threshold: one f32 on the device. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int gfpl_fast_score(const float* imgs, float* out, int b, int h,
                               int w, const float* threshold, void* stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  // 16-byte loads and stores only where every row of both buffers starts
  // 16-byte aligned: a view may begin anywhere in its storage
  const bool vec = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(imgs) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      imgs, out, h, w, threshold, vec);
  return static_cast<int>(cudaGetLastError());
}
