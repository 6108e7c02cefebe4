// Packed bilinear splat under a fixed window schedule, for Hopper
// (sm_90a): acc[g, rows[g, e], :] += float(wg[g, e, :]) over the entries
// that the schedule visits, with 128-element bf16 payloads wg, int32
// tile-numbered rows and an fp32 accumulator acc [G, H*W, 128] that the
// caller zeroes.
//
// Replaces scripts/bench_splat_sched.py::run_kernel, the TPU bench of
// tgi/ops/pallas/splat_pack.py::plane_splat_pack's schedule, with its
// three kernel bodies, per 512-entry block:
//   walk    (splat_pack._kernel, bench variant A): the first entry's
//           window, then the window of the smallest row not yet done,
//           each clamped to nrows - 256; exact;
//   static9 (_kernel_static, variant B): the 9 consecutive windows from
//           the first entry's window, clamped to nrows - 9 * 256; the
//           entries outside them are dropped, wrong by design (the TPU
//           bench times it only);
//   nbhd    (_kernel_nbhd, variant C): the 4x4 tile neighbourhood
//           anchored at the block's (min window-y, min window-x), clamped
//           to W/16 - 4, then the walk over the entries it did not
//           cover; exact.
// The windows visited, and the entries added in each, are the TPU
// bodies' (the windows are aligned and disjoint, so each entry is added
// at most once). Where the TPU adds a window with one one-hot matmul
// [256, B] x [B, 128] into a VMEM accumulator, here one CTA takes a
// block, one thread per entry; in each pass every warp takes a ballot
// of its entries in the window and adds each such entry's payload (bf16
// widened to fp32) to the accumulator in device memory with atomicAdd,
// 32 channels at a time. A block-wide min sets the walk's next window.
// The order of the atomic adds changes from run to run, so the result is
// not bitwise repeatable. Rows outside [0, H*W) are dropped; a walk
// whose first entry has one starts at the smallest row's window.
//
// Layout: H and W multiples of 16 (tile numbering); static9 and nbhd
// also need H, W >= 64 and H*W >= 9 * 256.
//
// What bounds it: device-memory bytes. At G = 3, 256^2 planes,
// E = 786,432 entries a plane: wg 604 MB read, rows 9.4 MB read, acc
// 100.7 MB written, 0.213 ms at 3.35 TB/s; the 302 M adds take 0.005 ms
// at 67 TFLOP/s. The atomics go to the L2, which holds about half of the
// 100.7 MB accumulator.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 512;   // entries per CTA, one per thread
constexpr int kWindow = 256;  // rows per tile window
constexpr int kWarps = kBlock / 32;
constexpr int kLanes = 128;   // payload elements per entry
constexpr int kNone = 1 << 30;

enum Schedule { kWalk = 0, kStatic9 = 1, kNbhd = 2 };

__device__ int block_min(int v, int* warp_min) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = warp_min[0];
  for (int w = 1; w < kWarps; ++w) m = min(m, warp_min[w]);
  __syncthreads();
  return m;
}

__device__ int window_of(int row, int nrows) {
  return min((row / kWindow) * kWindow, nrows - kWindow);
}

__device__ float bf16_to_float(unsigned short bits) {
  return __uint_as_float((unsigned)bits << 16);
}

// Every lane of the warp calls this. Adds the payloads of the warp's
// entries whose `sel` is set: lane l takes channels l, l + 32, l + 64
// and l + 96, so each atomic instruction covers 32 consecutive floats.
__device__ void add_selected(bool sel, int row, long long e_warp,
                             const unsigned short* __restrict__ wg,
                             float* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  unsigned ballot = __ballot_sync(0xffffffffu, sel);
  while (ballot) {
    const int j = __ffs(ballot) - 1;
    ballot &= ballot - 1;
    const int r = __shfl_sync(0xffffffffu, row, j);
    const unsigned short* src = wg + (e_warp + j) * kLanes;
    float* dst = acc + (long long)r * kLanes;
#pragma unroll
    for (int k = 0; k < kLanes / 32; ++k)
      atomicAdd(dst + lane + 32 * k, bf16_to_float(__ldg(src + lane + 32 * k)));
  }
}

__global__ void __launch_bounds__(kBlock)
splat_sched_kernel(const unsigned short* __restrict__ wg,
                   const int* __restrict__ rows, float* __restrict__ acc,
                   long long E, int nrows, int wgrid, int schedule) {
  __shared__ int warp_min[kWarps];
  __shared__ int first_raw;

  const long long g = blockIdx.y;
  const long long e0 = (long long)blockIdx.x * kBlock;
  const int tid = threadIdx.x;
  const long long e = e0 + tid;
  const long long e_warp = g * E + e0 + (tid & ~31);
  float* acc_g = acc + g * nrows * kLanes;

  int raw = kNone;
  int row = kNone;  // this entry's row, while not yet added
  if (e < E) {
    raw = __ldg(rows + g * E + e);
    if (raw >= 0 && raw < nrows) row = raw;
  }
  if (tid == 0) first_raw = raw;

  int undone = row;
  if (schedule == kStatic9) {
    __syncthreads();
    // floor((first row) / 256) * 256, as the TPU body computes it.
    const int fw = first_raw >= 0 ? first_raw / kWindow
                                  : -((-first_raw + kWindow - 1) / kWindow);
    const int first = min(fw * kWindow, nrows - 9 * kWindow);
    for (int k = 0; k < 9; ++k) {
      const int base = first + k * kWindow;
      add_selected(row >= base && row < base + kWindow, row, e_warp, wg,
                   acc_g);
    }
    return;
  }
  if (schedule == kNbhd) {
    const int wid = row == kNone ? kNone : row / kWindow;
    const int wy = row == kNone ? kNone : wid / wgrid;
    const int wx = row == kNone ? kNone : wid % wgrid;
    const int wy0 = min(block_min(wy, warp_min), wgrid - 4);
    const int wx0 = min(block_min(wx, warp_min), wgrid - 4);
    for (int ky = 0; ky < 4; ++ky) {
      for (int kx = 0; kx < 4; ++kx) {
        const int base = ((wy0 + ky) * wgrid + (wx0 + kx)) * kWindow;
        add_selected(row >= base && row < base + kWindow, row, e_warp, wg,
                     acc_g);
      }
    }
    const bool covered = row != kNone && wy >= wy0 && wy < wy0 + 4 &&
                         wx >= wx0 && wx < wx0 + 4;
    if (covered) undone = kNone;
  }
  // The walk: all of it for kWalk, the residual for kNbhd. The walk
  // starts at the window of the block's first entry (thread 0's, made
  // visible by block_min's barrier) where its row is valid, the residual
  // and a walk without one at the smallest row's.
  int m = block_min(undone, warp_min);
  const bool from_first =
      schedule == kWalk && first_raw >= 0 && first_raw < nrows;
  int base = window_of(from_first ? first_raw : m, nrows);
  while (m != kNone) {
    const bool in = undone >= base && undone < base + kWindow;
    add_selected(in, row, e_warp, wg, acc_g);
    if (in) undone = kNone;
    m = block_min(undone, warp_min);
    base = window_of(m, nrows);
  }
}

}  // namespace

extern "C" {

// wg [G, E, 128] bf16 (as 16-bit words), rows [G, E] int32, acc
// [G, H*W, 128] fp32, zeroed by the caller; all contiguous on the current
// device. schedule: 0 walk, 1 static9, 2 nbhd. Launches on `stream`,
// allocates nothing, and returns cudaGetLastError() (0 = ok).
int tgi_splat_sched(const void* wg, const int* rows, float* acc, int G,
                    long long E, int H, int W, int schedule, void* stream) {
  const long long nrows = (long long)H * W;
  if (G <= 0 || G > 65535 || E <= 0 || H <= 0 || W <= 0 || H % 16 != 0 ||
      W % 16 != 0 || nrows >= kNone || schedule < kWalk || schedule > kNbhd)
    return (int)cudaErrorInvalidValue;
  if (schedule != kWalk && (H < 64 || W < 64 || nrows < 9 * kWindow))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (E + kBlock - 1) / kBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)G);
  splat_sched_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const unsigned short*)wg, rows, acc, E, (int)nrows, W / 16, schedule);
  return (int)cudaGetLastError();
}

const char* tgi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
