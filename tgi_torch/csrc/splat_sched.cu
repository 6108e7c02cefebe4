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
// of its entries in the window and groups them by row
// (__match_any_sync). Lane l owns channels 4l..4l+3 of a row: per entry
// it makes one 8-byte payload load (4 bf16, widened to fp32) and sums
// the entries of one row in registers (the block-local order keeps a
// ray's samples together, and they often share a cell); each row then
// reaches the accumulator in device memory with one float4 atomicAdd per
// lane (atom.global.add.v4.f32, compute capability 9.x). A block-wide
// min sets the walk's next window. The order of the atomic adds changes
// from run to run, so the result is not bitwise repeatable. Rows outside
// [0, H*W) are dropped; a walk whose first entry has one starts at the
// smallest row's window.
//
// Layout: H and W multiples of 16 (tile numbering); static9 and nbhd
// also need H, W >= 64 and H*W >= 9 * 256; wg 8-byte aligned.
//
// What bounds it: device-memory bytes. At G = 3, 256^2 planes,
// E = 786,432 entries a plane: wg 604 MB read, rows 9.4 MB read, acc
// 100.7 MB written, 0.213 ms at 3.35 TB/s; the 302 M adds take 0.005 ms
// at 67 TFLOP/s. The atomics go to the L2, which holds about half of the
// 100.7 MB accumulator. The earlier design, four 2-byte loads and four
// scalar atomicAdds of 32 consecutive floats per entry, took 5.5 x that
// bound on an H100 (tgi_torch/scripts/triplane_variants.py). The float4
// atomics alone moved it by 3-4 %: the L2 saw the same 128-byte
// reductions. What the L2 reduces is the limit, so this design sends it
// one row per distinct row of a ballot: summing runs of one row halved
// the walk, grouping each ballot by row took another 1-24 % (nbhd and
// static9 the most). A 128 KB shared-memory window flushed once per pass
// took 9-10 times as long (one block per SM, shared atomics and two
// barriers per pass).

#include <cuda_runtime.h>
#include <stdint.h>

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

// Lane `lane`'s four payload elements of entry e, widened to fp32; a
// streaming load, since each payload is read once.
__device__ __forceinline__ float4 payload(
    const unsigned short* __restrict__ wg, long long e, int lane) {
  const uint2 b = __ldcs(reinterpret_cast<const uint2*>(wg + e * kLanes) +
                         lane);
  return make_float4(__uint_as_float(b.x << 16),
                     __uint_as_float(b.x & 0xffff0000u),
                     __uint_as_float(b.y << 16),
                     __uint_as_float(b.y & 0xffff0000u));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Every lane of the warp calls this. Adds the payloads of the warp's
// entries whose `sel` is set: the entries that share a row (found with
// __match_any_sync) are summed in registers, in lane order, and reach the
// accumulator with one float4 atomic per lane.
__device__ void add_selected(bool sel, int row, long long e_warp,
                             const unsigned short* __restrict__ wg,
                             float* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  if (__ballot_sync(0xffffffffu, sel) == 0) return;
  // Lanes not selected match no one: -1 - lane is no row.
  const unsigned peers = __match_any_sync(0xffffffffu, sel ? row : -1 - lane);
  unsigned leaders =
      __ballot_sync(0xffffffffu, sel && __ffs(peers) - 1 == lane);
  while (leaders) {
    const int l = __ffs(leaders) - 1;
    leaders &= leaders - 1;
    const int r = __shfl_sync(0xffffffffu, row, l);
    unsigned group = __shfl_sync(0xffffffffu, peers, l);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    while (group) {
      const int j = __ffs(group) - 1;
      group &= group - 1;
      sum = add4(sum, payload(wg, e_warp + j, lane));
    }
    atomicAdd(reinterpret_cast<float4*>(acc + (long long)r * kLanes) + lane,
              sum);
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

// wg [G, E, 128] bf16 (as 16-bit words, 8-byte aligned), rows [G, E]
// int32, acc [G, H*W, 128] fp32 (16-byte aligned), zeroed by the caller;
// all contiguous on the current device. schedule: 0 walk, 1 static9,
// 2 nbhd. Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (0 = ok).
int tgi_splat_sched(const void* wg, const int* rows, float* acc, int G,
                    long long E, int H, int W, int schedule, void* stream) {
  const long long nrows = (long long)H * W;
  if (G <= 0 || G > 65535 || E <= 0 || H <= 0 || W <= 0 || H % 16 != 0 ||
      W % 16 != 0 || nrows >= kNone || schedule < kWalk ||
      schedule > kNbhd || (uintptr_t)wg % 8 != 0 || (uintptr_t)acc % 16 != 0)
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
