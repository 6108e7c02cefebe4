// Tile-walk row fetch for Hopper (sm_90a): out[g, p, :] =
// exp[g, cells[g, p], :] from a plane whose rows are numbered in 16x16
// cell tiles, 256 rows per tile, walking the 256-row windows that each
// 512-point block touches.
//
// Replaces tgi/ops/pallas/gather_vmem.py::gather_rows_mxu. The TPU
// kernel has no fast dynamic row read, so per 512-point block it walks
// the touched windows (the first point's window, then the window of the
// smallest row not yet done, each clamped to nrows - 256) and fetches a
// window's rows with one one-hot matmul [B, 256] x [256, L] on the MXU.
// The walk is kept here, with one CTA per block and one thread per
// point; the matmul is not. Each pass stages the 256-row window in
// shared memory with coalesced 16-byte loads (64 KB for a bf16 row of
// 128, 128 KB for fp32), the block's points in that window enqueue
// themselves in a shared list, and the CTA copies their rows from
// shared memory to the output in 16-byte chunks. A block-wide min
// finds the next window. The result is a bitwise copy for any point
// order; the order sets only the number of passes, which the kernel
// writes per block into the optional `passes` output (what the TPU
// bench's block-local against ray-major comparison is about).
//
// The plane's row count must be a multiple of 256 (H and W multiples of
// 16), so the windows are aligned and disjoint and each point is copied
// in exactly one pass. A cell outside [0, nrows) writes a zero row (the
// TPU kernel would never finish there; no caller passes one). A block
// whose first point has such a cell starts at the smallest row's window.
//
// What bounds it: device-memory bytes, as the plain fetch
// (gather_rows.cu): at G = 3, 256^2 planes, P = 786,432, a bf16 row of
// 128, the output is 604 MB, the plane 50.3 MB and the cells 9.4 MB,
// 0.198 ms at 3.35 TB/s (fp32: 1.208 GB + 100.7 MB + 9.4 MB, 0.393 ms).
// This design reads each touched window once per block, so a window
// shared by many blocks is re-read (mostly from the L2), and a pass's
// load, copy and min run one after another in the CTA; with one 128 KB
// fp32 window a CTA fills an SM, three bf16 ones share it.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 512;   // points per CTA, one per thread
constexpr int kWindow = 256;  // rows per tile window
constexpr int kWarps = kBlock / 32;
constexpr int kNone = 1 << 30;

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

__global__ void __launch_bounds__(kBlock)
tilewalk_kernel(const int4* __restrict__ exp, const int* __restrict__ cells,
                int4* __restrict__ out, int* __restrict__ passes, int nrows,
                long long P, int chunks) {
  extern __shared__ int4 win[];  // [kWindow, chunks]
  __shared__ int list[kBlock];   // point * kWindow + row - base
  __shared__ int warp_min[kWarps];
  __shared__ int count;
  __shared__ int first_row;

  const long long g = blockIdx.y;
  const long long p0 = (long long)blockIdx.x * kBlock;
  const int tid = threadIdx.x;
  const long long p = p0 + tid;

  int row = kNone;  // this thread's point, while not yet copied
  if (p < P) {
    const int cell = __ldg(cells + g * P + p);
    if (cell >= 0 && cell < nrows) {
      row = cell;
    } else {
      for (int c = 0; c < chunks; ++c)
        out[(g * P + p) * chunks + c] = make_int4(0, 0, 0, 0);
    }
  }
  if (tid == 0) {
    count = 0;
    first_row = row;
  }
  int m = block_min(row, warp_min);
  int base = window_of(first_row != kNone ? first_row : m, nrows);
  int npass = 0;
  const int4* plane = exp + g * nrows * chunks;
  while (m != kNone) {
    const int4* src = plane + (long long)base * chunks;
    for (int i = tid; i < kWindow * chunks; i += kBlock)
      win[i] = __ldg(src + i);
    __syncthreads();
    const bool mine = row >= base && row < base + kWindow;
    if (mine) list[atomicAdd(&count, 1)] = tid * kWindow + (row - base);
    __syncthreads();
    const int n = count;
    for (int i = tid; i < n * chunks; i += kBlock) {
      const int k = i / chunks;
      const int c = i - k * chunks;
      const int e = list[k];
      const int r = e % kWindow;
      out[(g * P + p0 + e / kWindow) * chunks + c] = win[r * chunks + c];
    }
    if (mine) row = kNone;
    ++npass;
    m = block_min(row, warp_min);  // its barriers also end the copy
    if (tid == 0) count = 0;
    base = window_of(m, nrows);
  }
  if (passes != nullptr && tid == 0) passes[g * gridDim.x + blockIdx.x] = npass;
}

}  // namespace

extern "C" {

// exp [G, nrows, row_bytes] (any element type) with tile-numbered rows,
// cells [G, P] int32, out [G, P, row_bytes], passes [G, ceil(P / 512)]
// int32 or null; all contiguous and 16-byte aligned on the current
// device. nrows must be a positive multiple of 256. Launches on
// `stream`, allocates nothing, and returns cudaGetLastError() (0 = ok).
int tgi_gather_tilewalk(const void* exp, const int* cells, void* out,
                        int* passes, int G, int nrows, long long P,
                        int row_bytes, void* stream) {
  if (G <= 0 || G > 65535 || nrows < kWindow || nrows % kWindow != 0 ||
      nrows >= kNone || P <= 0 || row_bytes <= 0 || row_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = kWindow * row_bytes;
  if (smem > 220 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tilewalk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (P + kBlock - 1) / kBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)G);
  tilewalk_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      (const int4*)exp, cells, (int4*)out, passes, nrows, P, row_bytes / 16);
  return (int)cudaGetLastError();
}

const char* tgi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
