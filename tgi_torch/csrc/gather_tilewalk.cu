// Tile-walk row fetch for Hopper (sm_90a): out[g, p, :] =
// exp[g, cells[g, p], :] from a plane whose rows are numbered in 16x16
// cell tiles, 256 rows per tile, and per 512-point block the number of
// 256-row windows the TPU kernel's walk visits.
//
// Replaces tgi/ops/pallas/gather_vmem.py::gather_rows_mxu. The TPU
// kernel has no fast dynamic row read, so per 512-point block it walks
// the touched windows (the first point's window, then the window of the
// smallest row not yet done) and fetches a window's rows with one
// one-hot matmul [B, 256] x [256, L] on the MXU. The card reads any row
// directly, so the walk decides nothing here: the kernel keeps the TPU
// kernel's function, not its blocks. One wave of resident 512-thread
// CTAs walks the (plane, 512-point block) pairs with a grid-stride loop.
// Per block each thread loads one cell into shared memory; when
// `passes` is asked for, the leader of each warp's lanes that share a
// window (__match_any_sync) inserts the window into a 1,024-slot shared
// hash table, and the block's fresh inserts are its passes (the walk
// visits each touched window once and no other; at most 512 keys, so
// any nrows works). Then the CTA copies the block's rows in 16-byte
// chunks, a bf16 row of 128 by 16 lanes and an fp32 row by 32, four
// loads in flight per thread. A cell outside [0, nrows) writes a zero
// row (the TPU kernel would never finish there; no caller passes one).
// The plane's row count must be a multiple of 256 (H and W multiples of
// 16), as the TPU kernel's tiles need; that is what makes its clamp
// min(window, nrows - 256) a no-op.
//
// What bounds it: device-memory bytes, as the plain fetch
// (gather_rows.cu): at G = 3, 256^2 planes, P = 786,432, a bf16 row of
// 128, the output is 604 MB, the plane 50.3 MB and the cells 9.4 MB,
// 0.198 ms at 3.35 TB/s (fp32: 1.208 GB + 100.7 MB + 9.4 MB, 0.393 ms).
// The earlier design staged each touched 256-row window whole in shared
// memory (64 KB bf16, 128 KB fp32) once per pass, so at 23 passes per
// block in ray-major order the L2 served ~12 times the output's bytes
// and the kernel lost to torch indexing. This one stages nothing: each
// output row is one row read (non-coherent, so a row the block repeats
// can hit L1; the bench's blocks name 151 distinct rows of 512 in
// block-local order, 297 in ray-major order), and the output goes out
// with streaming stores (st.global.cs) that keep it from evicting the
// plane from the L2. On an H100 80GB HBM3 at 700 W it takes 0.248-0.259
// ms (bf16) and 0.509-0.527 ms (fp32) at P = 786,432 in either order,
// 75-80 % of that bound and within 6 % of gather_rows.cu on the same
// bytes (tgi_torch/scripts/triplane_variants.py). Staging a window's rows
// through cp.async into a double buffer took 1.6-2.3 times as long;
// bucketing the block's points by window first, L2-only loads, or eight
// loads in flight each moved it by under 4 %.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 512;   // points per block (the TPU's MXU_BLOCK)
constexpr int kWindow = 256;  // rows per tile window
constexpr int kSlots = 1024;  // hash slots for a block's windows
constexpr int kUnroll = 4;    // 16-byte loads in flight per thread

__device__ __forceinline__ int slot_of(int window) {
  return (int)(((unsigned)window * 0x9E3779B1u) >> 22);  // top 10 bits
}

__global__ void __launch_bounds__(kBlock)
tilewalk_kernel(const int4* __restrict__ exp, const int* __restrict__ cells,
                int4* __restrict__ out, int* __restrict__ passes, int nrows,
                long long P, long long nb, long long nblocks, int chunks) {
  __shared__ int rows[kBlock];    // the block's rows, -1 out of range
  __shared__ int table[kSlots];   // windows seen, -1 empty
  __shared__ int distinct;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (long long b = blockIdx.x; b < nblocks; b += gridDim.x) {
    const long long g = b / nb;
    const long long p0 = (b - g * nb) * kBlock;
    const int n = (int)min((long long)kBlock, P - p0);
    int row = -1;
    if (tid < n) {
      const int cell = __ldg(cells + g * P + p0 + tid);
      if (cell >= 0 && cell < nrows) row = cell;
    }
    rows[tid] = row;
    if (passes != nullptr) {
      for (int i = tid; i < kSlots; i += kBlock) table[i] = -1;
      if (tid == 0) distinct = 0;
      __syncthreads();
      const int w = row < 0 ? -1 : row / kWindow;
      const unsigned peers = __match_any_sync(0xffffffffu, w);
      int fresh = 0;
      if (w >= 0 && lane == __ffs(peers) - 1) {
        for (int s = slot_of(w);; s = (s + 1) & (kSlots - 1)) {
          const int prev = atomicCAS(&table[s], -1, w);
          if (prev == -1) fresh = 1;
          if (prev == -1 || prev == w) break;
        }
      }
      const unsigned found = __ballot_sync(0xffffffffu, fresh);
      if (lane == 0 && found != 0) atomicAdd(&distinct, __popc(found));
    }
    __syncthreads();
    if (passes != nullptr && tid == 0) passes[b] = distinct;

    const int total = n * chunks;
    const int4* plane = exp + g * nrows * chunks;
    int4* dst = out + (g * P + p0) * chunks;
    for (int e0 = tid; e0 < total; e0 += kBlock * kUnroll) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * kBlock;
        v[u] = make_int4(0, 0, 0, 0);
        if (e < total) {
          const int k = e / chunks;
          const int r = rows[k];
          const long long at = (long long)r * chunks + e - k * chunks;
          if (r >= 0) v[u] = __ldg(plane + at);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * kBlock;
        if (e < total) __stcs(dst + e, v[u]);
      }
    }
    __syncthreads();  // rows, table and distinct serve the next block
  }
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
      P <= 0 || row_bytes <= 0 || row_bytes % 16 != 0 ||
      row_bytes / 16 > (1 << 30) / kBlock)
    return (int)cudaErrorInvalidValue;
  static int resident = 0;  // CTAs the card holds at once, found once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tilewalk_kernel, kBlock, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * per_sm;
  }
  const long long nb = (P + kBlock - 1) / kBlock;
  const long long nblocks = nb * G;
  const long long grid = nblocks < resident ? nblocks : resident;
  tilewalk_kernel<<<(unsigned)grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const int4*)exp, cells, (int4*)out, passes, nrows, P, nb, nblocks,
      row_bytes / 16);
  return (int)cudaGetLastError();
}

const char* tgi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
