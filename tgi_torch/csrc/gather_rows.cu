// Row fetch out[g, p, :] = exp[g, cells[g, p], :] for Hopper (sm_90a):
// the raw fetch of the footprint-expanded tri-plane gather, for rows of
// bf16 or fp32.
//
// Replaces tgi/ops/pallas/gather_vmem.py::gather_rows_vmem_bf16 (the
// bf16 fetch) and is the raw fp32 form of gather_rows_vmem (whose fused
// form, with the bilinear lerp, is triplane_gather.cu). The TPU kernel
// holds the whole [HW, L] plane in VMEM and reads one row per point with
// a scalar-indexed dynamic slice; Mosaic refuses bf16 single-row reads,
// so the bf16 kernel reads the plane through an fp32 bit-cast view
// [HW, 64]. None of that survives here: the kernel moves bytes, so one
// source serves every element type. A row is row_bytes bytes (a
// multiple of 16); each thread copies one 16-byte chunk with a vector
// load and a vector store, so a bf16 row of 128 is 16 threads and an
// fp32 row 32 threads, and a warp's loads and stores are whole 128-byte
// lines. Any P is allowed; the ragged last block is masked. A cell
// outside [0, HW) writes a zero row (the TPU kernel's result there is
// undefined, and no caller passes one).
//
// What bounds it: device-memory bytes. At the main path's pass (G = 3,
// HW = 256^2, P = 786,432, L = 128) the output is 604 MB in bf16
// (1.208 GB in fp32), the plane 50.3 MB (100.7 MB) and the cells 9.4 MB:
// 0.198 ms (0.393 ms) at 3.35 TB/s. The plane fits in the 50 MB L2 only
// in part, so rows read by several points are fetched from device
// memory more than once; the output is written once, in order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_rows_kernel(const int4* __restrict__ exp,
                                   const int* __restrict__ cells,
                                   int4* __restrict__ out, long long HW,
                                   long long P, int chunks) {
  const long long g = blockIdx.y;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long p = t / chunks;
  if (p >= P) return;
  const int c = (int)(t - p * chunks);
  const long long cell = __ldg(cells + g * P + p);
  int4 v = make_int4(0, 0, 0, 0);
  if (cell >= 0 && cell < HW) v = __ldg(exp + (g * HW + cell) * chunks + c);
  out[(g * P + p) * chunks + c] = v;
}

}  // namespace

extern "C" {

// exp [G, HW, row_bytes] (any element type), cells [G, P] int32, out
// [G, P, row_bytes], all contiguous and 16-byte aligned on the current
// device. Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (0 = ok).
int tgi_gather_rows(const void* exp, const int* cells, void* out, int G,
                    long long HW, long long P, int row_bytes, void* stream) {
  if (G <= 0 || G > 65535 || HW <= 0 || P <= 0 || row_bytes <= 0 ||
      row_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = row_bytes / 16;
  const long long blocks = (P * chunks + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)G);
  gather_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)exp, cells, (int4*)out, HW, P, chunks);
  return (int)cudaGetLastError();
}

const char* tgi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
