// Tri-plane bilinear gather: the forward of the EG3D render's feature
// sampling, for Hopper (sm_90a).
//
// Replaces tgi/ops/pallas/gather_vmem.py::gather_rows_vmem (the TPU
// kernel) together with its caller's epilogue, tgi/ops/grid_sample.py:
// 192-213 (un-remap of the border slots, zero padding, fp32 lerp). The
// TPU design (a footprint-expanded [H*W, 4C] plane held in VMEM, one
// 128-lane row read per point, a slot remap at the borders) exists
// because the TPU has no fast dynamic gather; none of it survives. Here
// one pass does, per (plane, point): scale the world point by
// 2/box_warp, project it onto the plane ((x,y), (x,z), (z,x)),
// unnormalise (align_corners=False), floor, load the four corner rows
// of C floats with zero padding, and lerp in the reference order
//   top = v00 + (v01 - v00) * wx; bot = v10 + (v11 - v10) * wx;
//   out = top + (bot - top) * wy.
// The arithmetic uses round-to-nearest intrinsics so that nvcc does not
// contract it into FMAs: the result then matches the plain PyTorch
// version to the last bit or so.
//
// Layouts: planes [N*3, H, W, C] fp32 (channels last; the wrapper makes
// them with one permute per render), coords [N, M, 3] fp32, out
// [N, 3, M, C] fp32.
//
// What bounds it: device-memory bytes. At the full-width render
// (N = 1, M = 128*128*48 = 786,432, C = 32, 256x256 planes) one pass
// writes 3 * 786,432 * 32 * 4 B = 302 MB and reads 9.4 MB of coords and
// 25 MB of planes, which fit in the 50 MB L2, so the four corner
// re-reads of each plane cell mostly hit L2. About 336 MB in all, or
// 0.10 ms at 3.35 TB/s. The design serves the write stream: the threads
// of one point take neighbouring channels, so at C = 32 each corner load
// and the output store of a warp are one coalesced 128-byte line; a loop
// covers any C. The last block's ragged points are masked.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void triplane_gather_kernel(const float* __restrict__ planes,
                                       const float* __restrict__ coords,
                                       float* __restrict__ out, int H, int W,
                                       int C, long long M, float scale,
                                       int lanes) {
  const int gp = blockIdx.y;  // n * 3 + plane
  const int n = gp / 3;
  const int plane = gp - 3 * n;
  const int points_per_block = kThreads / lanes;
  const long long m =
      (long long)blockIdx.x * points_per_block + threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  if (m >= M) return;

  const float* co = coords + ((long long)n * M + m) * 3;
  const float x = __fmul_rn(scale, __ldg(co + 0));
  const float y = __fmul_rn(scale, __ldg(co + 1));
  const float z = __fmul_rn(scale, __ldg(co + 2));
  // Horizontal (width) and vertical (height) plane coordinates.
  const float u = plane == 2 ? z : x;
  const float v = plane == 0 ? y : (plane == 1 ? z : x);

  const float ix = __fadd_rn(__fmul_rn(__fadd_rn(u, 1.0f), 0.5f * W), -0.5f);
  const float iy = __fadd_rn(__fmul_rn(__fadd_rn(v, 1.0f), 0.5f * H), -0.5f);
  const float x0f = floorf(ix);
  const float y0f = floorf(iy);
  const float wx = __fsub_rn(ix, x0f);
  const float wy = __fsub_rn(iy, y0f);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;

  const bool x0ok = x0 >= 0 && x0 < W;
  const bool x1ok = x0 + 1 >= 0 && x0 + 1 < W;
  const bool y0ok = y0 >= 0 && y0 < H;
  const bool y1ok = y0 + 1 >= 0 && y0 + 1 < H;
  // Offsets of the four corner rows; only those of valid corners are read.
  const float* base = planes + (long long)gp * H * W * C;
  const long long o00 = ((long long)y0 * W + x0) * C;
  const long long o01 = o00 + C;
  const long long o10 = o00 + (long long)W * C;
  const long long o11 = o10 + C;
  float* o = out + ((long long)gp * M + m) * C;

  for (int c = lane; c < C; c += lanes) {
    const float v00 = (y0ok && x0ok) ? __ldg(base + o00 + c) : 0.0f;
    const float v01 = (y0ok && x1ok) ? __ldg(base + o01 + c) : 0.0f;
    const float v10 = (y1ok && x0ok) ? __ldg(base + o10 + c) : 0.0f;
    const float v11 = (y1ok && x1ok) ? __ldg(base + o11 + c) : 0.0f;
    const float top = __fadd_rn(v00, __fmul_rn(__fsub_rn(v01, v00), wx));
    const float bot = __fadd_rn(v10, __fmul_rn(__fsub_rn(v11, v10), wx));
    o[c] = __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), wy));
  }
}

}  // namespace

extern "C" {

// planes [N*3, H, W, C], coords [N, M, 3], out [N, 3, M, C], all fp32 and
// contiguous on the current device; scale = 2 / box_warp. Launches on
// `stream`, allocates nothing, and returns cudaGetLastError() (0 = ok).
int tgi_triplane_gather_f32(const float* planes, const float* coords,
                            float* out, int N, int H, int W, int C,
                            long long M, float scale, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || M <= 0 || N * 3 > 65535)
    return (int)cudaErrorInvalidValue;
  int lanes = 1;  // threads per point: next power of two >= C, at most 32
  while (lanes < C && lanes < 32) lanes *= 2;
  const long long points_per_block = kThreads / lanes;
  const long long blocks = (M + points_per_block - 1) / points_per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)(N * 3));
  triplane_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      planes, coords, out, H, W, C, M, scale, lanes);
  return (int)cudaGetLastError();
}

const char* tgi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
