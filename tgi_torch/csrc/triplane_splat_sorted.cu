// Sorted tri-plane splat: the backward of the EG3D render's feature
// sampling as a segmented reduction, with no atomics, for Hopper
// (sm_90a). Its d_planes is bitwise the same from run to run.
//
// Replaces tgi/ops/pallas/splat_mxu.py::plane_splat_mxu
// (_plane_splat_mxu_impl :117, kernel body _make_kernel :45), the route
// tgi takes with TGI_SPLAT=mxu (tgi/ops/grid_sample.py:262,292-299). Both
// compute d_planes[plane, cell, c] = sum over the (point, corner) entries
// that land on cell of w_corner(point) * g[plane, point, c]. The TPU
// kernel packs 128/C cells per 128-lane row and sums each 512-entry block
// of sorted entries into 64-row windows of a VMEM accumulator with
// one-hot MXU matmuls, because the TPU has no fast scatter. None of that
// survives: on Hopper a sorted entry list is a set of segments, and one
// warp per cell sums its own segment in registers.
//
// Two kernels, and the prep between them:
//   1. splat_cells_kernel writes each (plane, point, corner) entry's cell,
//      entry e = 4 * point + corner (corners in the order 00, 01, 10, 11),
//      with the round-to-nearest index arithmetic of triplane_gather.cu
//      (scale by 2/box_warp, project (x,y), (x,z), (z,x), unnormalise with
//      align_corners=False, floor), so the corners are the gather's. A
//      corner outside the plane gets the sentinel cell H*W.
//   2. The wrapper sorts each plane's entries by cell with
//      torch.sort(stable=True) and finds the segment offsets
//      [G, H*W + 1] with torch.searchsorted. These two library calls are
//      the counterpart of the XLA argsort and take_along_axis that tgi
//      runs before its Pallas kernel (splat_mxu.py:138-150); they are the
//      prep, not the kernel.
//   3. splat_segments_kernel: one warp per (plane, cell), lanes over
//      channels, a loop over channel chunks of 32 for any C. It walks its
//      segment in sorted order; for each entry it recomputes the corner
//      weight from the point's coordinates (the arithmetic of
//      triplane_splat.cu: w00 = (1-wx)(1-wy), w01 = wx(1-wy),
//      w10 = (1-wx)wy, w11 = wx wy) and adds w * g[point, c] to a register
//      with round-to-nearest adds in entry order. The cell's row is
//      written once; an empty segment writes zeros, so no memset is
//      needed. Sentinel entries sort last and belong to no cell's
//      segment.
// The sums run in a fixed order, so two runs give the same bits, and the
// plain version (an index order-preserving segment sum) agrees to
// rounding.
//
// Layouts: coords [N, M, 3] fp32; g [N, 3, M, C] fp32; cells [N*3, 4M]
// int32; order [N*3, 4M] int64 (torch.sort's indices: entries in cell
// order); offsets [N*3, H*W + 1] int32; d_planes [N*3, H, W, C] fp32
// (channels last).
//
// What bounds it. At the full-width render (N = 1, M = 786,432, C = 32,
// 3 planes of 256x256) the segment kernel must read g (302 MB), the
// entries (9.4 M, 38 MB as int32; this design reads torch.sort's int64
// indices, 75 MB) and the offsets (0.8 MB), and write d_planes (25 MB):
// about 366 MB, 0.11 ms at 3.35 TB/s. This simple design reads each
// point's g row once per corner, in cell order, not in the order it lies
// in memory: 4 x 302 MB of scattered 128-byte reads that the 50 MB L2
// cannot hold, so it is bound by the latency and bytes of those reads,
// several times the bound. The prep (cells, sort, search) adds a pass
// over 9.4 M keys.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Corners {
  int x0, y0;
  float wx, wy;
};

// The gather's index arithmetic for one point on one plane.
__device__ __forceinline__ Corners point_corners(const float* __restrict__ co,
                                                 int plane, int H, int W,
                                                 float scale) {
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
  Corners c;
  c.x0 = (int)x0f;
  c.y0 = (int)y0f;
  c.wx = __fsub_rn(ix, x0f);
  c.wy = __fsub_rn(iy, y0f);
  return c;
}

__global__ void splat_cells_kernel(const float* __restrict__ coords,
                                   int* __restrict__ cells, int H, int W,
                                   long long M, float scale) {
  const int gp = blockIdx.y;  // n * 3 + plane
  const int n = gp / 3;
  const int plane = gp - 3 * n;
  const long long m = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const Corners c = point_corners(coords + ((long long)n * M + m) * 3, plane,
                                  H, W, scale);
  const int sentinel = H * W;
  int out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yy = c.y0 + (k >> 1);
    const int xx = c.x0 + (k & 1);
    const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
    out[k] = ok ? yy * W + xx : sentinel;
  }
  int4* dst = reinterpret_cast<int4*>(cells + ((long long)gp * M + m) * 4);
  *dst = make_int4(out[0], out[1], out[2], out[3]);
}

__global__ void splat_segments_kernel(const float* __restrict__ g,
                                      const float* __restrict__ coords,
                                      const long long* __restrict__ order,
                                      const int* __restrict__ offsets,
                                      float* __restrict__ d_planes, int H,
                                      int W, int C, long long M,
                                      float scale) {
  const int gp = blockIdx.y;
  const int n = gp / 3;
  const int plane = gp - 3 * n;
  const int HW = H * W;
  const int cell = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (cell >= HW) return;  // whole warps leave together
  const int* off = offsets + (long long)gp * (HW + 1);
  const int begin = __ldg(off + cell);
  const int end = __ldg(off + cell + 1);
  const long long* ord = order + (long long)gp * 4 * M;
  const float* gv = g + (long long)gp * M * C;
  const float* co = coords + (long long)n * M * 3;
  float* dst = d_planes + ((long long)gp * HW + cell) * C;

  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    for (int e = begin; e < end; ++e) {
      const long long ent = __ldg(ord + e);
      const long long m = ent >> 2;
      const int k = (int)(ent & 3);
      const Corners p = point_corners(co + m * 3, plane, H, W, scale);
      const float ax = (k & 1) ? p.wx : __fsub_rn(1.f, p.wx);
      const float ay = (k >> 1) ? p.wy : __fsub_rn(1.f, p.wy);
      const float w = __fmul_rn(ax, ay);
      if (c < C) acc = __fadd_rn(acc, __fmul_rn(w, __ldg(gv + m * C + c)));
    }
    if (c < C) dst[c] = acc;
  }
}

}  // namespace

extern "C" {

// coords [N, M, 3] fp32 -> cells [N*3, 4M] int32 (entry 4m + k is corner
// k = 2*dy + dx of point m; H*W where the corner is outside the plane);
// scale = 2 / box_warp. Launches on `stream`, allocates nothing, and
// returns the first CUDA error (0 = ok).
int tgi_splat_cells_f32(const float* coords, int* cells, int N, int H, int W,
                        long long M, float scale, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || M <= 0 || N * 3 > 65535 ||
      (long long)H * W >= 2147483647LL || 4 * M >= 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (M + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)blocks, (unsigned)(N * 3));
  splat_cells_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      coords, cells, H, W, M, scale);
  return (int)cudaGetLastError();
}

// g [N, 3, M, C], coords [N, M, 3], order [N*3, 4M] int64 (each plane's
// entries sorted by cell), offsets [N*3, H*W + 1] int32 (each cell's
// first entry in that order) -> d_planes [N*3, H, W, C], every element
// written. All contiguous on the current device. Launches on `stream`,
// allocates nothing, and returns the first CUDA error (0 = ok).
int tgi_splat_segments_f32(const float* g, const float* coords,
                           const long long* order, const int* offsets,
                           float* d_planes, int N, int H, int W, int C,
                           long long M, float scale, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || M <= 0 || N * 3 > 65535 ||
      (long long)H * W >= 2147483647LL || 4 * M >= 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)H * W + kWarps - 1) / kWarps;
  const dim3 grid((unsigned)blocks, (unsigned)(N * 3));
  splat_segments_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      g, coords, order, offsets, d_planes, H, W, C, M, scale);
  return (int)cudaGetLastError();
}

const char* tgi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
