// Tri-plane splat: the backward of the EG3D render's feature sampling,
// for Hopper (sm_90a).
//
// Replaces two TPU kernels and the XLA code around them in
// tgi/ops/grid_sample.py::_gsp_bwd (236-301):
//   tgi/ops/pallas/splat_pack.py::plane_splat_pack (C = 32, H and W
//     divisible by 16: the full-width shape), and
//   tgi/ops/pallas/splat.py::plane_splat (any other C that divides 128
//     and is at most 64, e.g. the C = 16 and C = 8 test planes),
// and fuses _gsp_bwd's d_coords formula (255-260) with the fold back
// through project_onto_planes and the 2/box_warp scale. The TPU designs
// (footprint packing of four corner slots into 128 lanes, bf16 payload
// rounding, 16x16 cell tiling with one-hot MXU matmuls, the ray-layout
// reordering, the fold of expanded slots, the serialized
// read-modify-write of a [2, 2C] window) exist because the TPU has no
// fast scatter; none of it survives. The payload stays fp32.
//
// One thread group per world point covers all three planes. Per plane it
// scales the point by 2/box_warp, projects it ((x,y), (x,z), (z,x)),
// unnormalises (align_corners=False) and floors exactly as
// triplane_gather.cu does, so both kernels pick the same corners. The
// group's lanes take neighbouring channels: lane c adds w_k * g[c] into
// each valid corner with atomicAdd (a red.global.add.f32, its result
// unused), so at C = 32 a warp's reduction into one corner is one
// 128-byte line. A corner outside the plane gets no store. A loop over
// channels covers any C. Where d_coords is asked for, each lane also
// re-reads its channel of the four corners from the planes and forms
//   dix = ((v01-v00)(1-wy) + (v11-v10)wy) * g,
//   diy = ((v10-v00)(1-wx) + (v11-v01)wx) * g;
// a shuffle reduction over the group sums them over C, they are scaled
// by W/2 and H/2, and lane 0 folds the three planes' (dix, diy) into the
// world axes in the kernel:
//   dx = s (d0.x + d1.x + d2.y), dy = s d0.y, dz = s (d1.y + d2.x).
// No atomics are needed for d_coords, since one group owns the point.
//
// With want_dplanes = 0 the kernel skips the memset and the atomics and
// writes d_coords alone: the point gradient of the TGI_SPLAT=mxu route,
// whose d_planes comes from triplane_splat_sorted.cu (tgi too computes
// d_coords apart from its mxu splat, tgi/ops/grid_sample.py:253-260).
//
// The order of the atomic adds changes from run to run, so d_planes is
// not bitwise deterministic; it agrees with the plain version to
// rounding.
//
// Layouts: g [N, 3, M, C] fp32; coords [N, M, 3] fp32; planes
// [N*3, H, W, C] fp32 (channels last; read only for d_coords);
// d_planes [N*3, H, W, C] fp32, zeroed here with cudaMemsetAsync on the
// same stream (null with want_dplanes = 0); d_coords [N, M, 3] fp32 or
// null.
//
// What bounds it. At the full-width render (N = 1, M = 128*128*48 =
// 786,432, C = 32, 3 planes of 256x256) one pass reads g (302 MB),
// coords (9.4 MB) and, for d_coords, the planes (25 MB, which the 50 MB
// L2 holds), and writes d_planes (25 MB) and d_coords (9.4 MB): about
// 371 MB, 0.11 ms at 3.35 TB/s. It also makes 4 * 75.5 M fp32
// reductions into a 25 MB target that the L2 holds; the L2's atomic
// rate, not device-memory bytes, is the likelier limit of this simple
// design. Shared-memory pre-reduction of points that share a cell is a
// later lever.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float group_sum(float v, int lanes) {
  // Lanes of one group are `lanes` consecutive threads, aligned within
  // the warp, so xor offsets below `lanes` stay inside the group.
  for (int off = lanes / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void triplane_splat_kernel(const float* __restrict__ g,
                                      const float* __restrict__ coords,
                                      const float* __restrict__ planes,
                                      float* __restrict__ d_planes,
                                      float* __restrict__ d_coords, int H,
                                      int W, int C, long long M,
                                      long long NM, float scale, int lanes,
                                      bool want_dplanes) {
  const int points_per_block = kThreads / lanes;
  const long long p =
      (long long)blockIdx.x * points_per_block + threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  // Threads past the last point do no work but still join the shuffles.
  const bool active = p < NM;
  const long long n = active ? p / M : 0;
  const long long m = active ? p - n * M : 0;
  const bool want_coords = planes != nullptr;

  float x = 0.f, y = 0.f, z = 0.f;
  if (active) {
    const float* co = coords + p * 3;
    x = __fmul_rn(scale, __ldg(co + 0));
    y = __fmul_rn(scale, __ldg(co + 1));
    z = __fmul_rn(scale, __ldg(co + 2));
  }
  const long long plane_size = (long long)H * W * C;
  float dproj[3][2];

#pragma unroll
  for (int plane = 0; plane < 3; ++plane) {
    float dix = 0.f, diy = 0.f;
    float wx = 0.f, wy = 0.f;
    if (active) {
      // Horizontal (width) and vertical (height) plane coordinates.
      const float u = plane == 2 ? z : x;
      const float v = plane == 0 ? y : (plane == 1 ? z : x);
      const float ix =
          __fadd_rn(__fmul_rn(__fadd_rn(u, 1.0f), 0.5f * W), -0.5f);
      const float iy =
          __fadd_rn(__fmul_rn(__fadd_rn(v, 1.0f), 0.5f * H), -0.5f);
      const float x0f = floorf(ix);
      const float y0f = floorf(iy);
      wx = __fsub_rn(ix, x0f);
      wy = __fsub_rn(iy, y0f);
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const bool x0ok = x0 >= 0 && x0 < W;
      const bool x1ok = x0 + 1 >= 0 && x0 + 1 < W;
      const bool y0ok = y0 >= 0 && y0 < H;
      const bool y1ok = y0 + 1 >= 0 && y0 + 1 < H;
      const bool ok00 = y0ok && x0ok, ok01 = y0ok && x1ok;
      const bool ok10 = y1ok && x0ok, ok11 = y1ok && x1ok;
      const float w00 = (1.f - wx) * (1.f - wy), w01 = wx * (1.f - wy);
      const float w10 = (1.f - wx) * wy, w11 = wx * wy;

      const long long gp = n * 3 + plane;
      const float* gv_row = g + (gp * M + m) * C;
      float* dp = want_dplanes ? d_planes + gp * plane_size : nullptr;
      const float* pl = want_coords ? planes + gp * plane_size : nullptr;
      // Offsets of the four corner rows; only valid corners are touched.
      const long long o00 = ((long long)y0 * W + x0) * C;
      const long long o01 = o00 + C;
      const long long o10 = o00 + (long long)W * C;
      const long long o11 = o10 + C;

      for (int c = lane; c < C; c += lanes) {
        const float gv = __ldg(gv_row + c);
        if (want_dplanes) {
          if (ok00) atomicAdd(dp + o00 + c, w00 * gv);
          if (ok01) atomicAdd(dp + o01 + c, w01 * gv);
          if (ok10) atomicAdd(dp + o10 + c, w10 * gv);
          if (ok11) atomicAdd(dp + o11 + c, w11 * gv);
        }
        if (want_coords) {
          const float v00 = ok00 ? __ldg(pl + o00 + c) : 0.f;
          const float v01 = ok01 ? __ldg(pl + o01 + c) : 0.f;
          const float v10 = ok10 ? __ldg(pl + o10 + c) : 0.f;
          const float v11 = ok11 ? __ldg(pl + o11 + c) : 0.f;
          dix += ((v01 - v00) * (1.f - wy) + (v11 - v10) * wy) * gv;
          diy += ((v10 - v00) * (1.f - wx) + (v11 - v01) * wx) * gv;
        }
      }
    }
    if (want_coords) {  // uniform over the grid: every lane shuffles
      dproj[plane][0] = group_sum(dix, lanes) * (0.5f * W);
      dproj[plane][1] = group_sum(diy, lanes) * (0.5f * H);
    }
  }

  if (want_coords && active && lane == 0) {
    float* dc = d_coords + p * 3;
    dc[0] = scale * (dproj[0][0] + dproj[1][0] + dproj[2][1]);
    dc[1] = scale * dproj[0][1];
    dc[2] = scale * (dproj[1][1] + dproj[2][0]);
  }
}

}  // namespace

extern "C" {

// g [N, 3, M, C], coords [N, M, 3], planes [N*3, H, W, C] or null,
// d_planes [N*3, H, W, C], d_coords [N, M, 3] or null (both null or both
// given), all fp32 and contiguous on the current device; scale =
// 2 / box_warp. With want_dplanes, zeroes d_planes and splats into it;
// without, d_planes is null and d_coords is required. Launches on
// `stream`, allocates nothing, and returns the first CUDA error (0 = ok).
int tgi_triplane_splat_f32(const float* g, const float* coords,
                           const float* planes, float* d_planes,
                           float* d_coords, int N, int H, int W, int C,
                           long long M, float scale, int want_dplanes,
                           void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || M <= 0 || N * 3 > 65535 ||
      (planes == nullptr) != (d_coords == nullptr) ||
      (want_dplanes != 0) != (d_planes != nullptr) ||
      (!want_dplanes && d_coords == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (want_dplanes) {
    const size_t bytes = (size_t)N * 3 * H * W * C * sizeof(float);
    const cudaError_t err = cudaMemsetAsync(d_planes, 0, bytes, s);
    if (err != cudaSuccess) return (int)err;
  }
  int lanes = 1;  // threads per point: next power of two >= C, at most 32
  while (lanes < C && lanes < 32) lanes *= 2;
  const long long NM = (long long)N * M;
  const long long points_per_block = kThreads / lanes;
  const long long blocks = (NM + points_per_block - 1) / points_per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  triplane_splat_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      g, coords, planes, d_planes, d_coords, H, W, C, M, NM, scale, lanes,
      want_dplanes != 0);
  return (int)cudaGetLastError();
}

const char* tgi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
