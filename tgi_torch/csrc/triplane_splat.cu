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
// Per point and plane the kernel scales the point by 2/box_warp,
// projects it ((x,y), (x,z), (z,x)), unnormalises (align_corners=False)
// and floors exactly as triplane_gather.cu does, so both kernels pick
// the same corners, and adds w_k * g into each of the four corners that
// lie on the plane, w = ((1-wx)(1-wy), wx(1-wy), (1-wx)wy, wx wy), each
// product rounded as the plain version rounds it. Where d_coords is
// asked for, it also reads the four corners from the planes and forms
//   dix = sum_c ((v01-v00)(1-wy) + (v11-v10)wy) g,
//   diy = sum_c ((v10-v00)(1-wx) + (v11-v01)wx) g,
// scaled by W/2 and H/2 and folded into the world axes:
//   dx = s (d0.x + d1.x + d2.y), dy = s d0.y, dz = s (d1.y + d2.x).
//
// Mapping. A group of C/4 lanes (a power of two, at most 32; 8 at
// C = 32) owns a run of kRun consecutive points, and each lane owns a
// float4 of channels (a loop covers C > 128). The points come in the
// renderer's order, ray-major, so a run is kRun samples of one ray. For
// each plane the group keeps the four corner sums of the cell its last
// point fell in, in registers, adds each point whose cell (x0, y0) is
// the same, and flushes the sums with one float4 atomicAdd per corner on
// the plane (atom.global.add.v4.f32, compute capability 9.x) when the
// cell changes and at the end of the run. The float4s make 4 times
// fewer atomics than one per channel; the sums cut them again where a
// ray's samples share a cell, as on the plane that faces a frontal
// camera, where a warp's groups would otherwise reduce into the same
// addresses at once. The feature gradient g is read once, with
// streaming loads (ld.global.cs), so that it does not evict d_planes
// from the L2. d_coords is summed over the group's lanes with a shuffle
// (3 steps at C = 32) and written by lane 0: one group owns the point,
// so it needs no atomics. C % 4 != 0, or a g, planes or d_planes
// pointer that is not 16-byte aligned, takes the same kernel with one
// float per lane (the scalar path, chosen here from C and the
// pointers). The grid covers the runs, one per group.
//
// The order of the fp32 adds into d_planes changes with the runs and
// from run to run (atomics), so d_planes is not bitwise deterministic;
// it agrees with the plain version to rounding.
//
// With want_dplanes = 0 the kernel skips the memset and the atomics and
// writes d_coords alone: the point gradient of the TGI_SPLAT=mxu route,
// whose d_planes comes from triplane_splat_sorted.cu (tgi too computes
// d_coords apart from its mxu splat, tgi/ops/grid_sample.py:253-260).
//
// Layouts: g [N, 3, M, C] fp32; coords [N, M, 3] fp32; planes
// [N*3, H, W, C] fp32 (channels last; read only for d_coords);
// d_planes [N*3, H, W, C] fp32, zeroed here with cudaMemsetAsync on the
// same stream (null with want_dplanes = 0); d_coords [N, M, 3] fp32 or
// null.
//
// What bounds it. At the full-width render (N = 1, M = 128*128*48 =
// 786,432, C = 32, 3 planes of 256x256) one pass reads g (302 MB) and
// coords (9.4 MB) and writes d_planes (25 MB): 336 MB, 0.1005 ms at
// 3.35 TB/s. With d_coords it also reads the planes (25 MB) and writes
// d_coords (9.4 MB): 371 MB, 0.111 ms. On an H100 80GB HBM3 at 700 W it
// takes 0.41-0.42 ms per pass on a full-width render's points, 24 % of
// that bound (0.12-0.13 x grid_sampler_2d_backward), and 0.52 ms with
// d_coords, 21 % (tgi_torch/scripts/triplane_variants.py). What holds it
// there, by the times of its variants, is the L2's reductions into the
// 25 MB target: up to 4 * 3 * 8 = 96 float4 atomics per point at
// C = 32; the same mapping with four scalar atomics per float4 takes
// 1.45-1.71 ms. The runs' sums make it 6-7 % faster on a frontal
// render and 49 % on the splat bench's points, where half of a ray's
// consecutive samples share a cell on the (x, y) plane, and cost
// nothing at yaw +0.35 without d_coords, 3 % with them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;  // consecutive points per group

// What one lane moves of a row: four channels, or one.
template <int VEC> struct Lane;
template <> struct Lane<4> { using T = float4; };
template <> struct Lane<1> { using T = float; };

template <class T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// acc + w * g, the product rounded on its own as the plain version's.
__device__ __forceinline__ float add_scaled(float acc, float w, float g) {
  return __fadd_rn(acc, __fmul_rn(w, g));
}
__device__ __forceinline__ float4 add_scaled(float4 acc, float w, float4 g) {
  return make_float4(add_scaled(acc.x, w, g.x), add_scaled(acc.y, w, g.y),
                     add_scaled(acc.z, w, g.z), add_scaled(acc.w, w, g.w));
}

// sum_c ((b - a) * s + (d - c) * t) * g over one lane's channels.
__device__ __forceinline__ float corner_dot(float a, float b, float c,
                                            float d, float s, float t,
                                            float g) {
  return ((b - a) * s + (d - c) * t) * g;
}
__device__ __forceinline__ float corner_dot(float4 a, float4 b, float4 c,
                                            float4 d, float s, float t,
                                            float4 g) {
  return corner_dot(a.x, b.x, c.x, d.x, s, t, g.x) +
         corner_dot(a.y, b.y, c.y, d.y, s, t, g.y) +
         corner_dot(a.z, b.z, c.z, d.z, s, t, g.z) +
         corner_dot(a.w, b.w, c.w, d.w, s, t, g.w);
}

// One point's footprint on one plane.
struct Footprint {
  int x0, y0;
  float wx, wy;
};

__device__ __forceinline__ Footprint footprint(int plane, float x, float y,
                                               float z, int H, int W) {
  // Horizontal (width) and vertical (height) plane coordinates.
  const float u = plane == 2 ? z : x;
  const float v = plane == 0 ? y : (plane == 1 ? z : x);
  const float ix = __fadd_rn(__fmul_rn(__fadd_rn(u, 1.0f), 0.5f * W), -0.5f);
  const float iy = __fadd_rn(__fmul_rn(__fadd_rn(v, 1.0f), 0.5f * H), -0.5f);
  const float x0f = floorf(ix);
  const float y0f = floorf(iy);
  Footprint f;
  f.x0 = (int)x0f;
  f.y0 = (int)y0f;
  f.wx = __fsub_rn(ix, x0f);
  f.wy = __fsub_rn(iy, y0f);
  return f;
}

// Which of a cell's four corners lie on the plane: bits 00, 01, 10, 11.
__device__ __forceinline__ int corners_on(int x0, int y0, int H, int W) {
  const bool x0ok = x0 >= 0 && x0 < W;
  const bool x1ok = x0 + 1 >= 0 && x0 + 1 < W;
  const bool y0ok = y0 >= 0 && y0 < H;
  const bool y1ok = y0 + 1 >= 0 && y0 + 1 < H;
  return (y0ok && x0ok) | (y0ok && x1ok) << 1 | (y1ok && x0ok) << 2 |
         (y1ok && x1ok) << 3;
}

// The cell whose four corner sums a group holds for one plane; n < 0:
// none yet.
struct Cell {
  int x0, y0, n;
};

// Adds a cell's corner sums into its plane: one atomicAdd per corner
// that lies on the plane.
template <class T>
__device__ __forceinline__ void flush(T* plane, Cell c, int H, int W,
                                      int CV, const T (&acc)[4]) {
  const int on = corners_on(c.x0, c.y0, H, W);
  const long long o = ((long long)c.y0 * W + c.x0) * CV;
  if (on & 1) atomicAdd(plane + o, acc[0]);
  if (on & 2) atomicAdd(plane + o + CV, acc[1]);
  if (on & 4) atomicAdd(plane + o + (long long)W * CV, acc[2]);
  if (on & 8) atomicAdd(plane + o + (long long)(W + 1) * CV, acc[3]);
}

// Sum over the `lanes` lanes of a group: consecutive threads, aligned
// within the warp, so xor offsets below `lanes` stay inside the group.
__device__ __forceinline__ float group_sum(float v, int lanes,
                                           unsigned mask) {
  for (int off = lanes / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

template <int VEC, bool DPLANES, bool DCOORDS>
__global__ void __launch_bounds__(kThreads)
    triplane_splat_kernel(const float* __restrict__ g,
                          const float* __restrict__ coords,
                          const float* __restrict__ planes,
                          float* __restrict__ d_planes,
                          float* __restrict__ d_coords, int H, int W, int C,
                          long long M, long long NM, float scale,
                          int lanes) {
  using T = typename Lane<VEC>::T;
  const T* G = reinterpret_cast<const T*>(g);
  const T* P = reinterpret_cast<const T*>(planes);
  T* D = reinterpret_cast<T*>(d_planes);
  const int CV = C / VEC;  // lane-sized pieces of a row
  const int lane = threadIdx.x & (lanes - 1);
  // The group's lanes, for its shuffles: groups of one warp run apart.
  const unsigned mask =
      lanes == 32 ? 0xffffffffu
                  : ((1u << lanes) - 1u) << ((threadIdx.x & 31) & ~(lanes - 1));
  const long long plane_size = (long long)H * W * CV;
  const long long runs = (NM + kRun - 1) / kRun;
  const float hw = 0.5f * W, hh = 0.5f * H;
  const long long r =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / lanes;
  if (r >= runs) return;  // the whole group: r is the group's
  const long long p_end = (r + 1) * kRun < NM ? (r + 1) * kRun : NM;
  // Pieces of the row, `lanes` at a time: the trip count is the
  // group's, so every lane joins the shuffles; `has` masks the rest.
  for (int j0 = 0; j0 < CV; j0 += lanes) {
    const int j = j0 + lane;
    const bool has = j < CV;
    Cell open[3];
    T acc[3][4];
#pragma unroll
    for (int k = 0; k < 3; ++k) open[k] = Cell{0, 0, -1};
    for (long long p = r * kRun; p < p_end; ++p) {
      const int n = (int)(p / M);
      const long long m = p - (long long)n * M;
      const float* co = coords + p * 3;
      const float x = __fmul_rn(scale, __ldg(co + 0));
      const float y = __fmul_rn(scale, __ldg(co + 1));
      const float z = __fmul_rn(scale, __ldg(co + 2));
      float dx = 0.f, dy = 0.f, dz = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const Footprint f = footprint(k, x, y, z, H, W);
        const long long gp = (long long)n * 3 + k;
        const T gv = has ? __ldcs(G + (gp * M + m) * CV + j) : zero<T>();
        const float ux = __fsub_rn(1.f, f.wx), uy = __fsub_rn(1.f, f.wy);
        if (DPLANES) {
          if (f.x0 != open[k].x0 || f.y0 != open[k].y0 || n != open[k].n) {
            if (open[k].n >= 0 && has)
              flush(D + (long long)(open[k].n * 3 + k) * plane_size + j,
                    open[k], H, W, CV, acc[k]);
            open[k] = Cell{f.x0, f.y0, n};
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[k][c] = zero<T>();
          }
          acc[k][0] = add_scaled(acc[k][0], __fmul_rn(ux, uy), gv);
          acc[k][1] = add_scaled(acc[k][1], __fmul_rn(f.wx, uy), gv);
          acc[k][2] = add_scaled(acc[k][2], __fmul_rn(ux, f.wy), gv);
          acc[k][3] = add_scaled(acc[k][3], __fmul_rn(f.wx, f.wy), gv);
        }
        if (DCOORDS && has) {
          const int on = corners_on(f.x0, f.y0, H, W);
          const T* b = P + gp * plane_size + j;
          const long long o = ((long long)f.y0 * W + f.x0) * CV;
          const long long o10 = o + (long long)W * CV;
          const T v00 = (on & 1) ? __ldg(b + o) : zero<T>();
          const T v01 = (on & 2) ? __ldg(b + o + CV) : zero<T>();
          const T v10 = (on & 4) ? __ldg(b + o10) : zero<T>();
          const T v11 = (on & 8) ? __ldg(b + o10 + CV) : zero<T>();
          const float dix = corner_dot(v00, v01, v10, v11, uy, f.wy, gv) * hw;
          const float diy = corner_dot(v00, v10, v01, v11, ux, f.wx, gv) * hh;
          // Planes project (x, y), (x, z), (z, x).
          if (k == 0) { dx += dix; dy += diy; }
          if (k == 1) { dx += dix; dz += diy; }
          if (k == 2) { dz += dix; dx += diy; }
        }
      }
      if (DCOORDS) {
        dx = group_sum(dx, lanes, mask);
        dy = group_sum(dy, lanes, mask);
        dz = group_sum(dz, lanes, mask);
        if (lane == 0) {
          float* dc = d_coords + p * 3;
          if (j0 == 0) {
            dc[0] = scale * dx;
            dc[1] = scale * dy;
            dc[2] = scale * dz;
          } else {  // a later piece of a row longer than the group
            dc[0] += scale * dx;
            dc[1] += scale * dy;
            dc[2] += scale * dz;
          }
        }
      }
    }
    if (DPLANES && has) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (open[k].n >= 0)
          flush(D + (long long)(open[k].n * 3 + k) * plane_size + j,
                open[k], H, W, CV, acc[k]);
    }
  }
}

template <int VEC, bool DPLANES, bool DCOORDS>
int launch(const float* g, const float* coords, const float* planes,
           float* d_planes, float* d_coords, int N, int H, int W, int C,
           long long M, float scale, cudaStream_t stream) {
  const int CV = C / VEC;
  int lanes = 1;  // threads per run: next power of two >= CV, at most 32
  while (lanes < CV && lanes < 32) lanes *= 2;
  const long long NM = (long long)N * M;
  const long long per_block = kThreads / lanes;
  const long long runs = (NM + kRun - 1) / kRun;
  const long long blocks = (runs + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const auto kernel = triplane_splat_kernel<VEC, DPLANES, DCOORDS>;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      g, coords, planes, d_planes, d_coords, H, W, C, M, NM, scale, lanes);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_for(const float* g, const float* coords, const float* planes,
               float* d_planes, float* d_coords, int N, int H, int W, int C,
               long long M, float scale, cudaStream_t s) {
  if (d_planes == nullptr)
    return launch<VEC, false, true>(g, coords, planes, d_planes, d_coords, N,
                                    H, W, C, M, scale, s);
  if (d_coords == nullptr)
    return launch<VEC, true, false>(g, coords, planes, d_planes, d_coords, N,
                                    H, W, C, M, scale, s);
  return launch<VEC, true, true>(g, coords, planes, d_planes, d_coords, N, H,
                                 W, C, M, scale, s);
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
  const bool vec = C % 4 == 0 &&
                   (uintptr_t)g % 16 == 0 && (uintptr_t)planes % 16 == 0 &&
                   (uintptr_t)d_planes % 16 == 0;
  return vec ? launch_for<4>(g, coords, planes, d_planes, d_coords, N, H, W,
                             C, M, scale, s)
             : launch_for<1>(g, coords, planes, d_planes, d_coords, N, H, W,
                             C, M, scale, s);
}

const char* tgi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
