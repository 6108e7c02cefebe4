// Tri-plane bilinear gather: the forward of the EG3D render's feature
// sampling, for Hopper (sm_90a).
//
// Replaces tgi/ops/pallas/gather_vmem.py::gather_rows_vmem (the TPU
// kernel) together with its caller's epilogue, tgi/ops/grid_sample.py:
// 192-213 (un-remap of the border slots, zero padding, fp32 lerp). The
// TPU design (a footprint-expanded [H*W, 4C] plane held in VMEM, one
// 128-lane row read per point, a slot remap at the borders) exists
// because the TPU has no fast dynamic gather; none of it survives. Per
// (point, plane) the kernel scales the world point by 2/box_warp,
// projects it onto the plane ((x,y), (x,z), (z,x)), unnormalises
// (align_corners=False), floors, loads the four corner rows of C floats
// with zero padding, and lerps in the reference order
//   top = v00 + (v01 - v00) * wx; bot = v10 + (v11 - v10) * wx;
//   out = top + (bot - top) * wy.
// The arithmetic uses round-to-nearest intrinsics so that nvcc does not
// contract it into FMAs: the result matches the plain PyTorch version to
// the last bit.
//
// Layouts: planes [N*3, H, W, C] fp32 (channels last; the wrapper makes
// them with one permute per render), coords [N, M, 3] fp32, out
// [N, 3, M, C] fp32.
//
// Mapping. A group of C/4 lanes (a power of two, at most 32; 8 at
// C = 32, so 4 points per warp) owns one point, and each lane owns a
// float4 of channels (a loop covers C > 128). The group reads the
// point's coords once, projects it onto all three planes, issues its 12
// float4 corner loads, then writes its three float4 outputs with
// streaming stores (st.global.cs), which keep the 302 MB output stream
// from evicting the 25 MB of planes that the corner loads re-read from
// the L2 (2-8 % faster than plain stores). The grid is one wave of
// resident blocks (as many as the card holds at once), and each group
// walks the points with a grid-stride loop. C % 4 != 0, or a planes or
// out pointer that is not 16-byte aligned, takes the same kernel with
// one float per lane (the scalar path, chosen here from C and the
// pointers).
//
// What bounds it. Its bound is device-memory bytes: at the full-width
// render (N = 1, M = 128*128*48 = 786,432, C = 32, 256x256 planes) one
// pass writes 3 * 786,432 * 32 * 4 B = 302 MB and reads 9.4 MB of coords
// and 25 MB of planes, about 336 MB, or 0.1005 ms at 3.35 TB/s. On an
// H100 80GB HBM3 at 700 W it takes 0.206-0.220 ms per pass, 46-49 % of
// that bound, on a full-width render's points: 0.36 x F.grid_sample on
// the same inputs at yaw +0.35, 0.46-0.48 x on a frontal render
// (tgi_torch/scripts/triplane_variants.py). What holds it there, by the
// times of its variants, is the corner loads: 12 rows of 128 B per
// point, 1.21 GB per pass through L1 and L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// What one lane moves of a row: four channels, or one.
template <int VEC> struct Lane;
template <> struct Lane<4> { using T = float4; };
template <> struct Lane<1> { using T = float; };

__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), w));
}
__device__ __forceinline__ float4 lerp_rn(float4 a, float4 b, float w) {
  return make_float4(lerp_rn(a.x, b.x, w), lerp_rn(a.y, b.y, w),
                     lerp_rn(a.z, b.z, w), lerp_rn(a.w, b.w, w));
}
template <class T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// One point's footprint on one plane.
struct Footprint {
  long long o00;  // cell of corner (y0, x0) in its plane, y0 * W + x0
  float wx, wy;
  bool ok00, ok01, ok10, ok11;  // which corners lie on the plane
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
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const bool x0ok = x0 >= 0 && x0 < W;
  const bool x1ok = x0 + 1 >= 0 && x0 + 1 < W;
  const bool y0ok = y0 >= 0 && y0 < H;
  const bool y1ok = y0 + 1 >= 0 && y0 + 1 < H;
  Footprint f;
  f.o00 = (long long)y0 * W + x0;
  f.wx = __fsub_rn(ix, x0f);
  f.wy = __fsub_rn(iy, y0f);
  f.ok00 = y0ok && x0ok;
  f.ok01 = y0ok && x1ok;
  f.ok10 = y1ok && x0ok;
  f.ok11 = y1ok && x1ok;
  return f;
}

// A group of `lanes` lanes per point, all three planes.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    triplane_gather_kernel(const float* __restrict__ planes,
                           const float* __restrict__ coords,
                           float* __restrict__ out, int H, int W, int C,
                           long long M, long long NM, float scale,
                           int lanes) {
  using T = typename Lane<VEC>::T;
  const T* P = reinterpret_cast<const T*>(planes);
  T* O = reinterpret_cast<T*>(out);
  const int CV = C / VEC;  // lane-sized pieces of a row
  const int lane = threadIdx.x & (lanes - 1);
  const long long plane_rows = (long long)H * W;
  const long long groups = (long long)gridDim.x * (kThreads / lanes);
  for (long long p =
           ((long long)blockIdx.x * kThreads + threadIdx.x) / lanes;
       p < NM; p += groups) {
    const long long n = p / M;
    const long long m = p - n * M;
    const float* co = coords + p * 3;
    const float x = __fmul_rn(scale, __ldg(co + 0));
    const float y = __fmul_rn(scale, __ldg(co + 1));
    const float z = __fmul_rn(scale, __ldg(co + 2));
    Footprint f[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) f[k] = footprint(k, x, y, z, H, W);
    for (int j = lane; j < CV; j += lanes) {
      T v[3][4];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const T* b = P + (n * 3 + k) * plane_rows * CV + j;
        const long long o = f[k].o00;
        v[k][0] = f[k].ok00 ? __ldg(b + o * CV) : zero<T>();
        v[k][1] = f[k].ok01 ? __ldg(b + (o + 1) * CV) : zero<T>();
        v[k][2] = f[k].ok10 ? __ldg(b + (o + W) * CV) : zero<T>();
        v[k][3] = f[k].ok11 ? __ldg(b + (o + W + 1) * CV) : zero<T>();
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const T top = lerp_rn(v[k][0], v[k][1], f[k].wx);
        const T bot = lerp_rn(v[k][2], v[k][3], f[k].wx);
        __stcs(O + ((n * 3 + k) * M + m) * CV + j, lerp_rn(top, bot, f[k].wy));
      }
    }
  }
}

// Blocks of `kernel` that fit on the card at once.
template <class K>
cudaError_t resident_blocks(K kernel, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  *blocks = (long long)sms * per_sm;
  return err;
}

template <int VEC>
int launch(const float* planes, const float* coords, float* out, int N,
           int H, int W, int C, long long M, float scale,
           cudaStream_t stream) {
  const auto kernel = triplane_gather_kernel<VEC>;
  const int CV = C / VEC;
  int lanes = 1;  // threads per point: next power of two >= CV, at most 32
  while (lanes < CV && lanes < 32) lanes *= 2;
  const long long NM = (long long)N * M;
  const long long per_block = kThreads / lanes;
  long long blocks = (NM + per_block - 1) / per_block;
  static long long resident = 0;  // per instantiation, found once
  if (resident == 0) {
    const cudaError_t err = resident_blocks(kernel, &resident);
    if (err != cudaSuccess) return (int)err;
  }
  if (blocks > resident) blocks = resident;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      planes, coords, out, H, W, C, M, NM, scale, lanes);
  return (int)cudaGetLastError();
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
  const bool vec = C % 4 == 0 &&
                   ((uintptr_t)planes % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  const cudaStream_t s = (cudaStream_t)stream;
  return vec ? launch<4>(planes, coords, out, N, H, W, C, M, scale, s)
             : launch<1>(planes, coords, out, N, H, W, C, M, scale, s);
}

const char* tgi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
