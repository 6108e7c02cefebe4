// Sorted tri-plane splat: the backward of the EG3D render's feature
// sampling as a segmented reduction, with no atomics, for Hopper
// (sm_90a). Its d_planes is bitwise the same from run to run.
//
// Replaces tgi/ops/pallas/splat_mxu.py::plane_splat_mxu
// (_plane_splat_mxu_impl :117, kernel body _make_kernel :45), the route
// tgi takes with TGI_SPLAT=mxu (tgi/ops/grid_sample.py:262,292-299). Both
// compute d_planes[plane, cell, c] = sum over the (point, corner) pairs
// that land on cell of w_corner(point) * g[plane, point, c]. The TPU
// kernel sorts one entry per (point, corner), packs 128/C cells per
// 128-lane row and sums each 512-entry block of sorted entries into
// 64-row windows of a VMEM accumulator with one-hot MXU matmuls, because
// the TPU has no fast scatter. None of that survives: on Hopper the
// points sorted by the cell they fall in form segments, and one warp per
// output cell sums the four segments that reach it in registers.
//
// Three kernels, and a sort between the first two:
//   1. splat_keys_kernel gives each (plane, point) one int32 key: the
//      point's floor cell (y0, x0), found with the round-to-nearest index
//      arithmetic of triplane_gather.cu (scale by 2/box_warp, project
//      (x,y), (x,z), (z,x), unnormalise with align_corners=False, floor),
//      numbered on the (H+1) x (W+1) grid of floor cells from -1:
//      key = gp * K + (y0 + 1) * (W + 1) + (x0 + 1), K = (H+1)(W+1) + 1,
//      gp = n * 3 + plane. A point whose floor cell lies off that grid
//      (no corner on the plane) gets its plane's sentinel gp * K + K - 1,
//      which sorts after the plane's cells.
//   2. The wrapper sorts the N * 3 * M keys at once with
//      torch.sort(stable=True): the counterpart of the XLA argsort that
//      tgi runs before its Pallas kernel (splat_mxu.py:146-150), the prep,
//      not the kernel. Its int64 indices are the flat (gp * M + m).
//   3. splat_offsets_kernel, one thread per sorted position i (and one
//      past the end): writes offsets[j] = i for every key j in
//      (key[i-1], key[i]], so offsets [N*3, K] holds each floor cell's
//      first position in the sorted order and each plane's sentinel run
//      its start; and writes the point's 16-byte record (int32 flat index,
//      wx, wy, 0), with wx and wy recomputed from its coords, so that the
//      segment kernel reads one coalesced record per entry and no coords.
//   4. splat_segments_kernel: one warp per output cell (y, x). The cell
//      takes corner 00 from floor cell (y, x), corner 01 from (y, x-1),
//      corner 10 from (y-1, x) and corner 11 from (y-1, x-1): two ranges
//      of consecutive keys, one per floor row, so two contiguous runs of
//      records. A group of C/4 lanes (8 at C = 32, so 4 groups a warp)
//      owns a float4 of channels per lane. The warp loads 32 records at
//      once, one per lane, each lane forming its entry's corner weight
//      (the arithmetic of triplane_splat.cu: w00 = (1-wx)(1-wy),
//      w01 = wx(1-wy), w10 = (1-wx)wy, w11 = wx wy); then each group takes
//      every 4th entry, broadcast by shuffle, and issues kUnroll row loads
//      of g before it adds them, each product and sum rounded to nearest.
//      The four groups' sums meet in a fixed xor-shuffle tree and the
//      first group writes the cell's row once: no atomics and no memset.
// Which entries a group sums, in which order, and the tree are fixed by
// the positions alone, so two runs give the same bits; the plain version
// sums in another fixed order and agrees to rounding. C % 4 != 0, or g or
// d_planes not 16-byte aligned, takes the same kernel with one float per
// lane (the scalar path, chosen here); rows longer than 32 lanes take
// pieces in turn.
//
// Layouts: coords [N, M, 3] fp32; keys [N*3*M] int32; order [N*3*M] int64
// (torch.sort's indices); offsets [N*3, K] int32; records [N*3*M] int4;
// g [N, 3, M, C] fp32; d_planes [N*3, H, W, C] fp32 (channels last).
//
// What bounds it. At the full-width render (N = 1, M = 786,432, C = 32,
// 3 planes of 256x256) the function reads g (302 MB) and coords (9.4 MB)
// and writes d_planes (25 MB): 336 MB, 0.1005 ms at 3.35 TB/s. This
// design adds its keys (9.4 MB written and read), indices (18.9 MB),
// records (37.7 MB written, read ~4 times from the L2) and offsets
// (0.8 MB): ~470 MB, 0.14 ms. Each g row is read by the four cells that
// its point's corners land on; sorted by cell, those reads come from
// neighbouring warps and mostly hit the 50 MB L2. On an H100 80GB HBM3
// at 700 W (tgi_torch/scripts/triplane_variants.py) the whole takes
// 0.49-0.50 ms per pass, 20 % of the bound, against the earlier design's
// 1.30-1.36 (one entry per point and corner, a segment walk that re-read
// the coords per entry): the prep 0.24-0.25 ms, most of it the sort, and
// the segment kernel 0.23-0.25, about what the L2 needs to serve the
// four reads of every g row (1.2 GB). Four row loads in flight per lane
// beat eight by 15 % there (fewer registers, more warps) and tie with
// two. Where points pile into a few cells by the thousand, as the splat
// bench's clipped points do, one warp walks each long segment alone and
// the segment kernel takes ~1.2 ms at M = 196,608.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // g rows a lane has in flight
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float shfl_xor(float v, int off) {
  return __shfl_xor_sync(kFull, v, off);
}
__device__ __forceinline__ float4 shfl_xor(float4 v, int off) {
  return make_float4(shfl_xor(v.x, off), shfl_xor(v.y, off),
                     shfl_xor(v.z, off), shfl_xor(v.w, off));
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// One point's floor cell (floats) and fractions on one plane: the
// gather's index arithmetic.
struct Footprint {
  float x0f, y0f, wx, wy;
};

__device__ __forceinline__ Footprint footprint(const float* __restrict__ co,
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
  Footprint f;
  f.x0f = floorf(ix);
  f.y0f = floorf(iy);
  f.wx = __fsub_rn(ix, f.x0f);
  f.wy = __fsub_rn(iy, f.y0f);
  return f;
}

__global__ void __launch_bounds__(kThreads)
    splat_keys_kernel(const float* __restrict__ coords,
                      int* __restrict__ keys, int H, int W, long long M,
                      float scale) {
  const int gp = blockIdx.y;  // n * 3 + plane
  const int n = gp / 3;
  const long long m = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const Footprint f = footprint(coords + ((long long)n * M + m) * 3,
                                gp - 3 * n, H, W, scale);
  const int cells = (H + 1) * (W + 1);
  // Compared as floats, so a far or NaN point never reaches a conversion.
  const bool on = f.x0f >= -1.f && f.x0f <= (float)(W - 1) &&
                  f.y0f >= -1.f && f.y0f <= (float)(H - 1);
  const int local =
      on ? ((int)f.y0f + 1) * (W + 1) + ((int)f.x0f + 1) : cells;
  keys[(long long)gp * M + m] = gp * (cells + 1) + local;
}

__global__ void __launch_bounds__(kThreads)
    splat_offsets_kernel(const int* __restrict__ sorted_keys,
                         const long long* __restrict__ order,
                         const float* __restrict__ coords,
                         int* __restrict__ offsets,
                         int4* __restrict__ records,
                         int H, int W, long long M, long long T, int nkeys,
                         float scale) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i > T) return;
  // Every key j in (key[i-1], key[i]] starts at i; past the end, T.
  const int lo = i == 0 ? 0 : __ldg(sorted_keys + i - 1) + 1;
  const int hi = i == T ? nkeys - 1 : __ldg(sorted_keys + i);
  for (int j = lo; j <= hi; ++j) offsets[j] = (int)i;
  if (i == T) return;
  const long long p = __ldg(order + i);  // gp * M + m
  const long long gp = p / M;
  const long long n = gp / 3;
  const Footprint f = footprint(coords + (n * M + (p - gp * M)) * 3,
                                (int)(gp - 3 * n), H, W, scale);
  records[i] = make_int4((int)p, __float_as_int(f.wx), __float_as_int(f.wy),
                         0);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    splat_segments_kernel(const float* __restrict__ g,
                          const int4* __restrict__ records,
                          const int* __restrict__ offsets,
                          float* __restrict__ d_planes, int H, int W, int C,
                          int lanes) {
  using T = typename Lane<VEC>::T;
  const T* G = reinterpret_cast<const T*>(g);
  T* D = reinterpret_cast<T*>(d_planes);
  const int CV = C / VEC;  // lane-sized pieces of a row
  const int groups = 32 / lanes;
  const int wl = threadIdx.x & 31;
  const int q = wl / lanes;  // this lane's group
  const int lane = wl & (lanes - 1);
  const int gp = blockIdx.y;
  const long long HW = (long long)H * W;
  const long long cell = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (cell >= HW) return;  // whole warps leave together
  const int y = (int)(cell / W);
  const int x = (int)(cell - (long long)y * W);
  const int* off = offsets + (long long)gp * ((H + 1) * (W + 1) + 1);
  // Floor row y: cells (y, x-1) [corner 01] and (y, x) [corner 00]; floor
  // row y-1: (y-1, x-1) [corner 11] and (y-1, x) [corner 10]. On the
  // grid from -1, floor cell (fy, fx) is (fy + 1) * (W + 1) + fx + 1.
  const int ka = (y + 1) * (W + 1) + x;
  const int kb = y * (W + 1) + x;
  const int a0 = __ldg(off + ka), a1 = __ldg(off + ka + 1);
  const int a2 = __ldg(off + ka + 2);
  const int b0 = __ldg(off + kb), b1 = __ldg(off + kb + 1);
  const int b2 = __ldg(off + kb + 2);
  const int la = a2 - a0;
  const int n = la + (b2 - b0);
  const int step = kUnroll * groups;
  // Pieces of the row, `lanes` at a time: the trip counts are the warp's,
  // so every lane joins the shuffles; `has` masks the rest.
  for (int j0 = 0; j0 < CV; j0 += lanes) {
    const int j = j0 + lane;
    const bool has = j < CV;
    T acc = zero<T>();
    for (int base = 0; base < n; base += 32) {
      // This lane's entry of the chunk: its record and corner weight.
      const int e = base + wl;
      int idx = 0;
      float w = 0.f;
      if (e < n) {
        const bool upper = e < la;  // floor row y: corners 00, 01
        const int pos = upper ? a0 + e : b0 + (e - la);
        const int4 r = __ldg(records + pos);
        const float wx = __int_as_float(r.y), wy = __int_as_float(r.z);
        const bool right = pos < (upper ? a1 : b1);  // from column x-1
        const float ax = right ? wx : __fsub_rn(1.f, wx);
        const float ay = upper ? __fsub_rn(1.f, wy) : wy;
        w = __fmul_rn(ax, ay);
        idx = r.x;
      }
      const int cnt = min(32, n - base);
      for (int e0 = 0; e0 < cnt; e0 += step) {
        T gv[kUnroll];
        float wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int src = e0 + u * groups + q;
          const int id = __shfl_sync(kFull, idx, src & 31);
          wv[u] = __shfl_sync(kFull, w, src & 31);
          gv[u] = (has && src < cnt) ? __ldg(G + (long long)id * CV + j)
                                     : zero<T>();
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (e0 + u * groups + q < cnt) acc = add_scaled(acc, wv[u], gv[u]);
      }
    }
    // The groups' sums, in a fixed tree.
    for (int o = lanes; o < 32; o <<= 1) acc = add(acc, shfl_xor(acc, o));
    if (q == 0 && has) D[((long long)gp * HW + cell) * CV + j] = acc;
  }
}

template <int VEC>
int launch_segments(const float* g, const int4* records, const int* offsets,
                    float* d_planes, int N, int H, int W, int C,
                    cudaStream_t stream) {
  const int CV = C / VEC;
  int lanes = 1;  // threads per row piece: next power of two >= CV, <= 32
  while (lanes < CV && lanes < 32) lanes *= 2;
  const long long blocks = ((long long)H * W + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)(N * 3));
  splat_segments_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      g, records, offsets, d_planes, H, W, C, lanes);
  return (int)cudaGetLastError();
}

bool bad_shape(int N, int H, int W, long long M) {
  // Keys, flat indices and positions are int32.
  const long long keys = 3LL * N * ((long long)(H + 1) * (W + 1) + 1);
  return N <= 0 || H <= 0 || W <= 0 || M <= 0 || N * 3 > 65535 ||
         keys >= 2147483647LL || 3LL * N * M >= 2147483647LL;
}

}  // namespace

extern "C" {

// coords [N, M, 3] fp32 -> keys [N*3*M] int32, the floor-cell key of each
// (plane, point), its plane's sentinel where no corner is on the plane;
// scale = 2 / box_warp. Launches on `stream`, allocates nothing, and
// returns the first CUDA error (0 = ok).
int tgi_splat_keys_f32(const float* coords, int* keys, int N, int H, int W,
                       long long M, float scale, void* stream) {
  if (bad_shape(N, H, W, M)) return (int)cudaErrorInvalidValue;
  const long long blocks = (M + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)(N * 3));
  splat_keys_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      coords, keys, H, W, M, scale);
  return (int)cudaGetLastError();
}

// sorted_keys [N*3*M] int32 and order [N*3*M] int64 (torch.sort's values
// and indices), coords [N, M, 3] -> offsets [N*3, (H+1)(W+1) + 1] int32,
// every element written, and records [N*3*M] of 16 bytes (int32 flat
// index, fp32 wx, fp32 wy, 0). Launches on `stream`, allocates nothing,
// and returns the first CUDA error (0 = ok).
int tgi_splat_offsets_f32(const int* sorted_keys, const long long* order,
                          const float* coords, int* offsets, void* records,
                          int N, int H, int W, long long M, float scale,
                          void* stream) {
  if (bad_shape(N, H, W, M) || (uintptr_t)records % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long T = 3LL * N * M;
  const int nkeys = 3 * N * ((H + 1) * (W + 1) + 1);
  const long long blocks = (T + 1 + kThreads - 1) / kThreads;
  splat_offsets_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      sorted_keys, order, coords, offsets, (int4*)records, H, W, M, T, nkeys,
      scale);
  return (int)cudaGetLastError();
}

// g [N, 3, M, C] fp32, records and offsets from tgi_splat_offsets_f32 ->
// d_planes [N*3, H, W, C] fp32, every element written. All contiguous on
// the current device. Launches on `stream`, allocates nothing, and
// returns the first CUDA error (0 = ok).
int tgi_splat_segments_f32(const float* g, const void* records,
                           const int* offsets, float* d_planes, int N, int H,
                           int W, int C, long long M, void* stream) {
  if (bad_shape(N, H, W, M) || C <= 0 || (uintptr_t)records % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int4* rec = (const int4*)records;
  const bool vec = C % 4 == 0 && (uintptr_t)g % 16 == 0 &&
                   (uintptr_t)d_planes % 16 == 0;
  return vec ? launch_segments<4>(g, rec, offsets, d_planes, N, H, W, C, s)
             : launch_segments<1>(g, rec, offsets, d_planes, N, H, W, C, s);
}

const char* tgi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
