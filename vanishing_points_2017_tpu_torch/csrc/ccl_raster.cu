// Raster min-label connected components for Hopper (sm_90a).
//
// Replaces the TPU kernel vanishing_points_2017_tpu/ops/ccl_pallas.py
// (_half_pass_kernel, launched by connected_components_pallas_batch). Same
// pass semantics as the plain twin
// ops/lines_device.py::connected_components_ref: labels start as flat pixel
// indices; each half pass walks the rows in order (descending rows first,
// then ascending), injects the previous row's final labels through the
// N/NW/NE edge bits (S/SW/SE when ascending), then spreads them within the
// row by a forward and a backward segmented min scan over the W/E edge
// bits. `passes` half passes alternate descending/ascending. Eight passes
// do not always reach the CCL fixpoint, so a union-find CCL would give
// other labels exactly where they fall short: this kernel reproduces the
// passes, not the fixpoint. Input is the packed 8-direction edge bit-plane
// computed once in PyTorch (ops/lines_device.py::pack_edge_masks), so the
// kernel works on integers only and is bit-exact against its twin.
//
// What bounds it: rows are a sequential dependency, so a half pass is H
// dependent steps of (load a row, a few integer ops, 2 log2(W) scan rounds
// with block barriers, store a row). At 639 x 639 and 8 passes that is
// ~5100 row steps of ~20 barriers each per image: latency of barriers and
// of the row load, not bandwidth (the 1.6 MB label + 1.6 MB mask planes of
// an image stay in L2).
// What the design does about it: one thread block per image, one thread per
// column (W <= 1024), all 8 passes in one launch; the previous row, and the
// forward/backward scan buffers, live in shared memory, and the forward and
// backward scans share their barriers. B blocks leave most of the 132 SMs
// idle at the main path's batch; splitting an image over several blocks is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMax = 0x7fffffff;
constexpr int kMaxThreads = 1024;

// bit index per neighbour direction (dy, dx), as in the JAX package:
// (-1,-1) 0, (-1,0) 1, (-1,1) 2, (0,-1) 3, (0,1) 4, (1,-1) 5, (1,0) 6, (1,1) 7
constexpr int kW = 3, kE = 4;

__global__ void ccl_raster(const int32_t* __restrict__ packed,
                           int32_t* __restrict__ labels, int H, int W,
                           int passes) {
  __shared__ int32_t prev[kMaxThreads];
  __shared__ int32_t fv[kMaxThreads], bv[kMaxThreads];
  __shared__ uint8_t fm[kMaxThreads], bm[kMaxThreads];

  const int x = threadIdx.x;
  const bool in = x < W;
  const size_t img = (size_t)blockIdx.x * H * W;
  const int32_t* pk = packed + img;
  int32_t* lab = labels + img;

  for (int y = 0; y < H && in; ++y) lab[(size_t)y * W + x] = y * W + x;

  for (int p = 0; p < passes; ++p) {
    const bool asc = p & 1;
    const int b_up = asc ? 6 : 1, b_upl = asc ? 5 : 0, b_upr = asc ? 7 : 2;
    prev[x] = kMax;
    __syncthreads();
    for (int s = 0; s < H; ++s) {
      const int y = asc ? H - 1 - s : s;
      const size_t o = (size_t)y * W + x;
      int32_t mk = in ? pk[o] : 0;
      int32_t v = in ? lab[o] : kMax;
      if ((mk >> b_up) & 1) v = min(v, prev[x]);
      if (((mk >> b_upl) & 1) && x >= 1) v = min(v, prev[x - 1]);
      if (((mk >> b_upr) & 1) && x < W - 1) v = min(v, prev[x + 1]);
      // forward (x joins x-1) and backward (x joins x+1) segmented min
      // scans, Hillis-Steele doubling; both share each round's barriers
      int32_t f = v, bk = v;
      uint8_t fmk = (mk >> kW) & 1, bmk = (mk >> kE) & 1;
      fv[x] = f; bv[x] = bk; fm[x] = fmk; bm[x] = bmk;
      __syncthreads();
      for (int d = 1; d < W; d <<= 1) {
        int32_t fs = x >= d ? fv[x - d] : kMax;
        uint8_t fms = x >= d ? fm[x - d] : 0;
        int32_t bs = x + d < W ? bv[x + d] : kMax;
        uint8_t bms = x + d < W ? bm[x + d] : 0;
        __syncthreads();
        if (fmk) f = min(f, fs);
        fmk &= fms;
        if (bmk) bk = min(bk, bs);
        bmk &= bms;
        fv[x] = f; bv[x] = bk; fm[x] = fmk; bm[x] = bmk;
        __syncthreads();
      }
      const int32_t out = min(f, bk);
      if (in) lab[o] = out;
      prev[x] = in ? out : kMax;
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// packed (B, H, W) int32 edge bit-plane, labels (B, H, W) int32 output;
// contiguous on the launching device. Requires 1 <= W <= 1024.
int ccl_raster_launch(const int32_t* packed, int32_t* labels, int B, int H,
                      int W, int passes, void* stream) {
  if (W < 1 || W > kMaxThreads) return (int)cudaErrorInvalidValue;
  int threads = ((W + 31) / 32) * 32;
  ccl_raster<<<B, threads, 0, (cudaStream_t)stream>>>(packed, labels, H, W,
                                                     passes);
  return (int)cudaGetLastError();
}

}  // extern "C"
