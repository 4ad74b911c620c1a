// Inverse-gnomonic sphere renderer for Hopper (sm_90a).
//
// Replaces the TPU kernel vanishing_points_2017_tpu/ops/sphere_pallas.py
// (_render_kernel, launched by sphere_render_pallas). Same function as the
// plain twin ops/sphere.py::sphere_render_ref: for each masked line l and
// column alpha, beta = atan((-l0 sin a - l2 cos a) / l1), row centre
// rc = S/2 - 1/2 - beta S/pi (NaN -> -1e6), central-difference slope m
// (one-sided at the edges); each pixel sums the anti-aliased coverage
// clip(1/2 + w/2 - |row - rc| / sqrt(1 + m^2), 0, 1) over the lines, and the
// image is 1 - exp(acc * log1p(-alpha)).
//
// What bounds it: the dense form is O(B N S^2) multiply-adds — at the main
// path's B = 32, N = 512, S = 500 that is 4.1e9 line-pixel terms, about 8
// flops each, so it is bound by FP32 issue, not by memory (the per-line
// tables are 2 x 1 MB per image and stay in L1/L2).
// What the design does about it: pass 1 evaluates the transcendental part
// once per (image, line, column) into a (B, N, S) table of rc and
// 1/sqrt(1+m^2); pass 2 gives one thread per output pixel, which loops over
// the lines in index order, skipping masked ones, so the per-pixel work is
// a load pair and four flops, the sum is deterministic and needs no
// atomics. A thread's table reads are shared with the other rows of its
// column through L1. The sparse per-column band splat is later work.
//
// Numerics: built without --use_fast_math and with -fmad=false, so atanf,
// rsqrtf, expf and every product/sum round as the twin's separate PyTorch
// operations do; sin/cos of the column angles come from the caller (the
// twin's own tensors), so both paths start from identical inputs. Only
// the f32 order of the coverage sum differs from the twin.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float row_centre(float l0, float l1, float l2,
                                            float sa, float ca, float c0,
                                            float c1) {
  float beta = atanf((-l0 * sa - l2 * ca) / l1);
  float rc = c0 - beta * c1;
  return isnan(rc) ? -1e6f : rc;
}

// pass 1: one thread per (image, line, column)
__global__ void line_tables(const float* __restrict__ l,
                            const unsigned char* __restrict__ mask,
                            const float* __restrict__ sa,
                            const float* __restrict__ ca,
                            float* __restrict__ rc_out,
                            float* __restrict__ inv_out, int n_lines, int S,
                            float c0, float c1) {
  int j = blockIdx.y * blockDim.x + threadIdx.x;
  int line = blockIdx.x;  // b * n_lines + n
  if (j >= S || !mask[line]) return;
  float l0 = l[3 * line], l1 = l[3 * line + 1], l2 = l[3 * line + 2];
  float rc = row_centre(l0, l1, l2, sa[j], ca[j], c0, c1);
  float m;
  if (j == 0) {
    m = row_centre(l0, l1, l2, sa[1], ca[1], c0, c1) - rc;
  } else if (j == S - 1) {
    m = rc - row_centre(l0, l1, l2, sa[j - 1], ca[j - 1], c0, c1);
  } else {
    m = 0.5f * (row_centre(l0, l1, l2, sa[j + 1], ca[j + 1], c0, c1) -
                row_centre(l0, l1, l2, sa[j - 1], ca[j - 1], c0, c1));
  }
  size_t o = (size_t)line * S + j;
  rc_out[o] = rc;
  inv_out[o] = rsqrtf(1.0f + m * m);
}

// pass 2: one thread per output pixel, lines summed in index order
__global__ void composite(const unsigned char* __restrict__ mask,
                          const float* __restrict__ rc_tab,
                          const float* __restrict__ inv_tab,
                          float* __restrict__ out, int n_lines, int S,
                          float cov_c, float log1m_alpha) {
  int col = blockIdx.x * blockDim.x + threadIdx.x;
  int row = blockIdx.y * blockDim.y + threadIdx.y;
  int b = blockIdx.z;
  if (col >= S || row >= S) return;
  const unsigned char* mk = mask + (size_t)b * n_lines;
  const float* rcp = rc_tab + (size_t)b * n_lines * S + col;
  const float* ivp = inv_tab + (size_t)b * n_lines * S + col;
  float r = (float)row;
  float acc = 0.0f;
  for (int n = 0; n < n_lines; ++n) {
    if (!mk[n]) continue;
    float d = fabsf(r - rcp[(size_t)n * S]) * ivp[(size_t)n * S];
    acc += fminf(fmaxf(cov_c - d, 0.0f), 1.0f);
  }
  out[((size_t)b * S + row) * S + col] = 1.0f - expf(acc * log1m_alpha);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// l (B, N, 3) f32, mask (B, N) bool, sa/ca (S,) f32, scratch rc/inv
// (B, N, S) f32, out (B, S, S) f32; all contiguous on the launching device.
int sphere_render_launch(const float* l, const unsigned char* mask,
                         const float* sa, const float* ca, float* rc_tab,
                         float* inv_tab, float* out, int B, int N, int S,
                         float c0, float c1, float cov_c, float log1m_alpha,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    dim3 g1(B * N, (S + 127) / 128);
    line_tables<<<g1, 128, 0, st>>>(l, mask, sa, ca, rc_tab, inv_tab, N, S,
                                    c0, c1);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  dim3 blk(32, 8);
  dim3 g2((S + 31) / 32, (S + 7) / 8, B);
  composite<<<g2, blk, 0, st>>>(mask, rc_tab, inv_tab, out, N, S, cov_c,
                                log1m_alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"
