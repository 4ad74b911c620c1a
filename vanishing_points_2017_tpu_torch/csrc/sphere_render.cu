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
// What bounds it: the output, B S^2 floats written once, and the per
// (line, column) curve evaluation (an atan, a division, a rsqrt). A line
// covers only the rows within cov_c / inv of rc in each column, about 2-5
// at the main path's sizes, so the coverage work is that band, not the
// column: at B = 32, N = 512, S = 500 the dense form's 4.1e9 line-pixel
// terms shrink to a few 1e7.
// What the design does about it: a banded splat per column. One block is
// one warp and owns 30 output columns (lanes 1-30; lanes 0 and 31 evaluate
// the halo columns for the central differences, which reach the owners by
// shuffle) and a tile of kRows rows, whose accumulator lives in shared
// memory laid out [row][lane], so every lane hits its own bank.
// Each lane walks the lines in index order, skipping masked ones (the mask
// is the same for the whole warp), and adds the coverage only to the rows
// of a conservative band rc -+ (cov_c / inv + 2), clamped to the tile; a
// steep curve (tiny inv) widens the band up to the whole column, an
// off-canvas rc (-1e6) leaves it empty. Then the composite is written once,
// from shared memory, across the columns. No (line, column) table goes
// through device memory, and no atomics: each pixel's sum runs over the
// lines in index order. Several row tiles per column cost one more curve
// evaluation per tile, and buy occupancy: the accumulator of a whole
// column is 64 KB, a 125-row tile's 16 KB (on the H100, 125 ran faster
// than 500, 250 and 64 rows at B = 32 x N = 512; PERF.md).
//
// Numerics: built without --use_fast_math and with -fmad=false, so atanf,
// rsqrtf, expf and every product/sum round as the twin's separate PyTorch
// operations do; sin/cos of the column angles come from the caller (the
// twin's own tensors), so both paths start from identical inputs. Rows
// outside the band have coverage exactly 0, so skipping them leaves each
// pixel's float sum as the dense loop over the lines computes it: only the
// f32 order of the coverage sum differs from the twin, and the image does
// not depend on the row tile.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCols = 30;   // output columns per warp
constexpr int kRows = 125;  // output rows per warp (the row tile)

__device__ __forceinline__ float row_centre(float l0, float l1, float l2,
                                            float sa, float ca, float c0,
                                            float c1) {
  float beta = atanf((-l0 * sa - l2 * ca) / l1);
  float rc = c0 - beta * c1;
  return isnan(rc) ? -1e6f : rc;
}

// grid (ceil(S / kCols), ceil(S / kRows), B), 32 threads
__global__ void __launch_bounds__(32)
    sphere_splat(const float* __restrict__ l,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ sa, const float* __restrict__ ca,
                 float* __restrict__ out, int n_lines, int S, float c0,
                 float c1, float cov_c, float log1m_alpha) {
  __shared__ float acc[kRows * 32];  // [row][lane]
  const int lane = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kRows;
  const int r1 = min(r0 + kRows, S);
  const int j = blockIdx.x * kCols - 1 + lane;
  const bool owner = lane >= 1 && lane <= kCols && j < S;
  const int jc = min(max(j, 0), S - 1);  // halo lanes off the canvas
  const float saj = sa[jc], caj = ca[jc];
  for (int r = r0; r < r1; ++r) acc[(r - r0) * 32 + lane] = 0.0f;

  const float* lb = l + (size_t)b * n_lines * 3;
  const unsigned char* mb = mask + (size_t)b * n_lines;
  for (int n = 0; n < n_lines; ++n) {
    if (!mb[n]) continue;  // uniform across the warp
    const float rc = row_centre(lb[3 * n], lb[3 * n + 1], lb[3 * n + 2], saj,
                                caj, c0, c1);
    const float rl = __shfl_up_sync(kFull, rc, 1);
    const float rr = __shfl_down_sync(kFull, rc, 1);
    if (!owner) continue;
    float m;
    if (j == 0) {
      m = rr - rc;
    } else if (j == S - 1) {
      m = rc - rl;
    } else {
      m = 0.5f * (rr - rl);
    }
    const float inv = rsqrtf(1.0f + m * m);
    const float half = cov_c / inv + 2.0f;
    const float lo_f = fmaxf(rc - half, (float)r0);
    const float hi_f = fminf(rc + half, (float)(r1 - 1));
    if (!(lo_f <= hi_f)) continue;
    const int hi = (int)ceilf(hi_f);
    for (int r = (int)floorf(lo_f); r <= hi; ++r) {
      const float d = fabsf((float)r - rc) * inv;
      acc[(r - r0) * 32 + lane] += fminf(fmaxf(cov_c - d, 0.0f), 1.0f);
    }
  }
  if (!owner) return;
  for (int r = r0; r < r1; ++r) {
    out[((size_t)b * S + r) * S + j] =
        1.0f - expf(acc[(r - r0) * 32 + lane] * log1m_alpha);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// l (B, N, 3) f32, mask (B, N) bool, sa/ca (S,) f32, out (B, S, S) f32;
// all contiguous on the launching device.
int sphere_render_launch(const float* l, const unsigned char* mask,
                         const float* sa, const float* ca, float* out, int B,
                         int N, int S, float c0, float c1, float cov_c,
                         float log1m_alpha, void* stream) {
  if (S < 2) return (int)cudaErrorInvalidValue;
  dim3 grid((S + kCols - 1) / kCols, (S + kRows - 1) / kRows, B);
  sphere_splat<<<grid, 32, 0, (cudaStream_t)stream>>>(
      l, mask, sa, ca, out, N, S, c0, c1, cov_c, log1m_alpha);
  return (int)cudaGetLastError();
}

}  // extern "C"
