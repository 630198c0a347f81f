// Shared pieces of the CP/VM field kernels (field_fwd.cu, dyn_field_fwd.cu,
// field_bwd.cu, dyn_field_bwd.cu): the layout descriptions passed by the
// ctypes entry points, bf16 helpers, the hat taps, the degree-4 spherical
// harmonics and the mma.sync.m16n8k16 wrapper. The forward kernels' body is
// in field_fwd_body.cuh, the backward kernels' in field_bwd_body.cuh; the
// backward recomputes the forward with the forward body's own device
// functions, so the two agree bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sdn {

constexpr int kShDeg = 4;
constexpr int kShDim = kShDeg * kShDeg;
constexpr int kMaxScales = 8;
constexpr int kMaxPlanes = 4;

struct FieldMeta {
  int n_scales, n_planes, freq_degree, w_elems;
  // the backward kernels' weight-gradient buffer g_w (f32, w_elems entries):
  int w_off[5];  // w0 [32 n_blocks, 64] | w1 [64, 16] | wc0 [32, 64] | wc1 [64, 64] | wc2 [64, 8]
  float bound;
  float pmm[kShDeg];    // (-1)^m (2m-1)!!
  float shk[kShDim];    // K_l^m, times sqrt(2) for m != 0
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ldbf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Lower tap index and the two bf16-rounded hat weights of x01 in [0, 1] on a
// res-point axis; the same float operations as the reference's hat basis.
__device__ __forceinline__ void hat(float x01, int res, int& i0, float& w0, float& w1) {
  const float xa = __fmul_rn(x01, (float)(res - 1));
  i0 = min((int)floorf(xa), res - 2);
  const float f0 = (float)i0;
  w0 = bf16r(fmaxf(0.f, 1.f - fabsf(__fsub_rn(xa, f0))));
  w1 = bf16r(fmaxf(0.f, 1.f - fabsf(__fsub_rn(xa, f0 + 1.f))));
}

// x in [-bound, bound] -> [0, 1], clipped
__device__ __forceinline__ float unit01(float x, float bound) {
  return fminf(fmaxf(__fdiv_rn(__fadd_rn(x, bound), 2.f * bound), 0.f), 1.f);
}

// Real SH of degree 4 of a unit direction, in the reference's component
// order (l = 0..3, m = -l..l), not rounded.
__device__ __forceinline__ void sh_basis(const FieldMeta& meta, float dx, float dy, float dz,
                                         float* v) {
  float Cm[kShDeg], Sm[kShDeg], Pl[kShDeg][kShDeg];
  Cm[0] = 1.f;
  Sm[0] = 0.f;
#pragma unroll
  for (int mm = 1; mm < kShDeg; ++mm) {
    Cm[mm] = dx * Cm[mm - 1] - dy * Sm[mm - 1];
    Sm[mm] = dx * Sm[mm - 1] + dy * Cm[mm - 1];
  }
#pragma unroll
  for (int mm = 0; mm < kShDeg; ++mm) {
    Pl[mm][mm] = meta.pmm[mm];
    if (mm + 1 < kShDeg) Pl[mm + 1][mm] = (float)(2 * mm + 1) * dz * Pl[mm][mm];
#pragma unroll
    for (int l = mm + 2; l < kShDeg; ++l)
      Pl[l][mm] = ((float)(2 * l - 1) * dz * Pl[l - 1][mm] -
                   (float)(l + mm - 1) * Pl[l - 2][mm]) / (float)(l - mm);
  }
  int k = 0;
#pragma unroll
  for (int l = 0; l < kShDeg; ++l) {
#pragma unroll
    for (int mm = -l; mm <= l; ++mm, ++k) {
      const int am = mm < 0 ? -mm : mm;
      float s = meta.shk[k] * Pl[l][am];
      if (mm > 0) s = s * Cm[am];
      if (mm < 0) s = s * Sm[am];
      v[k] = s;
    }
  }
}

// D[16x8] += A[16x16] * B[16x8]; A row-major, B column-major, f32 accumulate.
// Fragments (g = lane / 4, t = lane % 4):
//   A: a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..) a3 (g+8, 2t+8..)
//   B: b0 (k 2t..2t+1, n g) b1 (k 2t+8.., n g)
//   C: c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_relu_bf16(float lo, float hi) {
  return pack_bf16(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
}

inline double sh_k(int l, int m) {
  double r = (2.0 * l + 1.0) / (4.0 * M_PI);
  for (int t = l - m + 1; t <= l + m; ++t) r /= t;  // (l-m)! / (l+m)!
  return sqrt(r);
}

// meta (int64): n_scales, n_planes, freq_degree, feat_dim, w_elems, w_off[5],
// then per scale (res, rank, off_x, off_y, off_z), then per plane scale
// (res, ch, plane_off[3], vm_line_off[3]): the tables' places in `tab`, with
// rank and ch their padded row lengths, which the wrappers read (the kernels
// take them from the tile layout behind, see fill_tile_meta); w_elems and
// w_off describe the weight-gradient buffer. Offsets count elements.
// Returns 0, or cudaErrorInvalidValue for a layout the kernels do not take.
inline int fill_meta(const long long* meta, float bound, FieldMeta* out) {
  FieldMeta fm = {};
  fm.n_scales = (int)meta[0];
  fm.n_planes = (int)meta[1];
  fm.freq_degree = (int)meta[2];
  fm.w_elems = (int)meta[4];
  if (fm.n_scales < 0 || fm.n_scales > kMaxScales || fm.n_planes < 0 ||
      fm.n_planes > kMaxPlanes || fm.w_elems % 8 != 0)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < 5; ++t) fm.w_off[t] = (int)meta[5 + t];
  fm.bound = bound;
  double dfact = 1.0;  // (2m-1)!!
  for (int mm = 0; mm < kShDeg; ++mm) {
    if (mm > 0) dfact *= (2 * mm - 1);
    fm.pmm[mm] = (float)((mm % 2 ? -1.0 : 1.0) * dfact);
  }
  int k = 0;
  for (int l = 0; l < kShDeg; ++l)
    for (int mm = -l; mm <= l; ++mm, ++k) {
      const int am = mm < 0 ? -mm : mm;
      fm.shk[k] = (float)(mm == 0 ? sh_k(l, 0) : sqrt(2.0) * sh_k(l, am));
    }
  *out = fm;
  return 0;
}

}  // namespace sdn
