// Shared pieces of the CP/VM field kernels (field_fwd.cu, dyn_field_fwd.cu,
// field_bwd.cu): the layout description passed by the ctypes entry points,
// bf16 helpers, the 64-wide tower products over bf16 rows in shared memory,
// the hat taps, the degree-4 spherical harmonics, and the canonical field at
// one sample (field_sample), which both forward kernels call. A forward
// recomputed inside the backward rounds exactly as the forward kernels do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sdn {

constexpr int kHid = 64;          // sigma tower hidden width
constexpr int kGeo = 15;          // geo_feat_dim
constexpr int kSigOut = 1 + kGeo;
constexpr int kHidC = 64;         // colour tower hidden width
constexpr int kShDeg = 4;
constexpr int kShDim = kShDeg * kShDeg;
constexpr int kMaxScales = 8;
constexpr int kMaxPlanes = 4;

struct FieldMeta {
  int n_scales, n_planes, freq_degree, feat_dim, w_elems;
  int w_off[5];  // w0 [feat, 64] | w1t [16, 64] | wc0 [31, 64] | wc1t [64, 64] | wc2 [64, 3]
  int res[kMaxScales], rank[kMaxScales];
  long long line_off[kMaxScales][3];
  int pres[kMaxPlanes], pch[kMaxPlanes];
  long long plane_off[kMaxPlanes][3], vml_off[kMaxPlanes][3];
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

__device__ __forceinline__ void unpack8(uint4 u, float* f) {
  f[0] = __uint_as_float(u.x << 16); f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16); f[3] = __uint_as_float(u.y & 0xffff0000u);
  f[4] = __uint_as_float(u.z << 16); f[5] = __uint_as_float(u.z & 0xffff0000u);
  f[6] = __uint_as_float(u.w << 16); f[7] = __uint_as_float(u.w & 0xffff0000u);
}

// acc[0:64] += a * row[0:64]; row is a 16-byte aligned bf16 row in shared memory
__device__ __forceinline__ void axpy64(float a, const __nv_bfloat16* row, float* acc) {
  const uint4* r = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float w[8];
    unpack8(r[q], w);
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[q * 8 + t] = fmaf(a, w[t], acc[q * 8 + t]);
  }
}

// sum_k v[k] * row[k] over 64 entries
__device__ __forceinline__ float dot64(const float* v, const __nv_bfloat16* row) {
  const uint4* r = reinterpret_cast<const uint4*>(row);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float w[8];
    unpack8(r[q], w);
#pragma unroll
    for (int t = 0; t < 8; ++t) s = fmaf(v[q * 8 + t], w[t], s);
  }
  return s;
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

// The five tower matrices in shared memory, in the layouts of FieldMeta::w_off.
struct TowerWeights {
  const __nv_bfloat16 *w0, *w1t, *wc0, *wc1t, *wc2;
};

__device__ __forceinline__ TowerWeights tower_weights(const __nv_bfloat16* ws,
                                                      const FieldMeta& meta) {
  return {ws + meta.w_off[0], ws + meta.w_off[1], ws + meta.w_off[2], ws + meta.w_off[3],
          ws + meta.w_off[4]};
}

// Copy the packed tower weights (w_elems bf16, a multiple of 8) to shared
// memory with the whole block; the caller synchronises.
__device__ __forceinline__ void stage_tower_weights(const __nv_bfloat16* wbuf, __nv_bfloat16* ws,
                                                    const FieldMeta& meta) {
  const uint4* src = reinterpret_cast<const uint4*>(wbuf);
  uint4* dst = reinterpret_cast<uint4*>(ws);
  for (int i = threadIdx.x; i < meta.w_elems / 8; i += blockDim.x) dst[i] = src[i];
}

// The canonical field at one sample: position xyz (already warped, for the
// dynamic kernel), direction d3[:, i]; writes rows (sigma, r, g, b) of
// out [4, m] at column i. The forward kernels of the static and the dynamic
// field both call this, so they round alike.
__device__ __forceinline__ void field_sample(const FieldMeta& meta,
                                             const __nv_bfloat16* __restrict__ tab,
                                             const TowerWeights& w, const float* xyz,
                                             const float* __restrict__ d3, long long m,
                                             long long i, int lod_mask, int density_only,
                                             float* __restrict__ out) {
  float x01[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) x01[a] = unit01(xyz[a], meta.bound);

  // ---- sigma tower input layer, accumulated feature by feature ----
  float h[kHid];
#pragma unroll
  for (int j = 0; j < kHid; ++j) h[j] = 0.f;
  int row = 0;
  for (int s = 0; s < meta.n_scales; ++s) {
    const int res = meta.res[s], rank = meta.rank[s];
    if ((lod_mask >> s) & 1) { row += rank; continue; }
    const __nv_bfloat16* lo[3];
    float wl[3], wh[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      int i0;
      hat(x01[a], res, i0, wl[a], wh[a]);
      lo[a] = tab + meta.line_off[s][a] + (long long)i0 * rank;
    }
    for (int r = 0; r < rank; ++r) {
      const float fx = wl[0] * ldbf(lo[0] + r) + wh[0] * ldbf(lo[0] + rank + r);
      const float fy = wl[1] * ldbf(lo[1] + r) + wh[1] * ldbf(lo[1] + rank + r);
      const float fz = wl[2] * ldbf(lo[2] + r) + wh[2] * ldbf(lo[2] + rank + r);
      axpy64(bf16r(__fmul_rn(__fmul_rn(fx, fy), fz)), w.w0 + (row + r) * kHid, h);
    }
    row += rank;
  }
  for (int s = 0; s < meta.n_planes; ++s) {
    const int P = meta.pres[s], C = meta.pch[s];
    int ip[3];
    float pl[3], ph[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) hat(x01[a], P, ip[a], pl[a], ph[a]);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      // VM pairs (plane axes a, b; line axis e): (0,1,2) (0,2,1) (1,2,0)
      const int a = p == 2 ? 1 : 0, b = p == 0 ? 1 : 2, e = 2 - p;
      const __nv_bfloat16* p00 =
          tab + meta.plane_off[s][p] + ((long long)ip[a] * P + ip[b]) * C;
      const __nv_bfloat16* p10 = p00 + (long long)P * C;
      const __nv_bfloat16* l0 = tab + meta.vml_off[s][p] + (long long)ip[e] * C;
      for (int c = 0; c < C; ++c) {
        const float q0 = pl[a] * ldbf(p00 + c) + ph[a] * ldbf(p10 + c);
        const float q1 = pl[a] * ldbf(p00 + C + c) + ph[a] * ldbf(p10 + C + c);
        const float f = pl[b] * q0 + ph[b] * q1;
        const float l = pl[e] * ldbf(l0 + c) + ph[e] * ldbf(l0 + C + c);
        axpy64(bf16r(__fmul_rn(f, l)), w.w0 + (row + c) * kHid, h);
      }
      row += C;
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) axpy64(xyz[a], w.w0 + (row + a) * kHid, h);
  row += 3;
  for (int fd = 0; fd < meta.freq_degree; ++fd) {
    const float sc = (float)(1 << fd);
#pragma unroll
    for (int a = 0; a < 3; ++a) axpy64(sinf(xyz[a] * sc), w.w0 + (row + a) * kHid, h);
#pragma unroll
    for (int a = 0; a < 3; ++a) axpy64(cosf(xyz[a] * sc), w.w0 + (row + 3 + a) * kHid, h);
    row += 6;
  }
#pragma unroll
  for (int j = 0; j < kHid; ++j) h[j] = bf16r(fmaxf(h[j], 0.f));

  // ---- sigma tower output layer ----
  float o[kSigOut];
#pragma unroll
  for (int j = 0; j < kSigOut; ++j) o[j] = dot64(h, w.w1t + j * kHid);
  const float sigma = expf(o[0]);
  out[i] = sigma;
  if (density_only) {
    out[m + i] = 0.f;
    out[2 * m + i] = 0.f;
    out[3 * m + i] = 0.f;
    return;
  }

  // ---- SH(d), degree 4 ----
  float sh[kShDim];
  sh_basis(meta, d3[i], d3[m + i], d3[2 * m + i], sh);

  // ---- colour tower ----
  float hc[kHidC];
#pragma unroll
  for (int j = 0; j < kHidC; ++j) hc[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kShDim; ++k) axpy64(bf16r(sh[k]), w.wc0 + k * kHidC, hc);
#pragma unroll
  for (int g = 0; g < kGeo; ++g) axpy64(bf16r(o[1 + g]), w.wc0 + (kShDim + g) * kHidC, hc);
#pragma unroll
  for (int j = 0; j < kHidC; ++j) hc[j] = bf16r(fmaxf(hc[j], 0.f));
  float rgb[3] = {0.f, 0.f, 0.f};
  for (int j = 0; j < kHidC; ++j) {
    const float a = bf16r(fmaxf(dot64(hc, w.wc1t + j * kHidC), 0.f));
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = fmaf(a, ldbf(w.wc2 + j * 3 + c), rgb[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[(c + 1) * m + i] = 1.f / (1.f + expf(-rgb[c]));
}

inline double sh_k(int l, int m) {
  double r = (2.0 * l + 1.0) / (4.0 * M_PI);
  for (int t = l - m + 1; t <= l + m; ++t) r /= t;  // (l-m)! / (l+m)!
  return sqrt(r);
}

// meta (int64): n_scales, n_planes, freq_degree, feat_dim, w_elems, w_off[5],
// then per scale (res, rank, off_x, off_y, off_z), then per plane scale
// (res, ch, plane_off[3], vm_line_off[3]). Offsets count bf16 elements.
// Returns 0, or cudaErrorInvalidValue for a layout the kernels do not take.
inline int fill_meta(const long long* meta, float bound, FieldMeta* out) {
  FieldMeta fm = {};
  fm.n_scales = (int)meta[0];
  fm.n_planes = (int)meta[1];
  fm.freq_degree = (int)meta[2];
  fm.feat_dim = (int)meta[3];
  fm.w_elems = (int)meta[4];
  if (fm.n_scales > kMaxScales || fm.n_planes > kMaxPlanes || fm.w_elems % 8 != 0)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < 5; ++t) fm.w_off[t] = (int)meta[5 + t];
  const long long* q = meta + 10;
  for (int s = 0; s < fm.n_scales; ++s, q += 5) {
    fm.res[s] = (int)q[0];
    fm.rank[s] = (int)q[1];
    for (int a = 0; a < 3; ++a) fm.line_off[s][a] = q[2 + a];
  }
  for (int s = 0; s < fm.n_planes; ++s, q += 8) {
    fm.pres[s] = (int)q[0];
    fm.pch[s] = (int)q[1];
    for (int p = 0; p < 3; ++p) {
      fm.plane_off[s][p] = q[2 + p];
      fm.vml_off[s][p] = q[5 + p];
    }
  }
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
