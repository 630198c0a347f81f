// The canonical CP/VM field backward at one tile of samples: the kernel body
// shared by the static backward (field_bwd.cu) and the dynamic backward
// (dyn_field_bwd.cu). See field_bwd.cu for the rounding points and the
// design. With kGx the kernel also computes d(loss)/d(position) of each
// sample, routed through the line scales and planes with res <= cutoff and
// through the frequency features (the coarse-only warp gradient of the
// dynamic field), and appends the sample to a compact list for the
// deformation tower's backward.

#pragma once

#include "field_common.cuh"

namespace sdn {

constexpr int kT = 64;                  // samples per block, one per thread
constexpr int kCin = kShDim + kGeo;     // colour tower input width
constexpr int kRowB = 72;               // padded bf16 row of a [T][64] stash
constexpr int kRowF = 68;               // padded f32 row of the g_h0 stash
constexpr size_t kMaxSmem = 232448;     // per block on sm_90

// Byte offsets of the stash arrays in dynamic shared memory (after the
// weights). "T" arrays are [rows][kT] (one column per sample), the others
// [kT][row] (one padded row per sample).
struct BwdLayout {
  int n_grid, n_freq;
  unsigned feat_t, freq_t, gh0, r0, gh1_t, cin_t, ghc0, rc0, ghc1_t, rc1, ghc2_t, total;
};

__device__ __forceinline__ unsigned pack2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// dst[0:64] = bf16(v[0:64]); dst is 16-byte aligned
__device__ __forceinline__ void store_row_bf16(__nv_bfloat16* dst, const float* v) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    d[q] = make_uint4(pack2(v[8 * q], v[8 * q + 1]), pack2(v[8 * q + 2], v[8 * q + 3]),
                      pack2(v[8 * q + 4], v[8 * q + 5]), pack2(v[8 * q + 6], v[8 * q + 7]));
}

__device__ __forceinline__ void red_add(float* p, float v) {
  if (v != 0.f) atomicAdd(p, v);
}

// out[r * rs + threadIdx.x * cs] += sum_{t < nt} rows[r][t] * col[t] for
// r < n_rows; rows is a bf16 [n_rows][kT] stash, nt a multiple of 8.
__device__ __forceinline__ void reduce_rows(const __nv_bfloat16* rows, int n_rows,
                                            const float* col, int nt, float* out, int rs,
                                            int cs) {
  for (int r = 0; r < n_rows; ++r) {
    const uint4* src = reinterpret_cast<const uint4*>(rows + r * kT);
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < kT / 8; ++q) {
      if (q * 8 < nt) {
        float w[8];
        unpack8(src[q], w);
#pragma unroll
        for (int t = 0; t < 8; ++t) acc = fmaf(w[t], col[q * 8 + t], acc);
      }
    }
    red_add(out + r * rs + threadIdx.x * cs, acc);
  }
}

// the same over an f32 [n_rows][kT] stash
__device__ __forceinline__ void reduce_rows_f32(const float* rows, int n_rows, const float* col,
                                                int nt, float* out, int rs) {
  for (int r = 0; r < n_rows; ++r) {
    const float4* src = reinterpret_cast<const float4*>(rows + r * kT);
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < kT / 4; ++q) {
      if (q * 4 < nt) {
        const float4 w = src[q];
        acc = fmaf(w.x, col[q * 4], acc);
        acc = fmaf(w.y, col[q * 4 + 1], acc);
        acc = fmaf(w.z, col[q * 4 + 2], acc);
        acc = fmaf(w.w, col[q * 4 + 3], acc);
      }
    }
    red_add(out + r * rs + threadIdx.x, acc);
  }
}

// col[t] = stash[t][threadIdx.x] for t < nt, else 0
__device__ __forceinline__ void load_col_bf16(const __nv_bfloat16* stash, int nt, float* col) {
#pragma unroll
  for (int t = 0; t < kT; ++t) col[t] = t < nt ? ldbf(stash + t * kRowB + threadIdx.x) : 0.f;
}

// Where the kGx kernel puts d(loss)/d(position): the samples that carry a
// cotangent are appended, in no particular order, to idx [n] (their sample
// index) and gx [3, m] (columns 0..n-1 used); *count is n and starts at 0.
// cutoff: line scales and planes with res <= cutoff back-drive the position.
struct GxOut {
  int cutoff;
  int* count;
  int* idx;
  float* gx;
};

// Derivative of the two hat taps of hat() with respect to the scaled
// coordinate xa = x01 (res - 1): -sign(xa - i) on the open support
// |xa - i| < 1, else 0 (the reference's d(hat)/dx).
__device__ __forceinline__ void hat_slope(float x01, int res, int i0, float& d0, float& d1) {
  const float xa = __fmul_rn(x01, (float)(res - 1));
  const float f0 = (float)i0;
  const float e0 = __fsub_rn(xa, f0), e1 = __fsub_rn(xa, f0 + 1.f);
  d0 = fabsf(e0) < 1.f ? (e0 > 0.f ? -1.f : (e0 < 0.f ? 1.f : 0.f)) : 0.f;
  d1 = fabsf(e1) < 1.f ? (e1 > 0.f ? -1.f : (e1 < 0.f ? 1.f : 0.f)) : 0.f;
}

template <bool kGx>
__global__ void __launch_bounds__(kT)
field_bwd_kernel(const float* __restrict__ x3, const float* __restrict__ d3,
                 const float* __restrict__ g_out, long long m,
                 const __nv_bfloat16* __restrict__ tab, const __nv_bfloat16* __restrict__ wbuf,
                 const FieldMeta meta, const BwdLayout L, float* __restrict__ g_tab,
                 float* __restrict__ g_w, const GxOut gxo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_active[kT / 32];
  __shared__ int list_base;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  {
    const uint4* src = reinterpret_cast<const uint4*>(wbuf);
    uint4* dst = reinterpret_cast<uint4*>(ws);
    for (int i = threadIdx.x; i < meta.w_elems / 8; i += blockDim.x) dst[i] = src[i];
  }
  const __nv_bfloat16* w0 = ws + meta.w_off[0];
  const __nv_bfloat16* w1t = ws + meta.w_off[1];
  const __nv_bfloat16* wc0 = ws + meta.w_off[2];
  const __nv_bfloat16* wc1t = ws + meta.w_off[3];
  const __nv_bfloat16* wc2 = ws + meta.w_off[4];
  __nv_bfloat16* feat_t = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.feat_t);
  float* freq_t = reinterpret_cast<float*>(smem_raw + L.freq_t);
  float* gh0_s = reinterpret_cast<float*>(smem_raw + L.gh0);
  __nv_bfloat16* r0_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.r0);
  __nv_bfloat16* gh1_t = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.gh1_t);
  __nv_bfloat16* cin_t = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.cin_t);
  __nv_bfloat16* ghc0_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.ghc0);
  __nv_bfloat16* rc0_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.rc0);
  __nv_bfloat16* ghc1_t = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.ghc1_t);
  __nv_bfloat16* rc1_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.rc1);
  __nv_bfloat16* ghc2_t = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.ghc2_t);

  // ---- which samples of the tile carry a cotangent; compact them ----
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i = (long long)blockIdx.x * kT + tid;
  float go[4] = {0.f, 0.f, 0.f, 0.f};
  if (i < m) {
#pragma unroll
    for (int r = 0; r < 4; ++r) go[r] = g_out[r * m + i];
  }
  const bool active = go[0] != 0.f || go[1] != 0.f || go[2] != 0.f || go[3] != 0.f;
  const unsigned ballot = __ballot_sync(0xffffffffu, active);
  if (lane == 0) warp_active[warp] = __popc(ballot);
  __syncthreads();  // also publishes the weights
  const int n_act = warp_active[0] + warp_active[1];
  if (n_act == 0) return;
  const int below = __popc(ballot & ((1u << lane) - 1u));
  const int slot = active ? (warp ? warp_active[0] : 0) + below
                          : n_act + (warp ? 32 - warp_active[0] : 0) + (lane - below);
  const int nt = (n_act + 7) & ~7;

  float gx_out[3] = {0.f, 0.f, 0.f};
  if (active) {
    float xyz[3], x01[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      xyz[a] = x3[a * m + i];
      x01[a] = unit01(xyz[a], meta.bound);
    }

    // ---- forward: sigma tower input layer; stash the features ----
    float h[kHid];
#pragma unroll
    for (int j = 0; j < kHid; ++j) h[j] = 0.f;
    int row = 0;
    for (int s = 0; s < meta.n_scales; ++s) {
      const int res = meta.res[s], rank = meta.rank[s];
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
        const float f = bf16r(__fmul_rn(__fmul_rn(fx, fy), fz));
        feat_t[(row + r) * kT + slot] = __float2bfloat16_rn(f);
        axpy64(f, w0 + (row + r) * kHid, h);
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
          const float v = bf16r(__fmul_rn(f, l));
          feat_t[(row + c) * kT + slot] = __float2bfloat16_rn(v);
          axpy64(v, w0 + (row + c) * kHid, h);
        }
        row += C;
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      freq_t[a * kT + slot] = xyz[a];
      axpy64(xyz[a], w0 + (row + a) * kHid, h);
    }
    row += 3;
    for (int fd = 0; fd < meta.freq_degree; ++fd) {
      const float sc = (float)(1 << fd);
      const int k = 3 + 6 * fd;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float v = sinf(xyz[a] * sc);
        freq_t[(k + a) * kT + slot] = v;
        axpy64(v, w0 + (row + a) * kHid, h);
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float v = cosf(xyz[a] * sc);
        freq_t[(k + 3 + a) * kT + slot] = v;
        axpy64(v, w0 + (row + 3 + a) * kHid, h);
      }
      row += 6;
    }
    unsigned long long mask0 = 0ull;
#pragma unroll
    for (int j = 0; j < kHid; ++j) {
      if (h[j] > 0.f) mask0 |= 1ull << j;
      h[j] = bf16r(fmaxf(h[j], 0.f));
    }
    store_row_bf16(r0_s + slot * kRowB, h);

    // ---- forward: sigma output layer, SH, colour tower ----
    float o[kSigOut];
#pragma unroll
    for (int j = 0; j < kSigOut; ++j) o[j] = dot64(h, w1t + j * kHid);
    float sh[kShDim];
    sh_basis(meta, d3[i], d3[m + i], d3[2 * m + i], sh);
    float hc[kHidC];
#pragma unroll
    for (int j = 0; j < kHidC; ++j) hc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < kShDim; ++k) {
      const float v = bf16r(sh[k]);
      cin_t[k * kT + slot] = __float2bfloat16_rn(v);
      axpy64(v, wc0 + k * kHidC, hc);
    }
#pragma unroll
    for (int g = 0; g < kGeo; ++g) {
      const float v = bf16r(o[1 + g]);
      cin_t[(kShDim + g) * kT + slot] = __float2bfloat16_rn(v);
      axpy64(v, wc0 + (kShDim + g) * kHidC, hc);
    }
    unsigned long long maskc0 = 0ull;
#pragma unroll
    for (int j = 0; j < kHidC; ++j) {
      if (hc[j] > 0.f) maskc0 |= 1ull << j;
      hc[j] = bf16r(fmaxf(hc[j], 0.f));
    }
    store_row_bf16(rc0_s + slot * kRowB, hc);
    unsigned long long maskc1 = 0ull;
    float lg[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < kHidC; ++j) {
      const float pre = dot64(hc, wc1t + j * kHidC);
      if (pre > 0.f) maskc1 |= 1ull << j;
      const float a = bf16r(fmaxf(pre, 0.f));
      rc1_s[slot * kRowB + j] = __float2bfloat16_rn(a);
#pragma unroll
      for (int c = 0; c < 3; ++c) lg[c] = fmaf(a, ldbf(wc2 + j * 3 + c), lg[c]);
    }

    // ---- backward chain ----
    float g2[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float rgb = 1.f / (1.f + expf(-lg[c]));
      g2[c] = bf16r(go[1 + c] * rgb * (1.f - rgb));
      ghc2_t[c * kT + slot] = __float2bfloat16_rn(g2[c]);
    }
    // g_hc1 = (W_c2 g_hc2) * [hc1 > 0];  g_rc0 = W_c1 g_hc1 (into hc)
#pragma unroll
    for (int k = 0; k < kHidC; ++k) hc[k] = 0.f;
    for (int j = 0; j < kHidC; ++j) {
      float gj = 0.f;
      if ((maskc1 >> j) & 1ull) {
#pragma unroll
        for (int c = 0; c < 3; ++c) gj = fmaf(ldbf(wc2 + j * 3 + c), g2[c], gj);
        gj = bf16r(gj);
      }
      ghc1_t[j * kT + slot] = __float2bfloat16_rn(gj);
      if (gj != 0.f) axpy64(gj, wc1t + j * kHidC, hc);
    }
#pragma unroll
    for (int k = 0; k < kHidC; ++k) hc[k] = ((maskc0 >> k) & 1ull) ? bf16r(hc[k]) : 0.f;
    store_row_bf16(ghc0_s + slot * kRowB, hc);  // g_hc0
    float gh1[kSigOut];
    gh1[0] = bf16r(go[0] * expf(fminf(fmaxf(o[0], -15.f), 15.f)));
#pragma unroll
    for (int g = 0; g < kGeo; ++g) gh1[1 + g] = bf16r(dot64(hc, wc0 + (kShDim + g) * kHidC));
#pragma unroll
    for (int j = 0; j < kSigOut; ++j) gh1_t[j * kT + slot] = __float2bfloat16_rn(gh1[j]);
    // g_h0 = (W_1 g_h1) * [h0 > 0] (into h), stashed in f32, used in bf16
#pragma unroll
    for (int k = 0; k < kHid; ++k) h[k] = 0.f;
#pragma unroll
    for (int j = 0; j < kSigOut; ++j) axpy64(gh1[j], w1t + j * kHid, h);
#pragma unroll
    for (int k = 0; k < kHid; ++k) h[k] = ((mask0 >> k) & 1ull) ? h[k] : 0.f;
    {
      float4* d = reinterpret_cast<float4*>(gh0_s + slot * kRowF);
#pragma unroll
      for (int q = 0; q < kHid / 4; ++q)
        d[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    }
#pragma unroll
    for (int k = 0; k < kHid; ++k) h[k] = bf16r(h[k]);

    // ---- table gradients: recompute the taps, scatter ----
    // with kGx also gx = d(loss)/d(xyz): the hat taps' slopes times the
    // coordinate scale (res - 1) / (2 bound), zero outside |x| < bound
    float gx[3] = {0.f, 0.f, 0.f}, inb[3] = {0.f, 0.f, 0.f};
    if constexpr (kGx) {
#pragma unroll
      for (int a = 0; a < 3; ++a) inb[a] = fabsf(xyz[a]) < meta.bound ? 1.f : 0.f;
    }
    row = 0;
    for (int s = 0; s < meta.n_scales; ++s) {
      const int res = meta.res[s], rank = meta.rank[s];
      const bool drive = kGx && res <= gxo.cutoff;
      const __nv_bfloat16* lo[3];
      float* glo[3];
      float wl[3], wh[3], dl[3] = {0.f, 0.f, 0.f}, dh[3] = {0.f, 0.f, 0.f};
      float gsum[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        int i0;
        hat(x01[a], res, i0, wl[a], wh[a]);
        if constexpr (kGx) hat_slope(x01[a], res, i0, dl[a], dh[a]);
        lo[a] = tab + meta.line_off[s][a] + (long long)i0 * rank;
        glo[a] = g_tab + meta.line_off[s][a] + (long long)i0 * rank;
      }
      for (int r = 0; r < rank; ++r) {
        float f[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) f[a] = wl[a] * ldbf(lo[a] + r) + wh[a] * ldbf(lo[a] + rank + r);
        const float g_prod = dot64(h, w0 + (row + r) * kHid);
        if (g_prod == 0.f) continue;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float gfr = g_prod * __fmul_rn(f[(a + 1) % 3], f[(a + 2) % 3]);
          const float gf = bf16r(gfr);
          red_add(glo[a] + r, gf * wl[a]);
          red_add(glo[a] + rank + r, gf * wh[a]);
          if constexpr (kGx) {
            if (drive)
              gsum[a] = fmaf(gfr, dl[a] * ldbf(lo[a] + r) + dh[a] * ldbf(lo[a] + rank + r),
                             gsum[a]);
          }
        }
      }
      if constexpr (kGx) {
        const float sc = (float)(res - 1) / (2.f * meta.bound);
#pragma unroll
        for (int a = 0; a < 3; ++a) gx[a] += gsum[a] * sc * inb[a];
      }
      row += rank;
    }
    for (int s = 0; s < meta.n_planes; ++s) {
      const int P = meta.pres[s], C = meta.pch[s];
      const bool drive = kGx && P <= gxo.cutoff;
      int ip[3];
      float pl[3], ph[3], dl[3] = {0.f, 0.f, 0.f}, dh[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        hat(x01[a], P, ip[a], pl[a], ph[a]);
        if constexpr (kGx) hat_slope(x01[a], P, ip[a], dl[a], dh[a]);
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int a = p == 2 ? 1 : 0, b = p == 0 ? 1 : 2, e = 2 - p;
        const long long o00 = meta.plane_off[s][p] + ((long long)ip[a] * P + ip[b]) * C;
        const long long o10 = o00 + (long long)P * C;
        const long long ol = meta.vml_off[s][p] + (long long)ip[e] * C;
        // cotangents of the two hat taps of each of the pair's three axes
        float ga0 = 0.f, ga1 = 0.f, gb0 = 0.f, gb1 = 0.f, ge0 = 0.f, ge1 = 0.f;
        for (int c = 0; c < C; ++c) {
          const float q0 = pl[a] * ldbf(tab + o00 + c) + ph[a] * ldbf(tab + o10 + c);
          const float q1 = pl[a] * ldbf(tab + o00 + C + c) + ph[a] * ldbf(tab + o10 + C + c);
          const float f = pl[b] * q0 + ph[b] * q1;
          const float l = pl[e] * ldbf(tab + ol + c) + ph[e] * ldbf(tab + ol + C + c);
          const float g_vm = dot64(h, w0 + (row + c) * kHid);
          if (g_vm == 0.f) continue;
          const float gl = bf16r(g_vm * f);
          red_add(g_tab + ol + c, gl * pl[e]);
          red_add(g_tab + ol + C + c, gl * ph[e]);
          const float gf = g_vm * l;
          const float t0 = bf16r(gf * pl[b]), t1 = bf16r(gf * ph[b]);
          red_add(g_tab + o00 + c, pl[a] * t0);
          red_add(g_tab + o10 + c, ph[a] * t0);
          red_add(g_tab + o00 + C + c, pl[a] * t1);
          red_add(g_tab + o10 + C + c, ph[a] * t1);
          if constexpr (kGx) {
            if (drive) {
              ga0 += ldbf(tab + o00 + c) * t0 + ldbf(tab + o00 + C + c) * t1;
              ga1 += ldbf(tab + o10 + c) * t0 + ldbf(tab + o10 + C + c) * t1;
              gb0 = fmaf(gf, q0, gb0);
              gb1 = fmaf(gf, q1, gb1);
              ge0 = fmaf(ldbf(tab + ol + c), gl, ge0);
              ge1 = fmaf(ldbf(tab + ol + C + c), gl, ge1);
            }
          }
        }
        if constexpr (kGx) {
          const float sc = (float)(P - 1) / (2.f * meta.bound);
          gx[a] += (ga0 * dl[a] + ga1 * dh[a]) * sc * inb[a];
          gx[b] += (gb0 * dl[b] + gb1 * dh[b]) * sc * inb[b];
          gx[e] += (ge0 * dl[e] + ge1 * dh[e]) * sc * inb[e];
        }
        row += C;
      }
    }
    if constexpr (kGx) {
      // the frequency features: gp = W0[freq rows] . bf16(g_h0); x itself,
      // then d sin(2^f x) = 2^f cos, d cos(2^f x) = -2^f sin (f32 stashes)
#pragma unroll
      for (int a = 0; a < 3; ++a) gx[a] += dot64(h, w0 + (row + a) * kHid);
      for (int fd = 0; fd < meta.freq_degree; ++fd) {
        const float sc = (float)(1 << fd);
        const int k = 3 + 6 * fd;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float gs = dot64(h, w0 + (row + k + a) * kHid);
          const float gc = dot64(h, w0 + (row + k + 3 + a) * kHid);
          gx[a] += sc * (gs * freq_t[(k + 3 + a) * kT + slot] - gc * freq_t[(k + a) * kT + slot]);
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) gx_out[a] = gx[a];
      // room in the compact list for this block's active samples
      if (slot == 0) list_base = atomicAdd(gxo.count, n_act);
    }
  } else if (slot < nt) {
    // an inactive slot inside the summed range: zeros
    const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
    for (int r = 0; r < L.n_grid; ++r) feat_t[r * kT + slot] = z;
    for (int r = 0; r < L.n_freq; ++r) freq_t[r * kT + slot] = 0.f;
    for (int k = 0; k < kHid; ++k) {
      gh0_s[slot * kRowF + k] = 0.f;
      r0_s[slot * kRowB + k] = z;
      ghc0_s[slot * kRowB + k] = z;
      rc0_s[slot * kRowB + k] = z;
      rc1_s[slot * kRowB + k] = z;
      ghc1_t[k * kT + slot] = z;
    }
    for (int j = 0; j < kSigOut; ++j) gh1_t[j * kT + slot] = z;
    for (int k = 0; k < kCin; ++k) cin_t[k * kT + slot] = z;
    for (int c = 0; c < 3; ++c) ghc2_t[c * kT + slot] = z;
  }
  __syncthreads();
  if constexpr (kGx) {
    if (active) {  // slot < n_act: the active samples come first
      const long long pos = (long long)list_base + slot;
      gxo.idx[pos] = (int)i;
#pragma unroll
      for (int a = 0; a < 3; ++a) gxo.gx[a * m + pos] = gx_out[a];
    }
  }

  // ---- weight gradients: thread tid owns column tid of every matrix ----
  float col[kT];
  // w0 [feat, 64]: grid rows on bf16(g_h0), frequency rows in f32
#pragma unroll
  for (int t = 0; t < kT; ++t) col[t] = t < nt ? bf16r(gh0_s[t * kRowF + tid]) : 0.f;
  reduce_rows(feat_t, L.n_grid, col, nt, g_w + meta.w_off[0], kHid, 1);
#pragma unroll
  for (int t = 0; t < kT; ++t) col[t] = t < nt ? gh0_s[t * kRowF + tid] : 0.f;
  reduce_rows_f32(freq_t, L.n_freq, col, nt, g_w + meta.w_off[0] + L.n_grid * kHid, kHid);
  // w1^T [16, 64]: [j][k] = sum_t g_h1[t][j] r0[t][k]
  load_col_bf16(r0_s, nt, col);
  reduce_rows(gh1_t, kSigOut, col, nt, g_w + meta.w_off[1], kHid, 1);
  // wc0 [31, 64]: [k][j] = sum_t cin[t][k] g_hc0[t][j]
  load_col_bf16(ghc0_s, nt, col);
  reduce_rows(cin_t, kCin, col, nt, g_w + meta.w_off[2], kHidC, 1);
  // wc1^T [64, 64]: [j][k] = sum_t g_hc1[t][j] rc0[t][k]
  load_col_bf16(rc0_s, nt, col);
  reduce_rows(ghc1_t, kHidC, col, nt, g_w + meta.w_off[3], kHidC, 1);
  // wc2 [64, 3]: [j][c] = sum_t rc1[t][j] g_hc2[t][c]
  load_col_bf16(rc1_s, nt, col);
  reduce_rows(ghc2_t, 3, col, nt, g_w + meta.w_off[4], 1, 3);
}


// Lay out the stashes behind the weights, and launch the backward over m
// samples on `stream`. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a configuration whose stashes do not fit a block's shared memory.
template <bool kGx>
inline int launch_field_bwd(const float* x3, const float* d3, const float* g_out, long long m,
                            const __nv_bfloat16* tab, const __nv_bfloat16* wbuf,
                            const FieldMeta& fm, float* g_tab, float* g_w, const GxOut& gxo,
                            cudaStream_t stream) {
  BwdLayout L;
  L.n_freq = 3 + 6 * fm.freq_degree;
  L.n_grid = 0;
  for (int s = 0; s < fm.n_scales; ++s) L.n_grid += fm.rank[s];
  for (int s = 0; s < fm.n_planes; ++s) L.n_grid += 3 * fm.pch[s];
  if (L.n_grid + L.n_freq != fm.feat_dim) return (int)cudaErrorInvalidValue;
  unsigned off = (unsigned)fm.w_elems * 2u;  // the weights come first
  auto take = [&off](unsigned bytes) {
    const unsigned at = off;
    off += (bytes + 15u) & ~15u;
    return at;
  };
  L.feat_t = take(L.n_grid * kT * 2u);
  L.freq_t = take(L.n_freq * kT * 4u);
  L.gh0 = take(kT * kRowF * 4u);
  L.r0 = take(kT * kRowB * 2u);
  L.gh1_t = take(kSigOut * kT * 2u);
  L.cin_t = take(kCin * kT * 2u);
  L.ghc0 = take(kT * kRowB * 2u);
  L.rc0 = take(kT * kRowB * 2u);
  L.ghc1_t = take(kHidC * kT * 2u);
  L.rc1 = take(kT * kRowB * 2u);
  L.ghc2_t = take(3 * kT * 2u);
  L.total = off;
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(field_bwd_kernel<kGx>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (m + kT - 1) / kT;
  if (blocks < 1) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  field_bwd_kernel<kGx><<<(unsigned)blocks, kT, L.total, stream>>>(
      x3, d3, g_out, m, tab, wbuf, fm, L, g_tab, g_w, gxo);
  return (int)cudaGetLastError();
}

}  // namespace sdn
