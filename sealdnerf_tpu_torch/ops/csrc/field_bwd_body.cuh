// The canonical CP/VM field backward: the kernel that the static backward
// (field_bwd.cu) and the dynamic backward (dyn_field_bwd.cu) share, and the
// small kernel that compacts the samples with a cotangent ahead of it. See
// field_bwd.cu for the rounding points. With kGx the kernel also computes
// d(loss)/d(position) of each sample, routed through the line scales and
// planes with res <= cutoff and through the frequency features (the
// coarse-only warp gradient of the dynamic field).
//
// Design: a warp per tile of 16 samples, everything of a sample in registers.
//
//   Compaction. compact_live_kernel writes the indices of the samples whose
//   four cotangents are not all zero to a list (ballot and prefix count per
//   warp, one atomicAdd per warp for its place; the list's order is free).
//   The body's warps walk the list, so no row of a tile is dead but those past
//   its end. The dynamic entry compacts before it warps, so its warp kernel
//   runs over the listed samples only.
//
//   Recompute. The forward of a tile IS the forward kernel's arithmetic: the
//   device functions of field_fwd_body.cuh (first_product with its 16-byte
//   gathers into A fragments, sigma_output, color_input, color_product,
//   color_output) on the wfwd buffer in TileLayout order. The f32
//   pre-activations in the accumulators are the forward's bit for bit, and
//   their signs are kept as one bit each (three 32-bit masks a thread); the
//   relu'd bf16 activations are kept as A fragments (56 registers). For
//   checks the kernel can leave the forward's output it recomputed (rec_out).
//
//   Chain. g_hc2 -> g_hc1 -> g_hc0 -> g_h1 -> g_h0 are products with the
//   matrices' transposes as B operands, packed once per parameter version
//   into wbwd (fragment order, see TileLayout). A product's f32 sums, masked
//   and rounded to bf16, are the next product's A fragments. trunc_exp's
//   clamped gradient and the sigmoid's stay per element.
//
//   Weight gradients. An outer product contracts over the tile's 16 samples,
//   which is one k-step of mma.m16n8k16. Its operands are the transposes of
//   fragments the thread already holds: movmatrix.m8n8.trans turns the 8x8
//   quarters of an A fragment (samples x columns) into the A operand (columns
//   x samples) and into the B operand (samples x columns, column-major). A
//   block keeps the partial sums of all five matrices in shared memory, in
//   C-fragment order (one float4 a thread and 16x8 unit, no bank conflicts),
//   across ALL its tiles; a warp adds a unit row under a spin lock of that row
//   (shared-memory float atomics are compare-and-swap loops; a lock around
//   plain float4 read-modify-writes costs the shared-memory bandwidth only).
//   At the end the block adds its sums to g_w once. The frequency rows of the
//   first matrix, which the reference sums from f32 operands, take both
//   operands as hi + lo bf16 pairs: the features already are (the forward's
//   layout), and g_h0 enters once as bf16(g) and once as bf16(g - bf16(g)).
//
//   Table gradients. The first product's gradient g_feat = bf16(g_h0) W0^T
//   comes k-block by k-block with W0^T's columns ordered so that the C
//   fragment of thread t holds the eight neighbouring ranks of ITS segment.
//   The taps are gathered again (one 16-byte load a tap row), the factors
//   recomputed, and a tap row's eight f32 gradients go out as two 16-byte
//   vector atomics (atomicAdd on float4, red.global.add.v4.f32 on sm_90).
//   g_x is summed from the same taps, per thread and then over the quad.
//
// Shared memory: wfwd, wbwd and the partial sums: 16 KB a k-block plus 60
// KB, 220 KB at the default widths (10 k-blocks): one block of 12 warps an
// SM. With more k-blocks (up to the forward's 16) that does not fit: the
// first matrix and its transpose, 8 KB a k-block, then stay in device memory
// (they are read through L2, 128 KB a tile at 16 k-blocks) and the rest takes
// 8 KB a k-block plus 60 KB, 188 KB at 16.

#pragma once

#include "field_fwd_body.cuh"

namespace sdn {

constexpr int kBwdBlock = 384;  // threads of a block of the backward body
constexpr int kBwdWarps = kBwdBlock / 32;
constexpr size_t kMaxSmem = 232448;  // per block on sm_90
constexpr int kMaxLocks = 2 * kMaxBlocks + 14;

// The transposed matrices (wbwd), each in B-fragment order: offsets in bf16
// elements. w0t [64, 32 n_blocks] | w1t [16, 64] | wc0t [64, 16] (geo rows,
// column 0 zero) | wc1t [64, 64] | wc2t [16, 64] (rows 3.. zero).
struct BwdMeta {
  int wb_elems;
  int wb_off[5];
  int w0_staged;  // set by launch_field_bwd: w0 and w0t are in shared memory too
};

// The weight-gradient buffer g_w (FieldMeta.w_off, w_elems; f32, row-major):
// w0 [32 n_blocks, 64] with the rows in the A fragments' order | w1 [64, 16] |
// wc0 [32, 64] in the colour input's order | wc1 [64, 64] | wc2 [64, 8].
// A block's partial sums hold the same entries in units of 16 rows x 8
// columns, C-fragment order, matrix after matrix; unit_nt(k) is matrix k's
// units a 16-row tile (its columns / 8).
__device__ __forceinline__ int unit_nt(int k) { return k == 1 ? 2 : (k == 4 ? 1 : 8); }

// Where the kGx kernel puts d(loss)/d(position): gx [3, m], column k for the
// k-th sample of the list. cutoff: line scales and planes with res <= cutoff
// back-drive the position.
struct GxOut {
  int cutoff;
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

__device__ __forceinline__ void red_add(float* p, float v) {
  if (v != 0.f) atomicAdd(p, v);
}

// p[0:8] += v[0:8]; p is 16-byte aligned
__device__ __forceinline__ void red_add8(float* p, const float* v) {
  if (v[0] != 0.f || v[1] != 0.f || v[2] != 0.f || v[3] != 0.f)
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  if (v[4] != 0.f || v[5] != 0.f || v[6] != 0.f || v[7] != 0.f)
    atomicAdd(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}

// ---------------------------------------------------------------------------
// The list of samples that carry a cotangent: idx[0 .. *count), any order.
// *count starts at 0.
static __global__ void compact_live_kernel(const float* __restrict__ g_out, long long m,
                                           int* __restrict__ count, int* __restrict__ idx) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  bool live = false;
  if (i < m)
    live = g_out[i] != 0.f || g_out[m + i] != 0.f || g_out[2 * m + i] != 0.f ||
           g_out[3 * m + i] != 0.f;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  int base = 0;
  if (lane == 0 && ballot != 0u) base = atomicAdd(count, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (live) idx[base + __popc(ballot & ((1u << lane) - 1u))] = (int)i;
}

inline int launch_compact(const float* g_out, long long m, int* count, int* idx,
                          cudaStream_t stream) {
  const long long blocks = (m + 255) / 256;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  compact_live_kernel<<<(unsigned)blocks, 256, 0, stream>>>(g_out, m, count, idx);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Fragment helpers.

// The transpose of an 8x8 b16 matrix held one 32-bit register a thread (row
// lane / 4, columns 2 (lane % 4) and the next); every lane of the warp calls.
__device__ __forceinline__ uint32_t movm(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// An A fragment [16 samples, 16 columns] as the A operand of the product
// that contracts over the samples: [16 columns, 16 samples].
__device__ __forceinline__ void transpose_a(const uint32_t* a, uint32_t* at) {
  at[0] = movm(a[0]);
  at[1] = movm(a[2]);
  at[2] = movm(a[1]);
  at[3] = movm(a[3]);
}

// The A fragments of a [16, 64] matrix (four k-steps) as the B operands of
// that product: bt[n] for the n-th tile of eight columns.
__device__ __forceinline__ void transpose_b(const uint32_t (*a)[4], uint32_t (*bt)[2]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    bt[2 * ks][0] = movm(a[ks][0]);
    bt[2 * ks][1] = movm(a[ks][1]);
    bt[2 * ks + 1][0] = movm(a[ks][2]);
    bt[2 * ks + 1][1] = movm(a[ks][3]);
  }
}

// One bit a pre-activation of a [16, 64] product: bit 4 n + c is acc[n][c] > 0
__device__ __forceinline__ uint32_t relu_mask(const float (*acc)[4]) {
  uint32_t mask = 0u;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) mask |= (acc[n][c] > 0.f ? 1u : 0u) << (4 * n + c);
  return mask;
}

__device__ __forceinline__ void apply_mask(float (*acc)[4], uint32_t mask) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = ((mask >> (4 * n + c)) & 1u) ? acc[n][c] : 0.f;
}

// bf16 of a [16, 64] f32 product as the A fragments of the next one
__device__ __forceinline__ void pack_fragments(const float (*acc)[4], uint32_t (*a)[4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = pack_bf16(acc[2 * ks][0], acc[2 * ks][1]);
    a[ks][1] = pack_bf16(acc[2 * ks][2], acc[2 * ks][3]);
    a[ks][2] = pack_bf16(acc[2 * ks + 1][0], acc[2 * ks + 1][1]);
    a[ks][3] = pack_bf16(acc[2 * ks + 1][2], acc[2 * ks + 1][3]);
  }
}

// A spin lock in shared memory, taken by a whole warp.
__device__ __forceinline__ void lock_acquire(int* lock) {
  if ((threadIdx.x & 31) == 0) {
    while (atomicCAS(lock, 0, 1) != 0) {
    }
    __threadfence_block();
  }
  __syncwarp();
}

__device__ __forceinline__ void lock_release(int* lock) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();
    atomicExch(lock, 0);
  }
}

// units[n] += at x bt[n] (+ at x bt2[n]) for the NT units of one 16-row tile
// of a weight gradient; units points at this lane's float4 of the first.
template <int NT, bool kTwo>
__device__ __forceinline__ void outer_tile(float4* units, int* lock, const uint32_t* a,
                                           const uint32_t (*bt)[2], const uint32_t (*bt2)[2]) {
  uint32_t at[4];
  transpose_a(a, at);
  float c[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
    mma_bf16(c[n], at, bt[n][0], bt[n][1]);
    if (kTwo) mma_bf16(c[n], at, bt2[n][0], bt2[n][1]);
  }
  lock_acquire(lock);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float4 v = units[n * 32];
    v.x += c[n][0]; v.y += c[n][1]; v.z += c[n][2]; v.w += c[n][3];
    units[n * 32] = v;
  }
  lock_release(lock);
}

// ---------------------------------------------------------------------------
// Table gradients of one sample's segment. gfe[e] is the cotangent of the
// segment's e-th feature. With kGx, gx[a] gains the position gradient through
// this segment when `drive` (res <= cutoff); inb[a] is 1 inside |x| < bound.

template <bool kGx>
__device__ __forceinline__ void line_scatter(const Seg& sg, const __nv_bfloat16* __restrict__ tab,
                                             float* __restrict__ g_tab, const float* x01,
                                             const float* gfe, bool drive, const float* inb,
                                             float bound, float* gx) {
  LineTaps tp;
  line_taps(sg, tab, x01, tp);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int a1 = (a + 1) % 3, a2 = (a + 2) % 3;
    float dl = 0.f, dh = 0.f, gsum = 0.f;
    if (kGx && drive) hat_slope(x01[a], sg.res, tp.i0[a], dl, dh);
    float vl[8], vh[8];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float other = __fmul_rn(line_lerp(tp, a1, c, h), line_lerp(tp, a2, c, h));
        const float gfr = gfe[2 * c + h] * other;
        const float gf = bf16r(gfr);
        vl[2 * c + h] = gf * tp.wl[a];
        vh[2 * c + h] = gf * tp.wh[a];
        if (kGx && drive) {
          const float lo = h ? bf_hi(tp.lo[a][c]) : bf_lo(tp.lo[a][c]);
          const float hi = h ? bf_hi(tp.hi[a][c]) : bf_lo(tp.hi[a][c]);
          gsum = fmaf(gfr, dl * lo + dh * hi, gsum);
        }
      }
    float* g = g_tab + sg.off[a] + (long long)tp.i0[a] * sg.stride;
    red_add8(g, vl);
    red_add8(g + sg.stride, vh);
    if (kGx && drive) gx[a] += gsum * ((float)(sg.res - 1) / (2.f * bound)) * inb[a];
  }
}

template <bool kGx>
__device__ __forceinline__ void plane_scatter(const Seg& sg, const __nv_bfloat16* __restrict__ tab,
                                              float* __restrict__ g_tab, const float* x01,
                                              const float* gfe, bool drive, const float* inb,
                                              float bound, float* gx) {
  PlaneTaps tp;
  plane_taps(sg, tab, x01, tp);
  const int P = sg.res, C = sg.stride;
  float* g00 = g_tab + sg.off[0] + ((long long)tp.ia * P + tp.ib) * C;
  float* gl0 = g_tab + sg.off[1] + (long long)tp.ie * C;
  // cotangents of the two hat taps of each of the pair's three axes
  float ga0 = 0.f, ga1 = 0.f, gb0 = 0.f, gb1 = 0.f, ge0 = 0.f, ge1 = 0.f;
  float v00[8], v01[8], v10[8], v11[8], vl0[8], vl1[8];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 2 * c + h;
      float q0, q1, fv, lv;
      plane_channel(tp, c, h, q0, q1, fv, lv);
      const float g_vm = gfe[e];
      const float gl = bf16r(g_vm * fv);
      vl0[e] = gl * tp.le;
      vl1[e] = gl * tp.he;
      const float gf = g_vm * lv;
      const float t0 = bf16r(gf * tp.lb), t1 = bf16r(gf * tp.hb);
      v00[e] = tp.la * t0;
      v10[e] = tp.ha * t0;
      v01[e] = tp.la * t1;
      v11[e] = tp.ha * t1;
      if (kGx && drive) {
        const float a00 = h ? bf_hi(tp.t00[c]) : bf_lo(tp.t00[c]);
        const float a01 = h ? bf_hi(tp.t01[c]) : bf_lo(tp.t01[c]);
        const float a10 = h ? bf_hi(tp.t10[c]) : bf_lo(tp.t10[c]);
        const float a11 = h ? bf_hi(tp.t11[c]) : bf_lo(tp.t11[c]);
        const float b0 = h ? bf_hi(tp.v0[c]) : bf_lo(tp.v0[c]);
        const float b1 = h ? bf_hi(tp.v1[c]) : bf_lo(tp.v1[c]);
        ga0 += a00 * t0 + a01 * t1;
        ga1 += a10 * t0 + a11 * t1;
        gb0 = fmaf(gf, q0, gb0);
        gb1 = fmaf(gf, q1, gb1);
        ge0 = fmaf(b0, gl, ge0);
        ge1 = fmaf(b1, gl, ge1);
      }
    }
  red_add8(g00, v00);
  red_add8(g00 + C, v01);
  red_add8(g00 + (long long)P * C, v10);
  red_add8(g00 + (long long)P * C + C, v11);
  red_add8(gl0, vl0);
  red_add8(gl0 + C, vl1);
  if (kGx && drive) {
    const int p = sg.sub, a = plane_axis_a(p), b = plane_axis_b(p), e = plane_axis_e(p);
    const float xa = p == 2 ? x01[1] : x01[0];
    const float xb = p == 0 ? x01[1] : x01[2];
    const float xe = p == 0 ? x01[2] : (p == 1 ? x01[1] : x01[0]);
    float dl, dh;
    const float sc = (float)(P - 1) / (2.f * bound);
    hat_slope(xa, P, tp.ia, dl, dh);
    const float da = (ga0 * dl + ga1 * dh) * sc;
    hat_slope(xb, P, tp.ib, dl, dh);
    const float db = (gb0 * dl + gb1 * dh) * sc;
    hat_slope(xe, P, tp.ie, dl, dh);
    const float de = (ge0 * dl + ge1 * dh) * sc;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gx[k] += ((k == a ? da : 0.f) + (k == b ? db : 0.f) + (k == e ? de : 0.f)) * inb[k];
  }
}

// The position gradient through a frequency segment: x itself, then
// d sin(2^f x) = 2^f cos, d cos(2^f x) = -2^f sin. A value's hi and lo columns
// meet the same weight row, so gfe[2 c] is the cotangent of value c.
__device__ __forceinline__ void freq_gx(const Seg& sg, int freq_degree, const float* xyz,
                                        const float* gfe, float* gx) {
  if (sg.sub == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) gx[a] += gfe[2 * a];
    return;
  }
  float v[4];
  freq_values(sg, freq_degree, xyz, v);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = 2 * (sg.sub - 1) + h;
    if (u < 3 * freq_degree) {
      const int fd = u / 3, ax = u - 3 * fd;
      const float d = (float)(1 << fd) * (gfe[4 * h] * v[2 * h + 1] - gfe[4 * h + 2] * v[2 * h]);
#pragma unroll
      for (int k = 0; k < 3; ++k) gx[k] += k == ax ? d : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// Persistent blocks of kBwdWarps warps; consecutive warps take consecutive
// tiles of the list. x3 holds the positions the field is evaluated at (the
// warped ones for the dynamic entry; only the listed columns are read).
// rec_out, null or [4, m] for checks, receives the forward's rows (sigma, r,
// g, b) that the kernel recomputed at the listed samples, to be held against
// the forward kernel's bit for bit.
template <bool kGx>
static __global__ void __launch_bounds__(kBwdBlock, 1)
field_bwd_kernel(const float* __restrict__ x3, const float* __restrict__ d3,
                 const float* __restrict__ g_out, long long m, const int* __restrict__ count,
                 const int* __restrict__ list, const __nv_bfloat16* __restrict__ tab,
                 const __nv_bfloat16* __restrict__ wfwd, const __nv_bfloat16* __restrict__ wbwd,
                 const __grid_constant__ FieldMeta meta, const __grid_constant__ TileMeta tm,
                 const BwdMeta bm, float* __restrict__ g_tab, float* __restrict__ g_w,
                 const GxOut gxo, float* __restrict__ rec_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the first matrix and its transpose lead their buffers: staged with the
  // rest, or left in device memory (BwdMeta.w0_staged)
  const int skip = bm.w0_staged ? 0 : tm.w_off[1] / 8;
  const int skip_t = bm.w0_staged ? 0 : bm.wb_off[1] / 8;
  uint4* ws = reinterpret_cast<uint4*>(smem_raw);
  uint4* wbs = ws + (tm.w_elems / 8 - skip);
  float4* sums = reinterpret_cast<float4*>(wbs + (bm.wb_elems / 8 - skip_t));
  int* locks = reinterpret_cast<int*>(sums + meta.w_elems / 4);
  const int n = *count;
  if (n == 0) return;
  const uint4* wf = reinterpret_cast<const uint4*>(wfwd);
  const uint4* wt = reinterpret_cast<const uint4*>(wbwd);
  for (int i = threadIdx.x; i < tm.w_elems / 8 - skip; i += blockDim.x) ws[i] = wf[skip + i];
  for (int i = threadIdx.x; i < bm.wb_elems / 8 - skip_t; i += blockDim.x) wbs[i] = wt[skip_t + i];
  for (int i = threadIdx.x; i < meta.w_elems / 4; i += blockDim.x)
    sums[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x < kMaxLocks) locks[threadIdx.x] = 0;
  __syncthreads();
  const TileWeights w = {bm.w0_staged ? ws : wf, ws + (tm.w_off[1] / 8 - skip),
                         ws + (tm.w_off[2] / 8 - skip), ws + (tm.w_off[3] / 8 - skip),
                         ws + (tm.w_off[4] / 8 - skip)};
  const uint4* w0t = bm.w0_staged ? wbs : wt;
  const uint4* w1t = wbs + (bm.wb_off[1] / 8 - skip_t);
  const uint4* wc0t = wbs + (bm.wb_off[2] / 8 - skip_t);
  const uint4* wc1t = wbs + (bm.wb_off[3] / 8 - skip_t);
  const uint4* wc2t = wbs + (bm.wb_off[4] / 8 - skip_t);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nb = tm.n_blocks;
  // first unit (as this lane's float4) and first lock of each matrix
  float4* const u_w0 = sums + lane;
  float4* const u_w1 = u_w0 + 16 * nb * 32;
  float4* const u_wc0 = u_w1 + 8 * 32;
  float4* const u_wc1 = u_wc0 + 16 * 32;
  float4* const u_wc2 = u_wc1 + 32 * 32;
  int* const l_w1 = locks + 2 * nb;
  int* const l_wc0 = l_w1 + 4;
  int* const l_wc1 = l_wc0 + 2;
  int* const l_wc2 = l_wc1 + 4;

  const int tiles = (n + kTileRows - 1) / kTileRows;
  for (int tile = blockIdx.x * kBwdWarps + warp; tile < tiles; tile += gridDim.x * kBwdWarps) {
    float xyz[2][3], x01[2][3], go[2][4];
    long long idx[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = tile * kTileRows + g + 8 * j;
      const bool live = k < n;
      idx[j] = live ? list[k] : -1;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        xyz[j][a] = live ? x3[a * m + idx[j]] : 0.f;
        x01[j][a] = unit01(xyz[j][a], meta.bound);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) go[j][r] = live ? g_out[r * m + idx[j]] : 0.f;
    }

    // ---- the forward, as the forward kernel computes it ----
    float acc[8][4];
    first_product(meta, tm, tab, w, xyz, x01, idx, 0, nullptr, acc);
    const uint32_t mask0 = relu_mask(acc);
    uint32_t r0[4][4];
    relu_fragments(acc, r0);
    float o[2][4];
    sigma_output(w, r0, 0, o);
    uint32_t cin[2][4];
    color_input(meta, d3, m, idx, o, cin);
    color_product<2>(w.wc0, cin, acc);
    const uint32_t maskc0 = relu_mask(acc);
    uint32_t rc0[4][4];
    relu_fragments(acc, rc0);
    color_product<4>(w.wc1, rc0, acc);
    const uint32_t maskc1 = relu_mask(acc);
    uint32_t rc1[4][4];
    relu_fragments(acc, rc1);
    float lg[4];
    color_output(w, rc1, lg);
    if (rec_out != nullptr) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (idx[j] >= 0 && t < 2) {
          if (t == 0) rec_out[idx[j]] = expf(o[0][2 * j]);
          rec_out[(2 * t + 1) * m + idx[j]] = sigmoidf(lg[2 * j]);
          if (t == 0) rec_out[2 * m + idx[j]] = sigmoidf(lg[2 * j + 1]);
        }
      }
    }

    // ---- the chain; each weight gradient as soon as its operands exist ----
    uint32_t ga[4][4], bt[8][2];
    {
      // g_hc2 = g_rgb rgb (1 - rgb), [16, 16]: columns (r, g) in t == 0, b in t == 1
      float g2[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < 2) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float c0 = sigmoidf(lg[2 * j]);
          g2[2 * j] = go[j][t == 0 ? 1 : 3] * c0 * (1.f - c0);
          if (t == 0) {
            const float c1 = sigmoidf(lg[2 * j + 1]);
            g2[2 * j + 1] = go[j][2] * c1 * (1.f - c1);
          }
        }
      }
      const uint32_t g2a[4] = {pack_bf16(g2[0], g2[1]), pack_bf16(g2[2], g2[3]), 0u, 0u};
      uint32_t b2[1][2] = {{movm(g2a[0]), movm(g2a[1])}};
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        outer_tile<1, false>(u_wc2 + mt * 32, l_wc2 + mt, rc1[mt], b2, b2);
      // g_hc1 = (g_hc2 Wc2^T) [hc1 > 0]
      zero_acc(acc);
      mma_step<4>(acc, g2a, wc2t + lane);
    }
    apply_mask(acc, maskc1);
    pack_fragments(acc, ga);
    transpose_b(ga, bt);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      outer_tile<8, false>(u_wc1 + mt * 8 * 32, l_wc1 + mt, rc0[mt], bt, bt);
    // g_hc0 = (g_hc1 Wc1^T) [hc0 > 0]
    zero_acc(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma_step<4>(acc, ga[ks], wc1t + ks * 128 + lane);
    apply_mask(acc, maskc0);
    pack_fragments(acc, ga);
    transpose_b(ga, bt);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      outer_tile<8, false>(u_wc0 + mt * 8 * 32, l_wc0 + mt, cin[mt], bt, bt);
    // g_h1 = (trunc_exp's gradient, g_hc0 Wc0[geo rows]^T), [16, 16]
    uint32_t gh1a[4];
    {
      float gh1[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) gh1[q][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint4 bw = wc0t[ks * 32 + lane];
        mma_bf16(gh1[0], ga[ks], bw.x, bw.y);
        mma_bf16(gh1[1], ga[ks], bw.z, bw.w);
      }
      if (t == 0) {
        gh1[0][0] = go[0][0] * expf(fminf(fmaxf(o[0][0], -15.f), 15.f));
        gh1[0][2] = go[1][0] * expf(fminf(fmaxf(o[0][2], -15.f), 15.f));
      }
      gh1a[0] = pack_bf16(gh1[0][0], gh1[0][1]);
      gh1a[1] = pack_bf16(gh1[0][2], gh1[0][3]);
      gh1a[2] = pack_bf16(gh1[1][0], gh1[1][1]);
      gh1a[3] = pack_bf16(gh1[1][2], gh1[1][3]);
      uint32_t b1[2][2] = {{movm(gh1a[0]), movm(gh1a[1])}, {movm(gh1a[2]), movm(gh1a[3])}};
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        outer_tile<2, false>(u_w1 + mt * 2 * 32, l_w1 + mt, r0[mt], b1, b1);
    }
    // g_h0 = (g_h1 W1^T) [h0 > 0], f32; bf16(g_h0) into the products, and for
    // the frequency rows also bf16(g_h0 - bf16(g_h0))
    zero_acc(acc);
    mma_step<4>(acc, gh1a, w1t + lane);
    apply_mask(acc, mask0);
    pack_fragments(acc, ga);
    transpose_b(ga, bt);
    uint32_t bt_lo[8][2];
    {
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[nn][c] = __fsub_rn(acc[nn][c], bf16r(acc[nn][c]));
      uint32_t lo[4][4];
      pack_fragments(acc, lo);
      transpose_b(lo, bt_lo);
    }

    // ---- k-block by k-block: g_feat, the first matrix's gradient, scatter ----
    float gx[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}}, inb[2][3];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int a = 0; a < 3; ++a) inb[j][a] = fabsf(xyz[j][a]) < meta.bound ? 1.f : 0.f;
    for (int b = 0; b < nb; ++b) {
      const Seg& sg = tm.seg[4 * b + t];
      const int kind = tm.blk_kind[b];
      const bool on = segment_on(sg, 0);
      uint32_t q[2][4], a[2][4];
      block_features(meta, kind, sg, on, tab, xyz, x01, q, a);
      if (kind == kSegFreq) {
        outer_tile<8, true>(u_w0 + (2 * b) * 8 * 32, locks + 2 * b, a[0], bt, bt_lo);
        outer_tile<8, true>(u_w0 + (2 * b + 1) * 8 * 32, locks + 2 * b + 1, a[1], bt, bt_lo);
      } else {
        outer_tile<8, false>(u_w0 + (2 * b) * 8 * 32, locks + 2 * b, a[0], bt, bt);
        outer_tile<8, false>(u_w0 + (2 * b + 1) * 8 * 32, locks + 2 * b + 1, a[1], bt, bt);
      }
      if (kGx || kind != kSegFreq) {  // block-uniform
        // g_feat = bf16(g_h0) W0^T: n-tile i of the block holds elements 2 i,
        // 2 i + 1 of this thread's segment, rows g (c0, c1) and g + 8 (c2, c3)
        float gf[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) gf[i][c] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint4* wk = w0t + (ks * 2 * nb + 2 * b) * 32 + lane;
          const uint4 b0 = wk[0], b1 = wk[32];
          mma_bf16(gf[0], ga[ks], b0.x, b0.y);
          mma_bf16(gf[1], ga[ks], b0.z, b0.w);
          mma_bf16(gf[2], ga[ks], b1.x, b1.y);
          mma_bf16(gf[3], ga[ks], b1.z, b1.w);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (on && idx[j] >= 0) {
            float gfe[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              gfe[2 * i] = gf[i][2 * j];
              gfe[2 * i + 1] = gf[i][2 * j + 1];
            }
            const bool drive = kGx && sg.res <= gxo.cutoff;
            if (kind == kSegLine)
              line_scatter<kGx>(sg, tab, g_tab, x01[j], gfe, drive, inb[j], meta.bound, gx[j]);
            else if (kind == kSegPlane)
              plane_scatter<kGx>(sg, tab, g_tab, x01[j], gfe, drive, inb[j], meta.bound, gx[j]);
            else if (kGx)
              freq_gx(sg, meta.freq_degree, xyz[j], gfe, gx[j]);
          }
        }
      }
      __syncwarp();
    }
    if (kGx) {
      // the four threads of a quad hold the segments of the same two samples
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float v = gx[j][a];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          const int k = tile * kTileRows + g + 8 * j;
          if (t == 0 && k < n) gxo.gx[a * m + k] = v;
        }
    }
  }

  // ---- the block's sums into g_w, once ----
  __syncthreads();
  const int n_units = meta.w_elems / 128;
  for (int u = warp; u < n_units; u += kBwdWarps) {
    int k = 0, first = 0;  // the unit's matrix and that matrix's first unit
    const int ends[5] = {16 * nb, 16 * nb + 8, 16 * nb + 24, 16 * nb + 56, 16 * nb + 60};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (u >= ends[i]) {
        k = i + 1;
        first = ends[i];
      }
    const int nt = unit_nt(k), mt = (u - first) / nt, ct = (u - first) - mt * nt;
    const float4 v = sums[u * 32 + lane];
    float* p = g_w + meta.w_off[k] + (long long)(16 * mt + g) * (8 * nt) + 8 * ct + 2 * t;
    red_add(p, v.x);
    red_add(p + 1, v.y);
    red_add(p + 8 * (8 * nt), v.z);
    red_add(p + 8 * (8 * nt) + 1, v.w);
  }
}

// The block's shared memory with (w0_staged) or without the first matrix and
// its transpose.
inline size_t field_bwd_smem(const FieldMeta& fm, const TileMeta& tm, const BwdMeta& bm,
                             bool w0_staged) {
  const int held = w0_staged ? 0 : tm.w_off[1] + bm.wb_off[1];
  return (size_t)(tm.w_elems + bm.wb_elems - held) * sizeof(__nv_bfloat16) +
         (size_t)fm.w_elems * sizeof(float) + kMaxLocks * sizeof(int);
}

// Launch the backward body over the listed samples on `stream`. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a configuration whose
// operands do not fit a block's shared memory.
template <bool kGx>
inline int launch_field_bwd(const float* x3, const float* d3, const float* g_out, long long m,
                            const int* count, const int* list, const __nv_bfloat16* tab,
                            const __nv_bfloat16* wfwd, const __nv_bfloat16* wbwd,
                            const FieldMeta& fm, const TileMeta& tm, BwdMeta bm,
                            float* g_tab, float* g_w, const GxOut& gxo, float* rec_out,
                            cudaStream_t stream) {
  if (tm.w_off[0] != 0 || bm.wb_off[0] != 0) return (int)cudaErrorInvalidValue;
  bm.w0_staged = field_bwd_smem(fm, tm, bm, true) <= kMaxSmem;
  const size_t smem = field_bwd_smem(fm, tm, bm, bm.w0_staged);
  if (smem > kMaxSmem || fm.w_elems != 2048 * tm.n_blocks + 7680) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(field_bwd_kernel<kGx>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = ((m + kTileRows - 1) / kTileRows + kBwdWarps - 1) / kBwdWarps;
  if (blocks > n_sm) blocks = n_sm;
  if (blocks < 1) blocks = 1;
  field_bwd_kernel<kGx><<<(unsigned)blocks, kBwdBlock, smem, stream>>>(
      x3, d3, g_out, m, count, list, tab, wfwd, wbwd, fm, tm, bm, g_tab, g_w, gxo, rec_out);
  return (int)cudaGetLastError();
}

// The backward's tail of `meta`, behind the forward kernels' tile layout:
// wb_elems, wb_off[5] (bf16 elements into wbwd).
inline int fill_bwd_meta(const long long* meta, const FieldMeta& fm, const TileMeta& tm,
                         BwdMeta* out) {
  const long long* q = meta + 10 + 5 * fm.n_scales + 8 * fm.n_planes + 7 + 29 * tm.n_blocks;
  BwdMeta bm = {};
  bm.wb_elems = (int)q[0];
  if (bm.wb_elems < 1 || bm.wb_elems % 8 != 0) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 5; ++k) {
    bm.wb_off[k] = (int)q[1 + k];
    if (bm.wb_off[k] % 8 != 0) return (int)cudaErrorInvalidValue;
  }
  *out = bm;
  return 0;
}

}  // namespace sdn
