// The forward kernels' body (field_fwd.cu, dyn_field_fwd.cu): the canonical
// field over a tile of 16 samples (field_tile), the kernel that walks the
// tiles (field_fwd_kernel) and its launch. The static entry runs it at the
// given positions, the dynamic entry at the warped ones, so the two round
// alike and agree bit for bit at t == 0.

#pragma once

#include "field_common.cuh"

namespace sdn {

// ---------------------------------------------------------------------------
// The canonical field forward over a tile of 16 samples, one warp a tile
// (field_tile). Both forward kernels run it, so they round alike.
//
// The five tower products run on mma.sync.m16n8k16 (bf16 operands, f32 sums):
// a tile's 16 samples are the 16 rows of the A operand. In that instruction's
// fragment layout (g = lane / 4, t = lane % 4) a thread holds, of rows g and
// g + 8, the columns 2t, 2t+1, 2t+8, 2t+9 of every 16 columns, so the four
// threads of a quad share two samples. The order of a product's columns is
// free as long as the matrix's rows follow it, and pack_tables (ops/field.py)
// orders the first sigma matrix so that thread t's eight columns of a
// "k-block" of 32 are eight NEIGHBOURING ranks of one table: a segment. A
// thread therefore reads each tap row of its segment with one 16-byte load,
// a quad reads 64 contiguous bytes of the row, and the features it computes
// are already the A fragments of two mma steps: they never pass through
// shared memory. A layer's f32 sums, relu'd and rounded to bf16, are laid out
// as the next layer's A fragments, so the activations stay in registers too.
// Every matrix is stored in shared memory in B-fragment order
// [k-step][pair of n-tiles][lane], one 16-byte load per thread and pair.
//
// Segment kinds, four segments (one per t) a k-block, a block of one kind:
//   line:  ranks r0..r0+7 of line scale `sub`: two taps on each axis, lerped
//          with bf16-rounded hat weights (exact in f32), the product of the
//          three axes rounded to bf16: the arithmetic of the plain version;
//   plane: channels c0..c0+7 of VM pair `sub` of one plane scale: a four-tap
//          bilinear plane read times a two-tap line read, rounded to bf16,
//          with the plain version's roundings (no fused multiply-add where
//          a product is inexact);
//   freq:  xyz (sub 0) or two (sin, cos) pairs (sub > 0) of the frequency
//          encoding. The plain version and the Pallas kernel keep these 27
//          rows in f32; the tensor cores take bf16, so each value v enters as
//          two columns hi = bf16(v), lo = bf16(v - hi) against the same
//          weight row: hi + lo carries 16 bits of v's mantissa, the products
//          are exact and the sums f32, so the row's error is 2^-17 |v w|,
//          below the f32 sum's own reordering noise over 259 rows;
//   zero:  padding.
// The colour tower's input is [SH(d) (16) | the sigma tower's 16 outputs]: the
// outputs stay where the sigma product left them, and column 0 (the density
// logit) meets a zero row and is zeroed in the fragment.

constexpr int kSegZero = 0, kSegLine = 1, kSegPlane = 2, kSegFreq = 3;
constexpr int kMaxBlocks = 16;  // k-blocks of 32 columns of the first product
constexpr int kTileRows = 16;   // samples per warp tile

struct Seg {
  int kind, sub, res, stride;  // stride: the table's row length (rank or channels)
  int off[3];                  // line: x, y, z tables; plane: plane, VM line (+ r0 / c0)
};

struct TileMeta {
  int n_blocks, w_elems;
  int w_off[5];  // w0 [32 n_blocks, 64] | w1 [64, 16] | wc0 [32, 64] | wc1 [64, 64] | wc2 [64, 16]
  int blk_kind[kMaxBlocks];
  Seg seg[4 * kMaxBlocks];
};

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

__device__ __forceinline__ void ldg8(const __nv_bfloat16* p, uint32_t* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

// The five tower matrices in shared memory, each in B-fragment order.
struct TileWeights {
  const uint4 *w0, *w1, *wc0, *wc1, *wc2;
};

__device__ __forceinline__ TileWeights tile_weights(const __nv_bfloat16* ws, const TileMeta& tm) {
  const uint4* p = reinterpret_cast<const uint4*>(ws);
  return {p + tm.w_off[0] / 8, p + tm.w_off[1] / 8, p + tm.w_off[2] / 8, p + tm.w_off[3] / 8,
          p + tm.w_off[4] / 8};
}

// Copy the packed forward weights (w_elems bf16, a multiple of 8) to shared
// memory with the whole block; the caller synchronises.
__device__ __forceinline__ void stage_tile_weights(const __nv_bfloat16* wfwd, __nv_bfloat16* ws,
                                                   const TileMeta& tm) {
  const uint4* src = reinterpret_cast<const uint4*>(wfwd);
  uint4* dst = reinterpret_cast<uint4*>(ws);
  for (int i = threadIdx.x; i < tm.w_elems / 8; i += blockDim.x) dst[i] = src[i];
}

// acc[2 p], acc[2 p + 1] += a x (n-tile pair p of one k-step); wk points at
// this lane's entry of the k-step's first pair.
template <int NTP>
__device__ __forceinline__ void mma_step(float (*acc)[4], const uint32_t* a, const uint4* wk) {
#pragma unroll
  for (int p = 0; p < NTP; ++p) {
    const uint4 b = wk[p * 32];
    mma_bf16(acc[2 * p], a, b.x, b.y);
    mma_bf16(acc[2 * p + 1], a, b.z, b.w);
  }
}

// relu'd bf16 of a [16, 64] f32 product as the A fragments of the next one
__device__ __forceinline__ void relu_fragments(const float (*acc)[4], uint32_t (*a)[4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    a[ks][0] = pack_relu_bf16(acc[2 * ks][0], acc[2 * ks][1]);
    a[ks][1] = pack_relu_bf16(acc[2 * ks][2], acc[2 * ks][3]);
    a[ks][2] = pack_relu_bf16(acc[2 * ks + 1][0], acc[2 * ks + 1][1]);
    a[ks][3] = pack_relu_bf16(acc[2 * ks + 1][2], acc[2 * ks + 1][3]);
  }
}

// Eight line features of one sample: q[c] holds ranks r0 + 2c, r0 + 2c + 1.
__device__ __forceinline__ void line_segment(const Seg& sg, const __nv_bfloat16* __restrict__ tab,
                                             const float* x01, uint32_t* q) {
  uint32_t lo[3][4], hi[3][4];
  float wl[3], wh[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    int i0;
    hat(x01[a], sg.res, i0, wl[a], wh[a]);
    const __nv_bfloat16* p = tab + sg.off[a] + (long long)i0 * sg.stride;
    ldg8(p, lo[a]);
    ldg8(p + sg.stride, hi[a]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float fx0 = wl[0] * bf_lo(lo[0][c]) + wh[0] * bf_lo(hi[0][c]);
    const float fy0 = wl[1] * bf_lo(lo[1][c]) + wh[1] * bf_lo(hi[1][c]);
    const float fz0 = wl[2] * bf_lo(lo[2][c]) + wh[2] * bf_lo(hi[2][c]);
    const float fx1 = wl[0] * bf_hi(lo[0][c]) + wh[0] * bf_hi(hi[0][c]);
    const float fy1 = wl[1] * bf_hi(lo[1][c]) + wh[1] * bf_hi(hi[1][c]);
    const float fz1 = wl[2] * bf_hi(lo[2][c]) + wh[2] * bf_hi(hi[2][c]);
    q[c] = pack_bf16(__fmul_rn(__fmul_rn(fx0, fy0), fz0), __fmul_rn(__fmul_rn(fx1, fy1), fz1));
  }
}

// Eight VM features of one sample and pair: channels c0 + 2c, c0 + 2c + 1.
__device__ __forceinline__ void plane_segment(const Seg& sg, const __nv_bfloat16* __restrict__ tab,
                                              const float* x01, uint32_t* q) {
  // VM pairs (plane axes a, b; line axis e): (0,1,2) (0,2,1) (1,2,0)
  const int p = sg.sub, P = sg.res, C = sg.stride;
  const float xa = p == 2 ? x01[1] : x01[0];
  const float xb = p == 0 ? x01[1] : x01[2];
  const float xe = p == 0 ? x01[2] : (p == 1 ? x01[1] : x01[0]);
  int ia, ib, ie;
  float la, ha, lb, hb, le, he;
  hat(xa, P, ia, la, ha);
  hat(xb, P, ib, lb, hb);
  hat(xe, P, ie, le, he);
  const __nv_bfloat16* p00 = tab + sg.off[0] + ((long long)ia * P + ib) * C;
  const __nv_bfloat16* l0 = tab + sg.off[1] + (long long)ie * C;
  uint32_t t00[4], t01[4], t10[4], t11[4], v0[4], v1[4];
  ldg8(p00, t00);
  ldg8(p00 + C, t01);
  ldg8(p00 + (long long)P * C, t10);
  ldg8(p00 + (long long)P * C + C, t11);
  ldg8(l0, v0);
  ldg8(l0 + C, v1);
  float f[2];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a00 = h ? bf_hi(t00[c]) : bf_lo(t00[c]), a01 = h ? bf_hi(t01[c]) : bf_lo(t01[c]);
      const float a10 = h ? bf_hi(t10[c]) : bf_lo(t10[c]), a11 = h ? bf_hi(t11[c]) : bf_lo(t11[c]);
      const float b0 = h ? bf_hi(v0[c]) : bf_lo(v0[c]), b1 = h ? bf_hi(v1[c]) : bf_lo(v1[c]);
      const float q0 = la * a00 + ha * a10;  // exact products: one rounding either way
      const float q1 = la * a01 + ha * a11;
      const float fv = __fadd_rn(__fmul_rn(lb, q0), __fmul_rn(hb, q1));
      const float lv = le * b0 + he * b1;
      f[h] = __fmul_rn(fv, lv);
    }
    q[c] = pack_bf16(f[0], f[1]);
  }
}

// Four values of the frequency encoding of one sample, each as (hi, lo).
__device__ __forceinline__ void freq_segment(const Seg& sg, int freq_degree, const float* xyz,
                                             uint32_t* q) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (sg.sub == 0) {
    v[0] = xyz[0]; v[1] = xyz[1]; v[2] = xyz[2];
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = 2 * (sg.sub - 1) + h;  // (degree, axis) pair
      if (u < 3 * freq_degree) {
        const int fd = u / 3, ax = u - 3 * fd;
        const float xv = ax == 0 ? xyz[0] : (ax == 1 ? xyz[1] : xyz[2]);
        sincosf(xv * (float)(1 << fd), &v[2 * h], &v[2 * h + 1]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float hi = bf16r(v[c]);
    q[c] = pack_bf16(hi, __fsub_rn(v[c], hi));
  }
}

// The canonical field at a tile of 16 samples; every lane of the warp calls
// it. xyz[j] is the (already warped) position of row g + 8 j and idx[j] its
// column in the [., m] arrays, or < 0 for a row past the ragged end, which is
// computed (at any in-range position) and not stored. Writes rows (sigma, r,
// g, b) of out [4, m]. feat_out, if not null, receives the A operand of the
// first product, bf16 [m, 32 n_blocks] in segment order (column 8 (4 b + t)
// + e; the caller zeroes it: a block that lod_mask skips whole is not
// written).
__device__ __forceinline__ void field_tile(const FieldMeta& meta, const TileMeta& tm,
                                           const __nv_bfloat16* __restrict__ tab,
                                           const TileWeights& w, const float (&xyz)[2][3],
                                           const long long (&idx)[2],
                                           const float* __restrict__ d3, long long m,
                                           int lod_mask, int density_only,
                                           float* __restrict__ out,
                                           __nv_bfloat16* __restrict__ feat_out) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  float x01[2][3];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int a = 0; a < 3; ++a) x01[j][a] = unit01(xyz[j][a], meta.bound);

  // ---- sigma tower, first product: features k-block by k-block ----
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  for (int b = 0; b < tm.n_blocks; ++b) {
    const Seg& sg = tm.seg[4 * b + t];
    const int kind = tm.blk_kind[b];
    const bool on = sg.kind != kSegZero && !(sg.kind == kSegLine && ((lod_mask >> sg.sub) & 1));
    if (!__any_sync(0xffffffffu, on)) continue;  // the whole block is skipped
    uint32_t a[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t q[4] = {0u, 0u, 0u, 0u};
      if (on) {
        if (kind == kSegLine) line_segment(sg, tab, x01[j], q);
        else if (kind == kSegPlane) plane_segment(sg, tab, x01[j], q);
        else freq_segment(sg, meta.freq_degree, xyz[j], q);
      }
      a[0][j] = q[0]; a[0][2 + j] = q[1];
      a[1][j] = q[2]; a[1][2 + j] = q[3];
      if (feat_out != nullptr && idx[j] >= 0)
        *reinterpret_cast<uint4*>(feat_out + idx[j] * (32LL * tm.n_blocks) + 8 * (4 * b + t)) =
            make_uint4(q[0], q[1], q[2], q[3]);
    }
    mma_step<4>(acc, a[0], w.w0 + (2 * b) * 128 + lane);
    mma_step<4>(acc, a[1], w.w0 + (2 * b + 1) * 128 + lane);
  }
  uint32_t ah[4][4];
  relu_fragments(acc, ah);

  // ---- sigma tower, output layer: (density logit, 15 geo features) ----
  float o[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint4 bw = w.w1[ks * 32 + lane];
    mma_bf16(o[0], ah[ks], bw.x, bw.y);
    if (!density_only) mma_bf16(o[1], ah[ks], bw.z, bw.w);
  }
  if (t == 0) {
    if (idx[0] >= 0) out[idx[0]] = expf(o[0][0]);
    if (idx[1] >= 0) out[idx[1]] = expf(o[0][2]);
  }
  if (density_only) {
    if (t != 0) {
      if (idx[0] >= 0) out[t * m + idx[0]] = 0.f;
      if (idx[1] >= 0) out[t * m + idx[1]] = 0.f;
    }
    return;
  }

  // ---- colour tower input: SH(d) of degree 4, then the sigma outputs ----
  uint32_t ac[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float sh[kShDim];
    const bool live = idx[j] >= 0;
    sh_basis(meta, live ? d3[idx[j]] : 0.f, live ? d3[m + idx[j]] : 0.f,
             live ? d3[2 * m + idx[j]] : 1.f, sh);
    float s4[4];  // thread t feeds components 4t..4t+3 (pack_tables orders wc0 so)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s4[c] = t == 0 ? sh[c] : (t == 1 ? sh[4 + c] : (t == 2 ? sh[8 + c] : sh[12 + c]));
    ac[0][j] = pack_bf16(s4[0], s4[1]);
    ac[0][2 + j] = pack_bf16(s4[2], s4[3]);
  }
  ac[1][0] = pack_bf16(o[0][0], o[0][1]);
  ac[1][1] = pack_bf16(o[0][2], o[0][3]);
  ac[1][2] = pack_bf16(o[1][0], o[1][1]);
  ac[1][3] = pack_bf16(o[1][2], o[1][3]);
  if (t == 0) {  // column 0 is the density logit, not a colour input
    ac[1][0] &= 0xffff0000u;
    ac[1][1] &= 0xffff0000u;
  }

  // ---- colour tower ----
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) mma_step<4>(acc, ac[ks], w.wc0 + ks * 128 + lane);
  relu_fragments(acc, ah);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) mma_step<4>(acc, ah[ks], w.wc1 + ks * 128 + lane);
  relu_fragments(acc, ah);
  float rgb[4] = {0.f, 0.f, 0.f, 0.f};  // (r, g) of rows g, g + 8 in t == 0; (b, -) in t == 1
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint4 bw = w.wc2[ks * 32 + lane];
    mma_bf16(rgb, ah[ks], bw.x, bw.y);
  }
  if (t < 2) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (idx[j] < 0) continue;
      out[(2 * t + 1) * m + idx[j]] = 1.f / (1.f + expf(-rgb[2 * j]));
      if (t == 0) out[2 * m + idx[j]] = 1.f / (1.f + expf(-rgb[2 * j + 1]));
    }
  }
}

constexpr int kFwdBlock = 256;
constexpr int kFwdWarps = kFwdBlock / 32;

// Persistent blocks of 8 warps; consecutive warps take consecutive tiles.
static __global__ void __launch_bounds__(kFwdBlock, 2)
field_fwd_kernel(const float* __restrict__ x3, const float* __restrict__ d3, long long m,
                 const __nv_bfloat16* __restrict__ tab, const __nv_bfloat16* __restrict__ wfwd,
                 const __grid_constant__ FieldMeta meta, const __grid_constant__ TileMeta tm,
                 int lod_mask, int density_only, float* __restrict__ out,
                 __nv_bfloat16* __restrict__ feat_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  stage_tile_weights(wfwd, ws, tm);
  __syncthreads();
  const TileWeights w = tile_weights(ws, tm);
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;

  const long long tiles = (m + kTileRows - 1) / kTileRows;
  for (long long tile = (long long)blockIdx.x * kFwdWarps + warp; tile < tiles;
       tile += (long long)gridDim.x * kFwdWarps) {
    float xyz[2][3];
    long long idx[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long i = tile * kTileRows + g + 8 * j;
      idx[j] = i < m ? i : -1;
#pragma unroll
      for (int a = 0; a < 3; ++a) xyz[j][a] = i < m ? x3[a * m + i] : 0.f;
    }
    field_tile(meta, tm, tab, w, xyz, idx, d3, m, lod_mask, density_only, out, feat_out);
  }
}

// Launch the forward over m samples on `stream`; returns cudaGetLastError().
inline int launch_field_fwd(const float* x3, const float* d3, long long m,
                            const __nv_bfloat16* tab, const __nv_bfloat16* wfwd,
                            const FieldMeta& fm, const TileMeta& tm, int lod_mask,
                            int density_only, float* out, __nv_bfloat16* feat_out,
                            cudaStream_t stream) {
  const size_t smem = (size_t)tm.w_elems * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(field_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, field_fwd_kernel, kFwdBlock, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long tiles = (m + kTileRows - 1) / kTileRows;
  long long blocks = (tiles + kFwdWarps - 1) / kFwdWarps;
  const long long cap = (long long)n_sm * per_sm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  field_fwd_kernel<<<(unsigned)blocks, kFwdBlock, smem, stream>>>(
      x3, d3, m, tab, wfwd, fm, tm, lod_mask, density_only, out, feat_out);
  return (int)cudaGetLastError();
}

// The forward kernels' tile layout, appended to `meta` after the plane
// scales: n_blocks, w_elems, w_off[5] (bf16 elements into the forward weight
// buffer), blk_kind[n_blocks], then per segment (4 n_blocks of them) kind,
// sub, res, stride, off[3]. n_blocks == 0 says that pack_tables could not lay
// the config out (a rank or channel count that is not a multiple of 8).
// Every row a segment reads must start 16-byte aligned.
inline int fill_tile_meta(const long long* meta, const FieldMeta& fm, TileMeta* out) {
  const long long* q = meta + 10 + 5 * fm.n_scales + 8 * fm.n_planes;
  TileMeta tm = {};
  tm.n_blocks = (int)q[0];
  tm.w_elems = (int)q[1];
  if (tm.n_blocks < 1 || tm.n_blocks > kMaxBlocks || tm.w_elems % 8 != 0)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < 5; ++t) {
    tm.w_off[t] = (int)q[2 + t];
    if (tm.w_off[t] % 8 != 0) return (int)cudaErrorInvalidValue;
  }
  q += 7;
  for (int b = 0; b < tm.n_blocks; ++b) tm.blk_kind[b] = (int)q[b];
  q += tm.n_blocks;
  for (int i = 0; i < 4 * tm.n_blocks; ++i, q += 7) {
    Seg& sg = tm.seg[i];
    sg.kind = (int)q[0];
    sg.sub = (int)q[1];
    sg.res = (int)q[2];
    sg.stride = (int)q[3];
    if (sg.kind != kSegZero && sg.kind != tm.blk_kind[i / 4]) return (int)cudaErrorInvalidValue;
    for (int a = 0; a < 3; ++a) {
      if (q[4 + a] < 0 || q[4 + a] > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      sg.off[a] = (int)q[4 + a];
    }
    if (sg.kind == kSegLine || sg.kind == kSegPlane) {
      if (sg.stride % 8 != 0 || sg.res < 2) return (int)cudaErrorInvalidValue;
      for (int a = 0; a < (sg.kind == kSegLine ? 3 : 2); ++a)
        if (sg.off[a] % 8 != 0) return (int)cudaErrorInvalidValue;
    }
  }
  *out = tm;
  return 0;
}

}  // namespace sdn
