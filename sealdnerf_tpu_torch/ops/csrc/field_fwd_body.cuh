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
//   zero:  padding;
//   hash:  levels l0..l0+3 (l0 = sub) of a multiresolution hash grid of two
//          features a level (K5, hash_field_fwd.cu): per level the eight
//          corners of the sample's cell, each one 4-byte read of a bf16 pair
//          at the level's tiled index or prime-XOR hash, summed with
//          trilinear weights in f32 and rounded to bf16.
// Which kinds an instantiation computes is its segment set, a template
// parameter: kCpSegs (line, plane, freq: K1-K4) or kHashSegs (hash: K5), so
// that neither carries the other's branches.
// The colour tower's input is [SH(d) (16) | the sigma tower's 16 outputs]: the
// outputs stay where the sigma product left them, and column 0 (the density
// logit) meets a zero row and is zeroed in the fragment.

constexpr int kSegZero = 0, kSegLine = 1, kSegPlane = 2, kSegFreq = 3, kSegHash = 4;
constexpr int kCpSegs = 0, kHashSegs = 1;  // segment sets
constexpr int kMaxBlocks = 16;  // k-blocks of 32 columns of the first product
constexpr int kTileRows = 16;   // samples per warp tile
constexpr int kHashLevels = 16;  // levels of a hash grid: one k-block of 16 x 2 features

// One level of a hash grid: position scale, the cell clamp (the level's
// resolution), the index strides of y and z, the table's rows, its first row
// in the packed table, and whether it hashes (else the tiled index). A
// hashed level's rows are a power of two and a tiled index stays below twice
// the rows (hash_field_fwd.cu checks both), so the modulo is a mask or one
// subtraction.
struct HashLevel {
  float scale;
  int res;
  uint32_t s1, s2, size, off;
  int hashed;
};

struct HashMeta {
  HashLevel lv[kHashLevels];
};

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

// The taps of one sample's line segment: per axis the lower tap index, the
// two bf16-rounded hat weights and eight ranks of either tap row.
struct LineTaps {
  int i0[3];
  float wl[3], wh[3];
  uint32_t lo[3][4], hi[3][4];
};

__device__ __forceinline__ void line_taps(const Seg& sg, const __nv_bfloat16* __restrict__ tab,
                                          const float* x01, LineTaps& tp) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    hat(x01[a], sg.res, tp.i0[a], tp.wl[a], tp.wh[a]);
    const __nv_bfloat16* p = tab + sg.off[a] + (long long)tp.i0[a] * sg.stride;
    ldg8(p, tp.lo[a]);
    ldg8(p + sg.stride, tp.hi[a]);
  }
}

// One axis's lerp of rank 2c + h of the segment (exact products: one rounding)
__device__ __forceinline__ float line_lerp(const LineTaps& tp, int a, int c, int h) {
  return h ? tp.wl[a] * bf_hi(tp.lo[a][c]) + tp.wh[a] * bf_hi(tp.hi[a][c])
           : tp.wl[a] * bf_lo(tp.lo[a][c]) + tp.wh[a] * bf_lo(tp.hi[a][c]);
}

// Eight line features of one sample: q[c] holds ranks r0 + 2c, r0 + 2c + 1.
__device__ __forceinline__ void line_features(const LineTaps& tp, uint32_t* q) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float fx0 = line_lerp(tp, 0, c, 0), fy0 = line_lerp(tp, 1, c, 0);
    const float fz0 = line_lerp(tp, 2, c, 0);
    const float fx1 = line_lerp(tp, 0, c, 1), fy1 = line_lerp(tp, 1, c, 1);
    const float fz1 = line_lerp(tp, 2, c, 1);
    q[c] = pack_bf16(__fmul_rn(__fmul_rn(fx0, fy0), fz0), __fmul_rn(__fmul_rn(fx1, fy1), fz1));
  }
}

__device__ __forceinline__ void line_segment(const Seg& sg, const __nv_bfloat16* __restrict__ tab,
                                             const float* x01, uint32_t* q) {
  LineTaps tp;
  line_taps(sg, tab, x01, tp);
  line_features(tp, q);
}

// The taps of one sample's VM segment (pair p = sg.sub; plane axes a, b and
// line axis e: (0,1,2) (0,2,1) (1,2,0)): tap indices, hat weights, eight
// channels of the four plane taps (t00 at (ia, ib), t01 at (ia, ib + 1), t10
// at (ia + 1, ib), t11) and of the two line taps.
struct PlaneTaps {
  int ia, ib, ie;
  float la, ha, lb, hb, le, he;
  uint32_t t00[4], t01[4], t10[4], t11[4], v0[4], v1[4];
};

__device__ __forceinline__ int plane_axis_a(int p) { return p == 2 ? 1 : 0; }
__device__ __forceinline__ int plane_axis_b(int p) { return p == 0 ? 1 : 2; }
__device__ __forceinline__ int plane_axis_e(int p) { return 2 - p; }

__device__ __forceinline__ void plane_taps(const Seg& sg, const __nv_bfloat16* __restrict__ tab,
                                           const float* x01, PlaneTaps& tp) {
  const int p = sg.sub, P = sg.res, C = sg.stride;
  const float xa = p == 2 ? x01[1] : x01[0];
  const float xb = p == 0 ? x01[1] : x01[2];
  const float xe = p == 0 ? x01[2] : (p == 1 ? x01[1] : x01[0]);
  hat(xa, P, tp.ia, tp.la, tp.ha);
  hat(xb, P, tp.ib, tp.lb, tp.hb);
  hat(xe, P, tp.ie, tp.le, tp.he);
  const __nv_bfloat16* p00 = tab + sg.off[0] + ((long long)tp.ia * P + tp.ib) * C;
  const __nv_bfloat16* l0 = tab + sg.off[1] + (long long)tp.ie * C;
  ldg8(p00, tp.t00);
  ldg8(p00 + C, tp.t01);
  ldg8(p00 + (long long)P * C, tp.t10);
  ldg8(p00 + (long long)P * C + C, tp.t11);
  ldg8(l0, tp.v0);
  ldg8(l0 + C, tp.v1);
}

// Channel 2c + h of the segment: the plane read's two lerps along axis a
// (q0 at ib, q1 at ib + 1), the bilinear plane value fv and the line value
// lv, with the plain version's roundings (no fused multiply-add where a
// product is inexact).
__device__ __forceinline__ void plane_channel(const PlaneTaps& tp, int c, int h, float& q0,
                                              float& q1, float& fv, float& lv) {
  const float a00 = h ? bf_hi(tp.t00[c]) : bf_lo(tp.t00[c]);
  const float a01 = h ? bf_hi(tp.t01[c]) : bf_lo(tp.t01[c]);
  const float a10 = h ? bf_hi(tp.t10[c]) : bf_lo(tp.t10[c]);
  const float a11 = h ? bf_hi(tp.t11[c]) : bf_lo(tp.t11[c]);
  const float b0 = h ? bf_hi(tp.v0[c]) : bf_lo(tp.v0[c]);
  const float b1 = h ? bf_hi(tp.v1[c]) : bf_lo(tp.v1[c]);
  q0 = tp.la * a00 + tp.ha * a10;  // exact products: one rounding either way
  q1 = tp.la * a01 + tp.ha * a11;
  fv = __fadd_rn(__fmul_rn(tp.lb, q0), __fmul_rn(tp.hb, q1));
  lv = tp.le * b0 + tp.he * b1;
}

// Eight VM features of one sample and pair: channels c0 + 2c, c0 + 2c + 1.
__device__ __forceinline__ void plane_features(const PlaneTaps& tp, uint32_t* q) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float f[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float q0, q1, fv, lv;
      plane_channel(tp, c, h, q0, q1, fv, lv);
      f[h] = __fmul_rn(fv, lv);
    }
    q[c] = pack_bf16(f[0], f[1]);
  }
}

__device__ __forceinline__ void plane_segment(const Seg& sg, const __nv_bfloat16* __restrict__ tab,
                                              const float* x01, uint32_t* q) {
  PlaneTaps tp;
  plane_taps(sg, tab, x01, tp);
  plane_features(tp, q);
}

// The four values of frequency segment sg of one sample: xyz and a zero
// (sub 0), or (sin, cos) of two (degree, axis) pairs u = 2 (sub - 1) + h,
// degree u / 3 of axis u % 3; zeros past the last pair.
__device__ __forceinline__ void freq_values(const Seg& sg, int freq_degree, const float* xyz,
                                            float* v) {
  v[0] = v[1] = v[2] = v[3] = 0.f;
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
}

// Four values of the frequency encoding of one sample, each as (hi, lo).
__device__ __forceinline__ void freq_segment(const Seg& sg, int freq_degree, const float* xyz,
                                             uint32_t* q) {
  float v[4];
  freq_values(sg, freq_degree, xyz, v);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float hi = bf16r(v[c]);
    q[c] = pack_bf16(hi, __fsub_rn(v[c], hi));
  }
}

// Four levels (l0..l0+3) of the hash grid at one sample, u its position in
// the unit cube (unclipped): q[c] holds level l0 + c's two features. Per
// level: pos = u * scale + 0.5, the cell floor(pos) and the fractions, the
// eight corners (corner i takes bit a of i on axis a) at the tiled index
// (x + y s1 + z s2) or the hash x ^ 2654435761 y ^ 805459861 z, both in 32
// bits, modulo the level's rows; the corner's weight is ((wx wy) wz) and the
// sum runs over the corners in order, with the plain version's roundings.
// A sample outside [0, 1]^3 encodes to zeros. The eight reads of each level
// are issued before any is used.
__device__ __forceinline__ void hash_segment(const HashMeta& hm, int l0,
                                             const __nv_bfloat16* __restrict__ tab,
                                             const float* u, uint32_t* q) {
  const uint32_t* __restrict__ tab2 = reinterpret_cast<const uint32_t*>(tab);
  const bool oob = u[0] < 0.f || u[0] > 1.f || u[1] < 0.f || u[1] > 1.f || u[2] < 0.f ||
                   u[2] > 1.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const HashLevel& L = hm.lv[l0 + c];
    float fr[3];
    uint32_t cell[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pos = __fadd_rn(__fmul_rn(u[a], L.scale), 0.5f);
      const float pf = floorf(pos);
      fr[a] = __fsub_rn(pos, pf);
      cell[a] = (uint32_t)fminf(fmaxf(pf, 0.f), (float)L.res);
    }
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t x = cell[0] + (i & 1), y = cell[1] + ((i >> 1) & 1),
                     z = cell[2] + ((i >> 2) & 1);
      const uint32_t hx = (x ^ (y * 2654435761u) ^ (z * 805459861u)) & (L.size - 1u);
      const uint32_t lin = x + y * L.s1 + z * L.s2;
      const uint32_t h = L.hashed ? hx : (lin >= L.size ? lin - L.size : lin);
      v[i] = __ldg(tab2 + L.off + h);
    }
    float f0 = 0.f, f1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float wx = (i & 1) ? fr[0] : __fsub_rn(1.f, fr[0]);
      const float wy = (i & 2) ? fr[1] : __fsub_rn(1.f, fr[1]);
      const float wz = (i & 4) ? fr[2] : __fsub_rn(1.f, fr[2]);
      const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
      f0 = __fadd_rn(f0, __fmul_rn(w, bf_lo(v[i])));
      f1 = __fadd_rn(f1, __fmul_rn(w, bf_hi(v[i])));
    }
    q[c] = oob ? 0u : pack_bf16(f0, f1);
  }
}

// The pieces of the canonical field at a tile of 16 samples, which the
// forward (field_tile) and the backward's recompute (field_bwd_body.cuh) both
// run, so that the backward sees the forward's pre-activations bit for bit.
// Every lane of the warp calls them. Row j of a thread is sample g + 8 j of
// the tile; idx[j] is its column in the [., m] arrays, or < 0 for a row past
// the ragged end, which is computed (at any in-range position) and not stored.

__device__ __forceinline__ void zero_acc(float (*acc)[4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
}

// Is segment sg computed under lod_mask (padding and skipped line scales are
// not)?
__device__ __forceinline__ bool segment_on(const Seg& sg, int lod_mask) {
  return sg.kind != kSegZero && !(sg.kind == kSegLine && ((lod_mask >> sg.sub) & 1));
}

// The eight features of this thread's segment of k-block b for its two rows,
// as the A fragments of the block's two k-steps. kSet: the segment set; hm:
// the hash grid's levels (kHashSegs only, whose x01 is unclipped).
template <int kSet = kCpSegs>
__device__ __forceinline__ void block_features(const FieldMeta& meta, int kind, const Seg& sg,
                                               bool on, const __nv_bfloat16* __restrict__ tab,
                                               const float (&xyz)[2][3],
                                               const float (&x01)[2][3], uint32_t (&q)[2][4],
                                               uint32_t (&a)[2][4],
                                               const HashMeta* hm = nullptr) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) q[j][c] = 0u;
    if (on) {
      if constexpr (kSet == kHashSegs) {
        hash_segment(*hm, sg.sub, tab, x01[j], q[j]);
      } else {
        if (kind == kSegLine) line_segment(sg, tab, x01[j], q[j]);
        else if (kind == kSegPlane) plane_segment(sg, tab, x01[j], q[j]);
        else freq_segment(sg, meta.freq_degree, xyz[j], q[j]);
      }
    }
    a[0][j] = q[j][0]; a[0][2 + j] = q[j][1];
    a[1][j] = q[j][2]; a[1][2 + j] = q[j][3];
  }
}

// acc [16, 64] = features x the first sigma matrix, k-block by k-block.
// feat_out, if not null, receives the A operand, bf16 [m, 32 n_blocks] in
// segment order (column 8 (4 b + t) + e; the caller zeroes it: a block that
// lod_mask skips whole is not written).
template <int kSet = kCpSegs>
__device__ __forceinline__ void first_product(const FieldMeta& meta, const TileMeta& tm,
                                              const __nv_bfloat16* __restrict__ tab,
                                              const TileWeights& w, const float (&xyz)[2][3],
                                              const float (&x01)[2][3],
                                              const long long (&idx)[2], int lod_mask,
                                              __nv_bfloat16* __restrict__ feat_out,
                                              float (*acc)[4], const HashMeta* hm = nullptr) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  zero_acc(acc);
  for (int b = 0; b < tm.n_blocks; ++b) {
    const Seg& sg = tm.seg[4 * b + t];
    const bool on = segment_on(sg, lod_mask);
    if (!__any_sync(0xffffffffu, on)) continue;  // the whole block is skipped
    uint32_t q[2][4], a[2][4];
    block_features<kSet>(meta, tm.blk_kind[b], sg, on, tab, xyz, x01, q, a, hm);
    if (feat_out != nullptr) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (idx[j] >= 0)
          *reinterpret_cast<uint4*>(feat_out + idx[j] * (32LL * tm.n_blocks) + 8 * (4 * b + t)) =
              make_uint4(q[j][0], q[j][1], q[j][2], q[j][3]);
    }
    mma_step<4>(acc, a[0], w.w0 + (2 * b) * 128 + lane);
    mma_step<4>(acc, a[1], w.w0 + (2 * b + 1) * 128 + lane);
  }
}

// o [16, 16] = (density logit, 15 geo features) from the relu'd hidden layer
__device__ __forceinline__ void sigma_output(const TileWeights& w, const uint32_t (*ah)[4],
                                             int density_only, float (*o)[4]) {
  const int lane = threadIdx.x & 31;
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
}

// The colour tower's input as A fragments: SH(d) of degree 4, then the sigma
// outputs with the density logit zeroed.
__device__ __forceinline__ void color_input(const FieldMeta& meta, const float* __restrict__ d3,
                                            long long m, const long long (&idx)[2],
                                            const float (*o)[4], uint32_t (*ac)[4]) {
  const int t = threadIdx.x & 3;
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
}

// The colour tower's two hidden products: acc = a x wc0 (k_steps = 2) or
// a x wc1 (k_steps = 4).
template <int kSteps>
__device__ __forceinline__ void color_product(const uint4* wm, const uint32_t (*a)[4],
                                              float (*acc)[4]) {
  const int lane = threadIdx.x & 31;
  zero_acc(acc);
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) mma_step<4>(acc, a[ks], wm + ks * 128 + lane);
}

// The colour logits: (r, g) of rows g, g + 8 in t == 0; (b, -) in t == 1.
__device__ __forceinline__ void color_output(const TileWeights& w, const uint32_t (*ah)[4],
                                             float* rgb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < 4; ++c) rgb[c] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint4 bw = w.wc2[ks * 32 + lane];
    mma_bf16(rgb, ah[ks], bw.x, bw.y);
  }
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// The canonical field at a tile of 16 samples. xyz[j] is the (already warped)
// position of row j. Writes rows (sigma, r, g, b) of out [4, m]; feat_out as
// in first_product. kSet and hm as in block_features: a hash grid reads its
// positions in the unit cube unclipped (a sample outside encodes to zeros).
template <int kSet = kCpSegs>
__device__ __forceinline__ void field_tile(const FieldMeta& meta, const TileMeta& tm,
                                           const __nv_bfloat16* __restrict__ tab,
                                           const TileWeights& w, const float (&xyz)[2][3],
                                           const long long (&idx)[2],
                                           const float* __restrict__ d3, long long m,
                                           int lod_mask, int density_only,
                                           float* __restrict__ out,
                                           __nv_bfloat16* __restrict__ feat_out,
                                           const HashMeta* hm = nullptr) {
  const int t = threadIdx.x & 3;
  float x01[2][3];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      x01[j][a] = kSet == kHashSegs
                      ? __fdiv_rn(__fadd_rn(xyz[j][a], meta.bound), 2.f * meta.bound)
                      : unit01(xyz[j][a], meta.bound);

  float acc[8][4];
  first_product<kSet>(meta, tm, tab, w, xyz, x01, idx, lod_mask, feat_out, acc, hm);
  uint32_t ah[4][4];
  relu_fragments(acc, ah);
  float o[2][4];
  sigma_output(w, ah, density_only, o);
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

  uint32_t ac[2][4];
  color_input(meta, d3, m, idx, o, ac);
  color_product<2>(w.wc0, ac, acc);
  relu_fragments(acc, ah);
  color_product<4>(w.wc1, ah, acc);
  relu_fragments(acc, ah);
  float rgb[4];
  color_output(w, ah, rgb);
  if (t < 2) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (idx[j] < 0) continue;
      out[(2 * t + 1) * m + idx[j]] = sigmoidf(rgb[2 * j]);
      if (t == 0) out[2 * m + idx[j]] = sigmoidf(rgb[2 * j + 1]);
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

// The persistent grid of a forward kernel (blocks of kFwdBlock threads, `smem`
// bytes of shared memory) over m samples: a block for every kFwdWarps tiles,
// at most as many as the SMs hold at once. Returns 0 or a CUDA error.
template <typename Kernel>
inline int fwd_blocks(Kernel kernel, long long m, size_t smem, long long* blocks) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFwdBlock, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long tiles = (m + kTileRows - 1) / kTileRows;
  long long b = (tiles + kFwdWarps - 1) / kFwdWarps;
  const long long cap = (long long)n_sm * per_sm;
  if (b > cap) b = cap;
  *blocks = b < 1 ? 1 : b;
  return 0;
}

// Launch the forward over m samples on `stream`; returns cudaGetLastError().
inline int launch_field_fwd(const float* x3, const float* d3, long long m,
                            const __nv_bfloat16* tab, const __nv_bfloat16* wfwd,
                            const FieldMeta& fm, const TileMeta& tm, int lod_mask,
                            int density_only, float* out, __nv_bfloat16* feat_out,
                            cudaStream_t stream) {
  const size_t smem = (size_t)tm.w_elems * sizeof(__nv_bfloat16);
  long long blocks = 0;
  const int bad = fwd_blocks(field_fwd_kernel, m, smem, &blocks);
  if (bad) return bad;
  field_fwd_kernel<<<(unsigned)blocks, kFwdBlock, smem, stream>>>(
      x3, d3, m, tab, wfwd, fm, tm, lod_mask, density_only, out, feat_out);
  return (int)cudaGetLastError();
}

// The forward kernels' tile layout, appended to `meta` after the plane
// scales: n_blocks, w_elems, w_off[5] (bf16 elements into the forward weight
// buffer), blk_kind[n_blocks], then per segment (4 n_blocks of them) kind,
// sub, res, stride, off[3]. n_blocks == 0 says that pack_tables could not lay
// the config out (more than kMaxBlocks k-blocks). Every row a segment reads
// must start 16-byte aligned: pack_tables pads the tables' rows to multiples
// of eight columns.
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
