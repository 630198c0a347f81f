// Static CP/VM field backward for Hopper (sm_90a).
//
// Replaces the Pallas kernel sealdnerf_tpu/ops/pallas_field.py:_field_bwd_kernel
// (body _canonical_bwd, entry _bwd_pallas_call, custom VJP cp_train_fused).
// Given the cotangent g_out [4, M] of the forward's rows (sigma, r, g, b), it
// recomputes the forward per sample with K1's rounding points and returns the
// f32 gradients of every line table, plane, VM line and of the five tower
// matrices. Positions and directions get no gradient (static scenes).
//
// Rounding points (those of _canonical_bwd):
//   - forward: bf16 taps and hat weights, CP and VM features rounded to bf16,
//     frequency features in f32, bf16 hidden activations into each product;
//   - chain: g_hc2 = g_rgb rgb (1 - rgb), ReLU masks from the f32
//     pre-activations, trunc_exp's gradient g_sigma exp(clip(h1_0, -15, 15)),
//     every transposed product on bf16 operands with f32 sums;
//   - weight gradients: both operands of every outer product rounded to bf16
//     (exact products, f32 sums), except the frequency rows of the first sigma
//     matrix, summed in f32 from f32 operands;
//   - table gradients: bf16(g_f) x bf16(hat weight) into the two taps of each
//     line; bf16(ua) x bf16(g_f[c] ub) into the four taps of each plane.
//
// Design (field_bwd_body.cuh has it in full): a first small kernel lists the
// samples that carry a cotangent (march-invalid samples, which the renderer
// masks, carry none); then persistent blocks of 12 warps walk the list, a warp
// per tile of 16 samples. A tile's forward is the forward kernel's own
// arithmetic (the device functions of field_fwd_body.cuh), so the relu masks
// are the forward's; the chain's transposed products and the weight-gradient
// outer products run on mma.sync.m16n8k16 with the activations in registers;
// a block sums the five weight gradients in shared memory over all its tiles
// and adds them to g_w once; a tap row's eight table gradients go out as two
// 16-byte vector atomics.
//
// What bounds it: operations. Per live sample ~24k MACs of recompute, ~24k of
// transposed products and ~24k of weight-gradient sums on the tensor cores,
// the feature arithmetic twice on the FP32 pipe (once for the recompute, once
// for the scatter), and 348 vector atomics. Summing with atomics makes the
// results differ from run to run in their last bits.
//
// C interface for ctypes: sdn_field_bwd adds into g_tab (laid out like the
// packed tables) and g_w (see field_bwd_body.cuh), which the caller zeroes
// along with `count`; idx [M] is scratch for the list. rec_out is null, or
// [4, M] and receives the forward's output that the kernel recomputed (for
// checks). It returns the first error of its two launches, else 0.

#include "field_bwd_body.cuh"

using namespace sdn;

extern "C" int sdn_field_bwd(const float* x3, const float* d3, const float* g_out, long long m,
                             const void* tab, const void* wfwd, const void* wbwd,
                             const long long* meta, float bound, int* count, int* idx,
                             float* g_tab, float* g_w, float* rec_out, void* stream_) {
  FieldMeta fm;
  TileMeta tm;
  BwdMeta bm;
  int bad = fill_meta(meta, bound, &fm);
  if (!bad) bad = fill_tile_meta(meta, fm, &tm);
  if (!bad) bad = fill_bwd_meta(meta, fm, tm, &bm);
  if (bad) return bad;
  if (m < 1 || m > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  bad = launch_compact(g_out, m, count, idx, stream);
  if (bad) return bad;
  return launch_field_bwd<false>(x3, d3, g_out, m, count, idx, (const __nv_bfloat16*)tab,
                                 (const __nv_bfloat16*)wfwd, (const __nv_bfloat16*)wbwd, fm, tm,
                                 bm, g_tab, g_w, GxOut{}, rec_out, stream);
}
