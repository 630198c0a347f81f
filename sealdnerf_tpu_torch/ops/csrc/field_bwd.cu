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
// Design. A block owns a tile of kT = 64 samples, one per thread.
//   1. Each thread recomputes its sample's forward and backward chain in
//      registers, reading the bf16 tower weights (~48 KB) from shared memory,
//      and scatters its table gradients with atomicAdd (about 1.4k atomics per
//      sample at the default widths).
//   2. It stashes the bf16 activations and gradients that the weight-gradient
//      outer products need in shared memory (~1.8 KB per sample).
//   3. The block then sums each weight entry over its tile in f32 (thread j
//      owns column j of every matrix) and issues one atomicAdd per entry.
// Samples whose four cotangents are zero (march-invalid samples, which the
// renderer masks) are skipped; the active ones are compacted to the front of
// the tile, so the sums run over them only. The ragged tail is masked here.
//
// What bounds it: per active sample ~24k MACs of forward recompute, ~24k of
// transposed products and ~24k of weight-gradient sums, all on the FP32 pipe,
// plus the table atomics, which contend at the coarse scale (res 32: every
// sample of a step hits the same 3k addresses). With ~163 KB of shared memory
// a block at the default widths, one 64-thread block runs per SM. Summing with atomics makes the
// results differ from run to run in their last bits. Pre-reducing the table
// atomics within a warp and moving the towers and the outer products onto
// tensor cores are later work.
//
// C interface for ctypes: sdn_field_bwd adds into g_tab (laid out like the
// packed tables) and g_w (laid out like the packed weights), which the caller
// zeroes, and returns cudaGetLastError() after the launch.

#include "field_bwd_body.cuh"

using namespace sdn;

extern "C" int sdn_field_bwd(const float* x3, const float* d3, const float* g_out, long long m,
                             const void* tab, const void* wbuf, const long long* meta,
                             float bound, float* g_tab, float* g_w, void* stream) {
  FieldMeta fm;
  const int bad = fill_meta(meta, bound, &fm);
  if (bad) return bad;
  return launch_field_bwd<false>(x3, d3, g_out, m, (const __nv_bfloat16*)tab,
                                 (const __nv_bfloat16*)wbuf, fm, g_tab, g_w, GxOut{},
                                 (cudaStream_t)stream);
}
