// Dynamic (time-conditioned) CP/VM field forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel sealdnerf_tpu/ops/pallas_field.py:_dyn_field_kernel
// (entry cp_dnerf_forward_fused_planar), which does both halves per tile of
// samples:
//   - deformation tower: ex = [x, sin(2^f x), cos(2^f x)] (f32, rounded to
//     bf16) -> W0 (bf16, f32 sums) + the frame's f32 time bias -> L - 2 times
//     (relu, bf16, W) -> dx [3]; dx is forced to 0 when the frame's flag says
//     t == 0 (the Pallas caller baked that gate into the last matrix because
//     its kernel could not read a scalar; this one reads it);
//   - the canonical field (field_fwd_kernel of field_fwd_body.cuh, the static
//     forward kernel itself) at x + dx, so the two entries round alike and
//     agree bit for bit at t == 0.
// The time bias W0[nx:]^T freq(t) and the flag arrive as 129 floats in device
// memory (`tcond`), so a caller that holds t on the card never synchronises.
//
// What bounds it: both halves are bf16 x bf16 -> f32 products, and they want
// opposite things of an SM. The tower is ~107k MACs per sample (4.5 times the
// canonical towers, 0.226 ms at M = 1,048,613 on the tensor cores' 989
// TFLOP/s); it wants its 212 KB of matrices in shared memory and warpgroup
// products (deform_tower.cuh). The canonical half is bound by the instruction
// rate of its feature arithmetic and by its gathers (2.8 KB of table rows a
// sample), keeps everything of a sample in registers, and wants many warps
// and a large L1. The Pallas kernel fused the two so that the warp never left
// the chip; here one block cannot hold the tower's matrices beside the
// canonical ones, and the warp is 12 bytes a sample, written once and read
// once, against 2.8 KB of gathers. So the entry runs two kernels on the
// caller's stream and counts as one launch:
//   1. deform_fwd_kernel (warp_tiles of deform_tower.cuh, which the backward
//      entry runs too): xw [3, M] = x + dx. One persistent block an SM: a
//      producer warp brings the eight matrices into shared memory once, three
//      warpgroups walk tiles of 64 samples on wgmma.mma_async m64n128k16 with
//      the activations in registers;
//   2. field_fwd_kernel at xw, two blocks of 8 warps an SM, as the static
//      entry runs it.
// The design before this one (mma.sync on activations in shared memory,
// every matrix copied from L2 for every tile of 256 samples between two
// block barriers, one block of 8 warps an SM) took 2.200 ms on 1,048,613
// random samples, the tower 61-65 % of it, on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py phase 3c; PERF.md has both designs side by side).
//
// C interface for ctypes: sdn_dyn_field_fwd returns the first error of either
// launch, else 0. `wfwd` and feat_out as in sdn_field_fwd; xw [3, M] is
// scratch.

#include "deform_tower.cuh"
#include "field_fwd_body.cuh"

using namespace sdn;

namespace {

__global__ void __launch_bounds__(kTowerThreads, 1)
deform_fwd_kernel(const float* __restrict__ x3, long long m,
                  const __nv_bfloat16* __restrict__ wdef, const float* __restrict__ tcond,
                  const DeformMeta dm, float* __restrict__ xw, const int* __restrict__ list,
                  const int* __restrict__ count) {
  warp_tiles(x3, m, wdef, tcond, dm, xw, list, count);
}

}  // namespace

extern "C" int sdn_dyn_field_fwd(const float* x3, const float* d3, long long m, const void* tab,
                                 const void* wfwd, const long long* meta, float bound,
                                 const void* wdef, const long long* dmeta, const float* tcond,
                                 int lod_mask, int density_only, float* xw, float* out,
                                 void* feat_out, void* stream_) {
  FieldMeta fm;
  TileMeta tm;
  DeformMeta dm;
  int bad = fill_meta(meta, bound, &fm);
  if (!bad) bad = fill_tile_meta(meta, fm, &tm);
  if (!bad) bad = fill_deform_meta(dmeta, &dm);
  if (bad) return bad;
  cudaStream_t stream = (cudaStream_t)stream_;
  bad = launch_warp(deform_fwd_kernel, x3, m, (const __nv_bfloat16*)wdef, tcond, dm, xw,
                    nullptr, nullptr, stream);
  if (bad) return bad;
  return launch_field_fwd(xw, d3, m, (const __nv_bfloat16*)tab, (const __nv_bfloat16*)wfwd, fm,
                          tm, lod_mask, density_only, out, (__nv_bfloat16*)feat_out, stream);
}
