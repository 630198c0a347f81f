// Static CP/VM field forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel sealdnerf_tpu/ops/pallas_field.py:_field_kernel
// (body _field_body, entry cp_forward_fused_planar). Per sample it computes:
//   - per line scale: two bf16 table taps per axis (a lerp with bf16-rounded
//     hat weights), the CP product of the three axes, rounded to bf16;
//   - per VM scale and pair: a four-tap bilinear plane read times a two-tap
//     line read, rounded to bf16;
//   - raw xyz and sin/cos frequency features, kept in f32 (as the Pallas
//     kernel does; the XLA path rounds them);
//   - sigma tower feat -> 64 -> 16, exp on row 0;
//   - colour tower SH(4) ++ geo(15) -> 64 -> 64 -> 3, sigmoid.
// Output rows (sigma, r, g, b) as [4, M] f32. The Pallas kernel wrote [8, M]:
// the four zero rows there only padded the TPU's 8-row sublane tile.
//
// What bounds it: the Pallas kernel built [res, T] hat matrices for the TPU's
// matrix unit. With lerps the table work is 1,392 two-byte taps per sample
// (2.8 KB, out of L1/L2: the tables are 1.4 MB), and 23.9k MACs per sample
// remain in the towers. On the FP32 pipe those MACs bound the kernel (the
// first version, one sample a thread: 8.95 ms per 2^20 samples on an NVIDIA
// H100 80GB HBM3 at 700 W, this one 0.69 ms); as bf16 x bf16 -> f32 products
// they are what the tensor cores compute, and then the instruction rate of
// the feature arithmetic bounds it, the gathers hidden behind it (random and
// ray-coherent samples take the same time). Design (field_tile in
// field_fwd_body.cuh): a warp owns a tile of 16 samples; the four threads of a
// quad share two samples and each reads eight neighbouring ranks of every tap
// row with one 16-byte load, so a quad covers 64 contiguous bytes of a row;
// the features a thread computes are the A fragments of mma.sync.m16n8k16
// directly and a layer's sums are the next layer's fragments, so nothing of
// a sample passes through shared memory; the five matrices (56 KB, padded and
// in fragment order) are staged once per block and read with 16-byte loads.
// Blocks of 8 warps are persistent, two per SM, which leaves half of the SM's
// memory to L1 for the gathers; consecutive warps take consecutive tiles.
// The ragged tail is masked in the tile; `lod_mask` skips a scale's gathers
// and k-blocks and `density_only` stops after the sigma tower (one n-tile of
// its output layer): the occupancy-grid sweep.
//
// C interface for ctypes: sdn_field_fwd returns cudaGetLastError() after
// the launch; 0 means the launch was accepted. `wfwd` is the forward weight
// buffer of pack_tables; feat_out is null or a zeroed bf16 [m, 32 n_blocks]
// buffer that receives the first product's A operand (for tests).

#include "field_fwd_body.cuh"

using namespace sdn;

extern "C" int sdn_field_fwd(const float* x3, const float* d3, long long m, const void* tab,
                             const void* wfwd, const long long* meta, float bound, int lod_mask,
                             int density_only, float* out, void* feat_out, void* stream) {
  FieldMeta fm;
  TileMeta tm;
  int bad = fill_meta(meta, bound, &fm);
  if (!bad) bad = fill_tile_meta(meta, fm, &tm);
  if (bad) return bad;
  return launch_field_fwd(x3, d3, m, (const __nv_bfloat16*)tab, (const __nv_bfloat16*)wfwd, fm,
                          tm, lod_mask, density_only, out, (__nv_bfloat16*)feat_out,
                          (cudaStream_t)stream);
}
