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
// matrix unit. With lerps the table work is ~1.4k two-byte gathers per
// sample, and about 24k MACs per sample remain, almost all in the towers.
// So the kernel is bound by the FMA rate. Design: one thread per sample in a
// grid-stride loop; all five towers' bf16 weights (~48 KB) are staged once
// per block in dynamic shared memory and read as 16-byte broadcasts; the
// tables (~1.4 MB in bf16) are read from global memory and stay L2-resident.
// The ragged tail is masked here; `lod_mask` skips line scales and
// `density_only` skips SH and the colour tower (the occupancy-grid sweep).
// Moving the towers onto tensor cores (mma.sync / wgmma over a tile of
// samples) is later work.
//
// C interface for ctypes: sdn_field_fwd returns cudaGetLastError() after
// the launch; 0 means the launch was accepted.

#include "field_common.cuh"

namespace {

using namespace sdn;

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
field_fwd_kernel(const float* __restrict__ x3, const float* __restrict__ d3, long long m,
                 const __nv_bfloat16* __restrict__ tab, const __nv_bfloat16* __restrict__ wbuf,
                 const FieldMeta meta, int lod_mask, int density_only,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  stage_tower_weights(wbuf, ws, meta);
  __syncthreads();
  const TowerWeights w = tower_weights(ws, meta);

  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x) {
    float xyz[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) xyz[a] = x3[a * m + i];
    field_sample(meta, tab, w, xyz, d3, m, i, lod_mask, density_only, out);
  }
}

}  // namespace

extern "C" int sdn_field_fwd(const float* x3, const float* d3, long long m, const void* tab,
                             const void* wbuf, const long long* meta, float bound, int lod_mask,
                             int density_only, float* out, void* stream) {
  FieldMeta fm;
  const int bad = fill_meta(meta, bound, &fm);
  if (bad) return bad;
  const size_t smem = (size_t)fm.w_elems * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(field_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (m + kBlock - 1) / kBlock;
  const long long cap = (long long)n_sm * 4;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  field_fwd_kernel<<<(unsigned)blocks, kBlock, smem, (cudaStream_t)stream>>>(
      x3, d3, m, (const __nv_bfloat16*)tab, (const __nv_bfloat16*)wbuf, fm, lod_mask,
      density_only, out);
  return (int)cudaGetLastError();
}
