// Dynamic (time-conditioned) CP/VM field forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel sealdnerf_tpu/ops/pallas_field.py:_dyn_field_kernel
// (entry cp_dnerf_forward_fused_planar). One kernel does both halves per tile
// of samples, and the warp never leaves the chip in between:
//   - deformation tower: ex = [x, sin(2^f x), cos(2^f x)] (f32, rounded to
//     bf16) -> W0 (bf16, f32 sums) + the frame's f32 time bias -> L - 2 times
//     (relu, bf16, W) -> dx [3]; dx is forced to 0 when the frame's flag says
//     t == 0 (the Pallas caller baked that gate into the last matrix because
//     its kernel could not read a scalar; this one reads it);
//   - the canonical field (field_sample of field_common.cuh, the body of the
//     static forward kernel) at x + dx, so the two kernels round alike and
//     agree bit for bit at t == 0.
// The time bias W0[nx:]^T freq(t) and the flag arrive as 129 floats in device
// memory (`tcond`), so a caller that holds t on the card never synchronises.
//
// What bounds it: operations. The tower is ~107k MACs per sample (4.5 times
// the canonical towers) with bf16 operands and f32 sums, which is what the
// tensor cores compute, so it runs on mma.sync.m16n8k16: a block of 256
// threads owns a tile of 256 samples, whose activations live in shared memory
// as bf16 [256, 128] (rows padded to 136 against bank conflicts). Warp w owns
// rows 32w..32w+31 through every layer: it multiplies them by the layer's
// matrix into 128 f32 accumulators per thread and writes relu'd bf16 back in
// place, so layers need no block barrier for the activations. The matrices
// (217 KB in bf16) do not fit beside the canonical towers' 48 KB, so each
// layer's 32 KB matrix is staged from L2 into one shared buffer by the whole
// block, between two barriers. Pad samples of a ragged tail run the tower on
// zeros (the barriers need every thread) and are dropped before the canonical
// half, which runs one thread per sample on the FP32 pipe as the static kernel
// does. Blocks are persistent: one per SM, striding over the tiles.
// Later work: double-buffer the staging with cp.async, and move the canonical
// towers onto the tensor cores too.
//
// C interface for ctypes: sdn_dyn_field_fwd returns cudaGetLastError() after
// the launch; 0 means the launch was accepted.

#include "deform_tower.cuh"

namespace {

using namespace sdn;

constexpr int kTile = kTowerTile;  // samples per tile = threads per block

__global__ void __launch_bounds__(kTile)
dyn_field_fwd_kernel(const float* __restrict__ x3, const float* __restrict__ d3, long long m,
                     const __nv_bfloat16* __restrict__ tab,
                     const __nv_bfloat16* __restrict__ wbuf,
                     const __nv_bfloat16* __restrict__ wdef, const float* __restrict__ tcond,
                     const FieldMeta meta, const DeformMeta dm, int lod_mask, int density_only,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // canonical towers
  __nv_bfloat16* wst = ws + meta.w_elems;                          // one deform matrix
  __nv_bfloat16* act = wst + kDefHid * kLd;                        // tile activations
  float* tb = reinterpret_cast<float*>(act + kTile * kLd);         // time bias [128], flag
  float* dxs = tb + kDefHid + 4;                                   // dx [kTile][3]

  stage_tower_weights(wbuf, ws, meta);
  for (int j = threadIdx.x; j < kDefHid + 1; j += kTile) tb[j] = tcond[j];
  __syncthreads();
  const TowerWeights w = tower_weights(ws, meta);
  const bool moving = tb[kDefHid] != 0.f;

  const int tid = threadIdx.x;

  for (long long base = (long long)blockIdx.x * kTile; base < m;
       base += (long long)gridDim.x * kTile) {
    const long long i = base + tid;
    const bool live = i < m;
    float x[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = live ? x3[a * m + i] : 0.f;

    // ---- deformation tower: dx of this tile into dxs ----
    deform_tower_forward(dm, wdef, wst, act, tb, dxs, x);

    // ---- canonical field at x + dx ----
    if (live) {
      float xyz[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) xyz[a] = __fadd_rn(x[a], moving ? dxs[tid * 3 + a] : 0.f);
      field_sample(meta, tab, w, xyz, d3, m, i, lod_mask, density_only, out);
    }
    __syncwarp();  // dx is read before the next tile's tower writes it
  }
}

}  // namespace

extern "C" int sdn_dyn_field_fwd(const float* x3, const float* d3, long long m, const void* tab,
                                 const void* wbuf, const long long* meta, float bound,
                                 const void* wdef, const long long* dmeta, const float* tcond,
                                 int lod_mask, int density_only, float* out, void* stream) {
  FieldMeta fm;
  DeformMeta dm;
  int bad = fill_meta(meta, bound, &fm);
  if (!bad) bad = fill_deform_meta(dmeta, &dm);
  if (bad) return bad;
  const size_t smem = tower_forward_smem((size_t)fm.w_elems * sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(dyn_field_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dyn_field_fwd_kernel, kTile, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  long long blocks = (m + kTile - 1) / kTile;
  const long long cap = (long long)n_sm * per_sm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  dyn_field_fwd_kernel<<<(unsigned)blocks, kTile, smem, (cudaStream_t)stream>>>(
      x3, d3, m, (const __nv_bfloat16*)tab, (const __nv_bfloat16*)wbuf,
      (const __nv_bfloat16*)wdef, tcond, fm, dm, lod_mask, density_only, out);
  return (int)cudaGetLastError();
}
