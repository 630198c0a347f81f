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
  {
    const uint4* src = reinterpret_cast<const uint4*>(wbuf);
    uint4* dst = reinterpret_cast<uint4*>(ws);
    for (int i = threadIdx.x; i < meta.w_elems / 8; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();
  const __nv_bfloat16* w0 = ws + meta.w_off[0];
  const __nv_bfloat16* w1t = ws + meta.w_off[1];
  const __nv_bfloat16* wc0 = ws + meta.w_off[2];
  const __nv_bfloat16* wc1t = ws + meta.w_off[3];
  const __nv_bfloat16* wc2 = ws + meta.w_off[4];

  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x) {
    float xyz[3], x01[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      xyz[a] = x3[a * m + i];
      x01[a] = unit01(xyz[a], meta.bound);
    }

    // ---- sigma tower input layer, accumulated feature by feature ----
    float h[kHid];
#pragma unroll
    for (int j = 0; j < kHid; ++j) h[j] = 0.f;
    int row = 0;
    for (int s = 0; s < meta.n_scales; ++s) {
      const int res = meta.res[s], rank = meta.rank[s];
      if ((lod_mask >> s) & 1) { row += rank; continue; }
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
        axpy64(bf16r(__fmul_rn(__fmul_rn(fx, fy), fz)), w0 + (row + r) * kHid, h);
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
        // VM pairs (plane axes a, b; line axis e): (0,1,2) (0,2,1) (1,2,0)
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
          axpy64(bf16r(__fmul_rn(f, l)), w0 + (row + c) * kHid, h);
        }
        row += C;
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) axpy64(xyz[a], w0 + (row + a) * kHid, h);
    row += 3;
    for (int fd = 0; fd < meta.freq_degree; ++fd) {
      const float sc = (float)(1 << fd);
#pragma unroll
      for (int a = 0; a < 3; ++a) axpy64(sinf(xyz[a] * sc), w0 + (row + a) * kHid, h);
#pragma unroll
      for (int a = 0; a < 3; ++a) axpy64(cosf(xyz[a] * sc), w0 + (row + 3 + a) * kHid, h);
      row += 6;
    }
#pragma unroll
    for (int j = 0; j < kHid; ++j) h[j] = bf16r(fmaxf(h[j], 0.f));

    // ---- sigma tower output layer ----
    float o[kSigOut];
#pragma unroll
    for (int j = 0; j < kSigOut; ++j) o[j] = dot64(h, w1t + j * kHid);
    const float sigma = expf(o[0]);
    out[i] = sigma;
    if (density_only) {
      out[m + i] = 0.f;
      out[2 * m + i] = 0.f;
      out[3 * m + i] = 0.f;
      continue;
    }

    // ---- SH(d), degree 4 ----
    float sh[kShDim];
    sh_basis(meta, d3[i], d3[m + i], d3[2 * m + i], sh);

    // ---- colour tower ----
    float hc[kHidC];
#pragma unroll
    for (int j = 0; j < kHidC; ++j) hc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < kShDim; ++k) axpy64(bf16r(sh[k]), wc0 + k * kHidC, hc);
#pragma unroll
    for (int g = 0; g < kGeo; ++g) axpy64(bf16r(o[1 + g]), wc0 + (kShDim + g) * kHidC, hc);
#pragma unroll
    for (int j = 0; j < kHidC; ++j) hc[j] = bf16r(fmaxf(hc[j], 0.f));
    float rgb[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < kHidC; ++j) {
      const float a = bf16r(fmaxf(dot64(hc, wc1t + j * kHidC), 0.f));
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = fmaf(a, ldbf(wc2 + j * 3 + c), rgb[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) out[(c + 1) * m + i] = 1.f / (1.f + expf(-rgb[c]));
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
