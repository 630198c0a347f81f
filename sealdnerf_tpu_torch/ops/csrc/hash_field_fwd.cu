// Instant-NGP hash-grid field forward for Hopper (sm_90a): K5.
//
// Replaces no TPU kernel: the JAX package computes this field in plain XLA
// (sealdnerf_tpu/ops/grid_encode.py and models/ngp.py), and so did the port
// until K5. Per sample it computes:
//   - the multiresolution grid encoding: 16 levels of 2 features, per level
//     the trilinear sum of the 8 corners of the sample's cell, read from a
//     packed bf16 copy of the table at the tiled index while the level's
//     dense grid fits its rows, else at the prime-XOR hash, in 32 bits,
//     modulo the rows; a sample outside the unit cube encodes to zeros;
//   - sigma tower 32 -> 64 -> 16 (bf16 products, f32 sums), exp on row 0;
//   - colour tower SH(4) ++ geo(15) -> 64 -> 64 -> 3, sigmoid.
// Output rows (sigma, r, g, b) as [4, M] f32, as K1's.
//
// What bounds it: the towers are 9,344 MACs a sample, 19 ns of tensor-core
// time per 1,000 samples; the encoding is 128 random 4-byte reads a sample
// (16 levels x 8 corners) from a 24.5 MB table at the published widths,
// which fits the 50 MB L2 but not L1: every read is a 32-byte sector of L2
// for the fine levels, so latency and L2 sector throughput bound it, not the
// arithmetic. Design: K1's tile walk and tower code (field_tile of
// field_fwd_body.cuh, instantiated with the hash segment set): a warp owns 16
// samples, the sigma tower's 32 input columns are exactly one k-block, so
// thread t of a quad computes levels 4t..4t+3 of the quad's two samples and
// its features are the first product's A fragments directly; each level's
// eight reads are issued together, and a warp keeps 16 x 16 x 8 reads of its
// tile in flight across its lanes. The coarse levels' corners are shared by
// neighbouring samples of a ray and of neighbouring rays, and hit L1.
// `density_only` stops after the sigma tower (the occupancy grid's refresh).
//
// C interface for ctypes: sdn_hash_field_fwd returns cudaGetLastError() after
// the launch; 0 means the launch was accepted. meta is FieldMeta's head with
// no scales and planes, the tile layout of one k-block of four hash segments
// (sub 4t), then per level (scale as f32 bits, res, s1, s2, size, off,
// hashed); `tab` is the bf16 table [rows, 2], `wfwd` the packed tower
// weights; feat_out as in sdn_field_fwd.

#include <string.h>

#include "field_fwd_body.cuh"

using namespace sdn;

namespace {

// The hash levels behind the tile layout; 0 or cudaErrorInvalidValue for a
// layout K5 does not take (other than one block of four hash segments).
int fill_hash_meta(const long long* meta, const FieldMeta& fm, const TileMeta& tm,
                   HashMeta* out) {
  if (fm.n_scales != 0 || fm.n_planes != 0 || tm.n_blocks != 1 || tm.blk_kind[0] != kSegHash)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < 4; ++t)
    if (tm.seg[t].kind != kSegHash || tm.seg[t].sub != 4 * t) return (int)cudaErrorInvalidValue;
  const long long* q = meta + 10 + 7 + tm.n_blocks + 7 * 4 * tm.n_blocks;
  HashMeta hm = {};
  for (int l = 0; l < kHashLevels; ++l, q += 7) {
    HashLevel& L = hm.lv[l];
    const uint32_t bits = (uint32_t)q[0];
    memcpy(&L.scale, &bits, sizeof(float));
    L.res = (int)q[1];
    L.s1 = (uint32_t)q[2];
    L.s2 = (uint32_t)q[3];
    L.size = (uint32_t)q[4];
    L.off = (uint32_t)q[5];
    L.hashed = (int)q[6];
    if (L.res < 1 || q[4] < 1 || q[4] > 0xffffffffLL || q[5] < 0 || q[5] + q[4] > 0xffffffffLL)
      return (int)cudaErrorInvalidValue;
    // the modulo's shortcuts: a hashed level's rows are a power of two; a
    // tiled index, at most (res + 1) (1 + s1 + s2), stays below twice the rows
    const long long top = (long long)(L.res + 1) * (1 + q[2] + q[3]);
    if (L.hashed ? (L.size & (L.size - 1u)) != 0u : top >= 2 * q[4])
      return (int)cudaErrorInvalidValue;
  }
  *out = hm;
  return 0;
}

// Persistent blocks of 8 warps; consecutive warps take consecutive tiles.
__global__ void __launch_bounds__(kFwdBlock, 2)
hash_field_fwd_kernel(const float* __restrict__ x3, const float* __restrict__ d3, long long m,
                      const __nv_bfloat16* __restrict__ tab,
                      const __nv_bfloat16* __restrict__ wfwd,
                      const __grid_constant__ FieldMeta meta, const __grid_constant__ TileMeta tm,
                      const __grid_constant__ HashMeta hm, int density_only,
                      float* __restrict__ out, __nv_bfloat16* __restrict__ feat_out) {
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
    field_tile<kHashSegs>(meta, tm, tab, w, xyz, idx, d3, m, 0, density_only, out, feat_out,
                          &hm);
  }
}

}  // namespace

extern "C" int sdn_hash_field_fwd(const float* x3, const float* d3, long long m, const void* tab,
                                  const void* wfwd, const long long* meta, float bound,
                                  int density_only, float* out, void* feat_out, void* stream) {
  FieldMeta fm;
  TileMeta tm;
  HashMeta hm;
  int bad = fill_meta(meta, bound, &fm);
  if (!bad) bad = fill_tile_meta(meta, fm, &tm);
  if (!bad) bad = fill_hash_meta(meta, fm, tm, &hm);
  if (bad) return bad;
  const size_t smem = (size_t)tm.w_elems * sizeof(__nv_bfloat16);
  long long blocks = 0;
  bad = fwd_blocks(hash_field_fwd_kernel, m, smem, &blocks);
  if (bad) return bad;
  hash_field_fwd_kernel<<<(unsigned)blocks, kFwdBlock, smem, (cudaStream_t)stream>>>(
      x3, d3, m, (const __nv_bfloat16*)tab, (const __nv_bfloat16*)wfwd, fm, tm, hm, density_only,
      out, (__nv_bfloat16*)feat_out);
  return (int)cudaGetLastError();
}
