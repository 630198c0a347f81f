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

#include "field_common.cuh"

namespace {

using namespace sdn;

constexpr int kTile = 256;        // samples per tile = threads per block
constexpr int kDefHid = 128;      // deform tower hidden width
constexpr int kLd = kDefHid + 8;  // padded row stride of the bf16 smem matrices
constexpr int kLastRows = 8;      // the last matrix [3, 128], padded to one n-tile
constexpr int kMaxDefLayers = 16;

struct DeformMeta {
  int n_layers;  // matrices: first, n_layers - 2 hidden, last
  int in_dim;    // 3 + 6 * n_freq spatial inputs of the first matrix
  int in_pad;    // in_dim padded to a multiple of 16
  int n_freq;    // multires_deform
  long long off[kMaxDefLayers];  // bf16 element offsets into wdef
};

// D[16x8] += A[16x16] * B[16x8]; A row-major, B column-major, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[mt][nt][.] = rows (32 of this warp, as two 16-row tiles) times the
// staged matrix wt [8 * NT outputs, k_dim] (output-major, stride kLd).
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A: a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..) a3 (g+8, 2t+8..)
//   B: b0 (k 2t..2t+1, n g) b1 (k 2t+8.., n g)
//   C: c0 (g, 2t) c1 (g, 2t+1) c2 (g+8, 2t) c3 (g+8, 2t+1)
template <int NT>
__device__ __forceinline__ void warp_layer(const __nv_bfloat16* rows, const __nv_bfloat16* wt,
                                           int k_dim, float (&acc)[2][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  for (int k0 = 0; k0 < k_dim; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const __nv_bfloat16* r0 = rows + (mt * 16 + g) * kLd + k0 + 2 * t;
      a[mt][0] = lds32(r0);
      a[mt][1] = lds32(r0 + 8 * kLd);
      a[mt][2] = lds32(r0 + 8);
      a[mt][3] = lds32(r0 + 8 * kLd + 8);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* wr = wt + (nt * 8 + g) * kLd + k0 + 2 * t;
      const uint32_t b0 = lds32(wr), b1 = lds32(wr + 8);
      mma_bf16(acc[0][nt], a[0], b0, b1);
      mma_bf16(acc[1][nt], a[1], b0, b1);
    }
  }
}

__device__ __forceinline__ uint32_t pack_relu_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  __nv_bfloat16* rows = act + warp * 32 * kLd;  // this warp's 32 samples
  __nv_bfloat16* mine = act + tid * kLd;        // this thread's sample

  for (long long base = (long long)blockIdx.x * kTile; base < m;
       base += (long long)gridDim.x * kTile) {
    const long long i = base + tid;
    const bool live = i < m;
    float x[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = live ? x3[a * m + i] : 0.f;

    // ---- ex = freq(x, n_freq), bf16, into this sample's row ----
#pragma unroll
    for (int a = 0; a < 3; ++a) mine[a] = __float2bfloat16_rn(x[a]);
    for (int fd = 0; fd < dm.n_freq; ++fd) {
      const float sc = (float)(1 << fd);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        mine[3 + 6 * fd + a] = __float2bfloat16_rn(sinf(x[a] * sc));
        mine[6 + 6 * fd + a] = __float2bfloat16_rn(cosf(x[a] * sc));
      }
    }
    for (int j = dm.in_dim; j < dm.in_pad; ++j) mine[j] = __float2bfloat16_rn(0.f);

    // ---- deformation tower ----
    for (int l = 0; l < dm.n_layers; ++l) {
      const bool last = l == dm.n_layers - 1;
      const int k_dim = l == 0 ? dm.in_pad : kDefHid;
      const int per_row = k_dim / 8;  // 16-byte chunks per matrix row
      const int chunks = (last ? kLastRows : kDefHid) * per_row;
      __syncthreads();  // the previous matrix is no longer read
      const uint4* src = reinterpret_cast<const uint4*>(wdef + dm.off[l]);
      for (int c = tid; c < chunks; c += kTile) {
        const int r = c / per_row, q = c - r * per_row;
        *reinterpret_cast<uint4*>(wst + r * kLd + q * 8) = src[c];
      }
      __syncthreads();  // the matrix, and at l == 0 the tile's ex rows, are in place
      if (!last) {
        float acc[2][kDefHid / 8][4];
        warp_layer<kDefHid / 8>(rows, wst, k_dim, acc);
        __syncwarp();  // every lane has read its A fragments: write in place
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < kDefHid / 8; ++nt) {
            const int col = nt * 8 + 2 * t;
            float* c = acc[mt][nt];
            if (l == 0) {
              c[0] += tb[col]; c[1] += tb[col + 1];
              c[2] += tb[col]; c[3] += tb[col + 1];
            }
            __nv_bfloat16* r0 = rows + (mt * 16 + g) * kLd + col;
            *reinterpret_cast<uint32_t*>(r0) = pack_relu_bf16(c[0], c[1]);
            *reinterpret_cast<uint32_t*>(r0 + 8 * kLd) = pack_relu_bf16(c[2], c[3]);
          }
      } else {
        float acc[2][1][4];
        warp_layer<1>(rows, wst, k_dim, acc);
        if (t < 2) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float* r0 = dxs + (warp * 32 + mt * 16 + g) * 3;
            r0[2 * t] = acc[mt][0][0];
            r0[8 * 3 + 2 * t] = acc[mt][0][2];
            if (t == 0) {
              r0[1] = acc[mt][0][1];
              r0[8 * 3 + 1] = acc[mt][0][3];
            }
          }
        }
      }
      __syncwarp();
    }

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

// dmeta (int64): n_layers, hidden, in_dim, in_pad, n_freq, then one bf16
// element offset per matrix. Layouts in wdef, all output-major (W^T):
// [128, in_pad] | (n_layers - 2) x [128, 128] | [8, 128] (rows 3..7 zero).
int fill_deform_meta(const long long* dmeta, DeformMeta* out) {
  DeformMeta dm = {};
  dm.n_layers = (int)dmeta[0];
  dm.in_dim = (int)dmeta[2];
  dm.in_pad = (int)dmeta[3];
  dm.n_freq = (int)dmeta[4];
  if (dm.n_layers < 2 || dm.n_layers > kMaxDefLayers || dmeta[1] != kDefHid ||
      dm.in_dim != 3 + 6 * dm.n_freq || dm.in_pad % 16 != 0 || dm.in_pad < dm.in_dim ||
      dm.in_pad > kDefHid)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < dm.n_layers; ++l) {
    dm.off[l] = dmeta[5 + l];
    if (dm.off[l] % 8 != 0) return (int)cudaErrorInvalidValue;
  }
  *out = dm;
  return 0;
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
  const size_t smem = ((size_t)fm.w_elems + (size_t)(kDefHid + kTile) * kLd) *
                          sizeof(__nv_bfloat16) +
                      (size_t)(kDefHid + 4 + kTile * 3) * sizeof(float);
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
