// The deformation tower of the dynamic field kernels (dyn_field_fwd.cu,
// dyn_field_bwd.cu) on mma.sync.m16n8k16 tensor-core tiles: the layout
// description passed by the ctypes entry points, the fragment loads, one
// layer's product for a warp, the tower's forward over a tile of 256 samples,
// and the kernel body that writes the warped positions (warp_tiles). Both entries
// run the forward through this code, so a forward recomputed inside the
// backward rounds exactly as the forward kernel does:
//   ex = [x, sin(2^f x), cos(2^f x)] in f32, rounded to bf16 -> W0 (bf16
//   operands, f32 sums) + the frame's f32 time bias -> (relu, bf16, W) per
//   further matrix.

#pragma once

#include "field_common.cuh"

namespace sdn {

constexpr int kDefHid = 128;      // deform tower hidden width
constexpr int kLd = kDefHid + 8;  // padded row stride of the bf16 smem matrices
constexpr int kLastRows = 8;      // the last matrix [3, 128], padded to one n-tile
constexpr int kMaxDefLayers = 16;
constexpr int kTowerTile = 256;   // samples per forward tile = threads per block

struct DeformMeta {
  int n_layers;  // matrices: first, n_layers - 2 hidden, last
  int in_dim;    // 3 + 6 * n_freq spatial inputs of the first matrix
  int in_pad;    // in_dim padded to a multiple of 16
  int n_freq;    // multires_deform
  long long off[kMaxDefLayers];  // bf16 element offsets into wdef
};

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[mt][nt][.] = rows (16 * MT of this warp) times the staged matrix
// wt [8 * NT rows n, k_dim] (stride kLd): acc = rows . wt^T.
// (mma_bf16 and its fragment layout are in field_common.cuh.)
template <int MT, int NT>
__device__ __forceinline__ void warp_layer(const __nv_bfloat16* rows, const __nv_bfloat16* wt,
                                           int k_dim, float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  for (int k0 = 0; k0 < k_dim; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
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
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
    }
  }
}

// Copy a matrix of `rows` rows of k_dim bf16 (k_dim a multiple of 8, dense in
// global memory) into the staging buffer wst (row stride kLd) with the whole
// block; the caller synchronises before and after.
template <int kThreads>  // threads of the block
__device__ __forceinline__ void stage_matrix(const __nv_bfloat16* src_mat, int rows, int k_dim,
                                             __nv_bfloat16* wst) {
  const int per_row = k_dim / 8;  // 16-byte chunks per matrix row
  const uint4* src = reinterpret_cast<const uint4*>(src_mat);
  for (int c = threadIdx.x; c < rows * per_row; c += kThreads) {
    const int r = c / per_row, q = c - r * per_row;
    *reinterpret_cast<uint4*>(wst + r * kLd + q * 8) = src[c];
  }
}

// ex = freq(x, n_freq) of one sample, bf16, into its row; frequencies
// fd = first, first + step, ... (first == 0 also writes x and the zero pad).
__device__ __forceinline__ void encode_position(const DeformMeta& dm, const float* x,
                                                __nv_bfloat16* row, int first, int step) {
  if (first == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) row[a] = __float2bfloat16_rn(x[a]);
    for (int j = dm.in_dim; j < dm.in_pad; ++j) row[j] = __float2bfloat16_rn(0.f);
  }
  for (int fd = first; fd < dm.n_freq; fd += step) {
    const float sc = (float)(1 << fd);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      row[3 + 6 * fd + a] = __float2bfloat16_rn(sinf(x[a] * sc));
      row[6 + 6 * fd + a] = __float2bfloat16_rn(cosf(x[a] * sc));
    }
  }
}

// The tower's forward over a tile of kTowerTile samples, one per thread of a
// block of kTowerTile threads; every thread of the block must call it. The
// tile's activations live in `act` as bf16 [kTowerTile, kLd]. Warp w owns
// rows 32w..32w+31 through every layer: it multiplies them by the layer's
// matrix into 128 f32 accumulators per thread and writes relu'd bf16 back in
// place, so layers need no block barrier for the activations. Each layer's
// matrix is staged from wdef into wst by the whole block, between two
// barriers. tb is the first layer's time bias [kDefHid]. Leaves the raw
// output dx of sample s in dxs[3 s .. 3 s + 2]; the caller synchronises its
// warp before the next call overwrites dxs.
__device__ __forceinline__ void deform_tower_forward(const DeformMeta& dm,
                                                     const __nv_bfloat16* __restrict__ wdef,
                                                     __nv_bfloat16* wst, __nv_bfloat16* act,
                                                     const float* tb, float* dxs,
                                                     const float* x) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  __nv_bfloat16* rows = act + warp * 32 * kLd;  // this warp's 32 samples
  encode_position(dm, x, act + tid * kLd, 0, 1);

  for (int l = 0; l < dm.n_layers; ++l) {
    const bool last = l == dm.n_layers - 1;
    const int k_dim = l == 0 ? dm.in_pad : kDefHid;
    __syncthreads();  // the previous matrix is no longer read
    stage_matrix<kTowerTile>(wdef + dm.off[l], last ? kLastRows : kDefHid, k_dim, wst);
    __syncthreads();  // the matrix, and at l == 0 the tile's ex rows, are in place
    if (!last) {
      float acc[2][kDefHid / 8][4];
      warp_layer<2, kDefHid / 8>(rows, wst, k_dim, acc);
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
      warp_layer<2, 1>(rows, wst, k_dim, acc);
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
}

// Shared memory of deform_tower_forward after the caller's own `head` bytes:
// wst | act | tb [kDefHid + 4] | dxs [kTowerTile * 3].
inline size_t tower_forward_smem(size_t head) {
  return head + (size_t)(kDefHid + kTowerTile) * kLd * sizeof(__nv_bfloat16) +
         (size_t)(kDefHid + 4 + kTowerTile * 3) * sizeof(float);
}

// xw [3, m] = x + dx(x, t): the tower's forward over tiles of kTowerTile
// samples, the body of a kernel of kTowerTile threads and persistent blocks
// with tower_forward_smem(0) bytes of dynamic shared memory. tcond is the
// first layer's time bias [kDefHid] and the flag t != 0; at t == 0 the tower
// is skipped and xw = x. With a list (list [*count], device memory) only the
// listed samples are warped, each into its own column of xw; the others'
// columns are not written. The forward entry (dyn_field_fwd.cu) and the
// backward's (dyn_field_bwd.cu) each wrap it in a kernel of their own name,
// so they warp alike and a profile tells them apart.
__device__ __forceinline__ void warp_tiles(const float* __restrict__ x3, long long m,
                                           const __nv_bfloat16* __restrict__ wdef,
                                           const float* __restrict__ tcond,
                                           const DeformMeta& dm, float* __restrict__ xw,
                                           const int* __restrict__ list = nullptr,
                                           const int* __restrict__ count = nullptr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* wst = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* act = wst + kDefHid * kLd;
  float* tb = reinterpret_cast<float*>(act + kTowerTile * kLd);
  float* dxs = tb + kDefHid + 4;
  const int tid = threadIdx.x;
  for (int j = tid; j < kDefHid + 1; j += kTowerTile) tb[j] = tcond[j];
  __syncthreads();
  const bool moving = tb[kDefHid] != 0.f;
  const long long n = list != nullptr ? (long long)*count : m;
  for (long long base = (long long)blockIdx.x * kTowerTile; base < n;
       base += (long long)gridDim.x * kTowerTile) {
    const bool live = base + tid < n;
    const long long i = !live ? 0 : (list != nullptr ? (long long)list[base + tid] : base + tid);
    float x[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = live ? x3[a * m + i] : 0.f;
    if (moving) deform_tower_forward(dm, wdef, wst, act, tb, dxs, x);  // block-uniform
    if (live) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        xw[a * m + i] = __fadd_rn(x[a], moving ? dxs[tid * 3 + a] : 0.f);
    }
    __syncwarp();  // dx is read before the next tile's tower writes it
  }
}

using WarpKernel = void (*)(const float*, long long, const __nv_bfloat16*, const float*,
                            const DeformMeta, float*, const int*, const int*);

// Launch `kernel` (a wrapper of warp_tiles) over m samples, or over the
// listed ones of them, on `stream`; returns cudaGetLastError().
inline int launch_warp(WarpKernel kernel, const float* x3, long long m,
                       const __nv_bfloat16* wdef, const float* tcond, const DeformMeta& dm,
                       float* xw, const int* list, const int* count, cudaStream_t stream) {
  const size_t smem = tower_forward_smem(0);
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTowerTile, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  long long blocks = (m + kTowerTile - 1) / kTowerTile;
  if (blocks > (long long)n_sm * per_sm) blocks = (long long)n_sm * per_sm;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, kTowerTile, smem, stream>>>(x3, m, wdef, tcond, dm, xw, list, count);
  return (int)cudaGetLastError();
}

// dmeta (int64): n_layers, hidden, in_dim, in_pad, n_freq, then one bf16
// element offset per matrix. Layouts in wdef, all output-major (W^T):
// [128, in_pad] | (n_layers - 2) x [128, 128] | [8, 128] (rows 3..7 zero).
inline int fill_deform_meta(const long long* dmeta, DeformMeta* out) {
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

}  // namespace sdn
