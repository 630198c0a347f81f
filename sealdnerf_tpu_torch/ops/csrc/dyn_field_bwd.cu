// Dynamic (time-conditioned) CP/VM field backward for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// sealdnerf_tpu/ops/pallas_field.py:_dyn_field_bwd_kernel (entry
// _dyn_bwd_pallas_call, custom VJP cp_dnerf_train_fused). Given the cotangent
// g_out [4, M] of the dynamic forward's rows (sigma, r, g, b) at one time t,
// it recomputes the deformation tower and the canonical field and returns the
// f32 gradients of every table, of the five canonical tower matrices and of
// the deformation tower's matrices, the 13 time rows of the first included.
// Positions, directions and t get no gradient.
//
// Rounding points (those of the Pallas kernel):
//   - tower forward: as dyn_field_fwd.cu (deform_tower.cuh);
//   - canonical backward at xw = x + dx: as field_bwd.cu (field_bwd_body.cuh),
//     plus g_x = d(loss)/d(xw) through the line scales and planes with
//     res <= cutoff (the slopes -sign(xa - i) of the two hat taps times
//     (res - 1) / (2 bound), zero outside |xw| < bound, taps in bf16, f32
//     sums) and through the frequency features (W0^T bf16(g_h0), then
//     2^f cos and -2^f sin in f32);
//   - tower backward: g_h = g_x; per matrix l, from the last to the second,
//     g_W[l] += bf16(g_h) (x) bf16(r[l-1]) and g_h = (bf16(g_h) W[l]^T) masked
//     by r[l-1] > 0, f32 sums; the first matrix's spatial rows from ex; its
//     time rows from bf16(sum over samples of g_h) (x) bf16(freq(t)). The
//     Pallas kernel rounds that sum once per tile of its grid, this one once
//     for the whole call, after summing in f32.
//   - t == 0: the flag arrives in device memory beside the time bias, as in
//     the forward kernel; then dx = 0, every deform gradient is exactly 0 and
//     the canonical gradients are those of the static backward at x.
//
// What bounds it: operations. Per sample the tower costs ~107k MACs each for
// the recompute, the input gradients and the weight gradients, all bf16 x
// bf16 -> f32 and so on mma.sync.m16n8k16; the canonical half is the static
// backward's ~72k MACs on the FP32 pipe plus its table atomics.
//
// Design: shared memory decides it. The static backward already fills 163 KB
// for a 64-sample tile, and the tower's backward needs every hidden
// activation of its tile (7 x 128 bf16 a sample) beside a staged matrix, so
// one block cannot hold both. The entry point runs four kernels on the
// caller's stream, all written here, and counts as one launch:
//   1. warp_kernel (warp_tiles of deform_tower.cuh, which the forward entry
//      runs too): the tower's forward (deform_tower_forward, tiles of 256
//      samples) writes xw [3, M] to device memory (3 MB a training step).
//   2. field_bwd_kernel<true>: the static backward's body at xw; it also
//      computes g_x per sample and appends the samples that carry a cotangent
//      to a compact list (index, g_x), so that the tower's backward skips the
//      march's invalid samples.
//   3. tower_bwd_kernel: persistent blocks of 256 threads walk the list in
//      tiles of 64 samples. A tile recomputes the tower keeping all hidden
//      activations in shared memory (bf16 [7][64][136], 122 KB), then walks
//      back through the matrices. Input gradients are the forward's product
//      with the matrix staged input-major (a second packed copy, wdef_in);
//      weight gradients are products over the tile's samples whose operands
//      are read transposed with ldmatrix.trans, warp w owning 16 output rows.
//   4. time_rows_kernel: the outer product for the first matrix's time rows.
// Cross-block weight sums: each tile adds its [128, 128] product to the
// gradient buffer with one atomicAdd per nonzero entry (the buffer, 434 KB,
// stays in L2). Per-block partial buffers would need 57 MB and a second pass.
// So the results differ from run to run in their last bits, as the static
// backward's do. Later work: wider tiles by recomputing activations, wgmma,
// vector atomics.
//
// C interface for ctypes: sdn_dyn_field_bwd adds into g_tab, g_w, g_wdef
// (laid out like wdef) and g_tsum [128], which the caller zeroes along with
// `count`; it writes g_wtime [tdim, 128]; xw [3, M], idx [M] and gx [3, M]
// are scratch. acts, unless null, is bf16 [n_layers, M, 128] and receives the
// tower backward's recomputed ex and hidden activations in the list's order
// (for checks). Returns the first error of any launch, else 0.

#include "deform_tower.cuh"
#include "field_bwd_body.cuh"

namespace {

using namespace sdn;

constexpr int kBT = 64;         // samples per tile of the tower's backward
constexpr int kBThreads = 256;  // 8 warps

// ---------------------------------------------------------------- phase 1
__global__ void __launch_bounds__(kTowerTile)
warp_kernel(const float* __restrict__ x3, long long m, const __nv_bfloat16* __restrict__ wdef,
            const float* __restrict__ tcond, const DeformMeta dm, float* __restrict__ xw) {
  warp_tiles(x3, m, wdef, tcond, dm, xw);
}

// ---------------------------------------------------------------- phase 3
// Four 8x8 b16 matrices, transposed, from the shared-memory rows that the
// lanes address (lanes 8j..8j+7 give the rows of matrix j).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// out[o][i] += sum_s G[s][o] R[s][i] over the tile's kBT samples, for the 16
// rows o = 16 warp .. 16 warp + 15 and i < 16 n_pairs; G and R are bf16
// [kBT][kLd] in shared memory, out is f32 with row stride ld_out in device
// memory. The product's A operand is G^T and its B operand R, both stored
// sample-major, so both are read with ldmatrix.trans:
//   A (16 o x 16 s): matrices (s 0-7, o 0-7) (s 0-7, o 8-15) (s 8-15, o 0-7)
//                    (s 8-15, o 8-15) are a0..a3;
//   B (16 s x 16 i): matrices (s 0-7, i 0-7) (s 8-15, i 0-7) are b0, b1 of one
//                    n-tile, (s 0-7, i 8-15) (s 8-15, i 8-15) of the next.
__device__ __forceinline__ void warp_outer(const __nv_bfloat16* G, const __nv_bfloat16* R,
                                           int n_pairs, float* out, int ld_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int r8 = lane & 7, hi3 = (lane >> 3) & 1, hi4 = (lane >> 4) & 1;
  float acc[kDefHid / 8][4];
#pragma unroll
  for (int nt = 0; nt < kDefHid / 8; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
  for (int k0 = 0; k0 < kBT; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4_trans(a, G + (k0 + hi4 * 8 + r8) * kLd + 16 * warp + hi3 * 8);
#pragma unroll
    for (int np = 0; np < kDefHid / 16; ++np) {
      if (np < n_pairs) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, R + (k0 + hi3 * 8 + r8) * kLd + 16 * np + hi4 * 8);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  float* o0 = out + (long long)(16 * warp + g) * ld_out + 2 * t;
  float* o1 = o0 + 8 * (long long)ld_out;
#pragma unroll
  for (int nt = 0; nt < kDefHid / 8; ++nt) {
    if (nt < 2 * n_pairs) {
      red_add(o0 + nt * 8, acc[nt][0]);
      red_add(o0 + nt * 8 + 1, acc[nt][1]);
      red_add(o1 + nt * 8, acc[nt][2]);
      red_add(o1 + nt * 8 + 1, acc[nt][3]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory of tower_bwd_kernel, in bytes from the start:
//   wst [128][kLd] bf16 | ex [kBT][kLd] | act [n_layers - 1][kBT][kLd] |
//   ga, gb [kBT][kLd] | tb f32 [128 + 4] | rowsum f32 [128] | gxs f32 [kBT][4]
inline size_t tower_bwd_smem(int n_layers) {
  return (size_t)(kDefHid + (size_t)(n_layers + 2) * kBT) * kLd * sizeof(__nv_bfloat16) +
         (size_t)(kDefHid + 4 + kDefHid + 4 * kBT) * sizeof(float);
}

__global__ void __launch_bounds__(kBThreads)
tower_bwd_kernel(const float* __restrict__ x3, long long m, const int* __restrict__ count,
                 const int* __restrict__ idx, const float* __restrict__ gxc,
                 const __nv_bfloat16* __restrict__ wdef,
                 const __nv_bfloat16* __restrict__ wdef_in, const float* __restrict__ tcond,
                 const DeformMeta dm, float* __restrict__ g_wdef, float* __restrict__ g_tsum,
                 __nv_bfloat16* __restrict__ acts_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* wst = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ex = wst + kDefHid * kLd;
  __nv_bfloat16* act = ex + kBT * kLd;  // act[l]: relu'd bf16 output of matrix l
  __nv_bfloat16* ga = act + (dm.n_layers - 1) * kBT * kLd;
  __nv_bfloat16* gb = ga + kBT * kLd;
  float* tb = reinterpret_cast<float*>(gb + kBT * kLd);
  float* rowsum = tb + kDefHid + 4;
  float* gxs = rowsum + kDefHid;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (tcond[kDefHid] == 0.f) return;  // t == 0: the warp is gated off, no gradient
  const int n = *count;
  for (int j = tid; j < kDefHid; j += kBThreads) {
    tb[j] = tcond[j];
    rowsum[j] = 0.f;
  }
  const int n_hidden = dm.n_layers - 1;  // matrices whose output is kept
  const int mt = warp & 3, nh = warp >> 2;  // this warp's 16 samples x 64 columns
  const int row0 = mt * 16 + g;

  for (int base = blockIdx.x * kBT; base < n; base += gridDim.x * kBT) {
    __syncthreads();  // the previous tile's buffers are no longer read
    // ---- the tile's samples: position, g_x; ex = freq(x), bf16 ----
    {
      const int s = tid & (kBT - 1), part = tid >> 6;  // four threads a sample
      const bool live = base + s < n;
      const long long i = live ? idx[base + s] : 0;
      float x[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) x[a] = live ? x3[a * m + i] : 0.f;
      encode_position(dm, x, ex + s * kLd, part, kBThreads / kBT);
      if (part == 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) gxs[4 * s + a] = live ? gxc[a * m + base + s] : 0.f;
      }
    }

    // ---- forward, every hidden activation kept ----
    for (int l = 0; l < n_hidden; ++l) {
      const int k_dim = l == 0 ? dm.in_pad : kDefHid;
      __syncthreads();  // the staged matrix is no longer read
      stage_matrix<kBThreads>(wdef + dm.off[l], kDefHid, k_dim, wst);
      __syncthreads();  // the matrix and the layer's input rows are in place
      const __nv_bfloat16* in = l == 0 ? ex : act + (l - 1) * kBT * kLd;
      __nv_bfloat16* outp = act + l * kBT * kLd;
      float acc[1][8][4];
      warp_layer<1, 8>(in + mt * 16 * kLd, wst + nh * 64 * kLd, k_dim, acc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nh * 64 + nt * 8 + 2 * t;
        float* c = acc[0][nt];
        if (l == 0) {
          c[0] += tb[col]; c[1] += tb[col + 1];
          c[2] += tb[col]; c[3] += tb[col + 1];
        }
        *reinterpret_cast<uint32_t*>(outp + row0 * kLd + col) = pack_relu_bf16(c[0], c[1]);
        *reinterpret_cast<uint32_t*>(outp + (row0 + 8) * kLd + col) = pack_relu_bf16(c[2], c[3]);
      }
    }

    // ---- the last matrix [hidden, 3]: K = 3, on the FP32 pipe ----
    __syncthreads();
    if (acts_out) {
      // for checks: ex and every hidden activation of the tile's samples, as
      // 16-byte chunks of rows of 128 (ex: the columns below in_pad hold data)
      for (int c = tid; c < dm.n_layers * kBT * (kDefHid / 8); c += kBThreads) {
        const int q = c & 15, s = (c >> 4) & (kBT - 1), l = c / (16 * kBT);
        if (base + s < n && (l > 0 || q * 8 < dm.in_pad)) {
          const __nv_bfloat16* src = (l == 0 ? ex : act + (l - 1) * kBT * kLd) + s * kLd + q * 8;
          *reinterpret_cast<uint4*>(acts_out + ((long long)l * m + base + s) * kDefHid + q * 8) =
              *reinterpret_cast<const uint4*>(src);
        }
      }
    }
    stage_matrix<kBThreads>(wdef + dm.off[dm.n_layers - 1], kLastRows, kDefHid, wst);
    __syncthreads();
    const __nv_bfloat16* r_last = act + (n_hidden - 1) * kBT * kLd;
    {
      // g_W[last][o][i] += sum_s bf16(g_x[s][o]) r[s][i]: a column i and half
      // of the samples per thread
      const int i = tid & (kDefHid - 1), s0 = (tid >> 7) * (kBT / 2);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int s = s0; s < s0 + kBT / 2; ++s) {
        const float r = ldbf(r_last + s * kLd + i);
        a0 = fmaf(bf16r(gxs[4 * s]), r, a0);
        a1 = fmaf(bf16r(gxs[4 * s + 1]), r, a1);
        a2 = fmaf(bf16r(gxs[4 * s + 2]), r, a2);
      }
      float* gl = g_wdef + dm.off[dm.n_layers - 1];
      red_add(gl + i, a0);
      red_add(gl + kDefHid + i, a1);
      red_add(gl + 2 * kDefHid + i, a2);
    }
    __nv_bfloat16* gcur = ga;
    __nv_bfloat16* gnext = gb;
    {
      // g_h = (bf16(g_x) W[last]^T) masked by r > 0, rounded to bf16
      const float w0 = ldbf(wst + (tid & (kDefHid - 1))),
                  w1 = ldbf(wst + kLd + (tid & (kDefHid - 1))),
                  w2 = ldbf(wst + 2 * kLd + (tid & (kDefHid - 1)));
      const int i = tid & (kDefHid - 1), s0 = (tid >> 7) * (kBT / 2);
      float colsum = 0.f;
      for (int s = s0; s < s0 + kBT / 2; ++s) {
        float v = bf16r(gxs[4 * s]) * w0;
        v = fmaf(bf16r(gxs[4 * s + 1]), w1, v);
        v = fmaf(bf16r(gxs[4 * s + 2]), w2, v);
        v = ldbf(r_last + s * kLd + i) > 0.f ? v : 0.f;
        colsum += v;
        gcur[s * kLd + i] = __float2bfloat16_rn(v);
      }
      // a tower of two matrices: this is the first matrix's output gradient
      if (n_hidden == 1) atomicAdd(rowsum + i, colsum);
    }

    // ---- hidden matrices, from the last to the second ----
    for (int l = n_hidden - 1; l >= 1; --l) {
      const __nv_bfloat16* r_in = act + (l - 1) * kBT * kLd;  // this matrix's input
      __syncthreads();  // g_h of this layer is complete; wst is no longer read
      stage_matrix<kBThreads>(wdef_in + (long long)(l - 1) * kDefHid * kDefHid, kDefHid, kDefHid, wst);
      warp_outer(gcur, r_in, kDefHid / 16, g_wdef + dm.off[l], kDefHid);
      __syncthreads();  // the input-major matrix is in place
      float acc[1][8][4];
      warp_layer<1, 8>(gcur + mt * 16 * kLd, wst + nh * 64 * kLd, kDefHid, acc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nh * 64 + nt * 8 + 2 * t;
        float* c = acc[0][nt];
        const __nv_bfloat162 m0 =
            *reinterpret_cast<const __nv_bfloat162*>(r_in + row0 * kLd + col);
        const __nv_bfloat162 m1 =
            *reinterpret_cast<const __nv_bfloat162*>(r_in + (row0 + 8) * kLd + col);
        c[0] = __low2float(m0) > 0.f ? c[0] : 0.f;
        c[1] = __high2float(m0) > 0.f ? c[1] : 0.f;
        c[2] = __low2float(m1) > 0.f ? c[2] : 0.f;
        c[3] = __high2float(m1) > 0.f ? c[3] : 0.f;
        *reinterpret_cast<uint32_t*>(gnext + row0 * kLd + col) = pack_bf16(c[0], c[1]);
        *reinterpret_cast<uint32_t*>(gnext + (row0 + 8) * kLd + col) = pack_bf16(c[2], c[3]);
        if (l == 1) {
          // the time rows need the f32 sum over samples of the first
          // matrix's output gradient: over this warp's 16 rows by shuffles
          float s0 = c[0] + c[2], s1 = c[1] + c[3];
#pragma unroll
          for (int d = 4; d < 32; d <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, d);
            s1 += __shfl_xor_sync(0xffffffffu, s1, d);
          }
          if (g == 0) {
            atomicAdd(rowsum + col, s0);
            atomicAdd(rowsum + col + 1, s1);
          }
        }
      }
      __nv_bfloat16* sw = gcur;
      gcur = gnext;
      gnext = sw;
    }

    // ---- the first matrix: spatial rows from ex ----
    __syncthreads();
    warp_outer(gcur, ex, dm.in_pad / 16, g_wdef + dm.off[0], dm.in_pad);
  }
  __syncthreads();
  for (int j = tid; j < kDefHid; j += kBThreads) red_add(g_tsum + j, rowsum[j]);
}

// ---------------------------------------------------------------- phase 4
// g_wtime [tdim][128] = bf16(freq(t)) (x) bf16(g_tsum), the time rows of the
// first matrix; tcond holds freq(t) behind the bias and the flag.
__global__ void time_rows_kernel(const float* __restrict__ tcond, int tdim,
                                 const float* __restrict__ g_tsum, float* __restrict__ g_wtime) {
  const int j = threadIdx.x;
  const float s = tcond[kDefHid] != 0.f ? bf16r(g_tsum[j]) : 0.f;
  for (int k = 0; k < tdim; ++k) g_wtime[k * kDefHid + j] = s * bf16r(tcond[kDefHid + 1 + k]);
}

}  // namespace

extern "C" int sdn_dyn_field_bwd(const float* x3, const float* d3, const float* g_out,
                                 long long m, const void* tab, const void* wbuf,
                                 const long long* meta, float bound, const void* wdef,
                                 const void* wdef_in, const long long* dmeta, const float* tcond,
                                 int tdim, int cutoff, float* xw, int* count, int* idx,
                                 float* gx, float* g_tab, float* g_w, float* g_wdef,
                                 float* g_tsum, float* g_wtime, void* acts, void* stream_) {
  FieldMeta fm;
  DeformMeta dm;
  int bad = fill_meta(meta, bound, &fm);
  if (!bad) bad = fill_deform_meta(dmeta, &dm);
  if (bad) return bad;
  if (m < 1 || m > 0x7fffffffLL || tdim < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);

  // 1. xw = x + dx
  bad = launch_warp(warp_kernel, x3, m, (const __nv_bfloat16*)wdef, tcond, dm, xw,
                    stream);
  if (bad) return bad;

  // 2. canonical backward at xw, g_x and the compact list
  const GxOut gxo = {cutoff, count, idx, gx};
  bad = launch_field_bwd<true>(xw, d3, g_out, m, (const __nv_bfloat16*)tab,
                               (const __nv_bfloat16*)wbuf, fm, g_tab, g_w, gxo, stream);
  if (bad) return bad;

  // 3. the tower's backward over the list
  const size_t smem3 = tower_bwd_smem(dm.n_layers);
  if (smem3 > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tower_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (m + kBT - 1) / kBT;
  if (blocks > n_sm) blocks = n_sm;
  tower_bwd_kernel<<<(unsigned)blocks, kBThreads, smem3, stream>>>(
      x3, m, count, idx, gx, (const __nv_bfloat16*)wdef, (const __nv_bfloat16*)wdef_in, tcond,
      dm, g_wdef, g_tsum, (__nv_bfloat16*)acts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 4. the first matrix's time rows
  time_rows_kernel<<<1, kDefHid, 0, stream>>>(tcond, tdim, g_tsum, g_wtime);
  return (int)cudaGetLastError();
}
