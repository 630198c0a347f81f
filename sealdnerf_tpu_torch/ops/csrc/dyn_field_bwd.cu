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
//     g_W[l] += bf16(g_h) (x) r[l-1] and g_h = (bf16(g_h) W[l]^T) masked by
//     r[l-1] > 0, f32 sums (r[l-1]: the relu'd bf16 input of matrix l); the
//     first matrix's spatial rows from ex; its time rows from bf16(sum over
//     samples of g_h) (x) bf16(freq(t)). The Pallas kernel rounds that sum
//     once per tile of its grid, this one once for the whole call, after
//     summing the f32 g_h in f64.
//   - t == 0: the flag arrives in device memory beside the time bias, as in
//     the forward kernel; then dx = 0, every deform gradient is exactly 0 and
//     the canonical gradients are those of the static backward at x.
//
// What bounds it: operations. Per live sample the tower costs ~107k MACs each
// for the recompute, the input gradients and the weight gradients (0.119 ms
// for all three on 183,223 live samples at the tensor cores' 989 TFLOP/s),
// and the canonical half the static backward's ~72k; beside them the
// canonical half's feature arithmetic and its vector atomics.
//
// Design. The entry point runs six kernels on the caller's stream (4 and 5
// once a pass), all written here or in the headers, and counts as one
// launch:
//   1. compact_live_kernel (field_bwd_body.cuh) lists the samples that carry
//      a cotangent; everything after it walks that list, so the march's
//      invalid samples cost nothing, the warp included.
//   2. warp_kernel (warp_tiles of deform_tower.cuh, which the forward entry
//      runs too): xw of the listed samples, the same device function as K3's
//      warp, so the two agree bit for bit.
//   3. field_bwd_kernel<true>: the static backward's body at xw; it also
//      writes g_x of each listed sample, in the list's order.
//   4. tower_bwd_kernel: the blocks of the warp kernel (a producer warp that
//      brings the matrices into shared memory once a block, three consumer
//      warpgroups on tiles of 64 listed samples). A tile recomputes the
//      tower's forward in registers with the forward's own device function,
//      writes ex and every hidden activation to a scratch of tile images in
//      device memory and keeps their relu masks (64 bits a layer a thread),
//      then walks back through the matrices with the output gradient in
//      registers: g_h (x) W^T on wgmma with the matrix image read transposed
//      (MN-major), masked, rounded to bf16, and that tile written to a second
//      scratch. Each consumer warp sums the first matrix's output gradient
//      in f64 for the time rows in its own row of shared memory; the block
//      writes their sum out at its end.
//   5. tower_wgrad_kernel: the weight gradients as products over samples,
//      g_W[l] = G_l^T A_l with G_l, A_l the scratch tiles of matrix l's
//      output gradient and input: blocks (chunk of tiles, matrix), a producer
//      warp streams the tile pairs through a ring of three stages with
//      cp.async.bulk, two warpgroups (64 output rows each) sum them on wgmma
//      (both operands transposed from shared memory) in registers over all
//      the chunk's tiles, and each entry leaves the block once, as one f32
//      reduction into device memory.
//   6. time_rows_kernel: sums those rows in a fixed order (the time rows are
//      the same bits in every run) and forms the first matrix's time rows.
// Passes. The operands of the weight gradients make one round trip through
// device memory, 4 KB a listed sample at the default tower (two bf16 [128]
// rows a sample and matrix), written by tower_bwd_kernel and read by
// tower_wgrad_kernel. So that this scratch stays bounded whatever M, phases 4
// and 5 walk the list in passes of `window` tiles (the caller sizes it: at
// most 512 MB of scratch, 2,048 tiles or 131,072 samples at the default
// tower), each pass reusing the same scratch; a pass past the list's end
// costs two empty launches.
// Reductions into device memory. The design before this one added every
// tile's products (tiles of 64) with one atomic per entry: 6 * 16,384 + 128 *
// 64 + 3 * 128 = 106,880 per 64 samples, 1,670 a live sample. Now each
// tower_wgrad_kernel block adds its sums once: n_chunks * (H * 16,384 + 128 *
// in_pad + 3 * 128) a pass that reaches the list (H hidden matrices;
// n_chunks = min(ceil(2 SMs / n_layers), ceil(tiles of the pass / 16))); the
// time rows take none. At the default tower on 132 SMs: 33 * 106,880 =
// 3,527,040 a pass. On chip_smoke's phase 3d (M = 262,181, 183,223 live
// samples: two passes reach the list) 7,054,080 a call, 38.5 a live sample,
// 43 times fewer; when every sample is live at most 3,527,040 / 131,072 =
// 26.9 a sample in full passes, and 106,880 / 1,024 = 104 in a pass of fewer
// than 528 tiles. The sums' order changes with the grid, so results may
// differ from run to run in their last bits, as the static backward's do.
// Why still separate kernels from the canonical half: its block holds the
// canonical matrices twice and the partial weight gradients (220 KB at the
// default widths), the tower's backward its 212 KB of matrices; one block
// cannot hold both, and the 12 bytes of xw and of g_x a sample that pass
// between them through device memory are nothing beside either kernel's
// gathers.
//
// C interface for ctypes: sdn_dyn_field_bwd adds into g_tab, g_w and g_wdef
// (f32 [n_layers][128][128], matrix l output-major: row o, column i), which
// the caller zeroes along with `count`; it writes g_wtime [tdim, 128]; tsum
// (f64 [passes * min(SMs, ceil(S / 3))][128], S = min(window, ceil(M / 64)),
// passes = ceil(ceil(M / 64) / S)) is scratch; xw [3, M] (the listed
// samples' columns are written), idx [M] and gx [3, M] are scratch. gscr and
// ascr are the tower's scratch, bf16 [n_layers][S][64 x 128 tile image]
// each: ascr receives ex and the hidden activations that the tower's
// backward recomputed, gscr the bf16 output gradients of every matrix, tile
// by tile in the list's order. With acts_all set, ascr is [n_layers][ceil(M
// / 64)][tile image] and keeps every pass's tiles (for checks). rec_out is
// null or [4, M] and receives the forward's output that the canonical kernel
// recomputed. Returns the first error of any launch, else 0.

#include "deform_tower.cuh"
#include "field_bwd_body.cuh"

namespace {

using namespace sdn;

constexpr int kWgConsumers = 2;  // tower_wgrad_kernel's warpgroups: 64 output rows each
constexpr int kWgThreads = 128 * kWgConsumers + 32;  // and one producer warp
constexpr int kWgStages = 3;                       // tile pairs in tower_wgrad_kernel's ring
constexpr int kWgStageBytes = 2 * kTileBytes;      // G tile | A tile
constexpr int kChunkTiles = 16;                    // least tiles a chunk of the weight gradients

// ---------------------------------------------------------------- phase 2
__global__ void __launch_bounds__(kTowerThreads, 1)
warp_kernel(const float* __restrict__ x3, long long m, const __nv_bfloat16* __restrict__ wdef,
            const float* __restrict__ tcond, const DeformMeta dm, float* __restrict__ xw,
            const int* __restrict__ list, const int* __restrict__ count) {
  warp_tiles(x3, m, wdef, tcond, dm, xw, list, count);
}

// ---------------------------------------------------------------- phase 4
// acc[i] = 0 where bit i of the mask is clear.
__device__ __forceinline__ void apply_mask(float (&acc)[64], uint2 mk) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const uint32_t w = i < 32 ? mk.x : mk.y;
    if (!((w >> (i & 31)) & 1u)) acc[i] = 0.f;
  }
}

// g_h [64 x 128] (+)= the A fragments [64 x 16 k] . W^T for a matrix image of
// `rows` rows (output-major) read transposed: the input gradient.
__device__ __forceinline__ void chain_product(float (&acc)[64], const uint32_t (&a)[8][4],
                                              uint32_t wimg, int rows, int k_steps) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    if (kk < k_steps) wgmma_rs128<1>(acc, a[kk], desc_mnmajor(wimg, rows, kk), kk > 0);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
}

// The listed tiles of one pass: tiles base .. base + window - 1 of the list,
// as far as the list reaches.
__device__ __forceinline__ long long pass_tiles(const int* __restrict__ count, long long base,
                                                long long window) {
  const long long n = ((long long)*count + kTile - 1) / kTile - base;
  return n < 0 ? 0 : n < window ? n : window;
}

// One pass: the pass's tile k (list tile base + k) writes its images at tile
// k of gscr and of ascr, layers g_stride and a_stride bytes apart.
__global__ void __launch_bounds__(kTowerThreads, 1)
tower_bwd_kernel(const float* __restrict__ x3, long long m, const int* __restrict__ count,
                 const int* __restrict__ idx, const float* __restrict__ gxc,
                 const __nv_bfloat16* __restrict__ wdef, const float* __restrict__ tcond,
                 const DeformMeta dm, long long base, long long window,
                 unsigned char* __restrict__ gscr, long long g_stride,
                 unsigned char* __restrict__ ascr, long long a_stride,
                 double* __restrict__ tsum) {
  if (tcond[kDefHid] == 0.f) return;  // t == 0: the warp is gated off, no gradient
  const int tid = threadIdx.x;
  const long long n_tiles = pass_tiles(count, base, window);
  if (n_tiles == 0) {  // past the list's end: the block's time-row sums are 0
    if (tid < kDefHid) tsum[(long long)blockIdx.x * kDefHid + tid] = 0.0;
    return;
  }
  const TowerSmem sm = carve_tower_smem(dm);
  if (tid == 0) init_tower_barriers(sm);
  for (int j = tid; j < kDefHid; j += blockDim.x) sm.tb[j] = tcond[j];
  for (int j = tid; j < 4 * kConsumers * kDefHid; j += blockDim.x) sm.wsum[j] = 0.0;
  __syncthreads();
  const long long n = *count;
  const int rounds = tower_rounds(n_tiles);
  const Ring rg = make_ring(dm, true);
  const int wg = tid >> 7;
  if (wg == kConsumers) {
    tower_producer(dm, sm, rg, wdef, rounds);
    return;
  }
  const int lane = tid & 31, w4 = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int L = dm.n_layers;
  uint2 mask[kMaxDefLayers];
  for (int r = 0; r < rounds; ++r) {
    const long long tile = ((long long)r * gridDim.x + blockIdx.x) * kConsumers + wg;
    if (tile >= n_tiles) {
      ring_dry_round(rg, sm, r);
      continue;
    }
    long long p[2], i[2];
    bool live[2];
    float x0[3], x1[3];
    tile_rows(x3, m, idx, n, base + tile, p, i, live, x0, x1);
    float gx0[3], gx1[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      gx0[a] = live[0] ? gxc[a * m + p[0]] : 0.f;
      gx1[a] = live[1] ? gxc[a * m + p[1]] : 0.f;
    }
    uint32_t a[8][4];
    float acc[64];
    const TileKeep keep = {ascr + tile * kTileBytes, a_stride, mask};
    tower_forward_tile<true>(dm, sm, rg, r, x0, x1, a, acc, keep);

    // the last matrix: its output gradient bf16(g_x) in columns 0..2
    unsigned char* gt = gscr + tile * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[kk][q] = 0u;
    if (t == 0) {
      a[0][0] = pack_bf16(gx0[0], gx0[1]);
      a[0][1] = pack_bf16(gx1[0], gx1[1]);
    } else if (t == 1) {
      a[0][0] = pack_bf16(gx0[2], 0.f);
      a[0][1] = pack_bf16(gx1[2], 0.f);
    }
    store_tile(gt + (L - 1) * g_stride, a, w4, g, t, 1);
    chain_product(acc, a, smem_u32(sm.wlast), kLastRows, 1);
    apply_mask(acc, mask[L - 1]);
    // the hidden matrices, from the last to the second
    for (int l = L - 2; l >= 1; --l) {
      acc_to_frags(acc, a, false);
      store_tile(gt + l * g_stride, a, w4, g, t);
      int slot;
      uint32_t parity;
      ring_pos(rg, r, 2 * rg.H - l, slot, parity);
      mbar_wait(sm.full + 1 + slot, parity);
      chain_product(acc, a, smem_u32(sm.slots + (size_t)slot * kHidBytes), kDefHid, 8);
      ring_release(rg, sm, slot);
      apply_mask(acc, mask[l]);
    }
    // the first matrix: its output gradient summed over the warp's 16
    // samples in f64 into the warp's own row of sums (the time rows). The
    // f32 gradients of a sample are its own whatever the list's order, and
    // their f64 sum is as good as exact, so the sum that time_rows_kernel
    // rounds does not depend on which samples shared a tile, a block or a run
    double* ws = sm.wsum + (tid >> 5) * kDefHid;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        double s = (double)acc[4 * j + h] + (double)acc[4 * j + 2 + h];
#pragma unroll
        for (int d = 4; d < 32; d <<= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
        if (g == 0) ws[8 * j + 2 * t + h] += s;
      }
    acc_to_frags(acc, a, false);
    store_tile(gt, a, w4, g, t);
  }
  // the consumer warps' time-row sums are complete: the block's sum, over
  // its warps in order, to device memory for time_rows_kernel
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
  if (tid < kDefHid) {
    double s = 0.0;
    for (int w = 0; w < 4 * kConsumers; ++w) s += sm.wsum[w * kDefHid + tid];
    tsum[(long long)blockIdx.x * kDefHid + tid] = s;
  }
}

// ---------------------------------------------------------------- phase 5
// g_wdef[l] [128 o][128 i] += sum over one pass's listed samples of G_l[s][o]
// A_l[s][i] for matrix l = blockIdx.y, over the pass's tiles blockIdx.x,
// + gridDim.x, ... of the scratch (laid out as tower_bwd_kernel writes it).
// Consumer group w owns the output rows 64 w .. 64 w + 63.
__global__ void __launch_bounds__(kWgThreads, 2)
tower_wgrad_kernel(const int* __restrict__ count, const float* __restrict__ tcond,
                   const DeformMeta dm, long long base, long long window,
                   const unsigned char* __restrict__ gscr, long long g_stride,
                   const unsigned char* __restrict__ ascr, long long a_stride,
                   float* __restrict__ g_wdef) {
  if (tcond[kDefHid] == 0.f) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t s0 = smem_u32(smem_raw);
  unsigned char* stages = smem_raw + ((1024u - (s0 & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;
  const int tid = threadIdx.x, l = blockIdx.y;
  const long long n_tiles = pass_tiles(count, base, window);
  const long long c = blockIdx.x, n_chunks = gridDim.x;
  const long long mine = c < n_tiles ? (n_tiles - c + n_chunks - 1) / n_chunks : 0;
  if (mine == 0) return;
  if (tid == 0) {
    for (int k = 0; k < kWgStages; ++k) {
      mbar_init(full + k, 1);
      mbar_init(empty + k, 4 * kWgConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const unsigned char* gl = gscr + l * g_stride;
  const unsigned char* al = ascr + l * a_stride;
  const int wg = tid >> 7;
  if (wg == kWgConsumers) {
    if ((tid & 31) != 0) return;
    for (long long j = 0; j < mine; ++j) {
      const int st = (int)(j % kWgStages);
      if (j >= kWgStages) mbar_wait(empty + st, (uint32_t)((j / kWgStages - 1) & 1));
      const long long tile = c + j * n_chunks;
      unsigned char* dst = stages + st * kWgStageBytes;
      mbar_expect_tx(full + st, kWgStageBytes);
      bulk_load(dst, gl + tile * kTileBytes, kTileBytes, full + st);
      bulk_load(dst + kTileBytes, al + tile * kTileBytes, kTileBytes, full + st);
    }
    for (long long j = mine - kWgStages; j < mine; ++j)
      if (j >= 0) mbar_wait(full + (int)(j % kWgStages), (uint32_t)((j / kWgStages) & 1));
    return;
  }
  float acc[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) acc[q] = 0.f;
  for (long long j = 0; j < mine; ++j) {
    const int st = (int)(j % kWgStages);
    mbar_wait(full + st, (uint32_t)((j / kWgStages) & 1));
    const uint32_t gs = smem_u32(stages + st * kWgStageBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      wgmma_ss128_tt(acc, desc_mnmajor(gs + wg * (kTile * 128), kTile, kk),
                     desc_mnmajor(gs + kTileBytes, kTile, kk), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    if ((tid & 31) == 0) mbar_arrive(empty + st);
  }
  // acc[4 j + q]: row o = 64 wg + 16 w4 + g (+ 8 for q >= 2), column 8 j + 2 t + (q & 1)
  const int lane = tid & 31, w4 = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int rows = l == dm.n_layers - 1 ? 3 : kDefHid;
  const int cols = l == 0 ? 16 * first_ksteps(dm) : kDefHid;
  float* out = g_wdef + (long long)l * kDefHid * kDefHid;
#pragma unroll
  for (int q = 0; q < 64; ++q) {
    const int o = 64 * wg + 16 * w4 + g + ((q & 2) ? 8 : 0);
    const int i = 8 * (q >> 2) + 2 * t + (q & 1);
    if (o < rows && i < cols) red_add(out + o * kDefHid + i, acc[q]);
  }
}

// ---------------------------------------------------------------- phase 6
// g_wtime [tdim][128] = bf16(freq(t)) (x) bf16(sum), the time rows of the
// first matrix; sum: the f64 sum of tower_bwd_kernel's block sums tsum
// [blocks][128], in a fixed order (block b on thread row b % 8, then the
// rows in order), rounded to f32: a call's time rows are the same bits in
// every run. tcond holds freq(t) behind the bias and the flag. One block of
// 8 x 128 threads.
__global__ void __launch_bounds__(8 * kDefHid)
time_rows_kernel(const float* __restrict__ tcond, int tdim, int blocks,
                 const double* __restrict__ tsum, float* __restrict__ g_wtime) {
  __shared__ double part[8][kDefHid];
  const int c = threadIdx.x % kDefHid, w = threadIdx.x / kDefHid;
  const bool moving = tcond[kDefHid] != 0.f;  // at t == 0 tsum was not written
  double s = 0.0;
  if (moving)
    for (int b = w; b < blocks; b += 8) s += tsum[(long long)b * kDefHid + c];
  part[w][c] = s;
  __syncthreads();
  if (w != 0) return;
  double total = 0.0;
  for (int k = 0; k < 8; ++k) total += part[k][c];
  const float v = moving ? bf16r((float)total) : 0.f;
  for (int k = 0; k < tdim; ++k) g_wtime[k * kDefHid + c] = v * bf16r(tcond[kDefHid + 1 + k]);
}

}  // namespace

extern "C" int sdn_dyn_field_bwd(const float* x3, const float* d3, const float* g_out,
                                 long long m, const void* tab, const void* wfwd,
                                 const void* wbwd, const long long* meta, float bound,
                                 const void* wdef, const long long* dmeta, const float* tcond,
                                 int tdim, int cutoff, float* xw, int* count, int* idx, float* gx,
                                 float* g_tab, float* g_w, float* g_wdef, double* tsum,
                                 float* g_wtime, void* gscr, void* ascr, long long window,
                                 int acts_all, float* rec_out, void* stream_) {
  FieldMeta fm;
  TileMeta tm;
  BwdMeta bm;
  DeformMeta dm;
  int bad = fill_meta(meta, bound, &fm);
  if (!bad) bad = fill_tile_meta(meta, fm, &tm);
  if (!bad) bad = fill_bwd_meta(meta, fm, tm, &bm);
  if (!bad) bad = fill_deform_meta(dmeta, &dm);
  if (bad) return bad;
  if (m < 1 || m > 0x7fffffffLL || tdim < 0 || window < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);

  // 1. the samples with a cotangent
  bad = launch_compact(g_out, m, count, idx, stream);
  if (bad) return bad;

  // 2. xw = x + dx of the listed samples
  bad = launch_warp(warp_kernel, x3, m, (const __nv_bfloat16*)wdef, tcond, dm, xw, idx, count,
                    stream);
  if (bad) return bad;

  // 3. canonical backward at xw, and g_x in the list's order
  const GxOut gxo = {cutoff, gx};
  bad = launch_field_bwd<true>(xw, d3, g_out, m, count, idx, (const __nv_bfloat16*)tab,
                               (const __nv_bfloat16*)wfwd, (const __nv_bfloat16*)wbwd, fm, tm,
                               bm, g_tab, g_w, gxo, rec_out, stream);
  if (bad) return bad;

  // 4 and 5, a pass of at most `window` tiles of the list at a time: the
  // tower's recompute and chain, then the weight gradients summed over
  // chunks of the pass's tiles
  const long long tiles = (m + kTile - 1) / kTile;
  const long long span = window < tiles ? window : tiles;  // tiles a pass
  const long long passes = (tiles + span - 1) / span;
  const long long g_stride = span * kTileBytes;
  const long long a_stride = (acts_all ? tiles : span) * kTileBytes;
  const size_t smem4 = tower_smem_bytes(dm.first_bytes, dm.n_slots);
  cudaError_t err = cudaFuncSetAttribute(tower_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem4);
  if (err != cudaSuccess) return (int)err;
  const size_t smem5 = 1024 + (size_t)kWgStages * kWgStageBytes + 2 * kWgStages * sizeof(uint64_t);
  err = cudaFuncSetAttribute(tower_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem5);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (span + kConsumers - 1) / kConsumers;
  const long long blocks4 = pairs < n_sm ? pairs : n_sm;
  for (long long p = 0; p < passes; ++p) {
    const long long base = p * span;
    unsigned char* a_ptr = (unsigned char*)ascr + (acts_all ? base * kTileBytes : 0);
    tower_bwd_kernel<<<(unsigned)blocks4, kTowerThreads, smem4, stream>>>(
        x3, m, count, idx, gx, (const __nv_bfloat16*)wdef, tcond, dm, base, span,
        (unsigned char*)gscr, g_stride, a_ptr, a_stride, tsum + p * blocks4 * kDefHid);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long here = tiles - base < span ? tiles - base : span;
    long long chunks = (2LL * n_sm + dm.n_layers - 1) / dm.n_layers;
    const long long by_size = (here + kChunkTiles - 1) / kChunkTiles;
    if (chunks > by_size) chunks = by_size;
    tower_wgrad_kernel<<<dim3((unsigned)chunks, (unsigned)dm.n_layers), kWgThreads, smem5,
                         stream>>>(count, tcond, dm, base, span, (const unsigned char*)gscr,
                                   g_stride, a_ptr, a_stride, g_wdef);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  // 6. the first matrix's time rows
  time_rows_kernel<<<1, 8 * kDefHid, 0, stream>>>(tcond, tdim, (int)(passes * blocks4), tsum,
                                                  g_wtime);
  return (int)cudaGetLastError();
}
