// The deformation tower of the dynamic field kernels (dyn_field_fwd.cu, K3,
// and dyn_field_bwd.cu, K4) on Hopper's warpgroup products: the layout
// description passed by the ctypes entry points, the shared-memory images of
// the matrices, the mbarrier / bulk-copy / wgmma wrappers, the producer that
// brings the matrices in, the tower's forward over a tile of 64 samples, and
// the kernel body that writes the warped positions (warp_tiles), which both
// entries run. The backward's recompute calls the same tile forward, so it
// rounds exactly as the forward kernel does:
//   ex = [x, sin(2^f x), cos(2^f x)] in f32, rounded to bf16 -> W0 (bf16
//   operands, f32 sums) + the frame's f32 time bias -> (relu, bf16, W) per
//   further matrix.
// They replace the tower half of the Pallas kernels
// sealdnerf_tpu/ops/pallas_field.py:_dyn_field_kernel (forward) and
// :_dyn_field_bwd_kernel (backward).
//
// What bounds the tower: operations. 63 * 128 + 6 * 128^2 + 128 * 3 =
// 106,752 MACs a sample, bf16 x bf16 -> f32, against 12 bytes in and 12 out.
// The design that follows:
//   - The matrices are packed on the host (ops/field.py:_pack_deform) into the
//     images that wgmma reads from shared memory: each one output-major (W^T,
//     [rows][inputs]) in blocks of 64 columns, 128 bytes a row, the 16-byte
//     chunks of row r swizzled by r % 8 (the 128-byte swizzle). The first is
//     [128][in_pad rounded up to 64], the hidden ones [128][128] (32 KB), the
//     last [16][128] with rows 3..15 zero. At the default tower (8 matrices,
//     in_pad 64) they are 212 KB and all stay in shared memory: a producer
//     warp brings each in once per block with cp.async.bulk under an
//     mbarrier, and never again. A deeper or wider tower keeps the first and
//     last resident and streams the hidden ones through a ring of slots that
//     the producer keeps full (full / empty mbarriers, no block barrier).
//   - Three consumer warpgroups per block, each on its own tile of 64
//     samples, so one group's epilogue overlaps the others' products. A
//     block of 13 warps gets at most 128 registers a thread (ptxas rounds
//     it up to 16 warps); the tile's 64 accumulators and 32 A registers fit,
//     with a few spills. Against two groups (168 registers, no spills) on
//     an NVIDIA H100 80GB HBM3 at 700 W (profiling/torch_tower_variants.py):
//     deform_fwd_kernel 0.460 against 0.528 ms on 2^20 random samples, the
//     backward's tower_bwd_kernel 0.319 against 0.305 ms on 183,223; the
//     forward runs far more often (every frame and grid refresh).
//   - Every 128-wide product is one wgmma.mma_async m64n128k16 per 16 inputs,
//     A from registers, B (the matrix image) from shared memory. ex is
//     computed in registers straight into layer 0's A fragments, in a column
//     order of its own (ex_pair) in which the four lanes that share a sample
//     evaluate the same functions in step. A layer's f32 accumulators get
//     the time bias (layer 0), relu and a pack to bf16, and are then the
//     next layer's A fragments as they stand (the accumulator layout of
//     m64nNk16 is its register-A layout). Hidden activations never touch
//     shared memory. The last matrix runs as m64n8k16.
//   - The backward reads the same images transposed (wgmma's transposed-B
//     mode on the MN-major view of the same bytes), so no input-major copy.
// Each sample's arithmetic is its own, whatever its tile, block or chunk: a
// row of a wgmma tile depends only on its own A row and the fixed order of the
// k-steps.

#pragma once

#include "field_common.cuh"

namespace sdn {

constexpr int kDefHid = 128;       // deform tower hidden width
constexpr int kLastRows = 16;      // the last matrix [3, 128], padded to one k-step
constexpr int kMaxDefLayers = 16;
constexpr int kTile = 64;          // samples per warpgroup tile
constexpr int kConsumers = 3;      // consumer warpgroups per block
constexpr int kTowerThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kHidBytes = kDefHid * kDefHid * 2;      // a hidden matrix image
constexpr int kLastBytes = kLastRows * kDefHid * 2;   // the last matrix image
constexpr int kTileBytes = kTile * kDefHid * 2;       // a [64][128] bf16 tile image
constexpr size_t kTowerSmemMax = 232448;              // per block on sm_90

struct DeformMeta {
  int n_layers;     // matrices: first, n_layers - 2 hidden, last
  int in_dim;       // 3 + 6 * n_freq spatial inputs of the first matrix
  int in_pad;       // in_dim padded to a multiple of 16; the first matrix
                    // takes it padded to 64 or 128 (first_ksteps)
  int n_freq;       // multires_deform
  int first_bytes;  // bytes of the first matrix's image (128 rows, in_pad up to 64)
  int n_slots;      // shared-memory slots of the hidden matrices (>= n_layers - 2: resident)
  long long off[kMaxDefLayers];  // bf16 element offset of each matrix image in wdef
};

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. No
// wait of these kernels lasts longer than a few tiles' work: one that spins
// for ~10 s (2^34 cycles) is a fault, and the kernel traps rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  } while (!done);
}

// bytes (a multiple of 16) from device memory into shared memory; completion
// is counted on `bar` (whose expected bytes the caller set).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses to these registers across a wgmma's
// issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled image: start address,
// leading and stride byte offsets (both in bytes here), swizzle mode 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// An image of `rows` rows read K-major (its columns are the product's K, its
// rows N): k-step kk is columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t base, int rows, int kk) {
  return sw128_desc(base + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}

// The same image read MN-major (its rows are K, its columns M or N, used
// transposed): k-step kk is rows 16 kk .. 16 kk + 15; the leading offset steps
// from one block of 64 columns to the next, the stride from 8 rows to the next.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t base, int rows, int kk) {
  return sw128_desc(base + kk * 2048, rows * 128, 1024);
}

#define SDN_F8(i)                                                                        \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define SDN_D64                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d [64 x 128] (+)= A [64 x 16] (registers) . B [16 x 128] (shared memory);
// kTnspB = 0: B K-major, 1: B MN-major. scale_d = 0 overwrites d.
// Accumulator d[4 j + q] of lane (g, t) in warp w of the group: row 16 w + g
// (q < 2) or + 8 (q >= 2), column 8 j + 2 t + (q & 1). A fragment a[0..3]:
// rows 16 w + g, + 8, columns 2t, 2t + 1 (a0, a1) and 2t + 8, 2t + 9 (a2, a3).
template <int kTnspB>
__device__ __forceinline__ void wgmma_rs128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SDN_D64
      ", {%64, %65, %66, %67}, %69, p, 1, 1, %70;\n}\n"
      : SDN_F8(0), SDN_F8(8), SDN_F8(16), SDN_F8(24), SDN_F8(32), SDN_F8(40), SDN_F8(48),
        SDN_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc), "n"(kTnspB));
}

// d [64 x 128] (+)= A [64 x 16] . B [16 x 128], both from shared memory and
// both MN-major (transposed).
__device__ __forceinline__ void wgmma_ss128_tt(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SDN_D64
      ", %64, %65, p, 1, 1, 1, 1;\n}\n"
      : SDN_F8(0), SDN_F8(8), SDN_F8(16), SDN_F8(24), SDN_F8(32), SDN_F8(40), SDN_F8(48),
        SDN_F8(56)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d [64 x 8] (+)= A [64 x 16] (registers) . B [16 x 8] (shared memory, K-major).
__device__ __forceinline__ void wgmma_rs8(float (&d)[4], const uint32_t (&a)[4], uint64_t desc,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %8, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %9, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

#undef SDN_F8
#undef SDN_D64

// ------------------------------------------------------------ shared memory
// The tower's shared memory, from a 1024-byte-aligned base: the first
// matrix's image | the last's | n_slots hidden images | the time bias [128] |
// the backward's f64 sums of the first matrix's output gradient, one row
// [128] per consumer warp | full barriers (0: first and last; 1 + s: slot s) |
// empty barriers (slot s).
struct TowerSmem {
  unsigned char* w0;
  unsigned char* wlast;
  unsigned char* slots;
  float* tb;
  double* wsum;
  uint64_t* full;
  uint64_t* empty;
};

inline size_t tower_smem_bytes(int first_bytes, int n_slots) {
  return 1024 + (size_t)first_bytes + kLastBytes + (size_t)n_slots * kHidBytes +
         kDefHid * sizeof(float) + 4 * kConsumers * kDefHid * sizeof(double) +
         (size_t)(1 + 2 * kMaxDefLayers) * sizeof(uint64_t);
}

__device__ __forceinline__ TowerSmem carve_tower_smem(const DeformMeta& dm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t s = smem_u32(smem_raw);
  TowerSmem sm;
  sm.w0 = smem_raw + ((1024u - (s & 1023u)) & 1023u);
  sm.wlast = sm.w0 + dm.first_bytes;
  sm.slots = sm.wlast + kLastBytes;
  sm.tb = reinterpret_cast<float*>(sm.slots + (size_t)dm.n_slots * kHidBytes);
  sm.wsum = reinterpret_cast<double*>(sm.tb + kDefHid);
  sm.full = reinterpret_cast<uint64_t*>(sm.wsum + 4 * kConsumers * kDefHid);
  sm.empty = sm.full + 1 + kMaxDefLayers;
  return sm;
}

// One thread initialises the barriers; the caller synchronises the block.
__device__ __forceinline__ void init_tower_barriers(const TowerSmem& sm) {
  for (int k = 0; k < 1 + kMaxDefLayers; ++k) mbar_init(sm.full + k, 1);
  for (int k = 0; k < kMaxDefLayers; ++k) mbar_init(sm.empty + k, 4 * kConsumers);
  mbar_init_fence();
}

// ------------------------------------------------------------------ the ring
// The hidden matrices' uses in one round of a block (one tile per consumer
// group): the forward walks matrices 1..H; the backward's chain (seq_len =
// 2H) walks back H..1. Resident: matrix k sits in slot k - 1, loaded once.
struct Ring {
  int H, seq_len, n_slots;
  bool resident;
};

__device__ __forceinline__ Ring make_ring(const DeformMeta& dm, bool backward) {
  Ring rg;
  rg.H = dm.n_layers - 2;
  rg.seq_len = backward ? 2 * rg.H : rg.H;
  rg.n_slots = dm.n_slots;
  rg.resident = dm.n_slots >= rg.H;
  return rg;
}

__device__ __forceinline__ int ring_matrix(int q, int H) { return q < H ? 1 + q : 2 * H - q; }

// The slot and the full barrier's parity of use q of round r.
__device__ __forceinline__ void ring_pos(const Ring& rg, int r, int q, int& slot,
                                         uint32_t& parity) {
  if (rg.resident) {
    slot = ring_matrix(q, rg.H) - 1;
    parity = 0;
    return;
  }
  const long long j = (long long)r * rg.seq_len + q;
  slot = (int)(j % rg.n_slots);
  parity = (uint32_t)((j / rg.n_slots) & 1);
}

// A consumer warp is done with a slot's matrix (its wgmma has completed).
__device__ __forceinline__ void ring_release(const Ring& rg, const TowerSmem& sm, int slot) {
  if (!rg.resident && (threadIdx.x & 31) == 0) mbar_arrive(sm.empty + slot);
}

// A consumer group with no tile in round r still takes its turn in the ring.
__device__ __forceinline__ void ring_dry_round(const Ring& rg, const TowerSmem& sm, int r) {
  if (rg.resident) return;
  for (int q = 0; q < rg.seq_len; ++q) {
    int slot;
    uint32_t parity;
    ring_pos(rg, r, q, slot, parity);
    mbar_wait(sm.full + 1 + slot, parity);
    ring_release(rg, sm, slot);
  }
}

// The producer warp: lane 0 brings the first and last matrices in, then the
// hidden ones, once (resident) or round by round through the ring; it waits
// for its last copies before it leaves.
__device__ __forceinline__ void tower_producer(const DeformMeta& dm, const TowerSmem& sm,
                                               const Ring& rg,
                                               const __nv_bfloat16* __restrict__ wdef,
                                               int rounds) {
  if ((threadIdx.x & 31) != 0) return;
  mbar_expect_tx(sm.full, dm.first_bytes + kLastBytes);
  bulk_load(sm.w0, wdef + dm.off[0], dm.first_bytes, sm.full);
  bulk_load(sm.wlast, wdef + dm.off[dm.n_layers - 1], kLastBytes, sm.full);
  if (rg.resident) {
    for (int k = 0; k < rg.H; ++k) {
      mbar_expect_tx(sm.full + 1 + k, kHidBytes);
      bulk_load(sm.slots + (size_t)k * kHidBytes, wdef + dm.off[1 + k], kHidBytes,
                sm.full + 1 + k);
    }
    for (int k = 0; k < rg.H; ++k) mbar_wait(sm.full + 1 + k, 0);
  } else {
    const long long total = (long long)rounds * rg.seq_len;
    for (long long j = 0; j < total; ++j) {
      const int slot = (int)(j % rg.n_slots);
      if (j >= rg.n_slots) mbar_wait(sm.empty + slot, (uint32_t)((j / rg.n_slots - 1) & 1));
      mbar_expect_tx(sm.full + 1 + slot, kHidBytes);
      bulk_load(sm.slots + (size_t)slot * kHidBytes,
                wdef + dm.off[ring_matrix((int)(j % rg.seq_len), rg.H)], kHidBytes,
                sm.full + 1 + slot);
    }
    for (long long j = total - rg.n_slots; j < total; ++j)
      if (j >= 0)
        mbar_wait(sm.full + 1 + (int)(j % rg.n_slots), (uint32_t)((j / rg.n_slots) & 1));
  }
  mbar_wait(sm.full, 0);
}

// Rounds of block b when tiles are dealt to blocks in turn, kConsumers at a
// time: the block's consumer group w takes tile (r * gridDim + b) * kConsumers
// + w in round r.
__device__ __forceinline__ int tower_rounds(long long n_tiles) {
  const long long n_pairs = (n_tiles + kConsumers - 1) / kConsumers;
  if ((long long)blockIdx.x >= n_pairs) return 0;
  return (int)((n_pairs - blockIdx.x + gridDim.x - 1) / gridDim.x);
}

// ------------------------------------------------------------------ a tile
// The first matrix's k-steps: its inputs padded to 64 or 128.
__device__ __forceinline__ int first_ksteps(const DeformMeta& dm) {
  return dm.in_pad <= 64 ? 4 : 8;
}

// (sin v, cos v) rounded to bf16 and packed: one range reduction for both
// (sincosf gives sinf's and cosf's bits), one copy of the code, called from
// every ex slot.
static __device__ __noinline__ uint32_t sincos_bf16(float v) {
  float s, c;
  sincosf(v, &s, &c);
  return pack_bf16(s, c);
}

// Pair p of ex of a sample at x, in the kernels' column order: pairs 3 f + a
// are (sin, cos)(2^f x_a), then (x_0, x_1), (x_2, 0), then zeros. Pair p sits
// in columns 16 (i / 2) + 8 (i % 2) + 2 t and + 1, t = p / (2 K), i = p % (2
// K) for K k-steps: it is the A-fragment pair i of lane t of a quad, so the
// four lanes that share a sample evaluate the same functions in step, each
// on its own frequencies (ops/field.py: deform_ex_columns packs the first
// matrix's rows in this order).
__device__ __forceinline__ uint32_t ex_pair(const DeformMeta& dm, const float (&x)[3], int p) {
  const int n3 = 3 * dm.n_freq;
  if (p < n3) {
    const int fd = p / 3, a = p - 3 * fd;
    return sincos_bf16((a == 0 ? x[0] : (a == 1 ? x[1] : x[2])) * (float)(1 << fd));
  }
  if (p == n3) return pack_bf16(x[0], x[1]);
  if (p == n3 + 1) return pack_bf16(x[2], 0.f);
  return 0u;
}

__device__ __forceinline__ uint32_t pick4(uint32_t v0, uint32_t v1, uint32_t v2, uint32_t v3,
                                          int i) {
  return i == 0 ? v0 : (i == 1 ? v1 : (i == 2 ? v2 : v3));
}

// Store the A fragments (a [64][128] bf16 tile across the warpgroup), its
// first 32 * n_q columns, into a tile image in device memory: columns in
// blocks of 64, 128 bytes a row, the 16-byte chunks of row r swizzled by
// r % 8 (the layout the backward's weight gradient product reads). The four
// lanes of a quad hold the four column pairs of each 8-column chunk of their
// rows; a transpose within the quad (three shuffles a group of four chunks)
// gives each lane a whole chunk, written as one 16-byte store, so a warp
// writes whole 32-byte sectors.
__device__ __forceinline__ void store_tile(unsigned char* tile, const uint32_t (&a)[8][4],
                                           int w4, int g, int t, int n_q = 4) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * w4 + g + 8 * h;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= n_q) break;
      // v_u: this lane's pair of chunk 4 q + u (a[j / 2][2 (j % 2) + h], j = 4 q + u)
      const uint32_t v0 = a[2 * q][h], v1 = a[2 * q][2 + h], v2 = a[2 * q + 1][h],
                     v3 = a[2 * q + 1][2 + h];
      const uint32_t own = pick4(v0, v1, v2, v3, t);
      uint32_t got[4];
#pragma unroll
      for (int r = 1; r < 4; ++r)
        got[r] = __shfl_xor_sync(0xffffffffu, pick4(v0, v1, v2, v3, t ^ r), r);
      // lane s's pair of chunk 4 q + t came in round s ^ t (own: round 0)
      const uint32_t w0 = pick4(own, got[1], got[2], got[3], t);
      const uint32_t w1 = pick4(own, got[1], got[2], got[3], t ^ 1);
      const uint32_t w2 = pick4(own, got[1], got[2], got[3], t ^ 2);
      const uint32_t w3 = pick4(own, got[1], got[2], got[3], t ^ 3);
      const int j = 4 * q + t;
      *reinterpret_cast<uint4*>(tile + (j >> 3) * (kTile * 128) + row * 128 +
                                (((j & 7) ^ g) << 4)) = make_uint4(w0, w1, w2, w3);
    }
  }
}

// The relu mask of a tile's activations held as A fragments: bit i of the
// 64 is accumulator entry i (a[kk][r] holds entries 8 kk + 2 r and + 1).
__device__ __forceinline__ uint2 act_mask(const uint32_t (&a)[8][4]) {
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 8 * kk + 2 * r + h;
        const uint32_t bit = ((a[kk][r] >> (16 * h)) & 0x7fffu) != 0u ? 1u : 0u;
        if (i < 32)
          lo |= bit << i;
        else
          hi |= bit << (i - 32);
      }
  return make_uint2(lo, hi);
}

// acc (64 f32 of a layer) -> the next product's A fragments: relu'd (relu) or
// not, rounded to bf16.
__device__ __forceinline__ void acc_to_frags(const float (&acc)[64], uint32_t (&a)[8][4],
                                             bool relu) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = relu ? pack_relu_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1])
                      : pack_bf16(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
}

// Where the backward keeps a tile's activations: acts [n_layers] images of
// this tile, layer_stride bytes apart, and the relu masks of acts[1..].
struct TileKeep {
  unsigned char* acts;
  long long layer_stride;
  uint2* mask;  // [kMaxDefLayers]
};

// The tower's forward over one tile of 64 samples, by one consumer
// warpgroup, up to the last matrix: on return `a` holds the relu'd bf16
// output of the last hidden matrix (the last matrix's input) as A fragments.
// x0, x1: the positions of this thread's two rows (16 w + g and + 8). Round
// r of the ring. kKeep: also store ex and every hidden activation as tile
// images and keep their relu masks (the backward).
template <bool kKeep>
__device__ __forceinline__ void tower_forward_tile(const DeformMeta& dm, const TowerSmem& sm,
                                                   const Ring& rg, int r,
                                                   const float (&x0)[3], const float (&x1)[3],
                                                   uint32_t (&a)[8][4], float (&acc)[64],
                                                   const TileKeep& keep) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  // ex straight into layer 0's A fragments: pair i of this lane in
  // a[i / 2][2 (i % 2) + row]
  const int k0 = first_ksteps(dm);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int p = 2 * k0 * t + i;
    a[i >> 1][2 * (i & 1)] = i < 2 * k0 ? ex_pair(dm, x0, p) : 0u;
    a[i >> 1][2 * (i & 1) + 1] = i < 2 * k0 ? ex_pair(dm, x1, p) : 0u;
  }
  if (kKeep) store_tile(keep.acts, a, w4, g, t, k0 / 2);
  mbar_wait(sm.full, 0);  // the first and last matrices are in place
  const uint32_t w0 = smem_u32(sm.w0);
  wgmma_fence();
  if (k0 == 4) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs128<0>(acc, a[kk], desc_kmajor(w0, kDefHid, kk), kk > 0);
  } else {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs128<0>(acc, a[kk], desc_kmajor(w0, kDefHid, kk), kk > 0);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float b0 = sm.tb[8 * j + 2 * t], b1 = sm.tb[8 * j + 2 * t + 1];
    acc[4 * j] += b0;
    acc[4 * j + 1] += b1;
    acc[4 * j + 2] += b0;
    acc[4 * j + 3] += b1;
  }
  acc_to_frags(acc, a, true);
  if (kKeep) {
    store_tile(keep.acts + keep.layer_stride, a, w4, g, t);
    keep.mask[1] = act_mask(a);
  }
  for (int l = 1; l <= rg.H; ++l) {
    int slot;
    uint32_t parity;
    ring_pos(rg, r, l - 1, slot, parity);
    mbar_wait(sm.full + 1 + slot, parity);
    const uint32_t wl = smem_u32(sm.slots + (size_t)slot * kHidBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs128<0>(acc, a[kk], desc_kmajor(wl, kDefHid, kk), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    ring_release(rg, sm, slot);
    acc_to_frags(acc, a, true);
    if (kKeep) {
      store_tile(keep.acts + (l + 1) * keep.layer_stride, a, w4, g, t);
      keep.mask[l + 1] = act_mask(a);
    }
  }
}

// Load the positions of this thread's two rows of tile `tile` (list
// positions p = 64 tile + 16 w + g and + 8): sample i = list[p] (or p), x
// from x3 [3, m]; rows past n are dead (x = 0).
__device__ __forceinline__ void tile_rows(const float* __restrict__ x3, long long m,
                                          const int* __restrict__ list, long long n,
                                          long long tile, long long (&p)[2], long long (&i)[2],
                                          bool (&live)[2], float (&x0)[3], float (&x1)[3]) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3, g = lane >> 2;
  p[0] = tile * kTile + 16 * w4 + g;
  p[1] = p[0] + 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    live[h] = p[h] < n;
    i[h] = !live[h] ? 0 : (list != nullptr ? (long long)list[p[h]] : p[h]);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    x0[a] = live[0] ? x3[a * m + i[0]] : 0.f;
    x1[a] = live[1] ? x3[a * m + i[1]] : 0.f;
  }
}

// xw [3, m] = x + dx(x, t): the body of a kernel of kTowerThreads threads
// (the consumer warpgroups and the producer warp), persistent blocks and
// tower_smem_bytes(dm.first_bytes, dm.n_slots) bytes of dynamic shared
// memory. tcond is the first layer's time bias [kDefHid] and the flag t != 0;
// at t == 0 the tower is skipped and xw = x. With a list (list [*count],
// device memory) only the listed samples are warped, each into its own
// column of xw; the others' columns are not written. The forward entry
// (dyn_field_fwd.cu) and the backward's (dyn_field_bwd.cu) each wrap it in a
// kernel of their own name, so they warp alike and a profile tells them
// apart.
__device__ __forceinline__ void warp_tiles(const float* __restrict__ x3, long long m,
                                           const __nv_bfloat16* __restrict__ wdef,
                                           const float* __restrict__ tcond,
                                           const DeformMeta& dm, float* __restrict__ xw,
                                           const int* __restrict__ list = nullptr,
                                           const int* __restrict__ count = nullptr) {
  const int tid = threadIdx.x;
  const long long n = list != nullptr ? (long long)*count : m;
  if (tcond[kDefHid] == 0.f) {  // t == 0: no warp
    for (long long p = (long long)blockIdx.x * blockDim.x + tid; p < n;
         p += (long long)gridDim.x * blockDim.x) {
      const long long i = list != nullptr ? (long long)list[p] : p;
#pragma unroll
      for (int a = 0; a < 3; ++a) xw[a * m + i] = __fadd_rn(x3[a * m + i], 0.f);
    }
    return;
  }
  const TowerSmem sm = carve_tower_smem(dm);
  if (tid == 0) init_tower_barriers(sm);
  for (int j = tid; j < kDefHid; j += blockDim.x) sm.tb[j] = tcond[j];
  __syncthreads();
  const long long n_tiles = (n + kTile - 1) / kTile;
  const int rounds = tower_rounds(n_tiles);
  const Ring rg = make_ring(dm, false);
  const int wg = tid >> 7;
  if (wg == kConsumers) {
    tower_producer(dm, sm, rg, wdef, rounds);
    return;
  }
  const int t = tid & 3;
  const TileKeep none = {nullptr, 0, nullptr};
  for (int r = 0; r < rounds; ++r) {
    const long long tile = ((long long)r * gridDim.x + blockIdx.x) * kConsumers + wg;
    if (tile >= n_tiles) {
      ring_dry_round(rg, sm, r);
      continue;
    }
    long long p[2], i[2];
    bool live[2];
    float x0[3], x1[3];
    tile_rows(x3, m, list, n, tile, p, i, live, x0, x1);
    uint32_t a[8][4];
    float acc[64];
    tower_forward_tile<false>(dm, sm, rg, r, x0, x1, a, acc, none);
    // the last matrix: dx [64 x 3] as m64n8
    float d[4];
    const uint32_t wlast = smem_u32(sm.wlast);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) wgmma_rs8(d, a[kk], desc_kmajor(wlast, kLastRows, kk), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(d);
    // d: (row g, column 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
    if (t == 0) {
      if (live[0]) {
        xw[i[0]] = __fadd_rn(x0[0], d[0]);
        xw[m + i[0]] = __fadd_rn(x0[1], d[1]);
      }
      if (live[1]) {
        xw[i[1]] = __fadd_rn(x1[0], d[2]);
        xw[m + i[1]] = __fadd_rn(x1[1], d[3]);
      }
    } else if (t == 1) {
      if (live[0]) xw[2 * m + i[0]] = __fadd_rn(x0[2], d[0]);
      if (live[1]) xw[2 * m + i[1]] = __fadd_rn(x1[2], d[2]);
    }
  }
}

using WarpKernel = void (*)(const float*, long long, const __nv_bfloat16*, const float*,
                            const DeformMeta, float*, const int*, const int*);

// Launch `kernel` (a wrapper of warp_tiles) over m samples, or over the
// listed ones of them, on `stream`: one persistent block an SM at most;
// returns cudaGetLastError().
inline int launch_warp(WarpKernel kernel, const float* x3, long long m,
                       const __nv_bfloat16* wdef, const float* tcond, const DeformMeta& dm,
                       float* xw, const int* list, const int* count, cudaStream_t stream) {
  const size_t smem = tower_smem_bytes(dm.first_bytes, dm.n_slots);
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const long long pairs = ((m + kTile - 1) / kTile + kConsumers - 1) / kConsumers;
  long long blocks = pairs < n_sm ? pairs : n_sm;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, kTowerThreads, smem, stream>>>(x3, m, wdef, tcond, dm, xw, list,
                                                            count);
  return (int)cudaGetLastError();
}

// dmeta (int64): n_layers, hidden, in_dim, in_pad, n_freq, then the bf16
// element offset of each matrix image in wdef (see the header comment):
// first [128][in_pad up to 64] | (n_layers - 2) x [128][128] | last [16][128].
// Also chooses how many hidden matrices stay in shared memory.
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
    if (dm.off[l] % 512 != 0) return (int)cudaErrorInvalidValue;  // 1024-byte images
  }
  dm.first_bytes = (dm.in_pad + 63) / 64 * kDefHid * 128;
  const long long room =
      (long long)kTowerSmemMax - (long long)tower_smem_bytes(dm.first_bytes, 0);
  int slots = (int)(room / kHidBytes);
  const int hidden = dm.n_layers - 2;
  if (slots > hidden) slots = hidden;
  if (slots < 1 && hidden > 0) return (int)cudaErrorInvalidValue;
  dm.n_slots = slots < 0 ? 0 : slots;
  *out = dm;
  return 0;
}

}  // namespace sdn
