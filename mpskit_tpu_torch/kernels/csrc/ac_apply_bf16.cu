// K1: the fused one-site effective-Hamiltonian matvec in bf16, for Hopper.
//
//   y[x,s,r] = sum_{a,b,y,t,n} GL[a,x,y] X[y,t,n] W[a,b,s,t] GR[b,r,n]
//
// Replaces scripts/exp_r5_bf16_matvec.py::_kernel (the Pallas TPU kernel
// written for mpskit_tpu/algorithms/derivatives.py::ac_apply_fast) and
// keeps its rounding points:
//   t1[a][x,t,n] = sum_y bf16(GL[a,x,y]) bf16(X[y,t,n])      f32 accumulation
//   t2[b][x,s,n] = bf16( sum_{a,t} W[a,b,s,t] t1[a][x,t,n] )  f32 middle
//   y[x,s,r]     = sum_{b,n} t2[b][x,s,n] bf16(GR[b,r,n])     f32 accumulation
// A product of two bf16 values is exact in f32, so only the order of the
// f32 sums differs from the plain version (kernels/ac_apply.py).
//
// Bound. At D=512, w=3, d=2 the two products are 2 * 2*w*D^2*dD = 3.22
// GFLOP of bf16 tensor-core work (3.26 us at 989 TFLOP/s) and the middle
// 2*w^2*d^2*D^2 = 0.019 GFLOP of f32 FMA (0.28 us at 67 TFLOP/s, on other
// units, so it overlaps). The f32 operands GL, GR, X and Y are 10.5 MB,
// 3.13 us at 3.35 TB/s. The least time is the largest of the three, 3.26
// us: the kernel is bound by operations, close to the ridge, so it has to
// run its products on wgmma and keep its intermediates out of device
// memory.
//
// Design: one cooperative launch on the caller's stream runs its passes
// with a grid-wide barrier between them, since each launch costs the host
// about as much time as a pass takes on the card. No atomics and no split
// of a contracted index, so two launches give bit-identical y. The fused
// path below runs where a tier of K1_TIERS holds t1 in registers (d = 2
// with w <= 12, d = 3 with w <= 8); every other (w, d) takes the general
// path at the end of this note.
//  1. convert: bf16 copies of GL, GR and X into scratch, zero-padded to
//     Dp = ceil(D/64)*64, with X transposed to Xt[t][n][y]. Every operand
//     of the two products is then K-major (the contracted index
//     contiguous), every tile is full and 16-byte aligned, and only the
//     final store of y is masked.
//  2. stage 1 + middle: one warpgroup per (64 rows x, TN columns n) keeps
//     t1[a][t] for all (a, t) as w*d wgmma accumulators of 64 x TN in
//     registers. The contraction over y runs in chunks (64 y's, a) through
//     6-stage rings of 128B-swizzled tiles in shared memory: cp.async keeps
//     four chunks in flight ahead of the one being multiplied, and the
//     previous chunk's wgmma group is still running, which holds the sixth
//     stage. The Xt tiles of a y-chunk are loaded once for its w chunks.
//     Every accumulator has the same thread <-> (x, n) map, so the middle
//     contraction over (a, t) is FMAs inside each thread; its result is
//     rounded to bf16 and stored as T2, a (Dp*d) x (w*Dp) row-major matrix
//     (3 MB at D=512, which stays in L2).
//  3. stage 3: y (d*Dp x Dp) = T2 GRb^T, a plain wgmma GEMM over 64 x 64
//     tiles with K = w*Dp, through the same kind of ring.
// The rings are fed by cp.async rather than TMA: every operand of the two
// products is scratch that pass 1 wrote, so 16-byte copies made by the
// warpgroup itself need no tensor maps (one cuTensorMapEncodeTiled per
// buffer) and no host work per call. What limits stages 1 and 3 at D=512
// is the rate at which L2 feeds these 64-wide tiles to the SMs, not wgmma:
// a build with the wgmma instructions taken out ran almost as long. TN and
// the accumulator count are template arguments picked from (w, d) so that
// the accumulators take 96 registers a thread and are indexed only by
// compile-time constants.
// The general path, for any (w, d): k1_general, two warpgroups a block and
// one block an SM, with passes, tiles and a scratch layout of its own. Its
// bf16 operands are stored tiled (tiled()): 128 rows of a 64-wide K chunk
// are 16 KB in one piece, laid out as a stage of a ring holds them, so one
// bulk copy by the TMA engine (cp.async.bulk, counted on an mbarrier; no
// tensor map, no host work) fills a stage.
//  1. convert: GL, GR and X to tiled bf16, a warp to two rows (or to a
//     32 x 32 tile of Xt), 48 floats in flight a lane.
//  2. stage 1: T1 (w*Dp x d*Dp, f32) = GLb Xt^T, one GEMM over tiles of
//     128 x BN, a warpgroup to 64 rows, through a 6-stage ring that one
//     thread fills four chunks ahead; a block's chunks stream through it
//     from one tile into the next. BN (128, 96 or 64) follows from the
//     tiles' waves over the SMs.
//  3. the middle reads T1 once: an item of 256 or 512 points (x, n) is
//     copied into shared memory beside W (two items' worth where they
//     fit), and a warp sums G = 16, 12 or 8 outputs for 8 points a lane,
//     in the fused path's order of f32 FMAs; T2 is stored tiled. Widths
//     whose t1 and W do not fit there read them from device memory.
//  4. stage 3: y = T2 GRb^T, the same GEMM with K = w*Dp.
// t1 goes to device memory and back (w*d*Dp^2 f32 each way, 123 MB at
// (D, d, w) = (768, 2, 26)), which a fused tier keeps in registers: past
// the tiers the w*d outputs of an (x, n) tile do not fit in a block's
// registers or shared memory. Least times at (768, 2, 26) / (768, 2, 35),
// pass by pass: convert 57 / 76 us (bytes), stage 1 48 / 64 us (bf16
// products), the middle 55 / 86 us (bytes / f32 FMA), stage 3 48 / 64 us:
// 207 / 290 us, against roofline.k1_bound's 95 / 128 us for the call,
// which lets the passes overlap. What bounds the products is L2, which
// feeds their tiles at ~8 TB/s: a build without wgmma spends 0.10 ms of
// stage 1's 0.13 and of stage 3's 0.16 at (768, 2, 26). The middle is
// bound by the FMA pipes' instruction rate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;                     // rows of a tile; K chunk (128 B)
constexpr int TILE_BYTES = TILE * TILE * 2;  // one 64 x 64 bf16 tile
constexpr int NT = 128;                      // one warpgroup
constexpr int STAGES = 6;                    // depth of the shared-memory ring
// chunks loaded ahead of the one being multiplied: one more stage is held by
// the wgmma group still in flight from the previous chunk
constexpr int AHEAD = STAGES - 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `ch` (0..7) of row `row` in a tile of
// 128-byte rows, 128B-swizzled as wgmma's B128 layout reads it (the tile
// starts on a 1024-byte boundary).
__device__ __forceinline__ uint32_t swz(int row, int ch) {
  return row * 128 + ((ch ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// cp.async writes shared memory through the generic proxy and wgmma reads
// it through the async proxy: each thread fences its own copies before the
// barrier that publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma descriptor of a K-major 128B-swizzled tile at shared address
// `addr`: rows of 128 B, groups of 8 rows 1024 B apart (SBO); the leading
// offset is unused by this layout. Stepping K by 16 inside the 128-byte row
// adds 32 bytes to `addr`.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32) = A (64 x 16) B (N x 16)^T + (acc ? d : 0), both bf16 and
// K-major in shared memory. Register i of thread (warp, lane) of the
// warpgroup holds row 16*warp + lane/4 + 8*((i/2)%2), column 8*(i/4) +
// 2*(lane%4) + i%2. The first product into d passes acc = 0 instead of
// zeroing d: an instruction other than wgmma that defines accumulator
// registers while a wgmma group is in flight makes ptxas serialize them.
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[4], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<96>(float (&d)[48], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t a,
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// The dynamic shared memory, moved up to a 1024-byte boundary (the launch
// asks for 1 KB more than it uses), as the 128B swizzle needs.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// ---- pass 1: bf16 copies, zero-padded to Dp, X transposed ----------------
// Work item (z, 32 x 32 tile) of the Dp x Dp slabs: z < w: GL[z]; z < 2w:
// GR[z-w]; else Xt[z-2w]. Zeros outside D x D. Each thread loads its eight
// values before it stores any. `tile` is 32 x 33 floats of shared memory.
__device__ void convert(const float* __restrict__ GL,
                        const float* __restrict__ GR,
                        const float* __restrict__ X, bf16* __restrict__ GLb,
                        bf16* __restrict__ GRb, bf16* __restrict__ Xt, int w,
                        int d, int D, int Dp, float (*tile)[33]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;  // 32 x 4
  const int nt = Dp / 32, items = (2 * w + d) * nt * nt;
  const size_t slab = (size_t)D * D, slab_p = (size_t)Dp * Dp;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int z = item / (nt * nt), r0 = (item / nt) % nt * 32,
              c0 = item % nt * 32;
    float v[8];
    if (z < 2 * w) {
      const float* src = z < w ? GL + z * slab : GR + (z - w) * slab;
      bf16* dst = z < w ? GLb + z * slab_p : GRb + (z - w) * slab_p;
      const int col = c0 + tx;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int row = r0 + ty + 4 * k;
        v[k] = (row < D && col < D) ? src[(size_t)row * D + col] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        dst[(size_t)(r0 + ty + 4 * k) * Dp + col] = __float2bfloat16_rn(v[k]);
    } else {
      // Xt[t][n][y] = X[y][t][n]: n in [r0, r0+32), y in [c0, c0+32); read
      // along n, write along y
      const int t = z - 2 * w;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int y = c0 + ty + 4 * k, n = r0 + tx;
        v[k] = (y < D && n < D) ? X[((size_t)y * d + t) * D + n] : 0.f;
      }
      __syncthreads();  // the previous item's readers of `tile` are done
#pragma unroll
      for (int k = 0; k < 8; ++k) tile[ty + 4 * k][tx] = v[k];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = r0 + ty + 4 * k, y = c0 + tx;
        Xt[((size_t)t * Dp + n) * Dp + y] =
            __float2bfloat16_rn(tile[tx][ty + 4 * k]);
      }
    }
  }
}

// ---- pass 2: stage 1 and the middle ---------------------------------------
// Tile (n0, x0): t1[a][t] (64 x TN) for a < w <= WMAX, t < DD, over the
// chunks c = yc*w + a of 64 y's. Chunk c takes a stage of the GL ring, GL[a]
// rows x0.. (64 x 64); chunk (yc, 0) also loads, into the Xt ring, Xt[t]
// rows n0.. (TN x 64) for each t, which serve all w chunks of yc. Then
// T2[x*d + s][b*Dp + n] = bf16(sum_{a,t} W[a,b,s,t] t1[a][t][x][n]), with W
// in shared memory (sW).
template <int TN, int DD, int WMAX>
struct Stage1 {
  static constexpr int B_BYTES = TN * 128;       // one Xt[t] tile
  static constexpr int XT_BYTES = DD * B_BYTES;  // a stage of the Xt ring
  // the two rings, then sW
  static constexpr int RING_BYTES = STAGES * (TILE_BYTES + XT_BYTES);
};

template <int TN, int DD, int WMAX>
__device__ void stage1_tile(const bf16* __restrict__ GLb,
                            const bf16* __restrict__ Xt,
                            const float* __restrict__ sW,
                            bf16* __restrict__ T2, int w, int Dp,
                            uint32_t ring, int n0, int x0) {
  using S = Stage1<TN, DD, WMAX>;
  const uint32_t xring = ring + STAGES * TILE_BYTES;
  const int tid = threadIdx.x;
  const int ny = Dp / TILE, nk = w * ny;

  // The Xt stage of yc is refilled by chunk (yc + STAGES, 0), loaded at
  // iteration (yc + STAGES)*w - AHEAD; by then the groups of every chunk
  // before (yc + STAGES)*w - AHEAD - 1 are complete, and the last chunk of
  // yc, (yc + 1)*w - 1, is among them for any w >= 1 (AHEAD + 1 <=
  // (STAGES - 1)*w).
  auto load = [&](int c) {
    const int yc = c / w, a = c - yc * w, y0 = yc * TILE;
    const uint32_t sa = ring + (c % STAGES) * TILE_BYTES;
    const bf16* gA = GLb + ((size_t)a * Dp + x0) * Dp + y0;
    for (int i = tid; i < TILE * 8; i += NT) {
      const int row = i >> 3, ch = i & 7;
      cp_async16(sa + swz(row, ch), gA + (size_t)row * Dp + ch * 8);
    }
    if (a == 0) {
      const uint32_t sb = xring + (yc % STAGES) * S::XT_BYTES;
      for (int i = tid; i < DD * TN * 8; i += NT) {
        const int row = i >> 3, ch = i & 7;  // row = t*TN + j
        const int t = row / TN, j = row % TN;
        cp_async16(sb + swz(row, ch),
                   Xt + ((size_t)t * Dp + n0 + j) * Dp + y0 + ch * 8);
      }
    }
  };

  float acc[WMAX][DD][TN / 2];  // set by the first wgmma into each

#pragma unroll
  for (int c = 0; c < AHEAD; ++c) {
    if (c < nk) load(c);
    cp_async_commit();
  }
  int c = 0;
  for (int yc = 0; yc < ny; ++yc) {
    const uint32_t sb = xring + (yc % STAGES) * S::XT_BYTES;
#pragma unroll
    for (int a = 0; a < WMAX; ++a) {
      if (a < w) {
        cp_async_wait<AHEAD - 1>();  // this thread's copies of chunk c
        fence_proxy_async();
        // everyone's copies of c have landed, and everyone has seen the
        // wgmma group of c-2 complete: its GL stage takes chunk c + AHEAD
        __syncthreads();
        if (c + AHEAD < nk) load(c + AHEAD);
        cp_async_commit();
        const uint32_t sa = ring + (c % STAGES) * TILE_BYTES;
#pragma unroll
        for (int t = 0; t < DD; ++t) fence_regs(acc[a][t]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          const uint64_t da = desc(sa + kk * 32);
#pragma unroll
          for (int t = 0; t < DD; ++t)
            wgmma<TN>(acc[a][t], da, desc(sb + t * S::B_BYTES + kk * 32),
                      yc > 0 || kk > 0);
        }
        wg_commit();
        wg_wait<1>();  // leaves this chunk's group in flight
#pragma unroll
        for (int t = 0; t < DD; ++t) fence_regs(acc[a][t]);
        ++c;
      }
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int a = 0; a < WMAX; ++a)
#pragma unroll
    for (int t = 0; t < DD; ++t) fence_regs(acc[a][t]);

  // the middle, in each thread's own (x, n) entries
  const int warp = tid >> 5, lane = tid & 31;
  const int xr = x0 + warp * 16 + (lane >> 2);
  const size_t ld = (size_t)w * Dp;
  for (int b = 0; b < w; ++b) {
    bf16* out = T2 + (size_t)b * Dp + n0 + 2 * (lane & 3);
#pragma unroll
    for (int s = 0; s < DD; ++s) {
      float v[TN / 2];
#pragma unroll
      for (int r = 0; r < TN / 2; ++r) v[r] = 0.f;
#pragma unroll
      for (int a = 0; a < WMAX; ++a) {
        if (a < w) {
#pragma unroll
          for (int t = 0; t < DD; ++t) {
            const float cf = sW[((a * w + b) * DD + s) * DD + t];
#pragma unroll
            for (int r = 0; r < TN / 2; ++r)
              v[r] = fmaf(cf, acc[a][t][r], v[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < TN / 2; r += 2) {
        const int x = xr + 8 * ((r >> 1) & 1);
        *reinterpret_cast<__nv_bfloat162*>(
            out + (size_t)(x * DD + s) * ld + 8 * (r >> 2)) =
            __floats2bfloat162_rn(v[r], v[r + 1]);
      }
    }
  }
}

// ---- a 64 x 64 tile of a bf16 GEMM with f32 output -------------------------
// out[m0 + i][r0 + j] = sum_k A[i][k] B[j][k] for i, j < 64. A and B are
// K-major and already moved to the tile's first row: row i of A at A +
// i*lda, row j of B at B + j*ldb. K runs in nk chunks of 64: chunk c of A
// starts at column 64c, chunk c of B at column 64*(c % cpp) of panel c /
// cpp, the panels `panel` elements apart (stage 3's K = (b, n) crosses the
// slabs of GRb). Entries in a row >= rows or a column >= cols are padding
// and are not stored.
constexpr int GEMM_BYTES = STAGES * 2 * TILE_BYTES;

__device__ void gemm_tile(const bf16* __restrict__ A, size_t lda,
                          const bf16* __restrict__ B, size_t ldb, int cpp,
                          size_t panel, int nk, float* __restrict__ out,
                          size_t ldo, int rows, int cols, uint32_t ring,
                          int m0, int r0) {
  constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  const int tid = threadIdx.x;

  auto load = [&](int c) {
    const uint32_t st = ring + (c % STAGES) * STAGE_BYTES;
    const int p = c / cpp;
    const bf16* gA = A + (size_t)c * TILE;
    const bf16* gB = B + p * panel + (size_t)(c - p * cpp) * TILE;
    for (int i = tid; i < TILE * 8; i += NT) {
      const int row = i >> 3, ch = i & 7;
      cp_async16(st + swz(row, ch), gA + row * lda + ch * 8);
      cp_async16(st + TILE_BYTES + swz(row, ch), gB + row * ldb + ch * 8);
    }
  };

  float acc[TILE / 2];  // set by the first wgmma

#pragma unroll
  for (int c = 0; c < AHEAD; ++c) {
    if (c < nk) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (c + AHEAD < nk) load(c + AHEAD);
    cp_async_commit();
    const uint32_t st = ring + (c % STAGES) * STAGE_BYTES;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma<TILE>(acc, desc(st + kk * 32), desc(st + TILE_BYTES + kk * 32),
                  c > 0 || kk > 0);
    wg_commit();
    wg_wait<1>();
    fence_regs(acc);
  }
  wg_wait<0>();
  fence_regs(acc);

  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int r = 0; r < TILE / 2; ++r) {
    const int m = m0 + warp * 16 + (lane >> 2) + 8 * ((r >> 1) & 1);
    const int col = r0 + 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
    if (m < rows && col < cols) out[(size_t)m * ldo + col] = acc[r];
  }
}

// ---- pass 3: y = T2 GRb^T ---------------------------------------------------
// y viewed as (d*Dp) x Dp, row m = x*d + s; K = (b, n) runs over w*Dp in
// chunks of 64, each inside one b. Rows with x >= D and columns r >= D are
// padding.
__device__ void stage3(const bf16* __restrict__ T2,
                       const bf16* __restrict__ GRb, float* __restrict__ Y,
                       int w, int d, int D, int Dp, uint32_t ring) {
  const int n3 = Dp / TILE;
  const size_t ld = (size_t)w * Dp;
  for (int item = blockIdx.x; item < n3 * (d * Dp / TILE);
       item += gridDim.x) {
    const int r0 = item % n3 * TILE, m0 = item / n3 * TILE;
    __syncthreads();  // the previous item is done with the ring
    gemm_tile(T2 + m0 * ld, ld, GRb + (size_t)r0 * Dp, Dp, Dp / TILE,
              (size_t)Dp * Dp, w * Dp / TILE, Y, D, D * d, D, ring, m0, r0);
  }
}

// ---- the fused kernel: the three passes, a grid-wide barrier between them --
// Launched cooperatively with no more blocks than fit on the card at once;
// each pass deals its work items out over the blocks.
template <int TN, int DD, int WMAX>
__global__ void __launch_bounds__(NT, 1)
k1_kernel(const float* __restrict__ GL, const float* __restrict__ W,
          const float* __restrict__ GR, const float* __restrict__ X,
          float* __restrict__ Y, bf16* __restrict__ GLb,
          bf16* __restrict__ GRb, bf16* __restrict__ Xt,
          bf16* __restrict__ T2, int w, int D, int Dp) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t ring = smem_u32(smem);
  float* sW = reinterpret_cast<float*>(smem + Stage1<TN, DD, WMAX>::RING_BYTES);
  cg::grid_group grid = cg::this_grid();

  convert(GL, GR, X, GLb, GRb, Xt, w, DD, D, Dp,
          reinterpret_cast<float(*)[33]>(smem));
  for (int i = threadIdx.x; i < w * w * DD * DD; i += NT) sW[i] = W[i];
  grid.sync();

  const int n1 = Dp / TN;
  for (int item = blockIdx.x; item < n1 * (Dp / TILE); item += gridDim.x) {
    __syncthreads();  // the previous item is done with the rings
    stage1_tile<TN, DD, WMAX>(GLb, Xt, sW, T2, w, Dp, ring, item % n1 * TN,
                              item / n1 * TILE);
  }
  grid.sync();

  stage3(T2, GRb, Y, w, DD, D, Dp, ring);
}

// ---- the general path, for any (w, d) -------------------------------------
// Its own passes, tiles, scratch layout and launch: nothing below is called
// by the fused tiers, and it calls none of their passes. Two warpgroups a
// block, one block an SM.
constexpr int NTG = 256;
constexpr int GSTAGES = 6;                  // depth of the GEMM ring
constexpr int GAHEAD = GSTAGES - 2;         // as AHEAD above
constexpr int GA_BYTES = 128 * 128;         // a stage's A: 128 rows of 128 B
constexpr int GSTAGE_BYTES = 2 * GA_BYTES;  // then B: up to 128 rows
constexpr int GRING_BYTES = GSTAGES * GSTAGE_BYTES;
constexpr int SMEM_MAX = 232448;            // dynamic shared memory of a block
constexpr int BARS = 1024;                  // the GEMMs' mbarriers come first
constexpr int ROOM = SMEM_MAX - 1024 - BARS;  // for a pass, after them

// The general path keeps its bf16 operands "tiled": the 64-column chunk c
// of rows 8i..8i+7 of an R-row matrix is one 1024-byte block, 128B-swizzled
// as swz lays out a stage of a ring; the blocks of a chunk follow each other
// in row order, chunk after chunk. Rows m0..m0+127 of chunk c are then 16 KB
// in one piece, which one bulk copy moves into a stage as wgmma reads it.
// Element offset of (row, col):
__device__ __forceinline__ size_t tiled(int row, int col, int R) {
  return ((size_t)(col >> 6) * (R >> 3) + (row >> 3)) * 512 +
         (swz(row & 7, (col >> 3) & 7) >> 1) + (col & 7);
}

__device__ __forceinline__ uint32_t bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar),
               "r"(1) : "memory");
}

// arrives on `bar` and has its phase wait for `bytes` more
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16) from device memory into shared memory by the
// TMA engine, counted on `bar` when they have landed
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Pass 1: GLb (w*Dp x Dp: row a*Dp + x, column y), GRb (Dp x w*Dp: row r,
// column b*Dp + n) and Xt (d*Dp x Dp: row t*Dp + n, column y), tiled, bf16,
// zero past D. A warp to a work item, every warp of the grid in turn: 768
// columns of two rows of GL or GR, each lane 6 runs of 8 loaded before any
// is stored (the pass moves ~190 MB at w=26, D=768, so it needs many bytes
// in flight), a run stored as 16 bytes; or a 32 x 32 tile of Xt, turned in
// the warp's own 32 x 33 floats of `smem`.
constexpr int CU = 3;  // runs of 8 columns a lane

__device__ void convert_general(const float* __restrict__ GL,
                                const float* __restrict__ GR,
                                const float* __restrict__ X,
                                bf16* __restrict__ GLb, bf16* __restrict__ GRb,
                                bf16* __restrict__ Xt, int w, int d, int D,
                                int Dp, float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cs = (Dp + 256 * CU - 1) / (256 * CU);  // pieces of a row
  const int rows = w * Dp * cs, nt = Dp / 32;
  const int items = rows + d * nt * nt;
  const bool vec = (D & 3) == 0 && ((uintptr_t)GL & 15) == 0 &&
                   ((uintptr_t)GR & 15) == 0;
  float(*tile)[33] = reinterpret_cast<float(*)[33]>(smem + warp * 32 * 33);
  for (int item = blockIdx.x * (NTG / 32) + warp; item < items;
       item += gridDim.x * (NTG / 32)) {
    if (item < rows) {
      // rows r0 and r0 + 1 of slab z (Dp is even), 256*CU columns of each
      const int zr = item / cs * 2, c0 = item % cs * 256 * CU;  // z*Dp + r0
      const int z = zr / Dp, r0 = zr - z * Dp;
      const float* src = (z < w ? GL + (size_t)z * D * D
                                : GR + (size_t)(z - w) * D * D) +
                         (size_t)r0 * D;
      float v[2 * CU][8];  // run k: row r0 + k / CU
#pragma unroll
      for (int k = 0; k < 2 * CU; ++k) {
        const int r = r0 + k / CU, c = c0 + 256 * (k % CU) + 8 * lane;
        const float* run = src + (size_t)(k / CU) * D + c;
        if (vec) {
#pragma unroll
          for (int h = 0; h < 8; h += 4) {
            const float4 f =
                r < D && c + h < D
                    ? __ldg(reinterpret_cast<const float4*>(run + h))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
            v[k][h] = f.x, v[k][h + 1] = f.y, v[k][h + 2] = f.z,
            v[k][h + 3] = f.w;
          }
        } else {
#pragma unroll
          for (int h = 0; h < 8; ++h)
            v[k][h] = r < D && c + h < D ? __ldg(run + h) : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < 2 * CU; ++k) {
        const int r = r0 + k / CU, c = c0 + 256 * (k % CU) + 8 * lane;
        if (c >= Dp) continue;
        bf16* dst = z < w ? GLb + tiled(zr + k / CU, c, w * Dp)
                          : GRb + tiled(r, (z - w) * Dp + c, Dp);
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(bf2(v[k][0], v[k][1]), bf2(v[k][2], v[k][3]),
                       bf2(v[k][4], v[k][5]), bf2(v[k][6], v[k][7]));
      }
    } else {
      // Xt[t*Dp + n][y] = X[y][t][n]: read along n, write runs of 8 y
      const int i = item - rows, t = i / (nt * nt);
      const int y0 = i / nt % nt * 32, n0 = i % nt * 32;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const int y = y0 + k, n = n0 + lane;
        tile[k][lane] = y < D && n < D ? X[((size_t)y * d + t) * D + n] : 0.f;
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int uu = lane + 32 * q, rr = uu >> 2, cc = (uu & 3) * 8;
        const uint4 o = make_uint4(
            bf2(tile[cc][rr], tile[cc + 1][rr]),
            bf2(tile[cc + 2][rr], tile[cc + 3][rr]),
            bf2(tile[cc + 4][rr], tile[cc + 5][rr]),
            bf2(tile[cc + 6][rr], tile[cc + 7][rr]));
        *reinterpret_cast<uint4*>(Xt + tiled(t * Dp + n0 + rr, y0 + cc,
                                             d * Dp)) = o;
      }
      __syncwarp();  // done with `tile` before the next item fills it
    }
  }
}

// C (f32) = A B^T over K = 64*nk, A (M rows) and B (N rows) bf16 and
// tiled; entries of C past (rows, cols) are not stored.
struct Gemm {
  const bf16* A;
  const bf16* B;
  int M, N, nk;
  float* C;
  size_t ldc;
  int rows, cols;
};

// The GEMM over tiles of 128 x BN, dealt out over the blocks: warpgroup g
// takes rows 64g.. of the tile. The block's chunks, (its i-th tile, c) in
// order, stream through one ring of 6 stages whatever tile they belong to,
// so the next tile's first chunks load while this one's products finish
// and its accumulators are stored. Thread 0 fills a stage with two bulk
// copies (A's 128 rows and B's BN, fewer at the edge: the rest of the stage
// is left as it was and feeds only rows and columns that are not stored),
// counted on the stage's mbarrier in `bars`; the ring's waits are otherwise
// those of gemm_tile.
template <int BN>
__device__ void gemm_general(const Gemm& g, uint32_t ring, uint32_t bars) {
  const int tid = threadIdx.x, wg = tid >> 7;
  const int ntl = (g.N + BN - 1) / BN, tiles = (g.M + 127) / 128 * ntl;
  const int mine = (int)blockIdx.x < tiles
                       ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int total = mine * g.nk;

  auto load = [&](int q) {
    const int i = q / g.nk, c = q - i * g.nk;
    const int tile = blockIdx.x + i * gridDim.x;
    const int m0 = tile / ntl * 128, n0 = tile % ntl * BN;
    const int am = g.M - m0 < 128 ? g.M - m0 : 128;
    const int bn = g.N - n0 < BN ? g.N - n0 : BN;
    const uint32_t st = ring + (q % GSTAGES) * GSTAGE_BYTES;
    const uint32_t bar = bars + 8 * (q % GSTAGES);
    mbar_expect(bar, (am + bn) * 128);
    bulk_load(st, g.A + ((size_t)c * (g.M >> 3) + (m0 >> 3)) * 512, am * 128,
              bar);
    bulk_load(st + GA_BYTES, g.B + ((size_t)c * (g.N >> 3) + (n0 >> 3)) * 512,
              bn * 128, bar);
  };

  float acc[BN / 2];  // set by the first wgmma of each tile
  const uint32_t arows = wg * 64 * 128;
  const bool pairs = (g.ldc & 1) == 0;
  const int warp = (tid >> 5) & 3, lane = tid & 31;

  // the previous pass's use of this shared memory comes before the copies
  fence_proxy_async();
  __syncthreads();
  if (tid == 0)
    for (int q = 0; q < GAHEAD && q < total; ++q) load(q);
  int q = 0;
  for (int i = 0; i < mine; ++i) {
    for (int c = 0; c < g.nk; ++c, ++q) {
      mbar_wait(bars + 8 * (q % GSTAGES), (q / GSTAGES) & 1);
      // everyone has seen the group of chunk q - 2 complete: its stage
      // takes chunk q + GAHEAD
      __syncthreads();
      if (tid == 0 && q + GAHEAD < total) load(q + GAHEAD);
      const uint32_t st = ring + (q % GSTAGES) * GSTAGE_BYTES;
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)
        wgmma<BN>(acc, desc(st + arows + kk * 32),
                  desc(st + GA_BYTES + kk * 32), c > 0 || kk > 0);
      wg_commit();
      wg_wait<1>();
      fence_regs(acc);
    }
    wg_wait<0>();
    fence_regs(acc);

    const int tile = blockIdx.x + i * gridDim.x;
    const int m0 = tile / ntl * 128 + wg * 64 + warp * 16 + (lane >> 2);
    const int n0 = tile % ntl * BN + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < BN / 2; r += 2) {
      const int m = m0 + 8 * ((r >> 1) & 1), col = n0 + 8 * (r >> 2);
      if (m >= g.rows) continue;
      float* o = g.C + (size_t)m * g.ldc + col;
      if (pairs && col + 1 < g.cols) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[r], acc[r + 1]);
      } else {
        if (col < g.cols) o[0] = acc[r];
        if (col + 1 < g.cols) o[1] = acc[r + 1];
      }
    }
  }
}

__device__ void gemm_general_bn(int bn, const Gemm& g, uint32_t ring,
                                uint32_t bars) {
  if (bn == 128)
    gemm_general<128>(g, ring, bars);
  else if (bn == 96)
    gemm_general<96>(g, ring, bars);
  else
    gemm_general<64>(g, ring, bars);
}

// The middle: T2[x*d + s][b*Dp + n] = bf16(sum_{a,t} W[a,b,s,t]
// T1[a][x][t*Dp + n]) for every (x, n) of Dp x Dp, padding included (stage
// 3 reads it against the zero padding of GRb, so it has to be finite), each
// sum over k = a*d + t in the fused path's order. An item is 256*strips
// points e = x*Dp + n; their t1[k] are copied once from T1 into shared
// memory, in nbuf buffers (with two, the next item's copies run while this
// one is summed); W sits there too as sW[k][g] (g = b*d + s; zero from
// wd up to wdp, a multiple of G). A warp takes a unit, a strip of 256
// points and a group of G outputs: each lane 8 points (two runs of 4, 128
// apart, so the warp's reads of t1 are contiguous) and all G outputs, so
// that each t1 value read from shared memory serves G outputs and each W
// value 8 points; it reads the next k while it sums this one.
template <int G>
__device__ void middle_general(const float* __restrict__ T1,
                               const float* __restrict__ W,
                               bf16* __restrict__ T2, int w, int d, int Dp,
                               float* smem, int strips, int nbuf) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wd = w * d, groups = (wd + G - 1) / G, wdp = groups * G;
  const int P = 256 * strips, units = groups * strips, R2 = d * Dp;
  const size_t bstep = (size_t)(Dp >> 6) * (R2 >> 3) * 512;  // T2 per b
  float* sW = smem;
  float* buf = smem + wd * wdp;
  for (int i = tid; i < wd * wdp; i += NTG) {
    const int k = i / wdp, g = i - k * wdp;
    const int a = k / d, t = k - a * d, b = g / d, s = g - b * d;
    sW[i] = g < wd ? W[((a * w + b) * d + s) * d + t] : 0.f;
  }
  const int items = Dp * Dp / P;
  const size_t ld1 = (size_t)d * Dp;
  const int quads = P / 4, lq = tid % quads;  // this thread's copies

  auto load = [&](int item, int half) {
    float* dst = buf + half * wd * P + 4 * lq;
    const int e = item * P + 4 * lq, x = e / Dp, n = e - x * Dp;
    for (int k = tid / quads; k < wd; k += NTG / quads) {
      const int a = k / d, t = k - a * d;
      cp_async16(smem_u32(dst + k * P),
                 T1 + ((size_t)a * Dp + x) * ld1 + (size_t)t * Dp + n);
    }
  };
  auto coefs = [&](int k, int grp, float(&cf)[G]) {
#pragma unroll
    for (int j = 0; j < G; j += 4)
      *reinterpret_cast<float4*>(cf + j) =
          *reinterpret_cast<const float4*>(sW + k * wdp + grp * G + j);
  };

  if (nbuf == 2 && (int)blockIdx.x < items) load(blockIdx.x, 0);
  cp_async_commit();
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int half = nbuf == 2 ? it & 1 : 0;
    if (nbuf == 1)
      load(item, 0);
    else if (item + (int)gridDim.x < items)
      load(item + gridDim.x, half ^ 1);
    cp_async_commit();
    if (nbuf == 2)
      cp_async_wait<1>();  // this thread's copies of `item`
    else
      cp_async_wait<0>();
    __syncthreads();  // everyone's, and sW
    for (int u = warp; u < units; u += NTG / 32) {
      const int strip = u % strips, grp = u / strips;
      const float* tp = buf + half * wd * P + strip * 256 + 4 * lane;
      float acc[G][8];
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int p = 0; p < 8; ++p) acc[j][p] = 0.f;
      float4 u0 = *reinterpret_cast<const float4*>(tp);
      float4 u1 = *reinterpret_cast<const float4*>(tp + 128);
      float cf[G];
      coefs(0, grp, cf);
      for (int k = 0; k < wd; ++k) {
        const int kn = k + 1 < wd ? k + 1 : k;
        const float4 n0 = *reinterpret_cast<const float4*>(tp + kn * P);
        const float4 n1 = *reinterpret_cast<const float4*>(tp + kn * P + 128);
        float cn[G];
        coefs(kn, grp, cn);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          acc[j][0] = fmaf(cf[j], u0.x, acc[j][0]);
          acc[j][1] = fmaf(cf[j], u0.y, acc[j][1]);
          acc[j][2] = fmaf(cf[j], u0.z, acc[j][2]);
          acc[j][3] = fmaf(cf[j], u0.w, acc[j][3]);
          acc[j][4] = fmaf(cf[j], u1.x, acc[j][4]);
          acc[j][5] = fmaf(cf[j], u1.y, acc[j][5]);
          acc[j][6] = fmaf(cf[j], u1.z, acc[j][6]);
          acc[j][7] = fmaf(cf[j], u1.w, acc[j][7]);
        }
        u0 = n0, u1 = n1;
#pragma unroll
        for (int j = 0; j < G; ++j) cf[j] = cn[j];
      }
      // T2 at tiled(x*d + s, b*Dp + n, R2) for g = b*d + s, b and s
      // stepped along with g
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = item * P + strip * 256 + 128 * h + 4 * lane;
        const int x = e / Dp, n = e - x * Dp;
        bf16* const tn = T2 + (size_t)(n >> 6) * (R2 >> 3) * 512 + (n & 7);
        int b = grp * G / d, s = grp * G - b * d;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int row = x * d + s;
          if (grp * G + j < wd)
            *reinterpret_cast<uint2*>(
                tn + (size_t)b * bstep + (row >> 3) * 512 + (row & 7) * 64 +
                ((((n >> 3) & 7) ^ (row & 7)) << 3)) =
                make_uint2(bf2(acc[j][4 * h], acc[j][4 * h + 1]),
                           bf2(acc[j][4 * h + 2], acc[j][4 * h + 3]));
          if (++s == d) s = 0, ++b;
        }
      }
    }
    __syncthreads();  // everyone is done with this buffer before it refills
  }
}

// The middle for widths whose t1 and W do not fit in shared memory: a
// thread to a (group of MW outputs, point (x, n)), the points of a group
// on neighbouring threads; each reads the point's t1[k] from T1 and W from
// device memory.
constexpr int MW = 8;

__device__ void middle_wide(const float* __restrict__ T1,
                            const float* __restrict__ W,
                            bf16* __restrict__ T2, int w, int d, int Dp) {
  const int wd = w * d, groups = (wd + MW - 1) / MW;
  const size_t ld1 = (size_t)d * Dp, points = (size_t)Dp * Dp;
  for (size_t i = (size_t)blockIdx.x * NTG + threadIdx.x; i < groups * points;
       i += (size_t)gridDim.x * NTG) {
    const int g0 = (int)(i / points) * MW, e = (int)(i % points);
    const int x = e / Dp, n = e - x * Dp;
    const float* t1 = T1 + (size_t)x * ld1 + n;
    float v[MW] = {};
    for (int a = 0; a < w; ++a)
      for (int t = 0; t < d; ++t) {
        const float u = __ldg(t1 + (size_t)a * Dp * ld1 + (size_t)t * Dp);
#pragma unroll
        for (int j = 0; j < MW; ++j) {
          const int g = g0 + j, b = g / d, s = g - b * d;
          if (g < wd)
            v[j] = fmaf(__ldg(W + ((a * w + b) * d + s) * d + t), u, v[j]);
        }
      }
#pragma unroll
    for (int j = 0; j < MW; ++j) {
      const int g = g0 + j, b = g / d, s = g - b * d;
      if (g < wd)
        T2[tiled(x * d + s, b * Dp + n, d * Dp)] = __float2bfloat16_rn(v[j]);
    }
  }
}

// The middle's shape: G outputs a unit, 256*strips points an item, nbuf
// buffers of them; g = 0 for middle_wide.
struct Middle {
  int g, strips, nbuf;
};

size_t middle_bytes(int wd, const Middle& m) {
  if (m.g == 0) return 0;
  const size_t wdp = (wd + m.g - 1) / m.g * m.g;
  return sizeof(float) * (wd * wdp + (size_t)m.nbuf * wd * 256 * m.strips);
}

// Of the shapes that fit, the one with the least time a point: the rounds
// of units over the 8 warps, times G, over strips, a third more with one
// buffer (the copies then wait for the sums); middle_wide if none fits.
Middle middle_shape(int wd) {
  Middle best = {0, 0, 0};
  long best_cost = -1;
  const int gs[] = {16, 12, 8}, ss[] = {2, 1}, bs[] = {2, 1};
  for (int g : gs)
    for (int strips : ss)
      for (int nbuf : bs) {
        const Middle m = {g, strips, nbuf};
        if (middle_bytes(wd, m) > ROOM) continue;
        const long units = (long)(wd + g - 1) / g * strips;
        const long cost =
            (units + 7) / 8 * g * (nbuf == 2 ? 3 : 4) * (2 / strips);
        if (best_cost < 0 || cost < best_cost) best = m, best_cost = cost;
      }
  return best;
}

__global__ void __launch_bounds__(NTG, 1)
k1_general(const float* __restrict__ GL, const float* __restrict__ W,
           const float* __restrict__ GR, const float* __restrict__ X,
           float* __restrict__ Y, bf16* __restrict__ GLb,
           bf16* __restrict__ GRb, bf16* __restrict__ Xt,
           bf16* __restrict__ T2, float* __restrict__ T1, int w, int d,
           int D, int Dp, int bn1, int bn3, Middle mid) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t bars = smem_u32(smem);  // stage 1's, then stage 3's
  const uint32_t ring = bars + BARS;
  float* work = reinterpret_cast<float*>(smem + BARS);
  cg::grid_group grid = cg::this_grid();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * GSTAGES; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  convert_general(GL, GR, X, GLb, GRb, Xt, w, d, D, Dp, work);
  grid.sync();
  // stage 1: T1 (w*Dp x d*Dp, row-major; row a*Dp + x, column t*Dp + n) =
  // GLb Xt^T
  const Gemm g1 = {GLb, Xt, w * Dp, d * Dp, Dp / TILE, T1, (size_t)d * Dp,
                   w * Dp, d * Dp};
  gemm_general_bn(bn1, g1, ring, bars);
  grid.sync();
  if (mid.g == 16)
    middle_general<16>(T1, W, T2, w, d, Dp, work, mid.strips, mid.nbuf);
  else if (mid.g == 12)
    middle_general<12>(T1, W, T2, w, d, Dp, work, mid.strips, mid.nbuf);
  else if (mid.g == 8)
    middle_general<8>(T1, W, T2, w, d, Dp, work, mid.strips, mid.nbuf);
  else
    middle_wide(T1, W, T2, w, d, Dp);
  grid.sync();
  // stage 3: y ((D*d) x D of the (d*Dp) x Dp view, row x*d + s) = T2 GRb^T
  // over K = (b, n)
  const Gemm g3 = {T2, GRb, d * Dp, Dp, w * Dp / TILE, Y, (size_t)D, D * d,
                   D};
  gemm_general_bn(bn3, g3, ring, bars + 8 * GSTAGES);
}

// ---- host side --------------------------------------------------------------
// The fused tiers, (d, TN, largest w), the widest n-tile first for each d:
// each keeps the w*d accumulators of 64 x TN at 96 f32 registers a thread.
// Every other (w, d) takes k1_general.
#define K1_TIERS(X) \
  X(2, 32, 3) X(2, 16, 6) X(2, 8, 12) X(3, 32, 2) X(3, 16, 4) X(3, 8, 8)

bool fused(int w, int d) {
#define K1_HAS(DD_, TN_, WMAX_) \
  if (d == DD_ && w <= WMAX_) return true;
  K1_TIERS(K1_HAS)
#undef K1_HAS
  return false;
}

// The scratch of one launch, carved from one allocation at `base`: bf16
// GLb and GRb (w, Dp, Dp), Xt (d, Dp, Dp), T2 (d*Dp, w*Dp), and for the
// general path f32 T1 (w, Dp, d*Dp); each starts on a 256-byte boundary.
// The general path lays its bf16 buffers out tiled, in the same sizes.
struct Scratch {
  bf16 *GLb, *GRb, *Xt, *T2;
  float* T1;
  size_t bytes;
};

Scratch carve(uintptr_t base, int w, int d, int Dp) {
  const size_t slab = (size_t)Dp * Dp;
  size_t off = 0;
  auto take = [&](size_t nbytes) {
    const uintptr_t p = base + off;
    off += (nbytes + 255) / 256 * 256;
    return p;
  };
  Scratch s;
  s.GLb = (bf16*)take(2 * w * slab);
  s.GRb = (bf16*)take(2 * w * slab);
  s.Xt = (bf16*)take(2 * d * slab);
  s.T2 = (bf16*)take(2 * (size_t)w * d * slab);
  s.T1 = fused(w, d) ? nullptr : (float*)take(4 * (size_t)w * d * slab);
  s.bytes = off;
  return s;
}

int padded(int D) { return (D + TILE - 1) / TILE * TILE; }

constexpr int MAX_DEVICES = 64;

// Launches `kernel` cooperatively on stream `st` with `bytes` of dynamic
// shared memory, one block per work item up to as many as fit on the card
// at once. `resident` is the kernel's own record of that number per device
// (0: not known yet); finding it sets the kernel's shared-memory size.
cudaError_t cooperative(const void* kernel, size_t bytes, int items,
                        void** args, cudaStream_t st,
                        int (&resident)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                          bytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm * sms <= 0) return cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per_sm * sms;
  }
  const int blocks = items < resident[dev] ? items : resident[dev];
  return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(NT), args,
                                     bytes, st);
}

template <int TN, int DD, int WMAX>
cudaError_t launch_fused(const float* GL, const float* W, const float* GR,
                         const float* X, float* Y, const Scratch& s, int w,
                         int D, int Dp, cudaStream_t st) {
  static int resident[MAX_DEVICES];
  const size_t most1 = Stage1<TN, DD, WMAX>::RING_BYTES +
                       sizeof(float) * WMAX * WMAX * DD * DD;
  const size_t bytes = 1024 + (most1 > GEMM_BYTES ? most1 : GEMM_BYTES);
  const int items1 = (Dp / TN) * (Dp / TILE);
  const int items3 = (Dp / TILE) * (DD * Dp / TILE);
  bf16 *GLb = s.GLb, *GRb = s.GRb, *Xt = s.Xt, *T2 = s.T2;
  void* args[] = {&GL, &W, &GR, &X, &Y, &GLb, &GRb, &Xt, &T2, &w, &D, &Dp};
  return cooperative((const void*)k1_kernel<TN, DD, WMAX>, bytes,
                     items1 > items3 ? items1 : items3, args, st, resident);
}

// The width of a GEMM's 128-row tiles, of 128, 96 and 64: the least waves
// over `blocks` times the time of a tile, taken as BN plus 32 for the loads
// of its A rows, which a narrower tile spreads over fewer products.
int tile_width(int M, int N, int blocks) {
  const int widths[] = {128, 96, 64};
  int best = 128;
  long best_cost = -1;
  for (int bn : widths) {
    const long tiles = (long)((M + 127) / 128) * ((N + bn - 1) / bn);
    const long cost = (tiles + blocks - 1) / blocks * (bn + 32);
    if (best_cost < 0 || cost < best_cost) best = bn, best_cost = cost;
  }
  return best;
}

// Launches k1_general cooperatively on stream `st`: one block on every SM
// (`resident` records their number per device; 0: not known yet), the
// tiles of both GEMMs and the middle's shape picked from (w, d, Dp).
cudaError_t launch_general(const float* GL, const float* W, const float* GR,
                           const float* X, float* Y, const Scratch& s, int w,
                           int d, int D, int Dp, cudaStream_t st) {
  static int resident[MAX_DEVICES];
  const void* kernel = (const void*)k1_general;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          NTG, SMEM_MAX);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm * sms <= 0) return cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per_sm * sms;
  }
  const int blocks = resident[dev];
  Middle mid = middle_shape(w * d);
  const size_t mb = middle_bytes(w * d, mid);
  const size_t bytes = 1024 + BARS + (mb > GRING_BYTES ? mb : GRING_BYTES);
  int bn1 = tile_width(w * Dp, d * Dp, blocks);
  int bn3 = tile_width(d * Dp, Dp, blocks);
  bf16 *GLb = s.GLb, *GRb = s.GRb, *Xt = s.Xt, *T2 = s.T2;
  float* T1 = s.T1;
  void* args[] = {&GL, &W,  &GR, &X, &Y, &GLb, &GRb, &Xt,  &T2,
                  &T1, &w,  &d,  &D, &Dp, &bn1, &bn3, &mid};
  return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(NTG), args,
                                     bytes, st);
}

}  // namespace

// Plain C entry points (loaded with ctypes). GL, GR: (w, D, D); W: (w, w,
// d, d); X, Y: (D, d, D); all float32, contiguous, on the current device.

// Bytes of device scratch that ac_apply_bf16 needs at (w, d, D); 0 if
// these are not all positive.
extern "C" size_t ac_apply_bf16_scratch_bytes(int w, int d, int D) {
  if (w <= 0 || d <= 0 || D <= 0) return 0;
  return carve(0, w, d, padded(D)).bytes;
}

// 1 where ac_apply_bf16 runs (w, d) on a fused tier of K1_TIERS, 0 where it
// takes k1_general.
extern "C" int ac_apply_bf16_fused(int w, int d) { return fused(w, d) ? 1 : 0; }

// Launches K1 on `stream` without synchronizing, with `scratch` (256-byte
// aligned, `scratch_bytes` long, at least ac_apply_bf16_scratch_bytes) as
// its work space, and returns the launch's cudaError_t (0 on success).
extern "C" int ac_apply_bf16(const float* GL, const float* W, const float* GR,
                             const float* X, float* Y, void* scratch,
                             size_t scratch_bytes, int w, int d, int D,
                             void* stream) {
  if (w <= 0 || d <= 0 || D <= 0 || scratch == nullptr ||
      (uintptr_t)scratch % 256 != 0)
    return (int)cudaErrorInvalidValue;
  const int Dp = padded(D);
  const Scratch s = carve((uintptr_t)scratch, w, d, Dp);
  if (s.bytes > scratch_bytes) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define K1_LAUNCH(DD_, TN_, WMAX_)                                      \
  if (d == DD_ && w <= WMAX_)                                           \
    return (int)launch_fused<TN_, DD_, WMAX_>(GL, W, GR, X, Y, s, w, D, \
                                              Dp, st);
  K1_TIERS(K1_LAUNCH)
#undef K1_LAUNCH
  return (int)launch_general(GL, W, GR, X, Y, s, w, d, D, Dp, st);
}
