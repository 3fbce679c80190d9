// K1: the fused one-site effective-Hamiltonian matvec in bf16.
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
// Bound. At D=512, w=3, d=2 one matvec is 2 * 2*w*D^2*dD = 3.2 GFLOP over
// at least 10.5 MB of f32 operands (GL, GR, X, Y): ~300 flop/byte, at the
// card's bf16 ridge.
//
// Design. The TPU kernel keeps t1 for a 128-row bra tile in VMEM
// (w*128*d*D f32 = 1.5 MB at D=512), far beyond the 227 KB of shared
// memory a block can use, and runs its D/128 = 4 grid steps in order, one
// after the other. Here the contracted index n is split across blocks,
// with a second pass that sums the splits:
//   pass 1: block (split s, bra tile of TX=16 rows) takes the n-range of
//     its split in chunks of TN=64. Per chunk it computes t1 for its rows
//     (stage 1, streamed over y in chunks of TY=64) and the middle into
//     t2 (stage 2, rounded to bf16), and keeps t2 of its whole n-range in
//     shared memory. It then walks all ket columns r in tiles of TR=128,
//     contracting t2 against GR (stage 3) into a partial y of its split.
//   pass 2: y = the sum of the partial y's over the splits (in a fixed
//     order, so the result is deterministic).
// Nothing is computed twice, GL and X are read once per block, and at
// D=512 the grid has 8 splits x 32 bra tiles = 256 blocks for the 132 SMs
// (two resident per SM). The price is the partials: nsplit * D*d*D f32
// written and read once (16 MB at D=512). Stages 1 and 3 run on the bf16
// tensor cores through WMMA (16x16x16 bf16 -> f32; the rows of stage 3
// are the (x, s) pairs, so TX*d is a multiple of 16 for any d); stage 2 is
// f32 FMA. Accumulator tiles live in shared memory, each owned by one warp.
// Any D, w, d is taken: out-of-range rows and columns are zero-filled on
// load and masked on store. wgmma and TMA loads are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TX = 16;    // bra rows x per block (one WMMA M tile of x)
constexpr int TR = 128;   // ket columns r per stage-3 tile
constexpr int TN = 64;    // contracted n per chunk
constexpr int TY = 64;    // contracted y per stage-1 chunk
constexpr int PAD = 8;    // bf16 row padding (16 bytes) against bank conflicts
constexpr int MAX_CHUNKS = 4;  // n-chunks per split at most (bounds sT2)
constexpr int NWARP = 8;
constexpr int NT = 32 * NWARP;

constexpr int LDGL = TY + PAD;  // sGL[a][x][yy]
constexpr int LDGR = TN + PAD;  // sGR[b][r][nn]

__host__ __device__ inline size_t up32(size_t bytes) {
  return (bytes + 31) / 32 * 32;
}

// Offsets in bytes of the shared arrays; every array starts on a 32-byte
// boundary, as WMMA loads and stores need. Stage 1's buffers (sT1, sGL,
// sX) and stage 3's (sGR, sY) are never live together and share memory.
struct Layout {
  size_t sW, sT2, sT1, sGL, sX, sGR, sY, total;
  int ldx, ldt2;  // row lengths of sX[yy][t*TN+nn] and sT2[b][x*d+s][n]
  __host__ __device__ Layout(int w, int d, int ns_len) {
    ldx = d * TN + PAD;
    ldt2 = ns_len + PAD;
    size_t o = 0;
    sW = o;  o += up32(sizeof(float) * w * w * d * d);
    sT2 = o; o += up32(sizeof(bf16) * w * TX * d * ldt2);
    const size_t shared = o;
    sT1 = o; o += up32(sizeof(float) * w * TX * d * TN);
    sGL = o; o += up32(sizeof(bf16) * w * TX * LDGL);
    sX = o;  o += up32(sizeof(bf16) * TY * ldx);
    const size_t end1 = o;
    o = shared;
    sGR = o; o += up32(sizeof(bf16) * w * TR * LDGR);
    sY = o;  o += up32(sizeof(float) * TX * d * TR);
    total = o > end1 ? o : end1;
  }
};

// The n-splits at width D on a card with `sms` SMs: about two blocks per
// SM, each split a whole number of TN-chunks, at most MAX_CHUNKS of them.
void split_plan(int D, int sms, int* nsplit, int* ns_len) {
  const int xtiles = (D + TX - 1) / TX;
  const int chunks = (D + TN - 1) / TN;
  const int target = (2 * sms + xtiles - 1) / xtiles;
  int per = (chunks + target - 1) / target;
  per = per < 1 ? 1 : (per > MAX_CHUNKS ? MAX_CHUNKS : per);
  *ns_len = per * TN;
  *nsplit = (chunks + per - 1) / per;
}

__global__ void __launch_bounds__(NT)
ac_apply_bf16_partial(const float* __restrict__ GL, const float* __restrict__ W,
                      const float* __restrict__ GR, const float* __restrict__ X,
                      float* __restrict__ P, int w, int d, int D, int ns_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(w, d, ns_len);
  float* sW = reinterpret_cast<float*>(smem + lay.sW);
  bf16* sT2 = reinterpret_cast<bf16*>(smem + lay.sT2);
  float* sT1 = reinterpret_cast<float*>(smem + lay.sT1);  // [a][x][t*TN+nn]
  bf16* sGL = reinterpret_cast<bf16*>(smem + lay.sGL);
  bf16* sX = reinterpret_cast<bf16*>(smem + lay.sX);
  bf16* sGR = reinterpret_cast<bf16*>(smem + lay.sGR);
  float* sY = reinterpret_cast<float*>(smem + lay.sY);    // [x*d+s][r]

  const int dTN = d * TN, ldx = lay.ldx, ldt2 = lay.ldt2, rows = TX * d;
  const int tid = threadIdx.x, warp = tid / 32;
  const int nbase = blockIdx.x * ns_len;
  const int x0 = blockIdx.y * TX;
  const int nF1 = w * (dTN / 16);          // t1 tiles: (a, column block)
  const int nF3 = (rows / 16) * (TR / 16); // y tiles: (row blk, col blk)
  float* Ps = P + (size_t)blockIdx.x * D * d * D;

  for (int i = tid; i < w * w * d * d; i += NT) sW[i] = W[i];

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fbc;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;

  // ---- stages 1 and 2 over the split's n-range, chunk by chunk ----
  for (int c0 = 0; c0 < ns_len; c0 += TN) {
    const int n0 = nbase + c0;
    for (int y0 = 0; y0 < D; y0 += TY) {
      __syncthreads();  // the previous readers of sGL/sX/sT1 are done
      for (int i = tid; i < w * TX * TY; i += NT) {
        const int yy = i % TY, x = (i / TY) % TX, a = i / (TY * TX);
        const int gx = x0 + x, gy = y0 + yy;
        const float v = (gx < D && gy < D) ? GL[((size_t)a * D + gx) * D + gy]
                                           : 0.f;
        sGL[(a * TX + x) * LDGL + yy] = __float2bfloat16_rn(v);
      }
      for (int i = tid; i < TY * dTN; i += NT) {
        const int nn = i % TN, t = (i / TN) % d, yy = i / dTN;
        const int gy = y0 + yy, gn = n0 + nn;
        const float v = (gy < D && gn < D) ? X[((size_t)gy * d + t) * D + gn]
                                           : 0.f;
        sX[yy * ldx + t * TN + nn] = __float2bfloat16_rn(v);
      }
      __syncthreads();
      for (int f = warp; f < nF1; f += NWARP) {
        const int a = f / (dTN / 16), cb = f % (dTN / 16);
        float* acc = sT1 + (size_t)a * TX * dTN + cb * 16;
        if (y0 == 0) wmma::fill_fragment(fc, 0.f);
        else wmma::load_matrix_sync(fc, acc, dTN, wmma::mem_row_major);
        for (int k = 0; k < TY; k += 16) {
          wmma::load_matrix_sync(fa, sGL + a * TX * LDGL + k, LDGL);
          wmma::load_matrix_sync(fb, sX + k * ldx + cb * 16, ldx);
          wmma::mma_sync(fc, fa, fb, fc);
        }
        wmma::store_matrix_sync(acc, fc, dTN, wmma::mem_row_major);
      }
    }
    __syncthreads();  // sT1 complete
    // t2[b][x*d+s][c0+nn] = bf16(sum_{a,t} W[a,b,s,t] t1[a][x][t*TN+nn])
    for (int i = tid; i < w * rows * TN; i += NT) {
      const int nn = i % TN, s = (i / TN) % d, x = (i / dTN) % TX,
                b = i / (dTN * TX);
      float acc = 0.f;
      for (int a = 0; a < w; ++a) {
        const float* t1 = sT1 + (a * TX + x) * dTN + nn;
        const float* wab = sW + ((a * w + b) * d + s) * d;
        for (int t = 0; t < d; ++t) acc = fmaf(wab[t], t1[t * TN], acc);
      }
      sT2[(b * rows + x * d + s) * ldt2 + c0 + nn] = __float2bfloat16_rn(acc);
    }
  }

  // ---- stage 3: partial y[x*d+s][r] = sum_{b,n in range} t2 GR ----
  for (int r0 = 0; r0 < D; r0 += TR) {
    for (int c0 = 0; c0 < ns_len; c0 += TN) {
      __syncthreads();  // sT2 complete / sGR and sY free for reuse
      for (int i = tid; i < w * TR * TN; i += NT) {
        const int nn = i % TN, r = (i / TN) % TR, b = i / (TN * TR);
        const int gr = r0 + r, gn = nbase + c0 + nn;
        const float v = (gr < D && gn < D) ? GR[((size_t)b * D + gr) * D + gn]
                                           : 0.f;
        sGR[(b * TR + r) * LDGR + nn] = __float2bfloat16_rn(v);
      }
      __syncthreads();
      for (int f = warp; f < nF3; f += NWARP) {
        const int rb = f / (TR / 16), cb = f % (TR / 16);
        float* acc = sY + (size_t)rb * 16 * TR + cb * 16;
        if (c0 == 0) wmma::fill_fragment(fc, 0.f);
        else wmma::load_matrix_sync(fc, acc, TR, wmma::mem_row_major);
        for (int b = 0; b < w; ++b) {
          for (int k = 0; k < TN; k += 16) {
            wmma::load_matrix_sync(
                fa, sT2 + (b * rows + rb * 16) * ldt2 + c0 + k, ldt2);
            wmma::load_matrix_sync(fbc, sGR + (b * TR + cb * 16) * LDGR + k,
                                   LDGR);
            wmma::mma_sync(fc, fa, fbc, fc);
          }
        }
        wmma::store_matrix_sync(acc, fc, TR, wmma::mem_row_major);
      }
    }
    __syncthreads();  // sY complete
    for (int i = tid; i < rows * TR; i += NT) {
      const int r = i % TR, row = i / TR;
      const int gx = x0 + row / d, gr = r0 + r;
      if (gx < D && gr < D) Ps[((size_t)x0 * d + row) * D + gr] = sY[i];
    }
  }
}

// y[i] = sum over the splits of P[s][i], in split order.
__global__ void sum_splits(const float* __restrict__ P, float* __restrict__ Y,
                           size_t n, int nsplit) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s) acc += P[s * n + i];
    Y[i] = acc;
  }
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

// Number of n-splits the launch below uses at width D on the current
// device, or a negative cudaError_t. The caller sizes the partials buffer
// from it: nsplit * D * d * D floats.
extern "C" int ac_apply_bf16_nsplit(int D) {
  int sms = 0, nsplit = 0, ns_len = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return -(int)err;
  split_plan(D, sms, &nsplit, &ns_len);
  return nsplit;
}

// Plain C entry point (loaded with ctypes). GL, GR: (w, D, D); W: (w, w, d,
// d); X, Y: (D, d, D); P: nsplit * D * d * D floats of scratch; all float32,
// contiguous, on the current device. Launches both passes on `stream`
// without synchronizing and returns the first launch's cudaError_t (0 on
// success).
extern "C" int ac_apply_bf16(const float* GL, const float* W, const float* GR,
                             const float* X, float* Y, float* P, int w, int d,
                             int D, void* stream) {
  if (w <= 0 || d <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0, nsplit = 0, ns_len = 0, dev = 0, max_optin = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  split_plan(D, sms, &nsplit, &ns_len);
  const size_t bytes = Layout(w, d, ns_len).total;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > (size_t)max_optin) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(ac_apply_bf16_partial,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(nsplit, (D + TX - 1) / TX);
  ac_apply_bf16_partial<<<grid, NT, bytes, st>>>(GL, W, GR, X, P, w, d, D,
                                                 ns_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)D * d * D;
  sum_splits<<<(unsigned)((n + 1023) / 1024), 256, 0, st>>>(P, Y, n, nsplit);
  return (int)cudaGetLastError();
}
