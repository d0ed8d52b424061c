// Bidirectional LSTM layer forward for Hopper (sm_90a), one cooperative launch.
//
// Replaces the Pallas TPU kernel empose_tpu/ops/lstm_kernel.py::_pallas_bidi
// (body _make_bidi_kernel): one bidirectional LSTM layer at inference, both
// directions over F steps, gates in torch order (i, f, g, o).  Each
// direction's gate input is its hoisted projection x_proj[:, d] (both biases
// folded in, computed outside as one GEMM per direction); the backward one is
// projected from the input reversed per sample by length, so one mask serves
// both directions and the backward outputs come out in reversed time.  Where
// mask == 0 the (h, c) state is frozen bit for bit and the step's output is
// h_new * mask.
//
// What bounds it on this card.  The recurrence is serial in time, and every
// step needs both directions' W_hh: 8.4 MB at H=512.  With the weights
// resident the least time is the fp32 FMA work, 2 * 2*F*N*H*4H operations,
// which at N=64 lies above the card's bytes line; at N=1 the weights' bytes
// bound it.  The TPU kernel kept both matrices in one core's VMEM and ran
// the two directions one after the other inside each grid step.  Here:
//   * the grid has 2*H/U blocks; block b serves direction b / (H/U) and U
//     consecutive hidden units j of it, whose four gate columns
//     {j, H+j, 2H+j, 3H+j} it computes for every batch row, so the c/h
//     update of a unit never leaves its block;
//   * the block's columns of its direction's W_hh are loaded into dynamic
//     shared memory once and stay there for all F steps (512 * 32 * 4 B =
//     64 KB at H=512, U=8);
//   * the two directions are independent, so ONE grid-wide barrier per time
//     step serves both (the stack kernel pays one per layer); h goes through
//     a double-buffered global buffer that stays in L2, read with __ldcg;
//   * fp32 FMAs on the CUDA cores, no tensor cores (the fp32 parity mode);
//     the inner loop is the stack kernel's: each thread multiplies 4 batch
//     rows by its unit's 4 gate columns over a quarter of every staged
//     k-tile, and the four partial sums meet in shared memory.
// U is the smallest of 4 and 8 that gives at most one block per SM (the
// stack kernel's rule): U=8 at H=512, 128 blocks of 91 KB.  A first probe
// also ran U=4, whose 256 blocks need two per SM: it was slower at the
// serving shapes (more blocks at each grid barrier) and about level at
// F=256.  The host side checks the grid's co-residency with the occupancy
// API, launches with cudaLaunchCooperativeKernel and refuses a grid that
// does not fit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;   // R: batch rows per thread
constexpr int kSplit = 4;  // KSPLIT: ways the k range of a tile is split

// k-width of one staged h tile, per units-per-block U.
__host__ __device__ constexpr int tile_k(int U) { return U == 4 ? 128 : 64; }

// Error codes beside cudaError_t values (which are >= 0); the stack kernel's
// (a block too large for shared memory shows as a grid that does not fit).
constexpr int kErrGridTooLarge = -1;
constexpr int kErrNoCooperative = -3;
constexpr int kErrBadShape = -4;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// Thread layout (the stack kernel's).  Thread t = ((ks * RGN) + rg) * U + u
// owns unit j0 + u, the R rows {rg, rg + RGN, ...} of each pass of
// RG = R * RGN rows, and the ks-th quarter of every staged k-tile.  The
// KSPLIT partial sums are added through shared memory by thread
// (row = t / U, unit u), which owns that (row, unit)'s c/h update.
//
// Shared-memory layout (floats):
//   w_s   [H][U][4]          this block's gate columns of W_hh[d]
//   h_s   [RG][KT + 4]       staged tile of h_prev rows (padded: float4-aligned,
//                            consecutive rows on distinct banks)
//   red   [KSPLIT][RG][U][4] partial gate sums
template <int U>
__global__ void __launch_bounds__(kThreads)
lstm_bidi_kernel(const float* __restrict__ x_proj,  // (F, 2, N, 4H)
                 const float* __restrict__ mask,    // (F, N)
                 const float* __restrict__ w_hh,    // (2, H, 4H)
                 float* __restrict__ outs,          // (F, 2, N, H)
                 float* hbuf,                       // (2, 2, N, H), [0] holds h0
                 float* c_state,                    // (2, N, H), holds c0, ends as cF
                 float* __restrict__ h_final,       // (2, N, H)
                 int F, int N, int H) {
  constexpr int RG = kThreads / U;           // batch rows per pass
  constexpr int RGN = RG / kRows;            // row groups per pass
  constexpr int KT = tile_k(U);
  constexpr int KTS = KT / kSplit;           // k per split per tile
  constexpr int KS = KT + 4;                 // padded tile row stride
  constexpr int V4 = RG * KT / 4 / kThreads; // float4 per thread per tile
  static_assert(U % 4 == 0, "a float4 of W_hh covers 4 units of one gate");
  static_assert(V4 * 4 * kThreads == RG * KT, "tile must split evenly over the threads");
  static_assert(kSplit * RGN * U == kThreads, "thread layout must cover the block");
  static_assert(KTS % 4 == 0, "a split must be whole float4");
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;
  float* h_s = w_s + (size_t)H * U * 4;
  float* red = h_s + RG * KS;

  const int tid = threadIdx.x;
  const int u = tid % U;
  const int rg = (tid / U) % RGN;
  const int ks = tid / (U * RGN);
  const int r = tid / U;  // epilogue row within the pass
  const int blocks_per_dir = H / U;
  const int d = blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * U;
  const int j = j0 + u;
  const int H4 = 4 * H;
  const size_t NH = (size_t)N * H;
  const int n_tiles = (H + KT - 1) / KT;
  cg::grid_group grid = cg::this_grid();

  // Resident weights: this block's 4*U gate columns of W_hh[d]; one float4
  // read covers 4 consecutive units of one gate.
  {
    constexpr int Q = U / 4;
    const float* src = w_hh + (size_t)d * H * H4;
#pragma unroll 4
    for (int idx = tid; idx < H * 4 * Q; idx += kThreads) {
      const int k = idx / (4 * Q);
      const int g = (idx / Q) % 4;
      const int q = idx % Q;
      const float4 v = *reinterpret_cast<const float4*>(src + (size_t)k * H4 + g * H + j0 + 4 * q);
      float* dst = w_s + ((size_t)k * U + 4 * q) * 4 + g;
      dst[0] = v.x; dst[4] = v.y; dst[8] = v.z; dst[12] = v.w;
    }
  }
  __syncthreads();

  // Staging registers: the next tile is fetched from L2 while the current
  // one is multiplied (one tile in flight per thread).
  float4 h_reg[V4];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* w_rec = w_s + u * 4;
  float* c_d = c_state + (size_t)d * NH;

  for (int t = 0; t < F; ++t) {
    const int rd = t & 1;
    const int wr = rd ^ 1;
    const float* h_prev = hbuf + ((size_t)rd * 2 + d) * NH;
    float* h_next = hbuf + ((size_t)wr * 2 + d) * NH;
    const float* mask_t = mask + (size_t)t * N;
    const float* xp_t = x_proj + ((size_t)t * 2 + d) * N * H4;
    float* out_t = outs + ((size_t)t * 2 + d) * NH;

    for (int n0 = 0; n0 < N; n0 += RG) {
      // __ldcg: these rows were written by other blocks before the last
      // grid barrier, so they are read from L2, never from a stale L1.
      auto fetch = [&](int k0) {
#pragma unroll
        for (int v = 0; v < V4; ++v) {
          const int e = (v * kThreads + tid) * 4;
          const int nn = n0 + e / KT;
          const int k = k0 + e % KT;
          h_reg[v] = nn < N && k < H
                         ? __ldcg(reinterpret_cast<const float4*>(h_prev + (size_t)nn * H + k))
                         : zero4;
        }
      };

      float acc[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;
      const bool active = n0 + rg < N;  // this thread has at least one real row

      // The epilogue's own reads are issued now so their latency hides
      // behind the tile sweep.
      const int n = n0 + r;
      const bool row_ok = n < N;
      const size_t off = (size_t)(row_ok ? n : 0) * H + j;
      float gate[4];
      float c_old = 0.0f, h_old = 0.0f, m = 0.0f;
      if (row_ok) {
        const float* xp = xp_t + (size_t)n * H4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) gate[g] = xp[g * H];
        c_old = c_d[off];
        h_old = __ldcg(h_prev + off);
        m = mask_t[n];
      }

      fetch(0);
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int k0 = tile * KT;
        __syncthreads();  // the previous tile is consumed
#pragma unroll
        for (int v = 0; v < V4; ++v) {
          const int e = (v * kThreads + tid) * 4;
          *reinterpret_cast<float4*>(h_s + (e / KT) * KS + e % KT) = h_reg[v];
        }
        __syncthreads();
        if (tile + 1 < n_tiles) fetch(k0 + KT);
        const int k_lo = ks * KTS;
        const int k_hi = active ? min(k_lo + KTS, H - k0) : k_lo;
        for (int kk = k_lo; kk < k_hi; kk += 4) {
          const float* wr_k = w_rec + (k0 + kk) * U * 4;
          float4 hv[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            hv[i] = *reinterpret_cast<const float4*>(h_s + (rg + i * RGN) * KS + kk);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 w = *reinterpret_cast<const float4*>(wr_k + q * U * 4);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float a = q == 0 ? hv[i].x : q == 1 ? hv[i].y : q == 2 ? hv[i].z : hv[i].w;
              acc[i][0] = fmaf(a, w.x, acc[i][0]);
              acc[i][1] = fmaf(a, w.y, acc[i][1]);
              acc[i][2] = fmaf(a, w.z, acc[i][2]);
              acc[i][3] = fmaf(a, w.w, acc[i][3]);
            }
          }
        }
      }

      // Add the KSPLIT partial sums: red[ks][row][u][g].  (red's readers of
      // the previous pass are past the tile loop's barriers.)
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = rg + i * RGN;
        *reinterpret_cast<float4*>(red + (((size_t)ks * RG + row) * U + u) * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      __syncthreads();
      if (row_ok) {
#pragma unroll
        for (int s = 0; s < kSplit; ++s) {
          const float4 p = *reinterpret_cast<const float4*>(red + (((size_t)s * RG + r) * U + u) * 4);
          gate[0] += p.x; gate[1] += p.y; gate[2] += p.z; gate[3] += p.w;
        }
        const float i_g = sigmoid_f(gate[0]);
        const float f_g = sigmoid_f(gate[1]);
        const float g_g = tanhf(gate[2]);
        const float o_g = sigmoid_f(gate[3]);
        const float c_new = f_g * c_old + i_g * g_g;
        const float h_new = o_g * tanhf(c_new);
        h_next[off] = m > 0.0f ? h_new : h_old;
        c_d[off] = m > 0.0f ? c_new : c_old;
        out_t[off] = h_new * m;
      }
    }
    grid.sync();  // both directions' h of step t are written
  }

  // Final h of the units this block owns (written by these same threads).
  const float* h_last = hbuf + ((size_t)(F & 1) * 2 + d) * NH;
  for (int n0 = 0; n0 < N; n0 += RG) {
    const int n = n0 + r;
    if (n < N) h_final[(size_t)d * NH + (size_t)n * H + j] = h_last[(size_t)n * H + j];
  }
}

size_t shared_bytes(int U, int H) {
  const int rg = kThreads / U;
  return sizeof(float) * ((size_t)H * U * 4 + (size_t)rg * (tile_k(U) + 4) +
                          (size_t)kSplit * kThreads * 4);
}

// Sets the kernel's shared-memory size and finds whether its grid of 2H/U
// blocks is co-resident (*fits).  Returns 0, or a cudaError_t value.
template <int U>
int co_resident(int H, int dev, int n_sms, bool* fits) {
  *fits = false;
  const size_t smem = shared_bytes(U, H);
  int max_smem = 0;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)max_smem) return 0;
  auto kernel = lstm_bidi_kernel<U>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  *fits = per_sm * n_sms >= 2 * H / U;
  return 0;
}

// Units per block for hidden size H on this card (*units): the smallest of 4
// and 8 that divides H and gives at most one block per SM, if that grid is
// co-resident; 0 if there is none.  Returns 0, or a cudaError_t value.
int pick_units(int H, int* units) {
  *units = 0;
  int dev = 0, n_sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  bool fits = false;
  int err = 0;
  if (2 * H / 4 <= n_sms) {
    err = co_resident<4>(H, dev, n_sms, &fits);
    *units = fits ? 4 : 0;
  } else if (H % 8 == 0 && 2 * H / 8 <= n_sms) {
    err = co_resident<8>(H, dev, n_sms, &fits);
    *units = fits ? 8 : 0;
  }
  return err;
}

template <int U>
int launch(const float* x_proj, const float* mask, const float* w_hh, float* outs, float* hbuf,
           float* c_state, float* h_final, int F, int N, int H, cudaStream_t stream) {
  void* args[] = {(void*)&x_proj, (void*)&mask,    (void*)&w_hh, (void*)&outs,
                  (void*)&hbuf,   (void*)&c_state, (void*)&h_final, (void*)&F,
                  (void*)&N,      (void*)&H};
  cudaError_t err = cudaLaunchCooperativeKernel((void*)lstm_bidi_kernel<U>, dim3(2 * H / U),
                                                dim3(kThreads), args, shared_bytes(U, H), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Units per block the kernel takes for hidden size H on this card (see
// pick_units); 0 if no grid is co-resident or a query failed.
int lstm_bidi_units(int H) {
  if (H <= 0 || H % 4 != 0) return 0;
  int units = 0;
  return pick_units(H, &units) == 0 ? units : 0;
}

// Runs one bidirectional layer over all F steps in one cooperative launch on
// `stream`.  hbuf (2, 2, N, H) must hold h0 in its first half and c_state
// (2, N, H) must hold c0; on return outs, h_final and c_state (= cF) are
// written (stream ordered).  Returns 0, a cudaError_t value, or a negative
// code above.
int lstm_bidi_forward(const float* x_proj, const float* mask, const float* w_hh, float* outs,
                      float* hbuf, float* c_state, float* h_final, int F, int N, int H,
                      void* stream) {
  if (F <= 0 || N <= 0 || H <= 0 || H % 4 != 0) return kErrBadShape;
  int dev = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return kErrNoCooperative;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int units = 0;
  const int err = pick_units(H, &units);
  if (err != 0) return err;
  switch (units) {
    case 4: return launch<4>(x_proj, mask, w_hh, outs, hbuf, c_state, h_final, F, N, H, s);
    case 8: return launch<8>(x_proj, mask, w_hh, outs, hbuf, c_state, h_final, F, N, H, s);
    default: return kErrGridTooLarge;
  }
}

}  // extern "C"
