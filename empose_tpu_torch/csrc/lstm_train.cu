// The LSTM training pair for Hopper (sm_90a): forward sweep and reverse sweep
// of one direction-layer, each one cooperative launch over all F steps.
//
// Replaces the Pallas TPU kernels of empose_tpu/ops/lstm_train_kernel.py:
//   * lstm_train_fwd_kernel <- _pallas_fwd (body _make_fwd_kernel): from the
//     hoisted input projection x_proj (both biases folded in), run the
//     recurrence gates = x_proj[t] + h @ W_hh, gate order (i, f, g, o), and
//     emit the gate pre-activations and the carried (h, c) of every step.
//     Where mask == 0 the old (h, c) is selected, never blended.
//   * lstm_train_bwd_kernel <- _pallas_bwd (body _make_bwd_kernel): the
//     reverse-time sweep that turns the cotangents of every carried (h, c)
//     into dgates (the cotangent of the pre-activations) and carries dh, dc
//     back into dh0, dc0; frozen steps pass the cotangents straight through.
// Everything else of the layer's gradient is one large GEMM outside
// (dW_hh = h_prev^T @ dgates, dx_proj = dgates), as in the JAX package.
//
// What bounds them on this card.  Both sweeps are serial in time and need
// all of W_hh (4 MB at H=512) every step.  With W_hh resident the least time
// is the fp32 FMA work, 2*F*N*H*4H operations per sweep; what the kernels
// actually pay per step is a grid barrier and one round trip of the step's
// exchange buffer through L2.  W_hh is spread over the SMs:
//   * forward: each block owns U consecutive hidden units j and keeps their
//     four gate columns {j, H+j, 2H+j, 3H+j} of W_hh in shared memory
//     (512 x 16 floats = 32 KB at H=512, U=4, 128 blocks).  h_all[t-1] is the
//     exchange buffer every block reads at step t; c stays with the thread
//     that owns (row, unit).  One grid barrier per step.
//   * backward: the step's product dh_prev = dgates[t] @ W_hh^T needs ROWS of
//     W_hh, so each block keeps W_hh[j, 0:4H] of its U units resident
//     (32 KB at H=512, U=4).  Step t: (A) for its own units the block forms
//     Dh = dh_carry + dh_all[t], Dc = dc_carry + dc_all[t], the four dgates
//     columns and dc_carry = dc_new * f + Dc * (1 - m) (block-local), and
//     writes dgates[t], which is both an output and the exchange buffer;
//     (B) grid barrier; (C) dh_carry = dgates[t] @ W_hh[j, :]^T + Dh * (1 - m)
//     for its units, reading all 4H columns of dgates[t] from L2.  One grid
//     barrier per step; the carries live in dh0/dc0 and never leave their
//     block until the sweep ends.
//   * fp32 FMAs on the CUDA cores (the fp32 parity mode); each thread
//     multiplies 4 rows by 4 columns per k (8 float4 shared reads per 64
//     FMAs) and the k-split partial sums meet in shared memory.
// Reads of buffers written by other blocks before the last grid barrier
// (h_all[t-1], dgates[t]) go through __ldcg, never through a stale L1.
// The grid must be co-resident for the barrier, so the host side launches
// it with cudaLaunchCooperativeKernel and refuses a grid that does not fit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // batch rows per thread in the products

// Error codes beside cudaError_t values (which are >= 0); the same values
// as lstm_stack.cu.
constexpr int kErrGridTooLarge = -1;
constexpr int kErrSharedTooLarge = -2;
constexpr int kErrNoCooperative = -3;
constexpr int kErrBadShape = -4;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// Forward sweep.
//
// Thread t = ((ks * RGN) + rg) * U + u owns unit j0 + u, the rows
// {rg, rg + RGN, ...} of each pass of RG rows, and the ks-th quarter of every
// staged k-tile of h_prev; the KSPLIT partial sums of the four gates are
// added through shared memory by thread (row = t / U, unit u), which then
// owns that (row, unit)'s c/h update.
constexpr int kSplitF = 4;
__host__ __device__ constexpr int fwd_tile_k(int U) { return U == 1 ? 32 : U == 2 ? 64 : U == 4 ? 128 : 64; }

// Shared memory (floats): w_s [H][U][4] | h_s [RG][KT + 4] | red [KSPLIT][RG][U][4]
template <int U>
__global__ void __launch_bounds__(kThreads)
lstm_train_fwd_kernel(const float* __restrict__ x_proj,  // (F, N, 4H)
                      const float* __restrict__ mask,    // (F, N)
                      const float* __restrict__ w_hh,    // (H, 4H)
                      const float* __restrict__ h0,      // (N, H)
                      const float* __restrict__ c0,      // (N, H)
                      float* __restrict__ gates,         // (F, N, 4H) or null
                      float* h_all,                      // (F, N, H)
                      float* c_all,                      // (F, N, H)
                      int F, int N, int H) {
  constexpr int RG = kThreads / U;
  constexpr int RGN = RG / kRows;
  constexpr int KT = fwd_tile_k(U);
  constexpr int KTS = KT / kSplitF;
  constexpr int KS = KT + 4;
  constexpr int V4 = RG * KT / 4 / kThreads;
  static_assert(V4 * 4 * kThreads == RG * KT, "tile must split evenly over the threads");
  static_assert(kSplitF * RGN * U == kThreads, "thread layout must cover the block");
  static_assert(KTS % 4 == 0, "a split must be whole float4");
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;
  float* h_s = w_s + (size_t)H * U * 4;
  float* red = h_s + RG * KS;

  const int tid = threadIdx.x;
  const int u = tid % U;
  const int rg = (tid / U) % RGN;
  const int ks = tid / (U * RGN);
  const int r = tid / U;
  const int j0 = blockIdx.x * U;
  const int j = j0 + u;
  const int H4 = 4 * H;
  const size_t NH = (size_t)N * H;
  const int n_tiles = (H + KT - 1) / KT;
  cg::grid_group grid = cg::this_grid();

  for (int idx = tid; idx < H * U * 4; idx += kThreads) {
    const int k = idx / (U * 4);
    const int uu = (idx / 4) % U;
    const int g = idx % 4;
    w_s[idx] = w_hh[(size_t)k * H4 + g * H + j0 + uu];
  }
  __syncthreads();

  float4 h_reg[V4];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* w_u = w_s + u * 4;

  for (int t = 0; t < F; ++t) {
    const float* h_prev = t == 0 ? h0 : h_all + (size_t)(t - 1) * NH;
    const float* c_prev = t == 0 ? c0 : c_all + (size_t)(t - 1) * NH;
    float* h_next = h_all + (size_t)t * NH;
    float* c_next = c_all + (size_t)t * NH;
    const float* mask_t = mask + (size_t)t * N;

    for (int n0 = 0; n0 < N; n0 += RG) {
      auto fetch = [&](int k0) {
#pragma unroll
        for (int v = 0; v < V4; ++v) {
          const int e = (v * kThreads + tid) * 4;
          const int nn = n0 + e / KT;
          const int k = k0 + e % KT;
          h_reg[v] = (nn < N && k < H)
                         ? __ldcg(reinterpret_cast<const float4*>(h_prev + (size_t)nn * H + k))
                         : zero4;
        }
      };

      float acc[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;
      const bool active = n0 + rg < N;

      // The epilogue's own reads are issued first so their latency hides
      // behind the tile sweep.
      const int n = n0 + r;
      const bool row_ok = n < N;
      const size_t off = (size_t)(row_ok ? n : 0) * H + j;
      float gate[4];
      float c_old = 0.0f, h_old = 0.0f, m = 0.0f;
      if (row_ok) {
        const float* xp = x_proj + ((size_t)t * N + n) * H4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) gate[g] = xp[g * H];
        c_old = __ldcg(c_prev + off);
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
          const float* w_k = w_u + (k0 + kk) * U * 4;
          float4 hv[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            hv[i] = *reinterpret_cast<const float4*>(h_s + (rg + i * RGN) * KS + kk);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 w = *reinterpret_cast<const float4*>(w_k + q * U * 4);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float a = lane(hv[i], q);
              acc[i][0] = fmaf(a, w.x, acc[i][0]);
              acc[i][1] = fmaf(a, w.y, acc[i][1]);
              acc[i][2] = fmaf(a, w.z, acc[i][2]);
              acc[i][3] = fmaf(a, w.w, acc[i][3]);
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = rg + i * RGN;
        *reinterpret_cast<float4*>(red + (((size_t)ks * RG + row) * U + u) * 4) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      __syncthreads();
      if (row_ok) {
#pragma unroll
        for (int s = 0; s < kSplitF; ++s) {
          const float4 p = *reinterpret_cast<const float4*>(red + (((size_t)s * RG + r) * U + u) * 4);
          gate[0] += p.x; gate[1] += p.y; gate[2] += p.z; gate[3] += p.w;
        }
        if (gates != nullptr) {
          float* gp = gates + ((size_t)t * N + n) * H4 + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) gp[g * H] = gate[g];
        }
        const float i_g = sigmoid_f(gate[0]);
        const float f_g = sigmoid_f(gate[1]);
        const float g_g = tanhf(gate[2]);
        const float o_g = sigmoid_f(gate[3]);
        const float c_new = f_g * c_old + i_g * g_g;
        const float h_new = o_g * tanhf(c_new);
        h_next[off] = m > 0.0f ? h_new : h_old;
        c_next[off] = m > 0.0f ? c_new : c_old;
      }
      __syncthreads();  // red is reused by the next pass
    }
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// Reverse sweep.
//
// Product layout: a pass covers RGB batch rows; thread t = ((ks * RGNB) + rg)
// * UQ + q multiplies the rows {rg, rg + RGNB, ...} by the four units
// 4q..4q+3 (units beyond U are zero columns) over the ks-th slice of every
// staged k-tile of dgates[t]; the KSPLIT partial sums meet in shared memory.
constexpr int kRowsPassB = 64;
constexpr int kTileB = 128;
__host__ __device__ constexpr int bwd_quads(int U) { return (U + 3) / 4; }

// Shared memory (floats): wt_s [4H][UP] | g_s [RGB][KTB + 4] | red [KSPLIT][RGB][UP]
template <int U>
__global__ void __launch_bounds__(kThreads)
lstm_train_bwd_kernel(const float* __restrict__ dh_all,  // (F, N, H)
                      const float* __restrict__ dc_all,  // (F, N, H)
                      const float* __restrict__ gates,   // (F, N, 4H)
                      const float* __restrict__ c_prev,  // (F, N, H): c before step t
                      const float* __restrict__ mask,    // (F, N)
                      const float* __restrict__ w_hh,    // (H, 4H)
                      float* dgates,                     // (F, N, 4H)
                      float* dh_c,                       // (N, H): carry, ends as dh0
                      float* dc_c,                       // (N, H): carry, ends as dc0
                      int F, int N, int H) {
  constexpr int UQ = bwd_quads(U);
  constexpr int UP = 4 * UQ;
  constexpr int RGB = kRowsPassB;
  constexpr int RGNB = RGB / kRows;
  constexpr int KSPLIT = kThreads / (RGNB * UQ);
  constexpr int KTB = kTileB;
  constexpr int KTS = KTB / KSPLIT;
  constexpr int KS = KTB + 4;
  constexpr int V4 = RGB * KTB / 4 / kThreads;
  static_assert(KSPLIT * RGNB * UQ == kThreads, "thread layout must cover the block");
  static_assert(KTS % 4 == 0 && KTS > 0, "a split must be whole float4");
  static_assert(V4 * 4 * kThreads == RGB * KTB, "tile must split evenly over the threads");
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  float* wt_s = smem;
  float* g_s = wt_s + (size_t)H4 * UP;
  float* red = g_s + RGB * KS;

  const int tid = threadIdx.x;
  const int q = tid % UQ;
  const int rg = (tid / UQ) % RGNB;
  const int ks = tid / (UQ * RGNB);
  const int j0 = blockIdx.x * U;
  const size_t NH = (size_t)N * H;
  const size_t NG = (size_t)N * H4;
  const int n_tiles = (H4 + KTB - 1) / KTB;
  cg::grid_group grid = cg::this_grid();

  // Resident rows W_hh[j0 + u, :], transposed to k-major; zero for padding units.
  for (int idx = tid; idx < UP * H4; idx += kThreads) {
    const int uu = idx / H4;
    const int k = idx % H4;
    wt_s[(size_t)k * UP + uu] = uu < U ? w_hh[(size_t)(j0 + uu) * H4 + k] : 0.0f;
  }
  for (int idx = tid; idx < N * U; idx += kThreads) {
    const size_t off = (size_t)(idx / U) * H + j0 + idx % U;
    dh_c[off] = 0.0f;
    dc_c[off] = 0.0f;
  }
  __syncthreads();

  float4 g_reg[V4];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = F - 1; t >= 0; --t) {
    const size_t base_h = (size_t)t * NH;
    const size_t base_g = (size_t)t * NG;
    float* dg_t = dgates + base_g;

    // (A) Elementwise, for the block's own units: dgates[t], dc carry, and
    // the frozen-step bypass Dh * (1 - m) parked in the dh carry.
    for (int idx = tid; idx < N * U; idx += kThreads) {
      const int n = idx / U;
      const int j = j0 + idx % U;
      const size_t off = (size_t)n * H + j;
      const float m = mask[(size_t)t * N + n];
      const float Dh = dh_c[off] + dh_all[base_h + off];
      const float Dc = dc_c[off] + dc_all[base_h + off];
      const float* gp = gates + base_g + (size_t)n * H4 + j;
      const float i_g = sigmoid_f(gp[0]);
      const float f_g = sigmoid_f(gp[H]);
      const float g_g = tanhf(gp[2 * H]);
      const float o_g = sigmoid_f(gp[3 * H]);
      const float cp = c_prev[base_h + off];
      const float c_new = f_g * cp + i_g * g_g;
      const float tc = tanhf(c_new);
      const float dh_new = Dh * m;
      const float dc_new = Dc * m + dh_new * o_g * (1.0f - tc * tc);
      float* dgp = dg_t + (size_t)n * H4 + j;
      dgp[0] = dc_new * g_g * i_g * (1.0f - i_g);
      dgp[H] = dc_new * cp * f_g * (1.0f - f_g);
      dgp[2 * H] = dc_new * i_g * (1.0f - g_g * g_g);
      dgp[3 * H] = dh_new * tc * o_g * (1.0f - o_g);
      dh_c[off] = Dh * (1.0f - m);
      dc_c[off] = dc_new * f_g + Dc * (1.0f - m);
    }

    // (B) Every block's dgates[t] columns are written.
    grid.sync();

    // (C) dh carry += dgates[t] @ W_hh[j, :]^T for the block's units.
    for (int n0 = 0; n0 < N; n0 += RGB) {
      auto fetch = [&](int k0) {
#pragma unroll
        for (int v = 0; v < V4; ++v) {
          const int e = (v * kThreads + tid) * 4;
          const int nn = n0 + e / KTB;
          const int k = k0 + e % KTB;
          g_reg[v] = (nn < N && k < H4)
                         ? __ldcg(reinterpret_cast<const float4*>(dg_t + (size_t)nn * H4 + k))
                         : zero4;
        }
      };
      float acc[kRows][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
      const bool active = n0 + rg < N;

      fetch(0);
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int k0 = tile * KTB;
        __syncthreads();
#pragma unroll
        for (int v = 0; v < V4; ++v) {
          const int e = (v * kThreads + tid) * 4;
          *reinterpret_cast<float4*>(g_s + (e / KTB) * KS + e % KTB) = g_reg[v];
        }
        __syncthreads();
        if (tile + 1 < n_tiles) fetch(k0 + KTB);
        const int k_lo = ks * KTS;
        const int k_hi = active ? min(k_lo + KTS, H4 - k0) : k_lo;
        for (int kk = k_lo; kk < k_hi; kk += 4) {
          float4 gv[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            gv[i] = *reinterpret_cast<const float4*>(g_s + (rg + i * RGNB) * KS + kk);
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const float4 w = *reinterpret_cast<const float4*>(wt_s + (size_t)(k0 + kk + qq) * UP + 4 * q);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const float a = lane(gv[i], qq);
              acc[i][0] = fmaf(a, w.x, acc[i][0]);
              acc[i][1] = fmaf(a, w.y, acc[i][1]);
              acc[i][2] = fmaf(a, w.z, acc[i][2]);
              acc[i][3] = fmaf(a, w.w, acc[i][3]);
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = rg + i * RGNB;
        *reinterpret_cast<float4*>(red + ((size_t)ks * RGB + row) * UP + 4 * q) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      __syncthreads();
      for (int idx = tid; idx < RGB * U; idx += kThreads) {
        const int row = idx / U;
        const int uu = idx % U;
        const int n = n0 + row;
        if (n < N) {
          float s = 0.0f;
          for (int p = 0; p < KSPLIT; ++p) s += red[((size_t)p * RGB + row) * UP + uu];
          dh_c[(size_t)n * H + j0 + uu] += s;
        }
      }
      __syncthreads();  // red and the carries are read again next pass / step
    }
  }
}

size_t fwd_shared_bytes(int U, int H) {
  const int rg = kThreads / U;
  return sizeof(float) * ((size_t)H * U * 4 + (size_t)rg * (fwd_tile_k(U) + 4) +
                          (size_t)kSplitF * rg * U * 4);
}

size_t bwd_shared_bytes(int U, int H) {
  const int up = 4 * bwd_quads(U);
  const int ksplit = kThreads / (kRowsPassB / kRows * bwd_quads(U));
  return sizeof(float) * ((size_t)4 * H * up + (size_t)kRowsPassB * (kTileB + 4) +
                          (size_t)ksplit * kRowsPassB * up);
}

// Sets the kernel's shared memory, checks that the grid of H / U blocks is
// co-resident, and launches it cooperatively on `stream`.
int launch_cooperative(const void* kernel, int U, int H, size_t smem, void** args,
                       cudaStream_t stream) {
  int dev = 0, n_sms = 0, coop = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!coop) return kErrNoCooperative;
  if (smem > (size_t)max_smem) return kErrSharedTooLarge;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = H / U;
  if (per_sm * n_sms < blocks) return kErrGridTooLarge;
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int U>
int launch_fwd(const float* x_proj, const float* mask, const float* w_hh, const float* h0,
               const float* c0, float* gates, float* h_all, float* c_all, int F, int N, int H,
               cudaStream_t stream) {
  void* args[] = {(void*)&x_proj, (void*)&mask,  (void*)&w_hh,  (void*)&h0,
                  (void*)&c0,     (void*)&gates, (void*)&h_all, (void*)&c_all,
                  (void*)&F,      (void*)&N,     (void*)&H};
  return launch_cooperative((const void*)lstm_train_fwd_kernel<U>, U, H, fwd_shared_bytes(U, H),
                            args, stream);
}

template <int U>
int launch_bwd(const float* dh_all, const float* dc_all, const float* gates, const float* c_prev,
               const float* mask, const float* w_hh, float* dgates, float* dh0, float* dc0,
               int F, int N, int H, cudaStream_t stream) {
  void* args[] = {(void*)&dh_all, (void*)&dc_all, (void*)&gates, (void*)&c_prev,
                  (void*)&mask,   (void*)&w_hh,   (void*)&dgates, (void*)&dh0,
                  (void*)&dc0,    (void*)&F,      (void*)&N,      (void*)&H};
  return launch_cooperative((const void*)lstm_train_bwd_kernel<U>, U, H, bwd_shared_bytes(U, H),
                            args, stream);
}

}  // namespace

extern "C" {

// Units per block for hidden size H on this card: the smallest power of two
// that divides H and gives at most one block per SM.  0 if there is none.
int lstm_train_units(int H) {
  int dev = 0, n_sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  for (int U = 1; U <= 8; U *= 2) {
    if (H % U == 0 && H / U <= n_sms) return U;
  }
  return 0;
}

// Forward sweep over all F steps in one cooperative launch on `stream`.
// gates may be null (the undifferentiated primal).  Returns 0, a
// cudaError_t value, or a negative code above.
int lstm_train_forward(const float* x_proj, const float* mask, const float* w_hh,
                       const float* h0, const float* c0, float* gates, float* h_all,
                       float* c_all, int F, int N, int H, void* stream) {
  if (F <= 0 || N <= 0 || H <= 0 || H % 4 != 0) return kErrBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lstm_train_units(H)) {
    case 1: return launch_fwd<1>(x_proj, mask, w_hh, h0, c0, gates, h_all, c_all, F, N, H, s);
    case 2: return launch_fwd<2>(x_proj, mask, w_hh, h0, c0, gates, h_all, c_all, F, N, H, s);
    case 4: return launch_fwd<4>(x_proj, mask, w_hh, h0, c0, gates, h_all, c_all, F, N, H, s);
    case 8: return launch_fwd<8>(x_proj, mask, w_hh, h0, c0, gates, h_all, c_all, F, N, H, s);
    default: return kErrGridTooLarge;
  }
}

// Reverse sweep over all F steps in one cooperative launch on `stream`;
// writes dgates (F, N, 4H) and dh0, dc0 (N, H).  Returns as above.
int lstm_train_backward(const float* dh_all, const float* dc_all, const float* gates,
                        const float* c_prev, const float* mask, const float* w_hh,
                        float* dgates, float* dh0, float* dc0, int F, int N, int H,
                        void* stream) {
  if (F <= 0 || N <= 0 || H <= 0 || H % 4 != 0) return kErrBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lstm_train_units(H)) {
    case 1: return launch_bwd<1>(dh_all, dc_all, gates, c_prev, mask, w_hh, dgates, dh0, dc0, F, N, H, s);
    case 2: return launch_bwd<2>(dh_all, dc_all, gates, c_prev, mask, w_hh, dgates, dh0, dc0, F, N, H, s);
    case 4: return launch_bwd<4>(dh_all, dc_all, gates, c_prev, mask, w_hh, dgates, dh0, dc0, F, N, H, s);
    case 8: return launch_bwd<8>(dh_all, dc_all, gates, c_prev, mask, w_hh, dgates, dh0, dc0, F, N, H, s);
    default: return kErrGridTooLarge;
  }
}

}  // extern "C"
