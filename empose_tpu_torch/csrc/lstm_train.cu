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
//     back into dh0, dc0; frozen steps give zero dgates and pass the
//     cotangents straight through.
// Everything else of the layer's gradient is one large GEMM outside
// (dW_hh = h_prev^T @ dgates, dx_proj = dgates), as in the JAX package.
//
// What bounds them on this card.  Both sweeps are serial in time and need
// all of W_hh (4 MB at H=512) every step.  With W_hh resident the least time
// is the fp32 FMA work, 2*F*N*H*4H operations per sweep (0.032 ms at F=64,
// N=16, H=512); the serial floor is F grid barriers, one per step (1.5-2.8 us
// each on an H100).  W_hh is spread over the SMs: each block owns U
// consecutive hidden units j (U=4 at H=512: 128 blocks, one per SM).
//
// Forward: the block keeps the four gate columns {j, H+j, 2H+j, 3H+j} of its
// units resident (512 x 16 floats = 32 KB at H=512, U=4).  h_all[t-1] is the
// exchange buffer every block reads at step t, in k-tiles through registers
// into shared memory; c stays with the thread that owns (row, unit); each
// thread multiplies 4 rows by 4 columns per k and the k-split partial sums
// meet in shared memory.  One grid barrier per step.
//
// Reverse: the step's product dh_prev = dgates[t] @ W_hh^T needs ROWS of
// W_hh, so the block keeps W_hh[j, 0:4H] of its units resident (32 KB), as
// they lie in memory.  Step t:
//   (A) for its own units the block forms Dh = dh + dh_all[t], Dc = dc +
//       dc_all[t], the four dgates columns and the carries dc = dc_new * f +
//       Dc * (1 - m), dh = Dh * (1 - m), and writes its columns of dgates[t],
//       which is both an output and the step's exchange buffer.  Its
//       operands (dh_all, dc_all, c_prev, the 4U gate columns, mask of step
//       t) were copied into shared memory by cp.async during step t + 1: no
//       device-memory latency is exposed here.  The carries dh, dc live in
//       shared memory for the whole sweep and reach dh0, dc0 once, at the
//       end.  Where these 9U + 1 floats a row would cost the ring of (C) a
//       chunk per step (the plan's choice: N = 100 at H=512, and any N
//       above 121), the operands are read from device memory in (A) and the
//       carries live in the block's columns of dh0, dc0 instead, so the
//       shared memory does not grow with N: any N runs.
//   (B) one grid barrier: every block's columns of dgates[t] are written.
//   (C) dh += dgates[t] @ W_hh[j, :]^T.  The block issues 16-byte cp.async
//       copies of all of dgates[t] (N x 4H, 128 KB at N=16) at once and waits
//       once, so the L2 latency is paid about once per step.  Where N x 4H
//       does not fit beside the resident rows (N > 23 at H=512), a ring of
//       two stages of up to 16 rows keeps the next chunk in flight while the
//       current one's FMAs run.  The launch plan (ops/lstm_train_kernel.py::
//       lstm_train_bwd_plan) sizes the stages.  What a step then costs on an
//       H100 (PERF.md): the barrier, phase (A) and the launch about 4 us, and
//       each pass of up to 16 rows about 2 us more; so the sweep is bound by
//       its serial steps and passes, far above the FMA bound.
// The product's register tile: thread (row group g, k-split s) multiplies
// NR <= 4 rows of its group by the block's U units over the float4 columns
// s, s + S, ... of 4H (neighbouring threads on neighbouring float4: no bank
// conflicts), so every staged value of dgates is read once per block and
// W_hh's rows once per row group.  NR is the number of rows the group really
// has: no FMA or shared load on a row beyond N (a pass covers 4, 8 or 16
// rows as N asks).  The S partial sums of a (row, unit) meet in a fixed order: an
// xor butterfly within the warp, then the warps of the group in order, then
// the carry.  No atomics, so two launches on the same inputs give the same
// bits.
//
// fp32 FMAs on the CUDA cores (the fp32 parity mode).  Reads of buffers
// written by other blocks before the last grid barrier (h_all[t-1],
// dgates[t]) go through L2 (__ldcg, cp.async.cg), never through a stale L1.
// The grid must be co-resident for the barrier: lstm_train_prepare sets the
// kernels' shared memory and checks their occupancy once per device, the
// wrapper keeps the grid within the SMs, and the C entries only launch
// (cudaLaunchCooperativeKernel), so a call does no per-call queries.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // batch rows per thread in the products

// Error codes beside cudaError_t values (which are >= 0); the same values
// as lstm_stack.cu.
constexpr int kErrGridTooLarge = -1;
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
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr size_t round4(size_t x) { return (x + 3) / 4 * 4; }
__host__ __device__ constexpr size_t round32(size_t x) { return (x + 31) / 32 * 32; }

// Shared memory of the reverse sweep (floats), in this order:
//   wt_s  [U][4H], to 128 bytes        the block's rows of W_hh
//   g_s   [stages][stage_rows][4H]     the staged rows of dgates[t], from a
//                                      128-byte boundary (an H100 run with
//                                      them 16 bytes off it was much slower)
//   ops   [3][N][U] + [N][4][U], [N]   the next step's dh_all, dc_all, c_prev,
//                                      gate columns and mask (resident only)
//   car   [2][N][U]                    the carries dh, dc (resident only)
//   red   [kWarps][kRows][U]          the warps' partial sums of a pass
// The same formula as ops/lstm_train_kernel.py::bwd_smem_bytes.
__host__ __device__ constexpr size_t bwd_smem_floats(int U, int N, int H, int stages,
                                                     int stage_rows, bool resident) {
  return round32((size_t)U * 4 * H) + (size_t)stages * stage_rows * 4 * H +
         (resident ? round4((size_t)7 * U * N) + round4((size_t)N) + (size_t)2 * U * N : 0) +
         (size_t)kWarps * kRows * U;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = smem_u32(dst);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start the copies of step s's operands of the block's units into `ops`:
// per row the U floats of dh_all, dc_all and c_prev at j0, the U floats of
// each of the four gates, and the mask.  None depends on the recurrence.
template <int U>
__device__ __forceinline__ void copy_step_operands(float* ops, const float* __restrict__ dh_all,
                                                   const float* __restrict__ dc_all,
                                                   const float* __restrict__ c_prev,
                                                   const float* __restrict__ gates,
                                                   const float* __restrict__ mask, int s, int N,
                                                   int H, int j0, int tid) {
  constexpr int kPiece = U < 4 ? U : 4;  // floats per copy (16 bytes at most)
  constexpr int kPieces = U / kPiece;
  const size_t row0 = (size_t)s * N;
  for (int e = tid; e < N * 7 * kPieces; e += kThreads) {
    const int piece = e % kPieces;
    const int seg = (e / kPieces) % 7;
    const int n = e / (kPieces * 7);
    const float* src;
    float* dst;
    if (seg < 3) {
      const float* base = seg == 0 ? dh_all : seg == 1 ? dc_all : c_prev;
      src = base + (row0 + n) * H + j0;
      dst = ops + (size_t)seg * U * N + n * U;
    } else {
      src = gates + (row0 + n) * 4 * H + (seg - 3) * H + j0;
      dst = ops + (size_t)3 * U * N + (n * 4 + seg - 3) * U;
    }
    cp_async<4 * kPiece>(dst + piece * kPiece, src + piece * kPiece);
  }
  float* m_s = ops + round4((size_t)7 * U * N);
  for (int n = tid; n < N; n += kThreads) cp_async<4>(m_s + n, mask + row0 + n);
}

// One thread's share of a pass: NR rows (`rows`, stride 4H, in shared
// memory) times the block's U resident rows of W_hh over the float4 columns
// s, s + S, ... of 4H; the warp's sums, added by an xor butterfly, go to
// red_w (lane 0).
template <int U, int NR>
__device__ __forceinline__ void pass_tile(const float* rows, const float* wt_s, float* red_w,
                                          int H, int s, int S, int lane) {
  const int H4 = 4 * H;
  float acc[NR][U];
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int u = 0; u < U; ++u) acc[r][u] = 0.0f;
#pragma unroll 2
  for (int c = s; c < H; c += S) {
    float4 g[NR], w[U];
#pragma unroll
    for (int r = 0; r < NR; ++r) g[r] = *reinterpret_cast<const float4*>(rows + r * H4 + 4 * c);
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = *reinterpret_cast<const float4*>(wt_s + u * H4 + 4 * c);
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        acc[r][u] = fmaf(g[r].x, w[u].x, acc[r][u]);
        acc[r][u] = fmaf(g[r].y, w[u].y, acc[r][u]);
        acc[r][u] = fmaf(g[r].z, w[u].z, acc[r][u]);
        acc[r][u] = fmaf(g[r].w, w[u].w, acc[r][u]);
      }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r)
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][u] += __shfl_xor_sync(0xffffffffu, acc[r][u], off);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int u = 0; u < U; ++u) red_w[r * U + u] = acc[r][u];
  }
}

// Threads: row group grp = tid / S of `groups`, k-split s = tid % S with S =
// kThreads / groups (whole warps per group).  A pass covers 4 * groups rows
// of a stage; stages of stage_rows rows each (1 stage: all N rows).
// resident = 1: the step operands are prefetched into shared memory and the
// carries live there; resident = 0: (A) reads the operands of step t from
// device memory and the carries live in the block's columns of dh0, dc0 (only
// this block reads or writes them, ordered by its __syncthreads).
template <int U>
__global__ void __launch_bounds__(kThreads, 1)
lstm_train_bwd_kernel(const float* __restrict__ dh_all,  // (F, N, H)
                      const float* __restrict__ dc_all,  // (F, N, H)
                      const float* __restrict__ gates,   // (F, N, 4H)
                      const float* __restrict__ c_prev,  // (F, N, H): c before step t
                      const float* __restrict__ mask,    // (F, N)
                      const float* __restrict__ w_hh,    // (H, 4H)
                      float* dgates,                     // (F, N, 4H)
                      float* dh0,                        // (N, H)
                      float* dc0,                        // (N, H)
                      int F, int N, int H, int groups, int stage_rows, int stages,
                      int resident) {
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  const int j0 = blockIdx.x * U;
  float* wt_s = smem;
  float* g_s = wt_s + round32((size_t)U * H4);
  float* ops = g_s + (size_t)stages * stage_rows * H4;
  const float* op_dh = ops;
  const float* op_dc = ops + U * N;
  const float* op_cp = ops + 2 * U * N;
  const float* op_g = ops + 3 * U * N;
  const float* m_s = ops + round4((size_t)7 * U * N);
  float* dh_s = ops + round4((size_t)7 * U * N) + round4((size_t)N);
  float* red = resident ? dh_s + 2 * U * N : ops;
  // The carries of (row n, unit u) at n * cs + u.
  float* dh_c = resident ? dh_s : dh0 + j0;
  float* dc_c = resident ? dh_s + U * N : dc0 + j0;
  const int cs = resident ? U : H;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int S = kThreads / groups;
  const int grp = tid / S;
  const int s = tid % S;
  const int wpg = S / 32;  // warps per row group
  const int rows_pass = kRows * groups;
  const int n_chunks = (N + stage_rows - 1) / stage_rows;
  cg::grid_group grid = cg::this_grid();

  for (int i = 4 * tid; i < U * H4; i += 4 * kThreads)
    cp_async<16>(wt_s + i, w_hh + (size_t)j0 * H4 + i);
  if (resident) copy_step_operands<U>(ops, dh_all, dc_all, c_prev, gates, mask, F - 1, N, H, j0, tid);
  cp_async_commit();
  for (int i = tid; i < U * N; i += kThreads) {
    const int c = i / U * cs + i % U;
    dh_c[c] = dc_c[c] = 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int t = F - 1; t >= 0; --t) {
    float* dg_t = dgates + (size_t)t * N * H4;

    // (A) The block's columns of dgates[t] and the carries.
    for (int idx = tid; idx < N * U; idx += kThreads) {
      const int n = idx / U;
      const int u = idx % U;
      const int c = n * cs + u;
      float m, dh_in, dc_in, cp, gi, gf, gg, go;
      if (resident) {
        const float* gp = op_g + n * 4 * U + u;
        m = m_s[n];
        dh_in = op_dh[idx];
        dc_in = op_dc[idx];
        cp = op_cp[idx];
        gi = gp[0];
        gf = gp[U];
        gg = gp[2 * U];
        go = gp[3 * U];
      } else {
        const size_t row = (size_t)t * N + n;
        const float* gp = gates + row * H4 + j0 + u;
        m = __ldg(mask + row);
        dh_in = __ldg(dh_all + row * H + j0 + u);
        dc_in = __ldg(dc_all + row * H + j0 + u);
        cp = __ldg(c_prev + row * H + j0 + u);
        gi = __ldg(gp);
        gf = __ldg(gp + H);
        gg = __ldg(gp + 2 * H);
        go = __ldg(gp + 3 * H);
      }
      const float Dh = dh_c[c] + dh_in;
      const float Dc = dc_c[c] + dc_in;
      const float i_g = sigmoid_f(gi);
      const float f_g = sigmoid_f(gf);
      const float g_g = tanhf(gg);
      const float o_g = sigmoid_f(go);
      const float c_new = f_g * cp + i_g * g_g;
      const float tc = tanhf(c_new);
      const float dh_new = Dh * m;
      const float dc_new = Dc * m + dh_new * o_g * (1.0f - tc * tc);
      float* dgp = dg_t + (size_t)n * H4 + j0 + u;
      dgp[0] = dc_new * g_g * i_g * (1.0f - i_g);
      dgp[H] = dc_new * cp * f_g * (1.0f - f_g);
      dgp[2 * H] = dc_new * i_g * (1.0f - g_g * g_g);
      dgp[3 * H] = dh_new * tc * o_g * (1.0f - o_g);
      dh_c[c] = Dh * (1.0f - m);
      dc_c[c] = dc_new * f_g + Dc * (1.0f - m);
    }

    // (B) Every block's columns of dgates[t] are written (and every thread
    // of this block is done with the step's operands).
    grid.sync();

    // (C) dh += dgates[t] @ W_hh[j0:j0+U, :]^T.  Step t-1's operands go into
    // the first copy group, beside the first chunk of dgates[t].
    if (resident && t > 0)
      copy_step_operands<U>(ops, dh_all, dc_all, c_prev, gates, mask, t - 1, N, H, j0, tid);
    auto issue = [&](int c) {
      const int r0 = c * stage_rows;
      const int cr = min(stage_rows, N - r0);
      float* dst = g_s + (size_t)(c % stages) * stage_rows * H4;
      const float* src = dg_t + (size_t)r0 * H4;
      for (int i = 4 * tid; i < cr * H4; i += 4 * kThreads) cp_async<16>(dst + i, src + i);
      cp_async_commit();
    };
    for (int c = 0; c < min(stages, n_chunks); ++c) issue(c);
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks && stages > 1)
        cp_async_wait<1>();  // chunk c has landed; chunk c + 1 stays in flight
      else
        cp_async_wait<0>();
      __syncthreads();
      const int r0 = c * stage_rows;
      const int cr = min(stage_rows, N - r0);
      const float* st = g_s + (size_t)(c % stages) * stage_rows * H4;
      for (int p0 = 0; p0 < cr; p0 += rows_pass) {
        const int lr0 = p0 + kRows * grp;
        const float* rows = st + (size_t)lr0 * H4;
        float* red_w = red + (tid / 32) * kRows * U;
        switch (min(kRows, cr - lr0)) {
          case 4: pass_tile<U, 4>(rows, wt_s, red_w, H, s, S, lane); break;
          case 3: pass_tile<U, 3>(rows, wt_s, red_w, H, s, S, lane); break;
          case 2: pass_tile<U, 2>(rows, wt_s, red_w, H, s, S, lane); break;
          case 1: pass_tile<U, 1>(rows, wt_s, red_w, H, s, S, lane); break;
          default: break;  // the group has no row in this pass
        }
        __syncthreads();
        for (int idx = tid; idx < min(rows_pass, cr - p0) * U; idx += kThreads) {
          const int lr = idx / U;
          const int u = idx % U;
          const float* part = red + ((size_t)(lr / kRows) * wpg * kRows + lr % kRows) * U + u;
          float sum = 0.0f;
          for (int w = 0; w < wpg; ++w) sum += part[(size_t)w * kRows * U];
          dh_c[(r0 + p0 + lr) * cs + u] += sum;
        }
        __syncthreads();  // red is written again by the next pass
      }
      if (c + stages < n_chunks) issue(c + stages);  // stage c % stages is free here
    }
  }

  if (resident) {
    for (int idx = tid; idx < N * U; idx += kThreads) {
      const size_t off = (size_t)(idx / U) * H + j0 + idx % U;
      dh0[off] = dh_c[idx];
      dc0[off] = dc_c[idx];
    }
  }
}

size_t fwd_shared_bytes(int U, int H) {
  const int rg = kThreads / U;
  return sizeof(float) * ((size_t)H * U * 4 + (size_t)rg * (fwd_tile_k(U) + 4) +
                          (size_t)kSplitF * rg * U * 4);
}

// Lets `kernel` use up to max_smem bytes of dynamic shared memory and checks
// that an SM holds one block of it with that much.
cudaError_t prepare_kernel(const void* kernel, int max_smem, bool* fits) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         max_smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, max_smem);
  if (per_sm < 1) *fits = false;
  return err;
}

template <int U>
cudaError_t prepare_units(int max_smem, bool* fits) {
  cudaError_t err = prepare_kernel((const void*)lstm_train_fwd_kernel<U>, max_smem, fits);
  if (err == cudaSuccess) err = prepare_kernel((const void*)lstm_train_bwd_kernel<U>, max_smem, fits);
  return err;
}

int launch(const void* kernel, int blocks, size_t smem, void** args, cudaStream_t stream) {
  const cudaError_t err =
      cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <int U>
int launch_fwd(const float* x_proj, const float* mask, const float* w_hh, const float* h0,
               const float* c0, float* gates, float* h_all, float* c_all, int F, int N, int H,
               cudaStream_t stream) {
  void* args[] = {(void*)&x_proj, (void*)&mask,  (void*)&w_hh,  (void*)&h0,
                  (void*)&c0,     (void*)&gates, (void*)&h_all, (void*)&c_all,
                  (void*)&F,      (void*)&N,     (void*)&H};
  return launch((const void*)lstm_train_fwd_kernel<U>, H / U, fwd_shared_bytes(U, H), args, stream);
}

template <int U>
int launch_bwd(const float* dh_all, const float* dc_all, const float* gates, const float* c_prev,
               const float* mask, const float* w_hh, float* dgates, float* dh0, float* dc0,
               int F, int N, int H, int groups, int stage_rows, int stages, int resident,
               cudaStream_t stream) {
  void* args[] = {(void*)&dh_all, (void*)&dc_all, (void*)&gates,  (void*)&c_prev,
                  (void*)&mask,   (void*)&w_hh,   (void*)&dgates, (void*)&dh0,
                  (void*)&dc0,    (void*)&F,      (void*)&N,      (void*)&H,
                  (void*)&groups, (void*)&stage_rows, (void*)&stages, (void*)&resident};
  const size_t smem = sizeof(float) * bwd_smem_floats(U, N, H, stages, stage_rows, resident);
  return launch((const void*)lstm_train_bwd_kernel<U>, H / U, smem, args, stream);
}

}  // namespace

extern "C" {

// Once per device, before the first launch there (and outside any CUDA graph
// capture): checks that the card launches cooperative grids, lets every
// instance of both sweeps use the card's opt-in shared memory per block, and
// checks that an SM holds one block of each with that much.  Writes the SM
// count and the opt-in limit in bytes to info[0], info[1].  Returns 0, a
// cudaError_t value, or a negative code above.
int lstm_train_prepare(int device, int* info) {
  int prev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&info[0], cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&info[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  bool fits = true;
  if (err == cudaSuccess) err = prepare_units<1>(info[1], &fits);
  if (err == cudaSuccess) err = prepare_units<2>(info[1], &fits);
  if (err == cudaSuccess) err = prepare_units<4>(info[1], &fits);
  if (err == cudaSuccess) err = prepare_units<8>(info[1], &fits);
  cudaSetDevice(prev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return kErrNoCooperative;
  return fits ? 0 : kErrGridTooLarge;
}

// Forward sweep over all F steps in one cooperative launch of H / units
// blocks on `stream`.  gates may be null (the undifferentiated primal).
// Launches only: lstm_train_prepare must have run on the current device.
// Returns 0, a cudaError_t value, or a negative code above.
int lstm_train_forward(const float* x_proj, const float* mask, const float* w_hh,
                       const float* h0, const float* c0, float* gates, float* h_all,
                       float* c_all, int F, int N, int H, int units, void* stream) {
  if (F <= 0 || N <= 0 || H <= 0 || H % 4 != 0 || H % units != 0) return kErrBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (units) {
    case 1: return launch_fwd<1>(x_proj, mask, w_hh, h0, c0, gates, h_all, c_all, F, N, H, s);
    case 2: return launch_fwd<2>(x_proj, mask, w_hh, h0, c0, gates, h_all, c_all, F, N, H, s);
    case 4: return launch_fwd<4>(x_proj, mask, w_hh, h0, c0, gates, h_all, c_all, F, N, H, s);
    case 8: return launch_fwd<8>(x_proj, mask, w_hh, h0, c0, gates, h_all, c_all, F, N, H, s);
    default: return kErrBadShape;
  }
}

// Reverse sweep over all F steps in one cooperative launch on `stream`;
// writes dgates (F, N, 4H) and dh0, dc0 (N, H).  units, groups, stage_rows,
// stages, resident (1: step operands and carries in shared memory) and
// smem_bytes are the launch plan's; smem_bytes must equal the layout's size.
// Launches only, as above.  Returns as above.
int lstm_train_backward(const float* dh_all, const float* dc_all, const float* gates,
                        const float* c_prev, const float* mask, const float* w_hh,
                        float* dgates, float* dh0, float* dc0, int F, int N, int H, int units,
                        int groups, int stage_rows, int stages, int resident, int smem_bytes,
                        void* stream) {
  if (F <= 0 || N <= 0 || H <= 0 || H % 4 != 0 || H % units != 0 || stage_rows <= 0 ||
      stages < 1 || stages > 2 || (groups != 1 && groups != 2 && groups != 4) ||
      (resident != 0 && resident != 1) ||
      (size_t)smem_bytes !=
          sizeof(float) * bwd_smem_floats(units, N, H, stages, stage_rows, resident))
    return kErrBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LSTM_TRAIN_BWD(U)                                                                        \
  launch_bwd<U>(dh_all, dc_all, gates, c_prev, mask, w_hh, dgates, dh0, dc0, F, N, H, groups, \
                stage_rows, stages, resident, s)
  switch (units) {
    case 1: return LSTM_TRAIN_BWD(1);
    case 2: return LSTM_TRAIN_BWD(2);
    case 4: return LSTM_TRAIN_BWD(4);
    case 8: return LSTM_TRAIN_BWD(8);
    default: return kErrBadShape;
  }
#undef LSTM_TRAIN_BWD
}

}  // extern "C"
