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
// all of W_hh (4 MB at H=512) every step.  W_hh is spread over the SMs: each
// block owns U consecutive hidden units j (U=4 at H=512: 128 blocks, one per
// SM) and keeps its part resident in shared memory (32 KB).  A sweep is then
// bound by three things:
//   * the fp32 FMA work, 2*F*N*H*4H operations (0.032 ms at F=64, N=16,
//     H=512: about 0.5 us per step);
//   * F grid barriers, one per step (1.5-2.8 us each on an H100);
//   * the step's exchange buffer, which every block writes just before the
//     barrier and reads in full just after it, so it cannot be prefetched:
//     h_all[t-1] in the forward sweep, N*H*4 bytes per block and step (32 KB
//     at N=16, 128 KB at N=64), dgates[t] in the reverse sweep, N*4H*4
//     bytes, each from L2.
//
// Forward.  The block keeps the four gate columns {j, H+j, 2H+j, 3H+j} of
// its units resident, laid out so that neighbouring threads read
// neighbouring float4 (no bank conflicts).  Step t:
//   * Staging.  The block issues 16-byte cp.async.cg copies of all of
//     h_all[t-1] at once, one copy group per chunk of 16 rows, on a 128-byte
//     boundary; the pass over chunk c waits only for chunk c's group, so its
//     FMAs run while the later chunks land, and the L2 latency is paid about
//     once per step.  Where the N rows do not fit beside the resident columns
//     (N > 97 at H=512), the chunks cycle through a ring of up to 8 slots of
//     16 rows, the next chunks in flight while the current one's FMAs run.
//     Where only one slot fits (H=1024, N > 24), a chunk is copied only once
//     every thread is done with the one before, so nothing overlaps there.
//     The launch plan (ops/lstm_train_kernel.py::lstm_train_fwd_plan) sizes
//     it.
//   * FMAs.  Warp (unit pair, row group) multiplies its rows of the chunk
//     by the eight gate columns of its two units, lane l over the float4
//     columns l, l + 32, ... of H, with W_hh of the first four of them held
//     in registers for the whole sweep: a staged h value is read from shared
//     memory once per unit pair and W_hh not at all (at H <= 512).  A piece
//     covers the rows the warp has (4, 2 and 1-row register tiles as N
//     asks): no FMA and no shared load falls on a row beyond N.  The warp's
//     partial sums meet in a fixed order, a butterfly in which a lane hands
//     half of the values it still holds to its partner at each stage (31
//     shuffles for 4 rows x 2 units x 4 gates), which leaves each lane with
//     the whole sum of one (row, unit, gate).  No atomics and no shared
//     memory: two launches on the same inputs give the same bits, and a
//     chunk needs one __syncthreads.
//   * Epilogue and carries, in the warp.  Each lane adds x_proj's column to
//     its sum and applies its gate's nonlinearity; the first lane of each
//     (row, unit) gathers the four gates by shuffles and writes h_all[t] and
//     c_all[t] (each gate's lane writes gates[t]).  Each lane reads its
//     step operands (x_proj[t]'s gate column, mask[t], the carry c from the
//     block's own columns of c_all[t-1]) from device memory before its FMAs,
//     which hide their latency (an H100 run that prefetched them into shared
//     memory a step ahead and kept c there was no faster at N=16 or N=64);
//     the old h that a masked row keeps is read from the staged row.  So the
//     shared memory does not grow with N beyond the staged rows, and any N
//     runs.
//   * One grid barrier per step, none after the last.
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
// That is the HIGHEST instance of each sweep (template argument P =
// kHighest, lstm_common.cuh): fp32 FMAs on the CUDA cores (the fp32 parity
// mode).  Reads of buffers written by other blocks before the last grid
// barrier (h_all[t-1], dgates[t]) go through L2 (cp.async.cg, __ldcg), never
// through a stale L1.
//
// HIGH and DEFAULT (P = kHigh, kDefault): the step's product runs on the
// tensor cores, mma.sync m16n8k16 bf16 with f32 sums, with W_hh rounded to
// bf16 (DEFAULT) or split into a bf16 hi/lo pair (HIGH) once by the wrapper,
// as JAX splits it outside its kernels; at HIGH each product is ah*bh +
// al*bh + ah*bl (JAX's dot3).  The gate nonlinearities, the cell, the frozen
// steps and every output stay f32, as at HIGHEST.  The grid is HIGHEST's,
// with U >= 2 (an n8 tile holds two units' four gates).
//   * Forward: the design of the bidirectional layer's mode body
//     (csrc/lstm_bidi.cu mma_body, one direction).  The block's 4U gate
//     columns of W_hh stay resident as B fragments (a unit's gates in one
//     lane quad).  Every block needs all of h_all[t-1] each step, so its
//     bf16 form (hi; hi and lo at HIGH) is made once, by the thread that
//     writes the f32 value, into a two-slot exchange buffer laid out as the
//     A operand's k-step tiles, not by each of the 128 blocks for the whole
//     state.  After the barrier one thread streams the step's
//     16-row chunks into a ring of shared-memory slots by bulk copies on
//     mbarriers, and the warps multiply each chunk as it lands, over 8
//     disjoint k-step sets; where a step has two chunks or more and the ring
//     two slots, two teams of 4 warps take them in turns, one team's
//     epilogue beside the other's products.  The sets' partial tiles meet in
//     shared memory, summed in set order by one thread per (row, unit),
//     which adds x_proj, keeps the gates and runs the cell; it reads its
//     cell operands a chunk ahead.  The details: fwd_mma.
//   * Reverse: dh += dgates[t] (N x 4H) @ W_hh[j0:j0+U, :]^T, with K = 4H and
//     only U outputs per row.  The A operand is 16 rows of dgates[t] in bf16
//     (k contiguous, so ldmatrix reads them as the forward reads h), and the
//     B operand is one n8 tile whose column n is W_hh's row j0 + n (n < U;
//     zero beyond): the pairs (k, k + 1) a B fragment holds lie next to each
//     other in that row, and the N x U result is half of one tile at U=4.
//     With W's rows as A instead, M = U would pad to 16 (3/4 of each tile
//     wasted at U=4) and dgates would need a transposed fragment load.
//     Every block needs all of dgates[t] each step, so the bf16 form is made
//     once, by the block that owns the columns, in phase (A): it writes them
//     into a two-slot exchange buffer laid out as the A operand's tiles, and
//     after the barrier each block streams the step's 16-row chunks, in
//     k-slices of k_cols columns (all 4H where two fit, as at H=512
//     DEFAULT), through a ring of shared-memory stages by bulk copies (the
//     Tensor Memory Accelerator) on mbarriers, so the warps multiply as the
//     bytes land and never issue copies themselves.  Phase (A)
//     reads its step operands from shared memory where they fit beside the
//     ring (prefetched during the step before), as HIGHEST does.  The
//     details: bwd_mma.
// No atomics at any mode: two launches on the same inputs give the same
// bits.
// The grid must be co-resident for the barrier: lstm_train_prepare sets the
// kernels' shared memory and checks their occupancy once per device, the
// wrapper keeps the grid within the SMs, and the C entries only launch
// (cudaLaunchCooperativeKernel), so a call does no per-call queries.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using lstm::bulk_copy;
using lstm::component;
using lstm::cp_async;
using lstm::cp_async_commit;
using lstm::cp_async_wait;
using lstm::cp_async_wait_upto;
using lstm::exchange_index;
using lstm::fence_mbarrier_init;
using lstm::fence_proxy_async_global;
using lstm::kDefault;
using lstm::kHigh;
using lstm::kHighest;
using lstm::kMaxStages;
using lstm::kMmaRows;
using lstm::kParts;
using lstm::kRingSyncBytes;
using lstm::kTile;
using lstm::mbar_arrive;
using lstm::mbar_expect_tx;
using lstm::mbar_init;
using lstm::mbar_wait;
using lstm::mma_ktile;
using lstm::put_state;
using lstm::round32;
using lstm::sigmoid_f;
using lstm::store_release;
using lstm::tile_offset;
using lstm::wait_issued;
using lstm::warp_reduce_scatter;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // batch rows per thread in the reverse sweep's product

// Error codes beside cudaError_t values (which are >= 0); the same values
// as lstm_stack.cu.
constexpr int kErrGridTooLarge = -1;
constexpr int kErrNoCooperative = -3;
constexpr int kErrBadShape = -4;

__host__ __device__ constexpr size_t round4(size_t x) { return (x + 3) / 4 * 4; }

// ---------------------------------------------------------------------------
// Forward sweep.
constexpr int kPassRows = 16;  // rows of h_all[t-1] per staged chunk
constexpr int kRegCols = 4;    // float4 columns per lane whose W_hh lives in registers

// Shared memory of the forward sweep (floats), in this order:
//   w_s  [4][U][H], to 128 bytes    the block's gate columns of W_hh: the
//                                   float4 of unit u's four gates at row
//                                   k = 4c + q sits at (q * U + u) * H + 4c
//   h_s  [stage_rows][H]            the staged rows of h_all[t-1], from a
//                                   128-byte boundary: all N, or a ring of
//                                   stage_rows / 16 chunk slots
// The same formula as ops/lstm_train_kernel.py::fwd_smem_bytes.
__host__ __device__ constexpr size_t fwd_smem_floats(int U, int H, int stage_rows) {
  return round32((size_t)4 * U * H) + (size_t)stage_rows * H;
}

// What the pieces of a forward step share.
struct FwdStep {
  const float* x_proj;
  const float* mask;
  const float* c_prev;  // c_all[t-1] or c0
  float* gates;         // null: the gates are not kept
  float* h_next;        // h_all[t]
  float* c_next;        // c_all[t]
  int t, N, H, j0;
};

// Units a forward warp multiplies at once: a staged h value read from
// shared memory serves both units' FMAs.
template <int U>
__host__ __device__ constexpr int fwd_pair() { return U < 2 ? U : 2; }

// One warp's piece of a step: NP staged rows (`rows`, stride H; global rows
// n0 ...) times the four gate columns of its UP units u0, u0 + 1.  Lane l
// multiplies the float4 columns l, l + 32, ... of H (W_hh of the first
// kRegCols of them in registers).  The warp's 4 UP NP <= 32 sums are
// scattered so that lane l holds the sum of value l / kC (kC = 32 / (4 UP
// NP)), value (row r, unit ui, gate g) being (r UP + ui) 4 + g; each such lane
// adds x_proj's column and applies its gate's nonlinearity, and the first
// lane of each (row, unit) gathers the four gates and writes its h and c.
template <int U, int NP>
__device__ __forceinline__ void fwd_piece(const FwdStep& p, const float* rows, int n0,
                                          const float4 (&wreg)[fwd_pair<U>()][kRegCols][4],
                                          const float* w_s, int u0, int lane) {
  constexpr int UP = fwd_pair<U>();
  constexpr int V = 4 * UP * NP;
  constexpr int kC = 32 / V;  // lanes holding the same sum
  static_assert(V <= 32, "a piece holds at most 32 sums");
  const int C4 = p.H / 4;
  const int idx = lane / kC;
  const int g = idx % 4;
  const int u = u0 + idx / 4 % UP;
  const int r_own = idx / (4 * UP);
  const int n = n0 + r_own;
  const int j = p.j0 + u;
  const bool lead = lane % (4 * kC) == 0;

  // The epilogue's operands, read before the FMAs so that their latency
  // hides behind them; the old h of a masked row is its staged row.
  const float x = __ldg(p.x_proj + ((size_t)p.t * p.N + n) * 4 * p.H + g * p.H + j);
  float m = 0.0f, c_old = 0.0f, h_old = 0.0f;
  if (lead) {
    h_old = rows[(size_t)r_own * p.H + j];
    m = __ldg(p.mask + (size_t)p.t * p.N + n);
    c_old = p.c_prev[(size_t)n * p.H + j];
  }

  const float4* r4 = reinterpret_cast<const float4*>(rows);
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  auto fma_rows = [&](const float4(&w)[UP][4], int c) {
#pragma unroll
    for (int r = 0; r < NP; ++r) {
      const float4 h = r4[r * C4 + c];
#pragma unroll
      for (int ui = 0; ui < UP; ++ui)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float a = component(h, q);
          float* out = acc + (r * UP + ui) * 4;
          out[0] = fmaf(a, w[ui][q].x, out[0]);
          out[1] = fmaf(a, w[ui][q].y, out[1]);
          out[2] = fmaf(a, w[ui][q].z, out[2]);
          out[3] = fmaf(a, w[ui][q].w, out[3]);
        }
    }
  };
#pragma unroll
  for (int i = 0; i < kRegCols; ++i) {
    if (lane + 32 * i < C4) {
      float4 w[UP][4];
#pragma unroll
      for (int ui = 0; ui < UP; ++ui)
#pragma unroll
        for (int q = 0; q < 4; ++q) w[ui][q] = wreg[ui][i][q];
      fma_rows(w, lane + 32 * i);
    }
  }
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  for (int c = lane + 32 * kRegCols; c < C4; c += 32) {
    float4 w[UP][4];
#pragma unroll
    for (int ui = 0; ui < UP; ++ui)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[ui][q] = w4[(q * U + u0 + ui) * C4 + c];
    fma_rows(w, c);
  }
  warp_reduce_scatter<V, 16>(acc, lane);

  const float pre = x + acc[0];
  const float act = g == 2 ? tanhf(pre) : sigmoid_f(pre);
  const int base = lane / (4 * kC) * (4 * kC);
  const float i_g = __shfl_sync(0xffffffffu, act, base);
  const float f_g = __shfl_sync(0xffffffffu, act, base + kC);
  const float g_g = __shfl_sync(0xffffffffu, act, base + 2 * kC);
  const float o_g = __shfl_sync(0xffffffffu, act, base + 3 * kC);
  if (p.gates != nullptr && lane % kC == 0)
    p.gates[((size_t)p.t * p.N + n) * 4 * p.H + g * p.H + j] = pre;
  if (lead) {
    const float c_new = f_g * c_old + i_g * g_g;
    const float h_new = o_g * tanhf(c_new);
    p.h_next[(size_t)n * p.H + j] = m > 0.0f ? h_new : h_old;
    p.c_next[(size_t)n * p.H + j] = m > 0.0f ? c_new : c_old;
  }
}

// Warps: unit pair warp % (U / UP) (units u0, u0 + 1; UP = 1 where U = 1),
// row group warp / (U / UP); the rows of a 16-row chunk are split over the
// row groups and each warp does its rows in pieces of at most 8 / UP.  Chunk c lies in slot c % slots of
// h_s (slots = stage_rows / 16 rounded up; all chunks where stage_rows ==
// N).  The pieces read x_proj's gate columns and the mask of step t and the
// carry c from device memory (c from the block's own columns of c_all[t-1],
// written by the same lane a step before).
template <int U>
__device__ __forceinline__ void fwd_fp32(const float* __restrict__ x_proj,
                                         const float* __restrict__ mask,
                                         const float* __restrict__ w_hh,
                                         const float* __restrict__ h0,
                                         const float* __restrict__ c0,
                                         float* __restrict__ gates, float* h_all, float* c_all,
                                         int F, int N, int H, int stage_rows, float* smem) {
  constexpr int UP = fwd_pair<U>();
  constexpr int kRowsW = kPassRows * U / UP / kWarps;  // rows of a chunk per warp
  constexpr int kMaxNP = 8 / UP;                        // rows of a piece at most
  static_assert(kWarps % (U / UP) == 0, "whole row groups of warps");
  const int j0 = blockIdx.x * U;
  const size_t NH = (size_t)N * H;
  float* w_s = smem;
  float* h_s = w_s + round32((size_t)4 * U * H);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int u0 = warp % (U / UP) * UP;
  const int row_lo = warp / (U / UP) * kRowsW;
  const int C4 = H / 4;
  const int n_chunks = (N + kPassRows - 1) / kPassRows;
  const int slots = (stage_rows + kPassRows - 1) / kPassRows;
  const int first = min(slots, n_chunks);  // chunks issued at the start of a step
  cg::grid_group grid = cg::this_grid();

  for (int idx = tid; idx < 4 * U * H; idx += kThreads) {
    const int qu = idx / H;
    const int k = (idx % H) / 4 * 4 + qu / U;
    w_s[idx] = w_hh[(size_t)k * 4 * H + (idx % 4) * H + j0 + qu % U];
  }
  __syncthreads();
  float4 wreg[UP][kRegCols][4];
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
#pragma unroll
  for (int ui = 0; ui < UP; ++ui)
#pragma unroll
    for (int i = 0; i < kRegCols; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wreg[ui][i][q] = lane + 32 * i < C4 ? w4[(q * U + u0 + ui) * C4 + lane + 32 * i]
                                            : make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < F; ++t) {
    const float* h_prev = t == 0 ? h0 : h_all + (size_t)(t - 1) * NH;
    FwdStep p;
    p.x_proj = x_proj;
    p.mask = mask;
    p.c_prev = t == 0 ? c0 : c_all + (size_t)(t - 1) * NH;
    p.gates = gates;
    p.h_next = h_all + (size_t)t * NH;
    p.c_next = c_all + (size_t)t * NH;
    p.t = t;
    p.N = N;
    p.H = H;
    p.j0 = j0;

    // Every chunk that has a slot, one copy group each.
    auto issue = [&](int c) {
      const int r0 = c * kPassRows;
      const int cr = min(kPassRows, N - r0);
      float* dst = h_s + (size_t)(c % slots) * kPassRows * H;
      const float* src = h_prev + (size_t)r0 * H;
      for (int i = 4 * tid; i < cr * H; i += 4 * kThreads) cp_async<16>(dst + i, src + i);
      cp_async_commit();
    };
    for (int c = 0; c < first; ++c) issue(c);
    int groups = first;

    for (int c = 0; c < n_chunks; ++c) {
      if (slots == 1 && c > 0) {  // a one-slot ring: chunk c goes where chunk c - 1 was read
        __syncthreads();          // every thread is done with chunk c - 1
        issue(c);
        ++groups;
      }
      cp_async_wait_upto(groups - c - 1);  // chunk c has landed
      __syncthreads();  // ... for every thread, and every thread is done with chunk c - 1
      if (slots > 1 && c > 0 && c - 1 + slots < n_chunks) {
        issue(c - 1 + slots);  // into chunk c - 1's slot, while chunk c is read
        ++groups;
      }
      const int r0 = c * kPassRows;
      const float* st = h_s + (size_t)(c % slots) * kPassRows * H;
      int lo = row_lo;
      int nr = max(0, min(kRowsW, N - r0 - lo));
      for (; nr >= kMaxNP; nr -= kMaxNP, lo += kMaxNP)
        fwd_piece<U, kMaxNP>(p, st + (size_t)lo * H, r0 + lo, wreg, w_s, u0, lane);
      if constexpr (kMaxNP > 4) {
        if (nr & 4) {
          fwd_piece<U, 4>(p, st + (size_t)lo * H, r0 + lo, wreg, w_s, u0, lane);
          lo += 4;
        }
      }
      if (nr & 2) {
        fwd_piece<U, 2>(p, st + (size_t)lo * H, r0 + lo, wreg, w_s, u0, lane);
        lo += 2;
      }
      if (nr & 1) fwd_piece<U, 1>(p, st + (size_t)lo * H, r0 + lo, wreg, w_s, u0, lane);
    }

    if (t + 1 < F) grid.sync();  // every block's rows of h_all[t] are written
  }
}

// Shared memory of the forward sweep at HIGH and DEFAULT (bytes), in this
// order: the B fragments of the block's gate columns of W_hh (`parts`
// planes); a ring of `stages` slots, each one 16-row chunk of h_all[t-1] in
// bf16 k-step tiles (`parts` planes); the ring's mbarriers and the count of
// its chunks issued (kRingSyncBytes); a buffer of the partial tiles for each
// of `teams` teams.  The same formula as
// ops/lstm_train_kernel.py::fwd_smem_bytes.
__host__ __device__ constexpr size_t fwd_mma_smem_bytes(int U, int H, int parts, int stages,
                                                        int teams) {
  return lstm::mma_matrix_bytes(U, H, parts) +
         (size_t)stages * parts * lstm::kpad16(H) * kMmaRows * 2 + kRingSyncBytes +
         (size_t)teams * lstm::mma_partial_bytes(U);
}

// What the steps of the forward sweep's HIGH and DEFAULT body share: the
// operands at the block's units j0 .., the exchange, and the block's shared
// memory (fwd_mma).
struct FwdSweep {
  const float* x_proj;  // (F, N, 4H)
  const float* mask;    // (F, N)
  const float* h0;      // (N, H)
  const float* c0;      // (N, H)
  float* gates;         // (F, N, 4H), or null: the gates are not kept
  float* h_all;         // (F, N, H)
  float* c_all;         // (F, N, H)
  unsigned short* xbuf;  // the exchange's two slots (slot stride kP x_part)
  int F, N, H, j0, KS, n_chunks, stages;
  size_t plane;   // bf16 of one part of a chunk
  size_t x_part;  // bf16 of one part of a state
  const uint2* w_b;                  // the B fragments
  __nv_bfloat16* ring;               // the ring's slots
  unsigned long long *full, *empty;  // the ring's mbarriers
  unsigned* issued;                  // the chunks issued in the launch (thread 0 writes)
  float* part;                       // a buffer of partial tiles per team
};

// The cell operands of a thread's (row, unit) of a chunk: x_proj's four
// gate columns, the mask, the carried c and h before the step.
struct CellOps {
  float x[4], m, c, h;
};

// The steps of the forward sweep's HIGH and DEFAULT body (see fwd_mma) with
// TEAMS teams of 8 / TEAMS warps, team g taking the chunks g, g + TEAMS, ...
// of every step.  With two teams and an odd slot count under the step's
// chunks (H=512 at HIGH from N=81: 5 slots), a warp other than thread 0's
// waits until its chunk is issued before its wait on the slot's full
// mbarrier (`count`, lstm_common.cuh), as the bidirectional layer's ring
// does (lstm_bidi.cu mma_steps says why only there).
template <int U, int P, int TEAMS>
__device__ __forceinline__ void fwd_steps(const FwdSweep& s, int tid) {
  constexpr int C = 4 * U;      // the block's gate columns
  constexpr int NT = U / 2;     // their n8 tiles
  constexpr int kP = kParts<P>;
  constexpr int kPart = lstm::mma_partial_bytes(U) / sizeof(float);
  constexpr int kTeamWarps = kWarps / TEAMS;
  constexpr int kTeamThreads = kThreads / TEAMS;
  static_assert(kWarps == lstm::kMmaWarps, "one k-step set per warp, two per warp of a team of 4");
  static_assert(kMmaRows * U <= kTeamThreads, "a thread per (row, unit) of a chunk");
  const int lane = tid % 32, warp = tid / 32;
  const int team = warp / kTeamWarps, tw = warp % kTeamWarps, ttid = tid % kTeamThreads;
  // Epilogue thread ttid < 16 U: row r = ttid / U, unit u = ttid % U.
  const bool cell = ttid < kMmaRows * U;
  const int r = ttid / U, u = ttid % U, j = s.j0 + u;
  const int N = s.N, H = s.H, KS = s.KS, n_chunks = s.n_chunks, stages = s.stages;
  const bool count = TEAMS > 1 && stages % 2 == 1 && stages < n_chunks;  // see above
  const size_t NH = (size_t)N * H;
  const unsigned chunk_bytes = (unsigned)s.plane * 2;
  cg::grid_group grid = cg::this_grid();
  // The team's threads meet (named barrier 1 + team; one team: the block).
  auto team_sync = [&]() {
    if constexpr (TEAMS == 1)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "n"(kTeamThreads) : "memory");
  };
  // Chunk c's cell operands at step t into o (row c 16 + r, unit u); c and h
  // before step t are h0, c0 or what this thread wrote at step t - 1.
  auto load = [&](CellOps& o, int t, int c) {
    const int n = c * kMmaRows + r;
    o.x[0] = o.x[1] = o.x[2] = o.x[3] = o.m = o.c = o.h = 0.0f;
    if (cell && n < N) {
      const float* x_n = s.x_proj + ((size_t)t * N + n) * 4 * H + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) o.x[q] = __ldg(x_n + q * H);
      const size_t o_ = (size_t)n * H + j;
      o.m = __ldg(s.mask + (size_t)t * N + n);
      o.c = t == 0 ? s.c0[o_] : s.c_all[(size_t)(t - 1) * NH + o_];
      o.h = t == 0 ? s.h0[o_] : s.h_all[(size_t)(t - 1) * NH + o_];
    }
  };
  CellOps cur, nxt;
  load(nxt, 0, team);

  for (int t = 0; t < s.F; ++t) {
    const unsigned short* x_read = s.xbuf + (size_t)(t & 1) * kP * s.x_part;
    unsigned short* x_write = s.xbuf + (size_t)((t + 1) & 1) * kP * s.x_part;
    float* g_t = s.gates == nullptr ? nullptr : s.gates + (size_t)t * N * 4 * H;
    float* h_t = s.h_all + (size_t)t * NH;
    float* c_t = s.c_all + (size_t)t * NH;
    const int base = t * n_chunks;  // chunks of the sweep before this step's
    // Chunk c into its slot: one bulk copy a part, issued by thread 0 once
    // the warps are done with the slot's previous chunk.
    auto issue = [&](int c) {
      const int slot = (base + c) % stages, use = (base + c) / stages;
      if (use > 0) mbar_wait(s.empty + slot, (use - 1) & 1);
      mbar_expect_tx(s.full + slot, kP * chunk_bytes);
#pragma unroll
      for (int p = 0; p < kP; ++p)
        bulk_copy(s.ring + ((size_t)slot * kP + p) * s.plane, x_read + p * s.x_part + c * s.plane,
                  chunk_bytes, s.full + slot);
      if (count) store_release(s.issued, base + c + 1);
    };
    int issued = 0;  // thread 0: the step's chunks issued
    if (tid == 0) {
      fence_proxy_async_global();
      for (; issued < min(stages, n_chunks); ++issued) issue(issued);
    }
    for (int c = team; c < n_chunks; c += TEAMS) {
      cur = nxt;
      if (c + TEAMS < n_chunks) load(nxt, t, c + TEAMS);
      const int slot = (base + c) % stages;
      if (count && warp > 0) wait_issued(s.issued, base + c, lane);
      mbar_wait(s.full + slot, ((base + c) / stages) & 1);  // chunk c has landed
      __syncwarp();  // the warp's lanes together again
      // The k-step sets tw (and tw + 4 in a team of 4 warps).
      float acc[TEAMS][NT][4];
#pragma unroll
      for (int v = 0; v < TEAMS; ++v)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          acc[v][nt][0] = acc[v][nt][1] = acc[v][nt][2] = acc[v][nt][3] = 0.f;
      const __nv_bfloat16* a = s.ring + (size_t)slot * kP * s.plane;
      for (int ks = tw; ks < KS; ks += lstm::kMmaWarps) {
#pragma unroll
        for (int v = 0; v < TEAMS; ++v) {
          const int k = ks + v * kTeamWarps;
          if (k < KS)
            mma_ktile<NT, P>(acc[v], a + (size_t)k * kTile, s.plane, s.w_b + (size_t)k * NT * 32,
                             (size_t)KS * NT * 32, lane);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(s.empty + slot);  // this warp is done with the slot
      if (tid == 0)  // every chunk whose slot's previous chunk is this one or older
        for (; issued < min(n_chunks, c + stages + 1); ++issued) issue(issued);
      // The team's buffer, once the team's epilogue of its chunk before is
      // done (with one team, the last chunk of a step is followed by the
      // grid barrier).
      float* pb = s.part + team * kPart;
      if (TEAMS > 1 || c > 0) team_sync();
#pragma unroll
      for (int v = 0; v < TEAMS; ++v)
        lstm::store_partials<U>(pb, acc[v], tw + v * kTeamWarps, lane);
      team_sync();  // the chunk's partial tiles are stored

      // Thread (r, u): its four gates' sums in set order, x_proj, the gates
      // kept, the nonlinearities and the cell; h[t] in f32 and, for the
      // next step's product, in bf16 into the exchange.
      const int n = c * kMmaRows + r;
      if (cell && n < N) {
        float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int w = 0; w < lstm::kMmaWarps; ++w) {
          const float4 p4 = *reinterpret_cast<const float4*>(pb + (w * kMmaRows + r) * C + 4 * u);
          pre[0] += p4.x;
          pre[1] += p4.y;
          pre[2] += p4.z;
          pre[3] += p4.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) pre[q] += cur.x[q];
        if (g_t != nullptr) {
#pragma unroll
          for (int q = 0; q < 4; ++q) g_t[(size_t)n * 4 * H + q * H + j] = pre[q];
        }
        const float i_g = sigmoid_f(pre[0]);
        const float f_g = sigmoid_f(pre[1]);
        const float g_g = tanhf(pre[2]);
        const float o_g = sigmoid_f(pre[3]);
        const size_t o = (size_t)n * H + j;
        // f c + i g with f c in the FMA, fixed: left to the compiler, which
        // product the contraction takes moves with the code around it, and
        // the two orders can differ by an ulp in c.
        const float c_new = __fmaf_rn(f_g, cur.c, __fmul_rn(i_g, g_g));
        const float h_new = o_g * tanhf(c_new);
        const float h_sel = cur.m > 0.0f ? h_new : cur.h;
        h_t[o] = h_sel;
        c_t[o] = cur.m > 0.0f ? c_new : cur.c;
        if (t + 1 < s.F) put_state<P>(x_write, s.x_part, n, j, KS, h_sel);
      }
      if (c + TEAMS >= n_chunks && t + 1 < s.F)
        load(nxt, t + 1, team);  // this thread's c and h of that chunk are written
    }
    if (t + 1 < s.F) {
      fence_proxy_async_global();  // the exchange's stores, before the other blocks' bulk copies
      grid.sync();                 // every block's rows of h_all[t] are written
    }
  }
}

// The forward sweep at HIGH and DEFAULT (see the head note).
//   * The exchange.  xbuf holds 2 slots x parts x n_chunks chunks x KS
//     k-steps of 16x16 bf16 tiles (lstm_common.cuh): h_all[t] goes in bf16
//     to slot (t + 1) & 1 from the thread that writes its f32 value, and
//     step t reads slot t & 1.  A prologue writes h0's bf16 form into slot
//     0 (each block its own columns) and the zeros of rows past N and of
//     columns past H in both slots, once per launch, and ends with a grid
//     barrier.  Slot (t + 1) & 1 is next written in step t + 2, after the
//     grid barrier of step t + 1, which no block passes before its copies of
//     step t + 1 have landed: two slots suffice.
//   * The ring.  After the barrier, thread 0 issues one bulk copy per chunk
//     and part into a ring of `stages` slots (full / empty mbarriers per
//     slot), as many chunks as there are slots, and each later chunk into
//     its slot once the warps are done with the slot's chunk before.
//   * Teams (`teams`, the plan's: 2 only where a step has two chunks or more
//     and the ring two slots or more).  Warps 0-3 and 4-7 are two teams that
//     take the chunks in turns, so one team's epilogue runs beside the
//     other's products (on an odd slot count under the step's chunks with
//     the count of the chunks issued, fwd_steps); else one team of 8 warps
//     takes every chunk through
//     one slot (the plan's: where two slots and two buffers of partials do
//     not fit, as at H=1024 HIGH, one slot and one buffer still do).  The
//     products of a chunk are split over 8 k-step sets, set w the k-steps
//     w, w + 8, ..., a warp of a team of 4 taking two of
//     them; each set's partial tile goes to the team's buffer in shared
//     memory, and the epilogue sums the 8 in set order: the same products
//     in the same order as one staged chunk, so the same bits.
//   * The cell.  Thread (row r, unit u) of a team (16 U of its threads)
//     sums its unit's four gate columns, writes them to gates when they are
//     kept, applies their nonlinearities and writes h and c; it reads the
//     cell operands of its team's next chunk while the current one is
//     multiplied, the next step's first chunk's before the grid barrier.
template <int U, int P>
__device__ __forceinline__ void fwd_mma(const float* __restrict__ x_proj,
                                        const float* __restrict__ mask,
                                        const unsigned short* w_hi, const unsigned short* w_lo,
                                        const float* __restrict__ h0,
                                        const float* __restrict__ c0,
                                        float* __restrict__ gates, float* h_all, float* c_all,
                                        unsigned short* xbuf, int F, int N, int H, int stages,
                                        int teams, float* smem) {
  constexpr int kP = kParts<P>;
  static_assert(U % 2 == 0, "whole n8 tiles: two units' four gates each");
  const int j0 = blockIdx.x * U;
  const int KS = lstm::kpad16(H) / 16;  // k-steps of H
  const int n_chunks = (N + kMmaRows - 1) / kMmaRows;
  const size_t plane = (size_t)KS * kTile;         // bf16 of one part of a chunk
  const size_t x_part = (size_t)n_chunks * plane;  // bf16 of one part of a state
  uint2* w_b = reinterpret_cast<uint2*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<char*>(smem) +
                                                         lstm::mma_matrix_bytes(U, H, kP));
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + (size_t)stages * kP * plane);
  unsigned long long* empty = full + kMaxStages;
  unsigned* issued = reinterpret_cast<unsigned*>(empty + kMaxStages);
  const int tid = threadIdx.x;
  cg::grid_group grid = cg::this_grid();

  // The prologue: the B fragments (wide loads of a row's U columns), the
  // mbarriers, h0's bf16 form and the zeros of the exchange.
  lstm::stage_b_fragments_vec<U, P>(w_b, w_hi, w_lo, H, j0, tid, kThreads);
  if (tid < stages) {
    mbar_init(full + tid, 1);
    mbar_init(empty + tid, teams == 2 ? kWarps / 2 : kWarps);  // the warps of a team
  }
  if (tid == 0) *issued = 0;
  fence_mbarrier_init();
  for (int i = tid; i < N * U; i += kThreads) {
    const int n = i / U, j = j0 + i % U;
    put_state<P>(xbuf, x_part, n, j, KS, __ldg(h0 + (size_t)n * H + j));
  }
  // The zeros: per (slot, part) the rows past N of the last chunk (all Kp
  // columns), then the columns past H of rows 0 .. N - 1.
  const int pad_rows = n_chunks * kMmaRows - N, Kp = KS * 16, pad_cols = Kp - H;
  const size_t row_pads = (size_t)pad_rows * Kp, pads = row_pads + (size_t)N * pad_cols;
  for (size_t e = (size_t)blockIdx.x * kThreads + tid; e < 2 * kP * pads;
       e += (size_t)gridDim.x * kThreads) {
    const size_t region = e / pads, q = e % pads;  // region: slot * kP + part
    const int n = q < row_pads ? N + (int)(q / Kp) : (int)((q - row_pads) / pad_cols);
    const int j = q < row_pads ? (int)(q % Kp) : H + (int)((q - row_pads) % pad_cols);
    xbuf[region * x_part + exchange_index(n, j, KS)] = 0;
  }
  fence_proxy_async_global();  // the exchange's stores, before the bulk copies
  grid.sync();

  const FwdSweep sw{x_proj, mask, h0, c0, gates, h_all, c_all, xbuf, F, N, H, j0, KS, n_chunks,
                    stages, plane, x_part, w_b, ring, full, empty, issued,
                    reinterpret_cast<float*>(reinterpret_cast<char*>(full) + kRingSyncBytes)};
  if (teams == 2)
    fwd_steps<U, P, 2>(sw, tid);
  else
    fwd_steps<U, P, 1>(sw, tid);
}

template <int U, int P>
__global__ void __launch_bounds__(kThreads, 1)
lstm_train_fwd_kernel(const float* __restrict__ x_proj,  // (F, N, 4H)
                      const float* __restrict__ mask,    // (F, N)
                      const void* __restrict__ w_hh,     // (H, 4H): f32 at HIGHEST, else bf16 (hi)
                      const void* __restrict__ w_lo,     // HIGH: the bf16 lo parts, else null
                      const float* __restrict__ h0,      // (N, H)
                      const float* __restrict__ c0,      // (N, H)
                      float* __restrict__ gates,         // (F, N, 4H) or null
                      float* h_all,                      // (F, N, H)
                      float* c_all,                      // (F, N, H)
                      int F, int N, int H, int stage_rows,
                      int teams,                         // HIGH, DEFAULT: 1 or 2 (the plan's)
                      void* xbuf) {                      // HIGH, DEFAULT: the bf16 exchange buffer
                                                         // in k-step tiles, else null
  extern __shared__ __align__(16) float smem[];
  if constexpr (P == kHighest)
    fwd_fp32<U>(x_proj, mask, static_cast<const float*>(w_hh), h0, c0, gates, h_all, c_all, F, N,
                H, stage_rows, smem);
  else
    fwd_mma<U, P>(x_proj, mask, static_cast<const unsigned short*>(w_hh),
                  static_cast<const unsigned short*>(w_lo), h0, c0, gates, h_all, c_all,
                  static_cast<unsigned short*>(xbuf), F, N, H, stage_rows / kMmaRows, teams,
                  smem);
}

// ---------------------------------------------------------------------------
// Reverse sweep.

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

// Shared memory of the reverse sweep at HIGH and DEFAULT (bytes), in this
// order: the B fragments of the block's rows of W_hh (one n8 tile per
// k-step of 4H, `parts` planes); a ring of `stages` stages, each one 16-row
// chunk's k-slice of k_cols columns in k-step tiles (`parts` planes); the
// ring's mbarriers (128 bytes); two buffers of the partial tiles of one n8
// tile; and where `resident` the step operands and carries of the HIGHEST
// layout (ops, car).  The same formula as
// ops/lstm_train_kernel.py::bwd_mma_smem_bytes.
__host__ __device__ constexpr size_t bwd_mma_smem_bytes(int U, int N, int H, int k_cols,
                                                        int stages, bool resident, int parts) {
  return (size_t)parts * (H / 4) * 32 * 8 + (size_t)stages * parts * kMmaRows * k_cols * 2 + 128 +
         2 * lstm::mma_partial_bytes(2) +
         (resident ? sizeof(float) * (round4((size_t)7 * U * N) + round4((size_t)N) +
                                      (size_t)2 * U * N)
                   : 0);
}

// The block's rows j0 .. j0 + U - 1 of W (bf16 hi, and lo at HIGH, each
// (H, 4H) row-major) as the B fragments of one n8 tile per k-step of 4H:
// uint2 (part H / 4 + ks) 32 + lane holds W[j0 + n][k], W[j0 + n][k + 1] and
// W[j0 + n][k + 8], W[j0 + n][k + 9] for k = 16 ks + 2 (lane % 4), n = lane
// / 4 (zero for n >= U).
template <int P>
__device__ void stage_bt_fragments(uint2* dst, const unsigned short* w_hi,
                                   const unsigned short* w_lo, int H, int j0, int U, int tid) {
  const int per_part = H / 4 * 32;
  for (int idx = tid; idx < kParts<P> * per_part; idx += kThreads) {
    const unsigned short* w = idx < per_part ? w_hi : w_lo;
    const int lane = idx % 32, ks = idx % per_part / 32, n = lane / 4;
    uint2 v = make_uint2(0u, 0u);
    if (n < U) {
      const unsigned short* row = w + (size_t)(j0 + n) * 4 * H + ks * 16 + (lane % 4) * 2;
      v = make_uint2((unsigned)__ldg(row) | (unsigned)__ldg(row + 1) << 16,
                     (unsigned)__ldg(row + 8) | (unsigned)__ldg(row + 9) << 16);
    }
    dst[idx] = v;
  }
}

// The reverse sweep at HIGH and DEFAULT (see the head note).  The carries
// of (row n, unit u) at n cs + u: in shared memory where `resident` (cs =
// U), else in the block's columns of dh0, dc0 (cs = H).
//   (A) as HIGHEST's, with the step operands prefetched into shared memory
//       during step t + 1 where `resident`, else read from device memory;
//       besides its columns of dgates[t] in f32 the block writes their bf16
//       form (hi, and lo at HIGH; split_bf16x2, the rounding the staging
//       used to do) into slot t % 2 of the exchange buffer xbuf, in k-step
//       tiles (tile_offset): 2 slots x parts x ceil(N / 16) chunks x H / 4
//       k-steps, the rows past N zero (written once, at the start).  Slot t
//       % 2 is next written in step t - 2, after the grid barrier of step t
//       - 1, which no block passes before every block is done with its step
//       t: two slots suffice.
//   (C) the step's stages, stage i = (16-row chunk i / n_slices, k-slice i
//       % n_slices of k_cols columns), each a contiguous run of tiles per
//       part, stream through a ring of `stages` slots by bulk copies that
//       one thread issues (one per part), each slot with a `full` mbarrier
//       (the copies' bytes landed) and an `empty` one (every warp is done
//       with it).  The warps multiply as their stages land and never wait
//       for a copy to be issued: warp w takes the k-steps w, w + 8, ... of
//       a slice into its tile, and after a chunk's last slice the warps'
//       tiles meet in shared memory (two buffers, one block barrier a
//       chunk) and one thread per (row, unit) adds their sum, in warp
//       order, to the carry dh.
// With k_cols a multiple of 128 (the plan's), each slice starts at a
// multiple of kMmaWarps k-steps, so warp w sums the k-steps w, w + 8, ...
// of 4H in order whatever the slicing: the same bits as one slice.
template <int U, int P>
__device__ __forceinline__ void bwd_mma(const float* __restrict__ dh_all,
                                        const float* __restrict__ dc_all,
                                        const float* __restrict__ gates,
                                        const float* __restrict__ c_prev,
                                        const float* __restrict__ mask,
                                        const unsigned short* w_hi, const unsigned short* w_lo,
                                        float* dgates, float* dh0, float* dc0,
                                        unsigned short* xbuf, int F, int N, int H, int k_cols,
                                        int stages, bool resident, float* smem) {
  constexpr int kP = kParts<P>;
  static_assert(U <= 8, "the block's units fit one n8 tile");
  const int H4 = 4 * H;
  const int KS = H4 / 16;  // k-steps of 4H
  const int j0 = blockIdx.x * U;
  const int n_chunks = (N + kMmaRows - 1) / kMmaRows;
  const int n_slices = (H4 + k_cols - 1) / k_cols;
  const int n_stages = n_chunks * n_slices;              // per step
  const size_t b_part = (size_t)(H / 4) * 32;           // fragments of one part
  const size_t x_part = (size_t)n_chunks * KS * kTile;  // bf16 per part of an xbuf slot
  const size_t plane = (size_t)k_cols / 16 * kTile;     // bf16 per part of a ring slot
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  uint2* w_b = reinterpret_cast<uint2*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(w_b + kP * b_part);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + (size_t)stages * kP * plane);
  unsigned long long* empty = full + 8;
  float* part = reinterpret_cast<float*>(full + 16);
  constexpr int kPart = lstm::mma_partial_bytes(2) / sizeof(float);
  float* ops = part + 2 * kPart;
  const float* op_dh = ops;
  const float* op_dc = ops + U * N;
  const float* op_cp = ops + 2 * U * N;
  const float* op_g = ops + 3 * U * N;
  const float* m_s = ops + round4((size_t)7 * U * N);
  float* dh_s = ops + round4((size_t)7 * U * N) + round4((size_t)N);
  float* dh_c = resident ? dh_s : dh0 + j0;
  float* dc_c = resident ? dh_s + U * N : dc0 + j0;
  const int cs = resident ? U : H;
  cg::grid_group grid = cg::this_grid();

  stage_bt_fragments<P>(w_b, w_hi, w_lo, H, j0, U, tid);
  if (resident)
    copy_step_operands<U>(ops, dh_all, dc_all, c_prev, gates, mask, F - 1, N, H, j0, tid);
  cp_async_commit();
  for (int i = tid; i < U * N; i += kThreads) {
    const int c = i / U * cs + i % U;
    dh_c[c] = dc_c[c] = 0.0f;
  }
  if (tid < stages) {
    mbar_init(full + tid, 1);
    mbar_init(empty + tid, lstm::kMmaWarps);
  }
  fence_mbarrier_init();
  // The rows past N of the last chunk's tiles in both slots: zero for the
  // whole sweep (no block writes them), spread over the grid.
  const int pad = n_chunks * kMmaRows - N;
  for (size_t e = (size_t)blockIdx.x * kThreads + tid; e < (size_t)2 * kP * KS * pad * 16;
       e += (size_t)gridDim.x * kThreads) {
    const size_t tile = e / (pad * 16);  // (slot and part, k-step)
    const int r = kMmaRows - pad + (int)(e / 16 % pad), c = (int)(e % 16);
    xbuf[((tile / KS * n_chunks + n_chunks - 1) * KS + tile % KS) * kTile + tile_offset(r, c)] = 0;
  }
  cp_async_wait<0>();
  __syncthreads();

  int base = 0;  // stages of the sweep before this step's
  for (int t = F - 1; t >= 0; --t, base += n_stages) {
    float* dg_t = dgates + (size_t)t * N * H4;
    unsigned short* xb_t = xbuf + (size_t)(t & 1) * kP * x_part;

    // (A) The block's columns of dgates[t], in f32 and into xbuf, and the
    // carries.
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
      const float d[4] = {dc_new * g_g * i_g * (1.0f - i_g), dc_new * cp * f_g * (1.0f - f_g),
                          dc_new * i_g * (1.0f - g_g * g_g), dh_new * tc * o_g * (1.0f - o_g)};
      const size_t o = (size_t)n * H4 + j0 + u;
      const size_t xo = (size_t)(n / kMmaRows) * KS * kTile;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = q * H + j0 + u;
        const size_t x = xo + (size_t)(col / 16) * kTile + tile_offset(n % kMmaRows, col % 16);
        unsigned hi, lo;
        lstm::split_bf16x2(d[q], 0.0f, hi, lo);
        dg_t[o + q * H] = d[q];
        xb_t[x] = (unsigned short)hi;
        if constexpr (kP == 2) xb_t[x_part + x] = (unsigned short)lo;
      }
      dh_c[c] = Dh * (1.0f - m);
      dc_c[c] = dc_new * f_g + Dc * (1.0f - m);
    }
    fence_proxy_async_global();  // xbuf's stores, before the other blocks' bulk copies

    // (B) Every block's columns of dgates[t] (and of xbuf) are written, and
    // every thread of this block is done with the step's operands.
    grid.sync();

    // (C) dh += dgates[t] @ W_hh[j0:j0+U, :]^T over the ring.  Step t-1's
    // operands go into a copy group of their own.
    if (resident && t > 0)
      copy_step_operands<U>(ops, dh_all, dc_all, c_prev, gates, mask, t - 1, N, H, j0, tid);
    cp_async_commit();
    // Stage i (of this step) into its slot: one bulk copy a part, issued by
    // thread 0 once every warp is done with the slot's previous stage.
    auto issue = [&](int i) {
      const int gi = base + i, slot = gi % stages, use = gi / stages;
      const int ch = i / n_slices, k0 = i % n_slices * k_cols;
      const unsigned bytes = (unsigned)min(k_cols, H4 - k0) * kMmaRows * 2;
      if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
      mbar_expect_tx(full + slot, kP * bytes);
      const unsigned short* src = xb_t + ((size_t)ch * KS + k0 / 16) * kTile;
#pragma unroll
      for (int p = 0; p < kP; ++p)
        bulk_copy(ring + ((size_t)slot * kP + p) * plane, src + p * x_part, bytes, full + slot);
    };
    if (tid == 0) {
      fence_proxy_async_global();
      for (int i = 0; i < min(stages, n_stages); ++i) issue(i);
    }
    float acc[1][4];
    for (int i = 0; i < n_stages; ++i) {
      const int gi = base + i, slot = gi % stages;
      const int slice = i % n_slices, k0 = slice * k_cols, steps = min(k_cols, H4 - k0) / 16;
      mbar_wait(full + slot, (gi / stages) & 1);  // stage i has landed
      __syncwarp();                               // the warp's lanes together again
      if (slice == 0) acc[0][0] = acc[0][1] = acc[0][2] = acc[0][3] = 0.0f;
      const __nv_bfloat16* a = ring + (size_t)slot * kP * plane;
      for (int ks = warp; ks < steps; ks += lstm::kMmaWarps)
        mma_ktile<1, P>(acc, a + (size_t)ks * kTile, plane, w_b + (size_t)(k0 / 16 + ks) * 32,
                        b_part, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);  // this warp is done with the slot
      if (tid == 0 && i + stages < n_stages) issue(i + stages);
      if (slice == n_slices - 1) {
        const int ch = i / n_slices;
        float* pb = part + (ch % 2) * kPart;
        lstm::store_partials<2>(pb, acc, warp, lane);  // one n8 tile: store_partials' U = 2
        __syncthreads();  // the chunk's partial tiles are stored (those of chunk ch - 2 read)
        if (tid < kMmaRows * U) {
          const int r = tid / U, u = tid % U, n = ch * kMmaRows + r;
          if (n < N) dh_c[n * cs + u] += lstm::sum_partials<2>(pb, r, u);
        }
      }
    }
    cp_async_wait<0>();  // the next step's operands have landed
    __syncthreads();     // ... for every thread, and the carries are complete
  }

  if (resident) {
    for (int idx = tid; idx < N * U; idx += kThreads) {
      const size_t off = (size_t)(idx / U) * H + j0 + idx % U;
      dh0[off] = dh_c[idx];
      dc0[off] = dc_c[idx];
    }
  }
}

// The reverse sweep; its HIGHEST body: threads of row group grp = tid / S
// of `groups`, k-split s = tid % S with S = kThreads / groups (whole warps
// per group).  A pass covers 4 * groups rows
// of a stage; stages of stage_rows rows each (1 stage: all N rows).
// resident = 1: the step operands are prefetched into shared memory and the
// carries live there; resident = 0: (A) reads the operands of step t from
// device memory and the carries live in the block's columns of dh0, dc0 (only
// this block reads or writes them, ordered by its __syncthreads).
template <int U, int P>
__global__ void __launch_bounds__(kThreads, 1)
lstm_train_bwd_kernel(const float* __restrict__ dh_all,  // (F, N, H)
                      const float* __restrict__ dc_all,  // (F, N, H)
                      const float* __restrict__ gates,   // (F, N, 4H)
                      const float* __restrict__ c_prev,  // (F, N, H): c before step t
                      const float* __restrict__ mask,    // (F, N)
                      const float* __restrict__ w_hh,    // (H, 4H): f32 at HIGHEST, else the
                                                         // bf16 (hi) parts
                      float* dgates,                     // (F, N, 4H)
                      float* dh0,                        // (N, H)
                      float* dc0,                        // (N, H)
                      int F, int N, int H, int groups, int stage_rows, int stages,
                      int resident,
                      const void* __restrict__ w_lo,     // HIGH: the bf16 lo parts, else null
                      int k_cols,
                      void* xbuf) {                      // HIGH, DEFAULT: the bf16 exchange
                                                         // buffer in k-step tiles, else null
  extern __shared__ __align__(16) float smem[];
  if constexpr (P != kHighest) {
    bwd_mma<U, P>(dh_all, dc_all, gates, c_prev, mask,
                  reinterpret_cast<const unsigned short*>(w_hh),
                  static_cast<const unsigned short*>(w_lo), dgates, dh0, dc0,
                  static_cast<unsigned short*>(xbuf), F, N, H, k_cols, stages, resident != 0,
                  smem);
    return;
  }
  // The HIGHEST body stays in the kernel, with W_hh a float parameter: as a
  // function taking W_hh through a void pointer it compiles to other SASS
  // (8 fewer instructions, about 1% slower at F=256 N=64 on an H100).
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

template <int U, int P>
cudaError_t prepare_units(int max_smem, bool* fits) {
  cudaError_t err = prepare_kernel((const void*)lstm_train_fwd_kernel<U, P>, max_smem, fits);
  if (err == cudaSuccess)
    err = prepare_kernel((const void*)lstm_train_bwd_kernel<U, P>, max_smem, fits);
  return err;
}

// U = 1, 2, 4, 8 at HIGHEST; U = 2, 4, 8 at HIGH and DEFAULT (an n8 tile
// holds two units' gates).
template <int P>
cudaError_t prepare_mode(int max_smem, bool* fits) {
  cudaError_t err = cudaSuccess;
  if constexpr (P == kHighest) err = prepare_units<1, P>(max_smem, fits);
  if (err == cudaSuccess) err = prepare_units<2, P>(max_smem, fits);
  if (err == cudaSuccess) err = prepare_units<4, P>(max_smem, fits);
  if (err == cudaSuccess) err = prepare_units<8, P>(max_smem, fits);
  return err;
}

int launch(const void* kernel, int blocks, size_t smem, void** args, cudaStream_t stream) {
  const cudaError_t err =
      cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

struct FwdArgs {
  const float* x_proj;
  const float* mask;
  const void* w_hh;
  const void* w_lo;
  const float* h0;
  const float* c0;
  float* gates;
  float* h_all;
  float* c_all;
  int F, N, H, stage_rows, teams;
  void* xbuf;
};

template <int U, int P>
int launch_fwd(FwdArgs a, size_t smem, cudaStream_t stream) {
  void* args[] = {(void*)&a.x_proj, (void*)&a.mask,  (void*)&a.w_hh,  (void*)&a.w_lo,
                  (void*)&a.h0,     (void*)&a.c0,    (void*)&a.gates, (void*)&a.h_all,
                  (void*)&a.c_all,  (void*)&a.F,     (void*)&a.N,     (void*)&a.H,
                  (void*)&a.stage_rows, (void*)&a.teams, (void*)&a.xbuf};
  return launch((const void*)lstm_train_fwd_kernel<U, P>, a.H / U, smem, args, stream);
}

struct BwdArgs {
  const float* dh_all;
  const float* dc_all;
  const float* gates;
  const float* c_prev;
  const float* mask;
  const void* w_hh;
  const void* w_lo;
  float* dgates;
  float* dh0;
  float* dc0;
  int F, N, H, groups, stage_rows, stages, resident, k_cols;
  void* xbuf;
};

template <int U, int P>
int launch_bwd(BwdArgs a, size_t smem, cudaStream_t stream) {
  void* args[] = {(void*)&a.dh_all, (void*)&a.dc_all, (void*)&a.gates,      (void*)&a.c_prev,
                  (void*)&a.mask,   (void*)&a.w_hh,   (void*)&a.dgates,     (void*)&a.dh0,
                  (void*)&a.dc0,    (void*)&a.F,      (void*)&a.N,          (void*)&a.H,
                  (void*)&a.groups, (void*)&a.stage_rows, (void*)&a.stages, (void*)&a.resident,
                  (void*)&a.w_lo,   (void*)&a.k_cols, (void*)&a.xbuf};
  return launch((const void*)lstm_train_bwd_kernel<U, P>, a.H / U, smem, args, stream);
}

// The instance of `units` at mode P (kErrBadShape for U = 1 but at HIGHEST).
template <int P>
int forward_at(FwdArgs a, int units, size_t smem, cudaStream_t s) {
  switch (units) {
    case 1:
      if constexpr (P == kHighest) return launch_fwd<1, P>(a, smem, s);
      return kErrBadShape;
    case 2: return launch_fwd<2, P>(a, smem, s);
    case 4: return launch_fwd<4, P>(a, smem, s);
    case 8: return launch_fwd<8, P>(a, smem, s);
    default: return kErrBadShape;
  }
}

template <int P>
int backward_at(BwdArgs a, int units, size_t smem, cudaStream_t s) {
  switch (units) {
    case 1:
      if constexpr (P == kHighest) return launch_bwd<1, P>(a, smem, s);
      return kErrBadShape;
    case 2: return launch_bwd<2, P>(a, smem, s);
    case 4: return launch_bwd<4, P>(a, smem, s);
    case 8: return launch_bwd<8, P>(a, smem, s);
    default: return kErrBadShape;
  }
}

}  // namespace

extern "C" {

// Once per device, before the first launch there (and outside any CUDA graph
// capture): checks that the card launches cooperative grids, lets every
// instance of both sweeps (U = 1, 2, 4, 8 at HIGHEST, U = 2, 4, 8 at HIGH and
// DEFAULT) use the card's opt-in shared memory per block, and checks that an
// SM holds one block of each with that much.  Writes the SM count and the
// opt-in limit in bytes to info[0], info[1].  Returns 0, a cudaError_t
// value, or a negative code above.
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
  if (err == cudaSuccess) err = prepare_mode<kHighest>(info[1], &fits);
  if (err == cudaSuccess) err = prepare_mode<kHigh>(info[1], &fits);
  if (err == cudaSuccess) err = prepare_mode<kDefault>(info[1], &fits);
  cudaSetDevice(prev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return kErrNoCooperative;
  return fits ? 0 : kErrGridTooLarge;
}

// Bytes of shared memory a forward-sweep block takes at mode (0 HIGHEST, 1
// HIGH, 2 DEFAULT) with `units` units, stage_rows staged rows and `teams`
// teams (read at HIGH and DEFAULT): the layout that lstm_train_forward holds
// smem_bytes to.
long long lstm_train_fwd_smem_bytes(int units, int H, int stage_rows, int mode, int teams) {
  return (long long)(mode == kHighest ? sizeof(float) * fwd_smem_floats(units, H, stage_rows)
                                      : fwd_mma_smem_bytes(units, H, mode == kHigh ? 2 : 1,
                                                           stage_rows / kMmaRows, teams));
}

// Forward sweep over all F steps in one cooperative launch of H / units
// blocks on `stream`.  gates may be null (the undifferentiated primal).
// mode (0 HIGHEST, 1 HIGH, 2 DEFAULT): w_hh is f32 at HIGHEST (w_lo and xbuf
// null), W_hh rounded to bf16 at DEFAULT, its bf16 hi parts at HIGH with
// w_lo the lo parts; at HIGH and DEFAULT xbuf is the exchange buffer, 2 x
// parts x ceil(N / 16) x kpad16(H) x 16 bf16 on a 16-byte boundary, whose
// contents the launch sets (no zeroing before it).  units, stage_rows
// (HIGHEST: N, all rows staged at once, or a multiple of 16 below N, a ring
// of 16-row slots; else 16 times the ring's slots, 1 to 8), teams (HIGHEST:
// 1; else 1, or 2 where N > 16 and the ring has two slots or more) and
// smem_bytes are the launch plan's; smem_bytes must equal the layout's
// size.  x_proj and h0 start on a 16-byte boundary.  Launches only:
// lstm_train_prepare must have run on the current device.  Returns 0, a
// cudaError_t value, or a negative code above.
int lstm_train_forward(const float* x_proj, const float* mask, const void* w_hh,
                       const float* h0, const float* c0, float* gates, float* h_all,
                       float* c_all, int F, int N, int H, int units, int stage_rows,
                       int smem_bytes, int mode, int teams, const void* w_lo, void* xbuf,
                       void* stream) {
  if (mode < kHighest || mode > kDefault || units <= 0 || H <= 0) return kErrBadShape;
  const size_t layout = (size_t)lstm_train_fwd_smem_bytes(units, H, stage_rows, mode, teams);
  const int n_chunks = (N + kMmaRows - 1) / kMmaRows, stages = stage_rows / kMmaRows;
  if (F <= 0 || N <= 0 || H % 4 != 0 || H % units != 0 || stage_rows <= 0 ||
      (mode == kHighest &&
       (teams != 1 || stage_rows > N || (stage_rows != N && stage_rows % kPassRows != 0))) ||
      (mode != kHighest &&
       (stage_rows % kMmaRows != 0 || stages > kMaxStages || xbuf == nullptr ||
        reinterpret_cast<size_t>(xbuf) % 16 != 0 ||
        (teams != 1 && (teams != 2 || n_chunks < 2 || stages < 2)))) ||
      (mode == kHigh && w_lo == nullptr) || (size_t)smem_bytes != layout)
    return kErrBadShape;
  const FwdArgs a{x_proj, mask, w_hh, w_lo, h0, c0, gates, h_all, c_all,
                  F,      N,    H,    stage_rows, teams, xbuf};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kHigh) return forward_at<kHigh>(a, units, layout, s);
  if (mode == kDefault) return forward_at<kDefault>(a, units, layout, s);
  return forward_at<kHighest>(a, units, layout, s);
}

// Reverse sweep over all F steps in one cooperative launch on `stream`;
// writes dgates (F, N, 4H) and dh0, dc0 (N, H).  mode, w_hh and w_lo as
// above.  units, groups, stage_rows, stages, resident (1: step operands and
// carries in shared memory), k_cols and smem_bytes are the launch plan's
// (HIGHEST: k_cols = 4H, 1 or 2 stages; HIGH and DEFAULT: groups 1,
// stage_rows 16, a ring of 2 to 8 stages of k_cols columns, 4H or a
// multiple of 128 below it); smem_bytes must equal the layout's size.  xbuf
// (HIGH and DEFAULT; null at HIGHEST): scratch of 2 x parts x ceil(N / 16)
// x 16 x 4H bf16, on a 16-byte boundary.  Launches only, as above.  Returns as above.
int lstm_train_backward(const float* dh_all, const float* dc_all, const float* gates,
                        const float* c_prev, const float* mask, const void* w_hh,
                        float* dgates, float* dh0, float* dc0, int F, int N, int H, int units,
                        int groups, int stage_rows, int stages, int resident, int k_cols,
                        int smem_bytes, int mode, const void* w_lo, void* xbuf, void* stream) {
  if (mode < kHighest || mode > kDefault || units <= 0 || H <= 0 || k_cols <= 0)
    return kErrBadShape;
  const size_t layout =
      mode == kHighest
          ? sizeof(float) * bwd_smem_floats(units, N, H, stages, stage_rows, resident)
          : bwd_mma_smem_bytes(units, N, H, k_cols, stages, resident != 0, mode == kHigh ? 2 : 1);
  if (F <= 0 || N <= 0 || H % 4 != 0 || H % units != 0 || stage_rows <= 0 ||
      (resident != 0 && resident != 1) ||
      (mode == kHighest && (stages < 1 || stages > 2 ||
                            (groups != 1 && groups != 2 && groups != 4) || k_cols != 4 * H)) ||
      (mode != kHighest &&
       (stage_rows != kMmaRows || stages < 2 || stages > 8 || groups != 1 ||
        (k_cols % (16 * lstm::kMmaWarps) != 0 && k_cols != 4 * H) || k_cols > 4 * H ||
        xbuf == nullptr ||
        reinterpret_cast<size_t>(xbuf) % 16 != 0)) ||
      (mode == kHigh && w_lo == nullptr) || (size_t)smem_bytes != layout)
    return kErrBadShape;
  const BwdArgs a{dh_all, dc_all, gates,  c_prev,     mask,   w_hh,     w_lo,   dgates, dh0,
                  dc0,    F,      N,      H,          groups, stage_rows, stages, resident,
                  k_cols, xbuf};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kHigh) return backward_at<kHigh>(a, units, layout, s);
  if (mode == kDefault) return backward_at<kDefault>(a, units, layout, s);
  return backward_at<kHighest>(a, units, layout, s);
}

}  // extern "C"
