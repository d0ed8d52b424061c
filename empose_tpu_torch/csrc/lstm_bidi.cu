// Bidirectional LSTM layer forward for Hopper (sm_90a): both directions in
// one cooperative launch, or one direction per launch where the two do not
// fit on the card at once.
//
// Replaces the Pallas TPU kernel empose_tpu/ops/lstm_kernel.py::_pallas_bidi
// (body _make_bidi_kernel): one bidirectional LSTM layer at inference, both
// directions over F steps, gates in torch order (i, f, g, o).  Each
// direction's gate input is its hoisted projection x_proj[:, d] (both biases
// folded in, computed outside as one GEMM per direction); the backward one is
// projected from the input reversed per sample by length, so one mask serves
// both directions and the backward outputs come out in reversed time.  Where
// mask == 0 the (h, c) state is selected, frozen bit for bit, and the step's
// output is h_new * mask.
//
// What bounds it on this card.  The recurrence is serial in time, and every
// step needs both directions' W_hh (8.4 MB at H=512).  Three things bound a
// call:
//   * the fp32 FMA work, 2*2*F*N*H*4H operations (0.064 ms at F=16, N=64,
//     H=512: about 4 us per step);
//   * F grid barriers, one per step for both directions (1.5-2.8 us each on
//     an H100), or two sets of F where the directions run one per launch;
//   * the step's exchange buffer: every block reads all N rows of its
//     direction's h[t-1] (N*H*4 bytes: 128 KB at N=64, H=512) from L2 just
//     after the barrier, so it cannot be prefetched.
// The design is the training forward sweep's (csrc/lstm_train.cu,
// lstm_train_fwd_kernel), which runs the same recurrence for one direction:
//   * Grid.  Each block owns U consecutive hidden units j of ONE direction d
//     and keeps their four gate columns {j, H+j, 2H+j, 3H+j} of W_hh[d]
//     resident in shared memory, laid out so that neighbouring threads read
//     neighbouring float4.  U=8 wherever 8 divides H (U=4 where H % 8 == 4):
//     where 2H/U blocks fit on the SMs beside their columns (H=512: 128
//     blocks of 64 KB of columns), both directions share one grid and one
//     barrier per step; otherwise (H=1024: 128 KB of columns) the wrapper
//     launches the same kernel once per direction, each with H/U blocks.
//     U=4 with two blocks per SM at H=512 (256 blocks, 128 registers a
//     thread, W_hh read from shared memory) was slower at every N on an H100
//     (PERF.md).
//   * Staging.  Step t copies all N rows of the block's direction's h[t-1]
//     by 16-byte cp.async.cg copies (through L2, never a stale L1), one copy
//     group per chunk of 16 rows, from a 128-byte boundary; the pass over
//     chunk c waits only for chunk c's group, so its FMAs run while the later
//     chunks land.  Where the rows do not fit beside the columns (N > 81 at
//     H=512, U=8), the chunks cycle through a ring of 16-row slots, the next
//     chunks in flight while the current one's FMAs run; with one slot
//     (H=1024, N > 24) a chunk is copied only once every thread is done with
//     the one before.  So the shared memory does not grow with N, and any N
//     runs.  The launch plan (ops/lstm_kernel.py::lstm_bidi_plan) sizes it.
//   * FMAs.  Warp (unit pair, row group) multiplies its rows of the chunk by
//     the eight gate columns of its two units, lane l over the float4
//     columns l, l + 32, ... of H, with W_hh of the first two of them held
//     in registers for the whole sweep (half of it at H=512) and the rest
//     read from the resident columns: a staged h value is read from shared
//     memory once per unit pair.  At U=8 a warp has 8 rows of each chunk and
//     multiplies them as one 8-row register tile of 64 sums, so the sums are
//     reduced and the cell run once per chunk (4-row tiles, two per chunk,
//     were slower at N=64 on an H100); fewer rows take 4, 2 and 1-row
//     tiles: no FMA and no shared load falls on a row beyond N.  The partial
//     sums meet in a fixed-order warp reduce-scatter that leaves each lane
//     with the whole sums of one or two (row, unit, gate): no atomics and no
//     shared memory, so two launches on the same inputs give the same bits,
//     and a chunk needs one __syncthreads.
//   * The cell, in the warp.  Each lane reads its step operands (x_proj's
//     gate column, mask, the carry c) from device memory before its FMAs,
//     which hide their latency, adds x_proj to its sum and applies its gate's
//     nonlinearity; the first lane of each (row, unit) gathers the four gates
//     by shuffles and writes h[t], c and the output.  h0 and c0 are read in
//     place at the first step: no copy before the launch.
//   * One grid barrier per step, none after the last.
// That is the HIGHEST instance (fp32 FMAs on the CUDA cores, the fp32 parity
// mode).  At HIGH and DEFAULT (template argument P, lstm_common.cuh) the
// recurrent product runs on the tensor cores, mma.sync m16n8k16 bf16 with
// f32 accumulation, as in the stack kernel (csrc/lstm_stack.cu): W_hh comes
// in rounded (DEFAULT) or split into a bf16 hi/lo pair (HIGH) by the wrapper
// and stays resident in B-fragment order; each 16-row chunk of h[t-1] is
// converted once into bf16 planes (hi; hi and lo at HIGH), the 8 warps
// multiply over disjoint k-steps, and the partial tiles meet in shared
// memory, summed in warp order by one thread per (row, unit, gate).  The
// cell, masking and writes are the HIGHEST code's, in f32; no atomics.
// The grid must be co-resident for the barrier: lstm_bidi_prepare sets the
// kernel's shared memory and checks its occupancy once per device, the
// wrapper keeps the grid within the SMs, and lstm_bidi_forward only launches
// (cudaLaunchCooperativeKernel): no attribute or occupancy query per call,
// so a call can be captured in a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

using lstm::component;
using lstm::cp_async;
using lstm::cp_async_commit;
using lstm::cp_async_wait_upto;
using lstm::kDefault;
using lstm::kHigh;
using lstm::kHighest;
using lstm::kMmaRows;
using lstm::kParts;
using lstm::round32;
using lstm::sigmoid_f;
using lstm::warp_reduce_scatter;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPassRows = 16;  // rows of h[t-1] per staged chunk

// Error codes beside cudaError_t values (which are >= 0); the same values
// as lstm_stack.cu.
constexpr int kErrGridTooLarge = -1;
constexpr int kErrNoCooperative = -3;
constexpr int kErrBadShape = -4;

// Shared memory of a block (floats), in this order:
//   w_s  [4][U][H], to 128 bytes    the block's gate columns of W_hh[d]: the
//                                   float4 of unit u's four gates at row
//                                   k = 4c + q sits at (q * U + u) * H + 4c
//   h_s  [stage_rows][H]            the staged rows of h[t-1], from a
//                                   128-byte boundary: all N, or a ring of
//                                   stage_rows / 16 chunk slots
// The same formula as ops/lstm_kernel.py::bidi_smem_bytes.
__host__ __device__ constexpr size_t smem_floats(int U, int H, int stage_rows) {
  return round32((size_t)4 * U * H) + (size_t)stage_rows * H;
}

// Shared memory of a block at HIGH and DEFAULT (bytes): the B fragments of
// the block's columns of W_hh[d] (lstm_common.cuh, `parts` planes), one
// staged bf16 chunk of h[t-1] (`parts` planes) and the partial tiles.  The
// same formula as ops/lstm_kernel.py::bidi_smem_bytes.
__host__ __device__ constexpr size_t mma_smem_bytes(int U, int H, int parts) {
  return lstm::mma_matrix_bytes(U, H, parts) + (size_t)parts * lstm::mma_plane_bytes(H) +
         lstm::mma_partial_bytes(U);
}

// Units a warp multiplies at once (a staged h value read from shared memory
// serves both units' FMAs), and float4 columns of H per lane whose W_hh
// lives in registers for the whole sweep: half of W_hh at H=512; with four,
// the 64 sums of an 8-row tile no longer fit in 255 registers without spills.
constexpr int kUnitPair = 2;
constexpr int kRegCols = 2;

// What the pieces of a step share (pointers already at step t and the
// block's direction d).
struct Step {
  const float* x_t;     // x_proj[t, d]  (N, 4H)
  const float* mask_t;  // mask[t]       (N)
  const float* c_prev;  // c0[d] at t = 0, else c_out[d]  (N, H)
  float* c_next;        // c_out[d]      (N, H)
  float* h_next;        // h[t] of direction d  (N, H)
  float* out_t;         // outs[t, d]    (N, H)
  int H, j0;
};

// One warp's piece of a step: NP staged rows (`rows`, stride H; global rows
// n0 ...) times the four gate columns of its UP units u0, u0 + 1.  Lane l
// multiplies the float4 columns l, l + 32, ... of H (W_hh of the first RC of
// them in registers).  The warp's V = 4 UP NP <= 64 sums, value (row r, unit
// ui, gate g) being (r UP + ui) 4 + g, are scattered over the lanes: where
// V <= 32 lane l holds value l / kC (kC = 32 / V lanes hold each), where
// V = 64 it holds values 2l and 2l + 1.  Each lane adds x_proj's columns to
// its sums and applies their gates' nonlinearities, and the first lane of
// each (row, unit) gathers the four gates and writes its h, c and output.
template <int U, int NP>
__device__ __forceinline__ void step_piece(const Step& p, const float* rows, int n0,
                                           const float4 (&wreg)[kUnitPair][kRegCols][4],
                                           const float* w_s, int u0, int lane) {
  constexpr int UP = kUnitPair, RC = kRegCols;
  constexpr int V = 4 * UP * NP;
  constexpr int kPer = V > 32 ? V / 32 : 1;  // sums a lane ends with
  constexpr int kC = V < 32 ? 32 / V : 1;    // lanes holding the same sum
  constexpr int kCell = 4 / kPer * kC;       // lanes holding one (row, unit)'s four gates
  static_assert(V <= 64, "a piece holds at most 64 sums");
  const int H = p.H;
  const int C4 = H / 4;
  const int idx = lane / kC * kPer;  // the lane's first value
  const int g = idx % 4;             // its gate; the lane's value k has gate g + k
  const int u = u0 + idx / 4 % UP;
  const int r_own = idx / (4 * UP);
  const int n = n0 + r_own;
  const int j = p.j0 + u;
  const bool lead = lane % kCell == 0;

  // The cell's operands, read before the FMAs so that their latency hides
  // behind them; the old h of a masked row is its staged row.
  float x[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) x[k] = __ldg(p.x_t + (size_t)n * 4 * H + (g + k) * H + j);
  float m = 0.0f, c_old = 0.0f, h_old = 0.0f;
  if (lead) {
    h_old = rows[(size_t)r_own * H + j];
    m = __ldg(p.mask_t + n);
    c_old = p.c_prev[(size_t)n * H + j];
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
  for (int i = 0; i < RC; ++i) {
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
  for (int c = lane + 32 * RC; c < C4; c += 32) {
    float4 w[UP][4];
#pragma unroll
    for (int ui = 0; ui < UP; ++ui)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[ui][q] = w4[(q * U + u0 + ui) * C4 + c];
    fma_rows(w, c);
  }
  warp_reduce_scatter<V, 16>(acc, lane);

  float act[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const float pre = x[k] + acc[k];
    act[k] = g + k == 2 ? tanhf(pre) : sigmoid_f(pre);
  }
  // Gate q of the lane's (row, unit) is value q % kPer of lane base + q / kPer * kC.
  const int base = lane / kCell * kCell;
  float gate[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) gate[q] = __shfl_sync(0xffffffffu, act[q % kPer], base + q / kPer * kC);
  if (lead) {
    const float c_new = gate[1] * c_old + gate[0] * gate[2];
    const float h_new = gate[3] * tanhf(c_new);
    const size_t off = (size_t)n * H + j;
    p.h_next[off] = m > 0.0f ? h_new : h_old;
    p.c_next[off] = m > 0.0f ? c_new : c_old;
    p.out_t[off] = h_new * m;
  }
}

// Block b serves direction d0 + b / (H / U) and its units j0 = (b % (H / U))
// * U, ...  Warps: unit pair warp % (U / 2) (units u0, u0 + 1), row group
// warp / (U / 2); the rows of a 16-row chunk are split over the row groups,
// U rows each, which a warp multiplies as one tile where all of them exist,
// else in tiles of 4, 2 and 1 rows.  Chunk c lies in slot c % slots of h_s
// (slots = stage_rows / 16 rounded up; all chunks where stage_rows == N).
// h of step t goes to hbuf[(t + 1) & 1], read at step t + 1 (h0 in place at
// step 0); c is kept in c_out, each element read and written by the same
// lane (c0 in place at step 0).
// The HIGH and DEFAULT body (see the head note): step t takes the chunks of
// h[t-1] one at a time through one slot of staged bf16 planes and one set of
// partial tiles; h[t-1] is read through L2 (other blocks wrote it before the
// grid barrier; h0 in place at step 0).
template <int U, int P>
__device__ __forceinline__ void mma_body(const float* __restrict__ x_proj,
                                         const float* __restrict__ mask,
                                         const unsigned short* w_hi, const unsigned short* w_lo,
                                         const float* __restrict__ h0,
                                         const float* __restrict__ c0, float* __restrict__ outs,
                                         float* hbuf, float* c_out, int F, int N, int H, int d0,
                                         float* smem) {
  constexpr int C = 4 * U;                       // the block's gate columns of W_hh[d]
  constexpr int kEpi = kMmaRows * C / kThreads;  // (row, column) outputs of a thread
  constexpr int kP = kParts<P>;
  const int blocks_per_dir = H / U;
  const int d = d0 + blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * U;
  const size_t NH = (size_t)N * H;
  const size_t plane = lstm::mma_plane_bytes(H) / 2;  // bf16 per plane
  uint2* w_b = reinterpret_cast<uint2*>(smem);
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<char*>(smem) + lstm::mma_matrix_bytes(U, H, kP));
  float* part = reinterpret_cast<float*>(reinterpret_cast<char*>(a_s) +
                                         kP * lstm::mma_plane_bytes(H));
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  cg::grid_group grid = cg::this_grid();

  const size_t off = (size_t)d * H * 4 * H;
  lstm::stage_b_fragments<U, P>(w_b, w_hi + off, w_lo ? w_lo + off : nullptr, H, j0, tid,
                                kThreads);
  __syncthreads();

  const int n_chunks = (N + kMmaRows - 1) / kMmaRows;
  for (int t = 0; t < F; ++t) {
    const float* h_prev = t == 0 ? h0 + d * NH : hbuf + ((size_t)(t & 1) * 2 + d) * NH;
    const float* x_t = x_proj + ((size_t)t * 2 + d) * N * 4 * H;
    const float* c_prev = (t == 0 ? c0 : c_out) + d * NH;
    float* h_next = hbuf + ((size_t)((t + 1) & 1) * 2 + d) * NH;
    float* out_t = outs + ((size_t)t * 2 + d) * NH;
    for (int c = 0; c < n_chunks; ++c) {
      const int r0 = c * kMmaRows;
      // The cell's operands of thread (row r, column n = 4u + g), read
      // before the staging and the product so that their latency hides
      // behind them: x_proj's gate column, and for the first of each four
      // the mask, the old c and the old h.
      float x_in[kEpi], m[kEpi], c_old[kEpi], h_old[kEpi];
#pragma unroll
      for (int e = 0; e < kEpi; ++e) {
        const int idx = tid + kThreads * e;
        const int nn = idx % C, g = nn % 4, n = r0 + idx / C;
        const size_t o = (size_t)n * H + j0 + nn / 4;
        x_in[e] = m[e] = c_old[e] = h_old[e] = 0.0f;
        if (n < N) {
          x_in[e] = __ldg(x_t + (size_t)n * 4 * H + g * H + j0 + nn / 4);
          if (g == 0) {
            m[e] = __ldg(mask + (size_t)t * N + n);
            c_old[e] = c_prev[o];
            h_old[e] = __ldcg(h_prev + o);
          }
        }
      }
      lstm::stage_rows_bf16<P>(a_s, plane, h_prev, r0, N, H, tid, kThreads);
      __syncthreads();  // the chunk's planes are staged, and the partials of the chunk before read
      float acc[U / 2][4];
#pragma unroll
      for (int nt = 0; nt < U / 2; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      lstm::mma_rows<U, P>(acc, a_s, plane, w_b, H, warp, lane);
      lstm::store_partials<U>(part, acc, warp, lane);
      __syncthreads();  // the partials are there, and every warp is done with the planes

      // Thread (row r, column n = 4u + g): the gate's sum, input, nonlinearity.
#pragma unroll
      for (int e = 0; e < kEpi; ++e) {
        const int idx = tid + kThreads * e;
        const int r = idx / C, nn = idx % C, g = nn % 4;
        const int n = r0 + r;
        const float pre = lstm::sum_partials<U>(part, r, nn) + x_in[e];
        const float act = g == 2 ? tanhf(pre) : sigmoid_f(pre);
        float gate[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) gate[q] = __shfl_sync(0xffffffffu, act, (lane & ~3) + q);
        if (g == 0 && n < N) {
          const size_t o = (size_t)n * H + j0 + nn / 4;
          const float c_new = gate[1] * c_old[e] + gate[0] * gate[2];
          const float h_new = gate[3] * tanhf(c_new);
          h_next[o] = m[e] > 0.0f ? h_new : h_old[e];
          c_out[d * NH + o] = m[e] > 0.0f ? c_new : c_old[e];
          out_t[o] = h_new * m[e];
        }
      }
    }
    if (t + 1 < F) grid.sync();  // every block's rows of h[t] are written
  }
}

template <int U>
__device__ __forceinline__ void fp32_body(const float* __restrict__ x_proj,
                                          const float* __restrict__ mask,
                                          const float* __restrict__ w_hh,
                                          const float* __restrict__ h0,
                                          const float* __restrict__ c0,
                                          float* __restrict__ outs, float* hbuf, float* c_out,
                                          int F, int N, int H, int d0, int stage_rows,
                                          float* smem) {
  constexpr int UP = kUnitPair, RC = kRegCols;
  constexpr int kRowsW = kPassRows * U / UP / kWarps;  // rows of a chunk per warp: U
  static_assert(U == 4 || U == 8, "a warp's rows of a chunk are one tile of at most 64 sums");
  const int blocks_per_dir = H / U;
  const int d = d0 + blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * U;
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

  const float* w_d = w_hh + (size_t)d * H * 4 * H;
  for (int idx = tid; idx < 4 * U * H; idx += kThreads) {
    const int qu = idx / H;
    const int k = (idx % H) / 4 * 4 + qu / U;
    w_s[idx] = w_d[(size_t)k * 4 * H + (idx % 4) * H + j0 + qu % U];
  }
  __syncthreads();
  float4 wreg[UP][RC][4];
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
#pragma unroll
  for (int ui = 0; ui < UP; ++ui)
#pragma unroll
    for (int i = 0; i < RC; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wreg[ui][i][q] = lane + 32 * i < C4 ? w4[(q * U + u0 + ui) * C4 + lane + 32 * i]
                                            : make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < F; ++t) {
    const float* h_prev = t == 0 ? h0 + d * NH : hbuf + ((size_t)(t & 1) * 2 + d) * NH;
    Step p;
    p.x_t = x_proj + ((size_t)t * 2 + d) * N * 4 * H;
    p.mask_t = mask + (size_t)t * N;
    p.c_prev = (t == 0 ? c0 : c_out) + d * NH;
    p.c_next = c_out + d * NH;
    p.h_next = hbuf + ((size_t)((t + 1) & 1) * 2 + d) * NH;
    p.out_t = outs + ((size_t)t * 2 + d) * NH;
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
      if (nr == kRowsW) {
        step_piece<U, kRowsW>(p, st + (size_t)lo * H, r0 + lo, wreg, w_s, u0, lane);
        nr = 0;
      }
      if constexpr (kRowsW > 4) {
        if (nr & 4) {
          step_piece<U, 4>(p, st + (size_t)lo * H, r0 + lo, wreg, w_s, u0, lane);
          lo += 4;
        }
      }
      if (nr & 2) {
        step_piece<U, 2>(p, st + (size_t)lo * H, r0 + lo, wreg, w_s, u0, lane);
        lo += 2;
      }
      if (nr & 1) step_piece<U, 1>(p, st + (size_t)lo * H, r0 + lo, wreg, w_s, u0, lane);
    }

    if (t + 1 < F) grid.sync();  // every block's rows of h[t] are written
  }
}

template <int U, int P>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bidi_kernel(const float* __restrict__ x_proj,  // (F, 2, N, 4H)
                 const float* __restrict__ mask,    // (F, N)
                 const void* w_hh,                  // (2, H, 4H): f32 at HIGHEST, else bf16 (hi)
                 const void* w_lo,                  // HIGH: the bf16 lo parts, else null
                 const float* __restrict__ h0,      // (2, N, H)
                 const float* __restrict__ c0,      // (2, N, H)
                 float* __restrict__ outs,          // (F, 2, N, H)
                 float* hbuf,                       // (2, 2, N, H)
                 float* c_out,                      // (2, N, H): cF at the end
                 int F, int N, int H, int d0, int stage_rows) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (P == kHighest)
    fp32_body<U>(x_proj, mask, static_cast<const float*>(w_hh), h0, c0, outs, hbuf, c_out, F, N,
                 H, d0, stage_rows, smem);
  else
    mma_body<U, P>(x_proj, mask, static_cast<const unsigned short*>(w_hh),
                   static_cast<const unsigned short*>(w_lo), h0, c0, outs, hbuf, c_out, F, N, H,
                   d0, smem);
}

// Lets lstm_bidi_kernel<U, P> use up to max_smem bytes of dynamic shared
// memory and clears *fits unless an SM holds one block of it with that much.
template <int U, int P>
cudaError_t prepare_units(int max_smem, bool* fits) {
  const void* kernel = (const void*)lstm_bidi_kernel<U, P>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         max_smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, max_smem);
  if (per_sm < 1) *fits = false;
  return err;
}

template <int P>
cudaError_t prepare_mode(int max_smem, bool* fits) {
  cudaError_t err = prepare_units<4, P>(max_smem, fits);
  if (err == cudaSuccess) err = prepare_units<8, P>(max_smem, fits);
  return err;
}

template <int U, int P>
int launch(const float* x_proj, const float* mask, const void* w_hh, const void* w_lo,
           const float* h0, const float* c0, float* outs, float* hbuf, float* c_out, int F,
           int N, int H, int d0, int dirs, int stage_rows, size_t smem, cudaStream_t stream) {
  void* args[] = {(void*)&x_proj, (void*)&mask, (void*)&w_hh, (void*)&w_lo,
                  (void*)&h0,     (void*)&c0,   (void*)&outs, (void*)&hbuf,
                  (void*)&c_out,  (void*)&F,    (void*)&N,    (void*)&H,
                  (void*)&d0,     (void*)&stage_rows};
  const cudaError_t err =
      cudaLaunchCooperativeKernel((const void*)lstm_bidi_kernel<U, P>, dim3(dirs * H / U),
                                  dim3(kThreads), args, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <int P>
int launch_units(const float* x_proj, const float* mask, const void* w_hh, const void* w_lo,
                 const float* h0, const float* c0, float* outs, float* hbuf, float* c_out,
                 int F, int N, int H, int units, int d0, int dirs, int stage_rows, size_t smem,
                 cudaStream_t s) {
  return units == 8 ? launch<8, P>(x_proj, mask, w_hh, w_lo, h0, c0, outs, hbuf, c_out, F, N, H,
                                   d0, dirs, stage_rows, smem, s)
                    : launch<4, P>(x_proj, mask, w_hh, w_lo, h0, c0, outs, hbuf, c_out, F, N, H,
                                   d0, dirs, stage_rows, smem, s);
}

}  // namespace

extern "C" {

// Once per device, before the first launch there (and outside any CUDA graph
// capture): checks that the card launches cooperative grids, lets the six
// instances (U=4 and U=8 at each of the three modes) use the card's opt-in
// shared memory per block, and checks that an SM holds one block of each
// with that much.  Writes the SM count and the opt-in limit in bytes to
// info[0..1].  Returns 0, a cudaError_t value, or a negative code above.
int lstm_bidi_prepare(int device, int* info) {
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

// Runs `dirs` directions (2: both, block b / (H / units) serving direction
// b / (H / units); 1: direction d0 alone) of one bidirectional layer over all
// F steps in one cooperative launch of dirs * H / units blocks on `stream`.
// h0, c0 (2, N, H) are read in place; outs (F, 2, N, H), hbuf (2, 2, N, H)
// and c_out (2, N, H) are written for the launch's directions: h after the
// last step in hbuf[F & 1], c in c_out.  mode (0 HIGHEST, 1 HIGH, 2
// DEFAULT): w_hh is f32 at HIGHEST (w_lo null), W_hh rounded to bf16 at
// DEFAULT, its bf16 hi parts at HIGH with w_lo the lo parts.  units (8, or 4
// where H % 8 == 4), stage_rows (HIGHEST: N, all rows staged at once, or a
// multiple of 16 below N, a ring of 16-row slots; else 16) and smem_bytes
// are the launch plan's; smem_bytes must equal the layout's size.  h0 and
// hbuf start on a 16-byte boundary.  Launches only: lstm_bidi_prepare must
// have run on the current device.  Returns 0, a cudaError_t value, or a
// negative code above.
int lstm_bidi_forward(const float* x_proj, const float* mask, const void* w_hh,
                      const float* h0, const float* c0, float* outs, float* hbuf, float* c_out,
                      int F, int N, int H, int units, int d0, int dirs, int stage_rows,
                      int smem_bytes, int mode, const void* w_lo, void* stream) {
  const size_t layout = mode == kHighest ? sizeof(float) * smem_floats(units, H, stage_rows)
                                         : mma_smem_bytes(units, H, mode == kHigh ? 2 : 1);
  if (F <= 0 || N <= 0 || H <= 0 || H % 4 != 0 || (units != 4 && units != 8) ||
      H % units != 0 || (dirs != 1 && dirs != 2) || d0 < 0 || d0 + dirs > 2 ||
      mode < kHighest || mode > kDefault || stage_rows <= 0 ||
      (mode == kHighest &&
       (stage_rows > N || (stage_rows != N && stage_rows % kPassRows != 0))) ||
      (mode != kHighest && stage_rows != kMmaRows) || (mode == kHigh && w_lo == nullptr) ||
      (size_t)smem_bytes != layout)
    return kErrBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes;
  if (mode == kHigh)
    return launch_units<kHigh>(x_proj, mask, w_hh, w_lo, h0, c0, outs, hbuf, c_out, F, N, H,
                               units, d0, dirs, stage_rows, smem, s);
  if (mode == kDefault)
    return launch_units<kDefault>(x_proj, mask, w_hh, w_lo, h0, c0, outs, hbuf, c_out, F, N, H,
                                  units, d0, dirs, stage_rows, smem, s);
  return launch_units<kHighest>(x_proj, mask, w_hh, w_lo, h0, c0, outs, hbuf, c_out, F, N, H,
                                units, d0, dirs, stage_rows, smem, s);
}

}  // extern "C"
