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
// and stays resident in B-fragment order.  Every block needs all of its
// direction's h[t-1] each step, so its bf16 form (hi; hi and lo at HIGH) is
// made once, by the thread that writes the f32 value, into a two-slot
// exchange buffer laid out as the A operand's k-step tiles; after the
// barrier one thread streams the step's 16-row chunks into a ring of
// shared-memory slots by bulk copies (the Tensor Memory Accelerator) on
// mbarriers, and the warps multiply each chunk as it lands, over 8 disjoint
// k-step sets; where a step has two chunks or more, two teams of 4 warps
// take them in turns, one team's epilogue beside the other's products.
// The sets' partial tiles meet in shared memory, summed in set order by one
// thread per (row, unit).  The cell's operands are read a chunk ahead, the
// first chunk's before the grid barrier.  The cell, masking and writes are
// the HIGHEST code's, in f32; no atomics.  The details: mma_body.
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

using lstm::bulk_copy;
using lstm::component;
using lstm::cp_async;
using lstm::cp_async_commit;
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
using lstm::wait_issued;
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

// Shared memory of a block at HIGH and DEFAULT (bytes), in this order: the
// B fragments of the block's columns of W_hh[d] (lstm_common.cuh, `parts`
// planes); a ring of stage_rows / 16 slots, each one 16-row chunk of h[t-1]
// in bf16 k-step tiles (`parts` planes); the ring's mbarriers and the count
// of its chunks issued (kRingSyncBytes: at most kMaxStages slots); two
// buffers of the partial tiles.  The same formula as
// ops/lstm_kernel.py::bidi_smem_bytes.
__host__ __device__ constexpr size_t mma_smem_bytes(int U, int H, int parts, int stage_rows) {
  return lstm::mma_matrix_bytes(U, H, parts) + (size_t)stage_rows * parts * lstm::kpad16(H) * 2 +
         kRingSyncBytes + 2 * lstm::mma_partial_bytes(U);
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

// What the steps of the HIGH and DEFAULT body share: the operands at the
// block's direction d and units j0 .., the exchange, and the block's shared
// memory (mma_body).
struct Sweep {
  const float* x_proj;  // (F, 2, N, 4H)
  const float* mask;    // (F, N)
  const float* h0;      // (2, N, H)
  const float* c0;      // (2, N, H)
  float* outs;          // (F, 2, N, H)
  float* hbuf;          // (2, 2, N, H)
  float* c_out;         // (2, N, H)
  unsigned short* x_d;  // direction d's two slots of the exchange (slot stride 2 kP x_part)
  int F, N, H, d, j0, KS, n_chunks, stages;
  size_t plane;   // bf16 of one part of a chunk
  size_t x_part;  // bf16 of one part of a state
  const uint2* w_b;                          // the B fragments
  __nv_bfloat16* ring;                       // the ring's slots
  unsigned long long *full, *empty;          // the ring's mbarriers
  unsigned* issued;                          // the chunks issued in the launch (thread 0 writes)
  float* part;                               // the two buffers of partial tiles
};

// The cell operands of a thread's (row, unit) of a chunk: x_proj's four
// gate columns, the mask, the old c and the old h.
struct CellOps {
  float x[4], m, c, h;
};

// The steps of the HIGH and DEFAULT body (see mma_body) with TEAMS teams of
// 8 / TEAMS warps, team g taking the chunks g, g + TEAMS, ...  With two
// teams and an odd slot count under the step's chunks, chunk c's slot held
// chunk c - stages of the other team, which may not have landed when a
// warp reaches chunk c: there a warp other than thread 0's first waits
// until chunk c is issued (`count`), when the chunk before it has landed
// (thread 0 waited for its readers), so the full mbarrier is one phase
// behind or done, never two behind, where the parity would pass early.
// Elsewhere the slot's chunk before is one the same warps read, or one of
// the step before, read before the grid barrier, and no count is kept (it
// cost 4-8% at N=64 on an H100).  (Thread 0's warp meets thread 0 at the
// team barrier after each of its issues.)  tests/test_torch_bidi_modes.py
// runs these waits in a model of the ring.
template <int U, int P, int TEAMS>
__device__ __forceinline__ void mma_steps(const Sweep& s, int tid) {
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
  const int N = s.N, H = s.H, KS = s.KS, n_chunks = s.n_chunks, stages = s.stages, d = s.d;
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
  // Chunk c's cell operands at step t into o (row c 16 + r, unit u).
  auto load = [&](CellOps& o, int t, int c) {
    const int n = c * kMmaRows + r;
    o.x[0] = o.x[1] = o.x[2] = o.x[3] = o.m = o.c = o.h = 0.0f;
    if (cell && n < N) {
      const float* x_n = s.x_proj + (((size_t)t * 2 + d) * N + n) * 4 * H + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) o.x[q] = __ldg(x_n + q * H);
      const size_t o_ = d * NH + (size_t)n * H + j;
      o.m = __ldg(s.mask + (size_t)t * N + n);
      o.c = (t == 0 ? s.c0 : s.c_out)[o_];
      o.h = t == 0 ? s.h0[o_] : s.hbuf[(size_t)(t & 1) * 2 * NH + o_];
    }
  };
  CellOps cur, nxt;
  load(nxt, 0, team);

  for (int t = 0; t < s.F; ++t) {
    const unsigned short* x_read = s.x_d + (size_t)(t & 1) * 2 * kP * s.x_part;
    unsigned short* x_write = s.x_d + (size_t)((t + 1) & 1) * 2 * kP * s.x_part;
    float* h_next = s.hbuf + ((size_t)((t + 1) & 1) * 2 + d) * NH;
    float* out_t = s.outs + ((size_t)t * 2 + d) * NH;
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
      // One team: a buffer per chunk in turn; two: a buffer per team.
      float* pb = s.part + (TEAMS == 1 ? c % 2 : team) * kPart;
      if constexpr (TEAMS > 1) team_sync();  // the team's epilogue of its chunk before is done
#pragma unroll
      for (int v = 0; v < TEAMS; ++v)
        lstm::store_partials<U>(pb, acc[v], tw + v * kTeamWarps, lane);
      team_sync();  // the chunk's partial tiles are stored (one team: those of c - 2 read)

      // Thread (r, u): its four gates' sums in set order, inputs,
      // nonlinearities, and the cell.
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
        const float i_g = sigmoid_f(pre[0] + cur.x[0]);
        const float f_g = sigmoid_f(pre[1] + cur.x[1]);
        const float g_g = tanhf(pre[2] + cur.x[2]);
        const float o_g = sigmoid_f(pre[3] + cur.x[3]);
        const size_t o = (size_t)n * H + j;
        const float c_new = f_g * cur.c + i_g * g_g;
        const float h_new = o_g * tanhf(c_new);
        const float h_sel = cur.m > 0.0f ? h_new : cur.h;
        h_next[o] = h_sel;
        s.c_out[d * NH + o] = cur.m > 0.0f ? c_new : cur.c;
        out_t[o] = h_new * cur.m;
        if (t + 1 < s.F) put_state<P>(x_write, s.x_part, n, j, KS, h_sel);
      }
      if (c + TEAMS >= n_chunks && t + 1 < s.F)
        load(nxt, t + 1, team);  // this thread's c and h of that chunk are written
    }
    if (t + 1 < s.F) {
      fence_proxy_async_global();  // the exchange's stores, before the other blocks' bulk copies
      grid.sync();                 // every block's rows of h[t] are written
    }
  }
}

// The HIGH and DEFAULT body (see the head note).
//   * The exchange.  xbuf holds 2 slots x 2 directions x parts x n_chunks
//     chunks x KS k-steps of 16x16 bf16 tiles (lstm_common.cuh): h of step
//     t, selected by the mask, goes in bf16 to slot (t + 1) & 1 from the
//     thread that writes its f32 value, and step t reads slot t & 1.  A
//     prologue writes h0's bf16 form into slot 0 (each block its own
//     columns) and the zeros of rows past N and of columns past H in both
//     slots, once per launch, and ends with a grid barrier.  Slot (t + 1) &
//     1 is next written in step t + 2, after the grid barrier of step t + 1,
//     which no block passes before its copies of step t + 1 have landed:
//     two slots suffice.
//   * The ring.  After the barrier, thread 0 issues one bulk copy per chunk
//     and part into a ring of `stages` slots (full / empty mbarriers per
//     slot, as the training reverse sweep's), as many chunks as there are
//     slots, and each later chunk into its slot once the warps are done
//     with the slot's chunk before.
//   * Teams.  Where a step has two chunks or more and the ring two slots,
//     warps 0-3 and 4-7 are two teams that take the chunks in turns, so one
//     team's epilogue runs beside the other's products; else one team of 8
//     warps takes every chunk.  With two teams on an odd slot count under
//     the step's chunks, thread 0 publishes the count of the chunks issued
//     after each issue, and the other warps wait for their chunk's count
//     before its full mbarrier (mma_steps).  The products of a chunk are split over 8
//     k-step sets, set w the k-steps w, w + 8, ..., a
//     warp of a team of 4 taking two of them; each set's partial tile goes
//     to shared memory (two buffers: one per team, or for one team one per
//     chunk in turn), and the epilogue sums the 8 in set order: the same
//     products in the same order as one staged chunk, so the same bits.
//   * The cell.  Thread (row r, unit u) of a team (16 U of its threads)
//     sums its unit's four gate columns, applies their nonlinearities and
//     writes its h, c and output; it reads the cell operands of its team's
//     next chunk while the current one is multiplied, the next step's first
//     chunk's before the grid barrier (none depends on another block's h).
template <int U, int P>
__device__ __forceinline__ void mma_body(const float* __restrict__ x_proj,
                                         const float* __restrict__ mask,
                                         const unsigned short* w_hi, const unsigned short* w_lo,
                                         const float* __restrict__ h0,
                                         const float* __restrict__ c0, float* __restrict__ outs,
                                         float* hbuf, float* c_out, unsigned short* xbuf, int F,
                                         int N, int H, int d0, int stages, float* smem) {
  constexpr int kP = kParts<P>;
  const int blocks_per_dir = H / U;
  const int dirs = gridDim.x / blocks_per_dir;
  const int d = d0 + blockIdx.x / blocks_per_dir;
  const int j0 = (blockIdx.x % blocks_per_dir) * U;
  const size_t NH = (size_t)N * H;
  const int KS = lstm::kpad16(H) / 16;  // k-steps of H
  const int n_chunks = (N + kMmaRows - 1) / kMmaRows;
  const size_t plane = (size_t)KS * kTile;         // bf16 of one part of a chunk
  const size_t x_part = (size_t)n_chunks * plane;  // bf16 of one part of a state
  auto slot_of = [&](int sl, int dd) { return xbuf + ((size_t)sl * 2 + dd) * kP * x_part; };
  const bool two_teams = n_chunks > 1 && stages > 1;
  uint2* w_b = reinterpret_cast<uint2*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<char*>(smem) +
                                                         lstm::mma_matrix_bytes(U, H, kP));
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + (size_t)stages * kP * plane);
  unsigned long long* empty = full + kMaxStages;
  unsigned* issued = reinterpret_cast<unsigned*>(empty + kMaxStages);
  const int tid = threadIdx.x;
  cg::grid_group grid = cg::this_grid();

  // The prologue: the B fragments, the mbarriers, h0's bf16 form and the
  // zeros of the exchange.
  const size_t off = (size_t)d * H * 4 * H;
  lstm::stage_b_fragments_vec<U, P>(w_b, w_hi + off, w_lo ? w_lo + off : nullptr, H, j0, tid,
                                    kThreads);
  if (tid < stages) {
    mbar_init(full + tid, 1);
    mbar_init(empty + tid, two_teams ? kWarps / 2 : kWarps);  // the warps of a team
  }
  if (tid == 0) *issued = 0;
  fence_mbarrier_init();
  for (int i = tid; i < N * U; i += kThreads) {
    const int n = i / U, j = j0 + i % U;
    put_state<P>(slot_of(0, d), x_part, n, j, KS, __ldg(h0 + d * NH + (size_t)n * H + j));
  }
  // The zeros: per (slot, direction, part) the rows past N of the last chunk
  // (all Kp columns), then the columns past H of rows 0 .. N - 1.
  const int pad_rows = n_chunks * kMmaRows - N, Kp = KS * 16, pad_cols = Kp - H;
  const size_t row_pads = (size_t)pad_rows * Kp, pads = row_pads + (size_t)N * pad_cols;
  for (size_t e = (size_t)blockIdx.x * kThreads + tid; e < 2 * dirs * kP * pads;
       e += (size_t)gridDim.x * kThreads) {
    const size_t region = e / pads, q = e % pads;
    const int n = q < row_pads ? N + (int)(q / Kp) : (int)((q - row_pads) / pad_cols);
    const int j = q < row_pads ? (int)(q % Kp) : H + (int)((q - row_pads) % pad_cols);
    unsigned short* x = slot_of((int)(region / kP / dirs), d0 + (int)(region / kP % dirs)) +
                        region % kP * x_part;
    x[exchange_index(n, j, KS)] = 0;
  }
  fence_proxy_async_global();  // the exchange's stores, before the bulk copies
  grid.sync();

  const Sweep sw{x_proj, mask, h0, c0, outs, hbuf, c_out, slot_of(0, d), F, N, H, d, j0, KS,
                 n_chunks, stages, plane, x_part, w_b, ring, full, empty, issued,
                 reinterpret_cast<float*>(reinterpret_cast<char*>(full) + kRingSyncBytes)};
  if (two_teams)
    mma_steps<U, P, 2>(sw, tid);
  else
    mma_steps<U, P, 1>(sw, tid);
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
                 int F, int N, int H, int d0, int stage_rows,
                 void* xbuf) {                      // HIGH, DEFAULT: the bf16 exchange buffer in
                                                    // k-step tiles, else null
  extern __shared__ __align__(16) float smem[];
  if constexpr (P == kHighest)
    fp32_body<U>(x_proj, mask, static_cast<const float*>(w_hh), h0, c0, outs, hbuf, c_out, F, N,
                 H, d0, stage_rows, smem);
  else
    mma_body<U, P>(x_proj, mask, static_cast<const unsigned short*>(w_hh),
                   static_cast<const unsigned short*>(w_lo), h0, c0, outs, hbuf, c_out,
                   static_cast<unsigned short*>(xbuf), F, N, H, d0, stage_rows / kMmaRows, smem);
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
           int N, int H, int d0, int dirs, int stage_rows, void* xbuf, size_t smem,
           cudaStream_t stream) {
  void* args[] = {(void*)&x_proj, (void*)&mask, (void*)&w_hh, (void*)&w_lo,
                  (void*)&h0,     (void*)&c0,   (void*)&outs, (void*)&hbuf,
                  (void*)&c_out,  (void*)&F,    (void*)&N,    (void*)&H,
                  (void*)&d0,     (void*)&stage_rows, (void*)&xbuf};
  const cudaError_t err =
      cudaLaunchCooperativeKernel((const void*)lstm_bidi_kernel<U, P>, dim3(dirs * H / U),
                                  dim3(kThreads), args, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <int P>
int launch_units(const float* x_proj, const float* mask, const void* w_hh, const void* w_lo,
                 const float* h0, const float* c0, float* outs, float* hbuf, float* c_out,
                 int F, int N, int H, int units, int d0, int dirs, int stage_rows, void* xbuf,
                 size_t smem, cudaStream_t s) {
  return units == 8 ? launch<8, P>(x_proj, mask, w_hh, w_lo, h0, c0, outs, hbuf, c_out, F, N, H,
                                   d0, dirs, stage_rows, xbuf, smem, s)
                    : launch<4, P>(x_proj, mask, w_hh, w_lo, h0, c0, outs, hbuf, c_out, F, N, H,
                                   d0, dirs, stage_rows, xbuf, smem, s);
}

// Shared memory of a block of the launch plan's layout (bytes).
size_t layout_bytes(int units, int H, int stage_rows, int mode) {
  return mode == kHighest ? sizeof(float) * smem_floats(units, H, stage_rows)
                          : mma_smem_bytes(units, H, mode == kHigh ? 2 : 1, stage_rows);
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

// Bytes of shared memory a block of the kernel takes at mode (0 HIGHEST, 1
// HIGH, 2 DEFAULT) with `units` units and stage_rows staged rows: the
// layout that lstm_bidi_forward holds smem_bytes to.
long long lstm_bidi_smem_bytes(int units, int H, int stage_rows, int mode) {
  return (long long)layout_bytes(units, H, stage_rows, mode);
}

// Runs `dirs` directions (2: both, block b / (H / units) serving direction
// b / (H / units); 1: direction d0 alone) of one bidirectional layer over all
// F steps in one cooperative launch of dirs * H / units blocks on `stream`.
// h0, c0 (2, N, H) are read in place; outs (F, 2, N, H), hbuf (2, 2, N, H)
// and c_out (2, N, H) are written for the launch's directions: h after the
// last step in hbuf[F & 1], c in c_out.  mode (0 HIGHEST, 1 HIGH, 2
// DEFAULT): w_hh is f32 at HIGHEST (w_lo and xbuf null), W_hh rounded to
// bf16 at DEFAULT, its bf16 hi parts at HIGH with w_lo the lo parts; at HIGH
// and DEFAULT xbuf is the exchange buffer, 2 x 2 x parts x ceil(N / 16) x
// kpad16(H) x 16 bf16 on a 16-byte boundary, whose contents the launch sets
// (no zeroing before it).  units (8, or 4 where H % 8 == 4), stage_rows
// (HIGHEST: N, all rows staged at once, or a multiple of 16 below N, a ring
// of 16-row slots; else 16 times the ring's slots, 1 to 8) and smem_bytes
// are the launch plan's; smem_bytes must equal the layout's size.  h0 and
// hbuf start on a 16-byte boundary.  Launches only: lstm_bidi_prepare must
// have run on the current device.  Returns 0, a cudaError_t value, or a
// negative code above.
int lstm_bidi_forward(const float* x_proj, const float* mask, const void* w_hh,
                      const float* h0, const float* c0, float* outs, float* hbuf, float* c_out,
                      int F, int N, int H, int units, int d0, int dirs, int stage_rows,
                      int smem_bytes, int mode, const void* w_lo, void* xbuf, void* stream) {
  if (F <= 0 || N <= 0 || H <= 0 || H % 4 != 0 || (units != 4 && units != 8) ||
      H % units != 0 || (dirs != 1 && dirs != 2) || d0 < 0 || d0 + dirs > 2 ||
      mode < kHighest || mode > kDefault || stage_rows <= 0 ||
      (mode == kHighest &&
       (stage_rows > N || (stage_rows != N && stage_rows % kPassRows != 0))) ||
      (mode != kHighest && (stage_rows % kMmaRows != 0 ||
                            stage_rows > kMaxStages * kMmaRows || xbuf == nullptr)) ||
      (mode == kHigh && w_lo == nullptr) ||
      (size_t)smem_bytes != layout_bytes(units, H, stage_rows, mode))
    return kErrBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes;
  if (mode == kHigh)
    return launch_units<kHigh>(x_proj, mask, w_hh, w_lo, h0, c0, outs, hbuf, c_out, F, N, H,
                               units, d0, dirs, stage_rows, xbuf, smem, s);
  if (mode == kDefault)
    return launch_units<kDefault>(x_proj, mask, w_hh, w_lo, h0, c0, outs, hbuf, c_out, F, N, H,
                                  units, d0, dirs, stage_rows, xbuf, smem, s);
  return launch_units<kHighest>(x_proj, mask, w_hh, w_lo, h0, c0, outs, hbuf, c_out, F, N, H,
                                units, d0, dirs, stage_rows, xbuf, smem, s);
}

}  // extern "C"
