// LSTM stack forward for Hopper (sm_90a): a whole unidirectional L-layer
// stack over F steps in one cooperative launch, in the stack schedule or the
// wavefront schedule.
//
// Replaces two Pallas TPU kernels of empose_tpu/ops/lstm_kernel.py:
//   * _pallas_forward (body _make_kernel), entry lstm_stack_forward: the
//     inference forward of the stack, one (step, layer) per phase;
//   * _pallas_wavefront (body _make_wavefront_kernel), entry
//     lstm_wavefront_forward: the same stack with layer l at time t - l in
//     phase t, so F + L - 1 phases instead of F * L.
// Gates in torch order (i, f, g, o).  Layer 0's gate input is the hoisted
// projection x0_proj (both biases folded in, computed outside as one GEMM);
// layer l >= 1's is prev_out @ W_ih[l] + b[l], prev_out being layer l-1's
// output h_new * mask.  Where mask == 0 the (h, c) state is selected, frozen
// bit for bit, and the step's output is h_new * mask.
//
// What bounds it on this card.  The recurrence is serial in time, and every
// step needs all (2L-1) weight matrices (12.6 MB at L=2, H=512).  With the
// weights resident on chip the least time is the fp32 FMA work,
// 2*F*N*H*4H*(2L-1) operations (0.096 ms at F=16, N=64, 2x512); beyond it
// each phase pays a grid barrier (1.5-2.8 us on an H100) and the staging of
// the rows of h it multiplies, which are written by every block just before
// the barrier and so cannot be prefetched.  The design is the bidirectional
// kernel's recurrence (csrc/lstm_bidi.cu) carried across the layer loop:
//   * Grid.  Each block owns U consecutive hidden units j of EVERY layer and
//     keeps their four gate columns {j, H+j, 2H+j, 3H+j} of every W_hh and of
//     W_ih of layers >= 1 resident in shared memory, laid out so that
//     neighbouring threads read neighbouring float4.  U=4 where H/4 blocks
//     fit on the SMs (2x512: 128 blocks of 96 KB of columns), else U=8 (one
//     layer of 1024: 128 blocks of 128 KB).  The launch plan
//     (ops/lstm_kernel.py::lstm_stack_plan) refuses a stack whose columns do
//     not fit (2x1024), which the wrapper then runs one layer per launch.
//   * Staging.  A phase multiplies the states of a run of layers: in the
//     stack order, phase (t, l) layer l's h after t-1 and, for l >= 1, layer
//     l-1's h after t (its output, up to the mask); in the wavefront order
//     phase p needs every active layer k's h after p-k-1, and each staged
//     state serves twice: as layer k's recurrent operand and as layer k+1's
//     input, from ONE staging.  In the stack order at two layers the same
//     holds across phases: phase (t, 1) stages layer 0's h after t as its
//     input, and phase (t + 1, 0) multiplies the rows still in shared memory
//     in place (all of them where every row is staged at once, 2x512: N <=
//     32; else the last chunk of each team's ring) and copies only the rest.
//     The rows are copied by 16-byte cp.async.cg (through L2, never a stale
//     L1), one copy group per chunk of 16 rows holding every operand's rows
//     of the chunk; the pass over chunk c waits only for chunk c's group.
//     Where the rows do not fit beside the columns, the chunks cycle through
//     a ring of 16-row slots, the next in flight while the current one is
//     multiplied; with one slot a chunk is copied only once every thread is
//     done with the one before.  So any N runs.  h0 is read in place at the
//     first step.
//   * Teams.  At U=4 a block runs two teams of 8 warps (512 threads of at
//     most 128 registers each), which take a phase's chunks in turns, each
//     with its own share of the ring and its own named barrier, so that one
//     team's tile epilogue and staging wait overlap the other's FMAs (faster
//     at N=64 on an H100 than one team of 256 threads); a phase of one
//     chunk, or a one-slot ring, runs one team.  U=8 runs one team (its
//     64-sum tiles spill at 128 registers).
//   * FMAs.  Warp (unit pair, row group) multiplies its rows of the chunk by
//     the eight gate columns of its two units, lane l over the float4
//     columns l, l + 32, ... of H; a staged value is read from shared memory
//     once per unit pair, and the columns straight from their resident copy
//     (holding a share of them in registers for the whole sweep, as the
//     bidirectional kernel does, was no faster on an H100 at any shape
//     timed).  At U=8 a warp's 8 rows of a chunk are one register tile of
//     64 sums, at U=4 its 4 rows one of 32; fewer rows take 4, 2 and 1-row
//     tiles, so no FMA and no shared load falls on a row beyond N.  A layer
//     l >= 1 adds its input product first, scales each row's sums by the
//     row's mask (the input is h_new * mask, and the staged row is the
//     state, h_new where the mask is 1), then its recurrent product, into
//     the same tile.  The kernel's pointers stay in parameter space
//     (StackArgs) until a tile's epilogue needs them.
//   * Sums and cell, in the warp.  The partial sums meet in a fixed-order
//     warp reduce-scatter (lstm_common.cuh), each lane adds its gate input
//     (x0_proj or the bias, read before the FMAs) and applies its gate's
//     nonlinearity, and the first lane of each (row, unit) gathers the four
//     gates and writes h, c and the output: no atomics and no shared memory,
//     so two launches on the same inputs give the same bits.  c0 is read in
//     place at the first step; c then lives in c_out, each element read and
//     written by the same lane.
//   * One grid barrier per phase, none after the last: F * L in the stack
//     order, F + L - 1 in the wavefront order.
// That is the HIGHEST instance (fp32 FMAs on the CUDA cores, the fp32 parity
// mode).  The third template argument P selects the mode (lstm_common.cuh):
// at HIGH and DEFAULT the recurrent product and layer l >= 1's input product
// (JAX's w_ih_up) run on the tensor cores, mma.sync m16n8k16 bf16 with f32
// accumulation (wgmma's 64-row tiles exceed serving's rows).  The wrapper
// hands in the weights already rounded (DEFAULT) or split into a bf16 hi/lo
// pair (HIGH), as JAX pre-splits them outside its kernel; the block keeps its
// columns in B-fragment order (half of HIGHEST's bytes at DEFAULT, the same
// at HIGH).  Gates, cell update and masking are the HIGHEST code's, in f32;
// the same schedule and grid barriers, no atomics: two launches give the
// same bits.  Both orders run one body (ring_body): every block needs all N
// rows of the layer states it multiplies, so their bf16 form is made once,
// by the thread that writes the f32 value, into a two-slot exchange per
// layer laid out as the A operand's k-step tiles; after each grid barrier
// one thread streams the phase's 16-row chunks of each staged state (once
// each, in the wavefront order too) into a ring of shared-memory slots by
// bulk copies (the Tensor Memory Accelerator) on mbarriers, and the warps
// multiply each chunk as it lands, over 8 disjoint k-step sets; where a
// phase has two chunks or more and the ring more slots than a chunk has
// items, two teams of 4 warps take them in turns, one team's epilogue
// beside the other's products.  The sets' partial tiles meet in shared
// memory, summed in set order by one thread per (row, unit).  The block's
// columns come in by wide loads (stage_b_fragments_vec).  The details:
// ring_body.
// The grid must be co-resident for the barrier: lstm_stack_prepare sets the
// kernel's shared memory and checks its occupancy once per device, the plan
// keeps the grid within the SMs, and the C entries only launch
// (cudaLaunchCooperativeKernel): no attribute or device query per call, so
// a call can be captured in a CUDA graph.

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

constexpr int kTeamThreads = 256;  // threads of a team: 8 warps
constexpr int kTeamWarps = kTeamThreads / 32;
constexpr int kPassRows = 16;  // rows of a staged chunk
constexpr int kUnitPair = 2;   // units a warp multiplies at once

// Teams of 256 threads of a block of the HIGHEST body, at most (see the head
// note): U=4 runs two, U=8 one.
template <int U>
constexpr int kTeams = U == 4 ? 2 : 1;
template <int U>
constexpr int kBlockThreads = kTeamThreads * kTeams<U>;

// The HIGH and DEFAULT body (ring_body) runs blocks of 8 warps (one team of
// 8, or two of 4) at every U, in both orders, and a ring of at most
// kMaxStages slots (its mbarriers and the count of the items issued:
// kRingSyncBytes, lstm_common.cuh).
constexpr int kRingThreads = 256;
constexpr int kRingWarps = kRingThreads / 32;
template <int U, int P>
constexpr int kKernelThreads = P != kHighest ? kRingThreads : kBlockThreads<U>;

// Error codes beside cudaError_t values (which are >= 0); the same values
// as lstm_bidi.cu and lstm_train.cu.
constexpr int kErrGridTooLarge = -1;
constexpr int kErrNoCooperative = -3;
constexpr int kErrBadShape = -4;

// Whether instance U runs stacks of more than one layer.  U=8 runs one layer
// only: it is taken where H > 528 (H / 4 blocks do not fit on 132 SMs), and
// there the columns of two layers (3 * 128 H bytes) leave no room for one
// 16-row slot of two staged states.
template <int U>
constexpr bool kStacked = U == 4;

// State planes staged per phase: the stack order multiplies at most two
// layers' states (layer l's and layer l-1's), the wavefront order all L.
__host__ __device__ constexpr int stage_planes(int L, bool wave) {
  return wave ? L : (L < 2 ? L : 2);
}

// Shared memory of a block (floats), in this order:
//   w_s  [2L-1][4][U][H], each matrix to 128 bytes: the block's gate columns
//        of matrix m; the float4 of unit u's four gates at row k = 4c + q
//        sits at m * round32(4UH) + (q * U + u) * H + 4c
//   h_s  [planes][stage_rows][H]: plane o holds the staged rows of the
//        phase's o-th state, all N, or a ring of stage_rows / 16 chunk slots
// The same formula as ops/lstm_kernel.py::stack_smem_bytes.
__host__ __device__ constexpr size_t smem_floats(int U, int H, int L, int planes,
                                                 int stage_rows) {
  return (size_t)(2 * L - 1) * round32((size_t)4 * U * H) + (size_t)planes * stage_rows * H;
}

// Shared memory of a block at HIGH and DEFAULT, in both orders (bytes), in
// this order: the B fragments of the 2L - 1 matrices; a ring of
// `stages` slots, each one state's 16-row chunk in bf16 k-step tiles
// (`parts` planes); the ring's mbarriers and the count of its items issued
// (kRingSyncBytes); two buffers of the partial tiles.  The same formula as
// ops/lstm_kernel.py::stack_ring_smem_bytes.
__host__ __device__ constexpr size_t ring_smem_bytes(int U, int H, int L, int parts, int stages) {
  return (size_t)(2 * L - 1) * lstm::mma_matrix_bytes(U, H, parts) +
         (size_t)stages * parts * lstm::kpad16(H) * kMmaRows * 2 + kRingSyncBytes +
         2 * lstm::mma_partial_bytes(U);
}

// The kernel's arguments, passed as one struct in parameter space: a piece
// reads its pointers from there where it needs them, so they hold no
// registers across the FMAs.
struct StackArgs {
  const float* x0_proj;  // (F, N, 4H)
  const float* mask;     // (F, N)
  const void* w_hh;      // (L, H, 4H): f32 at HIGHEST, else bf16 (hi)
  const void* w_ih_up;   // (L-1, H, 4H) or null, the same type
  const void* w_hh_lo;   // HIGH: the bf16 lo parts of w_hh, else null
  const void* w_ih_up_lo;  // HIGH: the bf16 lo parts of w_ih_up, else null
  const float* b_up;     // (L-1, 4H) or null
  const float* h0;       // (L, N, H)
  const float* c0;       // (L, N, H)
  float* outs;           // (F, N, H)
  float* hbuf;           // (2, L, N, H): layer l's h after step t in hbuf[(t + 1) & 1][l]
  float* c_out;          // (L, N, H): c, cF at the end
  int F, N, H, L, stage_rows, teams;
  void* xbuf;  // at HIGH and DEFAULT: the bf16 exchange (ring_body), else null
};

// acc += the NP staged rows `rows` (stride H) times the eight gate columns
// of units u0, u0 + 1 of one matrix (w4: the block's resident columns of it
// as float4).  Lane l multiplies the float4 columns l, l + 32, ... of H.
template <int U, int NP>
__device__ __forceinline__ void fma_tile(float* acc, const float* rows, const float4* w4, int u0,
                                         int lane, int C4) {
  constexpr int UP = kUnitPair;
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  for (int c = lane; c < C4; c += 32) {
    float4 w[UP][4];
#pragma unroll
    for (int ui = 0; ui < UP; ++ui)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[ui][q] = w4[(q * U + u0 + ui) * C4 + c];
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
  }
}

// One warp's piece of a layer's step: NP staged rows (global rows n0 ...)
// of the recurrent operand `rec` and, for a layer >= 1, of the input `inp`,
// times the gate columns of its units u0, u0 + 1.  The warp's V = 4 UP NP
// <= 64 sums, value (row r, unit ui, gate g) being (r UP + ui) 4 + g, are
// scattered over the lanes: where V <= 32 lane l holds value l / kC (kC =
// 32 / V lanes hold each), where V = 64 it holds values 2l and 2l + 1.  Each
// lane adds its gate input and applies its gate's nonlinearity, and the
// first lane of each (row, unit) gathers the four gates and writes its h, c
// and output.
template <int U, int NP>
__device__ __forceinline__ void step_piece(const StackArgs& a, int l, int t, const float* rec,
                                           const float* inp, int n0, const float* w_s, size_t ws,
                                           int j0, int u0, int lane) {
  constexpr int UP = kUnitPair;
  constexpr int V = 4 * UP * NP;
  constexpr int kPer = V > 32 ? V / 32 : 1;  // sums a lane ends with
  constexpr int kC = V < 32 ? 32 / V : 1;    // lanes holding the same sum
  constexpr int kCell = 4 / kPer * kC;       // lanes holding one (row, unit)'s four gates
  static_assert(V <= 64, "a piece holds at most 64 sums");
  const int H = a.H;
  const int C4 = H / 4;
  const int idx = lane / kC * kPer;  // the lane's first value
  const int g = idx % 4;             // its gate; the lane's value k has gate g + k
  const int u = u0 + idx / 4 % UP;
  const int r_own = idx / (4 * UP);
  const int n = n0 + r_own;
  const int j = j0 + u;
  const bool lead = lane % kCell == 0;
  const float* mask_t = a.mask + (size_t)t * a.N;

  // The cell's operands, read before the FMAs so that their latency hides
  // behind them: the gate input (x0_proj for layer 0, the bias above), the
  // mask, the old c; the old h of a masked row is its staged row.
  float x[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    x[k] = __ldg(l == 0 ? a.x0_proj + ((size_t)t * a.N + n) * 4 * H + (g + k) * H + j
                        : a.b_up + (size_t)(l - 1) * 4 * H + (g + k) * H + j);
  float m = 0.0f, c_old = 0.0f, h_old = 0.0f;
  if (lead) {
    h_old = rec[(size_t)r_own * H + j];
    m = __ldg(mask_t + n);
    c_old = (t == 0 ? a.c0 : a.c_out)[((size_t)l * a.N + n) * H + j];
  }

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  if (kStacked<U> && l > 0) {  // the input product, with W_ih[l] (matrix L + l - 1)
    fma_tile<U, NP>(acc, inp, reinterpret_cast<const float4*>(w_s + (a.L + l - 1) * ws), u0,
                    lane, C4);
    // The input is layer l-1's output h_new * mask; the staged row is its
    // state, h_new where the mask is 1 (and the old h where it is 0).
#pragma unroll
    for (int r = 0; r < NP; ++r) {
      const float mr = __ldg(mask_t + n0 + r);
#pragma unroll
      for (int i = 0; i < 4 * UP; ++i) acc[r * 4 * UP + i] *= mr;
    }
  }
  fma_tile<U, NP>(acc, rec, reinterpret_cast<const float4*>(w_s + l * ws), u0, lane, C4);
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
  for (int q = 0; q < 4; ++q)
    gate[q] = __shfl_sync(0xffffffffu, act[q % kPer], base + q / kPer * kC);
  if (lead) {
    const float c_new = gate[1] * c_old + gate[0] * gate[2];
    const float h_new = gate[3] * tanhf(c_new);
    const size_t NH = (size_t)a.N * H;
    const size_t off = (size_t)n * H + j;
    a.hbuf[((size_t)((t + 1) & 1) * a.L + l) * NH + off] = m > 0.0f ? h_new : h_old;
    a.c_out[l * NH + off] = m > 0.0f ? c_new : c_old;
    if (l == a.L - 1) a.outs[t * NH + off] = h_new * m;
  }
}

// Block b owns units j0 = b * U, ... of every layer.  Team tid / 256 takes
// chunks team, team + teams, ...; its warps: unit pair warp % (U / 2)
// (units u0, u0 + 1), row group warp / (U / 2); the rows of a 16-row chunk
// are split over the row groups, U rows each, which a warp multiplies as one
// tile where all of them exist, else in tiles of 4, 2 and 1 rows.
//
// Phases.  The stack order runs phase (t, l) = (ph / L, ph % L); the
// wavefront order runs in phase p every layer l with 0 <= p - l < F at time
// t = p - l.  Either way a phase has a wave index p (t + l) and a run of
// active layers [l_first, l_last], and stages the states of layers lo =
// max(0, l_first - 1) ... l_last, layer k's after step p - k - 1 (h0 in
// place before the first step): layer l's recurrent operand is plane l - lo,
// its input plane l - 1 - lo.  Layer l's h after step t lies in hbuf[(t + 1)
// & 1][l], so no slot is read and written in one phase.
template <int U, bool kWave>
__device__ __forceinline__ void fp32_body(const StackArgs& a, float* smem) {
  const int F = a.F, N = a.N, H = a.H, L = a.L, stage_rows = a.stage_rows, teams = a.teams;
  constexpr int UP = kUnitPair;
  constexpr int kRowsW = kPassRows * U / UP / kTeamWarps;  // rows of a chunk per warp: U
  static_assert(U == 4 || U == 8, "a warp's rows of a chunk are one tile of at most 64 sums");
  const int n_mats = 2 * L - 1;
  const size_t ws = round32((size_t)4 * U * H);
  const size_t NH = (size_t)N * H;
  const int H4 = 4 * H;
  float* w_s = smem;
  float* h_s = w_s + n_mats * ws;

  const int tid = threadIdx.x;
  const int team = tid / kTeamThreads;
  const int ttid = tid % kTeamThreads;  // the thread within its team
  const int lane = tid % 32;
  const int warp = ttid / 32;
  const int u0 = warp % (U / UP) * UP;
  const int row_lo = warp / (U / UP) * kRowsW;
  const int j0 = blockIdx.x * U;
  const int n_chunks = (N + kPassRows - 1) / kPassRows;
  const int slots = (stage_rows + kPassRows - 1) / kPassRows;
  // The team's chunks team, team + teams, ... (its i-th is chunk team + teams * i) and
  // its slots: a ring of slots / teams where the rows do not all fit, else one per chunk.
  const int my_chunks = (n_chunks - team + teams - 1) / teams;
  const int my_slots = (slots - team + teams - 1) / teams;
  const int first = min(my_slots, my_chunks);  // chunks issued at the start of a phase
  auto team_sync = [&]() {  // named barrier 1 + team of the team's 256 threads
    if (team == 0)
      asm volatile("bar.sync 1, %0;\n" ::"n"(kTeamThreads) : "memory");
    else
      asm volatile("bar.sync 2, %0;\n" ::"n"(kTeamThreads) : "memory");
  };
  cg::grid_group grid = cg::this_grid();

  for (int mi = 0; mi < n_mats; ++mi) {
    const float* src = mi < L ? static_cast<const float*>(a.w_hh) + (size_t)mi * H * H4
                              : static_cast<const float*>(a.w_ih_up) + (size_t)(mi - L) * H * H4;
    float* dst = w_s + mi * ws;
    for (int idx = tid; idx < 4 * U * H; idx += teams * kTeamThreads) {
      const int qu = idx / H;
      const int k = (idx % H) / 4 * 4 + qu / U;
      dst[idx] = src[(size_t)k * H4 + (idx % 4) * H + j0 + qu % U];
    }
  }
  __syncthreads();
  const int n_phases = kWave ? F + L - 1 : F * L;
  for (int ph = 0; ph < n_phases; ++ph) {
    const int l_first = kWave ? max(0, ph - F + 1) : ph % L;
    const int l_last = kWave ? min(L - 1, ph) : ph % L;
    const int wave = kWave ? ph : ph / L + l_first;
    const int lo = max(0, l_first - 1);
    const int n_ops = l_last - lo + 1;

    // The team's i-th chunk, one copy group, holding the chunk's rows of
    // every staged state.
    auto issue = [&](int i) {
      const int c = team + teams * i;
      const int r0 = c * kPassRows;
      const int cr = min(kPassRows, N - r0);
      for (int o = 0; o < n_ops; ++o) {
        const int k = lo + o;
        const int tau = wave - k - 1;  // the step after which layer k's state is read
        const float* src =
            (tau < 0 ? a.h0 + k * NH : a.hbuf + ((size_t)((tau + 1) & 1) * L + k) * NH) +
            (size_t)r0 * H;
        float* dst = h_s + ((size_t)o * stage_rows + (size_t)(c % slots) * kPassRows) * H;
        for (int e = 4 * ttid; e < cr * H; e += 4 * kTeamThreads) cp_async<16>(dst + e, src + e);
      }
      cp_async_commit();
    };
    // In the stack order at two layers, phase (t, 0) multiplies layer 0's h
    // after t - 1, which phase (t - 1, 1) staged as its input in plane 0: the
    // team's chunks still in their slots (the last my_slots it read, all of
    // them where every row is staged at once) are read in place, and the
    // phase takes the team's chunks in reverse order, those first.  Each
    // team reads only chunks it staged and waited for itself.
    const bool reuse = !kWave && L == 2 && l_first == 0 && ph > 0;
    const int resident = reuse ? min(my_slots, my_chunks) : 0;
    auto chunk_of = [&](int j) { return reuse ? my_chunks - 1 - j : j; };  // the j-th taken
    const int issued = resident ? 0 : first;
    for (int j = 0; j < issued; ++j) issue(chunk_of(j));
    int groups = issued;

    for (int j = 0; j < my_chunks; ++j) {
      // The j-th chunk taken is the (j - resident)-th copy group issued.
      if (my_slots == 1) {  // a one-slot ring: each chunk goes where the one before was read
        if (j > 0 && j >= resident) {
          team_sync();  // every thread of the team is done with the chunk before
          issue(chunk_of(j));
          ++groups;
        }
        if (j >= resident) {
          cp_async_wait_upto(groups - (j - resident) - 1);  // the chunk has landed
          team_sync();                                      // ... for every thread of the team
        }
      } else {
        if (j >= resident) cp_async_wait_upto(groups - (j - resident) - 1);
        team_sync();  // the chunk is there for the team, which is done with the one before
        if (j > 0 && j - 1 + my_slots < my_chunks) {
          issue(chunk_of(j - 1 + my_slots));  // into that one's slot, while this one is read
          ++groups;
        }
      }
      const int i = chunk_of(j);
      const int c = team + teams * i;
      const int r0 = c * kPassRows;
      const size_t slot_off = (size_t)(c % slots) * kPassRows * H;
      for (int l = l_first; l <= l_last; ++l) {
        const int t = wave - l;
        const float* rec = h_s + (size_t)(l - lo) * stage_rows * H + slot_off;
        const float* inp = l > 0 ? h_s + (size_t)(l - 1 - lo) * stage_rows * H + slot_off : nullptr;
        int lr = row_lo;
        int nr = max(0, min(kRowsW, N - r0 - lr));
        if (nr == kRowsW) {
          step_piece<U, kRowsW>(a, l, t, rec + (size_t)lr * H, inp ? inp + (size_t)lr * H : nullptr,
                                r0 + lr, w_s, ws, j0, u0, lane);
          nr = 0;
        }
        if constexpr (kRowsW > 4) {
          if (nr & 4) {
            step_piece<U, 4>(a, l, t, rec + (size_t)lr * H, inp ? inp + (size_t)lr * H : nullptr,
                             r0 + lr, w_s, ws, j0, u0, lane);
            lr += 4;
          }
        }
        if (nr & 2) {
          step_piece<U, 2>(a, l, t, rec + (size_t)lr * H, inp ? inp + (size_t)lr * H : nullptr,
                           r0 + lr, w_s, ws, j0, u0, lane);
          lr += 2;
        }
        if (nr & 1)
          step_piece<U, 1>(a, l, t, rec + (size_t)lr * H, inp ? inp + (size_t)lr * H : nullptr,
                           r0 + lr, w_s, ws, j0, u0, lane);
      }
    }

    if (ph + 1 < n_phases) grid.sync();  // every block's rows of this phase's states are written
  }
}

// The cell operands of a thread's (row, unit) of a chunk at a phase: the
// four gate inputs (x0_proj's columns for layer 0, the bias above), the
// mask, the old c and the old h.
struct CellOps {
  float x[4], m, c, h;
};

// What the phases of the HIGH and DEFAULT body share: the block's shared
// memory (ring_body).
struct Ring {
  int KS, n_chunks, stages;
  size_t plane;   // bf16 of one part of a state's chunk
  size_t x_part;  // bf16 of one part of a state in the exchange
  size_t mat;     // B fragments (uint2) of one matrix
  const uint2* w_b;                  // the B fragments of the 2L - 1 matrices
  __nv_bfloat16* ring;               // the ring's slots
  unsigned long long *full, *empty;  // the ring's mbarriers
  unsigned* issued;                  // the items issued in the launch (thread 0 writes)
  float* part;                       // the two buffers of partial tiles
};

// A phase of either order (fp32_body's phases): its wave index and its run
// of active layers [l_first, l_last].  It stages the states of layers lo =
// max(0, l_first - 1) ... l_last, layer k's after step wave - k - 1.  Both
// orders start at phase {0, 0, 0}; the stack order runs phase (t, l) as
// {t + l, l, l}, the wavefront order phase p as {p, max(0, p - F + 1),
// min(L - 1, p)}.
struct Phase {
  int wave, l_first, l_last;
};
template <bool kWave>
__device__ __forceinline__ Phase next_phase(const Phase& q, int F, int L) {
  if constexpr (kWave)
    return Phase{q.wave + 1, max(0, q.wave + 2 - F), min(L - 1, q.wave + 1)};
  else if (q.l_first + 1 < L)
    return Phase{q.wave + 1, q.l_first + 1, q.l_first + 1};
  else
    return Phase{q.wave + 2 - L, 0, 0};
}

// Whether a phase of n_chunks chunks of ipc items each, taken in turns by
// two teams (chunk c by team c % 2), keeps the count of the items issued on
// a ring of `stages` slots: where some item i >= stages finds its slot's
// item before, i - stages, in a chunk of the other team, which may still be
// in flight when a warp of this team waits for item i.  A slot's other
// items before are this team's, read before, or an earlier phase's, landed
// before its grid barrier.  The chunks' difference repeats with period ipc
// in i.  The same rule as tests/torch_ring_model.py count_needed.
__device__ __forceinline__ bool count_needed(int n_chunks, int stages, int ipc) {
  for (int i = stages; i < n_chunks * ipc && i < stages + ipc; ++i)
    if ((i / ipc - (i - stages) / ipc) % 2 != 0) return true;
  return false;
}

// The phases of the HIGH and DEFAULT body (see ring_body) in the stack order
// or (kWave) the wavefront order, with TEAMS teams of 8 / TEAMS warps, team g
// taking the chunks g, g + TEAMS, ... of every phase and, in each chunk, the
// phase's active layers in order.  With kReuse (the stack order at two
// layers, where the ring holds every item of a phase at once) phase (t, 0)
// multiplies layer 0's state after t - 1 in place: phase (t - 1, 1) copied
// it as its chunks' input.  Then item i of a phase (t, 1) sits in slot i,
// and phase (0, 0) copies chunk c into slot 2c.
template <int U, int P, int TEAMS, bool kReuse, bool kWave>
__device__ __forceinline__ void ring_phases(const StackArgs& a, const Ring& s, int tid) {
  constexpr int C = 4 * U;   // the block's gate columns of a matrix
  constexpr int NT = U / 2;  // their n8 tiles
  constexpr int kP = kParts<P>;
  constexpr int kPart = lstm::mma_partial_bytes(U) / sizeof(float);
  constexpr int kTW = kRingWarps / TEAMS;  // warps of a team
  constexpr int kTT = kRingThreads / TEAMS;
  static_assert(kRingWarps == lstm::kMmaWarps, "one k-step set per warp, two per warp of a team of 4");
  static_assert(kMmaRows * U <= kTT, "a thread per (row, unit) of a chunk");
  static_assert(!(kReuse && kWave), "the wavefront order stages each state once a phase");
  const int lane = tid % 32, warp = tid / 32;
  const int team = warp / kTW, tw = warp % kTW, ttid = tid % kTT;
  // Epilogue thread ttid < 16 U: row r = ttid / U, unit u = ttid % U.
  const bool cell = ttid < kMmaRows * U;
  const int r = ttid / U, u = ttid % U, j = blockIdx.x * U + u;
  const int F = a.F, N = a.N, H = a.H, L = a.L, KS = s.KS, n_chunks = s.n_chunks;
  const int stages = s.stages;
  const size_t NH = (size_t)N * H;
  const unsigned chunk_bytes = (unsigned)s.plane * 2;
  unsigned short* xbuf = static_cast<unsigned short*>(a.xbuf);
  // Slot sl of layer k's state in the exchange.
  auto layer_slot = [&](int sl, int k) { return xbuf + ((size_t)sl * L + k) * kP * s.x_part; };
  cg::grid_group grid = cg::this_grid();
  // The team's threads meet (named barrier 1 + team; one team: the block).
  auto team_sync = [&]() {
    if constexpr (TEAMS == 1)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "n"(kTT) : "memory");
  };
  // Chunk c's cell operands of layer l at step t into o (row c 16 + r, unit u).
  auto load = [&](CellOps& o, int t, int l, int c) {
    const int n = c * kMmaRows + r;
    o.x[0] = o.x[1] = o.x[2] = o.x[3] = o.m = o.c = o.h = 0.0f;
    if (cell && n < N) {
      const float* x_n = l == 0 ? a.x0_proj + ((size_t)t * N + n) * 4 * H + j
                                : a.b_up + (size_t)(l - 1) * 4 * H + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) o.x[q] = __ldg(x_n + q * H);
      const size_t off = l * NH + (size_t)n * H + j;
      o.m = __ldg(a.mask + (size_t)t * N + n);
      o.c = (t == 0 ? a.c0 : a.c_out)[off];
      o.h = t == 0 ? a.h0[off] : __ldcg(a.hbuf + (size_t)(t & 1) * L * NH + off);
    }
  };
  CellOps cur, nxt;
  load(nxt, 0, 0, team);  // phase 0: layer 0 at step 0
  // Where a slot's item before may be the other team's and in flight
  // (count_needed), thread 0 publishes the count of the items issued after
  // each, and a warp other than thread 0's first waits until its item is
  // issued: the slot's item before has landed then (thread 0 waited for its
  // readers), so the full mbarrier is one phase behind or done, never two
  // behind, where the parity would pass early.  tests/torch_ring_model.py
  // models these waits.  Bit k: the phases of k items a chunk keep the count.
  unsigned counted = 0;
  if constexpr (TEAMS > 1 && !kReuse)
    for (int k = 1; k <= (kWave ? min(L, 31) : 2); ++k)
      if (count_needed(n_chunks, stages, k)) counted |= 1u << k;

  const int n_phases = kWave ? F + L - 1 : F * L;
  int base = 0;  // the items of the launch before the phase's
  Phase q{0, 0, 0};
  for (int ph = 0; ph < n_phases; ++ph, q = next_phase<kWave>(q, F, L)) {
    // The phase's items, one state's chunk each: chunk c's state of layer k
    // (lo <= k <= l_last) as item c ipc + k - lo; so in the stack order at l
    // >= 1 chunk c's input as item 2c and its recurrent operand as item 2c +
    // 1, at layer 0 its recurrent operand as item c.  Item i is the (base +
    // i)-th of the launch.
    const int lo = max(0, q.l_first - 1);
    const int ipc = kWave ? q.l_last - lo + 1 : (kStacked<U> && q.l_first > 0 ? 2 : 1);
    const int l_last = kWave ? q.l_last : q.l_first;
    const int n_items = kReuse && q.l_first == 0 && q.wave > 0 ? 0 : n_chunks * ipc;
    const bool count = ipc < 32 ? (counted >> ipc) & 1u
                                : TEAMS > 1 && !kReuse && count_needed(n_chunks, stages, ipc);
    // Item i's slot and the count of the slot's copies before it (its full
    // mbarrier's phase).  With reuse slot 2c is copied at phase (0, 0) and
    // at every phase (t, 1), slot 2c + 1 at every phase (t, 1); phase (t >
    // 0, 0) reads slot 2c's copy of phase (t - 1, 1).
    auto slot_use = [&](int i, int& slot, int& use) {
      const int t = q.wave - q.l_first;
      if constexpr (!kReuse) {
        slot = (base + i) % stages;
        use = (base + i) / stages;
      } else if (q.l_first == 0) {
        slot = 2 * i;
        use = t;
      } else {
        slot = i;
        use = t + (i % 2 == 0);
      }
    };
    // The phase's next item into its slot: one bulk copy a part, issued by
    // thread 0 once the warps are done with the slot's previous item (with
    // reuse every item is issued after the grid barrier, when they are).
    // Layer k's state after step wave - k - 1 lies in slot (wave - k) & 1 of
    // layer k.  Thread 0 counts the phase's items issued and keeps the next
    // one's chunk and layer.
    int issued = 0, next_c = 0, next_k = lo;
    auto issue_next = [&]() {
      const int i = issued++;
      int slot, use;
      slot_use(i, slot, use);
      if (!kReuse && use > 0) mbar_wait(s.empty + slot, (use - 1) & 1);
      mbar_expect_tx(s.full + slot, kP * chunk_bytes);
      const unsigned short* src =
          layer_slot((q.wave - next_k) & 1, next_k) + (size_t)next_c * s.plane;
#pragma unroll
      for (int p = 0; p < kP; ++p)
        bulk_copy(s.ring + ((size_t)slot * kP + p) * s.plane, src + p * s.x_part, chunk_bytes,
                  s.full + slot);
      if (count) store_release(s.issued, base + i + 1);
      if (next_k++ == l_last) {
        next_k = lo;
        ++next_c;
      }
    };
    if (tid == 0) {
      fence_proxy_async_global();
      while (issued < min(stages, n_items)) issue_next();
    }
    // acc[v] += item i times matrix mi over the k-step sets tw (and tw + 4
    // in a team of 4 warps).  The warp waits for the item at its first use
    // and frees its slot after its last (in the wavefront order layer k's
    // state is multiplied by W_hh[k], then as layer k + 1's input by W_ih[k
    // + 1]); then thread 0 issues every item whose slot's previous item is
    // this one or older.  With two teams the ring has more slots than a
    // chunk has items (the plan), so team 0's next chunk is issued by then.
    auto product = [&](float(&acc)[TEAMS][NT][4], int i, int mi, bool first, bool last) {
      int slot, use;
      slot_use(i, slot, use);
      if (first) {
        if (count && warp > 0) wait_issued(s.issued, base + i, lane);
        mbar_wait(s.full + slot, use & 1);  // item i has landed
        __syncwarp();                       // the warp's lanes together again
      }
      const __nv_bfloat16* A = s.ring + (size_t)slot * kP * s.plane;
      const uint2* B = s.w_b + (size_t)mi * s.mat;
      for (int ks = tw; ks < KS; ks += lstm::kMmaWarps) {
#pragma unroll
        for (int v = 0; v < TEAMS; ++v) {
          const int k = ks + v * kTW;
          if (k < KS)
            mma_ktile<NT, P>(acc[v], A + (size_t)k * kTile, s.plane, B + (size_t)k * NT * 32,
                             (size_t)KS * NT * 32, lane);
        }
      }
      if (last) {
        __syncwarp();
        if (lane == 0) mbar_arrive(s.empty + slot);  // this warp is done with the slot
        if (tid == 0)
          while (issued < min(n_items, i + stages + 1)) issue_next();
      }
    };
    int e = 0;  // the team's epilogues of the phase
    // Layer l of chunk c: its products, then its epilogue.
    auto item = [&](int c, int l) {
      const int t = q.wave - l;
      cur = nxt;
      // The team's next (chunk, layer) of the phase: its cell operands
      // were written before the phase.
      if (kWave && l < l_last)
        load(nxt, t - 1, l + 1, c);
      else if (c + TEAMS < n_chunks)
        load(nxt, q.wave - q.l_first, q.l_first, c + TEAMS);
      float acc[TEAMS][NT][4];
#pragma unroll
      for (int v = 0; v < TEAMS; ++v)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          acc[v][nt][0] = acc[v][nt][1] = acc[v][nt][2] = acc[v][nt][3] = 0.f;
      if (kStacked<U> && l > 0) {  // the input product, with W_ih[l] (matrix L + l - 1)
        product(acc, c * ipc + l - 1 - lo, L + l - 1, !kWave || l == q.l_first, true);
        // The input is layer l-1's output h_new * mask; the staged row is its state.
        const int g = c * kMmaRows + lane / 4;
        const float* mask_t = a.mask + (size_t)t * N;
        const float m0 = g < N ? __ldg(mask_t + g) : 0.f;
        const float m1 = g + 8 < N ? __ldg(mask_t + g + 8) : 0.f;
#pragma unroll
        for (int v = 0; v < TEAMS; ++v)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            acc[v][nt][0] *= m0;
            acc[v][nt][1] *= m0;
            acc[v][nt][2] *= m1;
            acc[v][nt][3] *= m1;
          }
      }
      // The recurrent product, with W_hh[l].
      product(acc, c * ipc + l - lo, l, true, !kWave || l == l_last);
      // One team: a buffer per epilogue in turn; two: a buffer per team.
      float* pb = s.part + (TEAMS == 1 ? e % 2 : team) * kPart;
      if constexpr (TEAMS > 1) team_sync();  // the team's epilogue before is done
#pragma unroll
      for (int v = 0; v < TEAMS; ++v)
        lstm::store_partials<U>(pb, acc[v], tw + v * kTW, lane);
      team_sync();  // the partial tiles are stored (one team: those of the epilogue before read)

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
        a.hbuf[((size_t)((t + 1) & 1) * L + l) * NH + o] = h_sel;
        a.c_out[l * NH + o] = cur.m > 0.0f ? c_new : cur.c;
        if (l == L - 1) a.outs[t * NH + o] = h_new * cur.m;
        if (t + 1 < F || l + 1 < L)  // read at the next phase of layer l or l + 1
          put_state<P>(layer_slot((t + 1) & 1, l), s.x_part, n, j, KS, h_sel);
      }
      if (c + TEAMS >= n_chunks && l == l_last && ph + 1 < n_phases) {
        // The next phase's first (chunk, layer) of the team: this thread's c and h of it are
        // written.
        const Phase q1 = next_phase<kWave>(q, F, L);
        load(nxt, q1.wave - q1.l_first, q1.l_first, team);
      }
      ++e;
    };
    for (int c = team; c < n_chunks; c += TEAMS) {
      if constexpr (kWave) {
        for (int l = q.l_first; l <= l_last; ++l) item(c, l);
      } else {
        item(c, q.l_first);
      }
    }
    if (ph + 1 < n_phases) {
      fence_proxy_async_global();  // the exchange's stores, before the other blocks' bulk copies
      grid.sync();                 // every block's rows of this phase's states are written
    }
    base += n_chunks * ipc;
  }
}

// The HIGH and DEFAULT body of both orders (see the head note).
//   * The exchange.  xbuf holds 2 slots x L layers x parts x n_chunks
//     chunks x KS k-steps of 16x16 bf16 tiles (lstm_common.cuh): layer l's
//     state after step t, selected by the mask, goes in bf16 to slot (t +
//     1) & 1 of layer l from the thread that writes its f32 value to hbuf.
//     A prologue writes each layer's h0 in bf16 into its slot 0 (each block
//     its own columns) and the zeros of rows past N and of columns past H
//     in every slot, once per launch, and ends with a grid barrier.  Two
//     slots a layer suffice in either order: layer l's state after step t
//     is written at phase (t, l) of the stack order, phase t + l of the
//     wavefront order, and read only by the next phase that multiplies
//     layer l or l + 1: phases (t, l + 1) (its input) and (t + 1, l) (its
//     recurrent operand), or phase t + l + 1 (both).  The slot is next
//     written with the state after t + 2, at phase (t + 2, l) or t + l + 2,
//     after the grid barriers of those reads, which no block passes before
//     its copies of them have landed.  A phase reads the other slot of each
//     layer it writes.
//   * The ring.  After each grid barrier thread 0 issues bulk copies of the
//     phase's items, one state's 16-row chunk each (per chunk the phase's
//     staged states, each once: the stack order's input and recurrent
//     operand at l >= 1 and recurrent operand at layer 0, the wavefront's
//     layers max(0, l_first - 1) ... l_last), into a ring of `stages` slots
//     on full / empty mbarriers, as many as there are slots, and each later
//     item into its slot once the warps are done with the slot's item
//     before.  In the wavefront order an item stays in its slot until both
//     of its products are done, so a chunk holds its items one after the
//     other and takes up to L of them.  The item count runs on across
//     phases, and with it each slot's mbarrier phases; where a slot's item
//     before may be the other team's and still in flight (count_needed),
//     thread 0 publishes the count of the items issued, which the other
//     team waits for.  In the stack order at two layers, where the ring
//     holds all of a phase's items (2x512: N <= 64 at DEFAULT, N <= 16 at
//     HIGH), phase (t, 0) copies nothing: layer 0's state after t - 1 is
//     still in the slots where phase (t - 1, 1) copied it as its input, and
//     it is multiplied there (faster than copying it again: PERF.md).
//   * Teams.  Where a phase has two chunks or more and the ring more slots
//     than a chunk has items (the plan's teams: 2 items from two layers in
//     the stack order, L in the wavefront order), warps 0-3 and 4-7 are two
//     teams that take the chunks in turns, so one team's epilogue runs
//     beside the other's products; else one team of 8 warps takes every
//     chunk.  A product is split over 8 k-step sets, set w the k-steps w, w
//     + 8, ..., a warp of a team of 4 taking two of them; at l >= 1 each
//     set's input product is scaled by its rows' mask before its recurrent
//     product goes into the same accumulators.  Each set's partial tile goes
//     to shared memory (two buffers: one per team, or for one team one per
//     epilogue in turn), and the epilogue sums the 8 in set order.
//   * The cell.  Thread (row r, unit u) of a team (16 U of its threads)
//     sums its unit's four gate columns of a layer, applies their
//     nonlinearities and writes its h, c and output; it reads the cell
//     operands of its team's next (chunk, layer) while the current one is
//     multiplied, and the next phase's first one's before the grid barrier
//     (each is written by this thread, or by no one during the launch).
template <int U, int P, bool kWave>
__device__ __forceinline__ void ring_body(const StackArgs& a, float* smem) {
  constexpr int kP = kParts<P>;
  const int N = a.N, H = a.H, L = a.L, stages = a.stage_rows / kMmaRows;
  const int j0 = blockIdx.x * U;
  const size_t NH = (size_t)N * H;
  const int KS = lstm::kpad16(H) / 16;  // k-steps of H
  const int n_chunks = (N + kMmaRows - 1) / kMmaRows;
  const size_t plane = (size_t)KS * kTile;         // bf16 of one part of a chunk
  const size_t x_part = (size_t)n_chunks * plane;  // bf16 of one part of a state
  const size_t mat = lstm::mma_matrix_bytes(U, H, kP) / sizeof(uint2);  // fragments per matrix
  unsigned short* xbuf = static_cast<unsigned short*>(a.xbuf);
  auto layer_slot = [&](int sl, int k) { return xbuf + ((size_t)sl * L + k) * kP * x_part; };
  uint2* w_b = reinterpret_cast<uint2*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(w_b + (2 * L - 1) * mat);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + (size_t)stages * kP * plane);
  unsigned long long* empty = full + kMaxStages;
  unsigned* issued = reinterpret_cast<unsigned*>(empty + kMaxStages);
  const int tid = threadIdx.x;
  cg::grid_group grid = cg::this_grid();

  // The prologue: the B fragments, the mbarriers, h0's bf16 form and the
  // zeros of the exchange.
  const size_t HW = (size_t)H * 4 * H;
  for (int mi = 0; mi < 2 * L - 1; ++mi) {
    const bool up = mi >= L;
    const size_t off = (up ? mi - L : mi) * HW;
    const auto* hi = static_cast<const unsigned short*>(up ? a.w_ih_up : a.w_hh) + off;
    const auto* lo = static_cast<const unsigned short*>(up ? a.w_ih_up_lo : a.w_hh_lo);
    lstm::stage_b_fragments_vec<U, P>(w_b + mi * mat, hi, lo ? lo + off : nullptr, H, j0, tid,
                                      kRingThreads);
  }
  if (tid == 0) *issued = 0;
  if (tid < stages) {
    mbar_init(full + tid, 1);
    mbar_init(empty + tid, a.teams == 2 ? kRingWarps / 2 : kRingWarps);  // the warps of a team
  }
  fence_mbarrier_init();
  for (int i = tid; i < L * N * U; i += kRingThreads) {
    const int l = i / (N * U), n = i / U % N, j = j0 + i % U;
    put_state<P>(layer_slot(0, l), x_part, n, j, KS, __ldg(a.h0 + l * NH + (size_t)n * H + j));
  }
  // The zeros: per (slot, layer, part) the rows past N of the last chunk
  // (all Kp columns), then the columns past H of rows 0 .. N - 1.
  const int pad_rows = n_chunks * kMmaRows - N, Kp = KS * 16, pad_cols = Kp - H;
  const size_t row_pads = (size_t)pad_rows * Kp, pads = row_pads + (size_t)N * pad_cols;
  for (size_t e = (size_t)blockIdx.x * kRingThreads + tid; e < 2 * L * kP * pads;
       e += (size_t)gridDim.x * kRingThreads) {
    const size_t region = e / pads, q = e % pads;
    const int n = q < row_pads ? N + (int)(q / Kp) : (int)((q - row_pads) / pad_cols);
    const int j = q < row_pads ? (int)(q % Kp) : H + (int)((q - row_pads) % pad_cols);
    unsigned short* x =
        layer_slot((int)(region / kP / L), (int)(region / kP % L)) + region % kP * x_part;
    x[lstm::exchange_index(n, j, KS)] = 0;
  }
  fence_proxy_async_global();  // the exchange's stores, before the bulk copies
  grid.sync();

  const Ring s{KS,    n_chunks, stages, plane, x_part, mat,
               w_b,   ring,     full,   empty, issued,
               reinterpret_cast<float*>(reinterpret_cast<char*>(full) + kRingSyncBytes)};
  if constexpr (!kWave && kStacked<U>) {
    if (L == 2 && stages >= 2 * n_chunks) {  // reuse (ring_phases)
      if (a.teams == 2)
        ring_phases<U, P, 2, true, false>(a, s, tid);
      else
        ring_phases<U, P, 1, true, false>(a, s, tid);
      return;
    }
  }
  if (a.teams == 2)
    ring_phases<U, P, 2, false, kWave>(a, s, tid);
  else
    ring_phases<U, P, 1, false, kWave>(a, s, tid);
}

template <int U, bool kWave, int P>
__global__ void __launch_bounds__(kKernelThreads<U, P>, 1)
lstm_stack_kernel(const __grid_constant__ StackArgs a) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (P == kHighest)
    fp32_body<U, kWave>(a, smem);
  else
    ring_body<U, P, kWave>(a, smem);
}

// Lets lstm_stack_kernel<U, kWave, P> use up to max_smem bytes of dynamic
// shared memory and clears *fits unless an SM holds one block of it with that much.
template <int U, bool kWave, int P>
cudaError_t prepare_instance(int max_smem, bool* fits) {
  const void* kernel = (const void*)lstm_stack_kernel<U, kWave, P>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         max_smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kKernelThreads<U, P>, max_smem);
  if (per_sm < 1) *fits = false;
  return err;
}

// The three instances (U=4 in the stack and the wavefront order, U=8 in the
// stack order) at mode P.
template <int P>
cudaError_t prepare_mode(int max_smem, bool* fits) {
  cudaError_t err = prepare_instance<4, false, P>(max_smem, fits);
  if (err == cudaSuccess) err = prepare_instance<8, false, P>(max_smem, fits);
  if (err == cudaSuccess) err = prepare_instance<4, true, P>(max_smem, fits);
  return err;
}

template <int U, bool kWave, int P>
int launch(const StackArgs& args, size_t smem, cudaStream_t stream) {
  void* params[] = {(void*)&args};
  const int threads = P != kHighest ? kRingThreads : kTeamThreads * args.teams;
  const cudaError_t err =
      cudaLaunchCooperativeKernel((const void*)lstm_stack_kernel<U, kWave, P>, dim3(args.H / U),
                                  dim3(threads), params, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <bool kWave, int P>
int launch_units(const StackArgs& args, int units, size_t smem, cudaStream_t s) {
  // U=8 runs one layer, and the wavefront order needs two: it has no U=8 instance.
  if constexpr (!kWave) {
    if (units == 8) return launch<8, false, P>(args, smem, s);
  }
  return launch<4, kWave, P>(args, smem, s);
}

template <bool kWave>
int forward(const float* x0_proj, const float* mask, const void* w_hh, const void* w_ih_up,
            const float* b_up, const float* h0, const float* c0, float* outs, float* hbuf,
            float* c_out, int F, int N, int H, int L, int units, int stage_rows, int teams,
            int smem_bytes, int mode, const void* w_hh_lo, const void* w_ih_up_lo, void* xbuf,
            void* stream) {
  const int parts = mode == kHigh ? 2 : 1;
  const int planes = stage_planes(L, kWave);
  // HIGH and DEFAULT run ring_body: a ring of stage_rows / 16 slots and the
  // plan's teams (lstm_stack_plan decides: two where a phase has two chunks
  // or more and the ring more slots than a chunk has items, `planes` at
  // most; with fewer, thread 0 would leave items of its team unissued).
  const bool ring = mode != kHighest;
  const int stages = stage_rows / kMmaRows;
  const size_t layout = ring ? ring_smem_bytes(units, H, L, parts, stages)
                             : sizeof(float) * smem_floats(units, H, L, planes, stage_rows);
  if (F <= 0 || N <= 0 || H <= 0 || L <= 0 || H % 4 != 0 || (units != 4 && units != 8) ||
      H % units != 0 || mode < kHighest || mode > kDefault || stage_rows <= 0 ||
      (mode == kHighest && (stage_rows > N || (stage_rows != N && stage_rows % kPassRows != 0) ||
                            (stage_rows != N && stage_rows / kPassRows % teams != 0))) ||
      (ring && (stage_rows % kMmaRows != 0 || stages > kMaxStages || teams > 2 ||
                (teams == 2 && stages <= planes) || xbuf == nullptr)) ||
      teams < 1 || (!ring && teams > (units == 4 ? kTeams<4> : kTeams<8>)) ||
      (L > 1 && (w_ih_up == nullptr || b_up == nullptr || units != 4)) ||
      (mode == kHigh && (w_hh_lo == nullptr || (L > 1 && w_ih_up_lo == nullptr))) ||
      (size_t)smem_bytes != layout)
    return kErrBadShape;
  const StackArgs args{x0_proj, mask, w_hh, w_ih_up,    w_hh_lo,    w_ih_up_lo, b_up, h0, c0,
                       outs,    hbuf, c_out, F,      N, H,          L,          stage_rows, teams,
                       ring ? xbuf : nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes;
  if (mode == kHigh) return launch_units<kWave, kHigh>(args, units, smem, s);
  if (mode == kDefault) return launch_units<kWave, kDefault>(args, units, smem, s);
  return launch_units<kWave, kHighest>(args, units, smem, s);
}

}  // namespace

extern "C" {

// Once per device, before the first launch there (and outside any CUDA graph
// capture): checks that the card launches cooperative grids, lets the nine
// instances (U=4 in the stack and the wavefront order, U=8 in the stack
// order, at each of the three modes) use the card's opt-in shared memory per
// block, and checks that an SM holds one block of each with that much.
// Writes the SM count and the opt-in limit in bytes to info[0..1].  Returns
// 0, a cudaError_t value, or a negative code above.
int lstm_stack_prepare(int device, int* info) {
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

// Runs the whole stack over all F steps in one cooperative launch of H /
// units blocks on `stream`, one (step, layer) per phase (units 8: one layer
// only).  h0, c0 (L, N, H) are read in place; outs (F, N, H), hbuf (2, L,
// N, H) and c_out (L, N, H) are written: h after the last step in hbuf[F &
// 1], c in c_out.  mode (0 HIGHEST, 1 HIGH, 2 DEFAULT): at HIGHEST w_hh and
// w_ih_up are f32 and w_hh_lo, w_ih_up_lo null; at DEFAULT they are the
// weights rounded to bf16; at HIGH their bf16 hi parts, and w_hh_lo,
// w_ih_up_lo the lo parts; at HIGH and DEFAULT xbuf is the exchange buffer,
// 2 x L x parts x ceil(N / 16) x kpad16(H) x 16 bf16 on a 16-byte boundary,
// whose contents the launch sets (no zeroing before it).  units (4 or 8),
// stage_rows (HIGHEST: N, all rows staged at once, or a multiple of 16 below
// N, a ring of 16-row slots; else 16 times the ring's slots, 1 to 8), teams
// (HIGHEST: the block is 256 * teams threads; U=4: 2, or 1 for one chunk, a
// one-slot ring or where two teams' slots do not fit; U=8: 1; a ring's slots
// a multiple of it; else the block is 256 threads, 2 teams of 4 warps where
// N > 16 and the ring has more slots than a chunk has items, else 1) and
// smem_bytes are the launch plan's (ops/lstm_kernel.py::lstm_stack_plan);
// smem_bytes must equal the layout's size.  h0 and hbuf start on a 16-byte
// boundary.  Launches only: lstm_stack_prepare must have run on the current
// device.  Returns 0, a cudaError_t value, or a negative code above.
int lstm_stack_forward(const float* x0_proj, const float* mask, const void* w_hh,
                       const void* w_ih_up, const float* b_up, const float* h0,
                       const float* c0, float* outs, float* hbuf, float* c_out, int F, int N,
                       int H, int L, int units, int stage_rows, int teams, int smem_bytes,
                       int mode, const void* w_hh_lo, const void* w_ih_up_lo, void* xbuf,
                       void* stream) {
  return forward<false>(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0, outs, hbuf, c_out, F, N, H,
                        L, units, stage_rows, teams, smem_bytes, mode, w_hh_lo, w_ih_up_lo, xbuf,
                        stream);
}

// The same stack, the same operands and results, in the wavefront order:
// F + L - 1 grid barriers, each phase staging every active layer's state
// once.  Needs L >= 2 (at one layer the orders are one); its plan stages L
// state planes (at HIGH and DEFAULT a chunk's L items in the ring, and
// two teams only where the ring has more than L slots).
int lstm_wavefront_forward(const float* x0_proj, const float* mask, const void* w_hh,
                           const void* w_ih_up, const float* b_up, const float* h0,
                           const float* c0, float* outs, float* hbuf, float* c_out, int F,
                           int N, int H, int L, int units, int stage_rows, int teams,
                           int smem_bytes, int mode, const void* w_hh_lo,
                           const void* w_ih_up_lo, void* xbuf, void* stream) {
  if (L < 2) return kErrBadShape;
  return forward<true>(x0_proj, mask, w_hh, w_ih_up, b_up, h0, c0, outs, hbuf, c_out, F, N, H,
                       L, units, stage_rows, teams, smem_bytes, mode, w_hh_lo, w_ih_up_lo, xbuf,
                       stream);
}

}  // extern "C"
