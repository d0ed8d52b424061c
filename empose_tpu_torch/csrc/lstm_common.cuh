// Device helpers of the LSTM kernels: cp.async staging, the fixed-order
// warp reduce-scatter of a register tile's partial sums, the bf16
// tensor-core pieces of the HIGH and DEFAULT precision modes (bf16 hi/lo
// split, ldmatrix, mma.sync m16n8k16), and the exchange of a state's bf16
// form in k-step tiles through bulk copies (the Tensor Memory Accelerator)
// on mbarriers.
//
// Included by lstm_stack.cu, lstm_bidi.cu and lstm_train.cu; none of them
// keeps a copy of a helper here.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lstm {

// Precision modes, the codes of ops/precision.py MODE_CODES:
//   kHighest  fp32 FMAs on the CUDA cores (the fp32 parity mode);
//   kHigh     bf16_3x on the tensor cores: ah*bh + al*bh + ah*bl of the bf16
//             hi/lo splits of both operands, f32 accumulation (JAX's dot3);
//   kDefault  bf16 inputs, f32 accumulation.
constexpr int kHighest = 0;
constexpr int kHigh = 1;
constexpr int kDefault = 2;

// bf16 planes of an operand at mode P: hi, and lo at HIGH.
template <int P>
constexpr int kParts = P == kHigh ? 2 : 1;

__host__ __device__ constexpr size_t round32(size_t x) { return (x + 31) / 32 * 32; }

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float component(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// A kBytes (4, 8 or 16) copy from device memory into shared memory, both
// addresses on a kBytes boundary.  16 bytes go through L2 (.cg: never a
// stale L1 line, so rows written by other blocks before a grid barrier are
// read as written); fewer (.ca, the only form for them) only for data no
// block writes during the launch.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
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

// Waits until at most `pending` of this thread's newest copy groups are in
// flight (exactly for up to 7; for more it waits until 7 are, which is safe).
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// The sums over the warp's 32 lanes of the CNT <= 32 values v[0..CNT-1],
// scattered over the lanes: each stage at lane offset O hands half of the
// values a lane still holds to lane ^ O and adds the other half's, so after
// log2(CNT) stages lane l holds in v[0] the sum of value l / (32 / CNT); the
// offsets left add whole values.  The same lanes add in the same order every
// launch.  (With CNT = 64, lane l ends with values 2l and 2l + 1 in v[0..1].)
template <int CNT, int O>
__device__ __forceinline__ void warp_reduce_scatter(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (CNT > 1) {
      constexpr int kHalf = CNT / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float send = up ? v[i] : v[i + kHalf];
        const float keep = up ? v[i + kHalf] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      warp_reduce_scatter<kHalf, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      warp_reduce_scatter<1, O / 2>(v, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core products of the HIGH and DEFAULT modes.
//
// A block owns 4U gate columns of a matrix W (H, 4H): its column n = 4u + g
// is W's column g H + j0 + u (unit j0 + u, gate g), so the four gates of a
// unit are neighbouring columns.  A product multiplies 16 staged rows (one
// chunk, rows past N zero) by those columns: an m16n8k16 tile per k-step of
// 16 and n-tile of 8 columns; the kMmaWarps warps of a team take the
// k-steps warp, warp + kMmaWarps, ..., and their partial tiles meet in
// shared memory, summed in warp order by the epilogue (no atomics: the same
// bits every launch).  H is padded with zeros to Kp = 16 * ceil(H / 16).
constexpr int kMmaWarps = 8;
constexpr int kMmaRows = 16;

__host__ __device__ constexpr int kpad16(int H) { return (H + 15) / 16 * 16; }

// Bytes of a block's resident columns of one matrix (uint2 B fragments,
// `parts` planes) and of a team's partial tiles.
__host__ __device__ constexpr size_t mma_matrix_bytes(int U, int H, int parts) {
  return (size_t)parts * 8 * U * kpad16(H);
}
__host__ __device__ constexpr size_t mma_partial_bytes(int U) {
  return (size_t)kMmaWarps * kMmaRows * 4 * U * 4;
}

// Round-to-nearest-even bf16 of a pair, and the pair's lo parts bf16(x - hi).
__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ void split_bf16x2(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// A 16x16 bf16 A fragment of row-major rows (stride in elements) by one
// ldmatrix.x4: lane l gives the address of row l % 16, column (l / 16) * 8.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16x16, row) * b (16x8, col) in bf16 with f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The block's columns of W (bf16 hi, and lo at HIGH, each (H, 4H) row-major)
// in B-fragment order: uint2 ((part KS + ks) NT + nt) 32 + lane holds
// W[k][n], W[k + 1][n] and W[k + 8][n], W[k + 9][n] for k = 16 ks + 2 (lane %
// 4), n = 8 nt + lane / 4 (k >= H zero), so a lane fetches its fragment with
// one 8-byte load and a warp's loads are contiguous.  From wide loads: thread
// item (part, k, gate g) reads the block's U units of gate g at row k (U
// bf16: 16 bytes at U=8, 8 at U=4, 4 at U=2, aligned since U divides H and
// j0), four items' loads in flight before their 2-byte stores into the
// fragments, so a block stages its columns in a few load round trips.
template <int U, int P>
__device__ void stage_b_fragments_vec(uint2* dst, const unsigned short* w_hi,
                                      const unsigned short* w_lo, int H, int j0, int tid,
                                      int nthreads) {
  static_assert(U == 2 || U % 4 == 0, "an item is one 4-byte load or U / 4 8-byte ones");
  constexpr int NT = U / 2, kBatch = 4;
  const int Kp = kpad16(H), KS = Kp / 16;
  const int items = kParts<P> * Kp * 4;
  unsigned short* d16 = reinterpret_cast<unsigned short*>(dst);
  for (int first = tid; first < items; first += kBatch * nthreads) {
    uint2 q[kBatch][(U + 3) / 4];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = first + b * nthreads, g = idx % 4, k = idx / 4 % Kp;
      const unsigned short* w = idx / (4 * Kp) == 0 ? w_hi : w_lo;
      if constexpr (U == 2) {
        const unsigned* src =
            reinterpret_cast<const unsigned*>(w + (size_t)k * 4 * H + (size_t)g * H + j0);
        q[b][0].x = idx < items && k < H ? __ldg(src) : 0u;
      } else {
        const uint2* src =
            reinterpret_cast<const uint2*>(w + (size_t)k * 4 * H + (size_t)g * H + j0);
#pragma unroll
        for (int i = 0; i < U / 4; ++i)
          q[b][i] = idx < items && k < H ? __ldg(src + i) : make_uint2(0u, 0u);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = first + b * nthreads, g = idx % 4, k = idx / 4 % Kp, part = idx / (4 * Kp);
      if (idx >= items) break;
      const int ks = k / 16, kk = k % 16;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int n = 4 * u + g;
        const unsigned word = u % 4 < 2 ? q[b][u / 4].x : q[b][u / 4].y;
        const size_t frag =
            (((size_t)part * KS + ks) * NT + n / 8) * 32 + n % 8 * 4 + kk % 8 / 2;
        d16[4 * frag + kk / 8 * 2 + kk % 2] =
            (unsigned short)(u % 2 ? word >> 16 : word & 0xffffu);
      }
    }
  }
}

// The warp's partial tile into part[warp][16][4U] (f32): lane l holds rows
// l / 4 and l / 4 + 8, columns 8 nt + 2 (l % 4) + {0, 1}.
template <int U>
__device__ __forceinline__ void store_partials(float* part, const float (&acc)[U / 2][4],
                                               int warp, int lane) {
  constexpr int C = 4 * U;
  float* p = part + (size_t)(warp * kMmaRows + lane / 4) * C + (lane % 4) * 2;
#pragma unroll
  for (int nt = 0; nt < U / 2; ++nt) {
    *reinterpret_cast<float2*>(p + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(p + 8 * C + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// The sum of the kMmaWarps partials of (row r, column n), in warp order.
template <int U>
__device__ __forceinline__ float sum_partials(const float* part, int r, int n) {
  constexpr int C = 4 * U;
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kMmaWarps; ++w) s += part[(size_t)(w * kMmaRows + r) * C + n];
  return s;
}

// ---------------------------------------------------------------------------
// The exchange of a state's bf16 form between the blocks of a grid.
//
// The block that computes an element of the state writes its bf16 form (hi,
// and lo at HIGH) once into an exchange buffer in device memory, laid out in
// k-step tiles, and after the grid barrier every block streams the chunks it
// multiplies into shared memory by bulk copies, to the same layout.  A tile
// is one 16-row chunk's 16 columns 16 ks .. 16 ks + 15 of one bf16 part, 512
// contiguous bytes, its row r at 16 r elements and the row's two 8-column
// halves h at (h ^ (r / 4 % 2)) 8, so that the eight rows an ldmatrix reads
// fall in distinct banks.  A chunk's tiles lie in k order, so a k-slice of a
// chunk is one contiguous run per part: one bulk copy.
constexpr int kTile = kMmaRows * 16;  // bf16 of a tile

__host__ __device__ constexpr int tile_offset(int r, int c) {
  return r * 16 + ((c / 8) ^ (r / 4 % 2)) * 8 + c % 8;
}

// Where row n, column j of a state lies in one part of an exchange buffer:
// chunks of 16 rows, each KS k-step tiles.
__device__ __forceinline__ size_t exchange_index(int n, int j, int KS) {
  return ((size_t)(n / kMmaRows) * KS + j / 16) * kTile + tile_offset(n % kMmaRows, j % 16);
}

// h's bf16 form (hi, and lo at HIGH: split_bf16x2) at row n, column j of
// one state's parts in an exchange buffer (x_part bf16 per part).
template <int P>
__device__ __forceinline__ void put_state(unsigned short* x, size_t x_part, int n, int j, int KS,
                                          float h) {
  const size_t o = exchange_index(n, j, KS);
  unsigned hi, lo;
  split_bf16x2(h, 0.0f, hi, lo);
  x[o] = (unsigned short)hi;
  if constexpr (P == kHigh) x[x_part + o] = (unsigned short)lo;
}

// acc[nt] += one k-step tile (planes `tile`, and tile + lo_off at HIGH)
// times NT n-tiles of that k-step's B fragments (b[nt 32 + lane]; the lo
// parts b_lo uint2 further on at HIGH): ah*bh, and al*bh, ah*bl at HIGH,
// in this order (al*bl dropped, as in JAX's dot3).
template <int NT, int P>
__device__ __forceinline__ void mma_ktile(float (&acc)[NT][4], const __nv_bfloat16* tile,
                                          size_t lo_off, const uint2* b, size_t b_lo, int lane) {
  const __nv_bfloat16* p = tile + tile_offset(lane % 16, lane / 16 * 8);
  unsigned ah[4], al[4];
  ldmatrix_x4(ah, p);
  if constexpr (P == kHigh) ldmatrix_x4(al, p + lo_off);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint2 bh = b[nt * 32 + lane];
    mma_bf16(acc[nt], ah, bh);
    if constexpr (P == kHigh) {
      mma_bf16(acc[nt], al, bh);
      mma_bf16(acc[nt], ah, b[b_lo + nt * 32 + lane]);
    }
  }
}

// The bulk copies and their mbarriers.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Makes the mbarriers this thread initialised visible to the bulk copies.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Waits until the phase of parity `parity` of the mbarrier has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16, both addresses on a 16-byte boundary) from
// device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// Orders this thread's generic-proxy accesses of device memory before the
// bulk copies' (async-proxy) accesses that follow a barrier.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The ring of the mode bodies (the bidirectional layer, the stack order, the
// training forward sweep): at most kMaxStages slots, each with a full and an
// empty mbarrier, and the count of the ring's chunks (or items) issued in
// the launch, kRingSyncBytes in all (what follows stays on a 16-byte
// boundary).  Thread 0 issues every bulk copy; where two teams share the
// ring and a slot's consecutive items may belong to different teams, it
// publishes the count after each, and a warp other than thread 0's waits
// for its item's issue before its wait on the slot's full mbarrier, so that
// the mbarrier is at most one phase behind (never two, where the parity
// alone would pass a phase early).
constexpr int kMaxStages = 8;
constexpr int kRingSyncBytes = 2 * kMaxStages * 8 + 16;

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.cta.shared::cta.u32 [%0], %1;\n" ::"r"(smem_addr(p)), "r"(v)
               : "memory");
}
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(smem_addr(p))
               : "memory");
  return v;
}
// Waits (one lane of the warp, then the whole warp) until the count at p
// exceeds i: the (i + 1)-th chunk of the launch is issued.
__device__ __forceinline__ void wait_issued(const unsigned* p, unsigned i, int lane) {
  if (lane == 0)
    while (load_acquire(p) <= i) {
    }
  __syncwarp();
}

}  // namespace lstm
