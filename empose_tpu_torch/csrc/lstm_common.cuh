// Device helpers of the LSTM kernels: 16-byte cp.async staging through L2
// and the fixed-order warp reduce-scatter of a register tile's partial sums.
//
// Included by lstm_stack.cu.  lstm_bidi.cu and lstm_train.cu still carry
// their own copies of the same functions.

#pragma once

#include <cuda_runtime.h>

namespace lstm {

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float component(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// A 16-byte copy from device memory into shared memory through L2 (.cg: never
// a stale L1 line, so rows written by other blocks before a grid barrier are
// read as written).  Both addresses on a 16-byte boundary.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
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

}  // namespace lstm
