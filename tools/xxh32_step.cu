// xxh32_step.cu — the dependent latency of one xxh32 lane step on this
// card, stamped by clock64: lanes 0-3 of one warp run `steps` steps
// v = rotl(v + w * P2, 13) * P1, each w read from shared memory as
// csrc/xxh32.cu reads its staged stripes, and lane 0 writes the cycles
// between the stamps.  tools/stream_kernels.py divides them by `steps`:
// a row of n bytes is n / 16 such steps on each lane's chain, whatever
// the kernel's shape, so n / 16 times this is the row's chain bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t P1 = 2654435761u;
constexpr uint32_t P2 = 2246822519u;
constexpr int WORDS = 4096;

// clock64 once `dep` is ready: the setp waits on it, the mov after it
// (tools/step_clocks.cu's stamp).
__device__ __forceinline__ long long stamp(uint32_t dep) {
  long long t;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.eq.u32 p, %1, 0x7fffffff;\n\t"
      "mov.u64 %0, %%clock64;\n\t@p add.s64 %0, %0, 1;\n\t}"
      : "=l"(t) : "r"(dep) : "memory");
  return t;
}

__global__ void __launch_bounds__(32)
xxh32_step_kernel(const uint32_t* __restrict__ words, int steps,
                  long long* __restrict__ cycles, uint32_t* __restrict__ out) {
  __shared__ uint32_t w[WORDS];
  const int lane = threadIdx.x;
  for (int i = lane; i < WORDS; i += 32) w[i] = words[i];
  __syncwarp();
  uint32_t v = lane;
  const long long t0 = stamp(v);
  if (lane < 4) {
#pragma unroll 8
    for (int s = 0; s < steps; ++s) {
      const uint32_t x = v + w[(4 * s + lane) & (WORDS - 1)] * P2;
      v = __funnelshift_l(x, x, 13) * P1;
    }
  }
  const long long t1 = stamp(v);
  out[lane] = v;
  if (lane == 0) cycles[0] = t1 - t0;
}

}  // namespace

// words (4096,) u32, cycles (1,) i64 and out (32,) u32 on the device; one
// warp on `stream`.  Returns cudaGetLastError().
extern "C" int tpz_xxh32_step(const void* words, int steps, void* cycles,
                              void* out, void* stream) {
  xxh32_step_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), steps,
      static_cast<long long*>(cycles), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
