// Latency probe for Hopper (sm_90a), bound to Python with ctypes: the cycles
// from issue until a dependent instruction may issue, measured on the card
// for the instruction classes that make up the substep chain (FADD, FMUL,
// FFMA, MUFU.RCP, F2I, I2F).
//
// experiments/sass.py counts a loop's dependent chain with a latency table.
// kernel_first_check --chain (and chip_smoke.py's phase chain) replace the
// table's entries with these readings before the chain bound is computed, so
// the bound rests on this card's latencies, not on estimates.
//
// Each probe is one warp running a dependent chain of LEN links between two
// reads of clock64. A link is one instruction of the probed kind; the
// reciprocal's link also multiplies first (FMUL, probed on its own), so that
// no two reciprocals meet and fold. The chain is timed at two lengths; the
// difference over the extra links removes the cost of the clock reads and
// the loop's entry. The result's values mean nothing; only their dependence
// counts. kernel_first_check checks each chain's opcodes in the SASS.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Probe { P_FADD, P_FMUL, P_FFMA, P_RCP, P_F2I, P_I2F, N_PROBES };
constexpr int kShortChain = 128;
constexpr int kLongChain = 384;

template <int OP>
__device__ __forceinline__ float link(float x, float a, float c) {
  if constexpr (OP == P_FADD) {
    return x + c;
  } else if constexpr (OP == P_FMUL) {
    return x * a;
  } else if constexpr (OP == P_FFMA) {
    return fmaf(x, a, c);
  } else if constexpr (OP == P_RCP) {
    float r;
    asm volatile("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * a));
    return r;
  } else if constexpr (OP == P_F2I) {
    return __int_as_float(__float2int_rn(x));     // as sincos_exact reduces
  } else {
    return __int2float_rn(__float_as_int(x));     // as sincos_exact reduces
  }
}

template <int OP, int LEN>
__global__ void latency_probe_kernel(const float* __restrict__ in, long long* cycles,
                                     float* __restrict__ out) {
  float x = in[threadIdx.x];
  const float a = in[32], c = in[33];
  long long t0, t1;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0) :: "memory");
#pragma unroll
  for (int k = 0; k < LEN; ++k) x = link<OP>(x, a, c);
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1) : "f"(x) : "memory");
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

template <int OP>
void launch_pair(const float* in, long long* cycles, float* out, cudaStream_t stream) {
  latency_probe_kernel<OP, kShortChain><<<1, 32, 0, stream>>>(in, cycles + 2 * OP, out);
  latency_probe_kernel<OP, kLongChain><<<1, 32, 0, stream>>>(in, cycles + 2 * OP + 1, out);
}

}  // namespace

extern "C" {

const char* scg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// in: 34 floats (one start value a lane, then the multiplier and the addend);
// cycles: 2 * N_PROBES int64, the short and the long chain of each probe in
// the order of enum Probe; out: 32 floats. Returns cudaGetLastError().
int scg_latency_probe(const void* in, void* cycles, void* out, int* n_probes,
                      int* short_len, int* long_len, void* stream) {
  const float* i = (const float*)in;
  long long* cy = (long long*)cycles;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  *n_probes = N_PROBES;
  *short_len = kShortChain;
  *long_len = kLongChain;
  launch_pair<P_FADD>(i, cy, o, s);
  launch_pair<P_FMUL>(i, cy, o, s);
  launch_pair<P_FFMA>(i, cy, o, s);
  launch_pair<P_RCP>(i, cy, o, s);
  launch_pair<P_F2I>(i, cy, o, s);
  launch_pair<P_I2F>(i, cy, o, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
