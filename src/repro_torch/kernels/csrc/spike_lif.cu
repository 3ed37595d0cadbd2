// Fused LIF over T for Hopper (sm_90a): the membrane stays in registers
// across every time step.
//
// Replaces the TPU kernel src/repro/kernels/spike_lif.py
// (fused_lif_pallas, body _kernel):
//
//   v = 0;  for t < T:  v = v*leak + x[t];  s = v >= threshold;
//                        out[t] = s;  v = v*(1 - s)      (hard reset)
//
// over a (T, M, C) synaptic input, f32 or bf16 (converted to f32 on load,
// as the Pallas body's astype), into int8 spikes (T, M, C).
//
// One thread owns 4 consecutive elements of the flattened M*C axis (one
// where M*C is not a multiple of 4) and walks all T steps: step t's loads
// are coalesced, M*C apart from step t-1's, and the membrane never leaves
// the thread. T is a loop bound, not a template: any T runs.
//
// What bounds it on this card: bytes. Each element is read once (4 bytes,
// or 2 in bf16) and its spike written once (1 byte); a handful of float
// ops per element is nothing beside that. The design does the least the
// bound allows: 16-byte loads and 4-byte stores per thread, and the grid
// covers the M*C axis once.
//
// Every float op is pinned (__fmul_rn, __fadd_rn; the file is built
// -fmad=false) and the reset is the product v*(1 - s), not a select, so the
// kernel is bit-equal to the eager plain version (spike_lif.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

// the four inputs at i..i+3 (i a multiple of 4, 16- or 8-byte aligned)
__device__ __forceinline__ float4 load4(const float* p, long long i) {
  return __ldg(reinterpret_cast<const float4*>(p + i));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, long long i) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + i));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

__device__ __forceinline__ float lif_step(float& v, float x, float leak, float threshold) {
  v = __fadd_rn(__fmul_rn(v, leak), x);
  const float s = v >= threshold ? 1.0f : 0.0f;
  v = __fmul_rn(v, __fsub_rn(1.0f, s));  // hard reset, as the plain version's v*(1-s)
  return s;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    fused_lif_kernel(const T* __restrict__ x, int8_t* __restrict__ out, int t_steps,
                     long long n, float threshold, float leak) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;; g += stride) {
    if (VEC) {
      const long long i = 4 * g;
      if (i >= n) return;
      float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
      for (int t = 0; t < t_steps; ++t) {
        const long long o = (long long)t * n + i;
        const float4 xv = load4(x, o);
        char4 s;
        s.x = (signed char)lif_step(v0, xv.x, leak, threshold);
        s.y = (signed char)lif_step(v1, xv.y, leak, threshold);
        s.z = (signed char)lif_step(v2, xv.z, leak, threshold);
        s.w = (signed char)lif_step(v3, xv.w, leak, threshold);
        *reinterpret_cast<char4*>(out + o) = s;
      }
    } else {
      if (g >= n) return;
      float v = 0.f;
      for (int t = 0; t < t_steps; ++t) {
        const long long o = (long long)t * n + g;
        out[o] = (int8_t)lif_step(v, load_f32(x, o), leak, threshold);
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* out, int t_steps, long long n, float threshold, float leak,
           cudaStream_t stream) {
  // vector path: 4 elements a thread, every step's row of n starting aligned
  const bool vec = n % 4 == 0;
  const long long work = vec ? n / 4 : n;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // enough blocks for every SM to keep 2048 threads in flight; threads
  // stride over whatever is left
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)(sms > 0 ? sms : 132) * (2048 / kThreads);
  if (blocks > cap) blocks = cap;
  const T* xp = static_cast<const T*>(x);
  int8_t* op = static_cast<int8_t*>(out);
  if (vec)
    fused_lif_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(xp, op, t_steps, n,
                                                                       threshold, leak);
  else
    fused_lif_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(xp, op, t_steps, n,
                                                                        threshold, leak);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (T, n) contiguous, out (T, n) int8.
extern "C" int fused_lif_launch(const void* x, void* out, int t_steps, long long n, int dtype,
                                float threshold, float leak, void* stream) {
  if (t_steps < 0 || n < 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  if (t_steps == 0 || n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x, out, t_steps, n, threshold, leak, s)
                    : launch<__nv_bfloat16>(x, out, t_steps, n, threshold, leak, s);
}
