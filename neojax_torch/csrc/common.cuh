// Shared helpers of the neojax_torch CUDA kernels (sm_90a).
//
// Storage codes match neojax_torch.kernels.fdl_mac.STORAGE_CODES:
//   0 split (float), 1 bf16, 2 int16, 3 int8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace neo {

enum StorageCode : int { kSplit = 0, kBf16 = 1, kInt16 = 2, kInt8 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int16_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// Storage traits: whether rows are quantized, and the integer full scale.
template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr bool kQuant = false;
  static constexpr float kIntMax = 1.0f;
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr bool kQuant = false;
  static constexpr float kIntMax = 1.0f;
};
template <> struct Traits<int16_t> {
  static constexpr bool kQuant = true;
  static constexpr float kIntMax = 32767.0f;
};
template <> struct Traits<int8_t> {
  static constexpr bool kQuant = true;
  static constexpr float kIntMax = 127.0f;
};

// Round a float to the precision of M (identity for float, RNE for bf16).
template <typename M> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Store a row value into the storage dtype. Quantized storages receive an
// already rounded and clamped integer value.
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(int16_t* p, float v) {
  *p = static_cast<int16_t>(__float2int_rn(v));
}
__device__ __forceinline__ void store(int8_t* p, float v) {
  *p = static_cast<int8_t>(__float2int_rn(v));
}

// cp.async of 4, 8 or 16 bytes global -> shared (16: bypassing L1), its
// group commit and wait.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// cp.async of v bytes (4, 8 or 16) that writes zeros where !valid (src,
// any readable address, is then not read).
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int v, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? v : 0;
  if (v == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
  else if (v == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Allow a kernel more than 48 KB of shared memory, once per kernel and size.
template <typename K>
cudaError_t allow_smem(K kernel, int smem, int& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

}  // namespace neo
