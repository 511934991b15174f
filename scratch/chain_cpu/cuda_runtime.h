// CUDA names for compiling csrc/gate_chain.cu with g++ on the CPU
// (scratch/chain_cpu/run.py): no device code is made
#pragma once
#include <stdint.h>
#include <stddef.h>
#define __device__
#define __global__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __restrict__
#define __align__(n) __attribute__((aligned(n)))
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3 { unsigned x, y, z; };
inline uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline void __syncthreads() {}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetDevice(int*) { return 0; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
// three SMs of one block each: the grid has a few blocks, each walks
// several tiles
inline int cudaDeviceGetAttribute(int* n, int, int) { *n = 3; return 0; }
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }
inline int cudaGetLastError() { return 0; }
