// Shared definitions of the port's CUDA kernels.
//
// The per-lane bodies are `HD`: device functions under nvcc, plain inline
// functions under a host C++ compiler, so the same source also builds on a
// machine without CUDA for checking the lane logic.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define HD __device__ __forceinline__
#define EVM_TABLE static __constant__
#else
#define HD static inline
#define EVM_TABLE static const
#endif

#include "eravm_gen.h"   // generated from the port's isa/ by _build.py
