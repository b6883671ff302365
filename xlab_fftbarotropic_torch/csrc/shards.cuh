// shards.cuh: the base pointers of a distributed kernel's P source and P
// destination shards (a2a.cu, xstage.cu), passed to the kernel by value as
// one __grid_constant__ parameter.
//
// The launchers take a host array of 2 p pointers (the p sources, then the
// p destinations) and copy it into a Shards; nothing is put on the card
// before the launch, so a call queues the kernel alone. A block reads a
// pointer from the parameter space (the constant cache) through its index.
// The cap keeps the parameter at 512 bytes; the launchers refuse p outside
// [1, kMaxShards], and the Python wrappers (parallel/fused_transpose.py
// MAX_SHARDS) say so first.
#pragma once

#include <cuda_runtime.h>

namespace xfb {

constexpr int kMaxShards = 32;

struct Shards {
  const float2* src[kMaxShards];
  float2* dst[kMaxShards];
};

// ptrs: host array of 2 p device pointers, sources then destinations.
// Returns false (and leaves *out alone) for p outside [1, kMaxShards].
inline bool load_shards(const void* const* ptrs, int p, Shards* out) {
  if (p < 1 || p > kMaxShards) return false;
  Shards s = {};
  for (int t = 0; t < p; ++t) {
    s.src[t] = static_cast<const float2*>(ptrs[t]);
    s.dst[t] = static_cast<float2*>(const_cast<void*>(ptrs[p + t]));
  }
  *out = s;
  return true;
}

}  // namespace xfb
