// Device stamp: the recorder's (utils/timing.py) mark on the device's
// timeline. One thread reads the global nanosecond timer (%globaltimer) and
// writes (stamp id, ns) into the next free entry of a ring in device memory,
// whose cursor it advances atomically. It reads no host data, so a CUDA
// graph captures it as one kernel node, in stream order between the kernels
// around it. The cursor counts on past the ring's end, so an overflow shows
// as a cursor larger than the ring and loses no entry silently.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* ring, unsigned long long* cursor, int id,
                             int capacity) {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  const unsigned long long i = atomicAdd(cursor, 1ULL);
  if (i < (unsigned long long)capacity) {
    ring[2 * i] = id;
    ring[2 * i + 1] = (long long)ns;
  }
}

}  // namespace

extern "C" int xmat_stamp(void* ring, void* cursor, int id, int capacity, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)ring,
                                                  (unsigned long long*)cursor, id, capacity);
  return (int)cudaGetLastError();
}
