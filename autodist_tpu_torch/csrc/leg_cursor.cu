// The flight recorder's leg cursor, for Hopper (sm_90a): a stream-ordered
// progress stamp at a schedule-IR leg boundary of the training step.
//
// Not a port of a TPU kernel.  The JAX package stamps a leg cursor from
// inside the compiled step with a host callback, which fires when the DEVICE
// reaches the leg.  An eager PyTorch step that stamped on the host would
// stamp when the host ENQUEUES the leg, up to a step ahead of the card, and
// a hang would be blamed on the wrong leg.  This kernel moves the stamp into
// the stream: one thread, launched on the step's stream between two legs,
// runs when every kernel before it has finished.
//
// Design:
//  * the cursors live in a ring of `cap` slots of two 64-bit words in
//    mapped pinned host memory (cudaHostAlloc with cudaHostAllocMapped), so
//    the host reads them at any time without a synchronization and without
//    a copy on the stream (a copy would wait behind the stalled leg too);
//  * stamp `seq` writes slot seq % cap: first the %globaltimer nanoseconds,
//    then, after a system-scope fence, seq + 1 as the slot's completion
//    mark.  A host reader that sees the mark also sees the time;
//  * the host keeps what each stamp names (leg id, kind, microbatch slot);
//    the kernel writes only the sequence number and the time;
//  * one launch per stamp, no allocation, nothing waits for the host.
//
// What bounds it: the launch (a few microseconds of issue and one 16-byte
// write over PCIe), not bytes or operations.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

__global__ void leg_cursor_kernel(unsigned long long* ring,
                                  unsigned long long seq, unsigned int cap) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  volatile unsigned long long* slot = ring + 2 * (seq % cap);
  slot[1] = t;
  __threadfence_system();
  slot[0] = seq + 1;
}

}  // namespace

// The ring: `cap` slots of two 64-bit words, zeroed, in mapped pinned host
// memory; *host gets the host address, *dev the device address of it.
extern "C" int leg_cursor_alloc(unsigned int cap, void** host, void** dev) {
  size_t bytes = (size_t)cap * 2 * sizeof(unsigned long long);
  cudaError_t err = cudaHostAlloc(host, bytes, cudaHostAllocMapped);
  if (err != cudaSuccess) return (int)err;
  memset(*host, 0, bytes);
  return (int)cudaHostGetDevicePointer(dev, *host, 0);
}

extern "C" int leg_cursor_free(void* host) {
  return (int)cudaFreeHost(host);
}

// Stamp `seq` into the ring at device address `dev` on `stream`; returns
// cudaGetLastError().
extern "C" int leg_cursor_stamp(void* dev, unsigned long long seq,
                                unsigned int cap, void* stream) {
  if (cap == 0) return (int)cudaErrorInvalidValue;
  leg_cursor_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)dev, seq, cap);
  return (int)cudaGetLastError();
}
