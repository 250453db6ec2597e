// Stage stamps inside a captured program (`utils/timer.py:StageRing`).
//
// One thread writes the device's %globaltimer (nanoseconds) and the frame's
// tick into a ring of int64 [frames, slots, 2] (time, tick): the row is the
// tick modulo `frames`, the slot the stage.  The tick is read from a device
// scalar (the graph's static tick buffer), so a replay stamps the frame it
// runs; a stage whose stamp did not run keeps an older tick in its slot.
// A kernel launch, so it can be captured into a CUDA graph and into the
// body of a conditional node, where event nodes may not go.

#include <cuda_runtime.h>

__global__ void stage_stamp(long long* ring, const long long* tick, int slot, int slots,
                            int frames) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    const long long k = *tick;
    const long long row = ((k % frames) + frames) % frames;
    long long* cell = ring + 2 * (row * slots + slot);
    cell[0] = static_cast<long long>(now);
    cell[1] = k;
}

extern "C" {

// Returns a cudaError_t.
int stamp(void* stream, void* ring, const void* tick, int slot, int slots, int frames) {
    stage_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<long long*>(ring), static_cast<const long long*>(tick), slot, slots, frames);
    return cudaGetLastError();
}

}  // extern "C"
