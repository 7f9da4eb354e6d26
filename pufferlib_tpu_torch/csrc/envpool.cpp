// Native envpool driver core: semaphore spin-wait + batched slab gather.
//
// The reference's envpool hot loop is a Python busy-wait over per-worker
// semaphore bytes plus numpy fancy-indexed copies out of shared memory
// (reference vector.py:329-410). This module implements that driver half
// in C++: the GIL is released while spinning, the batch assembly is a
// single pass of memcpys, and worker-block gathers avoid intermediate
// numpy allocations. Loaded via ctypes (pufferlib_tpu_torch/native.py,
// which builds it into pufferlib_tpu_torch/_build/); the Python
// implementation remains the path of a pool built with native=False.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libpufferpool.so envpool.cpp

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <thread>

extern "C" {

// Spin until `needed` workers' semaphore bytes are in {MAIN=5, INFO=6}.
// Writes the ready worker indices to out_indices and returns the count.
// timeout_us < 0 means spin forever. Busy-spins for spin_us, then naps.
// spin_us = 0 naps from the start (oversubscribed hosts: hot-spinning
// the driver starves the workers when cores < workers).
int wait_ready(volatile uint8_t* semaphores, int num_workers,
        const int32_t* candidates, int num_candidates, int needed,
        int32_t* out_indices, int64_t timeout_us, int64_t spin_us) {
    constexpr uint8_t MAIN = 5;
    constexpr uint8_t INFO = 6;

    auto start = std::chrono::steady_clock::now();
    int found = 0;
    // track which candidates were already collected
    bool taken[1024] = {false};
    if (num_candidates > 1024) return -2;

    while (found < needed) {
        for (int i = 0; i < num_candidates && found < needed; ++i) {
            if (taken[i]) continue;
            int w = candidates[i];
            uint8_t v = semaphores[w];
            if (v == MAIN || v == INFO) {
                taken[i] = true;
                out_indices[found++] = w;
            }
        }
        if (found >= needed) break;

        auto now = std::chrono::steady_clock::now();
        int64_t waited = std::chrono::duration_cast<
            std::chrono::microseconds>(now - start).count();
        if (timeout_us >= 0 && waited > timeout_us) return -1;
        if (waited > spin_us) {
            // oversubscribed mode (spin_us == 0) naps short so step
            // latency stays sub-millisecond; cooled-down mode naps long
            std::this_thread::sleep_for(std::chrono::microseconds(
                spin_us == 0 ? 200 : 10000));
        } else {
            std::this_thread::yield();
        }
    }
    return found;
}

// Gather `count` fixed-size row-blocks from src into contiguous dst.
// Block b copies bytes src[offsets[b] .. offsets[b]+block_bytes) to
// dst[b*block_bytes ...). This is the slab->batch assembly.
void gather_blocks(const uint8_t* src, uint8_t* dst,
        const int64_t* offsets, int count, int64_t block_bytes) {
    for (int b = 0; b < count; ++b) {
        std::memcpy(dst + (int64_t)b * block_bytes,
            src + offsets[b], (size_t)block_bytes);
    }
}

// Scatter contiguous src batch rows back into slab offsets (actions).
void scatter_blocks(const uint8_t* src, uint8_t* dst,
        const int64_t* offsets, int count, int64_t block_bytes) {
    for (int b = 0; b < count; ++b) {
        std::memcpy(dst + offsets[b],
            src + (int64_t)b * block_bytes, (size_t)block_bytes);
    }
}

// Set semaphore bytes for a set of workers (driver -> workers signal).
void signal_workers(volatile uint8_t* semaphores,
        const int32_t* workers, int count, uint8_t value) {
    for (int i = 0; i < count; ++i) {
        semaphores[workers[i]] = value;
    }
}

}  // extern "C"
