// Row-block staging copies for the serving engines' host chunks: a chunk's
// rows are copied into page-locked memory in blocks, by the calling thread
// and a process-wide pool of helper threads together, so that the caller
// can issue each block's host-to-device copy as soon as that block has
// landed (lsm_tpu_torch/ops/stage.py). Plain C++, built by g++ at first use
// (ops/_build.py build_native).
//
// One job at a time: lsm_stage_begin takes the job lock and publishes the
// job, lsm_stage_wait(i) returns once block i has landed (the caller copies
// unclaimed blocks itself meanwhile), lsm_stage_end waits for every block,
// closes the job and releases the lock. A block is claimed through one
// 64-bit ticket, (generation << 32) | next block, so a helper that wakes
// late can never claim a block of a later job with the earlier job's view.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <system_error>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxBlocks = 256;
constexpr uint32_t kClosed = 0xffffffffu;

struct Pool {
  std::mutex job_lock;                 // held from lsm_stage_begin to lsm_stage_end
  std::mutex wake_lock;
  std::condition_variable wake;
  int helpers = 0;

  // The job. Written by the caller only while its ticket is closed.
  char* dst = nullptr;
  const char* src = nullptr;
  int64_t rows = 0, row_bytes = 0, src_stride = 0, per_block = 0;
  std::atomic<uint32_t> blocks{0};
  std::atomic<uint32_t> generation{0};
  std::atomic<uint64_t> ticket{kClosed};
  std::atomic<int> landed[kMaxBlocks];

  void copy(uint32_t b) {
    const int64_t r0 = b * per_block, r1 = std::min(rows, r0 + per_block);
    if (src_stride == row_bytes) {
      std::memcpy(dst + r0 * row_bytes, src + r0 * row_bytes, (r1 - r0) * row_bytes);
    } else {
      for (int64_t r = r0; r < r1; ++r)
        std::memcpy(dst + r * row_bytes, src + r * src_stride, row_bytes);
    }
    landed[b].store(1, std::memory_order_release);
  }

  // Claim the next block of job `gen` and copy it; false once none is left.
  bool claim_and_copy(uint32_t gen) {
    uint64_t t = ticket.load(std::memory_order_acquire);
    for (;;) {
      const uint32_t b = static_cast<uint32_t>(t);
      if ((t >> 32) != gen || b == kClosed || b >= blocks.load(std::memory_order_relaxed))
        return false;
      if (ticket.compare_exchange_weak(t, t + 1, std::memory_order_acq_rel)) {
        copy(b);
        return true;
      }
    }
  }

  void helper() {
    uint32_t seen = 0;                   // generations start at 1: join a job in progress
    for (;;) {
      uint32_t gen;
      {
        std::unique_lock<std::mutex> lk(wake_lock);
        wake.wait(lk, [&] { return generation.load(std::memory_order_acquire) != seen; });
        gen = generation.load(std::memory_order_acquire);
      }
      seen = gen;
      while (claim_and_copy(gen)) {
      }
    }
  }

  void grow(int n) {
    for (; helpers < n; ++helpers) {
      try {
        std::thread([this] { helper(); }).detach();
      } catch (const std::system_error&) {
        return;                          // fewer helpers: the caller copies the rest
      }
    }
  }
};

// Never destroyed: helpers block on its members for the life of the process.
Pool& pool() {
  static Pool* p = new Pool();
  return *p;
}

}  // namespace

extern "C" {

// Copy `rows` rows of `row_bytes` bytes from `src` (rows `src_stride` bytes
// apart, any sign) to the contiguous `dst`, in blocks of `per_block` rows,
// on the calling thread and up to `threads` - 1 helpers. Returns the number
// of blocks, or -1 (and starts nothing) on arguments it cannot take.
int lsm_stage_begin(void* dst, const void* src, int64_t rows, int64_t row_bytes,
                    int64_t src_stride, int64_t per_block, int threads) {
  if (rows < 1 || row_bytes < 0 || per_block < 1 || threads < 1) return -1;
  const int64_t n = (rows + per_block - 1) / per_block;
  if (n > kMaxBlocks) return -1;
  Pool& p = pool();
  p.job_lock.lock();
  p.grow(std::min<int64_t>(threads, n) - 1);
  p.dst = static_cast<char*>(dst);
  p.src = static_cast<const char*>(src);
  p.rows = rows;
  p.row_bytes = row_bytes;
  p.src_stride = src_stride;
  p.per_block = per_block;
  p.blocks.store(static_cast<uint32_t>(n), std::memory_order_relaxed);
  for (int64_t b = 0; b < n; ++b) p.landed[b].store(0, std::memory_order_relaxed);
  const uint32_t gen = p.generation.load(std::memory_order_relaxed) + 1;
  p.ticket.store(static_cast<uint64_t>(gen) << 32, std::memory_order_release);
  {
    std::lock_guard<std::mutex> lk(p.wake_lock);
    p.generation.store(gen, std::memory_order_release);
  }
  p.wake.notify_all();
  return static_cast<int>(n);
}

// Return once block `b` of the current job has landed, copying unclaimed
// blocks on the calling thread meanwhile.
void lsm_stage_wait(int b) {
  Pool& p = pool();
  const uint32_t gen = p.generation.load(std::memory_order_relaxed);
  while (!p.landed[b].load(std::memory_order_acquire)) {
    if (!p.claim_and_copy(gen)) std::this_thread::yield();
  }
}

// Wait for every block, close the job and release the job lock.
void lsm_stage_end(void) {
  Pool& p = pool();
  const uint32_t n = p.blocks.load(std::memory_order_relaxed);
  for (uint32_t b = 0; b < n; ++b) lsm_stage_wait(static_cast<int>(b));
  p.ticket.store((static_cast<uint64_t>(p.generation.load(std::memory_order_relaxed)) << 32) |
                     kClosed,
                 std::memory_order_release);
  p.job_lock.unlock();
}

}  // extern "C"
