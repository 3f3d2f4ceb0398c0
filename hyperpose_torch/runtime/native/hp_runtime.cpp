// Native host-runtime core: bounded MPMC ring queues + an affinity-pinned
// worker pool, exposed C-style for ctypes.
//
// Host-side counterpart of the reference's C++ concurrency layer
// (reference: include/hyperpose/utility/thread_safe_queue.hpp:16-193,
// src/thread_pool.cpp:39-68, src/stream.cpp:18-183). The queues carry opaque
// 64-bit tokens (the Python side maps tokens to frame objects), so the hot
// hand-off path between pipeline stages never takes the GIL.
//
// A copy of hyperpose_tpu/runtime/native/hp_runtime.cpp for the PyTorch port,
// which builds it at first use (runtime/native/__init__.py):
//   g++ -O3 -std=c++17 -shared -fPIC -o libhp_runtime-<hash>.so \
//       hp_runtime.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__linux__)
#include <pthread.h>
#include <sched.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Bounded MPMC ring queue of int64 tokens
// (reference: thread_safe_queue.hpp — fixed capacity ring buffer with
// blocking wait_until_pushed / dump semantics).
// ---------------------------------------------------------------------------

struct HpQueue {
    explicit HpQueue(int64_t capacity)
        : cap(capacity), buf(static_cast<size_t>(capacity)) {}

    int64_t cap;
    std::vector<int64_t> buf;
    int64_t head = 0;  // next pop position
    int64_t size = 0;
    bool closed = false;
    int64_t total_pushed = 0;
    int64_t total_popped = 0;
    std::mutex mu;
    std::condition_variable cv_push;  // waits for space
    std::condition_variable cv_pop;   // waits for items
};

HpQueue* hp_queue_new(int64_t capacity) { return new HpQueue(capacity); }

void hp_queue_free(HpQueue* q) { delete q; }

// Blocking push; returns 0 on success, -1 if the queue is closed.
int hp_queue_push(HpQueue* q, int64_t token) {
    std::unique_lock<std::mutex> lk(q->mu);
    q->cv_push.wait(lk, [&] { return q->size < q->cap || q->closed; });
    if (q->closed) return -1;
    q->buf[static_cast<size_t>((q->head + q->size) % q->cap)] = token;
    q->size++;
    q->total_pushed++;
    q->cv_pop.notify_one();
    return 0;
}

// Non-blocking push; returns 0 ok, 1 full, -1 closed.
int hp_queue_try_push(HpQueue* q, int64_t token) {
    std::unique_lock<std::mutex> lk(q->mu);
    if (q->closed) return -1;
    if (q->size >= q->cap) return 1;
    q->buf[static_cast<size_t>((q->head + q->size) % q->cap)] = token;
    q->size++;
    q->total_pushed++;
    q->cv_pop.notify_one();
    return 0;
}

// Blocking pop with timeout (ms; <0 = infinite). Returns 0 ok (token in
// *out), 1 timeout, -1 closed-and-empty.
int hp_queue_pop(HpQueue* q, int64_t* out, int64_t timeout_ms) {
    std::unique_lock<std::mutex> lk(q->mu);
    auto ready = [&] { return q->size > 0 || q->closed; };
    if (timeout_ms < 0) {
        q->cv_pop.wait(lk, ready);
    } else if (!q->cv_pop.wait_for(
                   lk, std::chrono::milliseconds(timeout_ms), ready)) {
        return 1;
    }
    if (q->size == 0) return -1;  // closed and drained
    *out = q->buf[static_cast<size_t>(q->head % q->cap)];
    q->head = (q->head + 1) % q->cap;
    q->size--;
    q->total_popped++;
    q->cv_push.notify_one();
    return 0;
}

// Greedy batch pop: wait for >=1 item (or closed), then drain up to
// max_items without further waiting (reference: stream DNN worker
// dump(max_batch_size), stream.hpp:326-345). Returns count (0 => closed).
int64_t hp_queue_dump(HpQueue* q, int64_t* out, int64_t max_items,
                      int64_t timeout_ms) {
    std::unique_lock<std::mutex> lk(q->mu);
    auto ready = [&] { return q->size > 0 || q->closed; };
    if (timeout_ms < 0) {
        q->cv_pop.wait(lk, ready);
    } else if (!q->cv_pop.wait_for(
                   lk, std::chrono::milliseconds(timeout_ms), ready)) {
        return 0;
    }
    int64_t n = 0;
    while (q->size > 0 && n < max_items) {
        out[n++] = q->buf[static_cast<size_t>(q->head % q->cap)];
        q->head = (q->head + 1) % q->cap;
        q->size--;
        q->total_popped++;
    }
    q->cv_push.notify_all();
    return n;
}

void hp_queue_close(HpQueue* q) {
    std::lock_guard<std::mutex> lk(q->mu);
    q->closed = true;
    q->cv_pop.notify_all();
    q->cv_push.notify_all();
}

// stats[0]=size stats[1]=capacity stats[2]=total_pushed stats[3]=total_popped
// stats[4]=closed (queue monitor parity, reference: src/stream.cpp:149-167)
void hp_queue_stats(HpQueue* q, int64_t* stats) {
    std::lock_guard<std::mutex> lk(q->mu);
    stats[0] = q->size;
    stats[1] = q->cap;
    stats[2] = q->total_pushed;
    stats[3] = q->total_popped;
    stats[4] = q->closed ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Worker pool with CPU-affinity pinning
// (reference: src/thread_pool.cpp:39-48 pins each worker to a core).
// Tasks are C callbacks (fn(ctx)) so Python can drive it via ctypes
// trampolines when needed; primarily used by the native pipeline below.
// ---------------------------------------------------------------------------

typedef void (*hp_task_fn)(void*);

struct HpPool {
    explicit HpPool(int n_threads, int pin) {
        stop = false;
        for (int i = 0; i < n_threads; ++i) {
            workers.emplace_back([this, i, pin] {
#if defined(__linux__)
                if (pin) {
                    cpu_set_t set;
                    CPU_ZERO(&set);
                    CPU_SET(i % std::thread::hardware_concurrency(), &set);
                    pthread_setaffinity_np(pthread_self(), sizeof(set), &set);
                }
#endif
                for (;;) {
                    std::function<void()> task;
                    {
                        std::unique_lock<std::mutex> lk(mu);
                        cv.wait(lk, [&] { return stop || !tasks.empty(); });
                        if (stop && tasks.empty()) return;
                        task = std::move(tasks.front());
                        tasks.pop_front();
                    }
                    task();
                    pending.fetch_sub(1);
                }
            });
        }
    }

    ~HpPool() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto& w : workers) w.join();
    }

    std::vector<std::thread> workers;
    std::deque<std::function<void()>> tasks;
    std::mutex mu;
    std::condition_variable cv;
    std::atomic<int64_t> pending{0};
    bool stop;
};

HpPool* hp_pool_new(int n_threads, int pin_affinity) {
    return new HpPool(n_threads, pin_affinity);
}

void hp_pool_free(HpPool* p) { delete p; }

void hp_pool_enqueue(HpPool* p, hp_task_fn fn, void* ctx) {
    p->pending.fetch_add(1);
    {
        std::lock_guard<std::mutex> lk(p->mu);
        p->tasks.emplace_back([fn, ctx] { fn(ctx); });
    }
    p->cv.notify_one();
}

// Spin-wait barrier (reference: thread_pool::wait()).
void hp_pool_wait(HpPool* p) {
    while (p->pending.load() > 0) {
        std::this_thread::yield();
    }
}

// ---------------------------------------------------------------------------
// Native uint8 HWC batcher: copy a frame into a pinned batch slot with
// optional nearest resize (keeps the hot memcpy path off the GIL;
// reference analog: nhwc_images_append_nchw_batch, src/data.cpp:21-51 —
// our device path wants NHWC so no transpose is needed).
// ---------------------------------------------------------------------------

void hp_copy_into_batch(const uint8_t* src, int64_t sh, int64_t sw,
                        uint8_t* dst_batch, int64_t slot, int64_t dh,
                        int64_t dw) {
    uint8_t* dst = dst_batch + slot * dh * dw * 3;
    if (sh == dh && sw == dw) {
        std::memcpy(dst, src, static_cast<size_t>(dh * dw * 3));
        return;
    }
    for (int64_t y = 0; y < dh; ++y) {
        const int64_t sy = y * sh / dh;
        const uint8_t* srow = src + sy * sw * 3;
        uint8_t* drow = dst + y * dw * 3;
        for (int64_t x = 0; x < dw; ++x) {
            const int64_t sx = x * sw / dw;
            std::memcpy(drow + x * 3, srow + sx * 3, 3);
        }
    }
}

// ---------------------------------------------------------------------------
// Bilinear uint8 HWC3 resize into a batch slot, with optional aspect-
// preserving letterbox (top-left placement, black pad) and BGR<->RGB swap.
// cv2 INTER_LINEAR-compatible sampling (half-pixel centers), fixed-point
// 16.16 arithmetic. out_ratio[0]=rx, out_ratio[1]=ry are the canvas
// coverage fractions (reference: src/data.cpp:53-69 non_scaling_resize,
// include/hyperpose/utility/human.hpp:44-58 resume_ratio). This is the
// native data-loader hot path: frames are resized straight into the pinned
// device-staging batch without touching the GIL.
// ---------------------------------------------------------------------------

void hp_resize_into_batch(const uint8_t* src, int64_t sh, int64_t sw,
                          uint8_t* dst_batch, int64_t slot, int64_t dh,
                          int64_t dw, int keep_ratio, int swap_rb,
                          float* out_ratio) {
    uint8_t* dst = dst_batch + slot * dh * dw * 3;
    int64_t nw = dw, nh = dh;
    if (keep_ratio) {
        const double scale =
            std::min(double(dw) / double(sw), double(dh) / double(sh));
        nw = std::max<int64_t>(1, llround(double(sw) * scale));
        nh = std::max<int64_t>(1, llround(double(sh) * scale));
        nw = std::min(nw, dw);
        nh = std::min(nh, dh);
        std::memset(dst, 0, static_cast<size_t>(dh * dw * 3));
    }
    // Two-pass separable bilinear, 11-bit fixed point per pass (cv2's
    // INTER_RESIZE_COEF_BITS): horizontal gather indices (with the BGR->RGB
    // swap folded in) are precomputed once per call; horizontally
    // interpolated rows are cached and reused across output rows that share
    // a source row pair (big win when upscaling).
    constexpr int32_t SHIFT = 11;
    constexpr int32_t ONE = 1 << SHIFT;
    const int64_t rowlen = nw * 3;
    std::vector<int32_t> ia(static_cast<size_t>(rowlen));
    std::vector<int32_t> ib(static_cast<size_t>(rowlen));
    std::vector<int32_t> wx(static_cast<size_t>(rowlen));
    const int c_src[3] = {swap_rb ? 2 : 0, 1, swap_rb ? 0 : 2};
    for (int64_t x = 0; x < nw; ++x) {
        double fx = (x + 0.5) * double(sw) / double(nw) - 0.5;
        fx = std::max(0.0, std::min(fx, double(sw - 1)));
        const int64_t x0 =
            std::min<int64_t>(int64_t(fx), std::max<int64_t>(sw - 2, 0));
        const int32_t w = int32_t((fx - double(x0)) * double(ONE) + 0.5);
        const int64_t step = (x0 + 1 < sw) ? 3 : 0;
        for (int c = 0; c < 3; ++c) {
            const size_t i = static_cast<size_t>(x * 3 + c);
            ia[i] = int32_t(x0 * 3 + c_src[c]);
            ib[i] = int32_t(x0 * 3 + step + c_src[c]);
            wx[i] = w;
        }
    }
    // hbuf holds two horizontally-interpolated source rows (values in
    // [0, 255*ONE], fits int32).
    std::vector<int32_t> hbuf(static_cast<size_t>(2 * rowlen));
    int32_t* rows[2] = {hbuf.data(), hbuf.data() + rowlen};
    int64_t cached[2] = {-1, -1};
    auto hrow = [&](int64_t sy, int which) -> const int32_t* {
        int32_t* out = rows[which];
        if (cached[which] == sy) return out;
        const uint8_t* s = src + sy * sw * 3;
        for (int64_t i = 0; i < rowlen; ++i) {
            const int32_t w = wx[static_cast<size_t>(i)];
            out[i] = int32_t(s[ia[static_cast<size_t>(i)]]) * (ONE - w) +
                     int32_t(s[ib[static_cast<size_t>(i)]]) * w;
        }
        cached[which] = sy;
        return out;
    };
    for (int64_t y = 0; y < nh; ++y) {
        double fy = (y + 0.5) * double(sh) / double(nh) - 0.5;
        fy = std::max(0.0, std::min(fy, double(sh - 1)));
        const int64_t y0 =
            std::min<int64_t>(int64_t(fy), std::max<int64_t>(sh - 2, 0));
        const int64_t y1 = std::min(y0 + 1, sh - 1);
        const int32_t wy = int32_t((fy - double(y0)) * double(ONE) + 0.5);
        if (cached[0] != y0 && cached[1] == y0) {
            std::swap(rows[0], rows[1]);
            std::swap(cached[0], cached[1]);
        }
        const int32_t* h0 = hrow(y0, 0);
        const int32_t* h1 = hrow(y1, 1);
        uint8_t* drow = dst + y * dw * 3;
        for (int64_t i = 0; i < rowlen; ++i) {
            const int64_t v =
                (int64_t(h0[i]) * (ONE - wy) + int64_t(h1[i]) * wy +
                 (int64_t(1) << (2 * SHIFT - 1))) >> (2 * SHIFT);
            drow[i] = uint8_t(v > 255 ? 255 : (v < 0 ? 0 : v));
        }
    }
    out_ratio[0] = float(double(nw) / double(dw));
    out_ratio[1] = float(double(nh) / double(dh));
}

}  // extern "C"
