// mercury-tpu native runtime: the host-side streaming engine.
//
// TPU-native equivalents of the reference's C runtime pieces:
//  - rt_ring:   thread-safe sample ring buffer (reference: audioio.c
//               playback/capture rings via common/ring_buffer_posix.cc)
//  - rt_window: sliding capture window that advances one OFDM-symbol period
//               at a time with frames_to_read/data_ready gating (reference:
//               radio_capture_prep_thread, audioio.c:999-1069)
//  - rt_shm:    POSIX shared-memory byte ring for external-app payload IPC
//               (reference: "/mercury-comm", common_defines.h:207-209)
//
// Exposed as a plain C ABI consumed from Python via ctypes; the TPU compute
// path stays in JAX/XLA — this module is the realtime I/O runtime around it.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <new>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// rt_ring: MPMC float ring with blocking reads
struct rt_ring {
  std::vector<float> buf;
  size_t head = 0, tail = 0, count = 0;
  std::mutex m;
  std::condition_variable cv;
};

rt_ring *rt_ring_create(size_t capacity) {
  auto *r = new (std::nothrow) rt_ring;
  if (!r) return nullptr;
  r->buf.resize(capacity);
  return r;
}

void rt_ring_destroy(rt_ring *r) { delete r; }

size_t rt_ring_write(rt_ring *r, const float *data, size_t n) {
  std::lock_guard<std::mutex> lk(r->m);
  size_t cap = r->buf.size();
  size_t free_n = cap - r->count;
  size_t w = n < free_n ? n : free_n;
  for (size_t i = 0; i < w; i++) {
    r->buf[r->head] = data[i];
    r->head = (r->head + 1) % cap;
  }
  r->count += w;
  r->cv.notify_all();
  return w;
}

size_t rt_ring_read(rt_ring *r, float *out, size_t n, int timeout_ms) {
  std::unique_lock<std::mutex> lk(r->m);
  if (timeout_ms > 0 && r->count < n) {
    r->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                   [&] { return r->count >= n; });
  }
  size_t cap = r->buf.size();
  size_t avail = r->count < n ? r->count : n;
  for (size_t i = 0; i < avail; i++) {
    out[i] = r->buf[r->tail];
    r->tail = (r->tail + 1) % cap;
  }
  r->count -= avail;
  return avail;
}

size_t rt_ring_size(rt_ring *r) {
  std::lock_guard<std::mutex> lk(r->m);
  return r->count;
}

void rt_ring_clear(rt_ring *r) {
  std::lock_guard<std::mutex> lk(r->m);
  r->head = r->tail = r->count = 0;
}

// ---------------------------------------------------------------------------
// rt_window: sliding capture window with symbol-period advancement
struct rt_window {
  std::vector<float> window;   // delayed capture window (buffer_Nsymb symbols)
  std::vector<float> pending;  // samples not yet shifted in
  size_t symbol_len;
  std::atomic<int> frames_to_read{0};
  std::atomic<int> data_ready{0};
  std::atomic<int> n_under{0};  // shifts while the consumer was busy
  std::mutex m;
};

rt_window *rt_window_create(size_t window_len, size_t symbol_len) {
  auto *w = new (std::nothrow) rt_window;
  if (!w) return nullptr;
  w->window.assign(window_len, 0.0f);
  w->symbol_len = symbol_len;
  return w;
}

void rt_window_destroy(rt_window *w) { delete w; }

// Append capture samples; the window shifts left one symbol period at a time
// (exactly the reference capture-prep protocol: frames_to_read counts down,
// data_ready latches when it hits zero, extra shifts count n_under).
void rt_window_push(rt_window *w, const float *samples, size_t n) {
  std::lock_guard<std::mutex> lk(w->m);
  w->pending.insert(w->pending.end(), samples, samples + n);
  size_t sym = w->symbol_len;
  size_t wlen = w->window.size();
  while (w->pending.size() >= sym) {
    std::memmove(w->window.data(), w->window.data() + sym,
                 (wlen - sym) * sizeof(float));
    std::memcpy(w->window.data() + wlen - sym, w->pending.data(),
                sym * sizeof(float));
    w->pending.erase(w->pending.begin(), w->pending.begin() + sym);
    int ftr = w->frames_to_read.load();
    if (ftr > 0) {
      w->frames_to_read.store(ftr - 1);
      if (ftr - 1 == 0) w->data_ready.store(1);
    } else if (w->data_ready.load() == 1) {
      w->n_under.fetch_add(1);
    }
  }
}

int rt_window_snapshot(rt_window *w, float *out) {
  std::lock_guard<std::mutex> lk(w->m);
  std::memcpy(out, w->window.data(), w->window.size() * sizeof(float));
  int ready = w->data_ready.load();
  return ready;
}

void rt_window_arm(rt_window *w, int frames_to_read) {
  std::lock_guard<std::mutex> lk(w->m);
  w->frames_to_read.store(frames_to_read);
  w->data_ready.store(0);
  w->n_under.store(0);
}

int rt_window_nunder(rt_window *w) { return w->n_under.load(); }
int rt_window_ready(rt_window *w) { return w->data_ready.load(); }

void rt_window_clear(rt_window *w) {
  std::lock_guard<std::mutex> lk(w->m);
  std::fill(w->window.begin(), w->window.end(), 0.0f);
  w->pending.clear();
}

// ---------------------------------------------------------------------------
// rt_pool: vectorized many-channel sliding-window pool (the serving-scale
// form of rt_window: one contiguous [n_ch, window_len] circular store, bulk
// feed, and a single-call gather of every ready channel into contiguous
// rows for the batched TPU dispatch). Per-channel semantics are identical
// to rt_window's capture-prep protocol (frames_to_read countdown per
// committed symbol, data_ready latch, n_under on extra shifts) but the
// window never memmoves: each channel is a ring, linearized only at gather
// time (two memcpys per ready row).
struct rt_pool {
  size_t n_ch, wlen, sym;
  std::vector<float> buf;       // [n_ch, wlen] circular per channel
  std::vector<size_t> head;     // per-channel next-write offset (symbol-aligned)
  std::vector<float> stage;     // [n_ch, sym] partial-symbol staging
  std::vector<size_t> phase;    // staged samples per channel
  std::vector<int> ftr;         // frames_to_read countdown
  std::vector<uint8_t> ready;   // data_ready latch
  std::vector<int> nunder;
  std::mutex m;
};

rt_pool *rt_pool_create(size_t n_ch, size_t window_len, size_t symbol_len) {
  if (symbol_len == 0 || window_len % symbol_len != 0) return nullptr;
  auto *p = new (std::nothrow) rt_pool;
  if (!p) return nullptr;
  p->n_ch = n_ch;
  p->wlen = window_len;
  p->sym = symbol_len;
  p->buf.assign(n_ch * window_len, 0.0f);
  p->head.assign(n_ch, 0);
  p->stage.assign(n_ch * symbol_len, 0.0f);
  p->phase.assign(n_ch, 0);
  p->ftr.assign(n_ch, 0);
  p->ready.assign(n_ch, 0);
  p->nunder.assign(n_ch, 0);
  return p;
}

void rt_pool_destroy(rt_pool *p) { delete p; }

static void pool_commit_symbol(rt_pool *p, size_t ch) {
  std::memcpy(p->buf.data() + ch * p->wlen + p->head[ch],
              p->stage.data() + ch * p->sym, p->sym * sizeof(float));
  p->head[ch] += p->sym;
  if (p->head[ch] == p->wlen) p->head[ch] = 0;
  int f = p->ftr[ch];
  if (f > 0) {
    p->ftr[ch] = f - 1;
    if (f - 1 == 0) p->ready[ch] = 1;
  } else if (p->ready[ch]) {
    p->nunder[ch]++;
  }
}

static void pool_feed_one(rt_pool *p, size_t ch, const float *data, size_t n) {
  size_t i = 0;
  while (i < n) {
    size_t take = p->sym - p->phase[ch];
    if (take > n - i) take = n - i;
    std::memcpy(p->stage.data() + ch * p->sym + p->phase[ch], data + i,
                take * sizeof(float));
    p->phase[ch] += take;
    i += take;
    if (p->phase[ch] == p->sym) {
      pool_commit_symbol(p, ch);
      p->phase[ch] = 0;
    }
  }
}

void rt_pool_feed(rt_pool *p, size_t ch, const float *data, size_t n) {
  if (ch >= p->n_ch) return;
  std::lock_guard<std::mutex> lk(p->m);
  pool_feed_one(p, ch, data, n);
}

// Feed every channel the same number of samples from one contiguous
// [n_ch, n_per_ch] block — ONE ctypes call for the whole pool tick.
void rt_pool_feed_block(rt_pool *p, const float *data, size_t n_per_ch) {
  std::lock_guard<std::mutex> lk(p->m);
  for (size_t ch = 0; ch < p->n_ch; ch++)
    pool_feed_one(p, ch, data + ch * n_per_ch, n_per_ch);
}

void rt_pool_arm(rt_pool *p, size_t ch, int frames_to_read) {
  if (ch >= p->n_ch) return;
  std::lock_guard<std::mutex> lk(p->m);
  p->ftr[ch] = frames_to_read;
  p->ready[ch] = 0;
  p->nunder[ch] = 0;
}

void rt_pool_arm_many(rt_pool *p, const int32_t *chans,
                      const int32_t *frames, size_t k) {
  std::lock_guard<std::mutex> lk(p->m);
  for (size_t i = 0; i < k; i++) {
    size_t ch = (size_t)chans[i];
    if (ch >= p->n_ch) continue;
    p->ftr[ch] = frames[i];
    p->ready[ch] = 0;
    p->nunder[ch] = 0;
  }
}

long rt_pool_ready_count(rt_pool *p) {
  std::lock_guard<std::mutex> lk(p->m);
  long c = 0;
  for (size_t ch = 0; ch < p->n_ch; ch++) c += p->ready[ch] != 0;
  return c;
}

// Linearize every ready channel's window into contiguous rows of `out`
// ([max_r, window_len]) and record their channel ids; returns the number
// of rows written. One pass, two memcpys per row (ring split).
long rt_pool_gather_ready(rt_pool *p, float *out, int32_t *idx_out,
                          size_t max_r) {
  std::lock_guard<std::mutex> lk(p->m);
  size_t r = 0;
  for (size_t ch = 0; ch < p->n_ch && r < max_r; ch++) {
    if (!p->ready[ch]) continue;
    const float *src = p->buf.data() + ch * p->wlen;
    size_t h = p->head[ch];
    float *row = out + r * p->wlen;
    std::memcpy(row, src + h, (p->wlen - h) * sizeof(float));
    if (h) std::memcpy(row + (p->wlen - h), src, h * sizeof(float));
    idx_out[r] = (int32_t)ch;
    r++;
  }
  return (long)r;
}

int rt_pool_nunder(rt_pool *p, size_t ch) {
  std::lock_guard<std::mutex> lk(p->m);
  return ch < p->n_ch ? p->nunder[ch] : 0;
}

void rt_pool_clear(rt_pool *p) {
  std::lock_guard<std::mutex> lk(p->m);
  std::fill(p->buf.begin(), p->buf.end(), 0.0f);
  std::fill(p->head.begin(), p->head.end(), 0);
  std::fill(p->phase.begin(), p->phase.end(), 0);
}

// ---------------------------------------------------------------------------
// rt_shm: shared-memory byte ring (header: write_idx, read_idx, capacity)
struct shm_hdr {
  std::atomic<uint64_t> widx;
  std::atomic<uint64_t> ridx;
  uint64_t capacity;
};

struct rt_shm {
  shm_hdr *hdr = nullptr;
  uint8_t *data = nullptr;
  size_t map_len = 0;
  int fd = -1;
  bool owner = false;
  char name[128];
};

rt_shm *rt_shm_open(const char *name, size_t size, int create) {
  auto *s = new (std::nothrow) rt_shm;
  if (!s) return nullptr;
  std::snprintf(s->name, sizeof(s->name), "%s", name);
  s->owner = create != 0;
  int flags = create ? (O_CREAT | O_RDWR) : O_RDWR;
  s->fd = shm_open(name, flags, 0660);
  if (s->fd < 0) { delete s; return nullptr; }
  s->map_len = sizeof(shm_hdr) + size;
  if (create && ftruncate(s->fd, (off_t)s->map_len) != 0) {
    close(s->fd); delete s; return nullptr;
  }
  void *p = mmap(nullptr, s->map_len, PROT_READ | PROT_WRITE, MAP_SHARED,
                 s->fd, 0);
  if (p == MAP_FAILED) { close(s->fd); delete s; return nullptr; }
  s->hdr = reinterpret_cast<shm_hdr *>(p);
  s->data = reinterpret_cast<uint8_t *>(p) + sizeof(shm_hdr);
  if (create) {
    s->hdr->widx.store(0);
    s->hdr->ridx.store(0);
    s->hdr->capacity = size;
  }
  return s;
}

void rt_shm_close(rt_shm *s) {
  if (!s) return;
  if (s->hdr) munmap(s->hdr, s->map_len);
  if (s->fd >= 0) close(s->fd);
  if (s->owner) shm_unlink(s->name);
  delete s;
}

long rt_shm_write(rt_shm *s, const uint8_t *data, size_t n) {
  uint64_t cap = s->hdr->capacity;
  uint64_t w = s->hdr->widx.load(std::memory_order_acquire);
  uint64_t r = s->hdr->ridx.load(std::memory_order_acquire);
  uint64_t free_n = cap - (w - r);
  if (n > free_n) n = free_n;
  for (size_t i = 0; i < n; i++) s->data[(w + i) % cap] = data[i];
  s->hdr->widx.store(w + n, std::memory_order_release);
  return (long)n;
}

long rt_shm_read(rt_shm *s, uint8_t *out, size_t n) {
  uint64_t cap = s->hdr->capacity;
  uint64_t w = s->hdr->widx.load(std::memory_order_acquire);
  uint64_t r = s->hdr->ridx.load(std::memory_order_acquire);
  uint64_t avail = w - r;
  if (n > avail) n = avail;
  for (size_t i = 0; i < n; i++) out[i] = s->data[(r + i) % cap];
  s->hdr->ridx.store(r + n, std::memory_order_release);
  return (long)n;
}

long rt_shm_size(rt_shm *s) {
  return (long)(s->hdr->widx.load() - s->hdr->ridx.load());
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sanitizer self-test (the TPU-native equivalent of the reference's
// build.sh asan/ubsan modes, README.md:60-67): build with
//   g++ -std=c++17 -O1 -g -fsanitize=address,undefined -DRT_SELFTEST \
//       runtime.cc -o rt_selftest -lpthread -lrt
// and run; exercises the ring and sliding-window protocols across threads
// under the sanitizers (tests/test_native.py::test_sanitized_selftest).
#ifdef RT_SELFTEST
#include <cstdio>
#include <thread>
#include <vector>

int main() {
  // ring: producer/consumer across threads, data integrity
  rt_ring *ring = rt_ring_create(4096);
  const size_t total = 100000;
  std::thread prod([&] {
    std::vector<float> buf(337);
    size_t sent = 0;
    while (sent < total) {
      size_t n = std::min(buf.size(), total - sent);
      for (size_t i = 0; i < n; i++) buf[i] = (float)(sent + i);
      size_t w = rt_ring_write(ring, buf.data(), n);
      sent += w;
      if (w == 0) std::this_thread::yield();
    }
  });
  size_t got = 0;
  std::vector<float> rbuf(501);
  while (got < total) {
    size_t n = rt_ring_read(ring, rbuf.data(), rbuf.size(), 100);
    for (size_t i = 0; i < n; i++) {
      if (rbuf[i] != (float)(got + i)) {
        std::fprintf(stderr, "ring data mismatch at %zu\n", got + i);
        return 1;
      }
    }
    got += n;
  }
  prod.join();
  rt_ring_destroy(ring);

  // sliding window: capture-prep protocol (push one symbol at a time,
  // snapshot under the countdown gate) with a concurrent reader
  const size_t sym = 256, nsym = 8;
  rt_window *w = rt_window_create(sym * nsym, sym);
  rt_window_arm(w, (int)nsym);
  std::thread reader([&] {
    std::vector<float> snap(sym * nsym);
    for (int k = 0; k < 50; k++) {
      if (rt_window_ready(w)) {
        if (rt_window_snapshot(w, snap.data())) rt_window_arm(w, 2);
      }
      std::this_thread::yield();
    }
  });
  std::vector<float> s(sym);
  for (int k = 0; k < 200; k++) {
    for (size_t i = 0; i < sym; i++) s[i] = (float)(k * sym + i);
    rt_window_push(w, s.data(), sym);
  }
  reader.join();
  rt_window_destroy(w);

  // window pool: bulk feed across channels with a concurrent gatherer;
  // per-channel countdown/ready semantics must match rt_window's
  {
    const size_t psym = 128, pnsym = 6, nch = 16;
    rt_pool *pool = rt_pool_create(nch, psym * pnsym, psym);
    if (!pool) { std::fprintf(stderr, "pool create failed\n"); return 1; }
    for (size_t c = 0; c < nch; c++) rt_pool_arm(pool, c, (int)pnsym);
    std::thread gatherer([&] {
      std::vector<float> rows(nch * psym * pnsym);
      std::vector<int32_t> ids(nch);
      for (int k = 0; k < 40; k++) {
        long r = rt_pool_gather_ready(pool, rows.data(), ids.data(), nch);
        for (long i = 0; i < r; i++) rt_pool_arm(pool, (size_t)ids[i], 2);
        std::this_thread::yield();
      }
    });
    std::vector<float> blk(nch * 200);
    for (int k = 0; k < 100; k++) {
      for (size_t i = 0; i < blk.size(); i++) blk[i] = (float)(k + (int)i);
      rt_pool_feed_block(pool, blk.data(), 200);
    }
    gatherer.join();
    // data correctness single-channel: last window must equal the tail of
    // the fed sequence (fed 100*200=20000 samples; window holds last 768
    // committed samples; phase = 20000 % 128 = 32 staged)
    rt_pool *p1 = rt_pool_create(1, psym * pnsym, psym);
    std::vector<float> seq(20000);
    for (size_t i = 0; i < seq.size(); i++) seq[i] = (float)i;
    rt_pool_feed(p1, 0, seq.data(), seq.size());
    rt_pool_arm(p1, 0, 0);  // make it gatherable
    std::vector<float> row(psym * pnsym);
    int32_t id1;
    rt_pool_arm(p1, 0, 1);
    rt_pool_feed(p1, 0, seq.data(), psym);  // one more symbol -> ready
    if (rt_pool_gather_ready(p1, row.data(), &id1, 1) != 1) {
      std::fprintf(stderr, "pool not ready\n"); return 1;
    }
    size_t committed = (seq.size() / psym) * psym + psym;
    for (size_t i = 0; i < row.size() - psym; i++) {
      float want = (float)(committed - psym - (row.size() - psym) + i);
      if (row[i] != want) {
        std::fprintf(stderr, "pool window mismatch at %zu: %f vs %f\n",
                     i, row[i], want);
        return 1;
      }
    }
    rt_pool_destroy(p1);
    rt_pool_destroy(pool);
  }

  // shm ring: write/read through the POSIX shared-memory circular buffer
  rt_shm *a = rt_shm_open("/mercury-rt-selftest", 1 << 12, 1);
  rt_shm *b = rt_shm_open("/mercury-rt-selftest", 1 << 12, 0);
  if (!a || !b) { std::fprintf(stderr, "shm open failed\n"); return 1; }
  uint8_t msg[300], back[300];
  for (int i = 0; i < 300; i++) msg[i] = (uint8_t)(i * 7);
  for (int round = 0; round < 40; round++) {
    if (rt_shm_write(a, msg, sizeof msg) != (long)sizeof msg) return 1;
    if (rt_shm_read(b, back, sizeof back) != (long)sizeof back) return 1;
    for (int i = 0; i < 300; i++)
      if (back[i] != msg[i]) { std::fprintf(stderr, "shm mismatch\n"); return 1; }
  }
  rt_shm_close(a);
  rt_shm_close(b);
  std::puts("rt_selftest OK");
  return 0;
}
#endif  // RT_SELFTEST
