/* Seqlock frame-ring primitives (C11 atomics).
 *
 * Native core of shrimpy_tpu.viewer.ring.FrameRing — the role the
 * reference fills with Micro-Manager's C++ circular buffer (reference
 * shrimpy/__init__.py:13-15 sizes it; viewer/ring_buffer.py layers the
 * preview ring on top). The Python ring's int64 slot-sequence stores
 * are plain numpy writes with NO ordering guarantees: a reader on
 * another core may observe the new sequence number before the frame
 * bytes, or torn frame bytes with a consistent-looking sequence. This
 * module implements the actual seqlock protocol:
 *
 *   writer:  seq[slot] = -1            (torn marker)
 *            release fence             (marker visible before data)
 *            memcpy(frame)
 *            release fence             (data visible before publish)
 *            seq[slot] = seqno         (publish)
 *
 *   reader:  s0 = seq[slot]; acquire fence
 *            memcpy(out)
 *            acquire fence; s1 = seq[slot]
 *            torn iff s0 != s1 or s0 < 0
 *
 * Calls are made through ctypes, which drops the GIL for the duration
 * — a production-scan write burst (~1200 slices/volume) runs
 * concurrently with the acquisition engine's Python control loop.
 *
 * Layout contract (must match ring.py): the shared segment is
 * [ n_slots x int64 seq | n_slots x frame_bytes frames ], and the
 * int64 header is 8-byte aligned (shm segments are page-aligned).
 *
 * Build: shrimpy_tpu/native/build.py compiles this lazily with the
 * host cc into a content-hashed .so; the Python ring falls back to
 * the numpy path when no compiler is available.
 */

#include <stdatomic.h>
#include <stdint.h>
#include <string.h>

/* The header is typed _Atomic through these helpers only; the Python
 * side never writes the header of a slot concurrently with us (one
 * writer per ring — the feeder thread), so plain int64 storage with
 * atomic accessors is sufficient and keeps the numpy view valid. */

static inline _Atomic int64_t *slot_seq(int64_t *seq, int64_t slot)
{
    return (_Atomic int64_t *)(seq + slot);
}

void shrimpy_ring_write(int64_t *seq, char *frames, int64_t n_slots,
                        int64_t frame_bytes, int64_t seqno,
                        const char *frame)
{
    int64_t slot = seqno % n_slots;
    atomic_store_explicit(slot_seq(seq, slot), -1, memory_order_relaxed);
    atomic_thread_fence(memory_order_release);
    memcpy(frames + slot * frame_bytes, frame, (size_t)frame_bytes);
    atomic_thread_fence(memory_order_release);
    atomic_store_explicit(slot_seq(seq, slot), seqno, memory_order_relaxed);
}

/* Returns the frame's sequence number, or -1 if the slot was torn
 * (overwritten during the copy) or never written. */
int64_t shrimpy_ring_read(int64_t *seq, const char *frames,
                          int64_t n_slots, int64_t frame_bytes,
                          int64_t slot, char *out)
{
    int64_t s0 = atomic_load_explicit(slot_seq(seq, slot),
                                      memory_order_relaxed);
    atomic_thread_fence(memory_order_acquire);
    memcpy(out, frames + slot * frame_bytes, (size_t)frame_bytes);
    atomic_thread_fence(memory_order_acquire);
    int64_t s1 = atomic_load_explicit(slot_seq(seq, slot),
                                      memory_order_relaxed);
    return (s0 == s1 && s0 >= 0) ? s0 : -1;
}

/* Row gather for the live deskew preview (ring.py read_rows): copy one
 * Y-row (row_bytes at row_off within each frame) from each listed slot
 * into out. Slots < 0 leave their (pre-zeroed) row untouched. Row
 * tearing is accepted — same best-effort contract as the Python path.
 */
void shrimpy_ring_read_rows(const char *frames, int64_t frame_bytes,
                            int64_t row_off, int64_t row_bytes,
                            const int64_t *slots, int64_t n, char *out)
{
    for (int64_t i = 0; i < n; i++) {
        if (slots[i] >= 0) {
            memcpy(out + i * row_bytes,
                   frames + slots[i] * frame_bytes + row_off,
                   (size_t)row_bytes);
        }
    }
}
