// L-vector composition for Hopper (sm_90a): the keyed lane-map compose
// (the out-of-order gap-close fold, B3 and B4) and the full-map compose (B7).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   B3  repro/kernels/lvec_compose.py::spec_compose_lanes_kernel       (carry)
//   B4  repro/kernels/lvec_compose.py::spec_compose_lanes_tree_kernel  (tree)
//   B7  repro/kernels/lvec_compose.py::lvec_compose_kernel        (full maps)
//
// B3 and B4 fold, per run b, the candidate-keyed [K, S] lane maps
// lanes[b, 0..N-1]: element 0 seeds the result (its key is never read);
// element i folds in through the keyed Eq. 8 combine
//     lane = cand_index[keys[b, i], acc]
//     acc  = lane < 0 ? (sinks[k] >= 0 ? sinks[k] : acc)
//                     : lanes[b, i, k, lane]        (within pattern k's lanes)
// and a key equal to pad_key is the identity.
//
// B3, compose_carry: the sequential left fold.  A combine is two dependent
// loads (the key row, then the map), so a run of N is a chain of 2(N-1)
// dependent loads per lane; the design makes both of them shared-memory
// loads.  A producer warp streams each element's key row of cand_index and
// its [K*S] lane map into a ring of STAGES tiles (`tile` elements of `runs`
// runs each).  A run's maps of a tile are one bulk copy (cp.async.bulk,
// complete_tx on the stage's mbarrier) of the aligned 16-byte units that
// hold them, and so is each distinct key's row of the tile (a key that
// recurs in the tile is staged once: the rows of frequent keys are what
// every CTA reads from the same few L2 lines).  4-byte cp.async copies take
// what would leave an operand's ends; all of it arrives on one barrier.
// The producer reads each key once per element, STAGES tiles ahead, and
// writes it into the stage with its row's address; a pad_key element gets
// no row and no map and reads a row of -1s, so both sides skip it the
// same way.  A consumer thread holds `lpt` lanes of one run in registers
// (one in a small batch: more warps a run; LPT in a large one), reads
// their sinks once, waits on the stage's parity only and gives it back
// with one arrival per warp -- no __syncthreads in the fold.  In a large
// batch several runs share a CTA (PCRE-14 under r = 2 at B = 1024: 4 runs
// of 210 lanes, 224 consumer threads, two CTAs an SM).  Where one element
// does not fit the ring (a key row and a lane map past four slots: PS00028,
// Q = 43,125 and S = 22,857) or a run has more lanes than a CTA's threads
// carry, carry_plan selects compose_carry_wide: the lanes of a run over
// several CTAs, rows and maps read from global memory.
//
// B4, compose_tree: the same fold as log2(N) levels of pairwise combines in
// place: at stride st slot i (a multiple of 2 st) becomes combine(slot i,
// slot i + st) with the right slot's own key, so a combined pair keeps the
// left key and a miss with no sink falls back to the left operand, as in
// the Pallas tree (the combine is not associative on pad lanes, so every
// order below is the tree's own pairing).  A unit is a run, or an aligned
// power-of-two segment of one; kernels/lvec_compose.py::tree_plan sizes
// the launch.  A producer warp bulk-copies each unit's maps into shared
// memory (the aligned 16-byte units that hold them, as in B3) and each
// distinct key's cand_index row once a CTA (a hash of the CTA's keys; a key
// past the CTA's row slots is read from global memory, a pad_key element is
// skipped); every load of a level's dependent chain -- the left lane, its
// row entry, the right map's lane -- is then a shared-memory load.  A thread
// carries LPT lanes of a unit over hp pair groups, and a unit's threads meet
// at their own named barrier after each level (several runs share a CTA in
// a large batch, so one run never stalls another).  A batch of few long runs
// splits each run into G segments on a thread-block cluster: each CTA
// reduces its segment as a subtree, then rank 0 gathers the cluster's
// partials through distributed shared memory and folds them in the tree's
// pairing; past MAX_CLUSTER segments a second launch of the same kernel
// reduces the G / MAX_CLUSTER cluster partials.  A unit that does not fit
// shared memory (PS00028: K*S = 22,857) takes compose_tree_wide, every
// level in a global scratch copy of the run.
//
// Bound of B3/B4 on an H100 SXM (3.35 TB/s): the real maps and keys read
// once, the output written once, at most one cand_index entry per
// lane-combine.  For PCRE-14 under r = 2 (K*S = 210) at B = 1024 runs of
// N = 32 that is ~26 MB, about 7.8 us: bytes bind (two shared loads per
// lane-combine, ~6e6 combines, take ~1.4 us at 8.4e12 loads/s).
//
// B7, lvec_compose: the left-to-right composition of N full [Q] maps,
// out[q] = maps[N-1][...maps[0][q]], batched over B.  Composition is
// associative, so a composition's N maps are split into G segments on G
// CTAs (kernels/lvec_compose.py::lvec_plan picks G to fill the 132 SMs);
// each CTA composes its segment from the identity, one thread per state
// (QPT states when Q exceeds a CTA), the maps streamed through a ring of
// STAGES tiles that a producer warp fills with bulk copies (4-byte cp.async
// where Q % 4 != 0).  The G partials are folded in order within a
// thread-block cluster of up to MAX_CLUSTER CTAs, each CTA reading its
// peers' partials through distributed shared memory between two cluster
// barriers; when G exceeds a cluster, the G / MAX_CLUSTER cluster partials
// go to a scratch [B, G / MAX_CLUSTER, Q] that a second launch of the same
// kernel composes.  Small maps (Q < 64) pack several compositions into one
// CTA.  Maps that do not fit the ring (four slots past shared memory, from
// Q = 14,522) take lvec_compose_wide: the states of a segment over several
// CTAs, maps read from global memory, the same second launch past one
// segment.  Bound: the maps read once at 3.35 TB/s against B*N*Q dependent
// shared loads at 8.4e12/s; bytes bind, and a segment's chain of N/G
// dependent loads is what the split shortens.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "sm90.cuh"

namespace {

// kernels/lvec_compose.py mirrors these (a CPU test holds them equal)
constexpr int STAGES = 4;           // tiles in each ring
constexpr int MAX_CONSUMERS = 992;  // consumer threads of a CTA (+1 producer
                                    // warp = 1024)
constexpr int MAX_CLUSTER = 8;      // portable thread-block cluster size
constexpr int QPT = 16;             // most states a B7 thread carries
constexpr int LPT = 4;              // lanes a B4 thread carries (a B3
                                    // one: in a large batch; one lane in a
                                    // small one)
constexpr int PAIRS = 32;           // most (run, element) pairs of a B3 tile:
                                    // one per producer lane
constexpr int WIDE_THREADS = 256;   // threads of a CTA of the instances for
                                    // operands that do not fit the rings
constexpr int WPT = 4;              // lanes (B3) or states (B7) a thread of
                                    // those carries

__host__ __device__ constexpr unsigned wide_blocks(int width) {
    return (unsigned)((width + WIDE_THREADS * WPT - 1) / (WIDE_THREADS * WPT));
}

// The copy of `words` int32 at `src` into a 16-byte aligned slot of
// slot_words(words): where the aligned 16-byte units that hold the words lie
// within [lo, hi) (the operand), one bulk copy of them, the data `off` words
// into the slot; else 4-byte copies of exactly the words, off 0.
struct Span {
    const int* src;
    int words, off;
    bool bulk;
};

__device__ __forceinline__ Span span(const int* src, int words, const int* lo,
                                     const int* hi) {
    const int off = (int)((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
    const int* start = src - off;
    const int n = (off + words + 3) & ~3;
    if (start >= lo && start + n <= hi) return {start, n, off, true};
    return {src, words, 0, false};
}

__host__ __device__ constexpr uint32_t slot_words(int words) {
    return (uint32_t)(words + 6) & ~3u;
}

// the producer warp's 4-byte copies of `words` int32, spread over its lanes
__device__ __forceinline__ void warp_copy(uint32_t dst, const int* src,
                                          int words, int lane) {
    for (int w = lane; w < words; w += 32)
        sm90::cp_async4(dst + (uint32_t)w * 4, src + w);
}

// close a producer stage: each lane's cp.async copies land before the
// stage's phase can complete, then the lane arrives (release: its plain
// shared stores become visible to the consumers that wait on the phase)
__device__ __forceinline__ void stage_done(uint64_t* full) {
    sm90::cp_async_arrive(full);
    sm90::mbar_arrive(full);
}

// -- B3 ----------------------------------------------------------------------

struct Carry {
    const int* lanes;  // [B, N, K*S]
    const int* keys;   // [B, N]
    const int* cidx;   // [rows, Q]
    const int* sinks;  // [K]
    int* out;          // [B, K*S]
    int B, N, Q, K, S, pad_key, rows;
    int runs;          // runs per CTA
    int tile;          // elements per ring tile; runs * tile <= PAIRS
};

// One stage, in int32 words: the header (the keys [PAIRS]; the byte
// address, from the start of shared memory, of each key row [PAIRS]; each
// run's map offset in its slot [PAIRS], in bytes), the key rows [runs *
// tile, slot_words(Q)], the maps [runs, slot_words(tile * K*S)].  After
// the STAGES stages: a row of Q words of -1 that a pad_key element reads,
// then the barriers.  kernels/lvec_compose.py::carry_stage_bytes and
// carry_plan compute the same sizes.
struct CarryLayout {
    uint32_t qs, ms, rows_off, maps_off, stage, neg, bars;
    __host__ __device__ CarryLayout(const Carry& p) {
        qs = slot_words(p.Q);
        ms = slot_words(p.tile * p.K * p.S);
        rows_off = 3 * PAIRS * 4;
        maps_off = rows_off + (uint32_t)(p.runs * p.tile) * qs * 4;
        stage = maps_off + (uint32_t)p.runs * ms * 4;
        neg = STAGES * stage;
        bars = neg + qs * 4;
    }
};

template <int L>   // lanes a consumer thread carries: 1 or LPT
__global__ void __launch_bounds__(1024, 1) compose_carry(const Carry p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31;
    const int cons = blockDim.x - 32;
    const int ks = p.K * p.S;
    const CarryLayout lay(p);
    const uint32_t base = sm90::smem_addr(smem);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
    uint64_t* empty = full + STAGES;
    const int b0 = blockIdx.x * p.runs;
    const int runs = min(p.runs, p.B - b0);
    const int n_tiles = (p.N + p.tile - 1) / p.tile;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            sm90::mbar_init(&full[s], 32);
            sm90::mbar_init(&empty[s], cons / 32);
        }
        sm90::mbar_init_fence();
    }
    for (int i = tid; i < p.Q; i += blockDim.x)
        reinterpret_cast<int*>(smem + lay.neg)[i] = -1;
    __syncthreads();

    if (tid >= cons) {
        // -- producer warp: lane j holds pair j = (run j / tile, element
        // j % tile) of every tile, and lane r < runs run r's maps
        const int r = lane / p.tile, tt = lane - r * p.tile;
        const bool mine = lane < runs * p.tile;
        const int* keys_r = p.keys + (size_t)(b0 + r) * p.N;
        const int* cidx_end = p.cidx + (size_t)p.rows * p.Q;
        const int* lanes_end = p.lanes + (size_t)p.B * p.N * ks;
        auto key_of = [&](int t) {
            const int i = t * p.tile + tt;
            return mine && i > 0 && i < p.N ? __ldg(keys_r + i) : p.pad_key;
        };
        // the keys of the next STAGES tiles are in flight (a global load's
        // latency would otherwise stall every tile); the loop runs in
        // groups of STAGES tiles, unrolled, so no pending load is moved
        int ahead[STAGES];
#pragma unroll
        for (int a = 0; a < STAGES; ++a) ahead[a] = key_of(a);
        for (int t0 = 0; t0 < n_tiles; t0 += STAGES)
#pragma unroll
        for (int s = 0; s < STAGES; ++s) {
            const int t = t0 + s;
            if (t >= n_tiles) break;
            const int key = ahead[s];
            ahead[s] = key_of(t + STAGES);
            if (t >= STAGES) sm90::mbar_wait(&empty[s], (t / STAGES - 1) & 1);
            const int i0 = t * p.tile, tl = min(p.tile, p.N - i0);
            const uint32_t st = base + s * lay.stage;
            const bool live = mine && tt < tl;
            const bool row = live && key != p.pad_key;
            const bool map = live && (i0 + tt == 0 || key != p.pad_key);
            const Span rs = span(p.cidx + (size_t)(row ? key : 0) * p.Q, p.Q,
                                 p.cidx, cidx_end);
            // one copy of each distinct key's row a tile: the lowest lane of
            // a key copies it, its other pairs read that slot
            const int lead =
                __ffs(__match_any_sync(~0u, row ? key : -1 - lane)) - 1;
            const bool row_copy = row && lead == lane;
            const bool row_bulk = row_copy && rs.bulk;
            // run `lane`'s maps: elements i0 .. the last one that needs a
            // map, rounded up to 4 elements within the tile
            const uint32_t need = __ballot_sync(~0u, map);
            int cnt = 0;
            if (lane < runs) {
                const uint32_t bits = (need >> (lane * p.tile))
                                      & (p.tile == 32 ? ~0u
                                                      : (1u << p.tile) - 1);
                if (bits) cnt = min((32 - __clz(bits) + 3) & ~3, tl);
            }
            const Span ms = span(
                p.lanes + ((size_t)(b0 + (cnt ? lane : 0)) * p.N + i0) * ks,
                cnt * ks, p.lanes, lanes_end);
            const bool map_bulk = cnt && ms.bulk;
            const uint32_t bytes = (row_bulk ? rs.words * 4 : 0)
                                   + (map_bulk ? ms.words * 4 : 0);
            const uint32_t total = __reduce_add_sync(~0u, bytes);
            if (lane == 0 && total) sm90::mbar_expect_tx(&full[s], total);
            int* head = reinterpret_cast<int*>(smem + s * lay.stage);
            head[lane] = row ? key : p.pad_key;
            head[PAIRS + lane] = row ? s * lay.stage + lay.rows_off
                                           + lead * lay.qs * 4 + rs.off * 4
                                     : lay.neg;
            head[2 * PAIRS + lane] = cnt ? ms.off * 4 : 0;
            __syncwarp();
            const uint32_t row_dst = st + lay.rows_off + lane * lay.qs * 4;
            const uint32_t map_dst = st + lay.maps_off + lane * lay.ms * 4;
            if (row_bulk) sm90::bulk_load(row_dst, rs.src, rs.words * 4,
                                          &full[s]);
            if (map_bulk) sm90::bulk_load(map_dst, ms.src, ms.words * 4,
                                          &full[s]);
            for (uint32_t m = __ballot_sync(~0u, cnt && !map_bulk); m;
                 m &= m - 1) {
                const int q = __ffs(m) - 1;
                warp_copy(st + lay.maps_off + q * lay.ms * 4,
                          p.lanes + ((size_t)(b0 + q) * p.N + i0) * ks,
                          __shfl_sync(~0u, cnt, q) * ks, lane);
            }
            for (uint32_t m = __ballot_sync(~0u, row_copy && !row_bulk); m;
                 m &= m - 1) {
                const int q = __ffs(m) - 1;
                warp_copy(st + lay.rows_off + q * lay.qs * 4,
                          p.cidx + (size_t)__shfl_sync(~0u, key, q) * p.Q,
                          p.Q, lane);
            }
            stage_done(&full[s]);
        }
        return;
    }

    // -- consumers: thread t carries lanes g, g + tpr, ... (L of them, tpr =
    // ceil(K*S / L) threads a run) of run t / tpr
    const int tpr = (ks + L - 1) / L;
    const int r = min(tid / tpr, runs - 1), g = tid - (tid / tpr) * tpr;
    const bool live = tid / tpr < runs;
    int acc[L], sink[L];
    uint32_t seed[L], kofs[L];
    bool ok[L];
#pragma unroll
    for (int u = 0; u < L; ++u) {   // a dead lane folds lane 0, unstored
        const int o = g + u * tpr;
        ok[u] = live && o < ks;
        const int k = ok[u] ? o / p.S : 0;
        acc[u] = 0;
        sink[u] = ok[u] ? __ldg(p.sinks + k) : -1;
        seed[u] = ok[u] ? (uint32_t)o * 4 : 0;
        kofs[u] = (uint32_t)(k * p.S) * 4;
    }
    const uint32_t keyw = (uint32_t)r * p.tile * 4;
    const uint32_t mapb = lay.maps_off + (uint32_t)r * lay.ms * 4;
    for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        sm90::mbar_wait(&full[s], (t / STAGES) & 1);
        const int tl = min(p.tile, p.N - t * p.tile);
        const uint32_t st = base + s * lay.stage;
        const uint32_t maps =
            st + mapb + sm90::lds(st + (2 * PAIRS + r) * 4);
        int tt = 0;
        if (t == 0) {   // element 0 seeds the run
#pragma unroll
            for (int u = 0; u < L; ++u)
                acc[u] = (int)sm90::lds(maps + seed[u]);
            tt = 1;
        }
        // each element's key and row address are read one element ahead
        // (the slots past the tile are another run's or unused), off the
        // chain of the two dependent loads.  A pad_key element reads the
        // row of -1s and keeps its state, so the walk has no branch; a lane
        // index is -1 or one of pattern k's lanes, and the map word a -1
        // reads (the one before pattern k's lanes) lies in shared memory
        // and is selected away.
        uint32_t key = sm90::lds(st + keyw + tt * 4);
        uint32_t row = base + sm90::lds(st + PAIRS * 4 + keyw + tt * 4);
        for (; tt < tl; ++tt) {
            const uint32_t next = sm90::lds(st + keyw + (tt + 1) * 4);
            const uint32_t next_row =
                base + sm90::lds(st + PAIRS * 4 + keyw + (tt + 1) * 4);
            const uint32_t map = maps + (uint32_t)(tt * ks) * 4;
            const bool pad = (int)key == p.pad_key;
            int ln[L];
#pragma unroll
            for (int u = 0; u < L; ++u)
                ln[u] = (int)sm90::lds(row + (uint32_t)acc[u] * 4);
#pragma unroll
            for (int u = 0; u < L; ++u) {   // one select after the map load
                const int keep = pad || sink[u] < 0 ? acc[u] : sink[u];
                const int hit = (int)sm90::lds(map + kofs[u]
                                               + (uint32_t)(ln[u] * 4));
                acc[u] = ln[u] < 0 ? keep : hit;
            }
            key = next;
            row = next_row;
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int u = 0; u < L; ++u)
        if (ok[u]) p.out[(size_t)(b0 + r) * ks + g + u * tpr] = acc[u];
}

// B3 where an element does not fit the ring (a cand_index row and a lane map
// past four ring slots, or more lanes than one CTA's threads carry): no
// shared memory; CTA (x, y) folds run x for lanes y * WIDE_THREADS * WPT +
// tid + u * WIDE_THREADS, WPT independent chains a thread.  The key row and
// the map are read from global memory (L2) through the read-only path; a
// warp reads 32 keys at once, one a lane, and passes each to all its lanes
// (a key is the whole CTA's, so the pad_key skip is uniform).
__global__ void __launch_bounds__(WIDE_THREADS) compose_carry_wide(
        const Carry p) {
    const int lane = threadIdx.x & 31;
    const int ks = p.K * p.S;
    const int* lanes_b = p.lanes + (size_t)blockIdx.x * p.N * ks;
    const int* keys_b = p.keys + (size_t)blockIdx.x * p.N;
    const int o0 = blockIdx.y * WIDE_THREADS * WPT + threadIdx.x;
    int acc[WPT], sink[WPT], kofs[WPT];
#pragma unroll
    for (int u = 0; u < WPT; ++u) {   // a lane past K*S folds lane 0, unstored
        const int o = o0 + u * WIDE_THREADS < ks ? o0 + u * WIDE_THREADS : 0;
        const int k = o / p.S;
        acc[u] = __ldg(lanes_b + o);   // element 0 seeds the run
        sink[u] = __ldg(p.sinks + k);
        kofs[u] = k * p.S;
    }
    for (int c = 1; c < p.N; c += 32) {
        const int mine = c + lane < p.N ? __ldg(keys_b + c + lane) : p.pad_key;
        const int m = min(32, p.N - c);
        for (int j = 0; j < m; ++j) {
            const int key = __shfl_sync(~0u, mine, j);
            if (key == p.pad_key) continue;
            const int* row = p.cidx + (size_t)key * p.Q;
            const int* map = lanes_b + (size_t)(c + j) * ks;
            int ln[WPT];
#pragma unroll
            for (int u = 0; u < WPT; ++u) ln[u] = __ldg(row + acc[u]);
#pragma unroll
            for (int u = 0; u < WPT; ++u)
                acc[u] = ln[u] < 0 ? (sink[u] >= 0 ? sink[u] : acc[u])
                                   : __ldg(map + kofs[u] + ln[u]);
        }
    }
#pragma unroll
    for (int u = 0; u < WPT; ++u)
        if (o0 + u * WIDE_THREADS < ks)
            p.out[(size_t)blockIdx.x * ks + o0 + u * WIDE_THREADS] = acc[u];
}

// -- B4 ----------------------------------------------------------------------

struct Tree {
    const int* lanes;  // [B, N, K*S]
    const int* keys;   // element i of run b: keys[b * key_row + i * key_step]
    const int* cidx;   // [rows, Q]
    const int* sinks;  // [K]
    int* dst;          // [B, G / cluster, K*S]: out, or the cluster partials
    int* scratch;      // [B, N, K*S]: the wide instance's levels
    int B, N, Q, K, S, pad_key, rows;
    int key_row, key_step;
    int G;             // segments per run (powers of two: N / G elements each)
    int cluster;       // CTAs per cluster: min(G, MAX_CLUSTER)
    int runs;          // runs per CTA (1 where G > 1)
    int hp;            // pair groups of a unit's threads
    int slots;         // cand_index row slots of a CTA
    int hsize;         // entries of the CTA's key hash (a power of two)
};

// threads of one unit (a run, or a segment of one): LPT lanes a thread, hp
// pair groups, whole warps (the unit's named barrier counts them)
__host__ __device__ constexpr int tree_lane_threads(int ks) {
    return (ks + LPT - 1) / LPT;
}
__host__ __device__ constexpr int tree_threads(int ks, int hp) {
    return (tree_lane_threads(ks) * hp + 31) / 32 * 32;
}

// Shared memory, in bytes: each unit's maps [runs][slot_words(width * K*S)]
// (width = max(segment, cluster): the cluster fold gathers its peers'
// partials there), the staged key rows [slots][slot_words(Q)], each unit's
// element entries [runs][width], the key hash (keys [hsize], entries
// [hsize]), a copy barrier for each unit.  kernels/lvec_compose.py::
// tree_smem mirrors it.
struct TreeLayout {
    int seg, width;
    uint32_t us, qs, rows_off, elem_off, hkey_off, hval_off, bar, end;
    __host__ __device__ TreeLayout(const Tree& p) {
        seg = p.N / p.G;
        width = seg > p.cluster ? seg : p.cluster;
        us = slot_words(width * p.K * p.S);
        qs = slot_words(p.Q);
        rows_off = (uint32_t)p.runs * us * 4;
        elem_off = rows_off + (uint32_t)p.slots * qs * 4;
        hkey_off = elem_off + (uint32_t)(p.runs * width) * 4;
        hval_off = hkey_off + (uint32_t)p.hsize * 4;
        bar = (hval_off + (uint32_t)p.hsize * 4 + 7) & ~7u;
        end = bar + (uint32_t)p.runs * 8;
    }
};

// An element's entry: 1 for pad_key (the identity: the pair is skipped),
// key * 4 + 2 for a key whose row is read from global memory (the CTA's
// row slots ran out), else the shared-memory offset of its staged row.
//
// The levels of one unit's n elements, in place: at stride st slot i (a
// multiple of 2 st) becomes the combine of slot i and slot i + st keyed by
// element i + st's entry, so a combined pair keeps its left key, as in the
// Pallas tree.  Thread (g, h) takes lanes g + u * tl of pairs h, h + hp, ...
// (h = n: none); the unit's bar_n threads meet at barrier `bar` after each
// level.  A lane index is -1 or one of pattern k's lanes; the word a -1
// reads (the one before pattern k's lanes of a slot >= 1) lies in the
// unit's maps and is selected away.
__device__ __forceinline__ void tree_levels(
        uint32_t base, uint32_t maps, uint32_t elem, int n, int ks,
        const int* __restrict__ cidx, int q, int h, int hp,
        const uint32_t (&lo)[LPT], const uint32_t (&kofs)[LPT],
        const int (&sink)[LPT], const bool (&ok)[LPT], int bar, int bar_n) {
    for (int st = 1; st < n; st *= 2) {
        const int pairs = n / (2 * st);
        for (int pp = h; pp < pairs; pp += hp) {
            const int i = 2 * pp * st, j = i + st;
            const uint32_t e = sm90::lds(elem + (uint32_t)j * 4);
            if (e & 1) continue;
            const uint32_t left = maps + (uint32_t)(i * ks) * 4;
            const uint32_t right = maps + (uint32_t)(j * ks) * 4;
            int a[LPT], ln[LPT];
#pragma unroll
            for (int u = 0; u < LPT; ++u) a[u] = (int)sm90::lds(left + lo[u]);
            if (e & 2) {
                const int* row = cidx + (size_t)(e >> 2) * q;
#pragma unroll
                for (int u = 0; u < LPT; ++u) ln[u] = __ldg(row + a[u]);
            } else {
#pragma unroll
                for (int u = 0; u < LPT; ++u)
                    ln[u] = (int)sm90::lds(base + e + (uint32_t)a[u] * 4);
            }
#pragma unroll
            for (int u = 0; u < LPT; ++u) {
                const int keep = sink[u] >= 0 ? sink[u] : a[u];
                const int hit = (int)sm90::lds(right + kofs[u]
                                               + (uint32_t)(ln[u] * 4));
                if (ok[u]) sm90::sts(left + lo[u], ln[u] < 0 ? keep : hit);
            }
        }
        sm90::bar_sync(bar, bar_n);
    }
}

__global__ void __launch_bounds__(1024, 1) compose_tree(const Tree p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31;
    const int ks = p.K * p.S;
    const int T = tree_threads(ks, p.hp), tl = tree_lane_threads(ks);
    const int cons = p.runs * T;
    const TreeLayout lay(p);
    const uint32_t base = sm90::smem_addr(smem);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);
    int* hkey = reinterpret_cast<int*>(smem + lay.hkey_off);
    int* hval = reinterpret_cast<int*>(smem + lay.hval_off);
    int* elems = reinterpret_cast<int*>(smem + lay.elem_off);
    // unit u: run b0 + u, elements e0 .. e0 + seg - 1 (a CTA of a split run
    // holds one unit, segment blockIdx.x % G)
    const bool split = p.G > 1;
    const int b0 = split ? blockIdx.x / p.G : blockIdx.x * p.runs;
    const int gseg = split ? blockIdx.x % p.G : 0;
    const int units = split ? 1 : min(p.runs, p.B - b0);
    const int* lanes_end = p.lanes + (size_t)p.B * p.N * ks;
    auto src_of = [&](int u, int g) {
        return p.lanes + ((size_t)(b0 + u) * p.N + (size_t)g * lay.seg) * ks;
    };
    auto span_of = [&](int u, int g) {
        return span(src_of(u, g), lay.seg * ks, p.lanes, lanes_end);
    };

    if (tid == 0) {
        for (int i = 0; i < p.runs; ++i) sm90::mbar_init(&full[i], 32);
        sm90::mbar_init_fence();
    }
    for (int i = tid; i < p.hsize; i += blockDim.x) hkey[i] = -1;
    __syncthreads();

    // a consumer thread's lanes (the producer's are unused)
    const int u = tid / T, t = tid - u * T;
    const int h = t / tl, g = t - h * tl;
    const bool act = tid < cons && u < units && h < p.hp;
    uint32_t lo[LPT], kofs[LPT];
    int sink[LPT];
    bool ok[LPT];
#pragma unroll
    for (int v = 0; v < LPT; ++v) {   // a dead lane combines lane 0, unstored
        const int o = g + v * tl;
        ok[v] = act && o < ks;
        const int k = ok[v] ? o / p.S : 0;
        lo[v] = ok[v] ? (uint32_t)o * 4 : 0;
        kofs[v] = (uint32_t)(k * p.S) * 4;
        sink[v] = ok[v] ? __ldg(p.sinks + k) : -1;
    }
    const int uu = u < units ? u : 0;
    const uint32_t maps = base + (uint32_t)uu * lay.us * 4
                          + (uint32_t)span_of(uu, gseg).off * 4;
    const uint32_t elem = base + lay.elem_off + (uint32_t)(uu * lay.width) * 4;

    if (tid >= cons) {
        // -- producer warp: lane u < units bulk-copies unit u's maps on its
        // barrier (4-byte copies where the span would leave the operand);
        // then every key of elements 1 .. seg - 1 is read into the entry
        // table, and each distinct key's row is copied once into a row
        // slot, on the barrier of the unit that first holds the key (a key
        // of an earlier batch is found in the hash); each lane arrives on a
        // unit's barrier once the unit's keys are done
        const Span ms = span_of(lane < units ? lane : 0, gseg);
        if (lane < units && ms.bulk) {
            sm90::mbar_expect_tx(&full[lane], ms.words * 4);
            sm90::bulk_load(base + lane * lay.us * 4, ms.src, ms.words * 4,
                            &full[lane]);
        }
        for (uint32_t m = __ballot_sync(~0u, lane < units && !ms.bulk); m;
             m &= m - 1) {
            const int q = __ffs(m) - 1;
            warp_copy(base + q * lay.us * 4, src_of(q, gseg), lay.seg * ks,
                      lane);
        }
        for (int x = lane; x < units * lay.seg; x += 32) {
            const int v = x / lay.seg, i = x - v * lay.seg;
            elems[v * lay.width + i] =
                i ? __ldg(p.keys + (size_t)(b0 + v) * p.key_row
                          + (size_t)(gseg * lay.seg + i) * p.key_step)
                  : p.pad_key;
        }
        __syncwarp();
        const int* cidx_end = p.cidx + (size_t)p.rows * p.Q;
        int used = 0;
        for (int v = 0; v < units; ++v) {
            for (int c0 = 1; c0 < lay.seg; c0 += 32) {
                const int i = c0 + lane;
                const bool valid = i < lay.seg;
                int* ent = elems + v * lay.width + i;
                const int key = valid ? *ent : p.pad_key;
                const bool need = key != p.pad_key;
                const int lead =
                    __ffs(__match_any_sync(~0u, need ? key : -1 - lane)) - 1;
                int pos = 0;
                bool fresh = false;
                if (need && lead == lane) {
                    pos = (int)(((uint32_t)key * 2654435761u) >> 16)
                          & (p.hsize - 1);
                    for (;;) {
                        const int old = atomicCAS(hkey + pos, -1, key);
                        if (old == -1 || old == key) {
                            fresh = old == -1;
                            break;
                        }
                        pos = (pos + 1) & (p.hsize - 1);
                    }
                }
                const uint32_t fb = __ballot_sync(~0u, fresh);
                const int slot = used + __popc(fb & ((1u << lane) - 1));
                const bool row = fresh && slot < p.slots;
                const Span rs = span(p.cidx + (size_t)(row ? key : 0) * p.Q,
                                     p.Q, p.cidx, cidx_end);
                const uint32_t dst = lay.rows_off + (uint32_t)slot * lay.qs * 4;
                int e = 1;
                if (fresh) {
                    e = row ? (int)(dst + rs.off * 4) : key * 4 + 2;
                    hval[pos] = e;
                }
                if (row && rs.bulk) {
                    sm90::mbar_expect_tx(&full[v], rs.words * 4);
                    sm90::bulk_load(base + dst, rs.src, rs.words * 4,
                                    &full[v]);
                }
                for (uint32_t m = __ballot_sync(~0u, row && !rs.bulk); m;
                     m &= m - 1) {
                    const int q = __ffs(m) - 1;
                    warp_copy(base + __shfl_sync(~0u, dst, q),
                              p.cidx + (size_t)__shfl_sync(~0u, key, q) * p.Q,
                              p.Q, lane);
                }
                used += __popc(fb);
                __syncwarp();
                if (need && lead == lane && !fresh) e = hval[pos];
                e = __shfl_sync(~0u, e, lead);
                if (valid) *ent = e;
            }
            stage_done(&full[v]);
        }
    } else if (u < units) {
        // -- consumers: unit u's levels on its named barrier, once its
        // copies and those of the CTA's earlier units (whose rows it may
        // read) have landed
        for (int v = 0; v <= u; ++v) sm90::mbar_wait(&full[v], 0);
        tree_levels(base, maps, elem, lay.seg, ks, p.cidx, p.Q,
                    act ? h : lay.seg, p.hp, lo, kofs, sink, ok, 1 + u, T);
        if (!split && h == 0)
#pragma unroll
            for (int v = 0; v < LPT; ++v)
                if (ok[v])
                    p.dst[(size_t)(b0 + u) * ks + g + v * tl] =
                        (int)sm90::lds(maps + lo[v]);
    }
    if (!split) return;

    // -- a split run: the cluster's partials (each CTA's slot 0) folded in
    // the tree's own pairing by rank 0, which gathers its peers' partials
    // into its slots 1 .. cluster - 1 through distributed shared memory and
    // reads their keys' rows from global memory
    sm90::cluster_sync();
    if (sm90::cluster_rank() == 0 && tid < cons) {
        const int c = p.cluster;
        if (act)
            for (int r = 1 + h; r < c; r += p.hp) {
                const uint32_t peer =
                    base + (uint32_t)span_of(0, gseg + r).off * 4;
#pragma unroll
                for (int v = 0; v < LPT; ++v)
                    if (ok[v])
                        sm90::sts(maps + (uint32_t)(r * ks) * 4 + lo[v],
                                  sm90::ld_cluster(
                                      sm90::cluster_map(peer + lo[v], r)));
            }
        if (t < c - 1) {
            const int key = __ldg(p.keys + (size_t)b0 * p.key_row
                                  + (size_t)((gseg + t + 1) * lay.seg)
                                        * p.key_step);
            sm90::sts(elem + (uint32_t)(t + 1) * 4,
                      key == p.pad_key ? 1u : (uint32_t)key * 4 + 2);
        }
        sm90::bar_sync(1, T);
        tree_levels(base, maps, elem, c, ks, p.cidx, p.Q, act ? h : c, p.hp,
                    lo, kofs, sink, ok, 1, T);
        if (h == 0)
#pragma unroll
            for (int v = 0; v < LPT; ++v)
                if (ok[v])
                    p.dst[((size_t)b0 * (p.G / c) + gseg / c) * ks + g
                          + v * tl] = (int)sm90::lds(maps + lo[v]);
    }
    sm90::cluster_sync();   // no CTA leaves while rank 0 reads its partial
}

// B4 where a unit does not fit shared memory (two elements past it, as
// PS00028's K*S = 22,857 lanes are, or more lanes than a CTA's threads
// carry): one CTA a run, every level in the global scratch copy of the run
// (level 0 reads the input), __syncthreads() between levels, cand_index
// read through the read-only path.
__global__ void __launch_bounds__(1024) compose_tree_wide(const Tree p) {
    const int b = blockIdx.x, tid = threadIdx.x;
    const int ks = p.K * p.S;
    const int* lanes_b = p.lanes + (size_t)b * p.N * ks;
    const int* keys_b = p.keys + (size_t)b * p.key_row;
    int* buf = p.scratch + (size_t)b * p.N * ks;
    for (int st = 1; st < p.N; st *= 2) {
        const int* src = st > 1 ? buf : lanes_b;
        const int pairs = p.N / (2 * st);
        for (int idx = tid; idx < pairs * ks; idx += blockDim.x) {
            const int pr = idx / ks;
            const int o = idx - pr * ks;
            const int k = o / p.S;
            const size_t left = (size_t)(2 * pr) * st, right = left + st;
            const int a = src[left * ks + o];
            const int key = __ldg(keys_b + right * p.key_step);
            int v = a;
            if (key != p.pad_key) {
                const int ln = __ldg(p.cidx + (size_t)key * p.Q + a);
                const int sink = __ldg(p.sinks + k);
                v = ln < 0 ? (sink >= 0 ? sink : a)
                           : src[right * ks + k * p.S + ln];
            }
            buf[left * ks + o] = v;
        }
        __syncthreads();
    }
    const int* res = p.N > 1 ? buf : lanes_b;
    for (int o = tid; o < ks; o += blockDim.x)
        p.dst[(size_t)b * ks + o] = res[o];
}

int threads_for(int work) {
    int t = ((work + 31) / 32) * 32;
    if (t > 1024) t = 1024;
    if (t < 32) t = 32;
    return t;
}

int launch_tree(const Tree& p, void* stream) {
    const int ks = p.K * p.S;
    const unsigned blocks = p.G > 1 ? (unsigned)(p.B * p.G)
                                    : (unsigned)((p.B + p.runs - 1) / p.runs);
    return launch::launch_ex(compose_tree, p, dim3(blocks),
                             p.runs * tree_threads(ks, p.hp) + 32,
                             TreeLayout(p).end, p.G > 1 ? p.cluster : 1,
                             stream);
}

bool tree_ok(int B, int N, int ks, int G, int cluster, int runs, int hp,
             int slots, int hsize) {
    if (G < 1 || (G & (G - 1)) || N % G || runs < 1 || runs > 15 || hp < 1
        || slots < 0 || hsize < 32 || (hsize & (hsize - 1)) || ks < 1)
        return false;
    if (cluster != (G < MAX_CLUSTER ? G : MAX_CLUSTER) || (G > 1 && runs != 1))
        return false;
    const int width = N / G > cluster ? N / G : cluster;
    return runs * tree_threads(ks, hp) <= MAX_CONSUMERS
           && hsize > runs * width && B >= 1;
}

// -- B7 ----------------------------------------------------------------------

struct Lvec {
    const int* maps;   // [B, N, Q]
    int* dst;          // [B, G / cluster, Q]: out, or the cluster partials
    int B, N, Q;
    int G;             // segments per composition (a multiple of cluster)
    int cluster;       // CTAs per cluster (consecutive segments)
    int pack;          // compositions per CTA
    int tpu;           // consumer threads per composition
    int nq;            // states per consumer thread (<= QPT)
    int tile;          // maps per composition per ring tile
};

// shared memory: the ring [STAGES][pack][slot_words(tile * Q)], the
// partials [pack][Q] (clusters), the barriers; kernels/lvec_compose.py::
// lvec_smem mirrors it
__host__ __device__ inline uint32_t lvec_ring_bytes(const Lvec& p) {
    return (uint32_t)STAGES * p.pack * slot_words(p.tile * p.Q) * 4;
}
__host__ __device__ inline uint32_t lvec_bars(const Lvec& p) {
    const uint32_t part = p.cluster > 1 ? (uint32_t)p.pack * p.Q * 4 : 0;
    return (lvec_ring_bytes(p) + part + 7) & ~7u;
}

template <int N_Q>   // states a consumer thread carries (1, or QPT)
__global__ void __launch_bounds__(1024, 1) lvec_compose(const Lvec p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31;
    const int cons = blockDim.x - 32;
    const uint32_t base = sm90::smem_addr(smem);
    const uint32_t unit = slot_words(p.tile * p.Q) * 4;   // a composition's
                                                           // tile
    const uint32_t stage = unit * p.pack;
    const uint32_t part = lvec_ring_bytes(p);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + lvec_bars(p));
    uint64_t* empty = full + STAGES;
    const int g = blockIdx.x % p.G;
    const int b0 = blockIdx.x / p.G * p.pack;
    const int units = min(p.pack, p.B - b0);
    const int i0 = (int)((long long)g * p.N / p.G);
    const int n_seg = (int)((long long)(g + 1) * p.N / p.G) - i0;
    const int n_tiles = (n_seg + p.tile - 1) / p.tile;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            sm90::mbar_init(&full[s], 32);
            sm90::mbar_init(&empty[s], cons / 32);
        }
        sm90::mbar_init_fence();
    }
    __syncthreads();

    const int* end = p.maps + (size_t)p.B * p.N * p.Q;
    const bool aligned = (p.Q & 3) == 0
                         && (reinterpret_cast<uintptr_t>(p.maps) & 15) == 0;
    auto map_at = [&](int b, int i) { return p.maps + ((size_t)b * p.N + i)
                                                      * p.Q; };
    int acc[N_Q];
    int nv = 0;       // live states of this thread: q = l + j * tpu, j < nv
    int u = 0, l = 0;
    if (tid >= cons) {
        // -- producer warp: every tile of every composition of the CTA ----
        for (int t = 0; t < n_tiles; ++t) {
            const int s = t % STAGES;
            if (t >= STAGES) sm90::mbar_wait(&empty[s], (t / STAGES - 1) & 1);
            const int ti = i0 + t * p.tile;
            const int words = min(p.tile, n_seg - t * p.tile) * p.Q;
            const uint32_t dst = base + s * stage;
            if (aligned) {   // every tile is whole aligned 16-byte units
                if (lane == 0)
                    sm90::mbar_expect_tx(&full[s],
                                         (uint32_t)units * words * 4);
                __syncwarp();
                for (int v = lane; v < units; v += 32)
                    sm90::bulk_load(dst + v * unit, map_at(b0 + v, ti),
                                    (uint32_t)words * 4, &full[s]);
                stage_done(&full[s]);
                continue;
            }
            uint32_t bytes = 0;
            for (int v = lane; v < units; v += 32) {
                const Span sp = span(map_at(b0 + v, ti), words, p.maps, end);
                if (sp.bulk) bytes += sp.words * 4;
            }
            const uint32_t total = __reduce_add_sync(~0u, bytes);
            if (lane == 0 && total) sm90::mbar_expect_tx(&full[s], total);
            __syncwarp();
            for (int v = lane; v < units; v += 32) {
                const Span sp = span(map_at(b0 + v, ti), words, p.maps, end);
                if (sp.bulk)
                    sm90::bulk_load(dst + v * unit, sp.src, sp.words * 4,
                                    &full[s]);
            }
            for (int v = 0; v < units; ++v)   // spans off the operand's ends
                if (!span(map_at(b0 + v, ti), words, p.maps, end).bulk)
                    warp_copy(dst + v * unit, map_at(b0 + v, ti), words, lane);
            stage_done(&full[s]);
        }
    } else {
        // -- consumers: composition u, states l, l + tpu, ... --------------
        u = tid / p.tpu;
        l = tid - u * p.tpu;
        if (u < units && l < p.Q) nv = min(p.nq, (p.Q - 1 - l) / p.tpu + 1);
#pragma unroll
        for (int j = 0; j < N_Q; ++j) acc[j] = l + j * p.tpu;
        const int uu = u < units ? u : 0;
        const uint32_t ubase = base + (uint32_t)uu * unit;
        const uint32_t row_bytes = (uint32_t)p.Q * 4;
        for (int t = 0; t < n_tiles; ++t) {
            const int s = t % STAGES;
            sm90::mbar_wait(&full[s], (t / STAGES) & 1);
            const int tl = min(p.tile, n_seg - t * p.tile);
            if (nv) {
                const int ti = i0 + t * p.tile;
                uint32_t row = ubase + s * stage;
                if (!aligned)
                    row += span(map_at(b0 + uu, ti), tl * p.Q, p.maps, end)
                               .off * 4;
#pragma unroll 4
                for (int i = 0; i < tl; ++i, row += row_bytes) {
#pragma unroll
                    for (int j = 0; j < N_Q; ++j)
                        if (j < nv)
                            acc[j] = (int)sm90::lds(row
                                                    + (uint32_t)acc[j] * 4);
                }
            }
            __syncwarp();
            if (lane == 0) sm90::mbar_arrive(&empty[s]);
        }
    }

    const int G2 = p.G / p.cluster;   // partials per composition in dst
    if (p.cluster == 1) {
#pragma unroll
        for (int j = 0; j < N_Q; ++j)
            if (j < nv)
                p.dst[((size_t)(b0 + u) * G2 + g) * p.Q + l + j * p.tpu] =
                    acc[j];
        return;
    }
    // -- fold the cluster's partials in segment order (rank 0 first) --------
    int* s_part = reinterpret_cast<int*>(smem + part);
#pragma unroll
    for (int j = 0; j < N_Q; ++j)
        if (j < nv) s_part[u * p.Q + l + j * p.tpu] = acc[j];
    __syncwarp();
    sm90::cluster_sync();
    const int rank = (int)sm90::cluster_rank();
    const uint32_t part_addr = base + part;
    const int c = g / p.cluster;
    for (int x = rank * blockDim.x + tid; x < units * p.Q;
         x += p.cluster * blockDim.x) {
        const int v = x / p.Q;
        const uint32_t row = part_addr + (uint32_t)v * p.Q * 4;
        const uint32_t q = (uint32_t)(x - v * p.Q);
        int a = (int)sm90::ld_cluster(sm90::cluster_map(row + q * 4, 0));
        for (int r = 1; r < p.cluster; ++r)
            a = (int)sm90::ld_cluster(sm90::cluster_map(row + (uint32_t)a * 4,
                                                        r));
        p.dst[((size_t)(b0 + v) * G2 + c) * p.Q + q] = a;
    }
    sm90::cluster_sync();   // no CTA leaves while a peer reads its partials
}

// B7 where a map does not fit the ring (more states than four ring slots or
// QPT states a thread hold): no shared memory; CTA (x, y) walks segment
// x % G of composition x / G for states y * WIDE_THREADS * WPT + tid + j *
// WIDE_THREADS, WPT independent chains a thread (a load of each in flight
// at once), every map read from global memory (L2) through the read-only
// path.  The partials go to dst as the ring instance's do, so the fold past
// one segment is the same second launch.
__global__ void __launch_bounds__(WIDE_THREADS)
lvec_compose_wide(const Lvec p) {
    const int g = blockIdx.x % p.G, b = blockIdx.x / p.G;
    const int q0 = blockIdx.y * WIDE_THREADS * WPT + threadIdx.x;
    const int i0 = (int)((long long)g * p.N / p.G);
    const int i1 = (int)((long long)(g + 1) * p.N / p.G);
    int acc[WPT];
#pragma unroll
    for (int j = 0; j < WPT; ++j) {   // a state past Q walks state 0, unstored
        const int q = q0 + j * WIDE_THREADS;
        acc[j] = q < p.Q ? q : 0;
    }
    const int* m = p.maps + ((size_t)b * p.N + i0) * p.Q;
    for (int i = i0; i < i1; ++i, m += p.Q)
#pragma unroll
        for (int j = 0; j < WPT; ++j) acc[j] = __ldg(m + acc[j]);
    int* dst = p.dst + ((size_t)b * p.G + g) * p.Q;
#pragma unroll
    for (int j = 0; j < WPT; ++j)
        if (q0 + j * WIDE_THREADS < p.Q) dst[q0 + j * WIDE_THREADS] = acc[j];
}

int launch_lvec(const Lvec& p, int cons, bool wide, void* stream) {
    if (wide)
        return launch::launch_ex(lvec_compose_wide, p,
                                 dim3((unsigned)(p.B * p.G),
                                      wide_blocks(p.Q)),
                                 WIDE_THREADS, 0, 1, stream);
    const unsigned blocks = (unsigned)((p.B + p.pack - 1) / p.pack * p.G);
    const size_t smem = lvec_bars(p) + 2 * STAGES * 8;
    return launch::launch_ex(p.nq > 1 ? lvec_compose<QPT> : lvec_compose<1>,
                             p, dim3(blocks), cons + 32, smem, p.cluster,
                             stream);
}

}  // namespace

extern "C" {

// B3: the ring instance (compose_carry<lpt>, `runs` runs of `tile`
// elements a tile) or, with `wide`, compose_carry_wide (runs, tile, cons and
// lpt unread)
int spec_compose_lanes_launch(const int* lanes, const int* keys,
                              const int* cidx, const int* sinks, int* out,
                              int B, int N, int Q, int K, int S, int pad_key,
                              int rows, int runs, int tile, int cons,
                              int lpt, int wide, void* stream) {
    const int ks = K * S;
    if (N < 1
        || (!wide && (runs < 1 || tile < 1 || runs * tile > PAIRS
                      || cons < 32 || cons % 32 || cons > MAX_CONSUMERS
                      || (lpt != 1 && lpt != LPT)
                      || runs * ((ks + lpt - 1) / lpt) > cons)))
        return (int)cudaErrorInvalidValue;
    Carry p = {lanes, keys, cidx, sinks, out, B, N, Q, K, S, pad_key, rows,
               runs, tile};
    if (wide)
        return launch::launch_ex(compose_carry_wide, p,
                                 dim3((unsigned)B, wide_blocks(ks)),
                                 WIDE_THREADS, 0, 1, stream);
    const size_t smem = CarryLayout(p).bars + 2 * STAGES * 8;
    return launch::launch_ex(lpt > 1 ? compose_carry<LPT> : compose_carry<1>,
                             p, dim3((unsigned)((B + runs - 1) / runs)),
                             cons + 32, smem, 1, stream);
}

// B4: stage 1 reduces each run (or each of its G segments, folded in
// clusters of `cluster`) with compose_tree; when G > cluster, stage 2 (the
// same kernel: runs2, hp2, slots2, hsize2) reduces the [B, G / cluster,
// K*S] cluster partials in `scratch`, keyed by each partial's first
// element.  `wide` takes compose_tree_wide ([B, N, K*S] levels in `scratch`;
// the plan's other arguments unread).
int spec_compose_lanes_tree_launch(const int* lanes, const int* keys,
                                   const int* cidx, const int* sinks,
                                   int* out, int* scratch, int B, int N,
                                   int Q, int K, int S, int pad_key, int rows,
                                   int G, int cluster, int runs, int hp,
                                   int slots, int hsize, int runs2, int hp2,
                                   int slots2, int hsize2, int wide,
                                   void* stream) {
    const int ks = K * S;
    if (N < 1 || (N & (N - 1)) || (wide && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    Tree p = {lanes, keys, cidx, sinks, out, scratch, B, N, Q, K, S, pad_key,
              rows, N, 1, G, cluster, runs, hp, slots, hsize};
    if (wide) {
        p.G = p.cluster = p.runs = p.hp = 1;
        return launch::launch_ex(compose_tree_wide, p, dim3((unsigned)B),
                                 threads_for((N / 2 > 0 ? N / 2 : 1) * ks), 0,
                                 1, stream);
    }
    const bool fold = G > cluster;
    if (!tree_ok(B, N, ks, G, cluster, runs, hp, slots, hsize)
        || (fold && (scratch == nullptr
                     || !tree_ok(B, G / cluster, ks, 1, 1, runs2, hp2, slots2,
                                 hsize2))))
        return (int)cudaErrorInvalidValue;
    if (fold) p.dst = scratch;
    int err = launch_tree(p, stream);
    if (err || !fold) return err;
    Tree f = {scratch, keys, cidx, sinks, out, nullptr, B, G / cluster, Q, K,
              S, pad_key, rows, N, cluster * (N / G), 1, 1, runs2, hp2,
              slots2, hsize2};
    return launch_tree(f, stream);
}

// B7: stage 1 composes [B, N, Q] in G segments per composition, clusters
// of `cluster`; when G > cluster, stage 2 composes the [B, G / cluster, Q]
// cluster partials in `scratch` (one segment, `fold_tile` maps a tile).
// `wide` takes lvec_compose_wide for both (cluster 1; pack, tpu, nq, cons
// and the tiles unread).
int lvec_compose_launch(const int* maps, int* out, int* scratch, int B,
                        int N, int Q, int G, int cluster, int pack, int tpu,
                        int nq, int cons, int tile, int fold_tile, int wide,
                        void* stream) {
    if (G < 1 || cluster < 1 || cluster > MAX_CLUSTER || G % cluster
        || (wide && cluster != 1) || (G > cluster && scratch == nullptr)
        || (!wide && (pack < 1 || tpu < 1 || nq < 1 || nq > QPT
                      || tpu * nq < Q || cons < 32 || cons % 32
                      || cons > MAX_CONSUMERS || pack * tpu > cons
                      || tile < 1 || fold_tile < 1)))
        return (int)cudaErrorInvalidValue;
    const bool fold = G > cluster;
    Lvec p = {maps, fold ? scratch : out, B, N, Q, G, cluster, pack, tpu, nq,
              tile};
    int err = launch_lvec(p, cons, wide != 0, stream);
    if (err || !fold) return err;
    Lvec f = {scratch, out, B, G / cluster, Q, 1, 1, pack, tpu, nq,
              fold_tile};
    return launch_lvec(f, cons, wide != 0, stream);
}

}  // extern "C"
