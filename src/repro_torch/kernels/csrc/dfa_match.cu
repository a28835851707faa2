// Speculative chunk scans for Hopper (sm_90a): the fused scan + Eq. 8 fold
// of a document on a thread-block cluster (B1, B2), and the plain chunk x
// lane scan (B6).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   B1  repro/kernels/dfa_match.py::spec_match_merge_kernel       (MERGE)
//   B2  repro/kernels/dfa_match.py::spec_match_merge_lanes_kernel (MERGE_LANES)
// both with their shared symbol-block body `_scan_block_with_exit`, and
//   B6  repro/kernels/dfa_match.py::spec_match_kernel             (SPEC)
// One template, spec_scan_kernel<SMEM_TABLE, MODE>; the scan itself
// (lanes in registers, a producer-fed symbol ring, the class-major table)
// is spec_scan.cuh.
//
// What bounds it.  A lane-step is one add and one dependent table load from
// shared memory; the card serves 32 four-byte shared words per SM and clock
// (~8.4e12 loads/s over 132 SMs at 700 W), and the symbols (4 bytes each,
// read once) move at 3.35 TB/s.  A lane is a chain of L dependent loads, so
// a shape with few lanes per SM is bound by the load latency instead (~30
// clocks a step), whatever the load rate.  The design keeps every chain
// short and many: LPT (4) lanes per thread in registers, one 16-byte symbol
// read per 4 symbols shared by the thread's lanes, no barrier and no carry
// traffic inside the scan (the ring is refilled by a producer warp while
// the consumers scan), bank-spread gathers from the class-major table.
//
// B6, spec_match: C chunks x S lanes through the table, no fold (paper
// Listing 2): the paper engine's matcher (lookahead mode, S = I_max
// candidate lanes) and, with C = S = 1, its sequential matcher (one
// consumer warp with one live lane, fed by the ring).  The grid runs over
// blocks of c_blk chunks x s_blk lanes that dfa_match.py::spec_launch_plan
// sizes to one CTA per SM where the lanes allow (whole waves of 132 SMs).
//
// B1/B2, per document b (a cluster of `cluster` CTAs, <= 8):
//   * the document's C chunks are split over the cluster's CTAs (CTA r
//     takes chunks [r*C/cluster, (r+1)*C/cluster)); every lane of the
//     [C, K*S] carry (chunk x pattern x candidate) steps through its chunk's
//     L symbols; a CTA whose lanes exceed its threads' registers runs them
//     in passes, each streaming the symbols again;
//   * after every l_blk symbols the cluster votes whether all the lanes of
//     the pass sit in absorbing states: each CTA ANDs its consumers' votes
//     (a named barrier), writes the result into every CTA's vote words
//     (distributed shared memory) and arrives on their vote barriers; every
//     CTA reads all the words, so the whole cluster leaves the pass at the
//     same block.  The remaining symbol tiles are drained, not scanned, and
//     counted into skipped[b] (the Pallas kernel's block granularity; with
//     passes the latest exit of any pass, since absorbing states are fixed
//     points);
//   * the Eq. 8 fold over chunks 1..C-1 through cand_index, the sink on a
//     miss and passthrough on the pad key: B1 folds one exact state per
//     pattern -> out[b, K]; B2 folds lane for lane -> out[b, K*S].  The
//     final lanes go to the CTA's shared memory (the fold reads its peers'
//     through distributed shared memory) or, when they do not fit, to a
//     global scratch row of the document; cluster barriers before the fold
//     and after its last remote read.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch.cuh"
#include "sm90.cuh"
#include "spec_scan.cuh"

namespace {

using spec_scan::LPT;
using spec_scan::STAGES;

enum Mode { SPEC = 0, MERGE = 1, MERGE_LANES = 2 };

struct Params {
    const int* table;       // [Q, n_cls] unscaled (B1/B2: identity pad column)
    const int* chunks;      // B6 [C, L]; B1/B2 [B, C, L] classes
    const int* init;        // B6 [C, S]; B1/B2 [B, C, K*S] entry lanes
    const int* lookahead;   // [B, C] boundary keys
    const int* cand_index;  // [n_keys + 1, Q]
    const int* sinks;       // [K]
    const int* absorbing;   // [Q] 0/1
    int* out;               // B6 [C, S]; B1 [B, K]; B2 [B, K*S]
    int* skipped;           // [B]
    int* scratch;           // [B, C*K*S] or null
    int C, L, Q, n_cls, K, S, pad_key, l_blk;
    int early_exit, carry_in_smem;
    int rows;        // most chunk rows of one CTA (ring rows)
    int width;       // lanes per row: B6 s_blk, B1/B2 K*S
    int tpc;         // consumer threads per row (ceil(width / LPT))
    int cons;        // consumer threads (whole warps); one producer warp more
    int passes;      // lane passes over the symbols (B1/B2)
    int tile;        // symbols per ring tile
    int row_words;   // ring row stride (16-byte multiple, odd in 16 bytes)
    int bulk;        // rows arrive by bulk copies (else plain loads)
    int cluster;     // CTAs per document (B1/B2)
};

// Shared memory of one CTA: the ring, then the class-major table, the
// absorbing bitmap, the lane carry, the barriers and the vote words.
// kernels/dfa_match.py::smem_bytes computes the same total.
struct Layout {
    uint32_t tab, abs, carry, bars, votes, total;
};

__host__ __device__ inline Layout layout(const Params& p, bool table,
                                         bool fold) {
    Layout l;
    uint32_t off = (uint32_t)STAGES * p.rows * p.row_words * 4;
    l.tab = off;
    if (table) off += (uint32_t)(p.Q | 1) * p.n_cls * 4;
    l.abs = off;
    if (fold && p.early_exit) off += (uint32_t)((p.Q + 31) / 32) * 4;
    l.carry = off;
    if (fold && p.carry_in_smem) off += (uint32_t)p.rows * p.width * 4;
    off = (off + 7) & ~7u;
    l.bars = off;
    off += (2 * STAGES + 2) * 8;
    l.votes = off;
    off += 16 * 4;
    l.total = off;
    return l;
}

// ring row stride of a tile: 16-byte units, an odd count of them, so that
// the rows of one quarter-warp's 16-byte loads fall in distinct banks
inline int row_words(int tile) {
    int w = (tile + 3) / 4 + 1;
    if (w % 2 == 0) ++w;
    return 4 * w;
}

template <bool SMEM_TABLE, int MODE>
__global__ void __launch_bounds__(1024, 1) spec_scan_kernel(const Params p) {
    constexpr bool FOLD = MODE != SPEC;
    using Tab = typename std::conditional<SMEM_TABLE, spec_scan::SmemTable,
                                          spec_scan::GlobalTable>::type;
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, lane_id = tid & 31;
    const Layout lay = layout(p, SMEM_TABLE, FOLD);
    const uint32_t base = sm90::smem_addr(smem);
    const uint32_t stage_bytes = (uint32_t)p.rows * p.row_words * 4;
    int* s_tab = reinterpret_cast<int*>(smem + lay.tab);
    uint32_t* s_abs = reinterpret_cast<uint32_t*>(smem + lay.abs);
    int* s_carry = reinterpret_cast<int*>(smem + lay.carry);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
    uint64_t* empty = full + STAGES;
    uint64_t* vote_bar = empty + STAGES;
    volatile uint32_t* votes =
        reinterpret_cast<volatile uint32_t*>(smem + lay.votes);  // [2][8]

    // this CTA's chunk rows [c0, c0 + rows_here) and lanes [s0, s0 + width)
    int doc = 0, rank = 0, c0, rows_here, s0 = 0, width = p.width;
    if constexpr (FOLD) {
        rank = (int)sm90::cluster_rank();
        doc = blockIdx.x / p.cluster;
        c0 = rank * p.C / p.cluster;
        rows_here = (rank + 1) * p.C / p.cluster - c0;
    } else {
        c0 = blockIdx.x * p.rows;
        rows_here = min(p.rows, p.C - c0);
        s0 = blockIdx.y * p.width;
        width = min(p.width, p.S - s0);
    }

    // -- prologue: table (class-major, byte offsets), bitmap, barriers ------
    if constexpr (SMEM_TABLE) {
        const int qp = p.Q | 1, n = p.Q * p.n_cls;
        for (int i = tid; i < n; i += blockDim.x) {
            const int q = i / p.n_cls, c = i - q * p.n_cls;
            s_tab[c * qp + q] = __ldg(p.table + i) << 2;
        }
    }
    if (FOLD && p.early_exit) {
        for (int w = tid; w < (p.Q + 31) / 32; w += blockDim.x) {
            uint32_t bits = 0;
            for (int j = 0; j < 32 && w * 32 + j < p.Q; ++j)
                bits |= (uint32_t)(__ldg(p.absorbing + w * 32 + j) != 0) << j;
            s_abs[w] = bits;
        }
    }
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            sm90::mbar_init(&full[s], p.bulk ? 1 : 32);
            sm90::mbar_init(&empty[s], p.cons / 32);
        }
        sm90::mbar_init(&vote_bar[0], p.cluster);
        sm90::mbar_init(&vote_bar[1], p.cluster);
        sm90::mbar_init_fence();
    }
    if constexpr (FOLD) sm90::cluster_sync();
    else __syncthreads();

    const int n_tiles = (p.L + p.tile - 1) / p.tile;
    const int* src0 = p.chunks + ((size_t)doc * p.C + c0) * p.L;

    if (tid >= p.cons) {
        // -- producer warp: every tile of every pass into the ring ----------
        int seq = 0;
        for (int pass = 0; pass < p.passes; ++pass) {
            for (int i = 0; i < n_tiles; ++i, ++seq) {
                const int s = seq % STAGES;
                if (seq >= STAGES)
                    sm90::mbar_wait(&empty[s], (seq / STAGES - 1) & 1);
                const int t0 = i * p.tile, tl = min(p.tile, p.L - t0);
                const int* src = src0 + t0;
                if (p.bulk) {
                    if (lane_id == 0)
                        sm90::mbar_arrive_tx(&full[s],
                                             (uint32_t)(rows_here * tl * 4));
                    __syncwarp();
                    for (int r = lane_id; r < rows_here; r += 32)
                        sm90::bulk_load(base + s * stage_bytes
                                            + (uint32_t)r * p.row_words * 4,
                                        src + (size_t)r * p.L,
                                        (uint32_t)tl * 4, &full[s]);
                } else {
                    int* d = reinterpret_cast<int*>(smem + s * stage_bytes);
                    for (int r = 0; r < rows_here; ++r)
                        for (int t = lane_id; t < tl; t += 32)
                            d[r * p.row_words + t] =
                                __ldg(src + (size_t)r * p.L + t);
                    sm90::mbar_arrive(&full[s]);
                }
            }
        }
    } else {
        // -- consumers: LPT lanes of one row each, in registers --------------
        Tab tab;
        if constexpr (SMEM_TABLE) {
            tab.base = base + lay.tab;
            tab.col = (uint32_t)(p.Q | 1) * 4;
        } else {
            tab.table = p.table;
            tab.n_cls = (uint32_t)p.n_cls;
        }
        const int slots = rows_here * p.tpc;
        const int tpb = FOLD ? p.l_blk / p.tile : 1;   // tiles per block
        const int l_blocks = FOLD ? p.L / p.l_blk : 0;
        int seq = 0, vseq = 0, last_exit = -1;
        bool every_pass_exited = true;
        for (int pass = 0; pass < p.passes; ++pass) {
            const int x = pass * p.cons + tid;
            const bool live = x < slots;
            const int row = live ? x / p.tpc : 0;   // a dead slot reads row 0
            const int g = live ? x - row * p.tpc : 0;
            const int* init_row =
                FOLD ? p.init + ((size_t)doc * p.C + c0 + row) * p.width
                     : p.init + (size_t)(c0 + row) * p.S + s0;
            uint32_t ln[LPT];
            uint32_t valid = 0;
#pragma unroll
            for (int u = 0; u < LPT; ++u) {
                const int j = g + u * p.tpc;
                const bool ok = live && j < width;
                valid |= (uint32_t)ok << u;
                ln[u] = tab.lane(ok ? __ldg(init_row + j) : 0);
            }
            const uint32_t row_addr = base + (uint32_t)row * p.row_words * 4;
            int exit_blk = -1;
            for (int i = 0; i < n_tiles; ++i, ++seq) {
                const int s = seq % STAGES;
                sm90::mbar_wait(&full[s], (seq / STAGES) & 1);
                if (exit_blk < 0)
                    spec_scan::scan_row<LPT>(ln, row_addr + s * stage_bytes,
                                             min(p.tile, p.L - i * p.tile),
                                             tab);
                __syncwarp();
                if (lane_id == 0) sm90::mbar_arrive(&empty[s]);
                if (FOLD && p.early_exit && exit_blk < 0
                    && (i + 1) % tpb == 0) {
                    bool mine = true;
#pragma unroll
                    for (int u = 0; u < LPT; ++u) {
                        const int st = tab.state(ln[u]);
                        const bool absorbed = (s_abs[st >> 5] >> (st & 31)) & 1;
                        mine = mine && (!((valid >> u) & 1) || absorbed);
                    }
                    bool all = sm90::bar_and(spec_scan::CONSUMER_BAR, p.cons,
                                             mine);
                    if (p.cluster > 1) {
                        const int v = vseq & 1;
                        if (tid == 0) {
                            const uint32_t word =
                                base + lay.votes + (uint32_t)(v * 8 + rank) * 4;
                            const uint32_t bar = sm90::smem_addr(&vote_bar[v]);
                            for (int q = 0; q < p.cluster; ++q) {
                                sm90::st_cluster(sm90::cluster_map(word, q),
                                                 all);
                                sm90::mbar_arrive_remote(
                                    sm90::cluster_map(bar, q));
                            }
                        }
                        sm90::mbar_wait_cluster(&vote_bar[v], (vseq >> 1) & 1);
                        all = true;
                        for (int q = 0; q < p.cluster; ++q)
                            all = all && votes[v * 8 + q] != 0;
                    }
                    ++vseq;
                    if (all) exit_blk = (i + 1) / tpb - 1;
                }
            }
#pragma unroll
            for (int u = 0; u < LPT; ++u) {
                if (!((valid >> u) & 1)) continue;
                const int j = g + u * p.tpc;
                const int st = tab.state(ln[u]);
                if constexpr (FOLD) {
                    if (p.carry_in_smem) s_carry[row * p.width + j] = st;
                    else p.scratch[((size_t)doc * p.C + c0 + row) * p.width
                                   + j] = st;
                } else {
                    p.out[(size_t)(c0 + row) * p.S + s0 + j] = st;
                }
            }
            if (exit_blk < 0) every_pass_exited = false;
            else last_exit = max(last_exit, exit_blk);
        }
        if (FOLD && rank == 0 && tid == 0)
            p.skipped[doc] = p.early_exit && every_pass_exited
                                 ? l_blocks - 1 - last_exit : 0;
    }

    if constexpr (FOLD) {
        // -- Eq. 8 fold over the cluster's lanes ------------------------------
        __syncwarp();
        if (!p.carry_in_smem) __threadfence();
        sm90::cluster_sync();
        const int ks = p.width;
        const int n_out = MODE == MERGE_LANES ? ks : p.K;
        const int o0 = rank * n_out / p.cluster;
        const int o1 = (rank + 1) * n_out / p.cluster;
        const int* la_b = p.lookahead + (size_t)doc * p.C;
        const uint32_t carry = base + lay.carry;
        auto carry_at = [&](int i, int j) -> int {
            if (p.carry_in_smem) {
                const int owner = ((i + 1) * p.cluster - 1) / p.C;
                const int local = (i - owner * p.C / p.cluster) * ks + j;
                return (int)sm90::ld_cluster(
                    sm90::cluster_map(carry + (uint32_t)local * 4, owner));
            }
            return p.scratch[((size_t)doc * p.C + i) * ks + j];
        };
        for (int o = o0 + tid; o < o1; o += blockDim.x) {
            const int k = MODE == MERGE_LANES ? o / p.S : o;
            int st = carry_at(0, MODE == MERGE_LANES ? o : k * p.S);
            const int sink = __ldg(p.sinks + k);
            for (int i = 1; i < p.C; ++i) {
                const int la = __ldg(la_b + i);
                if (la == p.pad_key) continue;   // whole chunk is padding
                const int lane = __ldg(p.cand_index + (size_t)la * p.Q + st);
                if (lane < 0) {
                    if (sink >= 0) st = sink;
                } else {
                    st = carry_at(i, k * p.S + lane);
                }
            }
            p.out[(size_t)doc * n_out + o] = st;
        }
        sm90::cluster_sync();   // no CTA leaves while a peer reads its lanes
    }
}

using KernelFn = void (*)(Params);

template <int MODE>
KernelFn pick(bool table) {
    return table ? spec_scan_kernel<true, MODE>
                 : spec_scan_kernel<false, MODE>;
}

Params common(const int* table, const int* chunks, const int* init, int* out,
              int C, int L, int Q, int n_cls, int tile, int bulk) {
    Params p = {};
    p.table = table;
    p.chunks = chunks;
    p.init = init;
    p.out = out;
    p.C = C;
    p.L = L;
    p.Q = Q;
    p.n_cls = n_cls;
    p.tile = tile;
    p.row_words = row_words(tile);
    p.bulk = bulk;
    p.passes = 1;
    p.cluster = 1;
    return p;
}

template <int MODE>
int launch_merge(const int* table, const int* chunks, const int* init,
                 const int* lookahead, const int* cand_index,
                 const int* sinks, const int* absorbing, int* out,
                 int* skipped, int* scratch, int B, int C, int L, int Q,
                 int n_cls_pad, int K, int S, int pad_key, int l_blk,
                 int early_exit, int table_in_smem, int carry_in_smem,
                 int cluster, int cons, int passes, int tile, int bulk,
                 void* stream) {
    Params p = common(table, chunks, init, out, C, L, Q, n_cls_pad, tile,
                      bulk);
    p.lookahead = lookahead;
    p.cand_index = cand_index;
    p.sinks = sinks;
    p.absorbing = absorbing;
    p.skipped = skipped;
    p.scratch = scratch;
    p.K = K;
    p.S = S;
    p.pad_key = pad_key;
    p.l_blk = l_blk;
    p.early_exit = early_exit;
    p.carry_in_smem = carry_in_smem;
    p.cluster = cluster;
    p.rows = (C + cluster - 1) / cluster;
    p.width = K * S;
    p.tpc = (p.width + LPT - 1) / LPT;
    p.cons = cons;
    p.passes = passes;
    if (cluster < 1 || cluster > 8 || cons < 32 || cons % 32
        || cons > spec_scan::MAX_CONSUMERS || l_blk % tile)
        return (int)cudaErrorInvalidValue;
    return launch::launch_ex(pick<MODE>(table_in_smem != 0), p,
                             dim3((unsigned)(B * cluster)), cons + 32,
                             layout(p, table_in_smem != 0, true).total,
                             cluster, stream);
}

}  // namespace

extern "C" {

int spec_match_merge_launch(
        const int* table, const int* chunks, const int* init,
        const int* lookahead, const int* cand_index, const int* sinks,
        const int* absorbing, int* out, int* skipped, int* scratch,
        int B, int C, int L, int Q, int n_cls_pad, int K, int S, int pad_key,
        int l_blk, int early_exit, int table_in_smem, int carry_in_smem,
        int cluster, int cons, int passes, int tile, int bulk, void* stream) {
    return launch_merge<MERGE>(
        table, chunks, init, lookahead, cand_index, sinks, absorbing, out,
        skipped, scratch, B, C, L, Q, n_cls_pad, K, S, pad_key, l_blk,
        early_exit, table_in_smem, carry_in_smem, cluster, cons, passes, tile,
        bulk, stream);
}

int spec_match_merge_lanes_launch(
        const int* table, const int* chunks, const int* init,
        const int* lookahead, const int* cand_index, const int* sinks,
        const int* absorbing, int* out, int* skipped, int* scratch,
        int B, int C, int L, int Q, int n_cls_pad, int K, int S, int pad_key,
        int l_blk, int early_exit, int table_in_smem, int carry_in_smem,
        int cluster, int cons, int passes, int tile, int bulk, void* stream) {
    return launch_merge<MERGE_LANES>(
        table, chunks, init, lookahead, cand_index, sinks, absorbing, out,
        skipped, scratch, B, C, L, Q, n_cls_pad, K, S, pad_key, l_blk,
        early_exit, table_in_smem, carry_in_smem, cluster, cons, passes, tile,
        bulk, stream);
}

int spec_match_launch(const int* table, const int* chunks, const int* init,
                      int* out, int C, int L, int Q, int n_cls, int S,
                      int c_blk, int s_blk, int table_in_smem, int cons,
                      int tile, int bulk, void* stream) {
    Params p = common(table, chunks, init, out, C, L, Q, n_cls, tile, bulk);
    p.S = S;
    p.rows = c_blk;
    p.width = s_blk;
    p.tpc = (s_blk + LPT - 1) / LPT;
    p.cons = cons;
    if (cons < 32 || cons % 32 || cons > spec_scan::MAX_CONSUMERS
        || p.rows * p.tpc > cons)
        return (int)cudaErrorInvalidValue;
    return launch::launch_ex(pick<SPEC>(table_in_smem != 0), p,
                             dim3((unsigned)((C + c_blk - 1) / c_blk),
                                  (unsigned)((S + s_blk - 1) / s_blk)),
                             cons + 32,
                             layout(p, table_in_smem != 0, false).total, 1,
                             stream);
}

}  // extern "C"
