// The sequential create_transfers / create_accounts kernels for Hopper
// (sm_90a).
//
// No Pallas counterpart: these are the JAX package's XLA kernels
// `create_transfers_kernel` (tigerbeetle_tpu/ops/create_kernels.py:664, a
// lax.fori_loop of `_ct_body` :282-662) and `create_accounts_kernel`
// (:792, a loop of `_ca_body` :676-790), the exact device path whose
// results the oracle pins. Each computes, bit for bit, what its plain
// PyTorch twin in tigerbeetle_tpu_torch/ops/create_kernels.py computes
// (`create_transfers_seq_plain` / `create_accounts_seq_plain`): the same
// checks in the same order (the first failing check wins), the same
// application, the same undo log and LIFO chain rollback, over the caches
// the host prefetched (ops/batch.py). Every padded lane of the batch is
// walked too, as the JAX loop walks them, so every output array (the undo
// log included) equals the twin's.
//
// Data: every array is a PyTorch tensor handed over by pointer. u64
// lanes are int64 tensors read here as uint64_t (unsigned compares,
// wrapping arithmetic); u32 and i32 lanes are int64 tensors holding the
// widened value; bool lanes are bool tensors. Balances are u128 as
// (hi, lo) limb pairs, combined here into unsigned __int128. The kernels
// read their inputs and write every output (the wrapper, ops/create_seq.py,
// allocates them uninitialised).
//
// create_transfers: one launch of one block of kThreads threads, in four
// stages, the twin's own split (`_ct_prepass`, `_ct_walk`):
//  1. stage (every thread): the "hot" region, in shared memory when it
//     fits beside the record ring (config 3's 1,024 account rows take
//     80 KB), else in the wrapper's global scratch (L2-resident): the
//     mutable account carry packed into one 80-byte row an account
//     (ARow); a slot's created and orphaned bytes, pending status and
//     last writer; an event's result code; a committed row's pending
//     status.
//  2. pre-pass (every thread, one lane each): what reads only immutable
//     inputs, decoded once into one 304-byte record an event (Rec) in
//     global scratch: the event's fields, the committed-cache pending
//     row, the exists status where the committed cache alone decides
//     it, the checks before the paths and the wrapper's, and for the
//     post/void and regular paths a mask of the failing checks (bit k:
//     check k of kPvCodes / kRegCodes).
//  3. walk (warp 0): lane 0 takes the events in order while the warp's
//     lanes copy the next 32 records into a shared-memory ring with
//     cp.async. It branches on the event's path and loads only that
//     path's rows, ORs the bits of the path's mutable checks (pending
//     status, closed accounts, overflows and limits, key_max) into the
//     pre-pass mask and takes the lowest set bit as the status. It
//     writes as little as it can: a created event becomes its slot's
//     writer (the batch-store row is rebuilt from the writer's record
//     and undo row, `batch_row`); the result is a 2-byte code; the undo
//     log is one packed 64-byte row an event (URow) in global scratch,
//     which a breaking chain replays newest-first.
//  4. unstage (every thread): the hot region, the rebuilt batch-store
//     rows, the undo rows and the result codes into the twin's
//     structure-of-arrays outputs.
// `stamps` gets %globaltimer at the five stage boundaries: the kernel's
// device time, read without a profiler.
//
// What bounds it: the walk, one thread's chain of dependent
// instructions an event (shared-memory loads, u128 checks, the writes),
// not bytes (an 8,190-event batch reads and writes ~3.9 MB, ~1.2 us at
// 3.35 TB/s). On an H100 80GB HBM3 at 700 W (scripts/chip_seq_turns.py,
// PERF.md) a config-3 batch takes ~5.9 ms, 96% of it the walk (~690 ns
// an event), against ~17.9 ms for the one-thread kernel it replaces.
// The first walk (every batch-store row and result written by the walk,
// a generic pointer into shared memory, 512 threads spilling) took
// 10.0 ms.
//
// create_accounts: one launch of one block of kCaThreads threads, the
// same four stages (the twin's `_ca_prepass`, `_ca_walk`). An account
// batch moves no balances: what one event leaves for the next is a
// batch-store row (an id repeated in the batch), key_max (`regress`) and
// the chain, so the walk is short.
//  1. stage: the hot region, in shared memory when it fits (a slot's
//     word: its last writer and a created bit; a lane's slot; a lane's
//     rcode).
//  2. pre-pass: each event decoded once into a 16-byte walk record
//     (AWalk: ts_act, slot, the static statuses s0 / post / ovr and the
//     event's bits) and a 64-byte record of the fields a batch-store
//     row holds (ARec), in global scratch.
//  3. walk (warp 0), a chunk of 32 events at a time, copied into a
//     shared-memory ring with cp.async one chunk ahead. A chunk with no
//     chain open, no valid linked event and no slot shared by two of its
//     undecided lanes is one warp step: each lane takes its event, and
//     key_max before a lane is a max scan over the lanes before it
//     (`ca_walk_chunk`). Any other chunk lane 0 walks one event at a
//     time (`ca_walk_event`).
//  4. unstage: each slot's row rebuilt from its writer's record, each
//     lane's result from its rcode.
// What bounds it: the chunks lane 0 walks one event at a time (a chain,
// an id repeated within the chunk), ~200 ns an event of dependent
// shared-memory steps, and on a batch of new accounts the warp steps'
// cp.async waits and the pre-pass's loads; not bytes (an 8,190-event
// batch moves ~2 MB, ~0.6 us at 3.35 TB/s). On an H100 80GB HBM3 at
// 700 W (scripts/chip_seq_turns.py, PERF.md) 8,190 new accounts take
// ~0.22 ms (the walk 0.16 ms) and an 8,190-event batch with chains and
// repeated ids ~1.7 ms (the walk 1.64 ms), against ~11 ms for the
// one-thread kernel it replaces.

// Argument block: `SeqArgs.p` holds the tensors' pointers in the order of
// the `Ptr` enums below (ops/create_seq.py `CT_PTRS` / `CA_PTRS` list the
// same names; tests/test_torch_create_kernels.py checks the two agree),
// passed by value as a __grid_constant__ parameter.

#include <cuda_runtime.h>
#include <stdint.h>

typedef uint64_t u64;
typedef int64_t i64;
typedef uint32_t u32;
typedef int32_t i32;
typedef uint8_t u8;
typedef uint16_t u16;
typedef unsigned __int128 u128;

static constexpr int kMaxPtrs = 128;

// Not in an unnamed namespace: the extern "C" entry points take it, and
// an argument type with internal linkage would give them internal
// linkage too.
struct SeqArgs {
  void* p[kMaxPtrs];
  u64 timestamp;
  i64 n;  // events in the batch
  i64 N;  // padded lanes walked
  // create_transfers only:
  i64 a_rows;      // account-cache rows
  i64 t_rows;      // committed-cache rows
  // Both kernels: the kind's key_max before the batch
  // (transfers_key_max, accounts_key_max).
  u64 key_max;
  u64 pulse_next;  // create_transfers: pulse_next_timestamp before it
  // Both kernels: create_<kind>_seq_scratch() bytes, any contents; and
  // %globaltimer at the five stage boundaries (5 u64).
  void* scratch;
  void* stamps;
};

namespace ct {
enum Ptr {
  EV_ID_HI, EV_ID_LO, EV_DR_HI, EV_DR_LO, EV_CR_HI, EV_CR_LO,
  EV_AMT_HI, EV_AMT_LO, EV_PID_HI, EV_PID_LO, EV_UD128_HI, EV_UD128_LO,
  EV_UD64, EV_UD32, EV_TIMEOUT, EV_LEDGER, EV_CODE, EV_FLAGS, EV_TS,
  EV_DR_IDX, EV_CR_IDX, EV_EXISTS_IDX, EV_SLOT, EV_PENDING_CACHE_IDX,
  EV_PENDING_SLOT, EV_VALID, EV_ORPHANED, EV_ACCT_TS_COLLISION,
  AC_EXISTS, AC_LEDGER, AC_TS,
  TC_DR_IDX, TC_CR_IDX, TC_DR_HI, TC_DR_LO, TC_CR_HI, TC_CR_LO,
  TC_AMT_HI, TC_AMT_LO, TC_PID_HI, TC_PID_LO, TC_UD128_HI, TC_UD128_LO,
  TC_UD64, TC_UD32, TC_TIMEOUT, TC_LEDGER, TC_CODE, TC_FLAGS, TC_TS,
  TC_EXPIRES_AT,
  ST_A_DP_HI, ST_A_DP_LO, ST_A_DPOS_HI, ST_A_DPOS_LO, ST_A_CP_HI,
  ST_A_CP_LO, ST_A_CPOS_HI, ST_A_CPOS_LO, ST_A_FLAGS,
  ST_S_CREATED, ST_S_ORPHANED, ST_S_AMT_HI, ST_S_AMT_LO, ST_S_DR_HI,
  ST_S_DR_LO, ST_S_CR_HI, ST_S_CR_LO, ST_S_PID_HI, ST_S_PID_LO,
  ST_S_UD128_HI, ST_S_UD128_LO, ST_S_UD64, ST_S_UD32, ST_S_TIMEOUT,
  ST_S_LEDGER, ST_S_CODE, ST_S_FLAGS, ST_S_TS, ST_S_PSTAT, ST_S_EXPIRES,
  ST_S_DR_IDX, ST_S_CR_IDX,
  ST_TC_PSTAT,
  ST_RB_KIND, ST_RB_DR_IDX, ST_RB_CR_IDX, ST_RB_AMT_HI, ST_RB_AMT_LO,
  ST_RB_PAMT_HI, ST_RB_PAMT_LO, ST_RB_P_IDX, ST_RB_P_BATCH,
  ST_RB_DR_CLOSED, ST_RB_CR_CLOSED,
  ST_R_TS, ST_R_STATUS,
  ST_KEY_MAX, ST_PULSE_NEXT, ST_CHAIN_KEY_MAX, ST_CHAIN_START,
  ST_CHAIN_BROKEN,
  AC_DP_HI, AC_DP_LO, AC_DPOS_HI, AC_DPOS_LO, AC_CP_HI, AC_CP_LO,
  AC_CPOS_HI, AC_CPOS_LO, AC_FLAGS,
  TC_PENDING_STATUS,
  NPTR
};
}  // namespace ct

namespace ca {
enum Ptr {
  EV_ID_HI, EV_ID_LO, EV_DP_HI, EV_DP_LO, EV_DPOS_HI, EV_DPOS_LO,
  EV_CP_HI, EV_CP_LO, EV_CPOS_HI, EV_CPOS_LO, EV_UD128_HI, EV_UD128_LO,
  EV_UD64, EV_UD32, EV_RESERVED, EV_LEDGER, EV_CODE, EV_FLAGS, EV_TS,
  EV_EXISTS_IDX, EV_SLOT, EV_VALID, EV_TRANSFER_TS_COLLISION,
  AC_UD128_HI, AC_UD128_LO, AC_UD64, AC_UD32, AC_LEDGER, AC_CODE,
  AC_FLAGS, AC_TS,
  ST_S_CREATED, ST_S_UD128_HI, ST_S_UD128_LO, ST_S_UD64, ST_S_UD32,
  ST_S_LEDGER, ST_S_CODE, ST_S_FLAGS, ST_S_TS,
  ST_R_TS, ST_R_STATUS,
  ST_KEY_MAX, ST_CHAIN_KEY_MAX, ST_CHAIN_START, ST_CHAIN_BROKEN,
  NPTR
};
}  // namespace ca

static_assert(ct::NPTR <= kMaxPtrs && ca::NPTR <= kMaxPtrs,
              "SeqArgs.p is too small");

namespace {

constexpr u64 kCreated = 0xFFFFFFFFull;
constexpr u64 kU63Max = 0x7FFFFFFFFFFFFFFFull;
constexpr u64 kNsPerS = 1000000000ull;
constexpr u128 kU128Max = ~static_cast<u128>(0);

// Transfer flag bits (types.TransferFlags).
constexpr u64 F_LINKED = 1u << 0, F_PENDING = 1u << 1, F_POST = 1u << 2,
              F_VOID = 1u << 3, F_BAL_DR = 1u << 4, F_BAL_CR = 1u << 5,
              F_CLOSE_DR = 1u << 6, F_CLOSE_CR = 1u << 7,
              F_IMPORTED = 1u << 8;
constexpr u64 TF_PADDING = 0xFFFFu & ~0x1FFu;
// Account flag bits (types.AccountFlags).
constexpr u64 A_LINKED = 1u << 0, A_DR_LIMIT = 1u << 1,
              A_CR_LIMIT = 1u << 2, A_IMPORTED = 1u << 4,
              A_CLOSED = 1u << 5;
constexpr u64 AF_PADDING = 0xFFFFu & ~0x3Fu;
// TransferPendingStatus.
constexpr i64 PS_PENDING = 1, PS_POSTED = 2, PS_VOIDED = 3, PS_EXPIRED = 4;

// CreateTransferStatus wire codes (types.CreateTransferStatus).
namespace ts {
constexpr u64 linked_event_failed = 1, linked_event_chain_open = 2,
  timestamp_must_be_zero = 3, reserved_flag = 4, id_must_not_be_zero = 5,
  id_must_not_be_int_max = 6, flags_are_mutually_exclusive = 7,
  debit_account_id_must_not_be_zero = 8,
  debit_account_id_must_not_be_int_max = 9,
  credit_account_id_must_not_be_zero = 10,
  credit_account_id_must_not_be_int_max = 11,
  accounts_must_be_different = 12, pending_id_must_be_zero = 13,
  pending_id_must_not_be_zero = 14, pending_id_must_not_be_int_max = 15,
  pending_id_must_be_different = 16,
  timeout_reserved_for_pending_transfer = 17, ledger_must_not_be_zero = 19,
  code_must_not_be_zero = 20, debit_account_not_found = 21,
  credit_account_not_found = 22, accounts_must_have_the_same_ledger = 23,
  transfer_must_have_the_same_ledger_as_accounts = 24,
  pending_transfer_not_found = 25, pending_transfer_not_pending = 26,
  pending_transfer_has_different_debit_account_id = 27,
  pending_transfer_has_different_credit_account_id = 28,
  pending_transfer_has_different_ledger = 29,
  pending_transfer_has_different_code = 30,
  exceeds_pending_transfer_amount = 31,
  pending_transfer_has_different_amount = 32,
  pending_transfer_already_posted = 33,
  pending_transfer_already_voided = 34, pending_transfer_expired = 35,
  exists_with_different_flags = 36,
  exists_with_different_debit_account_id = 37,
  exists_with_different_credit_account_id = 38,
  exists_with_different_amount = 39, exists_with_different_pending_id = 40,
  exists_with_different_user_data_128 = 41,
  exists_with_different_user_data_64 = 42,
  exists_with_different_user_data_32 = 43,
  exists_with_different_timeout = 44, exists_with_different_code = 45,
  exists = 46, overflows_debits_pending = 47,
  overflows_credits_pending = 48, overflows_debits_posted = 49,
  overflows_credits_posted = 50, overflows_debits = 51,
  overflows_credits = 52, overflows_timeout = 53, exceeds_credits = 54,
  exceeds_debits = 55, imported_event_expected = 56,
  imported_event_not_expected = 57,
  imported_event_timestamp_out_of_range = 58,
  imported_event_timestamp_must_not_advance = 59,
  imported_event_timestamp_must_not_regress = 60,
  imported_event_timestamp_must_postdate_debit_account = 61,
  imported_event_timestamp_must_postdate_credit_account = 62,
  imported_event_timeout_must_be_zero = 63,
  closing_transfer_must_be_pending = 64,
  debit_account_already_closed = 65, credit_account_already_closed = 66,
  exists_with_different_ledger = 67, id_already_failed = 68;
}  // namespace ts

// CreateAccountStatus wire codes (types.CreateAccountStatus).
namespace as {
constexpr u64 linked_event_failed = 1, linked_event_chain_open = 2,
  timestamp_must_be_zero = 3, reserved_field = 4, reserved_flag = 5,
  id_must_not_be_zero = 6, id_must_not_be_int_max = 7,
  flags_are_mutually_exclusive = 8, debits_pending_must_be_zero = 9,
  debits_posted_must_be_zero = 10, credits_pending_must_be_zero = 11,
  credits_posted_must_be_zero = 12, ledger_must_not_be_zero = 13,
  code_must_not_be_zero = 14, exists_with_different_flags = 15,
  exists_with_different_user_data_128 = 16,
  exists_with_different_user_data_64 = 17,
  exists_with_different_user_data_32 = 18,
  exists_with_different_ledger = 19, exists_with_different_code = 20,
  exists = 21, imported_event_expected = 22,
  imported_event_not_expected = 23,
  imported_event_timestamp_out_of_range = 24,
  imported_event_timestamp_must_not_advance = 25,
  imported_event_timestamp_must_not_regress = 26;
}  // namespace as

__device__ __forceinline__ bool transient(u64 s) {
  return s == ts::debit_account_not_found ||
         s == ts::credit_account_not_found ||
         s == ts::pending_transfer_not_found || s == ts::exceeds_credits ||
         s == ts::exceeds_debits || s == ts::debit_account_already_closed ||
         s == ts::credit_account_already_closed;
}

// Typed views of the argument block.
struct View {
  const SeqArgs& a;
  __device__ u64* u(int k) const { return static_cast<u64*>(a.p[k]); }
  __device__ i64* s(int k) const { return static_cast<i64*>(a.p[k]); }
  __device__ bool* b(int k) const { return static_cast<bool*>(a.p[k]); }
  __device__ u128 q(int hi, int lo, i64 i) const {
    return (static_cast<u128>(u(hi)[i]) << 64) | u(lo)[i];
  }
  __device__ void set_q(int hi, int lo, i64 i, u128 v) const {
    u(hi)[i] = static_cast<u64>(v >> 64);
    u(lo)[i] = static_cast<u64>(v);
  }
};

// The first listed failing check wins (the plain twin's _first_failure).
#define CHECK(status, cond, code) \
  if ((status) == kCreated && (cond)) (status) = (code)

// ============================================================ create_transfers

// The one block. At 512 threads a thread may hold 128 registers and the
// walk spills; at 256 it takes ~220 and keeps them.
constexpr int kThreads = 256;
constexpr int kChunk = 32;     // records a ring slot: one a lane of warp 0
// Dynamic shared memory a block may take on sm_90 (227 KB).
constexpr i64 kSmemCap = 232448;

// One event as the pre-pass leaves it. p_* is the pending row when it
// comes from the committed cache (pci >= 0), zero otherwise.
struct alignas(16) Rec {
  u128 amt, dr, cr, pid, ud128;
  u128 p_amt, p_dr, p_cr, p_ud128;
  u64 ts, ts_act, ts_event, timeout_ns, ud64, p_ud64, p_expires, exists_ts;
  u32 flags, timeout, ud32, ledger, code;
  u32 p_ud32, p_timeout, p_ledger, p_code, p_flags;
  i32 slot, psl, pci, ei, dr_idx, cr_idx, p_dr_idx, p_cr_idx;
  u32 pv_mask, reg_mask;
  u32 pre, ovr, exists_status;  // codes; kCreated: none
  u32 bits;                     // R_*
};
constexpr u32 R_VALID = 1, R_ORPHANED = 2, R_CHAIN_OPEN = 4,
              R_EXISTS_PRE = 8;

// The p-derived fields of a batch-store row written by a post or void
// whose pending row came from the batch store (the twin's s_* fields that
// copy that row, user data already chosen).
struct alignas(16) PvRow {
  u128 dr, cr, ud128;
  u64 ud64;
  u32 ud32, ledger, code;
};

// One undo-log row (the twin's rb_* at one event, and its slot).
struct alignas(16) URow {
  u128 amt, pamt;
  i32 kind, dr_idx, cr_idx, p_idx, slot;
  u8 p_batch, dr_closed, cr_closed;
};

// One account's mutable carry.
struct alignas(16) ARow {
  u128 dp, dpos, cp, cpos;
  u64 flags, pad;
};

static_assert(sizeof(Rec) == 304 && sizeof(PvRow) == 80 &&
                  sizeof(URow) == 64 && sizeof(ARow) == 80,
              "packed row sizes");

// An event's result as the walk leaves it (rcode): the status (its wire
// code, kRcCreated for created) and where its timestamp comes from.
constexpr u32 kRcStatus = 0x7F, kRcCreated = 0x7F;
constexpr u32 RC_TS_EVENT = 0 << 7, RC_TS_ACT = 1 << 7,
              RC_TS_EXISTS = 2 << 7,  // the record's exists_ts
              RC_TS_DIRECT = 3 << 7;  // the walk wrote r_ts itself
constexpr u32 kRcTs = 3 << 7;

// Where everything lives. The global scratch: records, undo rows, post /
// void rows, then the hot region unless it is in shared memory. Shared
// memory: the record ring (two buffers of kChunk), then the hot region
// when it fits. The hot region: the account rows, and a slot's created
// and orphaned bytes, pending status and last writer (the event whose
// batch-store row it holds: the row is rebuilt from that event's record
// and undo row), an event's rcode, a committed row's pending status.
struct Layout {
  i64 rec, undo, pv, hot;  // bytes into the scratch
  i64 acct, created, orphaned, spstat, writer, rcode, tpstat;  // into hot
  i64 hot_bytes, ring_bytes, scratch_bytes, smem_bytes;
  bool hot_in_smem;
};

__host__ __device__ inline i64 align16(i64 x) { return (x + 15) & ~i64{15}; }

__host__ __device__ inline Layout ct_layout(i64 N, i64 A, i64 T) {
  Layout L;
  L.acct = 0;
  L.created = align16(A * i64{sizeof(ARow)});
  L.orphaned = L.created + align16(N);
  L.spstat = L.orphaned + align16(N);
  L.writer = L.spstat + align16(N);
  L.rcode = L.writer + align16(N * 4);
  L.tpstat = L.rcode + align16(N * 2);
  L.hot_bytes = L.tpstat + align16(T * 4);
  L.ring_bytes = 2 * kChunk * i64{sizeof(Rec)};
  L.hot_in_smem = L.ring_bytes + L.hot_bytes <= kSmemCap;
  L.smem_bytes = L.ring_bytes + (L.hot_in_smem ? L.hot_bytes : 0);
  L.rec = 0;
  L.undo = L.rec + N * i64{sizeof(Rec)};
  L.pv = L.undo + N * i64{sizeof(URow)};
  L.hot = L.pv + N * i64{sizeof(PvRow)};
  L.scratch_bytes = L.hot + (L.hot_in_smem ? 0 : L.hot_bytes);
  return L;
}

// The post/void checks (reference :4053-4299) and the regular checks
// (:3748-3904) in order: bit k of a path's mask is check k failing. The
// twin lists the same codes (ops/create_kernels.py _PV_CODES /
// _REG_CODES; tests/test_torch_create_kernels.py checks they agree).
__constant__ u32 kPvCodes[21] = {
    ts::flags_are_mutually_exclusive, ts::flags_are_mutually_exclusive,
    ts::pending_id_must_not_be_zero, ts::pending_id_must_not_be_int_max,
    ts::pending_id_must_be_different,
    ts::timeout_reserved_for_pending_transfer,
    ts::pending_transfer_not_found, ts::pending_transfer_not_pending,
    ts::pending_transfer_has_different_debit_account_id,
    ts::pending_transfer_has_different_credit_account_id,
    ts::pending_transfer_has_different_ledger,
    ts::pending_transfer_has_different_code,
    ts::exceeds_pending_transfer_amount,
    ts::pending_transfer_has_different_amount,
    ts::pending_transfer_already_posted,
    ts::pending_transfer_already_voided, ts::pending_transfer_expired,
    ts::pending_transfer_expired,
    ts::imported_event_timestamp_must_not_regress,
    ts::debit_account_already_closed, ts::credit_account_already_closed};
__constant__ u32 kRegCodes[29] = {
    ts::debit_account_id_must_not_be_zero,
    ts::debit_account_id_must_not_be_int_max,
    ts::credit_account_id_must_not_be_zero,
    ts::credit_account_id_must_not_be_int_max,
    ts::accounts_must_be_different, ts::pending_id_must_be_zero,
    ts::timeout_reserved_for_pending_transfer,
    ts::closing_transfer_must_be_pending, ts::ledger_must_not_be_zero,
    ts::code_must_not_be_zero, ts::debit_account_not_found,
    ts::credit_account_not_found, ts::accounts_must_have_the_same_ledger,
    ts::transfer_must_have_the_same_ledger_as_accounts,
    ts::imported_event_timestamp_must_not_regress,
    ts::imported_event_timestamp_must_postdate_debit_account,
    ts::imported_event_timestamp_must_postdate_credit_account,
    ts::imported_event_timeout_must_be_zero,
    ts::debit_account_already_closed, ts::credit_account_already_closed,
    ts::overflows_debits_pending, ts::overflows_credits_pending,
    ts::overflows_debits_posted, ts::overflows_credits_posted,
    ts::overflows_debits, ts::overflows_credits, ts::overflows_timeout,
    ts::exceeds_credits, ts::exceeds_debits};

__device__ __forceinline__ u64 first_code(u32 mask, const u32* codes) {
  return mask ? codes[__ffs(static_cast<int>(mask)) - 1] : kCreated;
}

__device__ __forceinline__ u64 now_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// 16 bytes global -> shared, asynchronously (L2 only: the records were
// written by other threads of the block).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// u128 add: the sum mod 2^128; *ovf is set when it wrapped.
__device__ __forceinline__ u128 add(u128 a, u128 b, bool* ovf) {
  const u128 r = a + b;
  *ovf = r < a;
  return r;
}

__device__ __forceinline__ u128 umin(u128 a, u128 b) { return a < b ? a : b; }
__device__ __forceinline__ u128 sat_sub(u128 a, u128 b) {
  return a < b ? 0 : a - b;
}

// A stored transfer, from the committed cache or the batch store.
struct Row {
  u128 amt, dr, cr, pid, ud128;
  u64 ud64, ud32, timeout, ledger, code, flags, ts, expires;
  i64 dr_idx, cr_idx, pstat;
};

__device__ Row tc_row(const View& v, i64 c) {
  using namespace ct;
  Row r;
  r.amt = v.q(TC_AMT_HI, TC_AMT_LO, c);
  r.dr = v.q(TC_DR_HI, TC_DR_LO, c);
  r.cr = v.q(TC_CR_HI, TC_CR_LO, c);
  r.pid = v.q(TC_PID_HI, TC_PID_LO, c);
  r.ud128 = v.q(TC_UD128_HI, TC_UD128_LO, c);
  r.ud64 = v.u(TC_UD64)[c];
  r.ud32 = v.u(TC_UD32)[c];
  r.timeout = v.u(TC_TIMEOUT)[c];
  r.ledger = v.u(TC_LEDGER)[c];
  r.code = v.u(TC_CODE)[c];
  r.flags = v.u(TC_FLAGS)[c];
  r.ts = v.u(TC_TS)[c];
  r.expires = v.u(TC_EXPIRES_AT)[c];
  r.dr_idx = v.s(TC_DR_IDX)[c];
  r.cr_idx = v.s(TC_CR_IDX)[c];
  r.pstat = 0;  // mutable: the walk reads it from the hot region
  return r;
}

// The pending row the pre-pass copied from the committed cache.
__device__ Row rec_p_row(const Rec& x) {
  Row r;
  r.amt = x.p_amt;
  r.dr = x.p_dr;
  r.cr = x.p_cr;
  r.pid = 0;
  r.ud128 = x.p_ud128;
  r.ud64 = x.p_ud64;
  r.ud32 = x.p_ud32;
  r.timeout = x.p_timeout;
  r.ledger = x.p_ledger;
  r.code = x.p_code;
  r.flags = x.p_flags;
  r.ts = 0;
  r.expires = x.p_expires;
  r.dr_idx = x.p_dr_idx;
  r.cr_idx = x.p_cr_idx;
  r.pstat = 0;
  return r;
}

// create_transfer_exists + post_or_void_pending_transfer_exists
// (reference :3988-4051, 4301-4382; the twin's _ct_eval_exists) of the
// event x against the rows e and p (p is read only for a post or void).
__device__ u64 exists_status(const Rec& x, const Row& e, const Row& p) {
  const u64 flags = x.flags;
  const bool is_void = flags & F_VOID;
  const bool pv = flags & (F_POST | F_VOID);
  const bool balancing = flags & (F_BAL_DR | F_BAL_CR);
  const bool amt_ne_e = x.amt != e.amt;
  const bool amt_diff_regular = balancing ? x.amt < e.amt : amt_ne_e;
  bool amt_diff_pv = false;
  if (pv) {
    const bool eamt_ne_pamt = e.amt != p.amt;
    amt_diff_pv = is_void ? (x.amt == 0 ? eamt_ne_pamt : amt_ne_e)
                          : (x.amt == kU128Max ? eamt_ne_pamt : amt_ne_e);
  }
  const bool ud128_diff =
      pv ? (x.ud128 == 0 ? e.ud128 != p.ud128 : x.ud128 != e.ud128)
         : x.ud128 != e.ud128;
  const bool ud64_diff =
      pv ? (x.ud64 == 0 ? e.ud64 != p.ud64 : x.ud64 != e.ud64)
         : x.ud64 != e.ud64;
  const bool ud32_diff =
      pv ? (x.ud32 == 0 ? e.ud32 != p.ud32 : x.ud32 != e.ud32)
         : x.ud32 != e.ud32;
  const bool dr_diff = pv ? (x.dr != 0 && x.dr != e.dr) : x.dr != e.dr;
  const bool cr_diff = pv ? (x.cr != 0 && x.cr != e.cr) : x.cr != e.cr;
  const bool ledger_diff =
      pv ? (x.ledger != 0 && x.ledger != e.ledger) : x.ledger != e.ledger;
  const bool code_diff =
      pv ? (x.code != 0 && x.code != e.code) : x.code != e.code;
  u64 s = kCreated;
  CHECK(s, (flags & 0xFFFF) != (e.flags & 0xFFFF),
        ts::exists_with_different_flags);
  CHECK(s, x.pid != e.pid, ts::exists_with_different_pending_id);
  CHECK(s, x.timeout != e.timeout, ts::exists_with_different_timeout);
  CHECK(s, dr_diff, ts::exists_with_different_debit_account_id);
  CHECK(s, cr_diff, ts::exists_with_different_credit_account_id);
  CHECK(s, pv ? amt_diff_pv : amt_diff_regular,
        ts::exists_with_different_amount);
  CHECK(s, ud128_diff, ts::exists_with_different_user_data_128);
  CHECK(s, ud64_diff, ts::exists_with_different_user_data_64);
  CHECK(s, ud32_diff, ts::exists_with_different_user_data_32);
  CHECK(s, ledger_diff, ts::exists_with_different_ledger);
  CHECK(s, code_diff, ts::exists_with_different_code);
  return s == kCreated ? ts::exists : s;
}

// Stage 2, lane i (the twin's _ct_prepass on one lane).
__device__ void prepass(const View& v, i64 i, Rec* out) {
  using namespace ct;
  const SeqArgs& a = v.a;
  Rec x;
  const u64 flags = v.u(EV_FLAGS)[i];
  const bool linked = flags & F_LINKED, imported = flags & F_IMPORTED;
  const bool is_post = flags & F_POST, is_void = flags & F_VOID;
  const bool pv = is_post || is_void, pending = flags & F_PENDING;
  x.flags = static_cast<u32>(flags);
  x.amt = v.q(EV_AMT_HI, EV_AMT_LO, i);
  x.dr = v.q(EV_DR_HI, EV_DR_LO, i);
  x.cr = v.q(EV_CR_HI, EV_CR_LO, i);
  x.pid = v.q(EV_PID_HI, EV_PID_LO, i);
  x.ud128 = v.q(EV_UD128_HI, EV_UD128_LO, i);
  const u128 id = v.q(EV_ID_HI, EV_ID_LO, i);
  x.ud64 = v.u(EV_UD64)[i];
  x.ud32 = static_cast<u32>(v.u(EV_UD32)[i]);
  x.timeout = static_cast<u32>(v.u(EV_TIMEOUT)[i]);
  x.ledger = static_cast<u32>(v.u(EV_LEDGER)[i]);
  x.code = static_cast<u32>(v.u(EV_CODE)[i]);
  x.ts = v.u(EV_TS)[i];
  x.ts_event = a.timestamp - static_cast<u64>(a.n) + static_cast<u64>(i) + 1;
  x.ts_act = imported ? x.ts : x.ts_event;
  x.timeout_ns = static_cast<u64>(x.timeout) * kNsPerS;
  x.slot = static_cast<i32>(v.s(EV_SLOT)[i]);
  x.psl = static_cast<i32>(v.s(EV_PENDING_SLOT)[i]);
  x.pci = static_cast<i32>(v.s(EV_PENDING_CACHE_IDX)[i]);
  x.ei = static_cast<i32>(v.s(EV_EXISTS_IDX)[i]);
  x.dr_idx = static_cast<i32>(v.s(EV_DR_IDX)[i]);
  x.cr_idx = static_cast<i32>(v.s(EV_CR_IDX)[i]);
  const bool collision = imported && v.b(EV_ACCT_TS_COLLISION)[i];
  const bool p_cache = x.pci >= 0;

  // The pending row, where the committed cache holds it.
  Row p;
  if (p_cache) {
    p = tc_row(v, x.pci);
  } else {
    p = Row{};
  }
  x.p_amt = p.amt;
  x.p_dr = p.dr;
  x.p_cr = p.cr;
  x.p_ud128 = p.ud128;
  x.p_ud64 = p.ud64;
  x.p_ud32 = static_cast<u32>(p.ud32);
  x.p_timeout = static_cast<u32>(p.timeout);
  x.p_ledger = static_cast<u32>(p.ledger);
  x.p_code = static_cast<u32>(p.code);
  x.p_flags = static_cast<u32>(p.flags);
  x.p_expires = p.expires;
  x.p_dr_idx = static_cast<i32>(p.dr_idx);
  x.p_cr_idx = static_cast<i32>(p.cr_idx);

  // The exists path, whole where it reads only the committed cache.
  u32 bits = 0;
  x.exists_status = static_cast<u32>(kCreated);
  x.exists_ts = 0;
  if (x.ei >= 0 && (!pv || p_cache)) {
    const Row e = tc_row(v, x.ei);
    x.exists_status = static_cast<u32>(exists_status(x, e, p));
    x.exists_ts = e.ts;
    bits |= R_EXISTS_PRE;
  }

  // Post/void: bits 6-13 and 17 read the pending row (here only from the
  // committed cache, where bit 6, not found, is clear).
  u32 m = 0;
  m |= static_cast<u32>(is_post && is_void) << 0;
  m |= static_cast<u32>((flags & (F_PENDING | F_BAL_DR | F_BAL_CR |
                                  F_CLOSE_DR | F_CLOSE_CR)) != 0) << 1;
  m |= static_cast<u32>(x.pid == 0) << 2;
  m |= static_cast<u32>(x.pid == kU128Max) << 3;
  m |= static_cast<u32>(x.pid == id) << 4;
  m |= static_cast<u32>(x.timeout != 0) << 5;
  if (p_cache) {
    const bool full = is_void ? x.amt == 0 : x.amt == kU128Max;
    const u128 pv_amt = full ? p.amt : x.amt;
    m |= static_cast<u32>(!(p.flags & F_PENDING)) << 7;
    m |= static_cast<u32>(x.dr != 0 && x.dr != p.dr) << 8;
    m |= static_cast<u32>(x.cr != 0 && x.cr != p.cr) << 9;
    m |= static_cast<u32>(x.ledger != 0 && x.ledger != p.ledger) << 10;
    m |= static_cast<u32>(x.code != 0 && x.code != p.code) << 11;
    m |= static_cast<u32>(p.amt < pv_amt) << 12;
    m |= static_cast<u32>(is_void && pv_amt < p.amt) << 13;
    m |= static_cast<u32>(p.timeout != 0 && p.expires <= x.ts_event) << 17;
  }
  m |= static_cast<u32>(collision) << 18;
  x.pv_mask = m;

  // Regular: bits 14 (against key_max), 18-25 and 27-28 are the walk's.
  const i64 di = x.dr_idx, ci = x.cr_idx;
  const u64 dr_ledger = v.u(AC_LEDGER)[di], cr_ledger = v.u(AC_LEDGER)[ci];
  m = 0;
  m |= static_cast<u32>(x.dr == 0) << 0;
  m |= static_cast<u32>(x.dr == kU128Max) << 1;
  m |= static_cast<u32>(x.cr == 0) << 2;
  m |= static_cast<u32>(x.cr == kU128Max) << 3;
  m |= static_cast<u32>(x.dr == x.cr) << 4;
  m |= static_cast<u32>(x.pid != 0) << 5;
  m |= static_cast<u32>(!pending && x.timeout != 0) << 6;
  m |= static_cast<u32>(!pending && (flags & (F_CLOSE_DR | F_CLOSE_CR)))
       << 7;
  m |= static_cast<u32>(x.ledger == 0) << 8;
  m |= static_cast<u32>(x.code == 0) << 9;
  m |= static_cast<u32>(!v.b(AC_EXISTS)[di]) << 10;
  m |= static_cast<u32>(!v.b(AC_EXISTS)[ci]) << 11;
  m |= static_cast<u32>(dr_ledger != cr_ledger) << 12;
  m |= static_cast<u32>(x.ledger != dr_ledger) << 13;
  m |= static_cast<u32>(collision) << 14;
  m |= static_cast<u32>(imported && x.ts <= v.u(AC_TS)[di]) << 15;
  m |= static_cast<u32>(imported && x.ts <= v.u(AC_TS)[ci]) << 16;
  m |= static_cast<u32>(imported && x.timeout != 0) << 17;
  m |= static_cast<u32>(x.ts_act + x.timeout_ns > kU63Max) << 26;
  x.reg_mask = m;

  // The checks before the paths, and the wrapper's (reference
  // execute_create :3033-3104) but for the chain's two.
  u64 pre = kCreated;
  CHECK(pre, flags & TF_PADDING, ts::reserved_flag);
  CHECK(pre, id == 0, ts::id_must_not_be_zero);
  CHECK(pre, id == kU128Max, ts::id_must_not_be_int_max);
  x.pre = static_cast<u32>(pre);
  const bool ts_valid = x.ts >= 1 && x.ts <= kU63Max;
  const bool batch_imported = (v.u(EV_FLAGS)[0] & F_IMPORTED) && a.n > 0;
  u64 ovr = kCreated;
  if (!imported && x.ts != 0) ovr = ts::timestamp_must_be_zero;
  if (imported && ts_valid && x.ts >= a.timestamp) {
    ovr = ts::imported_event_timestamp_must_not_advance;
  }
  if (imported && !ts_valid) ovr = ts::imported_event_timestamp_out_of_range;
  if (imported != batch_imported) {
    ovr = imported ? ts::imported_event_not_expected
                   : ts::imported_event_expected;
  }
  x.ovr = static_cast<u32>(ovr);

  if (v.b(EV_VALID)[i]) bits |= R_VALID;
  if (v.b(EV_ORPHANED)[i]) bits |= R_ORPHANED;
  if (linked && i == a.n - 1) bits |= R_CHAIN_OPEN;
  x.bits = bits;
  out[i] = x;
}

// The hot region and the scratch rows, as the walk and the stages see
// them.
struct Hot {
  ARow* acc;
  u8* created;
  u8* orphaned;
  u8* spstat;
  i32* writer;
  u16* rcode;
  i32* tpstat;
  const Rec* recs;
  URow* undo;
  PvRow* pv;
};

__device__ __forceinline__ Hot hot_at(unsigned char* hot, unsigned char* g,
                                      const Layout& L) {
  Hot h;
  h.acc = reinterpret_cast<ARow*>(hot + L.acct);
  h.created = hot + L.created;
  h.orphaned = hot + L.orphaned;
  h.spstat = hot + L.spstat;
  h.writer = reinterpret_cast<i32*>(hot + L.writer);
  h.rcode = reinterpret_cast<u16*>(hot + L.rcode);
  h.tpstat = reinterpret_cast<i32*>(hot + L.tpstat);
  h.recs = reinterpret_cast<const Rec*>(g + L.rec);
  h.undo = reinterpret_cast<URow*>(g + L.undo);
  h.pv = reinterpret_cast<PvRow*>(g + L.pv);
  return h;
}

// The batch-store row at `slot` (the twin's s_* there), rebuilt from its
// last writer: that event's record and undo row (its amount and account
// indexes), its post / void row, and the slot's pending status. A slot
// never written is all zero.
__device__ Row batch_row(const Hot& h, i64 slot) {
  Row r = Row{};
  r.pstat = h.spstat[slot];
  const i32 w = h.writer[slot];
  if (w < 0) return r;
  const Rec& x = h.recs[w];
  const URow& u = h.undo[w];
  const u64 f = x.flags;
  const bool pv = f & (F_POST | F_VOID);
  r.amt = u.amt;
  r.dr_idx = u.dr_idx;
  r.cr_idx = u.cr_idx;
  r.pid = x.pid;
  r.flags = f;
  r.ts = x.ts_act;
  r.timeout = pv ? 0 : x.timeout;
  r.expires = (!pv && (f & F_PENDING) && x.timeout != 0)
                  ? x.ts_act + x.timeout_ns : 0;
  if (!pv) {
    r.dr = x.dr;
    r.cr = x.cr;
    r.ud128 = x.ud128;
    r.ud64 = x.ud64;
    r.ud32 = x.ud32;
    r.ledger = x.ledger;
    r.code = x.code;
  } else if (x.pci >= 0) {
    r.dr = x.p_dr;
    r.cr = x.p_cr;
    r.ud128 = x.ud128 == 0 ? x.p_ud128 : x.ud128;
    r.ud64 = x.ud64 == 0 ? x.p_ud64 : x.ud64;
    r.ud32 = x.ud32 == 0 ? x.p_ud32 : x.ud32;
    r.ledger = x.p_ledger;
    r.code = x.p_code;
  } else {
    const PvRow& q = h.pv[w];
    r.dr = q.dr;
    r.cr = q.cr;
    r.ud128 = q.ud128;
    r.ud64 = q.ud64;
    r.ud32 = q.ud32;
    r.ledger = q.ledger;
    r.code = q.code;
  }
  return r;
}

// The walk's carry.
struct Carry {
  u64 key_max, pulse_next, chain_key_max;
  i64 chain_start;
  bool chain_broken;
  // The amount of batch-store row 0: the pending amount of every event
  // whose pending id names neither a committed transfer nor an event of
  // the batch (the undo log records it), kept here rather than rebuilt
  // an event.
  u128 amt0;
};

// Undo chain member j (the twin's rollback): balance deltas back out;
// closed bits and pending statuses return to their pre-event snapshots,
// which is why members unwind newest-first.
__device__ __forceinline__ void rollback(const Hot& h, i64 j) {
  const URow u = h.undo[j];
  ARow& dr = h.acc[u.dr_idx];
  ARow& cr = h.acc[u.cr_idx];
  if (u.kind == 1 || u.kind == 3) {
    dr.dpos -= u.amt;
    cr.cpos -= u.amt;
  }
  if (u.kind == 2) {
    dr.dp -= u.amt;
    cr.cp -= u.amt;
  }
  if (u.kind == 3 || u.kind == 4) {
    dr.dp += u.pamt;
    cr.cp += u.pamt;
    if (u.p_batch) {
      h.spstat[u.p_idx] = PS_PENDING;
    } else {
      h.tpstat[u.p_idx] = PS_PENDING;
    }
  }
  if (u.kind > 0) {
    dr.flags = u.dr_closed ? (dr.flags | A_CLOSED) : (dr.flags & ~A_CLOSED);
    cr.flags = u.cr_closed ? (cr.flags | A_CLOSED) : (cr.flags & ~A_CLOSED);
    h.created[u.slot] = 0;
  }
  h.undo[j].kind = 0;
  h.rcode[j] = static_cast<u16>((h.rcode[j] & kRcTs) |
                                ts::linked_event_failed);
}

// Stage 3, event i (the twin's _ct_walk loop body).
__device__ __forceinline__ void walk_event(const View& v, const Hot& h,
                                           Carry& c, const Rec& x, i64 i) {
  const u64 f = x.flags;
  const bool valid = x.bits & R_VALID;
  const bool linked = f & F_LINKED, imported = f & F_IMPORTED;
  const bool is_post = f & F_POST, is_void = f & F_VOID;
  const bool pv = is_post || is_void, pending = f & F_PENDING;

  // --- chain open (reference :3033-3043) ---
  bool chain_active = c.chain_start >= 0;
  if (linked && !chain_active && valid) {
    c.chain_start = i;
    c.chain_key_max = c.key_max;
    chain_active = true;
  }

  const i32 slot = x.slot;
  const bool p_cache = x.pci >= 0;
  const i32 pci = x.pci > 0 ? x.pci : 0, psl = x.psl > 0 ? x.psl : 0;
  const bool regress = imported && x.ts <= c.key_max;

  // --- the pending row (a post or void reads it whole; any other event
  // only its amount, for the undo log) and the amount ---
  Row p;
  u128 f_amt;
  i32 s_dr, s_cr;
  ARow dr, cr;
  if (pv) {
    if (p_cache) {
      p = rec_p_row(x);
      p.pstat = h.tpstat[pci];
    } else {
      p = batch_row(h, psl);
    }
    const bool full = is_void ? x.amt == 0 : x.amt == kU128Max;
    f_amt = full ? p.amt : x.amt;
    s_dr = static_cast<i32>(p.dr_idx);
    s_cr = static_cast<i32>(p.cr_idx);
  } else {
    if (p_cache) {
      p.amt = x.p_amt;
    } else if (psl == 0) {
      p.amt = c.amt0;
    } else {
      const i32 w = h.writer[psl];
      p.amt = w < 0 ? u128{0} : h.undo[w].amt;
    }
    dr = h.acc[x.dr_idx];
    cr = h.acc[x.cr_idx];
    // Balancing clamp (reference :3840-3853), wrapping sums as the twin's.
    f_amt = x.amt;
    if (f & F_BAL_DR) f_amt = umin(f_amt, sat_sub(dr.cpos, dr.dpos + dr.dp));
    if (f & F_BAL_CR) f_amt = umin(f_amt, sat_sub(cr.dpos, cr.cpos + cr.cp));
    s_dr = x.dr_idx;
    s_cr = x.cr_idx;
  }

  // --- the path's status (reference :3729-3746) ---
  const bool e_cache = x.ei >= 0;
  const bool e_found = e_cache || h.created[slot];
  u64 inner = x.pre;
  u32 ts_exists = RC_TS_EXISTS;
  if (inner != kCreated) {
    // failed before the paths
  } else if (e_found) {
    if (x.bits & R_EXISTS_PRE) {
      inner = x.exists_status;
    } else {
      const Row e = e_cache ? tc_row(v, x.ei) : batch_row(h, slot);
      inner = exists_status(x, e, p);
      if (valid) v.u(ct::ST_R_TS)[i] = e.ts;
      ts_exists = RC_TS_DIRECT;
    }
  } else if ((x.bits & R_ORPHANED) || h.orphaned[slot]) {
    inner = ts::id_already_failed;
  } else if (pv) {
    u32 m = x.pv_mask;
    if (!p_cache) {
      const bool p_found = x.psl >= 0 && h.created[psl];
      m |= static_cast<u32>(!p_found) << 6;
      m |= static_cast<u32>(!(p.flags & F_PENDING)) << 7;
      m |= static_cast<u32>(x.dr != 0 && x.dr != p.dr) << 8;
      m |= static_cast<u32>(x.cr != 0 && x.cr != p.cr) << 9;
      m |= static_cast<u32>(x.ledger != 0 && x.ledger != p.ledger) << 10;
      m |= static_cast<u32>(x.code != 0 && x.code != p.code) << 11;
      m |= static_cast<u32>(p.amt < f_amt) << 12;
      m |= static_cast<u32>(is_void && f_amt < p.amt) << 13;
      m |= static_cast<u32>(p.timeout != 0 && p.expires <= x.ts_event) << 17;
    }
    m |= static_cast<u32>(p.pstat == PS_POSTED) << 14;
    m |= static_cast<u32>(p.pstat == PS_VOIDED) << 15;
    m |= static_cast<u32>(p.pstat == PS_EXPIRED) << 16;
    m |= static_cast<u32>(regress) << 18;
    if (!is_void) {
      m |= static_cast<u32>((h.acc[s_dr].flags & A_CLOSED) != 0) << 19;
      m |= static_cast<u32>((h.acc[s_cr].flags & A_CLOSED) != 0) << 20;
    }
    inner = first_code(m, kPvCodes);
  } else {
    u32 m = x.reg_mask;
    m |= static_cast<u32>(regress) << 14;
    m |= static_cast<u32>((dr.flags & A_CLOSED) != 0) << 18;
    m |= static_cast<u32>((cr.flags & A_CLOSED) != 0) << 19;
    // Overflow checks (reference :3856-3901): none can fail while every
    // term is below 2^126, and then the limits' sums are exact.
    const u64 hi = static_cast<u64>(f_amt >> 64) |
                   static_cast<u64>(dr.dp >> 64) |
                   static_cast<u64>(dr.dpos >> 64) |
                   static_cast<u64>(cr.cp >> 64) |
                   static_cast<u64>(cr.cpos >> 64);
    if (hi >> 62) {
      bool o1, o2, o3, o4;
      const u128 s_dp = add(f_amt, dr.dp, &o1);
      const u128 s_cp = add(f_amt, cr.cp, &o2);
      m |= static_cast<u32>(pending && o1) << 20;
      m |= static_cast<u32>(pending && o2) << 21;
      add(f_amt, dr.dpos, &o3);
      add(f_amt, cr.cpos, &o4);
      m |= static_cast<u32>(o3) << 22;
      m |= static_cast<u32>(o4) << 23;
      add(s_dp, dr.dpos, &o3);
      add(s_cp, cr.cpos, &o4);
      m |= static_cast<u32>(o1 || o3) << 24;
      m |= static_cast<u32>(o2 || o4) << 25;
    }
    // Balance limits (reference tigerbeetle.zig:34-42), wrapping sums.
    if (dr.flags & A_DR_LIMIT) {
      m |= static_cast<u32>(dr.cpos < dr.dp + dr.dpos + f_amt) << 27;
    }
    if (cr.flags & A_CR_LIMIT) {
      m |= static_cast<u32>(cr.dpos < cr.cp + cr.cpos + f_amt) << 28;
    }
    inner = first_code(m, kRegCodes);
  }

  // --- wrapper checks (reference execute_create :3033-3104) ---
  u64 status = inner;
  if (x.ovr != kCreated) status = x.ovr;
  if (c.chain_broken) status = ts::linked_event_failed;
  if (x.bits & R_CHAIN_OPEN) status = ts::linked_event_chain_open;
  // Where r_ts comes from: ts_actual_inner when no wrapper check
  // overrode the status, else the event's timestamp.
  const u32 ts_src = status != inner ? RC_TS_EVENT
                     : (e_found && inner == ts::exists) ? ts_exists
                     : inner == kCreated ? RC_TS_ACT
                                         : RC_TS_EVENT;

  // --- application (the twin's order) ---
  const bool created = status == kCreated && valid;
  const bool ap_pv = created && pv, ap_reg = created && !pv;
  const bool ap_pending = ap_reg && pending;
  const u64 f_ts = x.ts_act;
  bool rb_dr_closed, rb_cr_closed;
  if (!pv) {
    // dr and cr are distinct rows whenever the event is created.
    if (ap_pending) {
      h.acc[x.dr_idx].dp = dr.dp + f_amt;
      h.acc[x.cr_idx].cp = cr.cp + f_amt;
    }
    if (ap_reg && !pending) {
      h.acc[x.dr_idx].dpos = dr.dpos + f_amt;
      h.acc[x.cr_idx].cpos = cr.cpos + f_amt;
    }
    rb_dr_closed = dr.flags & A_CLOSED;
    rb_cr_closed = cr.flags & A_CLOSED;
    if (ap_reg && (f & F_CLOSE_DR)) h.acc[x.dr_idx].flags = dr.flags | A_CLOSED;
    if (ap_reg && (f & F_CLOSE_CR)) {
      h.acc[x.cr_idx].flags = h.acc[x.cr_idx].flags | A_CLOSED;
    }
  } else {
    rb_dr_closed = h.acc[s_dr].flags & A_CLOSED;
    rb_cr_closed = h.acc[s_cr].flags & A_CLOSED;
  }
  if (ap_pv) {
    // Post/void application (reference :4195-4283) and p's status flip
    // (:4233-4238).
    h.acc[s_dr].dp -= p.amt;
    h.acc[s_cr].cp -= p.amt;
    if (is_post) {
      h.acc[s_dr].dpos += f_amt;
      h.acc[s_cr].cpos += f_amt;
    }
    if (is_void && (p.flags & F_CLOSE_DR)) h.acc[s_dr].flags &= ~A_CLOSED;
    if (is_void && (p.flags & F_CLOSE_CR)) h.acc[s_cr].flags &= ~A_CLOSED;
    const u8 new_pstat = is_post ? PS_POSTED : PS_VOIDED;
    if (p_cache) {
      h.tpstat[pci] = new_pstat;
    } else {
      h.spstat[psl] = new_pstat;
      PvRow q;
      q.dr = p.dr;
      q.cr = p.cr;
      q.ud128 = x.ud128 == 0 ? p.ud128 : x.ud128;
      q.ud64 = x.ud64 == 0 ? p.ud64 : x.ud64;
      q.ud32 = static_cast<u32>(x.ud32 == 0 ? p.ud32 : x.ud32);
      q.ledger = static_cast<u32>(p.ledger);
      q.code = static_cast<u32>(p.code);
      h.pv[i] = q;
    }
  }

  // Insert the stored transfer into the batch store at `slot`: this
  // event becomes the slot's writer.
  if (created) {
    h.writer[slot] = static_cast<i32>(i);
    h.created[slot] = 1;
    h.spstat[slot] = ap_pending ? PS_PENDING : 0;
    if (slot == 0) c.amt0 = f_amt;
    if (f_ts > c.key_max) c.key_max = f_ts;
  }

  // Pulse scheduling (reference :3975-3981 add, :4227-4230 remove-reset).
  const u64 expires_new = f_ts + x.timeout_ns;
  if (ap_pending && x.timeout != 0 && expires_new < c.pulse_next) {
    c.pulse_next = expires_new;
  }
  if (ap_pv && p.timeout != 0 && c.pulse_next == p.expires) c.pulse_next = 1;

  // Undo log record.
  URow u;
  u.amt = f_amt;
  u.pamt = p.amt;
  u.kind = !created ? 0 : (is_post ? 3 : (is_void ? 4 : (pending ? 2 : 1)));
  u.dr_idx = s_dr;
  u.cr_idx = s_cr;
  u.p_idx = p_cache ? pci : psl;
  u.slot = slot;
  u.p_batch = !p_cache;
  u.dr_closed = rb_dr_closed;
  u.cr_closed = rb_cr_closed;
  h.undo[i] = u;

  // Orphan transient failures (reference transient_error :3215-3252).
  if (valid && transient(status)) h.orphaned[slot] = 1;
  h.rcode[i] = static_cast<u16>(
      ts_src | (status == kCreated ? kRcCreated : static_cast<u32>(status)));

  // --- chain break: roll back the applied prefix (reference :3116-3150) ---
  if (status != kCreated && chain_active && !c.chain_broken && valid) {
    const i64 start = c.chain_start > 0 ? c.chain_start : 0;
    for (i64 j = i - 1; j >= start; --j) rollback(h, j);
    c.key_max = c.chain_key_max;
    c.chain_broken = true;
  }
  // --- chain close (reference :3196-3207) ---
  if (chain_active && (!linked || status == ts::linked_event_chain_open)) {
    c.chain_start = -1;
    c.chain_broken = false;
  }
}

// Stage 3 whole: warp 0 walks while its lanes copy the records ahead.
__device__ __forceinline__ void walk(const View& v, const Hot& h,
                                     Rec* ring, i64 N) {
  using namespace ct;
  const int lane = static_cast<int>(threadIdx.x);
  const SeqArgs& a = v.a;
  Carry c;
  c.key_max = a.key_max;
  c.pulse_next = a.pulse_next;
  c.chain_key_max = 0;
  c.chain_start = -1;
  c.chain_broken = false;
  c.amt0 = 0;
  const i64 chunks = (N + kChunk - 1) / kChunk;
  constexpr int kPieces = sizeof(Rec) / 16;
  for (i64 k = 0; k <= chunks; ++k) {
    // Copy chunk k into its buffer, then walk chunk k - 1.
    if (k < chunks) {
      const i64 first = k * kChunk;
      const i64 cnt = N - first < kChunk ? N - first : kChunk;
      char* dst = reinterpret_cast<char*>(ring + (k & 1) * kChunk);
      const char* src = reinterpret_cast<const char*>(h.recs + first);
      for (i64 q = lane; q < cnt * kPieces; q += 32) {
        cp_async16(dst + 16 * q, src + 16 * q);
      }
    }
    cp_async_commit();
    if (k > 0 && lane == 0) {
      const i64 first = (k - 1) * kChunk;
      const i64 cnt = N - first < kChunk ? N - first : kChunk;
      const Rec* buf = ring + ((k - 1) & 1) * kChunk;
      for (i64 q = 0; q < cnt; ++q) walk_event(v, h, c, buf[q], first + q);
    }
    cp_async_wait_all();
    __syncwarp();
  }
  if (lane == 0) {
    v.u(ST_KEY_MAX)[0] = c.key_max;
    v.u(ST_PULSE_NEXT)[0] = c.pulse_next;
    v.u(ST_CHAIN_KEY_MAX)[0] = c.chain_key_max;
    v.s(ST_CHAIN_START)[0] = c.chain_start;
    v.b(ST_CHAIN_BROKEN)[0] = c.chain_broken;
  }
}

// Stages 1 and 4 over the hot region `h` (every thread).
__device__ __forceinline__ void stage(const View& v, const Hot& h, i64 N,
                                      i64 A, i64 T) {
  using namespace ct;
  const i64 tid = threadIdx.x, nt = blockDim.x;
  for (i64 k = tid; k < A; k += nt) {
    ARow r;
    r.dp = v.q(AC_DP_HI, AC_DP_LO, k);
    r.dpos = v.q(AC_DPOS_HI, AC_DPOS_LO, k);
    r.cp = v.q(AC_CP_HI, AC_CP_LO, k);
    r.cpos = v.q(AC_CPOS_HI, AC_CPOS_LO, k);
    r.flags = v.u(AC_FLAGS)[k];
    r.pad = 0;
    h.acc[k] = r;
  }
  for (i64 k = tid; k < T; k += nt) {
    h.tpstat[k] = static_cast<i32>(v.s(TC_PENDING_STATUS)[k]);
  }
  for (i64 k = tid; k < N; k += nt) {
    h.created[k] = 0;
    h.orphaned[k] = 0;
    h.spstat[k] = 0;
    h.writer[k] = -1;
  }
}

__device__ __forceinline__ void unstage(const View& v, const Hot& h, i64 N,
                                        i64 A, i64 T) {
  using namespace ct;
  const i64 tid = threadIdx.x, nt = blockDim.x;
  for (i64 k = tid; k < A; k += nt) {
    const ARow r = h.acc[k];
    v.set_q(ST_A_DP_HI, ST_A_DP_LO, k, r.dp);
    v.set_q(ST_A_DPOS_HI, ST_A_DPOS_LO, k, r.dpos);
    v.set_q(ST_A_CP_HI, ST_A_CP_LO, k, r.cp);
    v.set_q(ST_A_CPOS_HI, ST_A_CPOS_LO, k, r.cpos);
    v.u(ST_A_FLAGS)[k] = r.flags;
  }
  for (i64 k = tid; k < T; k += nt) v.s(ST_TC_PSTAT)[k] = h.tpstat[k];
  for (i64 k = tid; k < N; k += nt) {
    const Row s = batch_row(h, k);
    v.b(ST_S_CREATED)[k] = h.created[k];
    v.b(ST_S_ORPHANED)[k] = h.orphaned[k];
    v.set_q(ST_S_AMT_HI, ST_S_AMT_LO, k, s.amt);
    v.set_q(ST_S_DR_HI, ST_S_DR_LO, k, s.dr);
    v.set_q(ST_S_CR_HI, ST_S_CR_LO, k, s.cr);
    v.set_q(ST_S_PID_HI, ST_S_PID_LO, k, s.pid);
    v.set_q(ST_S_UD128_HI, ST_S_UD128_LO, k, s.ud128);
    v.u(ST_S_UD64)[k] = s.ud64;
    v.u(ST_S_UD32)[k] = s.ud32;
    v.u(ST_S_TIMEOUT)[k] = s.timeout;
    v.u(ST_S_LEDGER)[k] = s.ledger;
    v.u(ST_S_CODE)[k] = s.code;
    v.u(ST_S_FLAGS)[k] = s.flags;
    v.u(ST_S_TS)[k] = s.ts;
    v.s(ST_S_PSTAT)[k] = s.pstat;
    v.u(ST_S_EXPIRES)[k] = s.expires;
    v.s(ST_S_DR_IDX)[k] = s.dr_idx;
    v.s(ST_S_CR_IDX)[k] = s.cr_idx;
    const URow u = h.undo[k];
    v.s(ST_RB_KIND)[k] = u.kind;
    v.s(ST_RB_DR_IDX)[k] = u.dr_idx;
    v.s(ST_RB_CR_IDX)[k] = u.cr_idx;
    v.set_q(ST_RB_AMT_HI, ST_RB_AMT_LO, k, u.amt);
    v.set_q(ST_RB_PAMT_HI, ST_RB_PAMT_LO, k, u.pamt);
    v.s(ST_RB_P_IDX)[k] = u.p_idx;
    v.b(ST_RB_P_BATCH)[k] = u.p_batch;
    v.b(ST_RB_DR_CLOSED)[k] = u.dr_closed;
    v.b(ST_RB_CR_CLOSED)[k] = u.cr_closed;
    // Results: the walk's rcode and the record's timestamps.
    const Rec& x = h.recs[k];
    const u32 rc = h.rcode[k];
    const u32 st = rc & kRcStatus;
    if (!(x.bits & R_VALID)) {
      v.u(ST_R_TS)[k] = 0;
      v.u(ST_R_STATUS)[k] = 0;
      continue;
    }
    v.u(ST_R_STATUS)[k] = st == kRcCreated ? kCreated : st;
    const u32 src = rc & kRcTs;
    if (src != RC_TS_DIRECT) {
      v.u(ST_R_TS)[k] = src == RC_TS_ACT      ? x.ts_act
                        : src == RC_TS_EXISTS ? x.exists_ts
                                              : x.ts_event;
    }
  }
}

// One launch, one block: the four stages (see the note at the top).
__global__ void __launch_bounds__(kThreads, 1)
    create_transfers_seq_kernel(const __grid_constant__ SeqArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const View v{a};
  const i64 N = a.N, A = a.a_rows, T = a.t_rows;
  const Layout L = ct_layout(N, A, T);
  unsigned char* g = static_cast<unsigned char*>(a.scratch);
  Rec* ring = reinterpret_cast<Rec*>(smem);
  u64* stamps = static_cast<u64*>(a.stamps);
  const i64 tid = threadIdx.x, nt = blockDim.x;
  // The hot region's pointers, in shared memory when it fits: each branch
  // keeps its address space known to the compiler.
  const Hot hs = hot_at(smem + L.ring_bytes, g, L);
  const Hot hg = hot_at(g + L.hot, g, L);

  if (tid == 0) stamps[0] = now_ns();
  if (L.hot_in_smem) {
    stage(v, hs, N, A, T);
  } else {
    stage(v, hg, N, A, T);
  }
  __syncthreads();
  if (tid == 0) stamps[1] = now_ns();

  Rec* recs = reinterpret_cast<Rec*>(g + L.rec);
  for (i64 i = tid; i < N; i += nt) prepass(v, i, recs);
  __syncthreads();
  if (tid == 0) stamps[2] = now_ns();

  if (tid < 32) {
    if (L.hot_in_smem) {
      walk(v, hs, ring, N);
    } else {
      walk(v, hg, ring, N);
    }
  }
  __syncthreads();
  if (tid == 0) stamps[3] = now_ns();

  if (L.hot_in_smem) {
    unstage(v, hs, N, A, T);
  } else {
    unstage(v, hg, N, A, T);
  }
  __syncthreads();
  if (tid == 0) stamps[4] = now_ns();
}

// ============================================================ create_accounts

constexpr int kCaThreads = 512;

// What the walk reads of an event: the ring's unit. `code` packs the
// pre-pass's static statuses (wire codes, 0: none; CA_* offsets) and the
// event's bits (AW_*).
struct alignas(16) AWalk {
  u64 ts_act;  // ts_actual_created: the event's timestamp when imported
  i32 slot;    // the id's first lane: its batch-store row
  u32 code;
};
// s0: the first failing check before the exists check, else the exists
// status against the committed cache's row; post: the first failing
// check after it but for `regress` against the running key_max; ovr: the
// wrapper's timestamp and imported override that wins.
constexpr u32 CA_S0 = 0, CA_POST = 5, CA_OVR = 10, kCaCode = 31;
constexpr u32 AW_VALID = 1u << 15, AW_LINKED = 1u << 16,
              AW_IMPORTED = 1u << 17, AW_CHAIN_OPEN = 1u << 18;

// What an exists check against the batch store, and the unstage, read
// of an event: the fields a batch-store row holds.
struct alignas(16) ARec {
  u128 ud128;
  u64 ud64, ts_act, exists_ts;  // exists_ts: the committed row's
  u32 flags, ud32, ledger, code;
};

static_assert(sizeof(AWalk) == 16 && sizeof(ARec) == 64,
              "packed row sizes");

// A slot's word in the hot region: its last writer + 1 (0: none) and
// whether the batch store holds its row now. A chain's rollback clears
// the bit and keeps the writer, whose fields the row keeps (as the
// twin's does).
constexpr u32 kSwCreated = 1u << 31;

// The global scratch: walk records, then full records, then the hot
// region unless it is in shared memory. Shared memory: the walk ring
// (two buffers of kChunk), then the hot region when it fits. The hot
// region: a slot's word, a lane's slot (for a rollback) and rcode.
struct CaLayout {
  i64 walk, rec, hot;  // bytes into the scratch
  i64 sw, lslot, rcode;  // into hot
  i64 hot_bytes, ring_bytes, scratch_bytes, smem_bytes;
  bool hot_in_smem;
};

__host__ __device__ inline CaLayout ca_layout(i64 N) {
  CaLayout L;
  L.sw = 0;
  L.lslot = align16(N * 4);
  L.rcode = L.lslot + align16(N * 4);
  L.hot_bytes = L.rcode + align16(N * 2);
  L.ring_bytes = 2 * kChunk * i64{sizeof(AWalk)};
  L.hot_in_smem = L.ring_bytes + L.hot_bytes <= kSmemCap;
  L.smem_bytes = L.ring_bytes + (L.hot_in_smem ? L.hot_bytes : 0);
  L.walk = 0;
  L.rec = N * i64{sizeof(AWalk)};
  L.hot = L.rec + N * i64{sizeof(ARec)};
  L.scratch_bytes = L.hot + (L.hot_in_smem ? 0 : L.hot_bytes);
  return L;
}

struct CaHot {
  u32* sw;
  i32* lslot;
  u16* rcode;
  const AWalk* walk;
  const ARec* recs;
};

__device__ __forceinline__ CaHot ca_hot_at(unsigned char* hot,
                                           unsigned char* g,
                                           const CaLayout& L) {
  CaHot h;
  h.sw = reinterpret_cast<u32*>(hot + L.sw);
  h.lslot = reinterpret_cast<i32*>(hot + L.lslot);
  h.rcode = reinterpret_cast<u16*>(hot + L.rcode);
  h.walk = reinterpret_cast<const AWalk*>(g + L.walk);
  h.recs = reinterpret_cast<const ARec*>(g + L.rec);
  return h;
}

// create_account_exists (reference :3691-3703; the twin's _ca_exists).
__device__ __forceinline__ u64 ca_exists(const ARec& x, const ARec& e) {
  u64 s = kCreated;
  CHECK(s, (x.flags & 0xFFFF) != (e.flags & 0xFFFF),
        as::exists_with_different_flags);
  CHECK(s, x.ud128 != e.ud128, as::exists_with_different_user_data_128);
  CHECK(s, x.ud64 != e.ud64, as::exists_with_different_user_data_64);
  CHECK(s, x.ud32 != e.ud32, as::exists_with_different_user_data_32);
  CHECK(s, x.ledger != e.ledger, as::exists_with_different_ledger);
  CHECK(s, x.code != e.code, as::exists_with_different_code);
  return s == kCreated ? as::exists : s;
}

// Stage 2, lane i (the twin's _ca_prepass on one lane).
__device__ void ca_prepass(const View& v, i64 i, AWalk* wout, ARec* rout,
                           i32* lslot) {
  using namespace ca;
  const SeqArgs& a = v.a;
  const u64 flags = v.u(EV_FLAGS)[i];
  const bool linked = flags & A_LINKED, imported = flags & A_IMPORTED;
  const u64 ts = v.u(EV_TS)[i];
  const u64 ts_event = a.timestamp - static_cast<u64>(a.n) +
                       static_cast<u64>(i) + 1;
  const u128 id = v.q(EV_ID_HI, EV_ID_LO, i);
  const i64 slot = v.s(EV_SLOT)[i];
  const i64 ei = v.s(EV_EXISTS_IDX)[i];
  const u64 ledger = v.u(EV_LEDGER)[i], code = v.u(EV_CODE)[i];
  ARec r;
  r.ud128 = v.q(EV_UD128_HI, EV_UD128_LO, i);
  r.ud64 = v.u(EV_UD64)[i];
  r.ud32 = static_cast<u32>(v.u(EV_UD32)[i]);
  r.ledger = static_cast<u32>(ledger);
  r.code = static_cast<u32>(code);
  r.flags = static_cast<u32>(flags);
  r.ts_act = imported ? ts : ts_event;
  r.exists_ts = 0;

  // create_account (reference :3613-3689), split at the exists check.
  u64 s0 = kCreated;
  CHECK(s0, v.u(EV_RESERVED)[i] != 0, as::reserved_field);
  CHECK(s0, flags & AF_PADDING, as::reserved_flag);
  CHECK(s0, id == 0, as::id_must_not_be_zero);
  CHECK(s0, id == kU128Max, as::id_must_not_be_int_max);
  if (s0 == kCreated && ei >= 0) {
    ARec e;
    e.ud128 = v.q(AC_UD128_HI, AC_UD128_LO, ei);
    e.ud64 = v.u(AC_UD64)[ei];
    e.ud32 = static_cast<u32>(v.u(AC_UD32)[ei]);
    e.ledger = static_cast<u32>(v.u(AC_LEDGER)[ei]);
    e.code = static_cast<u32>(v.u(AC_CODE)[ei]);
    e.flags = static_cast<u32>(v.u(AC_FLAGS)[ei]);
    s0 = ca_exists(r, e);
    r.exists_ts = v.u(AC_TS)[ei];
  }
  u64 post = kCreated;
  CHECK(post, (flags & A_DR_LIMIT) && (flags & A_CR_LIMIT),
        as::flags_are_mutually_exclusive);
  CHECK(post, v.q(EV_DP_HI, EV_DP_LO, i) != 0,
        as::debits_pending_must_be_zero);
  CHECK(post, v.q(EV_DPOS_HI, EV_DPOS_LO, i) != 0,
        as::debits_posted_must_be_zero);
  CHECK(post, v.q(EV_CP_HI, EV_CP_LO, i) != 0,
        as::credits_pending_must_be_zero);
  CHECK(post, v.q(EV_CPOS_HI, EV_CPOS_LO, i) != 0,
        as::credits_posted_must_be_zero);
  CHECK(post, ledger == 0, as::ledger_must_not_be_zero);
  CHECK(post, code == 0, as::code_must_not_be_zero);
  CHECK(post, imported && v.b(EV_TRANSFER_TS_COLLISION)[i],
        as::imported_event_timestamp_must_not_regress);

  // The wrapper's overrides (reference execute_create :3033-3104) but
  // for the chain's two; a later one wins.
  const bool ts_valid = ts >= 1 && ts <= kU63Max;
  const bool batch_imported = (v.u(EV_FLAGS)[0] & A_IMPORTED) && a.n > 0;
  u64 ovr = 0;
  if (!imported && ts != 0) ovr = as::timestamp_must_be_zero;
  if (imported && ts_valid && ts >= a.timestamp) {
    ovr = as::imported_event_timestamp_must_not_advance;
  }
  if (imported && !ts_valid) ovr = as::imported_event_timestamp_out_of_range;
  if (imported != batch_imported) {
    ovr = imported ? as::imported_event_not_expected
                   : as::imported_event_expected;
  }

  u32 w = (s0 == kCreated ? 0u : static_cast<u32>(s0)) << CA_S0 |
          (post == kCreated ? 0u : static_cast<u32>(post)) << CA_POST |
          static_cast<u32>(ovr) << CA_OVR;
  if (v.b(EV_VALID)[i]) w |= AW_VALID;
  if (linked) w |= AW_LINKED;
  if (imported) w |= AW_IMPORTED;
  if (linked && i == a.n - 1) w |= AW_CHAIN_OPEN;
  AWalk x;
  x.ts_act = r.ts_act;
  x.slot = static_cast<i32>(slot);
  x.code = w;
  wout[i] = x;
  rout[i] = r;
  lslot[i] = static_cast<i32>(slot);
}

// The walk's carry, the same in every lane of warp 0.
struct CaCarry {
  u64 key_max, chain_key_max;
  i64 chain_start;
  bool chain_broken;
};

// Event i's inner status but for `regress` against key_max: the
// pre-pass's, or the exists status against the batch store's row (then
// *e_ts is that row's timestamp and *from_batch set). Only an earlier
// event of the batch can have written the row of an event's slot (the
// id's first lane).
__device__ __forceinline__ u64 ca_base(const CaHot& h, const AWalk& x,
                                       i64 i, u64* e_ts, bool* from_batch) {
  *from_batch = false;
  const u32 s0 = (x.code >> CA_S0) & kCaCode;
  if (s0) return s0;
  if (x.slot != i) {
    const u32 sw = h.sw[x.slot];
    if (sw & kSwCreated) {
      const ARec& e = h.recs[(sw & ~kSwCreated) - 1];
      *e_ts = e.ts_act;
      *from_batch = true;
      return ca_exists(h.recs[i], e);
    }
  }
  const u32 post = (x.code >> CA_POST) & kCaCode;
  return post ? post : kCreated;
}

__device__ __forceinline__ u64 ca_regressed(const AWalk& x, u64 inner,
                                            u64 key_max) {
  return inner == kCreated && (x.code & AW_IMPORTED) && key_max != 0 &&
                 x.ts_act <= key_max
             ? as::imported_event_timestamp_must_not_regress
             : inner;
}

// Event i's result and its creation: the rcode and, when it is
// created, the slot's word.
__device__ __forceinline__ void ca_finish(const View& v, const CaHot& h,
                                          const AWalk& x, i64 i, u64 inner,
                                          u64 status, u64 e_ts,
                                          bool from_batch) {
  if (!(x.code & AW_VALID)) return;
  u32 src = RC_TS_EVENT;
  if (status == inner && inner == as::exists) {
    if (from_batch) {
      v.u(ca::ST_R_TS)[i] = e_ts;
      src = RC_TS_DIRECT;
    } else {
      src = RC_TS_EXISTS;
    }
  } else if (status == inner && inner == kCreated) {
    src = RC_TS_ACT;
  }
  h.rcode[i] = static_cast<u16>(
      src | (status == kCreated ? kRcCreated : static_cast<u32>(status)));
  if (status == kCreated) {
    h.sw[x.slot] = static_cast<u32>(i + 1) | kSwCreated;
  }
}

// Stage 3, event i one at a time (the twin's `_ca_walk` loop body; lane
// 0).
__device__ __forceinline__ void ca_walk_event(const View& v, const CaHot& h,
                                              CaCarry& c, const AWalk x,
                                              i64 i) {
  const bool valid = x.code & AW_VALID, linked = x.code & AW_LINKED;
  // --- chain open (reference :3033-3043) ---
  bool chain_active = c.chain_start >= 0;
  if (linked && !chain_active && valid) {
    c.chain_start = i;
    c.chain_key_max = c.key_max;
    chain_active = true;
  }
  u64 e_ts = 0;
  bool from_batch;
  const u64 inner = ca_regressed(x, ca_base(h, x, i, &e_ts, &from_batch),
                                 c.key_max);
  // --- wrapper checks (reference execute_create :3033-3104) ---
  const u32 ovr = (x.code >> CA_OVR) & kCaCode;
  u64 status = ovr ? ovr : inner;
  if (c.chain_broken) status = as::linked_event_failed;
  if (x.code & AW_CHAIN_OPEN) status = as::linked_event_chain_open;
  ca_finish(v, h, x, i, inner, status, e_ts, from_batch);
  if (status == kCreated && valid && x.ts_act > c.key_max) {
    c.key_max = x.ts_act;
  }
  // --- chain break: roll back the chain's prefix (reference
  // :3116-3150) ---
  if (status != kCreated && chain_active && !c.chain_broken && valid) {
    for (i64 j = c.chain_start > 0 ? c.chain_start : 0; j < i; ++j) {
      h.sw[h.lslot[j]] &= ~kSwCreated;
      h.rcode[j] = static_cast<u16>((h.rcode[j] & kRcTs) |
                                    as::linked_event_failed);
    }
    c.key_max = c.chain_key_max;
    c.chain_broken = true;
  }
  // --- chain close (reference :3196-3207) ---
  if (chain_active && (!linked || status == as::linked_event_chain_open)) {
    c.chain_start = -1;
    c.chain_broken = false;
  }
}

// Stage 3, a chunk of `cnt` events from `first` whose lanes depend on
// one another through key_max alone, in one warp step: lane t takes event
// first + t. A lane that fails a check other than `regress` creates
// nothing, and one that fails only `regress` has a timestamp at or below
// key_max; so key_max before a lane is the max of key_max before the
// chunk and the ts_act of each earlier lane that fails nothing but
// perhaps `regress` (an inclusive max scan over the warp), as the twin's
// event-by-event walk finds it.
__device__ __forceinline__ void ca_walk_chunk(const View& v, const CaHot& h,
                                              CaCarry& c, const AWalk& x,
                                              i64 first, int cnt,
                                              int lane) {
  const bool have = lane < cnt;
  const i64 i = first + lane;
  u64 e_ts = 0, inner = kCreated;
  bool from_batch = false;
  if (have) inner = ca_base(h, x, i, &e_ts, &from_batch);
  const u32 ovr = (x.code >> CA_OVR) & kCaCode;
  const bool ok = have && (x.code & AW_VALID) && inner == kCreated && !ovr;
  u64 incl = ok ? x.ts_act : 0;
  for (int d = 1; d < 32; d <<= 1) {
    const u64 t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d && t > incl) incl = t;
  }
  u64 before = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
  if (lane == 0 || before < c.key_max) before = c.key_max;
  const u64 last = __shfl_sync(0xFFFFFFFFu, incl, 31);
  if (have) {
    inner = ca_regressed(x, inner, before);
    ca_finish(v, h, x, i, inner, ovr ? ovr : inner, e_ts, from_batch);
  }
  if (last > c.key_max) c.key_max = last;
}

// Stage 3 whole: warp 0 walks while its lanes copy the records ahead.
__device__ __forceinline__ void ca_walk(const View& v, const CaHot& h,
                                        AWalk* ring, i64 N) {
  using namespace ca;
  const int lane = static_cast<int>(threadIdx.x);
  CaCarry c;
  c.key_max = v.a.key_max;
  c.chain_key_max = 0;
  c.chain_start = -1;
  c.chain_broken = false;
  const i64 chunks = (N + kChunk - 1) / kChunk;
  for (i64 k = 0; k <= chunks; ++k) {
    // Copy chunk k into its buffer, then walk chunk k - 1.
    if (k < chunks) {
      const i64 first = k * kChunk;
      if (first + lane < N) {
        cp_async16(ring + (k & 1) * kChunk + lane, h.walk + first + lane);
      }
    }
    cp_async_commit();
    if (k > 0) {
      const i64 first = (k - 1) * kChunk;
      const int cnt = static_cast<int>(N - first < kChunk ? N - first
                                                          : kChunk);
      const AWalk* buf = ring + ((k - 1) & 1) * kChunk;
      AWalk x;
      if (lane < cnt) {
        x = buf[lane];
      } else {
        x.ts_act = 0;
        x.slot = -1;
        x.code = 0;
      }
      // The chunk is one warp step when no chain is open, no valid event
      // is linked and no slot is shared by two undecided lanes (which
      // alone read or write the batch store).
      const bool dyn = lane < cnt && ((x.code >> CA_S0) & kCaCode) == 0;
      const unsigned peers =
          __match_any_sync(0xFFFFFFFFu, dyn ? x.slot : -1 - lane);
      const bool stop = (dyn && __popc(peers) > 1) ||
                        ((x.code & AW_VALID) && (x.code & AW_LINKED));
      if (c.chain_start < 0 && !__any_sync(0xFFFFFFFFu, stop)) {
        ca_walk_chunk(v, h, c, x, first, cnt, lane);
      } else {
        if (lane == 0) {
          // Each record is read before the previous event's stores, which
          // the compiler cannot tell apart from the ring.
          AWalk next = buf[0];
          for (int q = 0; q < cnt; ++q) {
            const AWalk cur = next;
            if (q + 1 < cnt) next = buf[q + 1];
            ca_walk_event(v, h, c, cur, first + q);
          }
        }
        c.key_max = __shfl_sync(0xFFFFFFFFu, c.key_max, 0);
        c.chain_key_max = __shfl_sync(0xFFFFFFFFu, c.chain_key_max, 0);
        c.chain_start = __shfl_sync(0xFFFFFFFFu, c.chain_start, 0);
        c.chain_broken = __shfl_sync(0xFFFFFFFFu, c.chain_broken, 0);
      }
    }
    cp_async_wait_all();
    __syncwarp();
  }
  if (lane == 0) {
    v.u(ST_KEY_MAX)[0] = c.key_max;
    v.u(ST_CHAIN_KEY_MAX)[0] = c.chain_key_max;
    v.s(ST_CHAIN_START)[0] = c.chain_start;
    v.b(ST_CHAIN_BROKEN)[0] = c.chain_broken;
  }
}

// Stage 1 over the hot region (every thread).
__device__ __forceinline__ void ca_stage(const CaHot& h, i64 N) {
  for (i64 k = threadIdx.x; k < N; k += blockDim.x) {
    h.sw[k] = 0;
    h.rcode[k] = 0;
  }
}

// Stage 4 (every thread): each slot's batch-store row rebuilt from its
// last writer's record, and each lane's result.
__device__ __forceinline__ void ca_unstage(const View& v, const CaHot& h,
                                           i64 N) {
  using namespace ca;
  const SeqArgs& a = v.a;
  for (i64 k = threadIdx.x; k < N; k += blockDim.x) {
    const u32 sw = h.sw[k];
    v.b(ST_S_CREATED)[k] = (sw & kSwCreated) != 0;
    ARec e = ARec{};
    if (sw & ~kSwCreated) e = h.recs[(sw & ~kSwCreated) - 1];
    v.set_q(ST_S_UD128_HI, ST_S_UD128_LO, k, e.ud128);
    v.u(ST_S_UD64)[k] = e.ud64;
    v.u(ST_S_UD32)[k] = e.ud32;
    v.u(ST_S_LEDGER)[k] = e.ledger;
    v.u(ST_S_CODE)[k] = e.code;
    v.u(ST_S_FLAGS)[k] = e.flags;
    v.u(ST_S_TS)[k] = e.ts_act;
    // Results: the walk's rcode and the lane's timestamps.
    const u32 rc = h.rcode[k];
    const u32 st = rc & kRcStatus;
    v.u(ST_R_STATUS)[k] = st == kRcCreated ? kCreated : st;
    if (!(h.walk[k].code & AW_VALID)) {
      v.u(ST_R_TS)[k] = 0;
      continue;
    }
    const u32 src = rc & kRcTs;
    if (src != RC_TS_DIRECT) {
      v.u(ST_R_TS)[k] =
          src == RC_TS_ACT      ? h.recs[k].ts_act
          : src == RC_TS_EXISTS ? h.recs[k].exists_ts
                                : a.timestamp - static_cast<u64>(a.n) +
                                      static_cast<u64>(k) + 1;
    }
  }
}

// One launch, one block: the four stages (see the note at the top).
__global__ void __launch_bounds__(kCaThreads, 1)
    create_accounts_seq_kernel(const __grid_constant__ SeqArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const View v{a};
  const i64 N = a.N;
  const CaLayout L = ca_layout(N);
  unsigned char* g = static_cast<unsigned char*>(a.scratch);
  AWalk* ring = reinterpret_cast<AWalk*>(smem);
  u64* stamps = static_cast<u64*>(a.stamps);
  const i64 tid = threadIdx.x, nt = blockDim.x;
  // The hot region's pointers, in shared memory when it fits: each branch
  // keeps its address space known to the compiler.
  const CaHot hs = ca_hot_at(smem + L.ring_bytes, g, L);
  const CaHot hg = ca_hot_at(g + L.hot, g, L);

  if (tid == 0) stamps[0] = now_ns();
  if (L.hot_in_smem) {
    ca_stage(hs, N);
  } else {
    ca_stage(hg, N);
  }
  __syncthreads();
  if (tid == 0) stamps[1] = now_ns();

  AWalk* walk = reinterpret_cast<AWalk*>(g + L.walk);
  ARec* recs = reinterpret_cast<ARec*>(g + L.rec);
  if (L.hot_in_smem) {
    for (i64 i = tid; i < N; i += nt) ca_prepass(v, i, walk, recs, hs.lslot);
  } else {
    for (i64 i = tid; i < N; i += nt) ca_prepass(v, i, walk, recs, hg.lslot);
  }
  __syncthreads();
  if (tid == 0) stamps[2] = now_ns();

  if (tid < 32) {
    if (L.hot_in_smem) {
      ca_walk(v, hs, ring, N);
    } else {
      ca_walk(v, hg, ring, N);
    }
  }
  __syncthreads();
  if (tid == 0) stamps[3] = now_ns();

  if (L.hot_in_smem) {
    ca_unstage(v, hs, N);
  } else {
    ca_unstage(v, hg, N);
  }
  __syncthreads();
  if (tid == 0) stamps[4] = now_ns();
}


bool args_ok(const SeqArgs* args, int n_seg) {
  return n_seg == 1 && args->N >= 0 && args->n >= 0 && args->n <= args->N;
}

}  // namespace

// C entry points (bound with ctypes): one batch (n_seg must be 1), one
// launch on `stream`; no synchronisation. Each launch returns
// cudaGetLastError() of its launch (a refused shared-memory size
// included).

// Bytes of global scratch the create_transfers launch of `args` needs.
extern "C" long long create_transfers_seq_scratch(const SeqArgs* args) {
  return ct_layout(args->N, args->a_rows, args->t_rows).scratch_bytes;
}

extern "C" int create_transfers_seq_launch(const SeqArgs* args, int n_seg,
                                           void* stream) {
  if (!args_ok(args, n_seg) || args->N < 1 || args->a_rows < 1 ||
      args->t_rows < 1 || args->scratch == nullptr ||
      args->stamps == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L = ct_layout(args->N, args->a_rows, args->t_rows);
  const cudaError_t rc = cudaFuncSetAttribute(
      create_transfers_seq_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.smem_bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  create_transfers_seq_kernel<<<1, kThreads, L.smem_bytes,
                                static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of global scratch the create_accounts launch of `args` needs.
extern "C" long long create_accounts_seq_scratch(const SeqArgs* args) {
  return ca_layout(args->N).scratch_bytes;
}

extern "C" int create_accounts_seq_launch(const SeqArgs* args, int n_seg,
                                          void* stream) {
  if (!args_ok(args, n_seg) || args->N < 1 || args->scratch == nullptr ||
      args->stamps == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const CaLayout L = ca_layout(args->N);
  const cudaError_t rc = cudaFuncSetAttribute(
      create_accounts_seq_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.smem_bytes));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  create_accounts_seq_kernel<<<1, kCaThreads, L.smem_bytes,
                               static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
