// The sequential create_transfers / create_accounts kernels for Hopper
// (sm_90a): one thread walks a batch in event order.
//
// No Pallas counterpart: these are the JAX package's XLA kernels
// `create_transfers_kernel` (tigerbeetle_tpu/ops/create_kernels.py:664, a
// lax.fori_loop of `_ct_body` :282-662) and `create_accounts_kernel`
// (:792, a loop of `_ca_body` :676-790), the exact device path whose
// results the oracle pins. Each computes, bit for bit, what its plain
// PyTorch twin in tigerbeetle_tpu_torch/ops/create_kernels.py computes
// (`create_transfers_seq_plain` / `create_accounts_seq_plain`): the same
// checks in the same order (the first failing check wins), the same
// masked application, the same undo log and LIFO chain rollback, over
// the caches the host prefetched (ops/batch.py). Every padded lane of the
// batch is walked too, as the JAX loop walks them, so every output array
// (the undo log included) equals the twin's.
//
// Data: every array is a PyTorch tensor handed over by pointer. u64
// lanes are int64 tensors read here as uint64_t (unsigned compares,
// wrapping arithmetic); u32 and i32 lanes are int64 tensors holding the
// widened value; bool lanes are bool tensors. Balances are u128 as
// (hi, lo) limb pairs, combined here into unsigned __int128. The carry
// (mutable account cache, batch store s_*, committed pending statuses,
// undo log rb_*, scalars, results) is initialised by the wrapper
// (ops/create_seq.py, `_ct_init_state`) and updated in place.
//
// What bounds it: one thread and the chain of dependent loads through
// an event (event fields -> cache indexes -> cache rows -> the checks ->
// the masked writes), not bytes: an 8,190-event batch reads and writes
// ~3.9 MB (~1.2 us at 3.35 TB/s), but each event waits on that chain of
// global-memory round trips, mostly L2 hits once the caches are warm
// (chip_smoke.py on an H100 80GB HBM3 at 700 W: ~18 ms a config-3 batch,
// ~2.2 us an event; PERF.md). Being right is this kernel's bar; later
// designs: a warp that loads an event's fields in parallel, or the hot
// account rows in shared memory.
//
// Argument block: `SeqArgs.p` holds the tensors' pointers in the order of
// the `Ptr` enums below (ops/create_seq.py `CT_PTRS` / `CA_PTRS` list the
// same names; tests/test_torch_create_kernels.py checks the two agree),
// passed by value as a __grid_constant__ parameter.

#include <cuda_runtime.h>
#include <stdint.h>

typedef uint64_t u64;
typedef int64_t i64;
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

// A stored transfer, from the committed cache or the batch store.
struct Row {
  u128 amt, dr, cr, pid, ud128;
  u64 ud64, ud32, timeout, ledger, code, flags, ts, expires;
  i64 dr_idx, cr_idx, pstat;
};

__device__ Row transfer_row(const View& v, bool from_cache, i64 cache_idx,
                            i64 slot) {
  using namespace ct;
  const i64 c = cache_idx > 0 ? cache_idx : 0;
  const i64 s = slot > 0 ? slot : 0;
  Row r;
  if (from_cache) {
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
    r.pstat = v.s(ST_TC_PSTAT)[c];
  } else {
    r.amt = v.q(ST_S_AMT_HI, ST_S_AMT_LO, s);
    r.dr = v.q(ST_S_DR_HI, ST_S_DR_LO, s);
    r.cr = v.q(ST_S_CR_HI, ST_S_CR_LO, s);
    r.pid = v.q(ST_S_PID_HI, ST_S_PID_LO, s);
    r.ud128 = v.q(ST_S_UD128_HI, ST_S_UD128_LO, s);
    r.ud64 = v.u(ST_S_UD64)[s];
    r.ud32 = v.u(ST_S_UD32)[s];
    r.timeout = v.u(ST_S_TIMEOUT)[s];
    r.ledger = v.u(ST_S_LEDGER)[s];
    r.code = v.u(ST_S_CODE)[s];
    r.flags = v.u(ST_S_FLAGS)[s];
    r.ts = v.u(ST_S_TS)[s];
    r.expires = v.u(ST_S_EXPIRES)[s];
    r.dr_idx = v.s(ST_S_DR_IDX)[s];
    r.cr_idx = v.s(ST_S_CR_IDX)[s];
    r.pstat = v.s(ST_S_PSTAT)[s];
  }
  return r;
}

// One account-cache row as it stands now.
struct Acct {
  bool exists;
  u128 dp, dpos, cp, cpos;
  u64 flags, ledger, ts;
};

__device__ Acct acct_row(const View& v, i64 idx) {
  using namespace ct;
  Acct r;
  r.exists = v.b(AC_EXISTS)[idx];
  r.dp = v.q(ST_A_DP_HI, ST_A_DP_LO, idx);
  r.dpos = v.q(ST_A_DPOS_HI, ST_A_DPOS_LO, idx);
  r.cp = v.q(ST_A_CP_HI, ST_A_CP_LO, idx);
  r.cpos = v.q(ST_A_CPOS_HI, ST_A_CPOS_LO, idx);
  r.flags = v.u(ST_A_FLAGS)[idx];
  r.ledger = v.u(AC_LEDGER)[idx];
  r.ts = v.u(AC_TS)[idx];
  return r;
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

__device__ __forceinline__ void add_at(const View& v, int hi, int lo, i64 i,
                                       u128 d) {
  v.set_q(hi, lo, i, v.q(hi, lo, i) + d);
}
__device__ __forceinline__ void sub_at(const View& v, int hi, int lo, i64 i,
                                       u128 d) {
  v.set_q(hi, lo, i, v.q(hi, lo, i) - d);
}

// Undo chain member j (the plain twin's _ct_rollback): balance deltas
// back out; closed bits and pending statuses return to their pre-event
// snapshots, which is why members unwind newest-first.
__device__ void ct_rollback(const View& v, i64 j) {
  using namespace ct;
  const i64 kind = v.s(ST_RB_KIND)[j];
  const bool applied = kind > 0;
  const u128 amt = v.q(ST_RB_AMT_HI, ST_RB_AMT_LO, j);
  const u128 pamt = v.q(ST_RB_PAMT_HI, ST_RB_PAMT_LO, j);
  const i64 dri = v.s(ST_RB_DR_IDX)[j], cri = v.s(ST_RB_CR_IDX)[j];
  const bool was_pv = applied && (kind == 3 || kind == 4);
  if (applied && (kind == 1 || kind == 3)) {
    sub_at(v, ST_A_DPOS_HI, ST_A_DPOS_LO, dri, amt);
    sub_at(v, ST_A_CPOS_HI, ST_A_CPOS_LO, cri, amt);
  }
  if (applied && kind == 2) {
    sub_at(v, ST_A_DP_HI, ST_A_DP_LO, dri, amt);
    sub_at(v, ST_A_CP_HI, ST_A_CP_LO, cri, amt);
  }
  if (was_pv) {
    add_at(v, ST_A_DP_HI, ST_A_DP_LO, dri, pamt);
    add_at(v, ST_A_CP_HI, ST_A_CP_LO, cri, pamt);
  }
  if (applied) {
    u64* fl = v.u(ST_A_FLAGS);
    fl[dri] = v.b(ST_RB_DR_CLOSED)[j] ? (fl[dri] | A_CLOSED)
                                      : (fl[dri] & ~A_CLOSED);
    fl[cri] = v.b(ST_RB_CR_CLOSED)[j] ? (fl[cri] | A_CLOSED)
                                      : (fl[cri] & ~A_CLOSED);
  }
  const i64 p_idx = v.s(ST_RB_P_IDX)[j];
  const bool p_batch = v.b(ST_RB_P_BATCH)[j];
  if (was_pv && !p_batch) v.s(ST_TC_PSTAT)[p_idx] = PS_PENDING;
  if (was_pv && p_batch) v.s(ST_S_PSTAT)[p_idx] = PS_PENDING;
  if (applied) v.b(ST_S_CREATED)[v.s(EV_SLOT)[j]] = false;
  v.s(ST_RB_KIND)[j] = 0;
  v.u(ST_R_STATUS)[j] = ts::linked_event_failed;
}

// Event i of a create_transfers batch (the plain twin's _ct_body).
__device__ void ct_body(const View& v, i64 i) {
  using namespace ct;
  const SeqArgs& a = v.a;
  const u64 timestamp = a.timestamp;
  const u64 ts_event = timestamp - static_cast<u64>(a.n) +
                       static_cast<u64>(i) + 1;
  const bool valid = v.b(EV_VALID)[i];
  const u64 flags = v.u(EV_FLAGS)[i];
  const bool linked = flags & F_LINKED, imported = flags & F_IMPORTED;
  const bool is_post = flags & F_POST, is_void = flags & F_VOID;
  const bool pv = is_post || is_void, pending = flags & F_PENDING;
  const bool batch_imported = (v.u(EV_FLAGS)[0] & F_IMPORTED) && a.n > 0;

  const u128 id = v.q(EV_ID_HI, EV_ID_LO, i);
  const u128 ev_dr = v.q(EV_DR_HI, EV_DR_LO, i);
  const u128 ev_cr = v.q(EV_CR_HI, EV_CR_LO, i);
  const u128 ev_amt = v.q(EV_AMT_HI, EV_AMT_LO, i);
  const u128 ev_pid = v.q(EV_PID_HI, EV_PID_LO, i);
  const u128 ev_ud128 = v.q(EV_UD128_HI, EV_UD128_LO, i);
  const u64 ev_ud64 = v.u(EV_UD64)[i], ev_ud32 = v.u(EV_UD32)[i];
  const u64 ev_timeout = v.u(EV_TIMEOUT)[i];
  const u64 ev_ledger = v.u(EV_LEDGER)[i], ev_code = v.u(EV_CODE)[i];
  const u64 ev_ts = v.u(EV_TS)[i];

  i64* chain_start = v.s(ST_CHAIN_START);
  u64* key_max = v.u(ST_KEY_MAX);
  u64* pulse_next = v.u(ST_PULSE_NEXT);
  bool* chain_broken = v.b(ST_CHAIN_BROKEN);

  // --- chain open (reference :3033-3043) ---
  bool chain_active = *chain_start >= 0;
  const bool opening = linked && !chain_active && valid;
  if (opening) {
    *chain_start = i;
    *v.u(ST_CHAIN_KEY_MAX) = *key_max;
  }
  chain_active = chain_active || opening;

  // --- transfer lookup: committed cache / orphan / batch store ---
  const i64 slot = v.s(EV_SLOT)[i];
  const i64 exists_idx = v.s(EV_EXISTS_IDX)[i];
  const bool e_from_cache = exists_idx >= 0;
  const bool e_from_batch = !e_from_cache && v.b(ST_S_CREATED)[slot];
  const bool e_found = e_from_cache || e_from_batch;
  const bool orphan = v.b(EV_ORPHANED)[i] || v.b(ST_S_ORPHANED)[slot];
  const Row e = transfer_row(v, e_from_cache, exists_idx, slot);

  // --- pending transfer lookup ---
  const i64 pci_raw = v.s(EV_PENDING_CACHE_IDX)[i];
  const i64 psl_raw = v.s(EV_PENDING_SLOT)[i];
  const i64 pci = pci_raw > 0 ? pci_raw : 0;
  const i64 psl = psl_raw > 0 ? psl_raw : 0;
  const bool p_from_cache = pci_raw >= 0;
  const bool p_from_batch =
      !p_from_cache && psl_raw >= 0 && v.b(ST_S_CREATED)[psl];
  const bool p_found = p_from_cache || p_from_batch;
  const Row p = transfer_row(v, p_from_cache, pci_raw, psl_raw);
  const Acct p_dr = acct_row(v, p.dr_idx);
  const Acct p_cr = acct_row(v, p.cr_idx);
  const i64 dr_idx = v.s(EV_DR_IDX)[i], cr_idx = v.s(EV_CR_IDX)[i];
  const Acct dr = acct_row(v, dr_idx);
  const Acct cr = acct_row(v, cr_idx);

  // --- exists (reference :3988-4051, 4301-4382) ---
  u64 exists_status = kCreated;
  {
    const bool balancing = flags & (F_BAL_DR | F_BAL_CR);
    const bool amt_ne_e = ev_amt != e.amt;
    const bool eamt_ne_pamt = e.amt != p.amt;
    const bool amt_diff_regular = balancing ? ev_amt < e.amt : amt_ne_e;
    const bool amt_diff_pv =
        is_void ? (ev_amt == 0 ? eamt_ne_pamt : amt_ne_e)
                : (ev_amt == kU128Max ? eamt_ne_pamt : amt_ne_e);
    auto ud_diff = [&](u64 t, u64 ex, u64 pp) {
      return pv ? (t == 0 ? ex != pp : t != ex) : t != ex;
    };
    const bool ud128_diff =
        pv ? (ev_ud128 == 0 ? e.ud128 != p.ud128 : ev_ud128 != e.ud128)
           : ev_ud128 != e.ud128;
    const bool dr_diff = pv ? (ev_dr != 0 && ev_dr != e.dr) : ev_dr != e.dr;
    const bool cr_diff = pv ? (ev_cr != 0 && ev_cr != e.cr) : ev_cr != e.cr;
    const bool ledger_diff =
        pv ? (ev_ledger != 0 && ev_ledger != e.ledger) : ev_ledger != e.ledger;
    const bool code_diff =
        pv ? (ev_code != 0 && ev_code != e.code) : ev_code != e.code;
    u64& s = exists_status;
    CHECK(s, (flags & 0xFFFF) != (e.flags & 0xFFFF),
          ts::exists_with_different_flags);
    CHECK(s, ev_pid != e.pid, ts::exists_with_different_pending_id);
    CHECK(s, ev_timeout != e.timeout, ts::exists_with_different_timeout);
    CHECK(s, dr_diff, ts::exists_with_different_debit_account_id);
    CHECK(s, cr_diff, ts::exists_with_different_credit_account_id);
    CHECK(s, pv ? amt_diff_pv : amt_diff_regular,
          ts::exists_with_different_amount);
    CHECK(s, ud128_diff, ts::exists_with_different_user_data_128);
    CHECK(s, ud_diff(ev_ud64, e.ud64, p.ud64),
          ts::exists_with_different_user_data_64);
    CHECK(s, ud_diff(ev_ud32, e.ud32, p.ud32),
          ts::exists_with_different_user_data_32);
    CHECK(s, ledger_diff, ts::exists_with_different_ledger);
    CHECK(s, code_diff, ts::exists_with_different_code);
    if (s == kCreated) s = ts::exists;
  }
  const u64 exists_ts = e.ts;

  // --- post/void path (reference :4053-4299) ---
  const bool pv_full = is_void ? ev_amt == 0 : ev_amt == kU128Max;
  const u128 pv_amt = pv_full ? p.amt : ev_amt;
  const bool p_expires_due = p.timeout != 0 && p.expires <= ts_event;
  const bool acct_ts_collision = v.b(EV_ACCT_TS_COLLISION)[i];
  const bool regress = imported && (ev_ts <= *key_max || acct_ts_collision);
  const u64 pv_ts_actual = imported ? ev_ts : ts_event;
  u64 pv_status = kCreated;
  CHECK(pv_status, is_post && is_void, ts::flags_are_mutually_exclusive);
  CHECK(pv_status,
        flags & (F_PENDING | F_BAL_DR | F_BAL_CR | F_CLOSE_DR | F_CLOSE_CR),
        ts::flags_are_mutually_exclusive);
  CHECK(pv_status, ev_pid == 0, ts::pending_id_must_not_be_zero);
  CHECK(pv_status, ev_pid == kU128Max, ts::pending_id_must_not_be_int_max);
  CHECK(pv_status, ev_pid == id, ts::pending_id_must_be_different);
  CHECK(pv_status, ev_timeout != 0,
        ts::timeout_reserved_for_pending_transfer);
  CHECK(pv_status, !p_found, ts::pending_transfer_not_found);
  CHECK(pv_status, !(p.flags & F_PENDING), ts::pending_transfer_not_pending);
  CHECK(pv_status, ev_dr != 0 && ev_dr != p.dr,
        ts::pending_transfer_has_different_debit_account_id);
  CHECK(pv_status, ev_cr != 0 && ev_cr != p.cr,
        ts::pending_transfer_has_different_credit_account_id);
  CHECK(pv_status, ev_ledger != 0 && ev_ledger != p.ledger,
        ts::pending_transfer_has_different_ledger);
  CHECK(pv_status, ev_code != 0 && ev_code != p.code,
        ts::pending_transfer_has_different_code);
  CHECK(pv_status, p.amt < pv_amt, ts::exceeds_pending_transfer_amount);
  CHECK(pv_status, is_void && pv_amt < p.amt,
        ts::pending_transfer_has_different_amount);
  CHECK(pv_status, p.pstat == PS_POSTED, ts::pending_transfer_already_posted);
  CHECK(pv_status, p.pstat == PS_VOIDED, ts::pending_transfer_already_voided);
  CHECK(pv_status, p.pstat == PS_EXPIRED, ts::pending_transfer_expired);
  CHECK(pv_status, p_expires_due, ts::pending_transfer_expired);
  CHECK(pv_status, regress, ts::imported_event_timestamp_must_not_regress);
  CHECK(pv_status, (p_dr.flags & A_CLOSED) && !is_void,
        ts::debit_account_already_closed);
  CHECK(pv_status, (p_cr.flags & A_CLOSED) && !is_void,
        ts::credit_account_already_closed);

  // --- regular path (reference :3748-3904) ---
  const u64 reg_ts_actual = imported ? ev_ts : ts_event;
  // Balancing clamp (reference :3840-3853), wrapping sums as the twin's.
  u128 amt = ev_amt;
  if (flags & F_BAL_DR) amt = umin(amt, sat_sub(dr.cpos, dr.dpos + dr.dp));
  if (flags & F_BAL_CR) amt = umin(amt, sat_sub(cr.dpos, cr.cpos + cr.cp));
  // Overflow checks (reference :3856-3901).
  bool ovf_dp, ovf_cp, ovf_dpos, ovf_cpos, o1, o2;
  add(amt, dr.dp, &ovf_dp);
  add(amt, cr.cp, &ovf_cp);
  add(amt, dr.dpos, &ovf_dpos);
  add(amt, cr.cpos, &ovf_cpos);
  add(add(amt, dr.dp, &o1), dr.dpos, &o2);
  const bool ovf_d = o1 || o2;
  add(add(amt, cr.cp, &o1), cr.cpos, &o2);
  const bool ovf_c = o1 || o2;
  const u64 timeout_ns = ev_timeout * kNsPerS;
  const bool ovf_timeout = reg_ts_actual + timeout_ns > kU63Max;
  // Balance limits (reference tigerbeetle.zig:34-42).
  const bool exceeds_credits =
      (dr.flags & A_DR_LIMIT) && dr.cpos < dr.dp + dr.dpos + amt;
  const bool exceeds_debits =
      (cr.flags & A_CR_LIMIT) && cr.dpos < cr.cp + cr.cpos + amt;

  u64 reg_status = kCreated;
  CHECK(reg_status, ev_dr == 0, ts::debit_account_id_must_not_be_zero);
  CHECK(reg_status, ev_dr == kU128Max,
        ts::debit_account_id_must_not_be_int_max);
  CHECK(reg_status, ev_cr == 0, ts::credit_account_id_must_not_be_zero);
  CHECK(reg_status, ev_cr == kU128Max,
        ts::credit_account_id_must_not_be_int_max);
  CHECK(reg_status, ev_dr == ev_cr, ts::accounts_must_be_different);
  CHECK(reg_status, ev_pid != 0, ts::pending_id_must_be_zero);
  CHECK(reg_status, !pending && ev_timeout != 0,
        ts::timeout_reserved_for_pending_transfer);
  CHECK(reg_status, !pending && (flags & (F_CLOSE_DR | F_CLOSE_CR)),
        ts::closing_transfer_must_be_pending);
  CHECK(reg_status, ev_ledger == 0, ts::ledger_must_not_be_zero);
  CHECK(reg_status, ev_code == 0, ts::code_must_not_be_zero);
  CHECK(reg_status, !dr.exists, ts::debit_account_not_found);
  CHECK(reg_status, !cr.exists, ts::credit_account_not_found);
  CHECK(reg_status, dr.ledger != cr.ledger,
        ts::accounts_must_have_the_same_ledger);
  CHECK(reg_status, ev_ledger != dr.ledger,
        ts::transfer_must_have_the_same_ledger_as_accounts);
  CHECK(reg_status, regress, ts::imported_event_timestamp_must_not_regress);
  CHECK(reg_status, imported && ev_ts <= dr.ts,
        ts::imported_event_timestamp_must_postdate_debit_account);
  CHECK(reg_status, imported && ev_ts <= cr.ts,
        ts::imported_event_timestamp_must_postdate_credit_account);
  CHECK(reg_status, imported && ev_timeout != 0,
        ts::imported_event_timeout_must_be_zero);
  CHECK(reg_status, dr.flags & A_CLOSED, ts::debit_account_already_closed);
  CHECK(reg_status, cr.flags & A_CLOSED, ts::credit_account_already_closed);
  CHECK(reg_status, pending && ovf_dp, ts::overflows_debits_pending);
  CHECK(reg_status, pending && ovf_cp, ts::overflows_credits_pending);
  CHECK(reg_status, ovf_dpos, ts::overflows_debits_posted);
  CHECK(reg_status, ovf_cpos, ts::overflows_credits_posted);
  CHECK(reg_status, ovf_d, ts::overflows_debits);
  CHECK(reg_status, ovf_c, ts::overflows_credits);
  CHECK(reg_status, ovf_timeout, ts::overflows_timeout);
  CHECK(reg_status, exceeds_credits, ts::exceeds_credits);
  CHECK(reg_status, exceeds_debits, ts::exceeds_debits);

  // --- combine the three evaluation paths (reference :3729-3746) ---
  u64 inner = e_found ? exists_status
                      : (orphan ? ts::id_already_failed
                                : (pv ? pv_status : reg_status));
  u64 pre = kCreated;
  CHECK(pre, flags & TF_PADDING, ts::reserved_flag);
  CHECK(pre, id == 0, ts::id_must_not_be_zero);
  CHECK(pre, id == kU128Max, ts::id_must_not_be_int_max);
  if (pre != kCreated) inner = pre;
  const u64 ts_actual_inner =
      (e_found && inner == ts::exists)
          ? exists_ts
          : (inner == kCreated ? (pv ? pv_ts_actual : reg_ts_actual)
                               : ts_event);

  // --- wrapper checks (reference execute_create :3033-3104) ---
  const bool ts_valid = ev_ts >= 1 && ev_ts <= kU63Max;
  u64 status = inner;
  if (!imported && ev_ts != 0) status = ts::timestamp_must_be_zero;
  if (imported && ts_valid && ev_ts >= timestamp) {
    status = ts::imported_event_timestamp_must_not_advance;
  }
  if (imported && !ts_valid) {
    status = ts::imported_event_timestamp_out_of_range;
  }
  if (imported != batch_imported) {
    status = imported ? ts::imported_event_not_expected
                      : ts::imported_event_expected;
  }
  if (*chain_broken) status = ts::linked_event_failed;
  if (linked && i == a.n - 1) status = ts::linked_event_chain_open;
  const u64 ts_actual = status == inner ? ts_actual_inner : ts_event;

  // --- application (masked as the twin's) ---
  const bool created = status == kCreated && valid;
  const bool ap_pv = created && pv, ap_reg = created && !pv;
  const bool ap_pending = ap_reg && pending;
  const u128 f_amt = pv ? pv_amt : amt;
  const u64 f_ts = pv ? pv_ts_actual : reg_ts_actual;

  // Regular/pending application (reference :3909-3985).
  if (ap_pending) {
    add_at(v, ST_A_DP_HI, ST_A_DP_LO, dr_idx, f_amt);
    add_at(v, ST_A_CP_HI, ST_A_CP_LO, cr_idx, f_amt);
  }
  if (ap_reg && !pending) {
    add_at(v, ST_A_DPOS_HI, ST_A_DPOS_LO, dr_idx, f_amt);
    add_at(v, ST_A_CPOS_HI, ST_A_CPOS_LO, cr_idx, f_amt);
  }
  u64* a_flags = v.u(ST_A_FLAGS);
  const i64 s_dr = pv ? p.dr_idx : dr_idx, s_cr = pv ? p.cr_idx : cr_idx;
  const bool rb_dr_closed = a_flags[s_dr] & A_CLOSED;
  const bool rb_cr_closed = a_flags[s_cr] & A_CLOSED;
  if (ap_reg && (flags & F_CLOSE_DR)) a_flags[dr_idx] |= A_CLOSED;
  if (ap_reg && (flags & F_CLOSE_CR)) a_flags[cr_idx] |= A_CLOSED;

  // Post/void application (reference :4195-4283).
  if (ap_pv) {
    sub_at(v, ST_A_DP_HI, ST_A_DP_LO, p.dr_idx, p.amt);
    sub_at(v, ST_A_CP_HI, ST_A_CP_LO, p.cr_idx, p.amt);
  }
  if (ap_pv && is_post) {
    add_at(v, ST_A_DPOS_HI, ST_A_DPOS_LO, p.dr_idx, f_amt);
    add_at(v, ST_A_CPOS_HI, ST_A_CPOS_LO, p.cr_idx, f_amt);
  }
  if (ap_pv && is_void && (p.flags & F_CLOSE_DR)) {
    a_flags[p.dr_idx] &= ~A_CLOSED;
  }
  if (ap_pv && is_void && (p.flags & F_CLOSE_CR)) {
    a_flags[p.cr_idx] &= ~A_CLOSED;
  }

  // Flip p's pending status (reference :4233-4238).
  const i64 new_pstat = is_post ? PS_POSTED : PS_VOIDED;
  if (ap_pv && p_from_cache) v.s(ST_TC_PSTAT)[pci] = new_pstat;
  if (ap_pv && !p_from_cache) v.s(ST_S_PSTAT)[psl] = new_pstat;

  // Insert the stored transfer into the batch store at `slot`.
  if (created) {
    v.set_q(ST_S_AMT_HI, ST_S_AMT_LO, slot, f_amt);
    v.s(ST_S_DR_IDX)[slot] = s_dr;
    v.s(ST_S_CR_IDX)[slot] = s_cr;
    v.set_q(ST_S_DR_HI, ST_S_DR_LO, slot, pv ? p.dr : ev_dr);
    v.set_q(ST_S_CR_HI, ST_S_CR_LO, slot, pv ? p.cr : ev_cr);
    v.set_q(ST_S_PID_HI, ST_S_PID_LO, slot, ev_pid);
    v.set_q(ST_S_UD128_HI, ST_S_UD128_LO, slot,
            (pv && ev_ud128 == 0) ? p.ud128 : ev_ud128);
    v.u(ST_S_UD64)[slot] = (pv && ev_ud64 == 0) ? p.ud64 : ev_ud64;
    v.u(ST_S_UD32)[slot] = (pv && ev_ud32 == 0) ? p.ud32 : ev_ud32;
    v.u(ST_S_TIMEOUT)[slot] = pv ? 0 : ev_timeout;
    v.u(ST_S_LEDGER)[slot] = pv ? p.ledger : ev_ledger;
    v.u(ST_S_CODE)[slot] = pv ? p.code : ev_code;
    v.u(ST_S_FLAGS)[slot] = flags;
    v.u(ST_S_TS)[slot] = f_ts;
    v.s(ST_S_PSTAT)[slot] = ap_pending ? PS_PENDING : 0;
    v.u(ST_S_EXPIRES)[slot] =
        (ap_pending && ev_timeout != 0) ? f_ts + timeout_ns : 0;
    v.b(ST_S_CREATED)[slot] = true;
    if (f_ts > *key_max) *key_max = f_ts;
  }

  // Pulse scheduling (reference :3975-3981 add, :4227-4230 remove-reset).
  const u64 expires_new = f_ts + timeout_ns;
  if (ap_pending && ev_timeout != 0 && expires_new < *pulse_next) {
    *pulse_next = expires_new;
  }
  if (ap_pv && p.timeout != 0 && *pulse_next == p.expires) *pulse_next = 1;

  // Undo log record.
  v.s(ST_RB_KIND)[i] = !created ? 0
                                : (is_post ? 3 : (is_void ? 4
                                                          : (pending ? 2 : 1)));
  v.s(ST_RB_DR_IDX)[i] = s_dr;
  v.s(ST_RB_CR_IDX)[i] = s_cr;
  v.set_q(ST_RB_AMT_HI, ST_RB_AMT_LO, i, f_amt);
  v.set_q(ST_RB_PAMT_HI, ST_RB_PAMT_LO, i, p.amt);
  v.b(ST_RB_P_BATCH)[i] = !p_from_cache;
  v.s(ST_RB_P_IDX)[i] = p_from_cache ? pci : psl;
  v.b(ST_RB_DR_CLOSED)[i] = rb_dr_closed;
  v.b(ST_RB_CR_CLOSED)[i] = rb_cr_closed;

  // Orphan transient failures (reference transient_error :3215-3252).
  if (transient(status) && valid) v.b(ST_S_ORPHANED)[slot] = true;

  // Results.
  if (valid) {
    v.u(ST_R_TS)[i] = ts_actual;
    v.u(ST_R_STATUS)[i] = status;
  }

  // --- chain break: roll back the applied prefix (reference :3116-3150) ---
  const bool breaking =
      status != kCreated && chain_active && !*chain_broken && valid;
  if (breaking) {
    const i64 start = *chain_start > 0 ? *chain_start : 0;
    for (i64 j = i - 1; j >= start; --j) ct_rollback(v, j);
    *key_max = *v.u(ST_CHAIN_KEY_MAX);
    *chain_broken = true;
  }

  // --- chain close (reference :3196-3207) ---
  if (chain_active && (!linked || status == ts::linked_event_chain_open)) {
    *chain_start = -1;
    *chain_broken = false;
  }
}

__global__ void create_transfers_seq_kernel(const __grid_constant__ SeqArgs a) {
  const View v{a};
  for (i64 i = 0; i < a.N; ++i) ct_body(v, i);
}

// Event i of a create_accounts batch (the plain twin's _ca_body).
__device__ void ca_body(const View& v, i64 i) {
  using namespace ca;
  const SeqArgs& a = v.a;
  const u64 timestamp = a.timestamp;
  const u64 ts_event = timestamp - static_cast<u64>(a.n) +
                       static_cast<u64>(i) + 1;
  const bool valid = v.b(EV_VALID)[i];
  const u64 flags = v.u(EV_FLAGS)[i];
  const bool linked = flags & A_LINKED, imported = flags & A_IMPORTED;
  const bool batch_imported = (v.u(EV_FLAGS)[0] & A_IMPORTED) && a.n > 0;
  const u64 ev_ts = v.u(EV_TS)[i];
  const u128 ev_ud128 = v.q(EV_UD128_HI, EV_UD128_LO, i);
  const u128 id = v.q(EV_ID_HI, EV_ID_LO, i);

  i64* chain_start = v.s(ST_CHAIN_START);
  u64* key_max = v.u(ST_KEY_MAX);
  bool* chain_broken = v.b(ST_CHAIN_BROKEN);

  bool chain_active = *chain_start >= 0;
  const bool opening = linked && !chain_active && valid;
  if (opening) {
    *chain_start = i;
    *v.u(ST_CHAIN_KEY_MAX) = *key_max;
  }
  chain_active = chain_active || opening;

  const i64 slot = v.s(EV_SLOT)[i];
  const i64 exists_idx = v.s(EV_EXISTS_IDX)[i];
  const bool e_from_cache = exists_idx >= 0;
  const bool e_from_batch = !e_from_cache && v.b(ST_S_CREATED)[slot];
  const bool e_found = e_from_cache || e_from_batch;
  const i64 c = exists_idx > 0 ? exists_idx : 0;
  auto e_u = [&](int ac_k, int st_k) {
    return e_from_cache ? v.u(ac_k)[c] : v.u(st_k)[slot];
  };

  // create_account_exists (reference :3691-3703).
  u64 exists_status = kCreated;
  {
    const u128 e_ud128 =
        e_from_cache ? v.q(AC_UD128_HI, AC_UD128_LO, c)
                     : v.q(ST_S_UD128_HI, ST_S_UD128_LO, slot);
    u64& s = exists_status;
    CHECK(s, (flags & 0xFFFF) != (e_u(AC_FLAGS, ST_S_FLAGS) & 0xFFFF),
          as::exists_with_different_flags);
    CHECK(s, ev_ud128 != e_ud128, as::exists_with_different_user_data_128);
    CHECK(s, v.u(EV_UD64)[i] != e_u(AC_UD64, ST_S_UD64),
          as::exists_with_different_user_data_64);
    CHECK(s, v.u(EV_UD32)[i] != e_u(AC_UD32, ST_S_UD32),
          as::exists_with_different_user_data_32);
    CHECK(s, v.u(EV_LEDGER)[i] != e_u(AC_LEDGER, ST_S_LEDGER),
          as::exists_with_different_ledger);
    CHECK(s, v.u(EV_CODE)[i] != e_u(AC_CODE, ST_S_CODE),
          as::exists_with_different_code);
    if (s == kCreated) s = as::exists;
  }
  const u64 exists_ts = e_u(AC_TS, ST_S_TS);

  const bool regress =
      imported && ((*key_max != 0 && ev_ts <= *key_max) ||
                   v.b(EV_TRANSFER_TS_COLLISION)[i]);
  const u64 ts_actual_created = imported ? ev_ts : ts_event;

  // create_account (reference :3613-3689); a found id takes exists_status
  // at its place in the order.
  u64 inner = kCreated;
  bool exists_first = false;
  CHECK(inner, v.u(EV_RESERVED)[i] != 0, as::reserved_field);
  CHECK(inner, flags & AF_PADDING, as::reserved_flag);
  CHECK(inner, id == 0, as::id_must_not_be_zero);
  CHECK(inner, id == kU128Max, as::id_must_not_be_int_max);
  if (inner == kCreated && e_found) exists_first = true;
  if (!exists_first) {
    CHECK(inner, (flags & A_DR_LIMIT) && (flags & A_CR_LIMIT),
          as::flags_are_mutually_exclusive);
    CHECK(inner, v.q(EV_DP_HI, EV_DP_LO, i) != 0,
          as::debits_pending_must_be_zero);
    CHECK(inner, v.q(EV_DPOS_HI, EV_DPOS_LO, i) != 0,
          as::debits_posted_must_be_zero);
    CHECK(inner, v.q(EV_CP_HI, EV_CP_LO, i) != 0,
          as::credits_pending_must_be_zero);
    CHECK(inner, v.q(EV_CPOS_HI, EV_CPOS_LO, i) != 0,
          as::credits_posted_must_be_zero);
    CHECK(inner, v.u(EV_LEDGER)[i] == 0, as::ledger_must_not_be_zero);
    CHECK(inner, v.u(EV_CODE)[i] == 0, as::code_must_not_be_zero);
    CHECK(inner, regress, as::imported_event_timestamp_must_not_regress);
  } else {
    inner = exists_status;
  }
  const u64 ts_actual_inner =
      inner == as::exists
          ? exists_ts
          : (inner == kCreated ? ts_actual_created : ts_event);

  const bool ts_valid = ev_ts >= 1 && ev_ts <= kU63Max;
  u64 status = inner;
  if (!imported && ev_ts != 0) status = as::timestamp_must_be_zero;
  if (imported && ts_valid && ev_ts >= timestamp) {
    status = as::imported_event_timestamp_must_not_advance;
  }
  if (imported && !ts_valid) {
    status = as::imported_event_timestamp_out_of_range;
  }
  if (imported != batch_imported) {
    status = imported ? as::imported_event_not_expected
                      : as::imported_event_expected;
  }
  if (*chain_broken) status = as::linked_event_failed;
  if (linked && i == a.n - 1) status = as::linked_event_chain_open;
  const u64 ts_actual = status == inner ? ts_actual_inner : ts_event;

  const bool created = status == kCreated && valid;
  if (created) {
    v.set_q(ST_S_UD128_HI, ST_S_UD128_LO, slot, ev_ud128);
    v.u(ST_S_UD64)[slot] = v.u(EV_UD64)[i];
    v.u(ST_S_UD32)[slot] = v.u(EV_UD32)[i];
    v.u(ST_S_LEDGER)[slot] = v.u(EV_LEDGER)[i];
    v.u(ST_S_CODE)[slot] = v.u(EV_CODE)[i];
    v.u(ST_S_FLAGS)[slot] = flags;
    v.u(ST_S_TS)[slot] = ts_actual_created;
    v.b(ST_S_CREATED)[slot] = true;
    if (ts_actual_created > *key_max) *key_max = ts_actual_created;
  }
  if (valid) {
    v.u(ST_R_TS)[i] = ts_actual;
    v.u(ST_R_STATUS)[i] = status;
  }

  const bool breaking =
      status != kCreated && chain_active && !*chain_broken && valid;
  if (breaking) {
    const i64 start = *chain_start > 0 ? *chain_start : 0;
    for (i64 j = start; j < i; ++j) {
      v.b(ST_S_CREATED)[v.s(EV_SLOT)[j]] = false;
      v.u(ST_R_STATUS)[j] = as::linked_event_failed;
    }
    *key_max = *v.u(ST_CHAIN_KEY_MAX);
    *chain_broken = true;
  }

  if (chain_active && (!linked || status == as::linked_event_chain_open)) {
    *chain_start = -1;
    *chain_broken = false;
  }
}

__global__ void create_accounts_seq_kernel(const __grid_constant__ SeqArgs a) {
  const View v{a};
  for (i64 i = 0; i < a.N; ++i) ca_body(v, i);
}

bool args_ok(const SeqArgs* args, int n_seg) {
  return n_seg == 1 && args->N >= 0 && args->n >= 0 && args->n <= args->N;
}

}  // namespace

// C entry points (bound with ctypes): one batch (n_seg must be 1), one
// launch of one thread on `stream`; no synchronisation. Each returns
// cudaGetLastError() of its launch.
extern "C" int create_transfers_seq_launch(const SeqArgs* args, int n_seg,
                                           void* stream) {
  if (!args_ok(args, n_seg)) return static_cast<int>(cudaErrorInvalidValue);
  create_transfers_seq_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int create_accounts_seq_launch(const SeqArgs* args, int n_seg,
                                          void* stream) {
  if (!args_ok(args, n_seg)) return static_cast<int>(cudaErrorInvalidValue);
  create_accounts_seq_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}
