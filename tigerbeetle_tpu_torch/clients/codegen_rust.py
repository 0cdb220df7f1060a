"""Rust client crate emitter (reference: src/clients/rust — codegen'd
type glue + a native wrapper over tb_client). Rust has native u128, so
amounts are exact without limb emulation; packing is explicit
little-endian byte layout (no #[repr(C)] reliance), and the client binds
the shared `tbp_*` C ABI with a plain `extern "C"` block — no bindgen,
no external crates. Layout parity is enforced offline by
tests/test_torch_clients_codegen.py and the embedded golden vectors; the
`cargo test` suite runs wherever a Rust toolchain exists (none in this
image — emission and layout-diffing are still exact).

A copy of the JAX package's `clients/codegen_rust.py`."""

from __future__ import annotations

from .codegen import (
    ENUMS,
    FLAGS,
    HEADER,
    LAYOUTS,
    _mb_vectors,
    offsets,
    struct_size,
)

_RUST_TY = {"u128": "u128", "u64": "u64", "u32": "u32", "u16": "u16"}


def _struct(name: str) -> str:
    fields = [(f, k, o) for f, k, o in offsets(name)
              if not k.startswith("pad")]
    decl = "\n".join(f"    pub {f}: {_RUST_TY[k]}," for f, k, _ in fields)
    packs = []
    for f, k, o in fields:
        size = {"u128": 16, "u64": 8, "u32": 4, "u16": 2}[k]
        packs.append(f"        b[{o}..{o + size}]"
                     f".copy_from_slice(&self.{f}.to_le_bytes());")
    unpacks = []
    for f, k, o in fields:
        size = {"u128": 16, "u64": 8, "u32": 4, "u16": 2}[k]
        unpacks.append(
            f"            {f}: {_RUST_TY[k]}::from_le_bytes("
            f"b[{o}..{o + size}].try_into().unwrap()),")
    decl_src = decl
    packs_src = "\n".join(packs)
    unpacks_src = "\n".join(unpacks)
    return f"""#[derive(Debug, Clone, Copy, Default, PartialEq, Eq)]
pub struct {name} {{
{decl_src}
}}

impl {name} {{
    pub const SIZE: usize = {struct_size(name)};

    pub fn pack(&self) -> [u8; Self::SIZE] {{
        let mut b = [0u8; Self::SIZE];
{packs_src}
        b
    }}

    /// Panics if `b.len() != SIZE` (the wire layout is fixed).
    pub fn unpack(b: &[u8]) -> Self {{
        assert_eq!(b.len(), Self::SIZE, "{name}: need {{}} bytes", Self::SIZE);
        Self {{
{unpacks_src}
        }}
    }}
}}
"""


def _enum(name: str, cls) -> str:
    consts = "\n".join(
        f"    pub const {m.name.upper()}: u32 = {int(m)};" for m in cls)
    arms = "\n".join(
        f"        {int(m)} => \"{m.name}\"," for m in cls)
    return f"""#[allow(dead_code)]
pub mod {_snake(name)} {{
{consts}

    pub fn name_of(value: u32) -> &'static str {{
        match value {{
{arms}
            _ => "unknown",
        }}
    }}
}}
"""


def _flags(name: str, cls) -> str:
    # Flag fields are u16 on Account/Transfer and u32 on filters; emit
    # the widest type and let callers narrow (`as u16`) at pack time.
    consts = "\n".join(
        f"    pub const {m.name.upper()}: u32 = {int(m.value)};"
        for m in cls)
    return f"#[allow(dead_code)]\npub mod {_snake(name)} {{\n{consts}\n}}\n"


def _snake(camel: str) -> str:
    out = []
    for ch in camel:
        if ch.isupper() and out:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def generate_rust() -> dict[str, str]:
    structs = "\n".join(_struct(n) for n in LAYOUTS)
    enums = "\n".join(_enum(n, c) for n, c in ENUMS.items())
    flags = "\n".join(_flags(n, c) for n, c in FLAGS.items())

    types_rs = f"""// {HEADER}
//
// Wire types for the tigerbeetle_tpu cluster protocol (little-endian
// fixed layouts; reference data model: src/tigerbeetle.zig:10-148).

{structs}
{enums}
{flags}"""

    multi_batch_rs = f"""// {HEADER}
//
// Multi-batch wire codec (reference: src/vsr/multi_batch.zig:1-41).

pub const PADDING: u16 = 0xFFFF;

pub fn trailer_size(batch_count: usize, element_size: usize) -> usize {{
    let raw = (batch_count + 1) * 2;
    if element_size <= 1 {{
        return raw;
    }}
    (raw + element_size - 1) / element_size * element_size
}}

/// Encode `batches` (each element-aligned) into one multi-batch body.
pub fn encode(batches: &[&[u8]], element_size: usize)
    -> Result<Vec<u8>, String> {{
    if batches.is_empty() || batches.len() > 0xFFFE {{
        return Err("batch count out of range".into());
    }}
    let mut counts = Vec::with_capacity(batches.len());
    for (i, p) in batches.iter().enumerate() {{
        if element_size == 0 && !p.is_empty() {{
            return Err(format!(
                "payload {{i}} must be empty at element_size 0"));
        }}
        if element_size > 0 && p.len() % element_size != 0 {{
            return Err(format!("payload {{i}} not element-aligned"));
        }}
        let c = if element_size > 0 {{ p.len() / element_size }} else {{ 0 }};
        if c > 0xFFFE {{
            return Err("count exceeds u16".into());
        }}
        counts.push(c as u16);
    }}
    let es = element_size.max(1);
    let n_items = trailer_size(batches.len(), es) / 2;
    let mut items = vec![PADDING; n_items];
    items[n_items - 1] = batches.len() as u16;
    for (i, &c) in counts.iter().enumerate() {{
        items[n_items - 2 - i] = c;
    }}
    let mut out: Vec<u8> =
        batches.iter().flat_map(|p| p.iter().copied()).collect();
    for item in items {{
        out.extend_from_slice(&item.to_le_bytes());
    }}
    Ok(out)
}}

/// Decode a multi-batch body into its payloads.
pub fn decode(body: &[u8], element_size: usize)
    -> Result<Vec<Vec<u8>>, String> {{
    if body.len() < 2 {{
        return Err("body too small".into());
    }}
    let batch_count =
        u16::from_le_bytes(body[body.len() - 2..].try_into().unwrap())
        as usize;
    if batch_count == 0 || batch_count > 0xFFFE {{
        return Err("bad batch count".into());
    }}
    let es = element_size.max(1);
    let tsize = trailer_size(batch_count, es);
    if tsize > body.len() {{
        return Err("trailer exceeds body".into());
    }}
    let n_items = tsize / 2;
    let trailer = &body[body.len() - tsize..];
    let item = |i: usize| -> usize {{
        u16::from_le_bytes(trailer[2 * i..2 * i + 2].try_into().unwrap())
            as usize
    }};
    // Server-codec strictness (multi_batch.py): counts must not carry
    // the padding marker; padding items must all be 0xFFFF; the body
    // size must match the counts exactly.
    let mut counts = Vec::with_capacity(batch_count);
    for i in 0..batch_count {{
        let c = item(n_items - 2 - i);
        if c == PADDING as usize {{
            return Err("padding marker inside counts".into());
        }}
        counts.push(c);
    }}
    for i in 0..n_items - 1 - batch_count {{
        if item(i) != PADDING as usize {{
            return Err("trailer padding not 0xFFFF".into());
        }}
    }}
    let payload_len: usize =
        counts.iter().map(|c| c * element_size).sum();
    if payload_len + tsize != body.len() {{
        return Err("body size does not match trailer counts".into());
    }}
    let mut pos = 0usize;
    let mut out = Vec::with_capacity(batch_count);
    for count in counts {{
        let size = count * element_size;
        out.push(body[pos..pos + size].to_vec());
        pos += size;
    }}
    Ok(out)
}}
"""

    client_rs = f"""// {HEADER}
//
// Client over the shared C ABI (native/libtb_client.so, `tbp_*`; ABI
// reference: clients/cpp/tb_client.hpp). Packet and body live in
// heap memory owned by this wrapper; after a timeout the IO thread
// still owns the packet, so both allocations are deliberately leaked
// (zombie parking) — the same discipline as the Go/C++/Python/Ruby
// clients.

use std::ffi::{{c_char, c_int, c_uchar, c_uint, c_void, CString}};

// struct tbp_packet: next(0,8) user_data(8,8) operation(16,2)
// status(18,1) reserved(19,1) data_size(20,4) data(24,8)
// reply(32,8) reply_size(40,4) pad(44,4)
pub const PACKET_SIZE: usize = 48;

/// Byte image of `struct tbp_packet`. The C side dereferences pointer
/// and u64 fields through it, so the allocation must carry the struct's
/// 8-byte alignment — a bare [u8; 48] box (align 1) would be UB.
#[repr(C, align(8))]
struct PacketBytes([u8; PACKET_SIZE]);

const OFF_OPERATION: usize = 16;
const OFF_DATA_SIZE: usize = 20;
const OFF_DATA: usize = 24;
const OFF_REPLY: usize = 32;
const OFF_REPLY_SIZE: usize = 40;
const STATUS_PENDING: u8 = 0;
const STATUS_OK: u8 = 1;

#[allow(dead_code)]
extern "C" {{
    fn tbp_client_init(out: *mut *mut c_void, cluster: u64,
                       client_id: *const u8, addresses: *const c_char,
                       on_completion: *const c_void,
                       ctx: *const c_void) -> c_int;
    fn tbp_client_init_echo(out: *mut *mut c_void, cluster: u64,
                            client_id: *const u8,
                            on_completion: *const c_void,
                            ctx: *const c_void) -> c_int;
    fn tbp_client_submit(client: *mut c_void, packet: *mut c_void);
    fn tbp_client_wait(client: *mut c_void, packet: *mut c_void,
                       timeout_ms: c_uint) -> c_uchar;
    fn tbp_client_packet_free(packet: *mut c_void);
    fn tbp_client_deinit(client: *mut c_void);
}}

#[derive(Debug)]
pub enum ClientError {{
    Init(i32),
    Timeout,
    Packet(u8),
    Closed,
}}

pub struct Client {{
    handle: *mut c_void,
}}

// The tbp_* ABI is thread-safe (packet queue + internal IO thread).
unsafe impl Send for Client {{}}

impl Client {{
    /// Connect to a cluster at `addresses` ("host:port,host:port").
    pub fn connect(cluster: u64, client_id: u128, addresses: &str)
        -> Result<Self, ClientError> {{
        let addr = CString::new(addresses).expect("nul in addresses");
        let id = client_id.to_le_bytes();
        let mut handle: *mut c_void = std::ptr::null_mut();
        let rc = unsafe {{
            tbp_client_init(&mut handle, cluster, id.as_ptr(),
                            addr.as_ptr(), std::ptr::null(),
                            std::ptr::null())
        }};
        if rc != 0 {{
            return Err(ClientError::Init(rc));
        }}
        Ok(Self {{ handle }})
    }}

    /// Loopback echo client (no cluster) — for wire-level testing.
    pub fn echo(cluster: u64, client_id: u128)
        -> Result<Self, ClientError> {{
        let id = client_id.to_le_bytes();
        let mut handle: *mut c_void = std::ptr::null_mut();
        let rc = unsafe {{
            tbp_client_init_echo(&mut handle, cluster, id.as_ptr(),
                                 std::ptr::null(), std::ptr::null())
        }};
        if rc != 0 {{
            return Err(ClientError::Init(rc));
        }}
        Ok(Self {{ handle }})
    }}

    /// Submit one operation body and block for the reply.
    pub fn request(&self, operation: u16, body: &[u8], timeout_ms: u32)
        -> Result<Vec<u8>, ClientError> {{
        if self.handle.is_null() {{
            return Err(ClientError::Closed);
        }}
        let mut pkt: Box<PacketBytes> =
            Box::new(PacketBytes([0u8; PACKET_SIZE]));
        pkt.0[OFF_OPERATION..OFF_OPERATION + 2]
            .copy_from_slice(&operation.to_le_bytes());
        pkt.0[OFF_DATA_SIZE..OFF_DATA_SIZE + 4]
            .copy_from_slice(&(body.len() as u32).to_le_bytes());
        let data = body.to_vec().into_boxed_slice();
        if !body.is_empty() {{
            let ptr = data.as_ptr() as u64;
            pkt.0[OFF_DATA..OFF_DATA + 8]
                .copy_from_slice(&ptr.to_le_bytes());
        }}
        let pkt_ptr = Box::into_raw(pkt) as *mut c_void;
        unsafe {{ tbp_client_submit(self.handle, pkt_ptr) }};
        let status =
            unsafe {{ tbp_client_wait(self.handle, pkt_ptr, timeout_ms) }};
        if status == STATUS_PENDING {{
            // IO thread still owns the packet: park both allocations.
            std::mem::forget(data);
            return Err(ClientError::Timeout);
        }}
        // Reclaim ownership; free the ABI-owned reply buffer and then
        // the packet itself when the Box drops (the C++ client's
        // packet_free + delete pair, clients/cpp/tb_client.hpp:213-214).
        let mut pkt = unsafe {{
            Box::from_raw(pkt_ptr as *mut PacketBytes)
        }};
        drop(data);
        let result = if status != STATUS_OK {{
            Err(ClientError::Packet(status))
        }} else {{
            let len = u32::from_le_bytes(
                pkt.0[OFF_REPLY_SIZE..OFF_REPLY_SIZE + 4]
                    .try_into().unwrap()) as usize;
            let reply_ptr = u64::from_le_bytes(
                pkt.0[OFF_REPLY..OFF_REPLY + 8].try_into().unwrap())
                as *const u8;
            Ok(if len == 0 {{
                Vec::new()
            }} else {{
                unsafe {{ std::slice::from_raw_parts(reply_ptr, len) }}
                    .to_vec()
            }})
        }};
        unsafe {{
            tbp_client_packet_free(pkt.0.as_mut_ptr() as *mut c_void)
        }};
        result
    }}
}}

impl Drop for Client {{
    fn drop(&mut self) {{
        if !self.handle.is_null() {{
            unsafe {{ tbp_client_deinit(self.handle) }};
            self.handle = std::ptr::null_mut();
        }}
    }}
}}
"""

    lib_rs = f"""// {HEADER}

pub mod client;
pub mod multi_batch;
pub mod types;
"""

    cargo_toml = f"""# {HEADER}
[package]
name = "tigerbeetle_tpu"
version = "0.1.0"
edition = "2021"
description = "tigerbeetle_tpu client over the shared tbp_* C ABI"
license = "Apache-2.0"

[lib]
name = "tigerbeetle_tpu"
path = "src/lib.rs"
"""

    mb_cases = []
    for payloads, es, encoded in _mb_vectors():
        ps = ", ".join(f"&h(\"{p.hex()}\")[..]" for p in payloads)
        mb_cases.append(
            f"    check(&[{ps}], {es}, &h(\"{encoded.hex()}\"));")
    mb_cases_src = "\n".join(mb_cases)

    wire_rs = f"""// {HEADER}
//
// Golden parity vectors against the server's Python codecs
// (run: cargo test).

use tigerbeetle_tpu::multi_batch;
use tigerbeetle_tpu::types::Transfer;

fn h(hex: &str) -> Vec<u8> {{
    (0..hex.len())
        .step_by(2)
        .map(|i| u8::from_str_radix(&hex[i..i + 2], 16).unwrap())
        .collect()
}}

fn check(payloads: &[&[u8]], es: usize, encoded: &[u8]) {{
    assert_eq!(multi_batch::encode(payloads, es).unwrap(), encoded);
    let back = multi_batch::decode(encoded, es).unwrap();
    assert_eq!(back.len(), payloads.len());
    for (want, got) in payloads.iter().zip(back.iter()) {{
        assert_eq!(&got[..], *want);
    }}
}}

#[test]
fn multi_batch_golden_vectors() {{
{mb_cases_src}
}}

#[test]
fn transfer_round_trip() {{
    let t = Transfer {{
        id: (1u128 << 127) + 5,
        debit_account_id: 7,
        credit_account_id: 8,
        amount: 1u128 << 126,
        ledger: 700,
        code: 10,
        ..Default::default()
    }};
    let packed = t.pack();
    assert_eq!(packed.len(), Transfer::SIZE);
    assert_eq!(Transfer::unpack(&packed), t);
}}
"""

    return {
        "rust/Cargo.toml": cargo_toml,
        "rust/src/lib.rs": lib_rs,
        "rust/src/types.rs": types_rs,
        "rust/src/multi_batch.rs": multi_batch_rs,
        "rust/src/client.rs": client_rs,
        "rust/tests/wire.rs": wire_rs,
    }
