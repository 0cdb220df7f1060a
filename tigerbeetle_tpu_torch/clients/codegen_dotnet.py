""".NET client package emitter (reference: src/clients/dotnet —
codegen'd type glue + a P/Invoke wrapper over tb_client). C# 11's
native UInt128 carries the 128-bit amounts exactly; the client is a
[LibraryImport]-free classic DllImport over the shared `tbp_*` ABI so
it builds on any net8.0 SDK with no codegen step. Layout parity is
enforced offline by tests/test_torch_clients_codegen.py and the embedded
golden vectors.

A copy of the JAX package's `clients/codegen_dotnet.py`."""

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


def _pascal(snake: str) -> str:
    return "".join(p.capitalize() for p in snake.split("_"))


def _cstype(kind: str) -> str:
    return {"u128": "UInt128", "u64": "ulong", "u32": "uint",
            "u16": "ushort"}[kind]


def _struct(name: str) -> str:
    fields = [(f, k, o) for f, k, o in offsets(name)
              if not k.startswith("pad")]
    decls = "\n".join(f"    public {_cstype(k)} {_pascal(f)};"
                      for f, k, _ in fields)
    widths = {"u64": "UInt64", "u32": "UInt32", "u16": "UInt16"}
    packs = []
    unpacks = []
    for f, k, o in fields:
        p = _pascal(f)
        if k == "u128":
            packs.append(f"        Wire.PutU128(b, {o}, {p});")
            unpacks.append(f"        outv.{p} = Wire.GetU128(b, {o});")
        else:
            w = widths[k]
            packs.append(
                f"        BinaryPrimitives.Write{w}LittleEndian("
                f"b.Slice({o}), {p});")
            unpacks.append(
                f"        outv.{p} = BinaryPrimitives.Read{w}"
                f"LittleEndian(b.Slice({o}));")
    return f"""public struct {name}
{{
    public const int Size = {struct_size(name)};
{decls}

    public byte[] Pack()
    {{
        var bytes = new byte[Size];
        Span<byte> b = bytes;
{chr(10).join(packs)}
        return bytes;
    }}

    public static {name} Unpack(ReadOnlySpan<byte> b)
    {{
        if (b.Length != Size)
            throw new ArgumentException(
                $"{name}: need {{Size}} bytes, got {{b.Length}}");
        var outv = new {name}();
{chr(10).join(unpacks)}
        return outv;
    }}
}}
"""


def _enum(name: str, cls, backing: str = "uint") -> str:
    members = ",\n".join(f"    {_pascal(m.name)} = {int(m)}" for m in cls)
    return f"public enum {name} : {backing}\n{{\n{members},\n}}\n"


def _flags(name: str, cls, backing: str) -> str:
    members = ",\n".join(
        f"    {_pascal(m.name)} = {int(m.value)}" for m in cls)
    return (f"[Flags]\npublic enum {name} : {backing}\n"
            f"{{\n    None = 0,\n{members},\n}}\n")


def generate_dotnet() -> dict[str, str]:
    structs = "\n".join(_struct(n) for n in LAYOUTS)
    flag_backing = {"AccountFlags": "ushort", "TransferFlags": "ushort",
                    "AccountFilterFlags": "uint",
                    "QueryFilterFlags": "uint"}
    enums = "\n".join(
        [_enum(n, c) for n, c in ENUMS.items()]
        + [_flags(n, c, flag_backing[n]) for n, c in FLAGS.items()])

    types_cs = f"""// {HEADER}
//
// Wire types for the tigerbeetle_tpu cluster protocol (little-endian
// fixed layouts; reference data model: src/tigerbeetle.zig:10-148).
using System;
using System.Buffers.Binary;

namespace TigerBeetle.Tpu;

public static class Wire
{{
    public static void PutU128(Span<byte> b, int off, UInt128 v)
    {{
        BinaryPrimitives.WriteUInt64LittleEndian(
            b.Slice(off), (ulong)(v & ulong.MaxValue));
        BinaryPrimitives.WriteUInt64LittleEndian(
            b.Slice(off + 8), (ulong)(v >> 64));
    }}

    public static UInt128 GetU128(ReadOnlySpan<byte> b, int off)
    {{
        ulong lo = BinaryPrimitives.ReadUInt64LittleEndian(b.Slice(off));
        ulong hi = BinaryPrimitives.ReadUInt64LittleEndian(
            b.Slice(off + 8));
        return ((UInt128)hi << 64) | lo;
    }}
}}

{structs}
{enums}"""

    multibatch_cs = f"""// {HEADER}
//
// Multi-batch wire codec (reference: src/vsr/multi_batch.zig:1-41).
using System;
using System.Collections.Generic;

namespace TigerBeetle.Tpu;

public static class MultiBatch
{{
    private const int Padding = 0xFFFF;

    internal static int TrailerSize(int batchCount, int elementSize)
    {{
        int raw = (batchCount + 1) * 2;
        if (elementSize <= 1) return raw;
        return (raw + elementSize - 1) / elementSize * elementSize;
    }}

    public static byte[] Encode(IReadOnlyList<byte[]> batches,
                                int elementSize)
    {{
        if (batches.Count == 0 || batches.Count > 0xFFFE)
            throw new ArgumentException("batch count out of range");
        var counts = new int[batches.Count];
        int total = 0;
        for (int i = 0; i < batches.Count; i++)
        {{
            if (elementSize > 0 && batches[i].Length % elementSize != 0)
                throw new ArgumentException(
                    $"payload {{i}} not element-aligned");
            counts[i] = elementSize > 0
                ? batches[i].Length / elementSize : 0;
            if (counts[i] > 0xFFFE)
                throw new ArgumentException("count exceeds u16");
            total += batches[i].Length;
        }}
        int es = Math.Max(elementSize, 1);
        int nItems = TrailerSize(batches.Count, es) / 2;
        var body = new byte[total + nItems * 2];
        int pos = 0;
        foreach (var p in batches)
        {{
            p.CopyTo(body, pos);
            pos += p.Length;
        }}
        var items = new ushort[nItems];
        Array.Fill(items, (ushort)Padding);
        items[nItems - 1] = (ushort)batches.Count;
        for (int i = 0; i < counts.Length; i++)
            items[nItems - 2 - i] = (ushort)counts[i];
        foreach (var it in items)
        {{
            body[pos++] = (byte)(it & 0xFF);
            body[pos++] = (byte)(it >> 8);
        }}
        return body;
    }}

    public static List<byte[]> Decode(byte[] body, int elementSize)
    {{
        if (body.Length < 2)
            throw new ArgumentException("body too small");
        int batchCount = body[^2] | (body[^1] << 8);
        if (batchCount == 0 || batchCount == Padding)
            throw new ArgumentException("bad batch count");
        int es = Math.Max(elementSize, 1);
        int tsize = TrailerSize(batchCount, es);
        if (tsize > body.Length)
            throw new ArgumentException("trailer exceeds body");
        int payloadLen = body.Length - tsize;
        var result = new List<byte[]>(batchCount);
        int pos = 0;
        for (int i = 0; i < batchCount; i++)
        {{
            int idx = body.Length - 2 * (i + 2);
            int count = body[idx] | (body[idx + 1] << 8);
            int size = count * elementSize;
            if (pos + size > payloadLen)
                throw new ArgumentException("payloads exceed body");
            result.Add(body[pos..(pos + size)]);
            pos += size;
        }}
        if (pos != payloadLen)
            throw new ArgumentException("trailing payload bytes");
        return result;
    }}
}}
"""

    client_cs = f"""// {HEADER}
//
// Client over the shared C ABI (native/libtb_client.so, `tbp_*`;
// ABI reference: clients/cpp/tb_client.hpp). Packet and body live in
// native memory: after a timeout the IO thread still owns the packet,
// so both are deliberately leaked (zombie parking) — the same
// discipline as the Go/C++/Python clients.
using System;
using System.Runtime.InteropServices;

namespace TigerBeetle.Tpu;

public sealed class Client : IDisposable
{{
    [StructLayout(LayoutKind.Sequential)]
    internal struct Packet
    {{
        public IntPtr Next;
        public IntPtr UserData;
        public ushort Operation;
        public byte Status;
        public byte Reserved;
        public uint DataSize;
        public IntPtr Data;
        public IntPtr Reply;
        public uint ReplySize;
    }}

    private const byte StatusPending = 0;
    private const byte StatusOk = 1;

    [DllImport("tb_client")]
    private static extern int tbp_client_init(out IntPtr handle,
        ulong cluster, byte[] clientId, string addresses,
        IntPtr onCompletion, IntPtr ctx);

    [DllImport("tb_client")]
    private static extern int tbp_client_init_echo(out IntPtr handle,
        ulong cluster, byte[] clientId, IntPtr onCompletion, IntPtr ctx);

    [DllImport("tb_client")]
    private static extern void tbp_client_submit(IntPtr handle,
        IntPtr packet);

    [DllImport("tb_client")]
    private static extern byte tbp_client_wait(IntPtr handle,
        IntPtr packet, uint timeoutMs);

    [DllImport("tb_client")]
    private static extern void tbp_client_packet_free(IntPtr packet);

    [DllImport("tb_client")]
    private static extern void tbp_client_deinit(IntPtr handle);

    private IntPtr _handle;

    private Client(IntPtr handle) => _handle = handle;

    private static byte[] IdBytes(UInt128 id)
    {{
        var b = new byte[16];
        Wire.PutU128(b, 0, id);
        return b;
    }}

    public static Client Connect(ulong cluster, UInt128 clientId,
                                 string addresses)
    {{
        int rc = tbp_client_init(out var h, cluster, IdBytes(clientId),
            addresses, IntPtr.Zero, IntPtr.Zero);
        if (rc != 0)
            throw new InvalidOperationException($"init failed: {{rc}}");
        return new Client(h);
    }}

    public static Client Echo(ulong cluster, UInt128 clientId)
    {{
        int rc = tbp_client_init_echo(out var h, cluster,
            IdBytes(clientId), IntPtr.Zero, IntPtr.Zero);
        if (rc != 0)
            throw new InvalidOperationException($"echo init: {{rc}}");
        return new Client(h);
    }}

    public byte[] Request(Operation operation, byte[] body,
                          uint timeoutMs = 10_000)
    {{
        if (_handle == IntPtr.Zero)
            throw new ObjectDisposedException(nameof(Client));
        IntPtr pkt = Marshal.AllocHGlobal(Marshal.SizeOf<Packet>());
        IntPtr data = IntPtr.Zero;
        var p = new Packet
        {{
            Operation = (ushort)(uint)operation,
            DataSize = (uint)body.Length,
        }};
        if (body.Length > 0)
        {{
            data = Marshal.AllocHGlobal(body.Length);
            Marshal.Copy(body, 0, data, body.Length);
            p.Data = data;
        }}
        Marshal.StructureToPtr(p, pkt, false);
        tbp_client_submit(_handle, pkt);
        byte status = tbp_client_wait(_handle, pkt, timeoutMs);
        if (status == StatusPending)
            throw new TimeoutException("request timed out");  // park pkt
        try
        {{
            if (status != StatusOk)
                throw new InvalidOperationException(
                    $"packet status {{status}}");
            var done = Marshal.PtrToStructure<Packet>(pkt);
            var reply = new byte[done.ReplySize];
            if (done.ReplySize > 0)
                Marshal.Copy(done.Reply, reply, 0, (int)done.ReplySize);
            tbp_client_packet_free(pkt);
            return reply;
        }}
        finally
        {{
            if (status != StatusPending)
            {{
                Marshal.FreeHGlobal(pkt);
                if (data != IntPtr.Zero) Marshal.FreeHGlobal(data);
            }}
        }}
    }}

    public void Dispose()
    {{
        if (_handle == IntPtr.Zero) return;
        tbp_client_deinit(_handle);
        _handle = IntPtr.Zero;
    }}
}}
"""

    mb_cases = []
    for payloads, es, encoded in _mb_vectors():
        ps = ", ".join(f'H("{p.hex()}")' for p in payloads)
        mb_cases.append(
            f'        Check(new[] {{ {ps} }}, {es}, "{encoded.hex()}");'
            if payloads else
            f'        Check(Array.Empty<byte[]>(), {es}, "{encoded.hex()}");')
    selftest_cs = f"""// {HEADER}
//
// Self-contained test entry (no framework dependency): golden parity
// vectors against the server's Python codecs. Run: dotnet run
using System;
using TigerBeetle.Tpu;

static byte[] H(string hex)
{{
    var outv = new byte[hex.Length / 2];
    for (int i = 0; i < outv.Length; i++)
        outv[i] = Convert.ToByte(hex.Substring(2 * i, 2), 16);
    return outv;
}}

static void Check(byte[][] payloads, int es, string encodedHex)
{{
    var encoded = H(encodedHex);
    var got = MultiBatch.Encode(payloads, es);
    if (!got.AsSpan().SequenceEqual(encoded))
        throw new Exception($"encode mismatch at es={{es}}");
    var back = MultiBatch.Decode(encoded, es);
    if (back.Count != payloads.Length)
        throw new Exception("decode count mismatch");
    for (int i = 0; i < back.Count; i++)
        if (!back[i].AsSpan().SequenceEqual(payloads[i]))
            throw new Exception($"decode payload {{i}}");
}}

var t = new Transfer
{{
    Id = UInt128.MaxValue - 1,
    DebitAccountId = 7,
    CreditAccountId = 8,
    Amount = (UInt128)1 << 127,
    Ledger = 700,
    Code = 10,
}};
var b = t.Pack();
if (b.Length != Transfer.Size) throw new Exception("Transfer size");
var back2 = Transfer.Unpack(b);
if (back2.Id != t.Id || back2.Amount != t.Amount
    || back2.Ledger != 700 || back2.Code != 10)
    throw new Exception("Transfer round trip");

{chr(10).join(mb_cases)}
Console.WriteLine("SelfTest OK");
"""

    csproj = """<!-- Generated package; compile-level CI runs wherever a
     net8.0 SDK exists. -->
<Project Sdk="Microsoft.NET.Sdk">
  <PropertyGroup>
    <OutputType>Exe</OutputType>
    <TargetFramework>net8.0</TargetFramework>
    <Nullable>enable</Nullable>
    <AssemblyName>TigerBeetle.Tpu</AssemblyName>
    <RootNamespace>TigerBeetle.Tpu</RootNamespace>
    <AllowUnsafeBlocks>true</AllowUnsafeBlocks>
  </PropertyGroup>
</Project>
"""

    return {
        "dotnet/Types.cs": types_cs,
        "dotnet/MultiBatch.cs": multibatch_cs,
        "dotnet/Client.cs": client_cs,
        "dotnet/SelfTest.cs": selftest_cs,
        "dotnet/TigerBeetle.Tpu.csproj": csproj,
    }
