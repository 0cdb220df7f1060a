"""Java client package emitter (reference: src/clients/java — codegen'd
type glue + JNI wrapper, java/src/jni.zig). The rebuild's Java client
binds the same shared `tbp_*` C ABI via java.lang.foreign (JDK 22+
FFM — no hand-written JNI layer needed), and derives every layout from
the shared tables in codegen.py. Compile-level CI runs wherever a JDK
exists; layout parity is enforced offline by tests/test_torch_clients_codegen.py
and the embedded golden vectors (clients/conformance.json is the same
contract, machine-readable).

A copy of the JAX package's `clients/codegen_java.py`."""

from __future__ import annotations

from .codegen import (
    C_ABI_FUNCTIONS,
    ENUMS,
    FLAGS,
    HEADER,
    LAYOUTS,
    _mb_vectors,
    offsets,
    struct_size,
)


def _camel(snake: str) -> str:
    parts = snake.split("_")
    return parts[0] + "".join(p.capitalize() for p in parts[1:])


def _jtype(kind: str) -> str:
    # u128 -> BigInteger (Java has no unsigned; BigInteger keeps financial
    # amounts exact); u64 -> long (documented unsigned, callers use
    # Long.compareUnsigned); u32 -> int; u16 -> int (avoids short-sign
    # traps at call sites).
    return {"u128": "java.math.BigInteger", "u64": "long",
            "u32": "int", "u16": "int"}[kind]


def _pack_stmt(field: str, kind: str, off: int) -> str:
    g = _camel(field)
    if kind == "u128":
        return f"        putU128(b, {off}, {g});"
    if kind == "u64":
        return f"        b.putLong({off}, {g});"
    if kind == "u32":
        return f"        b.putInt({off}, {g});"
    return f"        b.putShort({off}, (short) {g});"


def _unpack_expr(kind: str, off: int) -> str:
    if kind == "u128":
        return f"getU128(b, {off})"
    if kind == "u64":
        return f"b.getLong({off})"
    if kind == "u32":
        return f"b.getInt({off})"
    return f"b.getShort({off}) & 0xFFFF"


def _struct_class(name: str) -> str:
    fields = [(f, k, o) for f, k, o in offsets(name)
              if not k.startswith("pad")]
    decls = "\n".join(f"    public {_jtype(k)} {_camel(f)}"
                      + (" = java.math.BigInteger.ZERO;"
                         if k == "u128" else ";")
                      for f, k, _ in fields)
    packs = "\n".join(_pack_stmt(f, k, o) for f, k, o in fields)
    unpacks = "\n".join(
        f"        out.{_camel(f)} = {_unpack_expr(k, o)};"
        for f, k, o in fields)
    return f"""    public static final class {name} {{
        public static final int SIZE = {struct_size(name)};
{decls}

        public byte[] pack() {{
            ByteBuffer b = ByteBuffer.allocate(SIZE)
                .order(ByteOrder.LITTLE_ENDIAN);
{packs}
            return b.array();
        }}

        public static {name} unpack(byte[] bytes) {{
            if (bytes.length != SIZE)
                throw new IllegalArgumentException(
                    "{name}: need " + SIZE + " bytes, got " + bytes.length);
            ByteBuffer b = ByteBuffer.wrap(bytes)
                .order(ByteOrder.LITTLE_ENDIAN);
            {name} out = new {name}();
{unpacks}
            return out;
        }}
    }}"""


def _enum_class(name: str, cls) -> str:
    consts = "\n".join(
        f"        public static final int {m.name.upper()} = {int(m)};"
        for m in cls)
    cases = "\n".join(
        f'            case {int(m)}: return "{m.name}";' for m in cls)
    return f"""    public static final class {name} {{
{consts}

        public static String name(int value) {{
            switch (value) {{
{cases}
            }}
            return "unknown(" + value + ")";
        }}
    }}"""


def _flags_class(name: str, cls) -> str:
    consts = "\n".join(
        f"        public static final int {m.name.upper()} = "
        f"{int(m.value)};" for m in cls)
    return f"""    public static final class {name} {{
{consts}
    }}"""


def generate_java() -> dict[str, str]:
    pkg = "com.tigerbeetle.tpu"
    structs = "\n\n".join(_struct_class(n) for n in LAYOUTS)
    enums = "\n\n".join(_enum_class(n, c) for n, c in ENUMS.items())
    flags = "\n\n".join(_flags_class(n, c) for n, c in FLAGS.items())

    types_java = f"""// {HEADER}
//
// Wire types for the tigerbeetle_tpu cluster protocol (little-endian
// fixed layouts; reference data model: src/tigerbeetle.zig:10-148).
package {pkg};

import java.nio.ByteBuffer;
import java.nio.ByteOrder;

public final class Types {{
    private Types() {{}}

    static void putU128(ByteBuffer b, int off, java.math.BigInteger v) {{
        byte[] be = v.toByteArray();
        for (int i = 0; i < 16; i++) {{
            int src = be.length - 1 - i;
            b.put(off + i, src >= 0 ? be[src] : 0);
        }}
    }}

    static java.math.BigInteger getU128(ByteBuffer b, int off) {{
        byte[] be = new byte[17];  // leading zero keeps it non-negative
        for (int i = 0; i < 16; i++) {{
            be[16 - i] = b.get(off + i);
        }}
        return new java.math.BigInteger(be);
    }}

{structs}

{enums}

{flags}
}}
"""

    multibatch_java = f"""// {HEADER}
//
// Multi-batch wire codec (reference: src/vsr/multi_batch.zig:1-41).
package {pkg};

import java.io.ByteArrayOutputStream;
import java.util.ArrayList;
import java.util.List;

public final class MultiBatch {{
    private MultiBatch() {{}}

    private static final int PADDING = 0xFFFF;

    static int trailerSize(int batchCount, int elementSize) {{
        int raw = (batchCount + 1) * 2;
        if (elementSize <= 1) return raw;
        return (raw + elementSize - 1) / elementSize * elementSize;
    }}

    public static byte[] encode(List<byte[]> batches, int elementSize) {{
        if (batches.isEmpty() || batches.size() > 0xFFFE)
            throw new IllegalArgumentException("batch count out of range");
        ByteArrayOutputStream body = new ByteArrayOutputStream();
        int[] counts = new int[batches.size()];
        for (int i = 0; i < batches.size(); i++) {{
            byte[] p = batches.get(i);
            if (elementSize > 0 && p.length % elementSize != 0)
                throw new IllegalArgumentException(
                    "payload " + i + " not element-aligned");
            counts[i] = elementSize > 0 ? p.length / elementSize : 0;
            if (counts[i] > 0xFFFE)
                throw new IllegalArgumentException("count exceeds u16");
            body.writeBytes(p);
        }}
        int es = Math.max(elementSize, 1);
        int nItems = trailerSize(batches.size(), es) / 2;
        int[] items = new int[nItems];
        java.util.Arrays.fill(items, PADDING);
        items[nItems - 1] = batches.size();
        for (int i = 0; i < counts.length; i++)
            items[nItems - 2 - i] = counts[i];
        for (int it : items) {{
            body.write(it & 0xFF);
            body.write((it >> 8) & 0xFF);
        }}
        return body.toByteArray();
    }}

    public static List<byte[]> decode(byte[] body, int elementSize) {{
        if (body.length < 2)
            throw new IllegalArgumentException("body too small");
        int batchCount = (body[body.length - 2] & 0xFF)
            | ((body[body.length - 1] & 0xFF) << 8);
        if (batchCount == 0 || batchCount == PADDING)
            throw new IllegalArgumentException("bad batch count");
        int es = Math.max(elementSize, 1);
        int tsize = trailerSize(batchCount, es);
        if (tsize > body.length)
            throw new IllegalArgumentException("trailer exceeds body");
        int payloadLen = body.length - tsize;
        List<byte[]> out = new ArrayList<>(batchCount);
        int pos = 0;
        for (int i = 0; i < batchCount; i++) {{
            int idx = body.length - 2 * (i + 2);
            int count = (body[idx] & 0xFF) | ((body[idx + 1] & 0xFF) << 8);
            int size = count * elementSize;
            if (pos + size > payloadLen)
                throw new IllegalArgumentException("payloads exceed body");
            out.add(java.util.Arrays.copyOfRange(body, pos, pos + size));
            pos += size;
        }}
        if (pos != payloadLen)
            throw new IllegalArgumentException("trailing payload bytes");
        return out;
    }}
}}
"""

    client_java = f"""// {HEADER}
//
// Client over the shared C ABI (native/libtb_client.so, `tbp_*`),
// bound with java.lang.foreign — the FFM replacement for the
// reference's hand-written JNI layer (src/clients/java/src/jni.zig).
// ABI: clients/cpp/tb_client.hpp / clients/conformance.json.
package {pkg};

import java.lang.foreign.*;
import java.lang.invoke.MethodHandle;

public final class Client implements AutoCloseable {{
    private static final Linker LINKER = Linker.nativeLinker();
    private static final SymbolLookup LIB =
        SymbolLookup.libraryLookup("tb_client", Arena.global());

    // struct tbp_packet (64-bit natural alignment):
    //   next(0,8) user_data(8,8) operation(16,2) status(18,1)
    //   reserved(19,1) data_size(20,4) data(24,8) reply(32,8)
    //   reply_size(40,4) pad(44,4)
    static final long PKT_SIZE = 48;
    static final long OFF_OPERATION = 16, OFF_STATUS = 18,
        OFF_DATA_SIZE = 20, OFF_DATA = 24, OFF_REPLY = 32,
        OFF_REPLY_SIZE = 40;
    static final int STATUS_PENDING = 0, STATUS_OK = 1;

    private static MethodHandle fn(String name, FunctionDescriptor d) {{
        return LINKER.downcallHandle(LIB.find(name).orElseThrow(
            () -> new UnsatisfiedLinkError(name)), d);
    }}

    private static final MethodHandle INIT = fn("tbp_client_init",
        FunctionDescriptor.of(ValueLayout.JAVA_INT, ValueLayout.ADDRESS,
            ValueLayout.JAVA_LONG, ValueLayout.ADDRESS,
            ValueLayout.ADDRESS, ValueLayout.ADDRESS,
            ValueLayout.ADDRESS));
    private static final MethodHandle INIT_ECHO = fn(
        "tbp_client_init_echo",
        FunctionDescriptor.of(ValueLayout.JAVA_INT, ValueLayout.ADDRESS,
            ValueLayout.JAVA_LONG, ValueLayout.ADDRESS,
            ValueLayout.ADDRESS, ValueLayout.ADDRESS));
    private static final MethodHandle SUBMIT = fn("tbp_client_submit",
        FunctionDescriptor.ofVoid(ValueLayout.ADDRESS,
            ValueLayout.ADDRESS));
    private static final MethodHandle WAIT = fn("tbp_client_wait",
        FunctionDescriptor.of(ValueLayout.JAVA_BYTE, ValueLayout.ADDRESS,
            ValueLayout.ADDRESS, ValueLayout.JAVA_INT));
    private static final MethodHandle PACKET_FREE = fn(
        "tbp_client_packet_free",
        FunctionDescriptor.ofVoid(ValueLayout.ADDRESS));
    private static final MethodHandle DEINIT = fn("tbp_client_deinit",
        FunctionDescriptor.ofVoid(ValueLayout.ADDRESS));

    private MemorySegment handle;

    private Client(MemorySegment handle) {{
        this.handle = handle;
    }}

    private static MemorySegment clientId(Arena a, java.math.BigInteger id) {{
        MemorySegment seg = a.allocate(16);
        byte[] be = id.toByteArray();
        for (int i = 0; i < 16; i++) {{
            int src = be.length - 1 - i;
            seg.set(ValueLayout.JAVA_BYTE, i, src >= 0 ? be[src] : 0);
        }}
        return seg;
    }}

    /** Connect to a cluster: addresses like "127.0.0.1:3001,...". */
    public static Client connect(long cluster, java.math.BigInteger id,
                                 String addresses) {{
        try (Arena a = Arena.ofConfined()) {{
            MemorySegment out = a.allocate(ValueLayout.ADDRESS);
            int rc = (int) INIT.invoke(out, cluster, clientId(a, id),
                a.allocateFrom(addresses), MemorySegment.NULL,
                MemorySegment.NULL);
            if (rc != 0)
                throw new IllegalStateException("tbp_client_init: " + rc);
            return new Client(out.get(ValueLayout.ADDRESS, 0));
        }} catch (RuntimeException e) {{
            throw e;
        }} catch (Throwable t) {{
            throw new RuntimeException(t);
        }}
    }}

    /** In-process echo client (reference tb_client init_echo). */
    public static Client echo(long cluster, java.math.BigInteger id) {{
        try (Arena a = Arena.ofConfined()) {{
            MemorySegment out = a.allocate(ValueLayout.ADDRESS);
            int rc = (int) INIT_ECHO.invoke(out, cluster,
                clientId(a, id), MemorySegment.NULL, MemorySegment.NULL);
            if (rc != 0)
                throw new IllegalStateException(
                    "tbp_client_init_echo: " + rc);
            return new Client(out.get(ValueLayout.ADDRESS, 0));
        }} catch (RuntimeException e) {{
            throw e;
        }} catch (Throwable t) {{
            throw new RuntimeException(t);
        }}
    }}

    /** Submit one operation body and block for the reply.
     *
     * Packet and body live in a shared arena: after a timeout the
     * native IO thread STILL owns the packet (it resends and
     * eventually writes the completion into it), so the arena is
     * deliberately leaked on timeout — the same zombie-parking
     * discipline as the Go/C++/Python clients. */
    public byte[] request(int operation, byte[] body, int timeoutMs) {{
        if (handle == null)
            throw new IllegalStateException("client is closed");
        Arena pa = Arena.ofShared();
        try {{
            MemorySegment pkt = pa.allocate(PKT_SIZE);
            pkt.fill((byte) 0);
            pkt.set(ValueLayout.JAVA_SHORT, OFF_OPERATION,
                (short) operation);
            pkt.set(ValueLayout.JAVA_INT, OFF_DATA_SIZE, body.length);
            if (body.length > 0) {{
                MemorySegment buf = pa.allocate(body.length);
                MemorySegment.copy(body, 0, buf, ValueLayout.JAVA_BYTE,
                    0, body.length);
                pkt.set(ValueLayout.ADDRESS, OFF_DATA, buf);
            }}
            SUBMIT.invoke(handle, pkt);
            byte status = (byte) WAIT.invoke(handle, pkt, timeoutMs);
            if (status == STATUS_PENDING) {{
                pa = null;  // IO thread owns the packet: park it
                throw new IllegalStateException("request timed out");
            }}
            if (status != STATUS_OK)
                throw new IllegalStateException(
                    "packet status " + status);
            int len = pkt.get(ValueLayout.JAVA_INT, OFF_REPLY_SIZE);
            MemorySegment reply = pkt.get(ValueLayout.ADDRESS, OFF_REPLY)
                .reinterpret(len);
            byte[] outBytes = new byte[len];
            MemorySegment.copy(reply, ValueLayout.JAVA_BYTE, 0,
                outBytes, 0, len);
            PACKET_FREE.invoke(pkt);
            return outBytes;
        }} catch (RuntimeException e) {{
            throw e;
        }} catch (Throwable t) {{
            throw new RuntimeException(t);
        }} finally {{
            if (pa != null)
                pa.close();
        }}
    }}

    @Override
    public void close() {{
        if (handle == null)
            return;
        try {{
            DEINIT.invoke(handle);
        }} catch (Throwable t) {{
            throw new RuntimeException(t);
        }}
        handle = null;
    }}
}}
"""

    mb_cases = []
    for payloads, es, encoded in _mb_vectors():
        ps = ", ".join(f'h("{p.hex()}")' for p in payloads)
        mb_cases.append(
            f"        check(java.util.List.of({ps}), {es}, "
            f'h("{encoded.hex()}"));')
    test_java = f"""// {HEADER}
//
// Self-contained test main (no framework dependency): golden parity
// vectors against the server's Python codecs. Run:
//   java -cp target/classes {pkg}.SelfTest
package {pkg};

public final class SelfTest {{
    private SelfTest() {{}}

    static byte[] h(String hex) {{
        byte[] out = new byte[hex.length() / 2];
        for (int i = 0; i < out.length; i++)
            out[i] = (byte) Integer.parseInt(
                hex.substring(2 * i, 2 * i + 2), 16);
        return out;
    }}

    static void check(java.util.List<byte[]> payloads, int es,
                      byte[] encoded) {{
        byte[] got = MultiBatch.encode(payloads, es);
        if (!java.util.Arrays.equals(got, encoded))
            throw new AssertionError("encode mismatch at es=" + es);
        java.util.List<byte[]> back = MultiBatch.decode(encoded, es);
        if (back.size() != payloads.size())
            throw new AssertionError("decode count mismatch");
        for (int i = 0; i < back.size(); i++)
            if (!java.util.Arrays.equals(back.get(i), payloads.get(i)))
                throw new AssertionError("decode payload " + i);
    }}

    public static void main(String[] args) {{
        // struct round trip with all-byte-spanning sentinels
        Types.Transfer t = new Types.Transfer();
        t.id = new java.math.BigInteger("340282366920938463463374607431768211454");
        t.debitAccountId = java.math.BigInteger.valueOf(7);
        t.creditAccountId = java.math.BigInteger.valueOf(8);
        t.amount = java.math.BigInteger.ONE.shiftLeft(127);
        t.ledger = 700; t.code = 10;
        byte[] b = t.pack();
        if (b.length != Types.Transfer.SIZE)
            throw new AssertionError("Transfer size");
        Types.Transfer back = Types.Transfer.unpack(b);
        if (!back.id.equals(t.id) || !back.amount.equals(t.amount)
            || back.ledger != 700 || back.code != 10)
            throw new AssertionError("Transfer round trip");

{chr(10).join(mb_cases)}
        System.out.println("SelfTest OK");
    }}
}}
"""

    pom_xml = """<?xml version="1.0" encoding="UTF-8"?>
<!-- Generated package; compile-level CI runs wherever a JDK >= 22
     exists (java.lang.foreign). -->
<project xmlns="http://maven.apache.org/POM/4.0.0">
  <modelVersion>4.0.0</modelVersion>
  <groupId>com.tigerbeetle</groupId>
  <artifactId>tigerbeetle-tpu</artifactId>
  <version>0.2.0</version>
  <packaging>jar</packaging>
  <properties>
    <maven.compiler.source>22</maven.compiler.source>
    <maven.compiler.target>22</maven.compiler.target>
    <project.build.sourceEncoding>UTF-8</project.build.sourceEncoding>
  </properties>
</project>
"""

    base = "java/src/main/java/com/tigerbeetle/tpu"
    return {
        f"{base}/Types.java": types_java,
        f"{base}/MultiBatch.java": multibatch_java,
        f"{base}/Client.java": client_java,
        f"{base}/SelfTest.java": test_java,
        "java/pom.xml": pom_xml,
    }


assert C_ABI_FUNCTIONS  # referenced by the generated Client binding
