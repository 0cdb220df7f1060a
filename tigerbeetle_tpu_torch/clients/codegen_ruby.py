"""Ruby client package emitter (reference: src/clients/ruby — codegen'd
type glue + a native wrapper over tb_client). Ruby Integers are
arbitrary-precision, so u128 amounts are exact; the client binds the
shared `tbp_*` C ABI with Fiddle (stdlib — no gem dependencies).
Layout parity is enforced offline by tests/test_torch_clients_codegen.py and
the embedded golden vectors; the minitest suite runs wherever a ruby
interpreter exists.

A copy of the JAX package's `clients/codegen_ruby.py`."""

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


def _struct_class(name: str) -> str:
    fields = [(f, k, o) for f, k, o in offsets(name)
              if not k.startswith("pad")]
    attrs = ", ".join(f":{f}" for f, _, _ in fields)
    defaults = "\n".join(f"        @{f} = opts.fetch(:{f}, 0)"
                         for f, _, _ in fields)
    packs = []
    for f, k, o in fields:
        if k == "u128":
            packs.append(f"    Wire.put_u128(b, {o}, @{f})")
        elif k == "u64":
            packs.append(f"    b[{o}, 8] = [@{f}].pack('Q<')")
        elif k == "u32":
            packs.append(f"    b[{o}, 4] = [@{f}].pack('L<')")
        else:
            packs.append(f"    b[{o}, 2] = [@{f}].pack('S<')")
    unpacks = []
    for f, k, o in fields:
        if k == "u128":
            unpacks.append(f"        {f}: Wire.get_u128(bytes, {o}),")
        elif k == "u64":
            unpacks.append(
                f"        {f}: bytes[{o}, 8].unpack1('Q<'),")
        elif k == "u32":
            unpacks.append(
                f"        {f}: bytes[{o}, 4].unpack1('L<'),")
        else:
            unpacks.append(
                f"        {f}: bytes[{o}, 2].unpack1('S<'),")
    packs_src = "\n".join(packs)
    unpacks_src = "\n".join(unpacks)
    return (
        f"  class {name}\n"
        f"    SIZE = {struct_size(name)}\n"
        f"    attr_accessor {attrs}\n\n"
        "    def initialize(opts = {})\n"
        f"{defaults}\n"
        "    end\n\n"
        "    def pack\n"
        "      b = (\"\\0\" * SIZE).b\n"
        f"{packs_src}\n"
        "      b\n"
        "    end\n\n"
        "    def self.unpack(bytes)\n"
        f"      raise ArgumentError, \"{name}: need #{{SIZE}} bytes\" \\\n"
        "        unless bytes.bytesize == SIZE\n"
        "      new(\n"
        f"{unpacks_src}\n"
        "      )\n"
        "    end\n"
        "  end\n")


def _enum_module(name: str, cls) -> str:
    consts = "\n".join(
        f"    {m.name.upper()} = {int(m)}" for m in cls)
    pairs = ", ".join(f"{int(m)} => :{m.name}" for m in cls)
    return f"""  module {name}
{consts}

    NAMES = {{ {pairs} }}.freeze

    def self.name_of(value)
      NAMES.fetch(value) {{ :"unknown_#{{value}}" }}
    end
  end
"""


def _flags_module(name: str, cls) -> str:
    consts = "\n".join(
        f"    {m.name.upper()} = {int(m.value)}" for m in cls)
    return f"  module {name}\n{consts}\n  end\n"


def generate_ruby() -> dict[str, str]:
    structs = "\n".join(_struct_class(n) for n in LAYOUTS)
    enums = "\n".join(_enum_module(n, c) for n, c in ENUMS.items())
    flags = "\n".join(_flags_module(n, c) for n, c in FLAGS.items())

    types_rb = f"""# {HEADER}
#
# Wire types for the tigerbeetle_tpu cluster protocol (little-endian
# fixed layouts; reference data model: src/tigerbeetle.zig:10-148).
# frozen_string_literal: false

module TigerBeetleTpu
  module Wire
    def put_u128(b, off, v)
      b[off, 16] = [v & 0xFFFFFFFFFFFFFFFF, v >> 64].pack('Q<Q<')
    end

    def get_u128(bytes, off)
      lo, hi = bytes[off, 16].unpack('Q<Q<')
      (hi << 64) | lo
    end

    module_function :put_u128, :get_u128
  end

{structs}
{enums}
{flags}end
"""

    multibatch_rb = f"""# {HEADER}
#
# Multi-batch wire codec (reference: src/vsr/multi_batch.zig:1-41).
# frozen_string_literal: true

module TigerBeetleTpu
  module MultiBatch
    PADDING = 0xFFFF

    def self.trailer_size(batch_count, element_size)
      raw = (batch_count + 1) * 2
      return raw if element_size <= 1
      (raw + element_size - 1) / element_size * element_size
    end

    def self.encode(batches, element_size)
      raise ArgumentError, 'batch count out of range' \\
        if batches.empty? || batches.size > 0xFFFE
      counts = batches.each_with_index.map do |p, i|
        if element_size.positive? && p.bytesize % element_size != 0
          raise ArgumentError, "payload #{{i}} not element-aligned"
        end
        c = element_size.positive? ? p.bytesize / element_size : 0
        raise ArgumentError, 'count exceeds u16' if c > 0xFFFE
        c
      end
      es = [element_size, 1].max
      n_items = trailer_size(batches.size, es) / 2
      items = Array.new(n_items, PADDING)
      items[n_items - 1] = batches.size
      counts.each_with_index {{ |c, i| items[n_items - 2 - i] = c }}
      (batches.join + items.pack('S<*')).b
    end

    def self.decode(body, element_size)
      raise ArgumentError, 'body too small' if body.bytesize < 2
      batch_count = body[-2, 2].unpack1('S<')
      raise ArgumentError, 'bad batch count' \\
        if batch_count.zero? || batch_count == PADDING
      es = [element_size, 1].max
      tsize = trailer_size(batch_count, es)
      raise ArgumentError, 'trailer exceeds body' if tsize > body.bytesize
      payload_len = body.bytesize - tsize
      pos = 0
      out = Array.new(batch_count) do |i|
        idx = body.bytesize - 2 * (i + 2)
        count = body[idx, 2].unpack1('S<')
        size = count * element_size
        raise ArgumentError, 'payloads exceed body' \\
          if pos + size > payload_len
        piece = body[pos, size]
        pos += size
        piece
      end
      raise ArgumentError, 'trailing payload bytes' if pos != payload_len
      out
    end
  end
end
"""

    client_rb = f"""# {HEADER}
#
# Client over the shared C ABI (native/libtb_client.so, `tbp_*`; ABI
# reference: clients/cpp/tb_client.hpp), bound with stdlib Fiddle.
# Packet and body live in native memory: after a timeout the IO thread
# still owns the packet, so both are deliberately leaked (zombie
# parking) — the same discipline as the Go/C++/Python clients.
# frozen_string_literal: true

require 'fiddle'
require 'fiddle/import'

module TigerBeetleTpu
  module ABI
    extend Fiddle::Importer
    dlload ENV.fetch('TB_CLIENT_LIB', 'libtb_client.so')

    # struct tbp_packet: next(0,8) user_data(8,8) operation(16,2)
    # status(18,1) reserved(19,1) data_size(20,4) data(24,8)
    # reply(32,8) reply_size(40,4) pad(44,4)
    PACKET_SIZE = 48
    OFF_OPERATION = 16
    OFF_STATUS = 18
    OFF_DATA_SIZE = 20
    OFF_DATA = 24
    OFF_REPLY = 32
    OFF_REPLY_SIZE = 40
    STATUS_PENDING = 0
    STATUS_OK = 1

    extern 'int tbp_client_init(void*, unsigned long long, void*, ' \\
           'const char*, void*, void*)'
    extern 'int tbp_client_init_echo(void*, unsigned long long, ' \\
           'void*, void*, void*)'
    extern 'void tbp_client_submit(void*, void*)'
    extern 'unsigned char tbp_client_wait(void*, void*, unsigned int)'
    extern 'void tbp_client_packet_free(void*)'
    extern 'void tbp_client_deinit(void*)'
  end

  class Client
    def initialize(handle)
      @handle = handle
    end

    def self.id_bytes(id)
      [id & 0xFFFFFFFFFFFFFFFF, id >> 64].pack('Q<Q<')
    end

    def self.connect(cluster, client_id, addresses)
      out = Fiddle::Pointer.malloc(Fiddle::SIZEOF_VOIDP)
      rc = ABI.tbp_client_init(out, cluster, id_bytes(client_id),
                               addresses, nil, nil)
      raise "tbp_client_init: #{{rc}}" unless rc.zero?
      new(out.ptr)
    end

    def self.echo(cluster, client_id)
      out = Fiddle::Pointer.malloc(Fiddle::SIZEOF_VOIDP)
      rc = ABI.tbp_client_init_echo(out, cluster, id_bytes(client_id),
                                    nil, nil)
      raise "tbp_client_init_echo: #{{rc}}" unless rc.zero?
      new(out.ptr)
    end

    def request(operation, body, timeout_ms: 10_000)
      raise 'client is closed' unless @handle
      pkt = Fiddle::Pointer.malloc(ABI::PACKET_SIZE, Fiddle::RUBY_FREE)
      pkt[0, ABI::PACKET_SIZE] = "\\0" * ABI::PACKET_SIZE
      pkt[ABI::OFF_OPERATION, 2] = [operation].pack('S<')
      pkt[ABI::OFF_DATA_SIZE, 4] = [body.bytesize].pack('L<')
      data = nil
      unless body.empty?
        data = Fiddle::Pointer.malloc(body.bytesize, Fiddle::RUBY_FREE)
        data[0, body.bytesize] = body
        pkt[ABI::OFF_DATA, 8] = [data.to_i].pack('Q<')
      end
      ABI.tbp_client_submit(@handle, pkt)
      status = ABI.tbp_client_wait(@handle, pkt, timeout_ms)
      if status == ABI::STATUS_PENDING
        # IO thread still owns the packet: park both allocations.
        pkt.free = nil
        data&.free = nil
        raise 'request timed out'
      end
      raise "packet status #{{status}}" unless status == ABI::STATUS_OK
      len = pkt[ABI::OFF_REPLY_SIZE, 4].unpack1('L<')
      reply_ptr = Fiddle::Pointer.new(pkt[ABI::OFF_REPLY, 8].unpack1('Q<'))
      reply = len.zero? ? (+'').b : reply_ptr[0, len]
      ABI.tbp_client_packet_free(pkt)
      reply
    end

    def close
      return unless @handle
      ABI.tbp_client_deinit(@handle)
      @handle = nil
    end
  end
end
"""

    mb_cases = []
    for payloads, es, encoded in _mb_vectors():
        ps = ", ".join(f"h('{p.hex()}')" for p in payloads)
        mb_cases.append(
            f"    check([{ps}], {es}, h('{encoded.hex()}'))")
    test_rb = f"""# {HEADER}
#
# Golden parity vectors against the server's Python codecs (minitest is
# in the Ruby stdlib — run: ruby test/test_wire.rb).
# frozen_string_literal: true

require 'minitest/autorun'
require_relative '../lib/tigerbeetle_tpu/types'
require_relative '../lib/tigerbeetle_tpu/multi_batch'

class TestWire < Minitest::Test
  def h(hex)
    [hex].pack('H*')
  end

  def check(payloads, es, encoded)
    assert_equal encoded, TigerBeetleTpu::MultiBatch.encode(payloads, es)
    back = TigerBeetleTpu::MultiBatch.decode(encoded, es)
    assert_equal payloads.size, back.size
    payloads.zip(back) {{ |want, got| assert_equal want, got }}
  end

  def test_transfer_round_trip
    t = TigerBeetleTpu::Transfer.new(
      id: (1 << 128) - 2, debit_account_id: 7, credit_account_id: 8,
      amount: 1 << 127, ledger: 700, code: 10
    )
    b = t.pack
    assert_equal TigerBeetleTpu::Transfer::SIZE, b.bytesize
    back = TigerBeetleTpu::Transfer.unpack(b)
    assert_equal t.id, back.id
    assert_equal t.amount, back.amount
    assert_equal 700, back.ledger
    assert_equal 10, back.code
  end

  def test_multibatch_golden_vectors
{chr(10).join(mb_cases)}
  end
end
"""

    gemspec = """# Generated package; compile-level CI runs wherever a
# ruby interpreter exists (stdlib only: Fiddle + minitest).
Gem::Specification.new do |s|
  s.name = 'tigerbeetle_tpu'
  s.version = '0.2.0'
  s.summary = 'Ruby client for the tigerbeetle_tpu cluster protocol'
  s.authors = ['tigerbeetle_tpu']
  s.files = Dir['lib/**/*.rb']
  s.license = 'Apache-2.0'
  s.required_ruby_version = '>= 3.0'
end
"""

    gem = "tigerbeetle_tpu"  # the gem's name, as the JAX package emits it
    return {
        f"ruby/lib/{gem}/types.rb": types_rb,
        f"ruby/lib/{gem}/multi_batch.rb": multibatch_rb,
        f"ruby/lib/{gem}/client.rb": client_rb,
        "ruby/test/test_wire.rb": test_rb,
        f"ruby/{gem}.gemspec": gemspec,
    }
