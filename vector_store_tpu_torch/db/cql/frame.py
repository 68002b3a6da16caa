"""CQL binary protocol v4 wire format: frame header + primitive notations.

Spec: native_protocol_v4.spec (public Cassandra document). 9-byte header:
version, flags, stream (i16), opcode, body length (i32), then the body.
"""

from __future__ import annotations

import io
import ipaddress
import struct

VERSION_REQUEST = 0x04
VERSION_RESPONSE = 0x84

# opcodes
OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_OPTIONS = 0x05
OP_SUPPORTED = 0x06
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_PREPARE = 0x09
OP_EXECUTE = 0x0A
OP_REGISTER = 0x0B
OP_EVENT = 0x0C
OP_BATCH = 0x0D
OP_AUTH_CHALLENGE = 0x0E
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

# result kinds
RESULT_VOID = 0x0001
RESULT_ROWS = 0x0002
RESULT_SET_KEYSPACE = 0x0003
RESULT_PREPARED = 0x0004
RESULT_SCHEMA_CHANGE = 0x0005

# consistency
CL_ONE = 0x0001
CL_QUORUM = 0x0004
CL_LOCAL_QUORUM = 0x0006
CL_LOCAL_ONE = 0x000A

HEADER = struct.Struct("!BBhBi")


def encode_frame(opcode: int, stream: int, body: bytes, version: int = VERSION_REQUEST) -> bytes:
    return HEADER.pack(version, 0, stream, opcode, len(body)) + body


def decode_header(data: bytes) -> tuple[int, int, int, int, int]:
    """(version, flags, stream, opcode, length)"""
    return HEADER.unpack(data)


class Writer:
    def __init__(self) -> None:
        self.buf = io.BytesIO()

    def bytes_(self) -> bytes:
        return self.buf.getvalue()

    def byte(self, v: int) -> "Writer":
        self.buf.write(struct.pack("!B", v))
        return self

    def short(self, v: int) -> "Writer":
        self.buf.write(struct.pack("!H", v))
        return self

    def int_(self, v: int) -> "Writer":
        self.buf.write(struct.pack("!i", v))
        return self

    def long_(self, v: int) -> "Writer":
        self.buf.write(struct.pack("!q", v))
        return self

    def string(self, s: str) -> "Writer":
        b = s.encode("utf-8")
        self.short(len(b))
        self.buf.write(b)
        return self

    def long_string(self, s: str) -> "Writer":
        b = s.encode("utf-8")
        self.int_(len(b))
        self.buf.write(b)
        return self

    def string_map(self, m: dict[str, str]) -> "Writer":
        self.short(len(m))
        for k, v in m.items():
            self.string(k)
            self.string(v)
        return self

    def bytes_value(self, b: bytes | None) -> "Writer":
        if b is None:
            self.int_(-1)
        else:
            self.int_(len(b))
            self.buf.write(b)
        return self

    def short_bytes(self, b: bytes) -> "Writer":
        self.short(len(b))
        self.buf.write(b)
        return self

    def raw(self, b: bytes) -> "Writer":
        self.buf.write(b)
        return self


class Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def byte(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def short(self) -> int:
        (v,) = struct.unpack_from("!H", self.data, self.pos)
        self.pos += 2
        return v

    def int_(self) -> int:
        (v,) = struct.unpack_from("!i", self.data, self.pos)
        self.pos += 4
        return v

    def long_(self) -> int:
        (v,) = struct.unpack_from("!q", self.data, self.pos)
        self.pos += 8
        return v

    def string(self) -> str:
        n = self.short()
        s = self.data[self.pos : self.pos + n].decode("utf-8")
        self.pos += n
        return s

    def long_string(self) -> str:
        n = self.int_()
        s = self.data[self.pos : self.pos + n].decode("utf-8")
        self.pos += n
        return s

    def string_list(self) -> list[str]:
        return [self.string() for _ in range(self.short())]

    def string_map(self) -> dict[str, str]:
        return {self.string(): self.string() for _ in range(self.short())}

    def string_multimap(self) -> dict[str, list[str]]:
        return {self.string(): self.string_list() for _ in range(self.short())}

    def bytes_value(self) -> bytes | None:
        n = self.int_()
        if n < 0:
            return None
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def short_bytes(self) -> bytes:
        n = self.short()
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def inet(self) -> tuple[str, int]:
        n = self.byte()
        addr = bytes(self.data[self.pos : self.pos + n])
        self.pos += n
        port = self.int_()
        return str(ipaddress.ip_address(addr)), port
