"""Bit-level RBSP writer/reader + exp-Golomb codes.

Host-side serialization layer (ref: TComBitStream.cpp:1-388,
SyntaxElementWriter/Parser). Emulation prevention (RBSP -> EBSP) is applied at
NAL packaging time in nal.py, not here.
"""
from __future__ import annotations


class BitWriter:
    """MSB-first bit writer (TComOutputBitstream semantics)."""

    def __init__(self) -> None:
        self.out = bytearray()
        self._held = 0          # bits accumulated, < 8
        self._held_bits = 0

    def write(self, value: int, num_bits: int) -> None:
        assert num_bits <= 32
        value &= (1 << num_bits) - 1 if num_bits < 32 else 0xFFFFFFFF
        bits = self._held_bits + num_bits
        acc = (self._held << num_bits) | value
        while bits >= 8:
            bits -= 8
            self.out.append((acc >> bits) & 0xFF)
        self._held = acc & ((1 << bits) - 1)
        self._held_bits = bits

    def write_flag(self, flag: int) -> None:
        self.write(1 if flag else 0, 1)

    def write_ue(self, value: int) -> None:
        """Unsigned exp-Golomb (H.265 9.2)."""
        assert value >= 0
        code = value + 1
        length = code.bit_length()
        self.write(0, length - 1)
        self.write(code, length)

    def write_se(self, value: int) -> None:
        """Signed exp-Golomb."""
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    def write_byte_alignment(self) -> None:
        """rbsp stop-one bit + zero alignment."""
        self.write(1, 1)
        if self._held_bits:
            self.write(0, 8 - self._held_bits)

    def align_zero(self) -> None:
        if self._held_bits:
            self.write(0, 8 - self._held_bits)

    def write_bytes(self, data: bytes) -> None:
        assert self._held_bits == 0
        self.out.extend(data)

    @property
    def num_bits(self) -> int:
        return len(self.out) * 8 + self._held_bits

    def get_bytes(self) -> bytes:
        assert self._held_bits == 0, "not byte aligned"
        return bytes(self.out)


class BitReader:
    """MSB-first bit reader over an RBSP payload."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.bit_pos = 0

    def read(self, num_bits: int) -> int:
        v = 0
        for _ in range(num_bits):
            byte = self.data[self.bit_pos >> 3] if (
                self.bit_pos >> 3) < len(self.data) else 0
            v = (v << 1) | ((byte >> (7 - (self.bit_pos & 7))) & 1)
            self.bit_pos += 1
        return v

    def read_flag(self) -> int:
        return self.read(1)

    def read_ue(self) -> int:
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("invalid ue(v)")
        return (1 << zeros) - 1 + self.read(zeros) if zeros else 0

    def read_se(self) -> int:
        v = self.read_ue()
        return (v + 1) >> 1 if v & 1 else -(v >> 1)

    def byte_align(self) -> None:
        self.bit_pos = (self.bit_pos + 7) & ~7

    @property
    def byte_pos(self) -> int:
        assert self.bit_pos % 8 == 0
        return self.bit_pos >> 3

    def more_rbsp_data(self) -> bool:
        """True if there is payload beyond the rbsp trailing bits."""
        nbits = len(self.data) * 8
        if self.bit_pos >= nbits:
            return False
        # find last set bit in stream = rbsp stop bit
        last = len(self.data) - 1
        while last >= 0 and self.data[last] == 0:
            last -= 1
        if last < 0:
            return False
        b = self.data[last]
        stop_bit_pos = last * 8 + 7
        while not (b & 1):
            b >>= 1
            stop_bit_pos -= 1
        return self.bit_pos < stop_bit_pos


def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    """Insert emulation-prevention 0x03 bytes (H.265 7.4.2)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    """Strip emulation-prevention bytes."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < n and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)
