"""Blake2b Fiat–Shamir transcript.

The reference uses the fork's `Blake2bWrite`/`Blake2bRead` transcripts over
Vesta points (reference/src/test_utils.rs:16,40,65).  The fork's exact
byte framing is unvendored, so this module defines tinyram-tpu's own
canonical format (see SURVEY.md §7 "Hard parts" #1: bit-exactness means
*identical challenge derivation given the same transcript bytes*, validated
by our own verifier):

  * Points absorb as 32 bytes: little-endian x with the top bit (bit 255,
    always free for 255-bit fields) carrying y's parity; the identity is 32
    zero bytes.
  * Scalars absorb as 32-byte little-endian plain (non-Montgomery) integers.
  * A challenge squeeze hashes the accumulated buffer with Blake2b-512
    (person=b"tinyram-tpu-v1"), reduces the 512-bit digest mod p (Fp, the
    circuit/scalar field), and the digest becomes the new buffer head so
    every challenge chains over all prior traffic.

Host-side by construction: transcript work is O(proof size) and
latency-bound, not throughput-bound.
"""

from __future__ import annotations

import hashlib

from ..field.params import P_PALLAS_BASE, Q_VESTA_BASE

CHALLENGE_FIELD = P_PALLAS_BASE
_PERSON = b"tinyram-tpu-v1"

AffinePoint = tuple[int, int] | None


def _point_bytes(pt: AffinePoint) -> bytes:
    if pt is None:
        return bytes(32)
    x, y = pt
    assert 0 <= x < Q_VESTA_BASE
    return (x | ((y & 1) << 255)).to_bytes(32, "little")


def point_from_bytes(raw: bytes) -> AffinePoint:
    """Decompress a 32-byte point encoding (verifier side)."""
    from ..field.params import CURVE_B

    v = int.from_bytes(raw, "little")
    if v == 0:
        return None
    q = Q_VESTA_BASE
    x = v & ((1 << 255) - 1)
    parity = v >> 255
    rhs = (x * x * x + CURVE_B) % q
    y = _sqrt_mod(rhs, q)
    if y is None:
        raise ValueError("invalid point encoding: x not on curve")
    if y & 1 != parity:
        y = q - y
    return (x, y)


def _sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli–Shanks for the pasta primes (p ≡ 1 mod 2^32)."""
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    s, t = 0, p - 1
    while t % 2 == 0:
        s += 1
        t //= 2
    m, c = s, pow(5, t, p)  # 5 is a non-residue for both pasta fields
    tt, r = pow(a, t, p), pow(a, (t + 1) // 2, p)
    while tt != 1:
        i, tmp = 0, tt
        while tmp != 1:
            tmp = tmp * tmp % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        tt, r = tt * c % p, r * b % p
    return r


class _TranscriptBase:
    def __init__(self):
        self._buf = b""

    def _absorb(self, data: bytes):
        self._buf += data

    def common_point(self, pt: AffinePoint):
        self._absorb(_point_bytes(pt))

    def common_scalar(self, s: int):
        self._absorb(int(s % CHALLENGE_FIELD).to_bytes(32, "little"))

    def challenge(self) -> int:
        digest = hashlib.blake2b(
            self._buf, digest_size=64, person=_PERSON
        ).digest()
        self._buf = digest
        return int.from_bytes(digest, "little") % CHALLENGE_FIELD


class TranscriptWriter(_TranscriptBase):
    """Prover side: absorbs and also appends to the proof byte stream."""

    def __init__(self):
        super().__init__()
        self._proof = bytearray()

    def write_point(self, pt: AffinePoint):
        raw = _point_bytes(pt)
        self._proof += raw
        self._absorb(raw)

    def write_scalar(self, s: int):
        raw = int(s % CHALLENGE_FIELD).to_bytes(32, "little")
        self._proof += raw
        self._absorb(raw)

    def finalize(self) -> bytes:
        return bytes(self._proof)


class TranscriptReader(_TranscriptBase):
    """Verifier side: consumes the proof byte stream, absorbing as it reads."""

    def __init__(self, proof: bytes):
        super().__init__()
        self._proof = proof
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._proof):
            raise ValueError("proof truncated")
        out = self._proof[self._pos : self._pos + n]
        self._pos += n
        return out

    def read_point(self) -> AffinePoint:
        raw = self._take(32)
        pt = point_from_bytes(raw)
        self._absorb(raw)
        return pt

    def read_scalar(self) -> int:
        raw = self._take(32)
        v = int.from_bytes(raw, "little")
        if v >= CHALLENGE_FIELD:
            raise ValueError("scalar out of range")
        self._absorb(raw)
        return v

    def finished(self) -> bool:
        return self._pos == len(self._proof)
