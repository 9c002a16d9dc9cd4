"""ifunc message frames (paper Figs. 2 & 3) and the truncation protocol.

Layout (bitcode mode, Fig. 3)::

    HEADER | PAYLOAD | MAGIC | CODE | DEPS | MAGIC

The frame is a single contiguous byte block. The *full* frame is always
constructed; the sender controls what actually travels by passing a different
*size* to the PUT (never by editing the frame): a cached send stops after the
first MAGIC. The MAGIC sentinels double as delivery detection for one-sided
PUTs — the receiver polls its buffer and considers the message delivered when
the expected trailing MAGIC is present (Sec. III-D).

Header fields::

    magic4  version  kind  flags  name_len  payload_len  code_len  deps_len
    digest(32B)  ack(4B) seq(4B)  name(name_len B)

The trailing 8-byte word is the reliability layer's channel state: the low
u32 is the sender-assigned per-peer sequence number, the high u32 a
piggybacked cumulative ACK (every seq <= ack from the *receiver's* stream
has been ingested by the sender of this frame).  Both are 0 when the
reliability layer is off — the pre-reliability wire format, bit-for-bit,
at zero added bytes when it is on.

Multi-payload frames (coalescing)
---------------------------------
A frame whose ``flags`` carry :attr:`FrameFlags.BATCH` packs N payloads of
the *same* ifunc type behind one header and (at most) one code section::

    HEADER | count(varint) item(varint) [len0..lenN-1(varint)] payload0 .. payloadN-1 | MAGIC | CODE | DEPS | MAGIC
            `--------------------------- PAYLOAD section ---------------------------'

The batch sub-header is a varint offset table: ``count`` then ``item``.
``item > 0`` is the compressed uniform case — every payload is ``item``
bytes, no per-payload table (2-6 bytes total, vs the 8-byte fixed
sub-header it replaced).  ``item == 0`` marks the ragged form: ``count``
varint lengths follow, one per payload (the scatter-gather offset table).
The truncation protocol is unchanged — the PAYLOAD section (including
the sub-header) sits before the first MAGIC, so a cached coalesced send
is still a prefix PUT — and the wire model charges one ``alpha_us`` for
all N payloads, which is the whole point: per-message latency amortizes
across a burst to one peer.  :func:`coalesce` builds such a frame from
same-type frames and :func:`split_payloads` recovers the individual
payloads on the target.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from enum import IntEnum

HDR_MAGIC = b"3CHN"
MAGIC = b"\xabMAGIC\xba\x00"  # 8-byte delivery sentinel
MAGIC_LEN = len(MAGIC)

_HDR_FMT = "<4sBBBxHxxIII32sQ"
_HDR_LEN = struct.calcsize(_HDR_FMT)


class ProtocolError(RuntimeError):
    """A peer violated the Three-Chains wire protocol (bad frame, stale
    cache, unknown handler...).  Defined here, at the bottom layer, so both
    the frame parser and the PE runtime raise the same family."""


class CorruptFrame(ProtocolError, ValueError):
    """Garbage bytes where a frame should be.  Also a ValueError: callers
    that validated frames before ProtocolError existed keep working."""


class FrameKind(IntEnum):
    BITCODE = 1  # fat-bitcode ifunc (Sec. III-C)
    BINARY = 2  # binary ifunc (Sec. III-B): single-triple, no target JIT
    ACTIVE_MESSAGE = 3  # pre-deployed handler, payload-only (baseline)
    GET_RESPONSE = 4  # transport-internal: RDMA GET reply
    RNDV = 5  # rendezvous descriptor: 16B control, data pulled by GET
    ACK = 6  # standalone cumulative ACK (header-only; reliability layer)


class FrameFlags(IntEnum):
    NONE = 0
    RESULT = 1  # carries a ReturnResult payload
    BATCH = 2  # PAYLOAD section is a multi-payload pack (see module docstring)
    HOP = 4  # PAYLOAD section starts with a propagation hop header (PUBLISH)
    EXPRESS = 8  # latency-class hint: drain via the control lane when
    # self-contained (multi-tenant QoS; flag travels in the existing
    # flags byte, so pre-QoS receivers parse it unchanged)


# 16-byte rendezvous descriptor: [src_peer_index, token, data_nbytes, reserved].
# The receiver reconstructs the staging region name from (src, token) and
# pulls the payload with a one-sided GET — correct when the payload dwarfs
# 2*alpha, and the only RETURN shape whose eager cost grows with size.
RNDV_DESC = struct.Struct("<IIII")
RNDV_DESC_NBYTES = RNDV_DESC.size


def rndv_region(src_name: str, token: int) -> str:
    """Staging-region naming convention shared by both ends of a rendezvous."""
    return f"rndv/{src_name}/{token}"


def pack_rndv(src_idx: int, token: int, nbytes: int) -> bytes:
    """Build one 16-byte rendezvous descriptor (reserved word always 0)."""
    return RNDV_DESC.pack(src_idx, token, nbytes, 0)


def unpack_rndv(desc: bytes) -> tuple[int, int, int]:
    """Parse + validate one rendezvous descriptor -> (src_idx, token,
    nbytes).  Anything that is not exactly one well-formed descriptor —
    truncation, trailing bytes, a set reserved word — is a loud
    :class:`CorruptFrame`, never a silent misparse."""
    if len(desc) != RNDV_DESC.size:
        raise CorruptFrame(
            f"malformed rendezvous descriptor: {len(desc)} bytes "
            f"(want {RNDV_DESC.size})"
        )
    src_idx, token, nbytes, reserved = RNDV_DESC.unpack(desc)
    if reserved != 0:
        raise CorruptFrame("malformed rendezvous descriptor: reserved word set")
    return src_idx, token, nbytes


# ------------------------------------------------------- propagation hops
# A PUBLISH frame (``FrameFlags.HOP``) prefixes its PAYLOAD section with a
# hop header: the recursive-propagation state a re-publishing PE needs to
# keep the multicast a *tree* —
#
#     ttl(u8)  k(u8)  root(u16)  pub_id(u32)  n_path(u16)  pad(2B)
#     path_digest(u64)  path[n_path](u16 each)
#
# ``ttl``    remaining hops this publish may still travel; a frame arriving
#            with ttl == 0 is expired and refused, a PE republishing sends
#            ttl - 1 and stops (silently) once that would hit zero.
# ``k``      tree shape on the wire: 0 = binomial, else k-ary fanout — so a
#            mid-tree PE needs no out-of-band config agreement.
# ``root``   peer index the publish originated at (tree root).
# ``pub_id`` root-chosen id; (code digest, root, pub_id) is the dedup key
#            that makes delivery exactly-once per PE under a fabric that is
#            only at-least-once (and is what breaks forwarding cycles).
# ``path``   peer indices visited so far, root first; a PE that finds its
#            own index here refuses the hop (cycle).  ``path_digest`` is a
#            FNV-1a over (k, root, pub_id, path): truncated or tampered hop
#            headers are rejected before any of their fields are trusted.
_HOP_FMT = struct.Struct("<BBHIH2xQ")
HOP_FIXED_NBYTES = _HOP_FMT.size  # 20
MAX_HOP_PATH = 1024  # sanity bound: longest admissible visited-path


def _fnv1a64(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclass(frozen=True)
class HopHeader:
    """Parsed propagation hop state (see wire layout above)."""

    ttl: int
    root: int
    pub_id: int
    path: tuple[int, ...]
    k: int = 0  # 0 = binomial tree, else k-ary fanout

    @property
    def nbytes(self) -> int:
        return HOP_FIXED_NBYTES + 2 * len(self.path)

    def digest(self) -> int:
        body = struct.pack("<BHI", self.k, self.root, self.pub_id)
        body += struct.pack(f"<{len(self.path)}H", *self.path)
        return _fnv1a64(body)

    def child_hop(self, me: int) -> "HopHeader":
        """The header a PE at index ``me`` republishes with: one hop spent,
        itself appended to the visited path."""
        return HopHeader(
            ttl=self.ttl - 1,
            root=self.root,
            pub_id=self.pub_id,
            path=(*self.path, me),
            k=self.k,
        )


def hop_nbytes(n_path: int) -> int:
    return HOP_FIXED_NBYTES + 2 * n_path


def pack_hop(hop: HopHeader) -> bytes:
    if not 0 <= hop.ttl <= 255:
        raise ValueError(f"hop ttl {hop.ttl} out of u8 range")
    if len(hop.path) > MAX_HOP_PATH:
        raise ValueError(f"hop path longer than {MAX_HOP_PATH}")
    head = _HOP_FMT.pack(
        hop.ttl, hop.k, hop.root, hop.pub_id, len(hop.path), hop.digest()
    )
    return head + struct.pack(f"<{len(hop.path)}H", *hop.path)


def unpack_hop(buf: bytes, off: int = 0) -> tuple[HopHeader, int]:
    """Parse one hop header at ``off``; returns (hop, next_off).  Truncated,
    over-long, or digest-mismatched headers raise :class:`CorruptFrame`."""
    if len(buf) < off + HOP_FIXED_NBYTES:
        raise CorruptFrame("corrupt hop header: truncated")
    ttl, k, root, pub_id, n_path, digest = _HOP_FMT.unpack_from(buf, off)
    if n_path > MAX_HOP_PATH:
        raise CorruptFrame(f"corrupt hop header: path length {n_path}")
    end = off + HOP_FIXED_NBYTES + 2 * n_path
    if len(buf) < end:
        raise CorruptFrame("corrupt hop header: truncated path")
    path = struct.unpack_from(f"<{n_path}H", buf, off + HOP_FIXED_NBYTES)
    hop = HopHeader(ttl=ttl, root=root, pub_id=pub_id, path=tuple(path), k=k)
    if hop.digest() != digest:
        raise CorruptFrame("corrupt hop header: path digest mismatch")
    return hop, end


def split_hop(payload: bytes) -> tuple[HopHeader, bytes]:
    """Strip the hop header off a PUBLISH frame's payload section; returns
    (hop, inner payload bytes — possibly empty for a code-only publish)."""
    hop, off = unpack_hop(payload, 0)
    return hop, payload[off:]


# ------------------------------------------------------------------ varint
def uvarint_encode(n: int) -> bytes:
    """LEB128 unsigned varint (u32 range)."""
    if n < 0:
        raise ValueError("uvarint is unsigned")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def uvarint_decode(buf: bytes, off: int) -> tuple[int, int]:
    """Decode one varint at ``off``; returns (value, next_off).  Truncated
    or over-long (>5 byte) encodings raise :class:`CorruptFrame`."""
    val = shift = 0
    for i in range(5):
        if off + i >= len(buf):
            raise CorruptFrame("corrupt batch frame: truncated varint")
        b = buf[off + i]
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off + i + 1
        shift += 7
    raise CorruptFrame("corrupt batch frame: over-long varint")


def pack_payloads(payloads: "list[bytes]") -> bytes:
    """Build a BATCH payload section: varint sub-header + concatenated
    payloads (uniform compressed form when sizes agree, offset table
    otherwise)."""
    lens = [len(p) for p in payloads]
    uniform = lens[0] if lens and all(n == lens[0] for n in lens) else 0
    head = uvarint_encode(len(payloads)) + uvarint_encode(uniform)
    if not uniform:
        head += b"".join(uvarint_encode(n) for n in lens)
    return head + b"".join(payloads)


def unpack_payloads(section: bytes) -> "list[bytes]":
    """Inverse of :func:`pack_payloads`; size disagreements are loud."""
    count, off = uvarint_decode(section, 0)
    item, off = uvarint_decode(section, off)
    if count > len(section):  # cheap sanity bound before allocating a table
        raise CorruptFrame("corrupt batch frame: payload count exceeds section")
    if item:
        lens = [item] * count
    else:
        lens = []
        for _ in range(count):
            n, off = uvarint_decode(section, off)
            lens.append(n)
    if len(section) != off + sum(lens):
        raise CorruptFrame("corrupt batch frame: payload section size mismatch")
    out = []
    for n in lens:
        out.append(section[off : off + n])
        off += n
    return out


def batch_subheader_nbytes(section: bytes) -> int:
    """How many bytes of a BATCH payload section are offset-table overhead."""
    count, off = uvarint_decode(section, 0)
    item, off = uvarint_decode(section, off)
    if not item:
        for _ in range(count):
            _, off = uvarint_decode(section, off)
    return off


@dataclass
class Frame:
    """A parsed view of (or recipe for) one contiguous message frame."""

    kind: FrameKind
    name: str  # ifunc type name, e.g. "tsi" / "chaser"
    payload: bytes
    code: bytes = b""  # fat-bitcode archive (or single slice for BINARY)
    deps: tuple[str, ...] = ()
    digest: bytes = b"\x00" * 32  # sha256 of code section
    seq: int = 0  # per-peer sequence number (u32; 0 = unsequenced)
    ack: int = 0  # piggybacked cumulative ACK (u32; 0 = nothing to ack)
    flags: int = FrameFlags.NONE
    version: int = 1
    # local scheduling metadata, never serialized: which tenant's budget
    # this frame charges against (None = untenanted / infrastructure)
    tenant: str | None = None

    @property
    def n_payloads(self) -> int:
        """1 for a plain frame, the packed count for a BATCH frame."""
        if not self.flags & FrameFlags.BATCH:
            return 1
        return uvarint_decode(self.payload, 0)[0]

    # ------------------------------------------------------------------ pack
    def pack(self) -> bytes:
        """Build the full contiguous frame (always includes the code)."""
        name_b = self.name.encode()
        deps_b = "\n".join(self.deps).encode()
        hdr = struct.pack(
            _HDR_FMT,
            HDR_MAGIC,
            self.version,
            int(self.kind),
            int(self.flags),
            len(name_b),
            len(self.payload),
            len(self.code),
            len(deps_b),
            self.digest,
            ((self.ack & 0xFFFFFFFF) << 32) | (self.seq & 0xFFFFFFFF),
        )
        return b"".join(
            [hdr, name_b, self.payload, MAGIC, self.code, deps_b, MAGIC]
        )

    # Sizes for the truncation protocol ------------------------------------
    @property
    def cached_nbytes(self) -> int:
        """Wire size when the target already holds the code: up to MAGIC #1."""
        return _HDR_LEN + len(self.name.encode()) + len(self.payload) + MAGIC_LEN

    @property
    def full_nbytes(self) -> int:
        return (
            self.cached_nbytes
            + len(self.code)
            + len("\n".join(self.deps).encode())
            + MAGIC_LEN
        )

    def wire_bytes(self, cached: bool) -> bytes:
        """What actually goes on the wire. The frame itself is never edited —
        a cached send is a shorter PUT of the same buffer."""
        full = self.pack()
        return full[: self.cached_nbytes] if cached else full

    def kind_breakdown(self, cached: bool) -> dict[str, int]:
        """Attribute this frame's wire bytes across the fabric's byte-kind
        accounting: ifunc payload data vs framing (header, name, sentinels,
        batch sub-header) vs code+deps."""
        payload = len(self.payload)
        if self.flags & FrameFlags.BATCH:
            payload -= batch_subheader_nbytes(self.payload)
        if self.flags & FrameFlags.HOP:
            payload -= unpack_hop(self.payload)[1]  # hop header is framing
        header = self.cached_nbytes - payload
        code = 0 if cached else self.full_nbytes - self.cached_nbytes
        return {"header": header, "payload": payload, "code": code}


# ---------------------------------------------------------------- unpacking
@dataclass
class ParsedHeader:
    kind: FrameKind
    flags: int
    name: str
    payload_len: int
    code_len: int
    deps_len: int
    digest: bytes
    seq: int
    ack: int
    header_len: int  # header + name bytes

    @property
    def cached_total(self) -> int:
        return self.header_len + self.payload_len + MAGIC_LEN

    @property
    def full_total(self) -> int:
        return self.cached_total + self.code_len + self.deps_len + MAGIC_LEN


def peek_header(buf: bytes | bytearray | memoryview) -> ParsedHeader | None:
    """Parse the header if enough bytes have been delivered, else None."""
    if len(buf) < _HDR_LEN:
        return None
    magic4, version, kind, flags, name_len, payload_len, code_len, deps_len, digest, seq_word = struct.unpack_from(
        _HDR_FMT, buf, 0
    )
    if magic4 != HDR_MAGIC:
        raise CorruptFrame("corrupt frame: bad header magic")
    if len(buf) < _HDR_LEN + name_len:
        return None
    try:
        name = bytes(buf[_HDR_LEN : _HDR_LEN + name_len]).decode()
        kind = FrameKind(kind)
    except (UnicodeDecodeError, ValueError) as e:
        raise CorruptFrame(f"corrupt frame: {e}") from None
    return ParsedHeader(
        kind=kind,
        flags=flags,
        name=name,
        payload_len=payload_len,
        code_len=code_len,
        deps_len=deps_len,
        digest=digest,
        seq=seq_word & 0xFFFFFFFF,
        ack=seq_word >> 32,
        header_len=_HDR_LEN + name_len,
    )


def delivery_complete(buf: bytes | bytearray | memoryview, expect_code: bool) -> bool:
    """MAGIC-based delivery detection (receiver side of one-sided PUT).

    ``expect_code`` is decided by the *receiver's own registry*: if it has
    already cached this ifunc type it only waits for the payload sentinel,
    otherwise for the trailing sentinel after CODE|DEPS (Sec. III-D).
    """
    hdr = peek_header(buf)
    if hdr is None:
        return False
    end = hdr.full_total if expect_code else hdr.cached_total
    if len(buf) < end:
        return False
    return bytes(buf[end - MAGIC_LEN : end]) == MAGIC


def unpack(buf: bytes | bytearray | memoryview, has_code: bool) -> Frame:
    """Materialize a Frame from a delivered buffer."""
    hdr = peek_header(buf)
    if hdr is None:
        raise CorruptFrame("corrupt frame: truncated header")
    off = hdr.header_len
    payload = bytes(buf[off : off + hdr.payload_len])
    off += hdr.payload_len
    if bytes(buf[off : off + MAGIC_LEN]) != MAGIC:
        raise CorruptFrame("corrupt frame: bad payload sentinel")
    off += MAGIC_LEN
    code = b""
    deps: tuple[str, ...] = ()
    if has_code:
        code = bytes(buf[off : off + hdr.code_len])
        off += hdr.code_len
        deps_b = bytes(buf[off : off + hdr.deps_len])
        off += hdr.deps_len
        try:
            deps = tuple(d for d in deps_b.decode().split("\n") if d)
        except UnicodeDecodeError as e:
            raise CorruptFrame(f"corrupt frame: undecodable deps ({e})") from None
        if bytes(buf[off : off + MAGIC_LEN]) != MAGIC:
            raise CorruptFrame("corrupt frame: bad code sentinel")
    return Frame(
        kind=hdr.kind,
        name=hdr.name,
        payload=payload,
        code=code,
        deps=deps,
        digest=hdr.digest,
        seq=hdr.seq,
        ack=hdr.ack,
        flags=hdr.flags,
    )


# -------------------------------------------------------------- coalescing
def coalesce(frames: "list[Frame]") -> Frame:
    """Pack N same-ifunc frames into one multi-payload frame.

    All frames must agree on (kind, name, digest) — they are instances of one
    ifunc type — and carry equal-size payloads (the wire format's ragged
    offset table exists, but one ifunc type means one payload aval, so the
    runtime only ever emits the uniform compressed form; a ragged batch here
    is a caller bug).  The code/deps sections come from the first frame that
    has them (every member of a batch shares the same code by construction,
    digest equality enforces it).
    """
    if len(frames) == 1:
        return frames[0]
    if any(f.flags & FrameFlags.HOP for f in frames):
        # each hop frame's PAYLOAD starts with its own per-edge path header;
        # packing them behind one header would splice paths together
        raise ValueError("coalesce: PUBLISH hop frames travel individually")
    head = frames[0]
    item = len(head.payload)
    for f in frames[1:]:
        if (f.kind, f.name, f.digest) != (head.kind, head.name, head.digest):
            raise ValueError("coalesce: frames are not the same ifunc type")
        if len(f.payload) != item:
            raise ValueError("coalesce: ragged payload sizes in one batch")
    carrier = next((f for f in frames if f.code), head)
    return Frame(
        kind=head.kind,
        name=head.name,
        payload=pack_payloads([f.payload for f in frames]),
        code=carrier.code,
        deps=carrier.deps,
        digest=head.digest,
        seq=frames[-1].seq,
        flags=head.flags | FrameFlags.BATCH,
        tenant=head.tenant,
    )


def split_payloads(frame: Frame) -> list[bytes]:
    """Individual payloads of a (possibly multi-payload) frame, in order."""
    if not frame.flags & FrameFlags.BATCH:
        return [frame.payload]
    return unpack_payloads(frame.payload)
