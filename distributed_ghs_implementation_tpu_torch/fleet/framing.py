"""Length-prefixed JSON framing for the router <-> worker channels.

A copy of the JAX package's ``fleet/framing.py``, which imports neither
JAX nor anything of that package: the port keeps its own so that it
imports nothing of the JAX package. The byte format is the same, so a
frame written by either package reads in the other. The port serves it
through ``serve/service.serve_frames`` and the fleet's transports
(``fleet/transport.py``).

The single-process service speaks newline-delimited JSON (one request per
line, ``serve/service.py``); the fleet cannot: a worker's channel carries
*interleaved* responses written by concurrent request threads, and a torn
line would silently merge two frames. Each frame is therefore::

    <payload-byte-length>\\n<payload>\\n                  # legacy (v1)
    <payload-byte-length> <crc32-hex>\\n<payload>\\n      # checksummed

— the reader knows exactly how many bytes belong to the frame before it
parses a single one, a short read is detected (not mis-parsed), and the
trailing newline keeps frames greppable in a captured channel dump. The
same framing runs over OS pipes (the single-host fleet) and TCP sockets
(``fleet/transport.py``) — a frame is a frame on either medium.

**Payload checksums** (round 19): the optional second header token is the
crc32 of the payload bytes. Length-prefixing alone detects *truncation*
but not *mutation* — a bit-flipped byte inside the payload either breaks
the JSON (caught late, after buffering) or, worse, survives as valid JSON
with a different value. With the checksum, every flipped payload is
rejected at the frame boundary as a typed :class:`FrameError`. Readers
accept both forms unconditionally; writers emit checksums only toward
peers that advertised the ``crc`` capability in their hello (or whose own
frames carried checksums) — the version gate that keeps a mixed-build
fleet compatible (``fleet/transport.py``, ``docs/FLEET.md``).

**Binary frames ("B-frames")**: a third header form carries raw array
sections after a compact JSON header, so a 3000-edge graph crosses the
wire as three contiguous little-endian buffers instead of a Python-list
JSON blob re-parsed on every hop::

    B<header-bytes> <section-bytes> <crc32-hex>\\n<header><sections>\\n

The header is ordinary compact JSON in which the reserved ``_sections``
key (at the top level, or one nesting level down — ``{"id": N, "req":
{...}}`` frames) holds the section table ``[[name, dtype, count], ...]``;
the section bytes follow the header back to back in table order. The
crc32 covers header *and* sections (B-frames are always checksummed —
they only ever go to peers that negotiated ``caps.wire``, which implies
the round-19 checksum support). :func:`read_frame` validates the table
against the declared byte count *before* any allocation beyond the
already-``max_bytes``-bounded payload read, rebuilds a
:class:`WireSections` view over the one received buffer (``np.frombuffer``
— zero copies, zero per-element Python objects), and re-implants it where
the table sat. Writers emit B-frames only toward peers that advertised
the ``wire`` capability in their hello (``fleet/transport.py``); for
legacy peers :func:`fold_sections` lowers the sections back to the
classic JSON fields (``edges`` triples, ``mst_edges`` pairs, plain
lists), so a mixed-build fleet degrades per-connection, transparently.

Error surface: :func:`read_frame` returns ``None`` only on a *clean* EOF
at a frame boundary (the peer closed in between frames — drain, or death)
and raises :class:`FrameError` on everything garbled: a non-numeric or
over-long length prefix, a length past ``max_bytes`` (a corrupt prefix
must not become a multi-gigabyte allocation — the reader sizes its buffer
from attacker/garbage-controlled bytes), a payload the stream could not
complete, a payload failing its declared checksum, bytes that are not
one JSON object, or a section table whose declarations do not tile the
declared section bytes exactly. ``FrameError`` subclasses ``ValueError``,
so callers that treated every framing problem as peer-death (the router's
reader catches ``(OSError, ValueError)``) keep doing so unchanged — the
typed error exists for callers that want to *distinguish* a corrupt peer
from a closed one (tests, the drills, the dial-in hello validation).
Writes must be serialized by the caller (the transports hold a
per-connection write lock).
"""

from __future__ import annotations

import json
import zlib
from typing import IO, Optional

#: A frame larger than this is a protocol violation (a runaway edges_out
#: response, or garbage on the channel) — refuse to buffer it. Callers with
#: tighter expectations (the hello exchange is a few hundred bytes) pass
#: their own ``max_bytes``.
MAX_FRAME_BYTES = 256 * 1024 * 1024

#: The longest legal header is the B-frame form: ``B`` + 9 header digits
#: + space + 9 section digits + space + 8 crc hex digits + newline (29
#: bytes; the legacy forms top out at 19). Anything longer is garbage,
#: and an unbounded ``readline`` on a corrupt stream would buffer until
#: memory runs out.
_MAX_HEADER_BYTES = 32

#: Reserved payload key that carries a :class:`WireSections` (in-memory)
#: or the section table (on the wire). Never a user-facing field name.
SECTIONS_KEY = "_sections"

#: Raw-section element types a B-frame may declare, with byte widths.
#: A closed whitelist: the itemsize must come from this table, never from
#: the wire, or a garbage dtype string sizes an allocation.
_SECTION_DTYPES = {"<i8": 8, "<f8": 8, "<i4": 4, "<f4": 4, "<u1": 1}

#: A section table longer than this is garbage, not a graph.
_MAX_SECTIONS = 64


class FrameError(ValueError):
    """A garbled frame: corrupt length prefix, oversize declaration,
    truncated payload, checksum mismatch, non-JSON bytes, or a binary
    section table that does not tile its declared bytes. The channel
    can no longer be trusted to be frame-aligned — the only safe response
    is to drop it."""


class WireSections:
    """Named contiguous little-endian array sections riding a B-frame.

    Two lives, one class. *Encode side* (:meth:`add`): holds the original
    NumPy arrays and emits their buffers directly onto the wire — no
    intermediate concatenation, no per-element Python objects. *Decode
    side* (:meth:`from_buffer`): holds the ONE buffer ``read_frame``
    received plus the validated ``(dtype, count, offset)`` table;
    :meth:`array` is an ``np.frombuffer`` view into it — zero-copy — and
    :meth:`chunks` returns the raw buffer itself, so a router forwarding
    a B-frame re-emits the section bytes without ever decoding them (the
    opaque-passthrough contract, ``docs/FLEET.md``).
    """

    __slots__ = ("_order", "_specs", "_arrays", "_buf", "_offsets")

    def __init__(self) -> None:
        self._order: list = []  # section names, wire order
        self._specs: dict = {}  # name -> (dtype_str, count)
        self._arrays: dict = {}  # encode side: name -> contiguous ndarray
        self._buf: bytes = b""  # decode side: the received section bytes
        self._offsets: dict = {}  # decode side: name -> byte offset

    # -- encode side ---------------------------------------------------
    def add(self, name: str, arr) -> "WireSections":
        """Attach ``arr`` as section ``name`` (chainable). The array is
        normalized to a C-contiguous little-endian whitelisted dtype; a
        dtype outside the whitelist is a caller bug, not a wire error."""
        import numpy as np

        a = np.ascontiguousarray(arr)
        dt = a.dtype.newbyteorder("<")
        if dt.str not in _SECTION_DTYPES:
            raise ValueError(
                f"section {name!r} dtype {a.dtype.str} not wire-encodable "
                f"(allowed: {sorted(_SECTION_DTYPES)})"
            )
        if a.dtype != dt:
            a = a.astype(dt)
        if a.ndim != 1:
            a = a.reshape(-1)
        if name in self._specs:
            raise ValueError(f"duplicate section {name!r}")
        self._order.append(name)
        self._specs[name] = (dt.str, int(a.shape[0]))
        self._arrays[name] = a
        return self

    # -- decode side ---------------------------------------------------
    @classmethod
    def from_buffer(cls, decl, buf: bytes) -> "WireSections":
        """Rebuild from a wire section table + the received bytes;
        :class:`FrameError` unless the table is well-formed and tiles
        ``buf`` exactly (the bounded-allocation contract: counts are
        checked against bytes already read, never used to size a read)."""
        if not isinstance(decl, list) or len(decl) > _MAX_SECTIONS:
            raise FrameError(
                f"malformed section table: "
                f"{type(decl).__name__} of {len(decl) if isinstance(decl, list) else '?'}"
            )
        self = cls()
        self._buf = buf
        offset = 0
        for entry in decl:
            if not (isinstance(entry, list) and len(entry) == 3):
                raise FrameError(f"malformed section entry: {entry!r}")
            name, dtype, count = entry
            if (
                not isinstance(name, str)
                or not name
                or len(name) > 64
                or name in self._specs
            ):
                raise FrameError(f"bad section name: {name!r}")
            itemsize = _SECTION_DTYPES.get(dtype)
            if itemsize is None:
                raise FrameError(f"section {name!r} dtype {dtype!r} unknown")
            if not isinstance(count, int) or isinstance(count, bool) or count < 0:
                raise FrameError(f"section {name!r} count {count!r} invalid")
            nbytes = count * itemsize
            if offset + nbytes > len(buf):
                raise FrameError(
                    f"section table overruns payload: {name!r} wants "
                    f"[{offset}, {offset + nbytes}) of {len(buf)} bytes"
                )
            self._order.append(name)
            self._specs[name] = (dtype, count)
            self._offsets[name] = offset
            offset += nbytes
        if offset != len(buf):
            raise FrameError(
                f"section table covers {offset} of {len(buf)} payload bytes"
            )
        return self

    # -- shared --------------------------------------------------------
    @property
    def names(self) -> tuple:
        return tuple(self._order)

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def count(self, name: str) -> int:
        return self._specs[name][1]

    @property
    def nbytes(self) -> int:
        return sum(
            count * _SECTION_DTYPES[dtype]
            for dtype, count in self._specs.values()
        )

    def decl(self) -> list:
        """The wire section table ``[[name, dtype, count], ...]``."""
        return [
            [name, self._specs[name][0], self._specs[name][1]]
            for name in self._order
        ]

    def array(self, name: str):
        """Section ``name`` as a 1-D array — an ``np.frombuffer`` view on
        the decode side (read-only, zero-copy), the original array on the
        encode side."""
        import numpy as np

        a = self._arrays.get(name)
        if a is not None:
            return a
        dtype, count = self._specs[name]
        return np.frombuffer(
            self._buf, dtype=dtype, count=count, offset=self._offsets[name]
        )

    def chunks(self) -> list:
        """Buffer objects whose concatenation is the wire section bytes.
        Decode-side sections return the received buffer itself — the
        forwarding path splices it without touching a single element."""
        if self._arrays:
            return [
                memoryview(self._arrays[name]).cast("B")
                for name in self._order
            ]
        return [self._buf] if self._buf else []


def encode_frame(obj: dict, *, crc: bool = False) -> bytes:
    """``obj`` as one wire-ready frame; ``crc=True`` emits the checksummed
    header form (send it only to peers known to parse it)."""
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if crc:
        return (
            b"%d %08x\n" % (len(payload), zlib.crc32(payload))
            + payload + b"\n"
        )
    return b"%d\n" % len(payload) + payload + b"\n"


def frame_sections(obj: dict):
    """The :class:`WireSections` riding ``obj`` (at the top level or one
    nesting level down), or ``None`` — how a transport decides between the
    B-frame and JSON encodings for one payload."""
    return _locate_sections(obj)[1]


def _locate_sections(obj: dict):
    """``(nest_key_or_None, WireSections_or_None)`` for ``obj``. One
    nesting level is enough by construction: requests/responses carry
    sections directly, and the fleet wraps exactly one envelope around
    them (``{"id": N, "req"/"resp": payload}``)."""
    s = obj.get(SECTIONS_KEY)
    if isinstance(s, WireSections):
        return None, s
    for key, val in obj.items():
        if isinstance(val, dict) and isinstance(
            val.get(SECTIONS_KEY), WireSections
        ):
            return key, val[SECTIONS_KEY]
    return None, None


def encode_bframe(obj: dict) -> bytes:
    """``obj`` (which must carry a :class:`WireSections`) as one binary
    frame. Always checksummed — B-frames only go to ``caps.wire`` peers.
    The section arrays' buffers are spliced into the frame directly; the
    JSON header is everything else plus the section table in place."""
    nest, secs = _locate_sections(obj)
    if secs is None:
        raise ValueError("encode_bframe: payload carries no WireSections")
    if nest is None:
        head_obj = {**obj, SECTIONS_KEY: secs.decl()}
    else:
        head_obj = {**obj, nest: {**obj[nest], SECTIONS_KEY: secs.decl()}}
    header = json.dumps(head_obj, separators=(",", ":")).encode("utf-8")
    crc = zlib.crc32(header)
    chunks = secs.chunks()
    sec_bytes = 0
    for ch in chunks:
        crc = zlib.crc32(ch, crc)
        sec_bytes += len(ch)
    return b"".join(
        [b"B%d %d %08x\n" % (len(header), sec_bytes, crc), header]
        + chunks
        + [b"\n"]
    )


def fold_sections(obj: dict) -> dict:
    """Lower a section-bearing payload to its classic pure-JSON form —
    the per-connection degradation path for peers without ``caps.wire``
    (and the text ``serve_loop``'s JSON egress). Graph-schema sections
    fold to their established field shapes: ``u``/``v``/``w`` become
    ``edges`` triples, ``mst_u``/``mst_v`` become ``mst_edges`` pairs;
    anything else folds to a plain list under its own name. Payloads
    without sections pass through unchanged (same object)."""
    nest, secs = _locate_sections(obj)
    if secs is None:
        return obj
    target = obj if nest is None else obj[nest]
    folded = {k: v for k, v in target.items() if k != SECTIONS_KEY}
    done = set()
    if all(n in secs for n in ("u", "v", "w")):
        done.update(("u", "v", "w"))
        folded["edges"] = [
            list(t)
            for t in zip(
                secs.array("u").tolist(),
                secs.array("v").tolist(),
                secs.array("w").tolist(),
            )
        ]
    if all(n in secs for n in ("mst_u", "mst_v")):
        done.update(("mst_u", "mst_v"))
        folded["mst_edges"] = [
            list(t)
            for t in zip(
                secs.array("mst_u").tolist(), secs.array("mst_v").tolist()
            )
        ]
    for name in secs.names:
        if name not in done:
            folded[name] = secs.array(name).tolist()
    return folded if nest is None else {**obj, nest: folded}


def write_frame(stream: IO[bytes], obj: dict, *, crc: bool = False) -> None:
    """Serialize ``obj`` as one length-prefixed frame and flush."""
    stream.write(encode_frame(obj, crc=crc))
    stream.flush()


def read_frame(
    stream: IO[bytes],
    *,
    max_bytes: int = MAX_FRAME_BYTES,
    meta: Optional[dict] = None,
) -> Optional[dict]:
    """Read one frame; ``None`` on clean EOF, :class:`FrameError` on
    anything garbled (see module docstring for the contract). ``meta``
    (when given) reports ``{"crc": bool, "wire": bool}`` — whether the
    frame carried a checksum / was a binary B-frame, which is how a
    transport learns what forms its peer speaks."""
    header = stream.readline(_MAX_HEADER_BYTES)
    if not header:
        return None
    if not header.endswith(b"\n"):
        raise FrameError(
            f"frame header not newline-terminated within "
            f"{_MAX_HEADER_BYTES} bytes: {header[:32]!r}"
        )
    parts = header.split()
    if parts and parts[0][:1] == b"B":
        return _read_bframe(stream, parts, max_bytes=max_bytes, meta=meta)
    if not parts or len(parts) > 2:
        raise FrameError(f"malformed frame header: {header!r}")
    try:
        n = int(parts[0])
    except ValueError:
        raise FrameError(f"non-numeric frame length prefix: {header!r}") from None
    want_crc: Optional[int] = None
    if len(parts) == 2:
        try:
            want_crc = int(parts[1], 16)
        except ValueError:
            raise FrameError(
                f"non-hex frame checksum token: {header!r}"
            ) from None
    if n < 0 or n > max_bytes:
        raise FrameError(
            f"declared frame length {n} outside [0, {max_bytes}]"
        )
    payload = stream.read(n)
    if payload is None or len(payload) != n:
        raise FrameError(
            f"truncated frame: header promised {n} bytes, "
            f"got {0 if payload is None else len(payload)}"
        )
    stream.read(1)  # the trailing newline (EOF here still parsed a frame)
    if want_crc is not None and zlib.crc32(payload) != want_crc:
        raise FrameError(
            f"frame payload checksum mismatch: declared {want_crc:08x}, "
            f"computed {zlib.crc32(payload):08x} over {n} bytes"
        )
    if meta is not None:
        meta["crc"] = want_crc is not None
        meta["wire"] = False
    try:
        obj = json.loads(payload)
    except ValueError:
        raise FrameError(
            f"frame payload is not valid JSON ({n} bytes)"
        ) from None
    if not isinstance(obj, dict):
        raise FrameError(f"frame payload is {type(obj).__name__}, not object")
    return obj


def _read_bframe(
    stream: IO[bytes],
    parts: list,
    *,
    max_bytes: int,
    meta: Optional[dict],
) -> dict:
    """The B-frame tail of :func:`read_frame`: parts is the split header
    line ``[b"B<hdr>", b"<sec>", b"<crc>"]``. Every length is bounds-
    checked against ``max_bytes`` BEFORE any payload allocation, and the
    section table must tile the section bytes exactly."""
    if len(parts) != 3:
        raise FrameError(f"malformed binary frame header: {parts!r}")
    try:
        hdr_n = int(parts[0][1:])
        sec_n = int(parts[1])
    except ValueError:
        raise FrameError(
            f"non-numeric binary frame length: {parts!r}"
        ) from None
    try:
        want_crc = int(parts[2], 16)
    except ValueError:
        raise FrameError(f"non-hex binary frame checksum: {parts!r}") from None
    if hdr_n < 0 or sec_n < 0 or hdr_n + sec_n > max_bytes:
        raise FrameError(
            f"declared binary frame length {hdr_n}+{sec_n} outside "
            f"[0, {max_bytes}]"
        )
    header = stream.read(hdr_n)
    if header is None or len(header) != hdr_n:
        raise FrameError(
            f"truncated binary frame header: promised {hdr_n} bytes, "
            f"got {0 if header is None else len(header)}"
        )
    sections = stream.read(sec_n)
    if sections is None or len(sections) != sec_n:
        raise FrameError(
            f"truncated binary frame sections: promised {sec_n} bytes, "
            f"got {0 if sections is None else len(sections)}"
        )
    stream.read(1)  # the trailing newline (EOF here still parsed a frame)
    crc = zlib.crc32(sections, zlib.crc32(header))
    if crc != want_crc:
        raise FrameError(
            f"binary frame checksum mismatch: declared {want_crc:08x}, "
            f"computed {crc:08x} over {hdr_n}+{sec_n} bytes"
        )
    try:
        obj = json.loads(header)
    except ValueError:
        raise FrameError(
            f"binary frame header is not valid JSON ({hdr_n} bytes)"
        ) from None
    if not isinstance(obj, dict):
        raise FrameError(
            f"binary frame header is {type(obj).__name__}, not object"
        )
    # Locate the section table where the sections will be re-implanted.
    nest, decl = None, obj.get(SECTIONS_KEY)
    if not isinstance(decl, list):
        decl = None
        for key, val in obj.items():
            if isinstance(val, dict) and isinstance(
                val.get(SECTIONS_KEY), list
            ):
                nest, decl = key, val[SECTIONS_KEY]
                break
    if decl is None:
        if sec_n:
            raise FrameError(
                f"binary frame carries {sec_n} section bytes but the "
                f"header declares no section table"
            )
    else:
        secs = WireSections.from_buffer(decl, sections)
        (obj if nest is None else obj[nest])[SECTIONS_KEY] = secs
    if meta is not None:
        meta["crc"] = True
        meta["wire"] = True
    return obj
