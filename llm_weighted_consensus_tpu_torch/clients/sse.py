"""Incremental server-sent-events decoder.

Parses a raw byte stream into SSE ``data:`` payloads.  This is hot loop #1
of the serving path (SURVEY §3.5): per-token work on every judge stream.
The pure-Python ``SSEParser`` has a C++ twin (``native/sse_parser.cpp``,
loaded through ctypes as ``NativeSSEParser``); ``make_parser`` picks the
native one when the shared library builds/loads, falling back silently
otherwise.  Both are run over one corpus by tests/test_native.py (split
feeds, CRLF, comments, flush).  Set ``LWC_NATIVE_SSE=0`` to force the
Python parser.

Frame semantics (the subset OpenAI-compatible providers emit, matching what
reqwest-eventsource accepts in the reference — chat client.rs:334-434):
``data:`` field lines accumulate per event (joined by newline), events end at
a blank line, ``:`` comment lines and other fields (``event:``/``id:``/
``retry:``) are ignored, and both LF and CRLF line endings are accepted.

Byte budgets: both parsers accept a
``max_buffer_bytes`` cap on the newline-less residue and a
``max_event_bytes`` cap on one event's accumulated ``data:`` payload
(value bytes plus joining newlines).  A hostile upstream streaming a
newline-less flood or one giant line trips a typed
:class:`~..errors.IngestCapError` instead of growing the buffer without
bound.  Trip semantics are part of the Python/native parity contract
(tests/test_native.py): events completed before the offending line still
surface, the oversized state is dropped (buffer/open event cleared), and
the parser stays usable for subsequent feeds.  ``0`` disables a cap.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional

from ..errors import IngestCapError


class SSEParser:
    """Push bytes in, pull decoded event data strings out."""

    def __init__(
        self, max_buffer_bytes: int = 0, max_event_bytes: int = 0
    ) -> None:
        self._buffer = bytearray()
        self._data_lines: list = []
        # accumulated byte size of the open event (value bytes + joining
        # newlines) — the quantity max_event_bytes caps.  Counted on the
        # raw bytes, pre-decode, so the native twin trips on the exact
        # same boundary.
        self._event_bytes = 0
        self.max_buffer_bytes = int(max_buffer_bytes)
        self.max_event_bytes = int(max_event_bytes)
        self.cap_trips = 0
        # events dispatched over this parser's lifetime — read by the
        # chat client at stream end as a judge-span trace attribute
        self.events_parsed = 0

    def feed(self, data: bytes) -> Iterator[str]:
        """Consume a chunk of bytes; yield completed event payloads.

        Raises :class:`IngestCapError` (after yielding any events that
        completed first) when a byte budget trips."""
        self._buffer.extend(data)
        while True:
            nl = self._buffer.find(b"\n")
            if nl < 0:
                if (
                    self.max_buffer_bytes
                    and len(self._buffer) > self.max_buffer_bytes
                ):
                    observed = len(self._buffer)
                    # drop the oversized residue: the parser must stay
                    # bounded AND usable if the caller keeps feeding
                    self._buffer = bytearray()
                    self.cap_trips += 1
                    raise IngestCapError(
                        "sse_buffer", self.max_buffer_bytes, observed
                    )
                return
            line = bytes(self._buffer[:nl])
            del self._buffer[: nl + 1]
            if line.endswith(b"\r"):
                line = line[:-1]
            event = self._feed_line(line)
            if event is not None:
                yield event

    def _feed_line(self, line: bytes) -> Optional[str]:
        if not line:
            # dispatch event
            if self._data_lines:
                event = "\n".join(self._data_lines)
                self._data_lines = []
                self._event_bytes = 0
                self.events_parsed += 1
                return event
            return None
        if line.startswith(b":"):
            return None  # comment
        field, _, value = line.partition(b":")
        if value.startswith(b" "):
            value = value[1:]
        if field == b"data":
            grown = self._event_bytes + len(value) + (
                1 if self._data_lines else 0
            )
            if self.max_event_bytes and grown > self.max_event_bytes:
                # drop the oversized open event; the offending line is
                # already consumed, so parsing can resume cleanly
                self._data_lines = []
                self._event_bytes = 0
                self.cap_trips += 1
                raise IngestCapError(
                    "sse_event", self.max_event_bytes, grown
                )
            self._event_bytes = grown
            self._data_lines.append(value.decode("utf-8", errors="replace"))
        # other fields (event/id/retry) are ignored
        return None

    def flush(self) -> Optional[str]:
        """End-of-stream: the remaining buffered bytes count as a final
        (newline-less) line, then any open event is dispatched — streams
        cut mid-event still surface their last frame."""
        if self._buffer:
            line = bytes(self._buffer)
            self._buffer = bytearray()
            if line.endswith(b"\r"):
                line = line[:-1]
            # the residual may itself be the dispatching blank line (stream
            # cut between CR and LF): surface that event too
            event = self._feed_line(line)
            if event is not None:
                return event
        if self._data_lines:
            event = "\n".join(self._data_lines)
            self._data_lines = []
            self._event_bytes = 0
            self.events_parsed += 1
            return event
        return None


# -- native twin --------------------------------------------------------------

_native_lib = None
_native_tried = False

# trip kinds returned by sse_parser_take_trip (native/sse_parser.cpp)
_TRIP_BUFFER = 1
_TRIP_EVENT = 2


def load_native_library():
    """The C++ parser out of the framework-wide native library
    (utils.native builds/loads the single .so for all native components).
    Blocking on first call — call from sync startup code
    (DefaultChatClient.__init__ does), never from the event loop;
    ``make_parser`` afterwards only reads the cache.  Returns None — and
    remembers the failure — when the library can't be built or loaded, or
    when ``LWC_NATIVE_SSE=0``."""
    global _native_lib, _native_tried
    if _native_tried:
        return _native_lib
    _native_tried = True
    if os.environ.get("LWC_NATIVE_SSE", "1").lower() in ("0", "false", "no"):
        return None
    from ..utils.native import load_library

    lib = load_library()
    if lib is None:
        return None
    try:
        lib.sse_parser_new.restype = ctypes.c_void_p
        lib.sse_parser_new.argtypes = []
        lib.sse_parser_free.argtypes = [ctypes.c_void_p]
        lib.sse_parser_feed.restype = ctypes.c_size_t
        lib.sse_parser_feed.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_size_t,
        ]
        lib.sse_parser_next_event.restype = ctypes.c_void_p
        lib.sse_parser_next_event.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.sse_parser_flush.restype = ctypes.c_size_t
        lib.sse_parser_flush.argtypes = [ctypes.c_void_p]
        # byte-budget ABI; a prebuilt .so predating the caps
        # raises AttributeError here, disabling the native path entirely
        # rather than serving an uncappable parser
        lib.sse_parser_set_caps.restype = None
        lib.sse_parser_set_caps.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_size_t,
        ]
        lib.sse_parser_take_trip.restype = ctypes.c_int
        lib.sse_parser_take_trip.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        _native_lib = lib
    except Exception:
        _native_lib = None
    return _native_lib


class NativeSSEParser:
    """ctypes wrapper over native/sse_parser.cpp — same interface and frame
    semantics as ``SSEParser``, caps included (parity-tested in
    tests/test_native.py)."""

    def __init__(
        self,
        lib=None,
        max_buffer_bytes: int = 0,
        max_event_bytes: int = 0,
    ) -> None:
        self._lib = lib or load_native_library()
        if self._lib is None:
            raise RuntimeError("native SSE parser unavailable")
        self._handle = self._lib.sse_parser_new()
        self.max_buffer_bytes = int(max_buffer_bytes)
        self.max_event_bytes = int(max_event_bytes)
        if self.max_buffer_bytes or self.max_event_bytes:
            self._lib.sse_parser_set_caps(
                self._handle, self.max_buffer_bytes, self.max_event_bytes
            )
        self.cap_trips = 0
        self.events_parsed = 0  # same contract as SSEParser

    def _drain(self) -> Iterator[str]:
        out_len = ctypes.c_size_t()
        while True:
            ptr = self._lib.sse_parser_next_event(
                self._handle, ctypes.byref(out_len)
            )
            if not ptr:
                return
            self.events_parsed += 1
            yield ctypes.string_at(ptr, out_len.value).decode(
                "utf-8", errors="replace"
            )

    def _raise_if_tripped(self) -> None:
        observed = ctypes.c_size_t()
        kind = self._lib.sse_parser_take_trip(
            self._handle, ctypes.byref(observed)
        )
        if kind == 0:
            return
        self.cap_trips += 1
        if kind == _TRIP_BUFFER:
            raise IngestCapError(
                "sse_buffer", self.max_buffer_bytes, observed.value
            )
        raise IngestCapError(
            "sse_event", self.max_event_bytes, observed.value
        )

    def _drain_then_trip(self) -> Iterator[str]:
        # events completed before the offending line surface first, then
        # the trip raises — byte-identical to the Python generator, which
        # yields as it parses and raises at the offending line
        yield from self._drain()
        self._raise_if_tripped()

    def feed(self, data: bytes) -> Iterator[str]:
        self._lib.sse_parser_feed(self._handle, data, len(data))
        return self._drain_then_trip()

    def flush(self) -> Optional[str]:
        n = self._lib.sse_parser_flush(self._handle)
        event = next(self._drain(), None) if n else None
        self._raise_if_tripped()
        return event

    def close(self) -> None:
        if self._handle is not None:
            self._lib.sse_parser_free(self._handle)
            self._handle = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


def make_parser(max_buffer_bytes: int = 0, max_event_bytes: int = 0):
    """The serving path's parser factory: native when available, else the
    pure-Python implementation (identical semantics either way).  Caps of
    0 disable the corresponding byte budget."""
    lib = load_native_library()
    if lib is not None:
        return NativeSSEParser(
            lib,
            max_buffer_bytes=max_buffer_bytes,
            max_event_bytes=max_event_bytes,
        )
    return SSEParser(
        max_buffer_bytes=max_buffer_bytes,
        max_event_bytes=max_event_bytes,
    )
