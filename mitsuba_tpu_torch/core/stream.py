"""General-purpose binary streams — the libcore Stream family (port of
mitsuba_tpu/core/stream.py; host bytes and numpy arrays, no device).

Rebuild of the reference's stream abstraction (stream.h:58): one typed,
endianness-aware API over interchangeable transports, so serialized
scenes, photon maps, and render protocol messages move the same way
whether the other end is a file, a memory buffer, a TCP socket, an
SSH-spawned worker's stdio, or a zlib-compressed wrapper of any of
those.  Implementations mirror the reference set:

* `FileStream`      — fstream.cpp (seekable, read/write/append modes)
* `MemoryStream`    — mstream.cpp (growable in-memory buffer)
* `SocketStream`    — sstream.cpp:37 (blocking exact-length TCP I/O)
* `PipeStream`      — sshstream.cpp:48 (stdio of a spawned command;
                      `ssh_stream()` reproduces the reference's
                      `ssh host mtssrv -ls` tunnel spawn,
                      src/mitsuba/mitsuba.cpp:310)
* `ZStream`         — zstream.cpp (incremental zlib over an inner
                      stream, independent inflate/deflate directions)
* `ConsoleStream`   — cstream.cpp (stdin/stdout)
* `MemoryMappedFile`— mmap.h (zero-copy numpy views of large files)

Differences from the reference, by design: Python ints are unbounded so
the typed API is explicit-width only (no `size_t` chameleon), strings
are UTF-8 (the reference is bytes-agnostic), and there is no TLS
"current stream" — streams are plain objects.

The byte-order contract matches stream.h:420: every stream starts in
little-endian (the native order of every format this framework reads
and of the machines it runs on), `set_byte_order` switches per-stream,
and multi-byte reads/writes swap as needed.
"""

from __future__ import annotations

import io
import mmap as _mmap
import os
import struct
import subprocess
import zlib

import numpy as np

__all__ = [
    "Stream",
    "FileStream",
    "MemoryStream",
    "SocketStream",
    "PipeStream",
    "ZStream",
    "ConsoleStream",
    "MemoryMappedFile",
    "ssh_stream",
]

_LE, _BE = "<", ">"


class StreamError(IOError):
    pass


class EOFError_(StreamError):
    """Exact-length read hit end of stream."""


class Stream:
    """Abstract typed binary stream (reference stream.h:58).

    Subclasses implement `_read(n) -> bytes (may be short, b'' = EOF)`,
    `_write(data) -> None`, and capability flags; everything typed is
    provided here.
    """

    def __init__(self):
        self._order = _LE

    # -- capabilities ---------------------------------------------------
    @property
    def can_read(self):
        return False

    @property
    def can_write(self):
        return False

    @property
    def can_seek(self):
        return False

    # -- raw transport (subclass responsibility) ------------------------
    def _read(self, n):
        raise StreamError("stream is not readable")

    def _write(self, data):
        raise StreamError("stream is not writable")

    def flush(self):
        pass

    def close(self):
        pass

    def seek(self, pos, whence=os.SEEK_SET):
        raise StreamError("stream is not seekable")

    def tell(self):
        raise StreamError("stream is not seekable")

    def size(self):
        raise StreamError("stream is not seekable")

    # -- byte order ------------------------------------------------------
    def set_byte_order(self, order):
        """'little' | 'big' | 'network' (= big, sstream.cpp default)."""
        if order in ("little", "le", _LE):
            self._order = _LE
        elif order in ("big", "be", "network", _BE):
            self._order = _BE
        else:
            raise ValueError(f"unknown byte order {order!r}")

    @property
    def byte_order(self):
        return "little" if self._order == _LE else "big"

    # -- exact-length raw I/O ---------------------------------------------
    def read(self, n):
        """Read exactly n bytes (raise EOFError_ on short read)."""
        parts, got = [], 0
        while got < n:
            chunk = self._read(n - got)
            if not chunk:
                raise EOFError_(
                    f"short read: wanted {n}, got {got} bytes"
                )
            parts.append(chunk)
            got += len(chunk)
        return b"".join(parts)

    def read_some(self, n):
        """Read up to n bytes (b'' at EOF) — for pump loops."""
        return self._read(n)

    def write(self, data):
        self._write(bytes(data))

    # -- typed scalar I/O --------------------------------------------------
    def _rd(self, fmt, size):
        return struct.unpack(self._order + fmt, self.read(size))[0]

    def _wr(self, fmt, value):
        self._write(struct.pack(self._order + fmt, value))

    def read_bool(self):
        return self._rd("?", 1)

    def read_u8(self):
        return self._rd("B", 1)

    def read_i8(self):
        return self._rd("b", 1)

    def read_u16(self):
        return self._rd("H", 2)

    def read_i16(self):
        return self._rd("h", 2)

    def read_u32(self):
        return self._rd("I", 4)

    def read_i32(self):
        return self._rd("i", 4)

    def read_u64(self):
        return self._rd("Q", 8)

    def read_i64(self):
        return self._rd("q", 8)

    def read_f16(self):
        return self._rd("e", 2)

    def read_f32(self):
        return self._rd("f", 4)

    def read_f64(self):
        return self._rd("d", 8)

    def write_bool(self, v):
        self._wr("?", bool(v))

    def write_u8(self, v):
        self._wr("B", v)

    def write_i8(self, v):
        self._wr("b", v)

    def write_u16(self, v):
        self._wr("H", v)

    def write_i16(self, v):
        self._wr("h", v)

    def write_u32(self, v):
        self._wr("I", v)

    def write_i32(self, v):
        self._wr("i", v)

    def write_u64(self, v):
        self._wr("Q", v)

    def write_i64(self, v):
        self._wr("q", v)

    def write_f16(self, v):
        self._wr("e", v)

    def write_f32(self, v):
        self._wr("f", v)

    def write_f64(self, v):
        self._wr("d", v)

    # -- strings (stream.h writeString: NUL-terminated) ---------------------
    def read_string(self):
        out = bytearray()
        while True:
            b = self.read(1)
            if b == b"\0":
                return out.decode("utf-8")
            out += b

    def write_string(self, s):
        self._write(s.encode("utf-8") + b"\0")

    def read_line(self, maxlen=1 << 20):
        out = bytearray()
        while len(out) < maxlen:
            b = self._read(1)
            if not b or b == b"\n":
                break
            if b != b"\r":
                out += b
        return out.decode("utf-8")

    def write_line(self, s):
        self._write(s.encode("utf-8") + b"\n")

    # -- numpy arrays --------------------------------------------------------
    def read_array(self, dtype, count):
        dt = np.dtype(dtype).newbyteorder(self._order)
        return (
            np.frombuffer(self.read(dt.itemsize * count), dtype=dt)
            .astype(np.dtype(dtype), copy=False)
        )

    def write_array(self, arr):
        a = np.ascontiguousarray(arr)
        dt = a.dtype.newbyteorder(self._order)
        self._write(a.astype(dt, copy=False).tobytes())

    # -- length-prefixed blobs (the render-service framing) -------------------
    def read_blob(self):
        return self.read(self.read_u64())

    def write_blob(self, data):
        self.write_u64(len(data))
        self._write(bytes(data))

    # -- context manager --------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class FileStream(Stream):
    """Seekable file stream (fstream.cpp). Modes: 'r', 'w', 'rw', 'a'."""

    _MODES = {"r": "rb", "w": "wb", "rw": "r+b", "a": "ab"}

    def __init__(self, path, mode="r"):
        super().__init__()
        if mode == "rw" and not os.path.exists(path):
            open(path, "wb").close()
        self._f = open(path, self._MODES[mode])
        self._mode = mode
        self.path = path

    @property
    def can_read(self):
        return self._mode in ("r", "rw")

    @property
    def can_write(self):
        return self._mode in ("w", "rw", "a")

    @property
    def can_seek(self):
        return True

    def _read(self, n):
        if not self.can_read:
            raise StreamError("file opened write-only")
        return self._f.read(n)

    def _write(self, data):
        if not self.can_write:
            raise StreamError("file opened read-only")
        self._f.write(data)

    def seek(self, pos, whence=os.SEEK_SET):
        self._f.seek(pos, whence)

    def tell(self):
        return self._f.tell()

    def size(self):
        return os.fstat(self._f.fileno()).st_size

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class MemoryStream(Stream):
    """Growable in-memory stream (mstream.cpp)."""

    def __init__(self, data=b""):
        super().__init__()
        self._buf = io.BytesIO(data)
        if data:
            self._buf.seek(0)

    @property
    def can_read(self):
        return True

    @property
    def can_write(self):
        return True

    @property
    def can_seek(self):
        return True

    def _read(self, n):
        return self._buf.read(n)

    def _write(self, data):
        self._buf.write(data)

    def seek(self, pos, whence=os.SEEK_SET):
        self._buf.seek(pos, whence)

    def tell(self):
        return self._buf.tell()

    def size(self):
        pos = self._buf.tell()
        self._buf.seek(0, os.SEEK_END)
        end = self._buf.tell()
        self._buf.seek(pos)
        return end

    def getvalue(self):
        return self._buf.getvalue()


class SocketStream(Stream):
    """Blocking exact-length I/O over a connected socket (sstream.cpp:37).

    Like the reference, reads loop until the requested length arrives and
    writes use sendall; the peer closing mid-message raises EOFError_.
    """

    def __init__(self, sock):
        super().__init__()
        self._sock = sock

    @property
    def can_read(self):
        return True

    @property
    def can_write(self):
        return True

    def _read(self, n):
        return self._sock.recv(min(n, 1 << 20))

    def _write(self, data):
        self._sock.sendall(data)

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    @classmethod
    def connect(cls, host, port, timeout=None):
        import socket as _socket

        return cls(_socket.create_connection((host, port), timeout))


class PipeStream(Stream):
    """Stdio of a spawned command — the SSHStream transport
    (sshstream.cpp:48) minus the ssh-specific argv.  Write goes to the
    child's stdin, read comes from its stdout; closing sends EOF and
    reaps the child."""

    def __init__(self, argv, env=None):
        super().__init__()
        self._proc = subprocess.Popen(
            argv,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            env=env,
        )
        self.argv = list(argv)

    @property
    def can_read(self):
        return True

    @property
    def can_write(self):
        return True

    def _read(self, n):
        return self._proc.stdout.read(n)

    def _write(self, data):
        self._proc.stdin.write(data)

    def flush(self):
        self._proc.stdin.flush()

    def close_write(self):
        """Send EOF to the child (keeps reading its remaining output)."""
        if self._proc.stdin and not self._proc.stdin.closed:
            self._proc.stdin.close()

    def close(self):
        self.close_write()
        if self._proc.stdout:
            self._proc.stdout.close()
        self._proc.wait(timeout=30)


def ssh_stream(host, command, *, user=None, port=None, extra=()):
    """Spawn `ssh [-l user] [-p port] host command` and return its
    PipeStream — the reference's remote-worker tunnel
    (src/mitsuba/mitsuba.cpp:310: `ssh host mtssrv -ls`)."""
    argv = ["ssh", "-x", "-T"]
    if user:
        argv += ["-l", user]
    if port:
        argv += ["-p", str(port)]
    argv += list(extra) + [host, command]
    return PipeStream(argv)


class ZStream(Stream):
    """Incremental zlib compression over an inner stream (zstream.cpp).

    The write direction deflates into the inner stream; `finish()` (or
    close) flushes the zlib trailer.  The read direction inflates from
    the inner stream with a bounded working buffer, so compressed blobs
    of any size stream through fixed memory.  Read and write use
    independent zlib contexts, matching the reference (a ZStream on a
    socket compresses both directions independently).
    """

    CHUNK = 1 << 16

    def __init__(self, inner, level=6, *, raw=False):
        super().__init__()
        wbits = -15 if raw else 15
        self.inner = inner
        self._comp = zlib.compressobj(level, zlib.DEFLATED, wbits)
        self._decomp = zlib.decompressobj(wbits)
        self._rbuf = b""
        self._finished = False

    @property
    def can_read(self):
        return self.inner.can_read

    @property
    def can_write(self):
        return self.inner.can_write

    def _read(self, n):
        while len(self._rbuf) < n:
            if self._decomp.eof:
                break
            raw = self._decomp.unconsumed_tail or self.inner.read_some(
                self.CHUNK
            )
            if not raw:
                self._rbuf += self._decomp.flush()
                break
            self._rbuf += self._decomp.decompress(raw, self.CHUNK)
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def _write(self, data):
        out = self._comp.compress(data)
        if out:
            self.inner.write(out)

    def flush(self):
        out = self._comp.flush(zlib.Z_SYNC_FLUSH)
        if out:
            self.inner.write(out)
        self.inner.flush()

    def finish(self):
        """Flush the zlib stream trailer (required before the inner
        stream's bytes are a complete zlib document)."""
        if not self._finished:
            out = self._comp.flush(zlib.Z_FINISH)
            if out:
                self.inner.write(out)
            self.inner.flush()
            self._finished = True

    def close(self):
        if self.can_write:
            self.finish()
        # the inner stream stays open — the caller owns it (zstream.cpp
        # keeps a ref and does not close its child either)


class ConsoleStream(Stream):
    """stdin/stdout as a stream (cstream.cpp) — what `mtssrv -ls` style
    stdio workers talk over."""

    def __init__(self, stdin=None, stdout=None):
        super().__init__()
        import sys

        self._in = stdin or sys.stdin.buffer
        self._out = stdout or sys.stdout.buffer

    @property
    def can_read(self):
        return True

    @property
    def can_write(self):
        return True

    def _read(self, n):
        return self._in.read(n)

    def _write(self, data):
        self._out.write(data)

    def flush(self):
        self._out.flush()


class MemoryMappedFile:
    """Zero-copy file mapping (mmap.h) with numpy views.

    `arr = MemoryMappedFile(path).view(np.float32)` maps a large asset
    (volume grid, photon dump) without reading it into RAM; writable
    mappings flush back on close.
    """

    def __init__(self, path, size=None, write=False):
        if write and size is not None and not os.path.exists(path):
            with open(path, "wb") as f:
                f.truncate(size)
        self._f = open(path, "r+b" if write else "rb")
        length = size or os.fstat(self._f.fileno()).st_size
        self._mm = _mmap.mmap(
            self._f.fileno(),
            length,
            access=_mmap.ACCESS_WRITE if write else _mmap.ACCESS_READ,
        )
        self.path = path
        self.writable = write

    def __len__(self):
        return len(self._mm)

    def view(self, dtype=np.uint8, offset=0, count=-1):
        return np.frombuffer(self._mm, dtype=dtype, offset=offset,
                             count=count)

    @property
    def data(self):
        return self._mm

    def flush(self):
        self._mm.flush()

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
