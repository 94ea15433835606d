"""ctypes binding for the native HTTP MJPEG live-view server
(native/streamsink.cpp).

The reference shows frames in a native window (reference: src/boilerplate.rs
swapchain present + src/debugui.rs overlay); on a headless accelerator host the
equivalent is a browser-viewable live stream.  `StreamSink.submit` costs the
simulation thread one frame copy; JPEG encoding and client IO run on native
threads.  Falls back to a pure-Python ThreadingHTTPServer + PIL encoder when
the native toolchain is unavailable, so `--serve` always works.
"""

from __future__ import annotations

import ctypes
import io
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libstreamsink.so"))


def _build_lib() -> Optional[str]:
    src = os.path.abspath(os.path.join(_NATIVE_DIR, "streamsink.cpp"))
    fresh = os.path.exists(_LIB_PATH) and (
        not os.path.exists(src)
        or os.path.getmtime(_LIB_PATH) >= os.path.getmtime(src)
    )
    if fresh:
        return _LIB_PATH
    try:
        subprocess.run(
            ["make", "-C", os.path.abspath(_NATIVE_DIR), "libstreamsink.so"],
            check=True,
            capture_output=True,
        )
        return _LIB_PATH if os.path.exists(_LIB_PATH) else None
    except Exception:
        return None


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = _build_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.ss_create.restype = ctypes.c_void_p
    lib.ss_create.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4
    lib.ss_port.restype = ctypes.c_int
    lib.ss_port.argtypes = [ctypes.c_void_p]
    lib.ss_submit.restype = ctypes.c_int
    lib.ss_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ss_clients.restype = ctypes.c_long
    lib.ss_clients.argtypes = [ctypes.c_void_p]
    lib.ss_frames.restype = ctypes.c_long
    lib.ss_frames.argtypes = [ctypes.c_void_p]
    lib.ss_poll_keys.restype = ctypes.c_int
    lib.ss_poll_keys.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    if hasattr(lib, "ss_set_key_token"):  # a stale .so predates the token API
        lib.ss_set_key_token.restype = None
        lib.ss_set_key_token.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ss_close.restype = None
    lib.ss_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class _PyMjpegServer:
    """Pure-Python fallback: ThreadingHTTPServer streaming PIL-encoded JPEG."""

    def __init__(self, port: int, quality: int, bind: str = "127.0.0.1",
                 key_token: str = ""):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._key_token = key_token
        self._cond = threading.Condition()
        self._jpeg: Optional[bytes] = None
        self._seq = 0
        self.frames = 0
        self._keys_mu = threading.Lock()
        self._keys: list = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/key?"):
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    if outer._key_token and (
                        (q.get("t") or [""])[0] != outer._key_token
                    ):
                        self.send_response(403)
                        self.end_headers()
                        return
                    name = (q.get("k") or [""])[0]
                    down = (q.get("d") or ["1"])[0] != "0"
                    if name and len(name) <= 32 and "\n" not in name:
                        with outer._keys_mu:
                            if len(outer._keys) < 256:
                                outer._keys.append((name, down))
                    self.send_response(204)
                    self.end_headers()
                elif self.path.startswith("/stream"):
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=spacetimeframe",
                    )
                    self.end_headers()
                    last = 0
                    try:
                        while True:
                            with outer._cond:
                                outer._cond.wait_for(
                                    lambda: outer._seq != last, timeout=1.0
                                )
                                if outer._seq == last or outer._jpeg is None:
                                    continue
                                frame, last = outer._jpeg, outer._seq
                            self.wfile.write(
                                b"--spacetimeframe\r\n"
                                b"Content-Type: image/jpeg\r\n"
                                b"Content-Length: %d\r\n\r\n" % len(frame)
                            )
                            self.wfile.write(frame)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        return
                else:
                    body = (
                        b"<!doctype html><html><body style='margin:0;background:#111'>"
                        b"<img src='/stream'></body></html>"
                    )
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

        self._srv = ThreadingHTTPServer((bind, port), Handler)
        self.port = self._srv.server_port
        self._quality = quality
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()

    def submit(self, arr: np.ndarray) -> None:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=self._quality)
        with self._cond:
            self._jpeg = buf.getvalue()
            self._seq += 1
            self.frames += 1
            self._cond.notify_all()

    def poll_keys(self) -> list:
        with self._keys_mu:
            out, self._keys = self._keys, []
        return out

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


class StreamSink:
    """Live MJPEG-over-HTTP view: submit (H, W, 3) float [0,1] or uint8
    frames; browse to http://host:port/ to watch."""

    def __init__(self, port: int, width: int, height: int, quality: int = 85,
                 bind: str = "127.0.0.1", key_token: Optional[str] = None):
        """`bind` defaults to loopback: the stream has no auth, so exposing
        it to the network is opt-in (bind='0.0.0.0').

        `key_token`: shared secret gating /key input (which steers — and via
        'q' can terminate — the engine).  On a non-loopback bind a token is
        REQUIRED unless key_token='' explicitly opts out; browse to
        http://host:port/?t=<token> so the page echoes it on key events.
        The pure-Python fallback applies the same gate."""
        # Resolve to a literal IPv4 address up front: the native server
        # falls back to LOOPBACK whenever inet_pton fails (hostnames, IPv6),
        # which would silently serve on 127.0.0.1 while the CLI prints the
        # requested host.  Resolving here makes both backends behave the
        # same and turns an unresolvable bind into a loud error.
        import socket

        try:
            socket.inet_aton(bind)
        except OSError:
            bind = socket.gethostbyname(bind)
        if key_token is None:
            if bind.startswith("127."):
                key_token = ""  # loopback: the host boundary is the gate
            else:
                import secrets

                key_token = secrets.token_urlsafe(12)
        self.bind = bind
        self.key_token = key_token
        self.width, self.height = width, height
        self._lib = _load()
        self._handle = None
        self._py: Optional[_PyMjpegServer] = None
        if self._lib is not None:
            self._handle = self._lib.ss_create(
                bind.encode(), port, width, height, quality
            )
            if self._handle is not None and key_token and hasattr(
                self._lib, "ss_set_key_token"
            ):
                self._lib.ss_set_key_token(self._handle, key_token.encode())
        if self._handle is None:
            self._py = _PyMjpegServer(
                port, quality, bind=bind, key_token=key_token
            )

    @property
    def native(self) -> bool:
        return self._handle is not None

    @property
    def port(self) -> int:
        if self._handle is not None:
            return int(self._lib.ss_port(self._handle))
        return self._py.port

    @property
    def frames_encoded(self) -> int:
        if self._handle is not None:
            return int(self._lib.ss_frames(self._handle))
        return self._py.frames

    @property
    def clients(self) -> int:
        if self._handle is not None:
            return int(self._lib.ss_clients(self._handle))
        return -1  # not tracked by the fallback

    def _to_u8(self, frame) -> np.ndarray:
        arr = np.asarray(frame)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
        assert arr.shape == (self.height, self.width, 3), arr.shape
        return np.ascontiguousarray(arr)

    def submit(self, frame) -> None:
        arr = self._to_u8(frame)
        if self._handle is not None:
            self._lib.ss_submit(self._handle, arr.tobytes())
        else:
            self._py.submit(arr)

    def poll_keys(self) -> list:
        """Drain key events posted by browser clients (GET /key?d=&k=) as
        [(key_name, down), ...] in arrival order — the winit keyboard-event
        queue of the reference (src/keyboard.rs:3-45) over HTTP."""
        if self._handle is not None:
            buf = ctypes.create_string_buffer(16384)
            n = self._lib.ss_poll_keys(self._handle, buf, len(buf))
            out = []
            for line in buf.raw[:n].decode("utf-8", "replace").splitlines():
                if len(line) >= 3 and line[1] == " ":
                    out.append((line[2:], line[0] != "0"))
            return out
        return self._py.poll_keys()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ss_close(self._handle)
            self._handle = None
        if self._py is not None:
            self._py.close()
            self._py = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
