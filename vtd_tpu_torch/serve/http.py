"""Minimal HTTP framework, stdlib only (port of ``vtd_tpu/serve/http.py``).

The subset of FastAPI + uvicorn that the API surface needs: a threaded HTTP server, a router with ``{param}`` path segments,
JSON request/response objects, multipart/form-data and
x-www-form-urlencoded parsing (for uploads and OAuth2 password forms),
an ``HTTPException`` with FastAPI-compatible ``{"detail": ...}`` bodies,
and a middleware chain.

Middleware protocol: ``middleware(request, call_next) -> Response`` —
the same onion model as Starlette's BaseHTTPMiddleware, so the
middleware stack order from the reference (``app/main.py:75-79``)
carries over directly.
"""
from __future__ import annotations

import io
import json
import logging
import os
import re
import tempfile
import threading
import traceback
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, BinaryIO, Callable, Dict, Iterator, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

logger = logging.getLogger(__name__)

# Bodies and multipart file parts larger than this spill from RAM to a
# disk-backed temp file; file responses are written to the socket in
# chunks of _CHUNK.  The reference streams uploads through a temp file
# the same way (app/api/endpoints/videos.py:52-54).
SPOOL_THRESHOLD = 8 * 1024 * 1024
_CHUNK = 256 * 1024


class HTTPException(Exception):
    def __init__(self, status_code: int, detail: str = "", headers=None):
        super().__init__(detail)
        self.status_code = status_code
        self.detail = detail
        self.headers = headers or {}


class UploadFile:
    """A parsed multipart file part.

    Backed by a spooled temp file, so a part larger than
    ``SPOOL_THRESHOLD`` never lives in RAM as one object.  ``len()``
    gives the part size; ``read()`` materializes bytes (small parts /
    tests); ``save_to()`` streams to a destination path.
    """

    def __init__(self, filename: str, fileobj: BinaryIO, size: int):
        self.filename = filename
        self._f = fileobj
        self.size = size

    def __len__(self) -> int:
        return self.size

    def read(self) -> bytes:
        self._f.seek(0)
        return self._f.read()

    def chunks(self, size: int = _CHUNK) -> Iterator[bytes]:
        self._f.seek(0)
        while True:
            data = self._f.read(size)
            if not data:
                return
            yield data

    def save_to(self, path: str) -> None:
        with open(path, "wb") as out:
            for chunk in self.chunks():
                out.write(chunk)

    def close(self) -> None:
        self._f.close()


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, str]
    headers: Dict[str, str]
    body: bytes = b""
    path_params: Dict[str, str] = field(default_factory=dict)
    client_ip: str = ""
    state: Dict[str, Any] = field(default_factory=dict)
    # Large bodies arrive spooled to disk instead of as `body` bytes.
    body_file: Optional[BinaryIO] = None

    def _read_body(self) -> bytes:
        if self.body_file is not None:
            self.body_file.seek(0)
            return self.body_file.read()
        return self.body

    def _body_stream(self) -> BinaryIO:
        if self.body_file is not None:
            self.body_file.seek(0)
            return self.body_file
        return io.BytesIO(self.body)

    def json(self) -> Any:
        data = self._read_body()
        if not data:
            return {}
        try:
            return json.loads(data.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            raise HTTPException(400, "Invalid JSON body")

    def _multipart(self) -> Tuple[Dict[str, str], Dict[str, Tuple[str, UploadFile]]]:
        cached = self.state.get("_multipart_cache")
        if cached is None:
            cached = parse_multipart_stream(
                self._body_stream(), self.headers.get("content-type", "")
            )
            self.state["_multipart_cache"] = cached
        return cached

    def form(self) -> Dict[str, str]:
        ctype = self.headers.get("content-type", "")
        if "application/x-www-form-urlencoded" in ctype:
            parsed = parse_qs(
                self._read_body().decode("utf-8"), keep_blank_values=True
            )
            return {k: v[0] for k, v in parsed.items()}
        if "multipart/form-data" in ctype:
            return self._multipart()[0]
        return {}

    def files(self) -> Dict[str, Tuple[str, UploadFile]]:
        ctype = self.headers.get("content-type", "")
        if "multipart/form-data" in ctype:
            return self._multipart()[1]
        return {}


@dataclass
class Response:
    status_code: int = 200
    content: Any = None
    headers: Dict[str, str] = field(default_factory=dict)
    media_type: str = "application/json"
    body_bytes: Optional[bytes] = None
    # Set (via FileResponse) to stream a file from disk instead of
    # holding the payload in memory; takes precedence over content.
    file_path: Optional[str] = None

    def render(self) -> bytes:
        if self.file_path is not None:
            with open(self.file_path, "rb") as f:
                return f.read()
        if self.body_bytes is not None:
            return self.body_bytes
        if self.content is None:
            return b""
        if isinstance(self.content, (bytes, bytearray)):
            return bytes(self.content)
        if isinstance(self.content, str):
            return self.content.encode("utf-8")
        return json.dumps(self.content, default=str).encode("utf-8")


def FileResponse(path: str, filename: str = "", media_type: str = "application/octet-stream") -> Response:
    """File-backed response.  The socket handler streams it in
    ``_CHUNK`` pieces; ``render()`` (TestClient path) materializes it."""
    headers = {}
    if filename:
        headers["Content-Disposition"] = f'attachment; filename="{filename}"'
    resp = Response(200, None, headers, media_type)
    resp.file_path = path
    return resp


def parse_multipart_stream(
    stream: BinaryIO, content_type: str, spool_threshold: int = SPOOL_THRESHOLD
) -> Tuple[Dict[str, str], Dict[str, Tuple[str, UploadFile]]]:
    """Incrementally parse multipart/form-data from a byte stream.

    File parts are written to spooled temp files as they arrive, so a
    multi-hundred-MB upload costs ``O(_CHUNK)`` RAM (the reference gets
    the same property from Starlette's multipart parser +
    ``shutil.copyfileobj`` at app/api/endpoints/videos.py:52-54).

    Returns ``(fields, files)`` with files mapping field name ->
    ``(filename, UploadFile)``.
    """
    m = re.search(r"boundary=([^;]+)", content_type)
    if not m:
        raise HTTPException(400, "Malformed multipart body")
    boundary = b"--" + m.group(1).strip('"').encode()
    fields: Dict[str, str] = {}
    files: Dict[str, Tuple[str, UploadFile]] = {}

    buf = b""

    def fill() -> bool:
        nonlocal buf
        data = stream.read(_CHUNK)
        if not data:
            return False
        buf += data
        return True

    # First delimiter line (no preceding CRLF required at stream start).
    # Preamble bytes before it are discardable — keep only a tail that
    # could be a boundary prefix, so a body that never contains the
    # declared boundary costs O(_CHUNK) RAM, not O(Content-Length).
    while boundary not in buf:
        if len(buf) > len(boundary):
            buf = buf[-(len(boundary) - 1):]
        if not fill():
            return fields, files
    buf = buf[buf.index(boundary) + len(boundary):]

    while True:
        while len(buf) < 2:
            if not fill():
                return fields, files
        if buf.startswith(b"--"):
            return fields, files  # closing "--boundary--"
        # Framing newline after the delimiter line.
        if buf.startswith(b"\r\n"):
            buf = buf[2:]
        elif buf.startswith(b"\n"):
            buf = buf[1:]
        # Part headers (bounded: a part whose header block never
        # terminates must not buffer the whole body in RAM).
        while b"\r\n\r\n" not in buf and b"\n\n" not in buf:
            if len(buf) > 65536:
                raise HTTPException(400, "Malformed multipart body")
            if not fill():
                return fields, files
        # Earliest terminator wins: preferring CRLF over LF would let a
        # CRLFCRLF inside a binary *body* hijack the header split of a
        # bare-LF-headed part.
        i_crlf = buf.find(b"\r\n\r\n")
        i_lf = buf.find(b"\n\n")
        if i_crlf >= 0 and (i_lf < 0 or i_crlf < i_lf):
            sep = b"\r\n\r\n"
        else:
            sep = b"\n\n"
        raw_headers, buf = buf.split(sep, 1)
        disp = ""
        for line in raw_headers.splitlines():
            if line.lower().startswith(b"content-disposition"):
                disp = line.decode("utf-8", "replace")
        name_m = re.search(r'name="([^"]*)"', disp)
        file_m = re.search(r'filename="([^"]*)"', disp)
        is_file = bool(name_m and file_m)
        sink: BinaryIO
        if is_file:
            sink = tempfile.SpooledTemporaryFile(max_size=spool_threshold)
        else:
            sink = io.BytesIO()
        size = 0

        # Part body: everything up to "\n--boundary" (covers CRLF and
        # bare-LF framing; a trailing \r before the cut is framing too).
        # Non-file fields stay in RAM, so they get the same 64 KB cap as
        # the header block — a multi-GB field part must not buffer
        # O(Content-Length) in the BytesIO (file parts spool to disk).
        field_cap = None if is_file else 65536
        delim = b"\n" + boundary
        while True:
            j = buf.find(delim)
            if j >= 0:
                cut = j - 1 if j > 0 and buf[j - 1:j] == b"\r" else j
                sink.write(buf[:cut])
                size += cut
                buf = buf[j + len(delim):]
                break
            # Keep a tail that could be a delimiter prefix; flush the rest.
            keep = len(delim) + 1
            if len(buf) > keep:
                sink.write(buf[:-keep])
                size += len(buf) - keep
                buf = buf[-keep:]
            if field_cap is not None and size > field_cap:
                raise HTTPException(400, "Multipart form field too large")
            if not fill():
                sink.write(buf)
                size += len(buf)
                buf = b""
                break
        if field_cap is not None and size > field_cap:
            raise HTTPException(400, "Multipart form field too large")

        if name_m:
            name = name_m.group(1)
            if is_file:
                sink.seek(0)
                files[name] = (file_m.group(1), UploadFile(file_m.group(1), sink, size))
            else:
                fields[name] = sink.getvalue().decode("utf-8", "replace")  # type: ignore[attr-defined]
        else:
            sink.close()
        if not buf and not fill():
            return fields, files


def parse_multipart(
    body: bytes, content_type: str
) -> Tuple[Dict[str, str], Dict[str, Tuple[str, bytes]]]:
    """Parse an in-memory multipart body. Returns (fields, files) where
    files maps field name -> (filename, bytes). Thin materializing
    wrapper over :func:`parse_multipart_stream`."""
    fields, ufiles = parse_multipart_stream(io.BytesIO(body), content_type)
    files = {k: (fname, uf.read()) for k, (fname, uf) in ufiles.items()}
    for _, uf in ufiles.values():
        uf.close()
    return fields, files


Handler = Callable[[Request], Response]
Middleware = Callable[[Request, Callable[[Request], Response]], Response]


class Route:
    _PARAM_RE = re.compile(r"{(\w+)}")

    def __init__(self, method: str, pattern: str, handler: Handler):
        self.method = method
        self.handler = handler
        regex = self._PARAM_RE.sub(r"(?P<\1>[^/]+)", pattern.rstrip("/") or "/")
        self.regex = re.compile("^" + regex + "/?$")

    def match(self, method: str, path: str):
        if method != self.method:
            return None
        return self.regex.match(path)


class App:
    """Router + middleware chain + exception handling."""

    def __init__(self):
        self.routes: List[Route] = []
        self.middleware: List[Middleware] = []
        self.mounts: List[Tuple[str, Handler]] = []
        self.on_startup: List[Callable[[], None]] = []

    # -- registration ---------------------------------------------------
    def route(self, method: str, pattern: str):
        def deco(fn: Handler) -> Handler:
            self.routes.append(Route(method, pattern, fn))
            return fn

        return deco

    def get(self, pattern):
        return self.route("GET", pattern)

    def post(self, pattern):
        return self.route("POST", pattern)

    def put(self, pattern):
        return self.route("PUT", pattern)

    def delete(self, pattern):
        return self.route("DELETE", pattern)

    def mount(self, prefix: str, handler: Handler):
        self.mounts.append((prefix, handler))

    def add_middleware(self, mw: Middleware):
        """Innermost-first, matching FastAPI's add_middleware semantics
        (the last one added sees the request first)."""
        self.middleware.append(mw)

    # -- dispatch ---------------------------------------------------------
    def _find(self, request: Request) -> Handler:
        for prefix, handler in self.mounts:
            if request.path.startswith(prefix):
                return handler
        allowed = []
        for route in self.routes:
            m = route.match(request.method, request.path)
            if m:
                request.path_params = m.groupdict()
                return route.handler
            if route.regex.match(request.path):
                allowed.append(route.method)
        if allowed:
            raise HTTPException(405, "Method not allowed")
        raise HTTPException(404, "Not found")

    def handle(self, request: Request) -> Response:
        def endpoint(req: Request) -> Response:
            # HTTPException -> Response INSIDE the middleware chain, so
            # 4xx/auth errors still get CORS + security headers, access
            # logging, and metrics (FastAPI parity: its exception
            # handlers run inside the middleware stack; converting only
            # in the outer catch left error responses undecorated and
            # invisible to http_requests_total).
            try:
                handler = self._find(req)
                return handler(req)
            except HTTPException as exc:
                # FastAPI-compatible body (reference app/main.py:108-121)
                return Response(
                    exc.status_code,
                    {
                        "detail": exc.detail,
                        "status_code": exc.status_code,
                        "path": req.path,
                    },
                    headers=exc.headers,
                )

        call = endpoint
        for mw in self.middleware:
            call = (lambda m, nxt: lambda req: m(req, nxt))(mw, call)

        try:
            return call(request)
        except HTTPException as exc:
            # raised by a middleware itself — safety net
            return Response(
                exc.status_code,
                {
                    "detail": exc.detail,
                    "status_code": exc.status_code,
                    "path": request.path,
                },
                headers=exc.headers,
            )
        except Exception:
            logger.error("Unhandled exception:\n%s", traceback.format_exc())
            return Response(
                500,
                {
                    "detail": "Internal server error",
                    "status_code": 500,
                    "path": request.path,
                },
            )


class _HTTPHandler(BaseHTTPRequestHandler):
    app: App = None  # type: ignore
    protocol_version = "HTTP/1.1"

    def _run(self):
        parsed = urlparse(self.path)
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        length = int(self.headers.get("Content-Length") or 0)
        body = b""
        body_file = None
        if length > SPOOL_THRESHOLD:
            # Spool big bodies (uploads) to disk in chunks: peak RSS is
            # O(_CHUNK), not O(Content-Length).
            body_file = tempfile.SpooledTemporaryFile(max_size=SPOOL_THRESHOLD)
            remaining = length
            while remaining > 0:
                chunk = self.rfile.read(min(_CHUNK, remaining))
                if not chunk:
                    break
                body_file.write(chunk)
                remaining -= len(chunk)
            if remaining > 0:
                # Client disconnected mid-body: a truncated upload must
                # NOT reach the handler (it would be stored as a valid
                # video and fail later at decode). Starlette raises
                # ClientDisconnect here; the socket is dead, so just
                # drop the connection.
                logger.warning(
                    "client disconnected %d bytes into a %d-byte body",
                    length - remaining, length,
                )
                body_file.close()
                self.close_connection = True
                return
            body_file.seek(0)
        elif length:
            body = self.rfile.read(length)
            if len(body) < length:
                logger.warning(
                    "client disconnected %d bytes into a %d-byte body",
                    len(body), length,
                )
                self.close_connection = True
                return
        request = Request(
            method=self.command,
            path=parsed.path,
            query=query,
            headers={k.lower(): v for k, v in self.headers.items()},
            body=body,
            client_ip=self.client_address[0],
            body_file=body_file,
        )
        try:
            response = self.app.handle(request)
            if response.file_path is not None:
                size = os.path.getsize(response.file_path)
                self.send_response(response.status_code)
                self.send_header("Content-Type", response.media_type)
                self.send_header("Content-Length", str(size))
                for k, v in response.headers.items():
                    self.send_header(k, v)
                self.end_headers()
                with open(response.file_path, "rb") as f:
                    while True:
                        chunk = f.read(_CHUNK)
                        if not chunk:
                            break
                        self.wfile.write(chunk)
                return
            payload = response.render()
            self.send_response(response.status_code)
            self.send_header("Content-Type", response.media_type)
            self.send_header("Content-Length", str(len(payload)))
            for k, v in response.headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)
        finally:
            if body_file is not None:
                body_file.close()

    do_GET = do_POST = do_PUT = do_DELETE = do_PATCH = do_OPTIONS = _run

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug(fmt, *args)


class Server:
    """Threaded HTTP server wrapper."""

    def __init__(self, app: App, host: str = "0.0.0.0", port: int = 8000):
        handler = type("BoundHandler", (_HTTPHandler,), {"app": app})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.app = app
        self.thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start_background(self):
        for fn in self.app.on_startup:
            fn()
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self.thread.start()

    def serve_forever(self):
        for fn in self.app.on_startup:
            fn()
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class TestClient:
    """In-process client (no socket): the fake-backend test strategy of
    the reference's ``fastapi.testclient`` usage (tests/test_api.py)."""

    def __init__(self, app: App):
        self.app = app
        for fn in app.on_startup:
            fn()

    def request(
        self,
        method: str,
        path: str,
        json_body: Any = None,
        data: Optional[Dict[str, str]] = None,
        files: Optional[Dict[str, Tuple[str, bytes]]] = None,
        headers: Optional[Dict[str, str]] = None,
        params: Optional[Dict[str, Any]] = None,
    ) -> Response:
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        body = b""
        if json_body is not None:
            body = json.dumps(json_body).encode()
            headers["content-type"] = "application/json"
        elif files is not None:
            boundary = "testboundary123"
            parts = []
            for k, v in (data or {}).items():
                parts.append(
                    f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
                )
            for k, (fname, fdata) in files.items():
                parts.append(
                    f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"; filename="{fname}"\r\n\r\n'.encode()
                    + fdata
                    + b"\r\n"
                )
            parts.append(f"--{boundary}--\r\n".encode())
            body = b"".join(parts)
            headers["content-type"] = f"multipart/form-data; boundary={boundary}"
        elif data is not None:
            from urllib.parse import urlencode

            body = urlencode(data).encode()
            headers["content-type"] = "application/x-www-form-urlencoded"

        parsed = urlparse(path)
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        if params:
            query.update({k: str(v) for k, v in params.items()})
        req = Request(
            method=method,
            path=parsed.path,
            query=query,
            headers=headers,
            body=body,
            client_ip="127.0.0.1",
        )
        resp = self.app.handle(req)
        resp.json = lambda: json.loads(resp.render() or b"null")  # type: ignore
        return resp

    def get(self, path, **kw):
        return self.request("GET", path, **kw)

    def post(self, path, **kw):
        return self.request("POST", path, **kw)

    def put(self, path, **kw):
        return self.request("PUT", path, **kw)

    def delete(self, path, **kw):
        return self.request("DELETE", path, **kw)
