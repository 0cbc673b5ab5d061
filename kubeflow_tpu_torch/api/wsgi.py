"""Minimal WSGI micro-framework (copy of the subset of
kubeflow_tpu/api/wsgi.py the port's model server uses).

- path patterns with <named> segments,
- JSON in/out, error envelope {"success": false, "log": msg},
- a threaded stdlib server on a background thread for real sockets
  (`App.handle_full` is the direct-call interface).
"""

from __future__ import annotations

import json
import re
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import default_registry

log = get_logger(__name__)

Handler = Callable[["Request"], Any]


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class NotFoundError(HttpError):
    def __init__(self, message: str = "not found"):
        super().__init__(404, message)


class BadRequest(HttpError):
    def __init__(self, message: str = "bad request"):
        super().__init__(400, message)


class Request:
    def __init__(
        self,
        method: str,
        path: str,
        params: Dict[str, str],
        body: Any,
        headers: Dict[str, str],
    ):
        self.method = method
        self.path = path
        self.params = params
        self.body = body
        self.headers = headers
        # handlers may append (name, value) pairs to the response
        self.response_headers: List[Tuple[str, str]] = []


class Response:
    """Non-JSON response (plain text such as /metrics)."""

    def __init__(
        self,
        body,
        content_type: str = "text/plain; charset=utf-8",
        status: int = 200,
    ):
        self.body = body.encode() if isinstance(body, str) else bytes(body)
        self.content_type = content_type
        self.status = status


_STATUS_TEXT = {
    200: "200 OK",
    400: "400 Bad Request",
    404: "404 Not Found",
    405: "405 Method Not Allowed",
    429: "429 Too Many Requests",
    500: "500 Internal Server Error",
    503: "503 Service Unavailable",
}


class App:
    """Route table + WSGI callable."""

    def __init__(self, name: str):
        self.name = name
        # (method, pattern, handler)
        self._routes: List[Tuple[str, re.Pattern, Handler]] = []
        reg = default_registry()
        self._requests = reg.counter(
            "http_requests_total", "requests", ["app", "method", "status"]
        )
        self._latency = reg.histogram(
            "http_request_seconds", "request latency", ["app"]
        )

    def route(self, method: str, pattern: str):
        # <name> matches one path segment
        regex = re.compile(
            "^" + re.sub(r"<([a-zA-Z_]+)>", r"(?P<\1>[^/]+)", pattern) + "$"
        )

        def deco(fn: Handler):
            self._routes.append((method.upper(), regex, fn))
            return fn

        return deco

    def get(self, pattern: str):
        return self.route("GET", pattern)

    def post(self, pattern: str):
        return self.route("POST", pattern)

    def handle_full(
        self, method: str, path: str, body: Any = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, Any, List[Tuple[str, str]]]:
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        matched_path = False
        for m, regex, fn in self._routes:
            match = regex.match(path)
            if match is None:
                continue
            matched_path = True
            if m != method.upper():
                continue
            req = Request(method.upper(), path, match.groupdict(), body, headers)
            try:
                with self._latency.time(app=self.name):
                    result = fn(req)
                status = 200
                if isinstance(result, tuple):
                    result, status = result
                if isinstance(result, Response):
                    status = result.status
            except HttpError as e:
                result, status = {"success": False, "log": e.message}, e.status
            except Exception:
                log.error(
                    "%s %s %s failed:\n%s", self.name, method, path,
                    traceback.format_exc(),
                )
                result, status = {"success": False, "log": "internal error"}, 500
            self._requests.inc(
                app=self.name, method=method.upper(), status=str(status)
            )
            return status, result, req.response_headers
        if matched_path:
            return (
                405,
                {"success": False, "log": f"method {method} not allowed"},
                [],
            )
        return 404, {"success": False, "log": f"no route for {path}"}, []

    def __call__(self, environ, start_response):
        method = environ["REQUEST_METHOD"]
        path = environ.get("PATH_INFO", "/")
        headers = {
            k[5:].replace("_", "-").lower(): v
            for k, v in environ.items()
            if k.startswith("HTTP_")
        }
        body = None
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        if length:
            raw = environ["wsgi.input"].read(length)
            try:
                body = json.loads(raw)
            except json.JSONDecodeError:
                start_response(
                    _STATUS_TEXT[400], [("Content-Type", "application/json")]
                )
                return [
                    json.dumps({"success": False, "log": "invalid JSON"}).encode()
                ]
        status, result, extra_headers = self.handle_full(
            method, path, body, headers
        )
        if isinstance(result, Response):
            payload, content_type = result.body, result.content_type
        else:
            payload, content_type = json.dumps(result).encode(), "application/json"
        start_response(
            _STATUS_TEXT.get(status, f"{status} Unknown"),
            [
                ("Content-Type", content_type),
                ("Content-Length", str(len(payload))),
            ]
            + list(extra_headers),
        )
        return [payload]


class Server:
    """Threaded WSGI server on a background thread: concurrent clients
    are served concurrently (thread per request)."""

    def __init__(self, app: App, host: str = "127.0.0.1", port: int = 0):
        from socketserver import ThreadingMixIn
        from wsgiref.simple_server import (
            WSGIRequestHandler,
            WSGIServer,
            make_server,
        )

        class QuietHandler(WSGIRequestHandler):
            def log_message(self, *args):  # noqa: ARG002
                pass

        class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
            daemon_threads = True

        self._httpd = make_server(
            host, port, app,
            server_class=ThreadingWSGIServer,
            handler_class=QuietHandler,
        )
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2)
