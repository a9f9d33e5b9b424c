"""The HTTP front door: the serving plane's network-facing edge.

Three routes, one behavior, two server stacks:

  * ``POST /submit``  — body ``{"img": <trace image id>}``; answers the
    request's :class:`FederationResult` as JSON
    (:func:`repro_torch.serving.client.result_to_dict` schema).  The handler
    thread parks on the service future while the micro-batcher
    coalesces it into a flush — an open-loop client gets true
    concurrent batching over HTTP.
  * ``POST /invalidate`` — body ``{"imgs": [...]}``; drops the images'
    cached artifacts everywhere (answers ``{"dropped": n}``).
  * ``GET /healthz``  — liveness + the transport's condemn state:
    ``{"status": "ok"|"degraded", "transport", "shards", "condemned"}``
    (degraded = serving, but at least one shard host is condemned).
  * ``GET /metrics``  — the service's merged metrics snapshot (parent
    registry + every shard/host registry) in Prometheus text exposition
    (``repro_torch.obs.prom``), scrapeable by a stock Prometheus and parseable
    by ``obs_report --prom``.
  * ``GET /stats``    — the flush-counter dict (JSON), test/debug sugar.

:func:`create_app` builds a FastAPI app (asyncio lifespan owns the
client's shutdown; ``/submit`` awaits the service future on a worker
thread so the event loop never blocks on a flush) when FastAPI is
installed — it is an OPTIONAL dependency, imported
lazily so the serving stack works without it.  :class:`HttpFrontDoor`
serves the identical routes on the stdlib ``ThreadingHTTPServer`` — no
dependencies, one thread per in-flight request — and is what tests and
``chip_smoke.py`` run; both stacks dispatch through the
same :func:`route_request`, so they cannot drift.

:class:`HttpServingClient` is the matching client: the
``FederationClient`` five-call surface over ``urllib`` (futures run on
a small thread pool), so in-process and over-HTTP callers are
interchangeable in tests and benches.
"""
from __future__ import annotations

import json
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence, Tuple
from urllib import request as _urlreq

from repro_torch.serving.client import (FederationClient,
                                        result_from_dict, result_to_dict)


def route_request(client: FederationClient, method: str, path: str,
                  body: Optional[bytes]) -> Tuple[int, str, bytes]:
    """The one shared dispatch: ``(status, content_type, payload)`` for
    an HTTP request against the serving surface.  Both server stacks
    (FastAPI and the stdlib fallback) adapt their I/O to this function;
    route semantics live here only."""
    try:
        if method == "GET" and path == "/healthz":
            condemned = client.condemned()
            svc = client.service
            doc = {"status": "degraded" if condemned else "ok",
                   "transport": getattr(svc, "shard_backend", "inline"),
                   "shards": getattr(svc, "workers", 1),
                   "condemned": condemned}
            return 200, "application/json", json.dumps(doc).encode()
        if method == "GET" and path == "/metrics":
            from repro_torch.obs.prom import render_prometheus
            text = render_prometheus(client.metrics_snapshot())
            return (200, "text/plain; version=0.0.4; charset=utf-8",
                    text.encode())
        if method == "GET" and path == "/stats":
            return (200, "application/json",
                    json.dumps(client.stats).encode())
        if method == "POST" and path == "/submit":
            try:
                doc = json.loads(body or b"")
                img = int(doc["img"])
            except (ValueError, KeyError, TypeError):
                return (400, "application/json", json.dumps(
                    {"error": "body must be {\"img\": <int>}"}).encode())
            res = client.handle(img)
            return (200, "application/json",
                    json.dumps(result_to_dict(res)).encode())
        if method == "POST" and path == "/invalidate":
            try:
                doc = json.loads(body or b"")
                imgs = [int(i) for i in doc["imgs"]]
            except (ValueError, KeyError, TypeError):
                return (400, "application/json", json.dumps(
                    {"error": "body must be {\"imgs\": [<int>...]}"}
                ).encode())
            return (200, "application/json", json.dumps(
                {"dropped": client.invalidate_images(imgs)}).encode())
        return (404, "application/json",
                json.dumps({"error": f"no route {method} {path}"}
                           ).encode())
    except Exception as e:      # a failed flush is the request's 500,
        return (500, "application/json",          # not the server's end
                json.dumps({"error": f"{type(e).__name__}: {e}"}
                           ).encode())


def create_app(client: FederationClient):
    """FastAPI application over the facade (requires the optional
    ``fastapi`` dependency; raise with guidance when absent).  The
    asyncio lifespan closes the client on shutdown; ``/submit`` resolves
    the service future via ``run_in_executor`` so a parked flush never
    blocks the event loop."""
    try:
        from contextlib import asynccontextmanager

        from fastapi import FastAPI, Request, Response
    except ImportError as e:
        raise ImportError(
            "the FastAPI front door needs the optional 'fastapi' "
            "dependency (pip install fastapi uvicorn); the stdlib "
            "HttpFrontDoor serves the same routes without it") from e

    @asynccontextmanager
    async def _lifespan(app):
        yield
        client.close()

    app = FastAPI(lifespan=_lifespan)

    async def _route(req: Request) -> Response:
        import asyncio
        body = await req.body()
        loop = asyncio.get_running_loop()
        status, ctype, payload = await loop.run_in_executor(
            None, route_request, client, req.method, req.url.path, body)
        return Response(content=payload, status_code=status,
                        media_type=ctype)

    for method, path in (("GET", "/healthz"), ("GET", "/metrics"),
                         ("GET", "/stats"), ("POST", "/submit"),
                         ("POST", "/invalidate")):
        app.add_api_route(path, _route, methods=[method])
    return app


class HttpFrontDoor:
    """The same routes on ``http.server.ThreadingHTTPServer`` — the
    dependency-free stack the tests and ``chip_smoke.py`` drive.  One
    daemon thread accepts; each request gets its own handler thread,
    which parks on the service future (that is the batching model: N in-flight HTTP
    requests = N queued submits = flush-sized batches).

    ``own_service=True`` ties the underlying service's shutdown to
    :meth:`close` (the CLI path); default leaves lifecycle with the
    caller (tests share one service across doors).
    """

    def __init__(self, service_or_client, host: str = "127.0.0.1",
                 port: int = 0, *, own_service: bool = False):
        if isinstance(service_or_client, FederationClient):
            self.client = service_or_client
        else:
            self.client = FederationClient(service_or_client,
                                           own_service=own_service)
        front = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _serve(self, method: str) -> None:
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                status, ctype, payload = route_request(
                    front.client, method, self.path, body)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):           # noqa: N802 (stdlib contract)
                self._serve("GET")

            def do_POST(self):          # noqa: N802
                self._serve("POST")

            def log_message(self, *a):  # keep test output quiet
                pass

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            # the stdlib default backlog of 5 RSTs connect bursts from
            # open-loop load generators; size it to a flush-heavy pool
            request_queue_size = 128

        self._server = _Server((host, port), _Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="fed-http-front",
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
        self.client.close()

    def __enter__(self) -> "HttpFrontDoor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class HttpServingClient:
    """``FederationClient``'s five-call surface over HTTP (urllib; no
    dependencies).  ``submit`` returns a real future backed by a small
    thread pool — open-loop load generators submit without blocking and
    the door's handler threads do the parking."""

    def __init__(self, base_url: str, *, timeout_s: float = 60.0,
                 pool_size: int = 32):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self._pool = ThreadPoolExecutor(max_workers=pool_size,
                                        thread_name_prefix="fed-http-cli")

    def _call(self, method: str, path: str, doc=None) -> dict:
        body = None if doc is None else json.dumps(doc).encode()
        req = _urlreq.Request(self.base_url + path, data=body,
                              method=method,
                              headers={"Content-Type":
                                       "application/json"})
        with _urlreq.urlopen(req, timeout=self.timeout_s) as resp:
            payload = resp.read()
        return json.loads(payload)

    def _get_text(self, path: str) -> str:
        req = _urlreq.Request(self.base_url + path, method="GET")
        with _urlreq.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read().decode()

    def submit(self, img_idx: int) -> Future:
        return self._pool.submit(self.handle, img_idx)

    def handle(self, img_idx: int):
        doc = self._call("POST", "/submit", {"img": int(img_idx)})
        return result_from_dict(doc)

    def handle_many(self, img_indices: Sequence[int]) -> List:
        futs = [self.submit(i) for i in img_indices]
        return [f.result() for f in futs]

    def invalidate_images(self, img_indices: Sequence[int]) -> int:
        return int(self._call("POST", "/invalidate",
                              {"imgs": [int(i) for i in img_indices]}
                              )["dropped"])

    @property
    def stats(self) -> dict:
        return self._call("GET", "/stats")

    def healthz(self) -> dict:
        return self._call("GET", "/healthz")

    def metrics_text(self) -> str:
        return self._get_text("/metrics")

    def close(self) -> None:
        self._pool.shutdown(wait=False)
