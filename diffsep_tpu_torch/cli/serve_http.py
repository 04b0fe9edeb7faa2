"""HTTP front end of the separation service (standard library only).

Counterpart of ``diffsep_tpu/cli/serve_http.py``:
  * ``POST /v1/separate`` with a wav body answers one multi-channel wav
    (channel i = separated source i);
  * requests of concurrent connections share sampler runs: handler threads
    enqueue, one worker thread drains what is pending, groups it by length
    bucket and runs micro-batches of up to ``engine.batch``; the previous
    batch's device time is the batching window;
  * ``GET /healthz`` for liveness, ``GET /metrics`` for Prometheus counters
    (requests, latency, batch fill, queue depth);
  * a full queue answers 503, a request not done in ``timeout_s`` 504.
Only the worker thread touches torch tensors; handler threads decode and
encode wavs and wait.
"""
from __future__ import annotations

import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..data.audio_io import load_wav_bytes, wav_to_bytes

log = logging.getLogger(__name__)

__all__ = ["HTTPSeparationServer"]


class _Metrics:
    """Prometheus text-format counters (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_ok = 0
        self.requests_error = 0  # 4xx and 5xx, timeouts included
        self.latency_sum = 0.0  # seconds, answered requests only
        self.latency_count = 0
        self.batch_fill_sum = 0  # real rows per sampler run
        self.batch_runs = 0

    def observe_result(self, ok: bool, latency_s=None):
        with self._lock:
            if ok:
                self.requests_ok += 1
            else:
                self.requests_error += 1
            if latency_s is not None:
                self.latency_sum += latency_s
                self.latency_count += 1

    def observe_run(self, fill: int):
        with self._lock:
            self.batch_fill_sum += fill
            self.batch_runs += 1

    def render(self, queue_depth: int, inflight: int) -> str:
        with self._lock:
            lines = [
                "# TYPE diffsep_requests_total counter",
                f'diffsep_requests_total{{status="ok"}} {self.requests_ok}',
                f'diffsep_requests_total{{status="error"}} {self.requests_error}',
                "# TYPE diffsep_request_latency_seconds summary",
                f"diffsep_request_latency_seconds_sum {self.latency_sum:.6f}",
                f"diffsep_request_latency_seconds_count {self.latency_count}",
                "# TYPE diffsep_batch_fill summary",
                f"diffsep_batch_fill_sum {self.batch_fill_sum}",
                f"diffsep_batch_fill_count {self.batch_runs}",
                "# TYPE diffsep_queue_depth gauge",
                f"diffsep_queue_depth {queue_depth}",
                "# TYPE diffsep_inflight gauge",
                f"diffsep_inflight {inflight}",
            ]
        return "\n".join(lines) + "\n"


class _Pending:
    """One enqueued request: the validated signal in, the estimate or an
    error out, handed back to its handler thread through ``done``."""

    __slots__ = ("wav", "done", "est", "error", "t_enqueue")

    def __init__(self, wav: np.ndarray):
        self.wav = wav
        self.done = threading.Event()
        self.est = None  # (n_src, n) on success
        self.error = None
        self.t_enqueue = time.perf_counter()


class HTTPSeparationServer:
    """A serving engine (``cli.serve.SeparationEngine``) behind an HTTP
    server, with micro-batching across connections. Use as a context manager
    or call ``start()`` and ``shutdown()``; ``port=0`` binds a free port,
    read back from ``.port``."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000, max_queue: int = 64,
                 timeout_s: float = 600.0):
        self.engine = engine
        self.metrics = _Metrics()
        self.timeout_s = timeout_s
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._t_start = time.time()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._worker_loop, name="diffsep-batcher", daemon=True)

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            # the listen backlog: with http.server's default of 5, a burst of
            # more simultaneous connects loses handshakes and the clients'
            # first writes are reset. Whatever the queue will hold, the
            # listener must accept.
            request_queue_size = max(128, max_queue)

        self._httpd = _Server((host, port), _make_handler(self))
        self._serve_thread = None
        self._listening = False  # shutdown() waits forever unless serve_forever() runs

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "HTTPSeparationServer":
        """Start the worker and the listener in background threads."""
        self._worker.start()
        self._listening = True
        self._serve_thread = threading.Thread(target=self._httpd.serve_forever, name="diffsep-http",
                                              daemon=True)
        self._serve_thread.start()
        log.info("http: serving on %s:%d", *self._httpd.server_address[:2])
        return self

    def serve_forever(self) -> None:
        """Start the worker and serve in this thread until interrupted."""
        self._worker.start()
        self._listening = True
        log.info("http: serving on %s:%d", *self._httpd.server_address[:2])
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self._listening = False
            self.shutdown()

    def shutdown(self) -> None:
        self._stop.set()
        if self._listening:
            self._listening = False
            self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    def submit(self, wav: np.ndarray) -> _Pending:
        """Enqueue a validated (1, n) signal; raises queue.Full when the
        server is saturated."""
        pending = _Pending(wav)
        self._queue.put_nowait(pending)
        return pending

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            # what arrived while the previous batch ran, up to a few runs'
            # worth, so that latency stays bounded
            while len(batch) < 4 * self.engine.batch:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            with self._inflight_lock:
                self._inflight += len(batch)
            try:
                self._run_batch(batch)
            finally:
                with self._inflight_lock:
                    self._inflight -= len(batch)

    def _run_batch(self, batch) -> None:
        for chunk, ests, err, *_ in self.engine.pipeline(batch, lambda p: p.wav):
            if err is not None:
                log.error("http: micro-batch failed", exc_info=err)
                for p in chunk:
                    p.error = f"{type(err).__name__}: {err}"
            else:
                for p, est in zip(chunk, ests):
                    p.est = est
            self.metrics.observe_run(len(chunk))
            for p in chunk:
                p.done.set()


def _make_handler(server: HTTPSeparationServer):
    engine = server.engine

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):
            if self.path in ("/healthz", "/health"):
                self._send_json(200, {
                    "status": "ok", "fs": engine.fs, "batch": engine.batch, "bucket_samples": engine.bucket,
                    "engine": type(engine).__name__, "uptime_s": round(time.time() - server._t_start, 3),
                })
            elif self.path == "/metrics":
                body = server.metrics.render(server._queue.qsize(), server._inflight).encode()
                self._send_bytes(200, body, "text/plain; version=0.0.4")
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path not in ("/v1/separate", "/separate"):
                # the body is not read: under keep-alive its bytes would be
                # parsed as the next request, so the connection closes
                self.close_connection = True
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                length = 0
            if length <= 0:
                self.close_connection = True
                self._send_json(400, {"error": "empty body; POST wav bytes"})
                return
            body = self.rfile.read(length)
            try:
                wav, sr = load_wav_bytes(body)
            except Exception as e:
                self._send_json(400, {"error": f"wav decode failed: {e}"})
                return
            err = engine.validate(wav, sr)
            if err is not None:
                self._send_json(400, {"error": err})
                return
            try:
                pending = server.submit(wav)
            except queue.Full:
                self._send_json(503, {"error": "server saturated; retry later"})
                return
            if not pending.done.wait(server.timeout_s):
                # the worker may still finish it; the slot is abandoned
                self._send_json(504, {"error": f"timed out after {server.timeout_s:.0f}s"})
                return
            if pending.error is not None:
                self._send_json(500, {"error": pending.error})
                return
            latency = time.perf_counter() - pending.t_enqueue
            self._send_bytes(200, wav_to_bytes(pending.est, engine.fs), "audio/wav", extra={
                "X-Diffsep-Sources": str(pending.est.shape[0]),
                "X-Diffsep-Latency-Ms": f"{latency * 1e3:.1f}",
            }, ok_latency=latency)

        def _send_bytes(self, code, body, ctype, extra=None, ok_latency=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                self.send_header("Connection", "close")
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
            if ok_latency is not None:
                server.metrics.observe_result(True, ok_latency)

        def _send_json(self, code, obj):
            self._send_bytes(code, (json.dumps(obj) + "\n").encode(), "application/json")
            if code >= 400:
                server.metrics.observe_result(False)

        def log_message(self, fmt, *args):
            log.debug("http: %s", fmt % args)

    return Handler
