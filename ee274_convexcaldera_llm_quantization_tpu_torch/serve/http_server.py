"""HTTP serving front end (stdlib only, no web framework).

Counterpart of ``ee274_convexcaldera_llm_quantization_tpu.serve.
http_server``: a background scheduler thread drives any of the port's
serving engines (slotted, fast or paged) while a ``ThreadingHTTPServer``
accepts JSON requests.

Endpoints:

- ``GET  /health``          -> ``{"status": "ok"}``
- ``GET  /v1/stats``        -> engine counters (tokens, steps, queue depth,
                               active slots)
- ``POST /v1/completions``  -> ``{"prompt": [token ids], "max_tokens": n,
                               "temperature": t, "top_k": k, "top_p": p,
                               "eos_token": e, "stream": bool}``.
  Non-streaming: blocks until done, returns the full completion.
  ``"stream": true``: server-sent events, one ``data: {"tokens": [...]}``
  chunk per newly committed token batch; the final chunk carries
  ``finished_reason``.

Prompts are token ids; pass a ``tokenizer`` callable (text -> ids) to
:class:`ServingHTTPServer` to also accept ``{"prompt": "text"}``.

Threads: every engine call happens on the runner thread (one device stream);
HTTP handler threads only enqueue work and wait on per-request events, and
streaming handlers read snapshot copies of the growing token list. If an
engine step raises, the runner records the error, wakes every waiting
request (answered with status 500) and re-raises on its own thread.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

import numpy as np

from ee274_convexcaldera_llm_quantization_tpu_torch.serve.engine import (
    Completion, Request)


class AsyncEngineRunner:
    """Drives a serving engine on a dedicated thread; thread-safe submit.

    The engine's scheduler loop (admit + decode tick) runs whenever work is
    pending; otherwise the thread idles on the inbox. Completions are
    published to per-uid events so any number of HTTP handler threads can
    block on their own request.
    """

    def __init__(self, engine, idle_sleep_s: float = 0.002):
        self.engine = engine
        self._inbox: "queue.Queue[Request]" = queue.Queue()
        self._events: Dict[int, threading.Event] = {}
        self._results: Dict[int, Completion] = {}
        self._partials: Dict[int, List[int]] = {}
        self._uid = 0
        self._uid_lock = threading.Lock()
        self._idle_sleep_s = idle_sleep_s
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ccq-engine")

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "AsyncEngineRunner":
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)

    # -- client API (any thread) ---------------------------------------------

    def submit(self, prompt, max_tokens: int = 64, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               eos_token: Optional[int] = None, priority: int = 0,
               tenant: int = 0) -> int:
        with self._uid_lock:
            self._uid += 1
            uid = self._uid
        req = Request(
            uid=uid, prompt=np.asarray(prompt, np.int32),
            max_new_tokens=int(max_tokens), temperature=float(temperature),
            top_k=int(top_k), top_p=float(top_p), eos_token=eos_token,
            priority=int(priority), tenant=int(tenant))
        # synchronous validation (a pure read), so the caller gets the error
        # at once instead of a dead request on the engine thread
        self.engine.validate(req)
        self._events[uid] = threading.Event()
        self._partials[uid] = []
        self._inbox.put(req)
        return uid

    def result(self, uid: int, timeout: Optional[float] = None
               ) -> Optional[Completion]:
        """The completion, or None on timeout; raises RuntimeError if the
        engine thread failed before finishing the request."""
        ev = self._events.get(uid)
        if ev is None or not ev.wait(timeout):
            return None
        self._events.pop(uid, None)
        self._partials.pop(uid, None)
        if uid not in self._results:
            raise RuntimeError(f"engine thread failed: {self.error!r}")
        return self._results.pop(uid)

    def partial(self, uid: int) -> Optional[List[int]]:
        """Snapshot of tokens committed so far (None once retired)."""
        toks = self._partials.get(uid)
        return list(toks) if toks is not None else None

    def done(self, uid: int) -> bool:
        ev = self._events.get(uid)
        return ev.is_set() if ev is not None else True

    def stats(self) -> Dict[str, object]:
        eng = self.engine
        if hasattr(eng, "queue"):        # slot engines
            depth, active = len(eng.queue), len(eng.slots)
        else:                            # paged engine: C++ scheduler counts
            depth, active = eng.sched.queue_len, eng.sched.active_count
        return {
            "tokens_generated": getattr(eng, "tokens_generated", 0),
            "steps": getattr(eng, "steps", 0),
            "queue_depth": depth + self._inbox.qsize(),
            "active_slots": active,
            "max_slots": eng.max_slots,
        }

    # -- engine thread -------------------------------------------------------

    def _loop(self) -> None:
        try:
            self._serve()
        except BaseException as e:
            self.error = e
            for ev in list(self._events.values()):
                ev.set()
            raise

    def _serve(self) -> None:
        eng = self.engine
        while not self._stop.is_set():
            moved = False
            while True:
                try:
                    eng.submit(self._inbox.get_nowait())
                    moved = True
                except queue.Empty:
                    break
            if eng.busy():
                eng.step()
                # publish streaming snapshots for live requests
                for uid, toks in eng.live_generated().items():
                    if uid in self._partials:
                        self._partials[uid] = list(toks)
                moved = True
            for comp in eng.completions:
                self._partials[comp.uid] = list(comp.tokens)
                self._results[comp.uid] = comp
                ev = self._events.get(comp.uid)
                if ev is not None:
                    ev.set()
            eng.completions.clear()
            if not moved:
                time.sleep(self._idle_sleep_s)


def _completion_json(comp: Completion) -> Dict[str, object]:
    return {
        "uid": comp.uid,
        "tokens": list(map(int, comp.tokens)),
        "prompt_len": comp.prompt_len,
        "finished_reason": comp.finished_reason,
        "latency_s": round(comp.latency_s, 4),
    }


class ServingHTTPServer:
    """HTTP front end over an :class:`AsyncEngineRunner`.

    ``tokenizer``: optional callable text -> list[int] enabling string
    prompts. ``port=0`` binds an ephemeral port (``.port`` holds the real
    one).
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000,
                 tokenizer: Optional[Callable[[str], List[int]]] = None,
                 request_timeout_s: float = 600.0):
        self.runner = AsyncEngineRunner(engine)
        self.tokenizer = tokenizer
        self.request_timeout_s = request_timeout_s
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # quiet: access logging belongs to the deployment
            def log_message(self, fmt, *args):
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._json(200, {"status": "ok"})
                elif self.path == "/v1/stats":
                    self._json(200, outer.runner.stats())
                else:
                    self._json(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if self.path != "/v1/completions":
                    self._json(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    prompt = req["prompt"]
                    if isinstance(prompt, str):
                        if outer.tokenizer is None:
                            raise ValueError(
                                "string prompts need a tokenizer; send "
                                "token ids")
                        prompt = outer.tokenizer(prompt)
                    if (not isinstance(prompt, list) or not prompt
                            or not all(isinstance(t, int) for t in prompt)):
                        raise ValueError(
                            "prompt must be a non-empty list of token ids")
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                try:
                    uid = outer.runner.submit(
                        prompt,
                        max_tokens=req.get("max_tokens", 64),
                        temperature=req.get("temperature", 0.0),
                        top_k=req.get("top_k", 0),
                        top_p=req.get("top_p", 1.0),
                        eos_token=req.get("eos_token"))
                except (ValueError, TypeError) as e:   # e.g. over capacity
                    self._json(400, {"error": str(e)})
                    return
                if req.get("stream"):
                    self._stream(uid)
                    return
                try:
                    comp = outer.runner.result(uid, outer.request_timeout_s)
                except RuntimeError as e:
                    self._json(500, {"error": str(e)})
                    return
                if comp is None:
                    self._json(504, {"error": "generation timed out"})
                    return
                self._json(200, _completion_json(comp))

            def _stream(self, uid: int) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                sent = 0
                deadline = time.time() + outer.request_timeout_s
                while time.time() < deadline:
                    toks = outer.runner.partial(uid)
                    done = outer.runner.done(uid)
                    if toks is not None and len(toks) > sent:
                        chunk = {"tokens": toks[sent:]}
                        self.wfile.write(
                            f"data: {json.dumps(chunk)}\n\n".encode())
                        self.wfile.flush()
                        sent = len(toks)
                    if done:
                        break
                    time.sleep(0.005)
                try:
                    comp = outer.runner.result(uid, 0.5)
                    fin = ({"finished_reason": comp.finished_reason,
                            "latency_s": round(comp.latency_s, 4)}
                           if comp is not None else
                           {"finished_reason": "timeout"})
                except RuntimeError as e:
                    fin = {"finished_reason": "error", "error": str(e)}
                self.wfile.write(f"data: {json.dumps(fin)}\n\n".encode())
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="ccq-http")

    def start(self) -> "ServingHTTPServer":
        self.runner.start()
        self._serve_thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self.runner.stop()

    def serve_forever(self) -> None:
        """Blocking convenience for a command-line server."""
        self.runner.start()
        try:
            self._server.serve_forever()
        finally:
            self.stop()
