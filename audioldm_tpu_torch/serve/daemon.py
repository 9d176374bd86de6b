"""Online serving: deadline-based microbatching and an HTTP front end (port
of audioldm_tpu/serve/daemon.py).

``ServeEngine`` covers the offline path (``submit``/``flush`` over a
requests file); this module adds the online one: concurrent callers submit
single requests, a scheduler thread forms batches (a batch closes when it
reaches ``max_batch`` or when its oldest request has waited
``max_delay_ms``), and each batch rides the engine's bucketed, CFG-folded,
merged-cache dispatch.

Batching semantics:
- Requests are grouped by their generation parameters (``GenParams``):
  requests in a batch run one sampler loop.
- Unseeded requests share batches; the batch key is ``(base_seed,
  ordinal)``, a monotone scheduler counter folded in, so no two batches
  share latents and no unseeded row draws a seeded request's latents
  (``pipeline.generate.key_generator``).
- A request with a ``seed`` shares batches too: the engine draws each
  seeded row's init latents from its own generator, so "same seed, same
  clip" holds whatever else is in flight. A seeded ``lcm`` request is
  served alone: lcm's in-loop noise comes from the batch key.

The HTTP layer is the standard library's ``http.server``: POST
/v1/generate returns a base64 wav, POST /v1/adapters hot-loads a PEFT LoRA
into the running bank (an in-place slot write, ``engine.AdapterBank``) or
registers a composition, DELETE /v1/adapters/<name> unloads one, GET
/healthz, /v1/stats and /v1/adapters. ``max_adapters`` bounds the bank;
past it, a load evicts the least recently served adapter that nothing pins.

Under data parallelism (an engine with a ``dp`` mesh of more than one rank,
``cli serve --dp N`` under torchrun) rank 0 runs the HTTP server and the
``Microbatcher``; every other rank runs ``follow``. Each engine call the
batcher makes (a batch, a hot-load, an unload, an eviction, a composition)
goes to the followers with ``broadcast_object_list`` before rank 0 makes
it, so that every rank calls the SPMD engine with the same arguments in
the same order; ``close`` sends the message that ends the followers. A
request that would raise (an unknown adapter, a composed adapter on the
rank-r route, a rank or name conflict) raises on rank 0 before anything is
sent, so no follower waits in a collective for it.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import threading
import time
import urllib.parse
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import dataclass
from typing import Optional

import numpy as np

from audioldm_tpu_torch.pipeline.generate import latent_shape, window_params
from audioldm_tpu_torch.serve.engine import ServeEngine, _as_dict
from audioldm_tpu_torch.utils import profiling


@dataclass(frozen=True)
class GenParams:
    """A request's generation settings: everything that must agree within
    a batch."""

    num_inference_steps: int = 50
    audio_length_in_s: float = 10.0
    guidance_scale: float = 2.5
    scheduler: str = "ddim"
    # None -> the engine's. A grouping field, not part of the geometry: the
    # CFG uncond embedding is one row a batch
    negative_prompt: Optional[str] = None
    # MultiDiffusion windows for long clips (pipeline/generate.py denoise)
    window_seconds: Optional[float] = None
    window_overlap: float = 0.5
    # limited-interval guidance: (lo, hi) fractions of the train timesteps
    guidance_interval: Optional[tuple] = None

    def geometry(self) -> tuple:
        """The fields that set the shape of the work (the allowlist's key):
        all but ``negative_prompt``, with ``window_overlap`` normalised to
        None when windowing is off (the engine ignores it then)."""
        return (
            self.num_inference_steps, self.audio_length_in_s, self.guidance_scale, self.scheduler,
            self.window_seconds, self.window_overlap if self.window_seconds is not None else None,
            self.guidance_interval,
        )

    def validate(self, modules) -> "GenParams":
        """Raise ``ValueError`` for settings the pipeline rejects, so that a
        bad request is a 400 at parse time, never an exception in the batch
        thread (which the handler must treat as a 500). The window checks
        are the pipeline's own, on ``modules``' geometry: ``window_params``
        bounds the overlap to [0, 0.9], and ``denoise`` windows when the
        window is shorter than the clip in latent frames. The JAX package's
        validate departs from both (audioldm_tpu/serve/daemon.py:113 accepts
        an overlap up to 1.0, and :119 compares seconds)."""
        if self.num_inference_steps < 1:
            raise ValueError(f"steps must be >= 1, got {self.num_inference_steps}")
        if not self.audio_length_in_s > 0:
            raise ValueError(f"seconds must be > 0, got {self.audio_length_in_s}")
        if self.scheduler not in ("ddim", "dpm++", "lcm"):
            raise ValueError(f"unknown scheduler {self.scheduler!r}; one of: ddim, dpm++, lcm")
        frames, _ = window_params(modules, self.window_seconds, self.window_overlap)
        if self.guidance_interval is not None:
            if self.scheduler == "lcm":
                raise ValueError("guidance_interval is incompatible with scheduler='lcm' (LCM samples without CFG)")
            if frames is not None and frames < latent_shape(modules, 1, self.audio_length_in_s)[2]:
                raise ValueError("guidance_interval is incompatible with windowed long-form generation")
        return self

    @classmethod
    def from_fields(cls, d: dict, defaults: "GenParams", modules) -> "GenParams":
        """``defaults`` with the request fields present in ``d`` (JSON null
        counts as absent; other keys are ignored), validated on ``modules``.
        Raises ``ValueError`` or ``TypeError`` for a malformed value: the
        HTTP handler answers it with a 400, ``cli serve --geometry`` exits."""
        kw = {name: conv(d[k]) for k, (name, conv) in REQUEST_FIELDS.items() if d.get(k) is not None}
        gi = d.get("guidance_interval")
        if gi is not None:
            # a str is iterable: "01" must not pass as (0.0, 1.0)
            if not isinstance(gi, (list, tuple)) or len(gi) != 2:
                raise ValueError("guidance_interval expects [lo, hi] fractions")
            lo, hi = (float(x) for x in gi)
            if not 0.0 <= lo <= hi <= 1.0:
                raise ValueError("guidance_interval needs 0 <= lo <= hi <= 1")
            kw["guidance_interval"] = (lo, hi)
        return dataclasses.replace(defaults, **kw).validate(modules)


# request field -> (GenParams field, conversion); guidance_interval, a pair,
# is read by GenParams.from_fields on its own
REQUEST_FIELDS = {
    "steps": ("num_inference_steps", int), "seconds": ("audio_length_in_s", float),
    "guidance": ("guidance_scale", float), "scheduler": ("scheduler", str),
    "window_seconds": ("window_seconds", float), "window_overlap": ("window_overlap", float),
    "negative_prompt": ("negative_prompt", str),
}


@dataclass
class _Pending:
    prompt: str
    adapter: Optional[str]
    params: GenParams
    seed: Optional[int]
    future: Future
    t_submit: float
    rid: int = 0  # the batcher's request ordinal: the key of its serve.queue span


def _spread(engine: ServeEngine) -> bool:
    """Whether the engine's calls must reach follower ranks."""
    mesh = getattr(engine, "mesh", None)  # stand-in engines of the tests carry none
    return mesh is not None and mesh.axis_size("dp") > 1


def _exchange(engine: ServeEngine, message=None):
    """Rank 0's ``message`` to every rank of the engine's dp group (the
    message itself on rank 0)."""
    import torch.distributed as dist

    mesh = engine.mesh
    box = [message]
    dist.broadcast_object_list(box, src=0, group=mesh.groups["dp"],
                               device=mesh.device if mesh.device.type == "cuda" else None)
    return box[0]


def follow(engine: ServeEngine) -> int:
    """The loop of a rank other than 0 under data parallelism: make every
    engine call rank 0's ``Microbatcher`` sends, in order, until it sends
    the stop message. Returns the number of calls made. A call that raises
    here raised on rank 0 too (every rank holds the same state); it is
    reported and the loop goes on."""
    import sys

    calls = 0
    while True:
        message = _exchange(engine)
        if message is None:
            return calls
        op, args, kwargs = message
        calls += 1
        try:
            getattr(engine, op)(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - rank 0 reports it to the client
            print(f"follower rank {engine.mesh.rank}: {op} raised {type(e).__name__}: {e}", file=sys.stderr)


class Microbatcher:
    """One scheduler thread turning concurrent ``submit`` calls into engine
    batches. Every engine call (dispatch and adapter hot-load alike) holds
    ``_engine_lock``: the engine's merged cache and bank are plain Python
    state.

    Each request's queue wait, from ``submit`` until the scheduler takes its
    batch, is kept for ``stats`` and, while spans are on
    (``utils/profiling.py``), recorded as a ``serve.queue`` span keyed by the
    request's ordinal; each batch served is a ``serve.batch`` span listing
    its requests' ordinals."""

    def __init__(
        self,
        engine: ServeEngine,
        max_batch: int = 8,
        max_delay_ms: float = 50.0,
        base_seed: int = 0,
        max_adapters: Optional[int] = None,
        geometries: Optional[list] = None,
        defaults: Optional[GenParams] = None,
    ):
        self.engine = engine
        self.max_batch = max_batch
        self.max_delay_ms = max_delay_ms
        self.base_seed = base_seed
        # the server's generation defaults: the HTTP handler fills fields
        # absent from a request from here, not from the dataclass defaults
        self.defaults = defaults if defaults is not None else GenParams()
        # geometry allowlist: with one, submit rejects a request whose
        # GenParams.geometry() is not listed, so arbitrary HTTP traffic
        # cannot ask for a clip length or batch geometry that runs the card
        # out of memory. None = any geometry (offline or trusted callers)
        self.geometries: Optional[frozenset] = (
            None if geometries is None else frozenset(self._norm_geometry(g) for g in geometries)
        )
        # hot-load capacity policy: loading a new adapter past this count (or
        # past the bank's max_capacity) evicts the least recently served one
        # that no composition or in-flight request pins (load_adapter)
        self.max_adapters = max_adapters
        self._adapter_last_used: dict[str, float] = {}
        # adapters of accepted, unfinished requests: submit increments,
        # resolution decrements; eviction and DELETE must not remove them
        self._adapter_inflight: dict[str, int] = {}
        self.batch_sizes: list[int] = []
        self.latencies_ms: deque[float] = deque(maxlen=1024)  # submit -> result wall time
        self.queue_waits_ms: deque[float] = deque(maxlen=1024)  # submit -> its batch taken
        self._requests = 0
        self.served = 0
        self._pending: deque[_Pending] = deque()
        self._cv = threading.Condition()
        self._engine_lock = threading.Lock()
        self._batch_ordinal = 0
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @staticmethod
    def _norm_geometry(g) -> tuple:
        """Allowlist entry -> geometry tuple: ``GenParams`` through
        ``geometry()``, raw tuples coerced to its types and normalised the
        same way (a dangling ``window_overlap`` -> None), after an arity
        check, so that no entry is dead config no request can match."""
        if isinstance(g, GenParams):
            return g.geometry()
        t = tuple(g)
        want = len(GenParams().geometry())
        if len(t) != want:
            raise ValueError(f"geometry entry needs {want} fields (steps, seconds, guidance, scheduler, "
                             f"window_seconds, window_overlap, guidance_interval), got {t!r}")
        try:
            gi = None if t[6] is None else tuple(float(x) for x in t[6])
            if gi is not None and len(gi) != 2:
                raise ValueError("guidance_interval expects (lo, hi)")
            t = (int(t[0]), float(t[1]), float(t[2]), str(t[3]), None if t[4] is None else float(t[4]),
                 None if t[5] is None else float(t[5]), gi)
        except (TypeError, ValueError) as e:
            raise ValueError(f"bad geometry entry {t!r}: {e}") from e
        if t[4] is None and t[5] is not None:
            t = t[:5] + (None,) + t[6:]
        return t

    # -- public API ---------------------------------------------------------
    def submit(self, prompt: str, adapter: Optional[str] = None, params: GenParams = GenParams(),
               seed: Optional[int] = None) -> Future:
        """Enqueue one request; the Future resolves to a float32 waveform
        ``[samples]``. Unknown adapters and disallowed geometries fail here,
        not in the batch."""
        if self.geometries is not None and params.geometry() not in self.geometries:
            # key=repr: the tuples mix None with numbers in one position
            raise ValueError(
                f"request geometry {params.geometry()} is not in the served allowlist (steps, seconds, "
                f"guidance, scheduler, window_seconds, window_overlap, guidance_interval); allowed: "
                f"{sorted(self.geometries, key=repr)}"
            )
        fut: Future = Future()
        req = _Pending(prompt, adapter, params, seed, fut, time.monotonic())
        with self._cv:
            self._requests += 1
            req.rid = self._requests
            # the adapter check and the in-flight pin under _cv, which
            # remove_adapter and _evict_for hold across their pin check and
            # the removal: no submit pins an adapter being removed
            if not self.engine.has_adapter(adapter):
                bank = self.engine.bank
                raise KeyError(f"unknown adapter {adapter!r}; loaded: {sorted(bank.names) if bank else []} "
                               f"composed: {sorted(self.engine.composed)}")
            if not self._running:
                raise RuntimeError("Microbatcher is closed")
            if adapter and adapter != "base":
                self._adapter_inflight[adapter] = self._adapter_inflight.get(adapter, 0) + 1
            self._pending.append(req)
            self._cv.notify()
        return fut

    def _release_inflight(self, r: _Pending) -> None:
        """Drop the in-flight pin once ``r``'s future is resolved."""
        if not r.adapter or r.adapter == "base":
            return
        with self._cv:
            n = self._adapter_inflight.get(r.adapter, 0) - 1
            if n > 0:
                self._adapter_inflight[r.adapter] = n
            else:
                self._adapter_inflight.pop(r.adapter, None)

    def _call(self, op: str, *args, **kwargs):
        """Under ``_engine_lock``: the engine's method ``op``, sent to the
        follower ranks first under data parallelism (``follow``)."""
        if _spread(self.engine):
            _exchange(self.engine, (op, args, kwargs))
        return getattr(self.engine, op)(*args, **kwargs)

    def load_adapter(self, name: str, adapter, rank: int, alpha: Optional[float] = None) -> None:
        """Hot-load (or replace) a LoRA adapter (``LoRAAdapters`` or ``{path:
        (a, b)}``) in the running engine: the bank writes one slot in place;
        the merged copy of a replaced name and every composition that uses
        it are dropped and rebuilt. Loading a new name past ``max_adapters``
        (or the bank's ``max_capacity``) first evicts the least recently
        served adapter that nothing pins; if none can go, the load is
        refused."""
        with self._engine_lock:
            eng = self.engine
            if name in eng.composed:
                raise ValueError(f"adapter name {name!r} is taken by a composed adapter; pick another name "
                                 "(compositions are recomputed, not replaced, by component loads)")
            if eng.bank is not None:
                if rank != eng.bank.rank:
                    raise ValueError(f"adapter rank {rank} != bank rank {eng.bank.rank}; a bank stacks same-rank "
                                     "adapters (engine.py AdapterBank)")
                eng.bank._conform(adapter)  # a mismatched adapter raises here, before any rank changes
                if name not in eng.bank.names:
                    self._evict_for(name)
            if _spread(eng):  # tensors travel pickled: on the host
                adapter = {p: tuple(x.detach().cpu() for x in e) for p, e in _as_dict(adapter).items()}
            self._call("load_adapter", name, adapter, rank, alpha)
            self._adapter_last_used[name] = time.monotonic()

    def _evict_for(self, incoming: str) -> None:
        """Under ``_engine_lock``: free a slot for ``incoming`` if the bank
        is at its capacity policy, evicting the least recently served
        adapter that no composition or in-flight request uses."""
        eng = self.engine
        loaded = len(eng.bank.names) - 1  # minus the reserved base slot
        over_policy = self.max_adapters is not None and loaded >= self.max_adapters
        if not (over_policy or eng.bank.full):
            return
        in_use = {c for w in eng.composed.values() for c in w}
        with self._cv:  # across the pin check and the removal (see submit)
            in_use |= {n for n, c in self._adapter_inflight.items() if c > 0}
            candidates = [n for n in eng.bank.names if n not in ("base", incoming) and n not in in_use]
            if not candidates:
                raise ValueError(
                    f"adapter bank is at capacity ({loaded} loaded, max_adapters={self.max_adapters}) and every "
                    "adapter is pinned (a composition component or referenced by in-flight requests): remove a "
                    "composition or retry later"
                )
            victim = min(candidates, key=lambda n: self._adapter_last_used.get(n, 0.0))
            self._call("remove_adapter", victim)
            self._adapter_last_used.pop(victim, None)

    def remove_adapter(self, name: str) -> None:
        """Unload an adapter or composition from the running engine; refused
        while accepted requests still use it."""
        with self._engine_lock, self._cv:
            if self._adapter_inflight.get(name, 0) > 0:
                raise ValueError(f"adapter {name!r} is referenced by {self._adapter_inflight[name]} in-flight "
                                 "request(s); retry after they complete")
            self.engine.check_remove(name)  # before the followers see the call
            self._call("remove_adapter", name)
            self._adapter_last_used.pop(name, None)

    def compose_adapter(self, name: str, weights: dict) -> None:
        """Register a weighted composition in the running engine
        (``engine.add_composed``)."""
        weights = {str(k): float(v) for k, v in weights.items()}
        with self._engine_lock:
            self.engine.check_composed(name, weights)  # before the followers see the call
            self._call("add_composed", name, weights)

    def close(self, timeout: float = 30.0) -> None:
        """Stop the scheduler after serving the requests already queued;
        under data parallelism, then end the followers."""
        with self._cv:
            self._running = False
            self._cv.notify()
        self._thread.join(timeout)
        if _spread(self.engine):
            with self._engine_lock:
                _exchange(self.engine, None)

    def stats(self) -> dict:
        bank = self.engine.bank
        counters = getattr(self.engine, "counters", {})  # stand-in engines of the tests carry none
        return {
            "served": self.served,
            "batches": len(self.batch_sizes),
            "mean_batch": float(np.mean(self.batch_sizes)) if self.batch_sizes else 0.0,
            "pending": len(self._pending),
            "adapters": sorted(bank.names) if bank else ["base"],
            "composed": sorted(self.engine.composed),
            # over the last <= 1024 requests: submit -> result, and submit -> its batch taken
            "latency_ms": _percentiles(self.latencies_ms),
            "queue_wait_ms": _percentiles(self.queue_waits_ms),
            # the engine's since it started (serve/engine.py ServeEngine.counters)
            "engine": {k: int(counters.get(k, 0)) for k in ("merged_hits", "merged_misses", "bank_gathers")},
        }

    # -- scheduler ------------------------------------------------------------
    def _take_batch(self) -> Optional[list[_Pending]]:
        """Under ``_cv``: pop the next batch, or None to keep waiting. The
        head request anchors the batch: it collects peers of equal params
        (seeded or not) until ``max_batch`` or the head's deadline. A seeded
        lcm request goes alone."""
        if not self._pending:
            return None
        head = self._pending[0]

        def solo(r: _Pending) -> bool:
            return r.seed is not None and r.params.scheduler == "lcm"

        if solo(head):
            self._pending.popleft()
            self._note_waits([head])
            return [head]
        same = [r for r in self._pending if not solo(r) and r.params == head.params]
        deadline = head.t_submit + self.max_delay_ms / 1000.0
        if len(same) < self.max_batch and time.monotonic() < deadline and self._running:
            self._cv.wait(timeout=max(0.0, deadline - time.monotonic()))
            return None
        batch = same[: self.max_batch]
        taken = set(map(id, batch))
        self._pending = deque(r for r in self._pending if id(r) not in taken)
        self._note_waits(batch)
        return batch

    def _note_waits(self, batch: list[_Pending]) -> None:
        """Keep each request's wait from submit until now, when its batch is taken."""
        now = time.monotonic()
        end_ns = profiling.clock()
        for r in batch:
            wait = now - r.t_submit
            self.queue_waits_ms.append(wait * 1e3)
            profiling.record("serve.queue", end_ns - int(wait * 1e9), end_ns, key=r.rid)

    def _loop(self) -> None:
        while True:
            with self._cv:
                if not self._running and not self._pending:
                    return
                if not self._pending:
                    self._cv.wait(timeout=0.5)
                batch = self._take_batch()
            if batch:
                self._serve(batch)

    def _batch_rng(self, ordinal: int) -> tuple:
        """Batch key of the unseeded rows: ``(base_seed, ordinal)``, a folded
        key, whose rows never draw the latents of a request seeded with any
        ``s`` (``key_generator``), although ordinals are small ints, as the
        seeds users pick are."""
        return (self.base_seed, ordinal)

    def _serve(self, batch: list[_Pending]) -> None:
        p = batch[0].params
        rng_key = None
        if len(batch) == 1 and batch[0].seed is not None and p.scheduler == "lcm":
            seed, seeds = batch[0].seed, None  # a seeded lcm request alone: its seed is the batch key
        else:
            seed = 0  # unused: rng_key wins in engine.generate
            rng_key = self._batch_rng(self._batch_ordinal)
            self._batch_ordinal += 1
            seeds = [r.seed for r in batch] if any(r.seed is not None for r in batch) else None
        try:
            with self._engine_lock, profiling.span("serve.batch", requests=[r.rid for r in batch]):
                self.engine.check_adapters([r.adapter for r in batch])  # before the followers see the batch
                wavs = self._call(
                    "generate", [r.prompt for r in batch], adapters=[r.adapter for r in batch],
                    num_inference_steps=p.num_inference_steps, audio_length_in_s=p.audio_length_in_s,
                    guidance_scale=p.guidance_scale, scheduler=p.scheduler, seed=seed, rng_key=rng_key,
                    negative_prompt=p.negative_prompt, window_seconds=p.window_seconds,
                    window_overlap=p.window_overlap, guidance_interval=p.guidance_interval, seeds=seeds,
                )
        except Exception as e:  # noqa: BLE001 - the batch thread must keep serving
            if len(batch) > 1:
                # an unservable combination (a composed adapter forced onto
                # the rank-r route) fails the whole batch: retry each request
                # alone, so that only the offending one fails
                for r in batch:
                    self._serve([r])
                return
            batch[0].future.set_exception(e)
            self._release_inflight(batch[0])
            return
        self.batch_sizes.append(len(batch))
        self.served += len(batch)
        now = time.monotonic()
        for i, r in enumerate(batch):
            self.latencies_ms.append((now - r.t_submit) * 1e3)
            if r.adapter and r.adapter != "base":
                self._adapter_last_used[r.adapter] = now  # LRU eviction order
            r.future.set_result(wavs[i])
            self._release_inflight(r)


def _percentiles(ms) -> Optional[dict]:
    """p50, p95 and p99 of ``ms`` rounded to 0.1 ms, or None when empty."""
    x = np.asarray(ms, np.float64)
    return {q: round(float(np.percentile(x, int(q[1:]))), 1) for q in ("p50", "p95", "p99")} if x.size else None


# -- HTTP front end -------------------------------------------------------


def _wav_bytes(waveform: np.ndarray, sample_rate: int) -> bytes:
    from audioldm_tpu_torch.data.wavio import write_wav

    buf = io.BytesIO()
    write_wav(buf, waveform, sample_rate)  # wave.open takes file objects
    return buf.getvalue()


def make_server(batcher: Microbatcher, sample_rate: int, host: str = "127.0.0.1", port: int = 0,
                request_timeout_s: float = 600.0):
    """A ``ThreadingHTTPServer`` over the batcher; call ``serve_forever()``
    (blocking) or drive it from a thread. Port 0 binds a free port
    (``server.server_address[1]``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def listing() -> dict:
        bank = batcher.engine.bank
        return {"adapters": sorted(bank.names) if bank else ["base"], "composed": sorted(batcher.engine.composed)}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; /v1/stats is the observability
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/v1/stats":
                self._json(200, batcher.stats())
            elif self.path == "/v1/adapters":
                self._json(200, listing())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except ValueError as e:  # json.JSONDecodeError is a ValueError
                return self._json(400, {"error": f"bad json: {e}"})
            if not isinstance(body, dict):
                return self._json(400, {"error": "request body must be a JSON object"})
            if self.path == "/v1/generate":
                return self._generate(body)
            if self.path == "/v1/adapters":
                return self._load_adapter(body)
            self._json(404, {"error": f"no route {self.path}"})

        def do_DELETE(self):
            prefix = "/v1/adapters/"
            if not self.path.startswith(prefix) or len(self.path) <= len(prefix):
                return self._json(404, {"error": f"no route {self.path} (DELETE /v1/adapters/<name>)"})
            name = urllib.parse.unquote(self.path[len(prefix):])
            try:
                batcher.remove_adapter(name)
            except KeyError as e:
                return self._json(404, {"error": str(e)})
            except ValueError as e:
                return self._json(409, {"error": str(e)})
            self._json(200, {"removed": name, **listing()})

        def _generate(self, body: dict) -> None:
            if "prompt" not in body:
                return self._json(400, {"error": "missing 'prompt'"})
            # the coercions sit inside the try, so that a malformed value is a
            # 400 with a body
            try:
                params = GenParams.from_fields(body, batcher.defaults, batcher.engine.modules)
                seed = None if body.get("seed") is None else int(body["seed"])
            except (TypeError, ValueError) as e:
                return self._json(400, {"error": f"bad parameter: {type(e).__name__}: {e}"})
            t0 = time.monotonic()
            # submit-time rejections are the client's fault (400, or 503 when
            # closing); what the batch thread raises later is the server's
            # (500): validate() already rejected the known-bad combinations
            try:
                fut = batcher.submit(str(body["prompt"]), body.get("adapter"), params, seed)
            except (KeyError, ValueError) as e:
                return self._json(400, {"error": str(e)})
            except RuntimeError as e:
                return self._json(503, {"error": str(e)})
            try:
                wav = fut.result(timeout=request_timeout_s)
            except FuturesTimeoutError:
                return self._json(504, {"error": f"request did not complete within {request_timeout_s}s"})
            except Exception as e:  # noqa: BLE001 - an engine error is the response
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})
            self._json(200, {
                "sample_rate": sample_rate, "samples": int(wav.shape[-1]),
                "audio_b64": base64.b64encode(_wav_bytes(wav, sample_rate)).decode(),
                "latency_ms": round((time.monotonic() - t0) * 1e3, 1),
            })

        def _load_adapter(self, body: dict) -> None:
            if "name" not in body or ("path" not in body) == ("compose" not in body):
                return self._json(400, {"error": "need 'name' plus exactly one of 'path' (load a PEFT "
                                                 "safetensors) or 'compose' ({component: weight} map)"})
            if "compose" in body:
                try:
                    batcher.compose_adapter(body["name"], dict(body["compose"]))
                except (TypeError, ValueError, KeyError) as e:
                    return self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return self._json(200, {"composed": body["name"], "weights": body["compose"],
                                        "adapters": listing()["adapters"], "composed_all": listing()["composed"]})
            from audioldm_tpu_torch.ckpt import read_safetensors
            from audioldm_tpu_torch.lora import import_peft_state_dict

            try:
                adapter, rank = import_peft_state_dict(read_safetensors(body["path"]))
                batcher.load_adapter(body["name"], adapter, rank, body.get("alpha"))
            except (OSError, ValueError, KeyError) as e:
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})
            self._json(200, {"loaded": body["name"], "rank": rank, "adapters": listing()["adapters"]})

    return ThreadingHTTPServer((host, port), Handler)
