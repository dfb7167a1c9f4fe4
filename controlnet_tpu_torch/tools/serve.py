"""HTTP serving of the distilled 1-step students and the few-step ControlNet
teacher.

Counterpart of the JAX package's ``tools/serve.py``, with its four models:

* ``consistency`` (the default): the consistency student's ``generate``,
  ``?steps=N`` model calls over the Karras ladder (1 by default);
* ``dmd``: the DMD student, one call at t = T - 1 whatever ``steps`` says;
* ``ddim_controlnet`` / ``dpm_controlnet``: the (non-distilled) DDPM
  ControlNet checkpoint sampled with a few-step solver, ``?steps=`` model
  evaluations per image, clamped to [-1, 1].

The students' outputs are not clamped, as in the JAX server.  ``--ckpt`` is
the student's reference-format ``.pth`` (default: where the port's trainer
writes it) or the ControlNet's.

    python -m controlnet_tpu_torch.tools.serve --config config/mnist.yaml \\
        [--model consistency|dmd|dpm_controlnet|ddim_controlnet] [--ckpt path.pth] \\
        [--attn_fused_proj] --port 8000

Endpoints (the JAX server's contract):
  GET  /healthz             -> {"status": "ok", "model": ..., "warm": true,
                               "max_batch": ..., "max_steps": ...,
                               "batch_window_ms": ...}
  POST /generate[?steps=N]  -> body: hint PNG bytes (grayscale or RGB, resized
                               to im_size); response: sample PNG.
  POST /generate_batch[?steps=N] -> body: npz with array "hints"
                               (B, im_size, im_size, hint_channels) float32;
                               response: npz with "samples" (B, H, W, C).
Both POSTs answer with the headers X-Latency-Ms (host clock around the
generation, the copy of the samples back to the host included, so the device
has finished) and X-Batch-Rows (rows of the dispatch the request rode in).
``steps`` defaults to 1; an unparseable or out-of-range value, a bad body or a
bad shape is a 400; a generation error is a 500 for every member of its batch.

Serving model: a ThreadingHTTPServer, so PNG / npz codec work overlaps across
requests, and one dispatcher thread that owns the device.  Requests are
batched dynamically across clients (``_MicroBatcher``) and padded to
power-of-two buckets up to ``--max-batch``.  Warm-up runs one generation per
bucket before the server accepts requests; on the card that is where the CUDA
kernels are built, so no request pays for it.

With more than one card visible the server holds one replica of its model
per card and splits a bucket evenly over them when its rows divide by their
count, as the JAX server shards a bucket over its mesh's data axis; other
buckets run on the first replica (``_replicated``).

Runs on the card; ``--device cpu`` runs it on the CPU.  Arrays are NHWC on the
wire and NCHW inside, permuted at the boundary.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from controlnet_tpu_torch import config as cfg
from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.io import images
from controlnet_tpu_torch.nn.layers import set_attn_fused_proj
from controlnet_tpu_torch.tools import sample_consistency_controlnet_distilled as cd_tool
from controlnet_tpu_torch.tools import sample_ddpm_controlnet as sample_tool
from controlnet_tpu_torch.tools import (
    sample_distribution_matching_controlnet_distilled as dmd_tool)

MODELS = ("consistency", "dmd", "ddim_controlnet", "dpm_controlnet")


def _student_generator(args, config, device):
    """``generate`` of a distilled student (``args.model`` consistency or
    dmd) on ``device``, unclamped."""
    task_name = cfg.train_params(config)["task_name"]
    ckpt = getattr(args, "ckpt", None)
    if args.model == "consistency":
        model = cd_tool.load_student(config, ckpt or os.path.join(task_name, cd_tool.CKPT_NAME),
                                     device)
        set_attn_fused_proj(model, getattr(args, "attn_fused_proj", False))

        def generate(hints, generator, steps=1, x_start=None, noise=None):
            h = torch.as_tensor(hints, device=model.device).permute(0, 3, 1, 2)
            return cd_tool.generate(model, h, steps, generator, x_start, noise)

        return generate
    student = dmd_tool.load_student(config, ckpt or dmd_tool.default_ckpt(task_name, True),
                                    device)
    set_attn_fused_proj(student, getattr(args, "attn_fused_proj", False))
    num_timesteps = cfg.diffusion_params(config)["num_timesteps"]
    student_device = student.unet.conv_in.weight.device

    def generate(hints, generator, steps=1, x_start=None, noise=None):
        del steps, noise  # one call at t = T - 1
        h = torch.as_tensor(hints, device=student_device).permute(0, 3, 1, 2)
        return dmd_tool.generate(student, h, num_timesteps, generator, x_start)

    return generate


def _teacher_generator(args, config, device):
    """``generate`` of the few-step DDPM ControlNet teacher on ``device``,
    clamped, and its schedule."""
    train_config = cfg.train_params(config)
    ckpt = getattr(args, "ckpt", None) or os.path.join(
        train_config["task_name"], train_config["controlnet_ckpt_name"])
    cn, sched = sample_tool.load_model(config, ckpt, device)
    set_attn_fused_proj(cn, getattr(args, "attn_fused_proj", False))
    solver = args.model.split("_")[0]  # "ddim" | "dpm"

    def generate(hints: np.ndarray, generator: torch.Generator | None, steps: int = 1,
                 x_start: torch.Tensor | None = None, noise=None) -> torch.Tensor:
        del noise  # DDIM at eta 0 and DPM-Solver++ draw x_T only
        with torch.inference_mode():
            loop, hint_arg, _ = sample_tool.prepare(cn, sched, hints, sampler=solver,
                                                    sampler_steps=steps)
            x0, _ = loop(cn, generator, hint_arg, x_start=x_start)
            # few-step x0 estimates can slightly overshoot the image range
            return torch.clamp(x0, -1.0, 1.0)

    return generate, sched


def serve_devices(device: torch.device) -> list:
    """The devices that hold a replica each: every visible card when the
    server runs on the card (``cuda`` with no index) and more than one is
    visible, else ``device`` alone."""
    if device.type == "cuda" and device.index is None and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def splits_over_replicas(rows: int, n_replicas: int) -> bool:
    """The JAX server's rule (``hint.shape[0] % n_data == 0``): a bucket whose
    rows divide by the replica count is split evenly over the replicas;
    another runs on the first."""
    return n_replicas > 1 and rows % n_replicas == 0


def _replicated(gens: list, devices: list, draw):
    """One ``generate`` over replicas ``gens`` (one per device): a bucket
    that splits is cut into equal row blocks, replica i taking block i; its
    draws (``draw(generator, rows, steps, x_start)``: x_T, and the consistency
    student's re-injected noise) are taken at the bucket's shape from the
    one generator, in the order one replica takes them (an injected
    ``x_start`` in place of the x_T draw), and sliced, so the answer is one
    replica's."""
    n = len(gens)

    def generate(hints, generator, steps=1, x_start=None):
        b = hints.shape[0]
        if not splits_over_replicas(b, n):
            return gens[0](hints, generator, steps, x_start)
        drawn, noise = draw(generator, b, steps, x_start)
        per = b // n
        outs = []
        for i, (gen, device) in enumerate(zip(gens, devices)):
            rows = slice(i * per, (i + 1) * per)
            with (torch.cuda.device(device) if device.type == "cuda"
                  else contextlib.nullcontext()):
                outs.append(gen(hints[rows], None, steps, drawn[rows].to(device),
                                None if noise is None else [z[rows].to(device) for z in noise]))
        return torch.cat([o.to(devices[0]) for o in outs])

    return generate


def build_generator(args, config, devices: list | None = None):
    """Load the model and return ``(generate, im_size, im_channels,
    hint_channels, steps_cap)``.

    ``generate(hints_nhwc, generator, steps, x_start=None)`` returns a (B, C,
    H, W) tensor on the (first) model's device; ``x_start`` replaces the x_T
    drawn from ``generator``.  A student runs its ``steps``-call generation
    (DMD: one call) unclamped; a teacher encodes the hints once, runs the
    ``steps``-step solver of ``args.model`` and clamps to [-1, 1].
    ``steps_cap`` is a teacher's schedule length (a solver walks a
    subsequence of it), None for a student.  ``devices`` (default: the one
    of ``args.device``) each hold a replica of the model (``_replicated``)."""
    if args.model not in MODELS:
        raise ValueError(f"unknown model {args.model!r} (one of {', '.join(MODELS)})")
    model_config = cfg.model_params(config)
    im_size, im_channels = model_config["im_size"], model_config["im_channels"]
    shape = (im_size, im_channels, model_config["hint_channels"])
    devices = devices or [resolve_device(getattr(args, "device", None))]
    steps_cap = None
    if args.model in ("consistency", "dmd"):
        gens = [_student_generator(args, config, d) for d in devices]
    else:
        built = [_teacher_generator(args, config, d) for d in devices]
        gens, steps_cap = [g for g, _ in built], built[0][1].num_timesteps
    if len(gens) == 1:
        return (gens[0], *shape, steps_cap)

    def draw(generator, rows, steps, x_start):
        size = (rows, im_channels, im_size, im_size)
        x_t = x_start if x_start is not None else torch.randn(size, generator=generator,
                                                               device=generator.device)
        if args.model != "consistency" or steps == 1:
            return x_t, None
        return x_t, [torch.randn(size, generator=generator, device=generator.device)
                     for _ in range(steps - 1)]

    return (_replicated(gens, devices, draw), *shape, steps_cap)


def _bucket(b: int, max_batch: int) -> int:
    """Next power of two >= b, capped at max_batch.

    Eager PyTorch does not recompile per shape, but few batch shapes keep
    cuDNN's algorithm choice stable and are what a later CUDA-graph capture
    needs.  The cap is exact: with a ``max_batch`` that is no power of two
    the last bucket is max_batch itself, never the power of two above it, so
    the operator's memory cap is not exceeded."""
    n = 1
    while n < b and n * 2 <= max_batch:
        n *= 2
    return n if n >= b else max_batch


@dataclass
class _Request:
    """One client's generation request, parked until its batch resolves."""

    hints: np.ndarray  # (n, H, W, C)
    steps: int
    event: threading.Event = field(default_factory=threading.Event)
    samples: np.ndarray | None = None
    latency_ms: float = 0.0
    batch_rows: int = 0
    error: Exception | None = None
    cancelled: bool = False  # submit() timed out; do not spend device time


class _MicroBatcher:
    """Cross-request dynamic batching in front of one device.

    One dispatcher thread pulls requests off a queue and coalesces those
    with the same ``steps`` value into a single device call of up to
    ``max_batch`` rows.  Two mechanisms fill batches:

    * backpressure coalescing: while the device executes batch k, arrivals
      queue up and are drained (without blocking) into batch k+1, which costs
      idle requests nothing;
    * an arrival window: after the first request of a batch, up to
      ``window_ms`` is spent waiting for near-simultaneous requests, so that a
      burst hitting an idle device still shares one dispatch (0 disables).

    Requests that do not fit the current batch (other steps, or rows past
    max_batch) are deferred in FIFO order to the next batch.
    """

    def __init__(self, run_fn, max_batch: int, window_ms: float):
        self._run = run_fn
        self._max_batch = max_batch
        self._window_s = max(0.0, window_ms) / 1000.0
        self._queue: queue.Queue = queue.Queue()
        self._pending: collections.deque = collections.deque()
        self._drain_lock = threading.Lock()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-microbatcher")
        self._thread.start()

    def stop(self) -> None:
        self._stop = True
        self._thread.join(timeout=5.0)
        # Fail any still-parked requests instead of leaving their handler
        # threads (and clients) to sit out the full submit timeout.
        self._fail_parked()

    def _fail_parked(self) -> None:
        """Complete every queued / pending request with a shutdown error.
        Guarded by a lock so that stop() and late submit() calls can both
        drain without completing a request twice."""
        with self._drain_lock:
            leftovers = list(self._pending)
            self._pending.clear()
            while True:
                try:
                    leftovers.append(self._queue.get_nowait())
                except queue.Empty:
                    break
        for r in leftovers:
            r.error = RuntimeError("server shutting down")
            r.event.set()

    def submit(self, hints: np.ndarray, steps: int,
               timeout: float = 600.0) -> tuple[np.ndarray, float, int]:
        """Enqueue and block until the batch containing this request ran.
        Returns (samples, latency_ms, dispatched_batch_rows)."""
        if self._stop:
            raise RuntimeError("server shutting down")
        req = _Request(hints, steps)
        self._queue.put(req)
        if self._stop:
            # stop() may have drained between the check above and the put;
            # with the dispatcher gone nothing else would ever complete this
            # request, so drain again and let it fail fast.
            self._fail_parked()
        if not req.event.wait(timeout):
            # Mark it dead so the dispatcher sheds it instead of spending a
            # device call on a result nobody will read.
            req.cancelled = True
            raise TimeoutError("generation timed out in the batching queue")
        if req.error is not None:
            raise req.error
        return req.samples, req.latency_ms, req.batch_rows

    # ---- dispatcher thread ----
    def _loop(self) -> None:
        pending = self._pending
        while not self._stop:
            if pending:
                head = pending.popleft()
            else:
                try:
                    head = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
            if head.cancelled:
                continue
            group, rows = [head], head.hints.shape[0]
            deferred = []
            deadline = time.monotonic() + self._window_s
            while rows < self._max_batch:
                if pending:
                    nxt = pending.popleft()
                else:
                    remaining = deadline - time.monotonic()
                    try:
                        # what is already queued is drained even after the
                        # window has closed (block=False)
                        nxt = self._queue.get(block=remaining > 0,
                                              timeout=max(remaining, 0.0))
                    except queue.Empty:
                        break
                if nxt.cancelled:
                    continue
                if (nxt.steps != head.steps
                        or rows + nxt.hints.shape[0] > self._max_batch):
                    deferred.append(nxt)
                    continue
                group.append(nxt)
                rows += nxt.hints.shape[0]
            pending.extendleft(reversed(deferred))
            self._dispatch(group, rows)

    def _dispatch(self, group: list, rows: int) -> None:
        try:
            hints = (group[0].hints if len(group) == 1
                     else np.concatenate([r.hints for r in group]))
            samples, latency_ms = self._run(hints, group[0].steps)
            off = 0
            for r in group:
                n = r.hints.shape[0]
                r.samples = samples[off:off + n]
                off += n
                r.latency_ms = latency_ms
                r.batch_rows = rows
                r.event.set()
        except Exception as e:  # surfaced per request as a 500
            for r in group:
                r.error = e
                r.event.set()


def _buckets(max_batch: int) -> list[int]:
    """Every batch size ``_bucket`` can return: the powers of two up to
    max_batch, and max_batch itself when it is not one."""
    out, b = [], 1
    while b <= max_batch:
        out.append(b)
        b *= 2
    if out[-1] != max_batch:
        out.append(max_batch)
    return out


def make_server(args, config, warm: bool = True,
                devices: list | None = None) -> ThreadingHTTPServer:
    """Build the (not yet running) HTTP server; tests drive it in a thread.
    ``devices`` hold one replica of the model each (default
    ``serve_devices``: every card when more than one is visible); the
    generator and the dispatcher live on the first."""
    devices = devices or serve_devices(resolve_device(getattr(args, "device", None)))
    device = devices[0]
    gen, im_size, _, hint_channels, steps_cap = build_generator(args, config, devices)
    max_batch = getattr(args, "max_batch", 8)
    # A solver cannot take more steps than the schedule has: the schedule
    # length caps the operator's --max-steps, and a request above it is a 400.
    max_steps = getattr(args, "max_steps", 8)
    if steps_cap is not None:
        max_steps = min(max_steps, steps_cap)
    window_ms = getattr(args, "batch_window_ms", 2.0)

    if warm:
        warm_gen = torch.Generator(device=device).manual_seed(0)
        for b in _buckets(max_batch):
            gen(np.zeros((b, im_size, im_size, hint_channels), np.float32), warm_gen, 1).cpu()

    generator = torch.Generator(device=device).manual_seed(args.seed)

    def device_scope():
        return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()

    def run(hints: np.ndarray, steps: int) -> tuple[np.ndarray, float]:
        """Pad to the bucket, generate, unpad.  Only the batcher's dispatcher
        thread calls this, so the device, the generator and the kernels'
        launch counters have one user.  Returns (samples NHWC, latency_ms);
        the copy to the host makes the clock wait for the device."""
        b = hints.shape[0]
        nb = _bucket(b, max_batch)
        if nb != b:
            hints = np.concatenate(
                [hints, np.zeros((nb - b,) + hints.shape[1:], hints.dtype)])
        t0 = time.time()
        # the current device is per thread, as is the inference mode that
        # ``gen`` enters: both are set here, in the dispatcher thread
        with device_scope():
            out = gen(hints, generator, steps).permute(0, 2, 3, 1).cpu().numpy()
        latency_ms = (time.time() - t0) * 1000.0
        return out[:b], latency_ms

    # --no-dynamic-batching: a coalescing cap of 1, every request its own
    # device call (the control of an A/B, and an operational escape hatch).
    coalesce_cap = max_batch if getattr(args, "dynamic_batching", True) else 1
    batcher = _MicroBatcher(run, coalesce_cap, window_ms)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str, extra: dict | None = None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _generate(self, hints: np.ndarray, steps: int):
            """(samples, reply headers), or None after a 500 was sent."""
            try:
                samples, latency_ms, rows = batcher.submit(hints, steps)
            except Exception as e:
                self._reply(500, f"generation failed: {e}".encode(), "text/plain")
                return None
            return samples, {"X-Latency-Ms": f"{latency_ms:.2f}", "X-Batch-Rows": str(rows)}

        def do_GET(self):
            if self.path.startswith("/healthz"):
                body = json.dumps({"status": "ok", "model": args.model, "warm": warm,
                                   "max_batch": max_batch, "max_steps": max_steps,
                                   "batch_window_ms": window_ms}).encode()
                self._reply(200, body, "application/json")
            else:
                self._reply(404, b"", "text/plain")

        def do_POST(self):
            # ``steps`` is read from the query string by its exact name (a
            # substring match would misread e.g. ?num_steps=4).
            steps = 1
            qs = parse_qs(urlparse(self.path).query)
            if "steps" in qs:
                try:
                    steps = int(qs["steps"][-1])
                except ValueError:
                    self._reply(400, b"steps must be an integer", "text/plain")
                    return
                if not 1 <= steps <= max_steps:
                    self._reply(400, f"steps must be in [1, {max_steps}]".encode(), "text/plain")
                    return
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)

            if self.path.startswith("/generate_batch"):
                try:
                    with np.load(io.BytesIO(raw)) as z:
                        hints = np.asarray(z["hints"], np.float32)
                except Exception as e:
                    self._reply(400, f"bad npz body: {e}".encode(), "text/plain")
                    return
                if (hints.ndim != 4 or hints.shape[0] < 1 or hints.shape[0] > max_batch
                        or hints.shape[1:] != (im_size, im_size, hint_channels)):
                    self._reply(400, f"bad hints shape {hints.shape}".encode(), "text/plain")
                    return
                done = self._generate(hints, steps)
                if done is None:
                    return
                buf = io.BytesIO()
                np.savez_compressed(buf, samples=done[0])
                self._reply(200, buf.getvalue(), "application/octet-stream", done[1])
                return

            if not self.path.startswith("/generate"):
                self._reply(404, b"", "text/plain")
                return
            try:
                hint = images.decode_hint_png(raw, im_size, hint_channels)
            except Exception as e:
                self._reply(400, f"bad image body: {e}".encode(), "text/plain")
                return
            done = self._generate(hint, steps)
            if done is None:
                return
            self._reply(200, images.encode_sample_png(done[0][0]), "image/png", done[1])

    class Server(ThreadingHTTPServer):
        # socketserver's default listen backlog of 5 makes a burst of clients
        # wait out TCP connection retries (1 s, 3 s, 7 s, ...) before the
        # batcher ever sees them
        request_queue_size = 128

        def server_close(self):
            batcher.stop()
            super().server_close()

    return Server((args.host, args.port), Handler)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Serve a distilled student or the few-step ControlNet teacher over HTTP "
                    "(PyTorch port)")
    parser.add_argument("--config", dest="config_path", default="config/mnist.yaml")
    parser.add_argument("--model", choices=MODELS, default="consistency",
                        help="consistency / dmd: the distilled 1-step student (consistency "
                             "takes ?steps= calls); ddim_controlnet / dpm_controlnet: few-step "
                             "sampling from the ControlNet checkpoint, ?steps= being the "
                             "solver's step count (dpm is second-order: matched quality at "
                             "roughly half the DDIM steps)")
    parser.add_argument("--ckpt", default=None,
                        help="reference-format .pth: the student's (default: where the port's "
                             "trainer writes it) or the ControlNet's (default: "
                             "<task_name>/<controlnet_ckpt_name>)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--attn_fused_proj", action="store_true",
                        help="run each self-attention layer the fused kernel takes as one "
                             "launch, projections included (off by default)")
    parser.add_argument("--max-batch", dest="max_batch", type=int, default=16,
                        help="largest batch bucket")
    parser.add_argument("--max-steps", dest="max_steps", type=int, default=8,
                        help="largest allowed ?steps= value (capped at the schedule length)")
    parser.add_argument("--no-dynamic-batching", dest="dynamic_batching", action="store_false",
                        help="one request per device call (the control of an A/B)")
    parser.add_argument("--batch-window-ms", dest="batch_window_ms", type=float, default=2.0,
                        help="arrival window of the cross-request batching: after the first "
                             "request of a batch, wait up to this long for more before "
                             "dispatching (0 disables; coalescing while the device is busy "
                             "always happens)")
    args = parser.parse_args(argv)

    config = cfg.load_config(args.config_path)
    server = make_server(args, config)
    print(f"warm; serving {args.model} on {args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
