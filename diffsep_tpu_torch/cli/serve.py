"""Long-running separation service.

    python -m diffsep_tpu_torch.cli.serve OUT_DIR --model RUN_DIR [--watch DIR | --http HOST:PORT]

Counterpart of ``diffsep_tpu/cli/serve.py``. The model is loaded once and
stays on the card; requests are grouped by length bucket (1 s by default)
and separated in micro-batches of up to ``--batch``, padded with zero rows.
``--model`` may also be an export artifact of the port
(``cli/export_model.py``), served by ``ArtifactEngine`` at its static batch
and length, with the sampler it was exported with. A sampler that a run's
config pins (a distilled stage) is the default. Three front ends share the
engine:
  * stdin (default): one wav path per line; the sources are written to
    ``OUT_DIR/s<i>/<stem>.wav`` and ``DONE <path>`` (or ``ERROR <path>
    <reason>``) printed per request;
  * ``--watch DIR``: a drop folder, polled for new wav files;
  * ``--http HOST:PORT``: ``POST /v1/separate`` (``cli/serve_http.py``).
It runs on CUDA unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import logging
import os
import select
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..data.audio_io import load_wav, save_wav
from ..train.losses import normalize_rows_host
from ..train.trainer import step_generator
from .eval_common import apply_pinned_sampler, reject_baked_flags, sampler_flag_map
from .loading import load_model
from .separate import reject_artifact, resolve_model_path, scale_output

log = logging.getLogger(__name__)

MAX_ATTEMPTS = 3


class _EngineBase:
    """The serving front half: request validation, length buckets,
    micro-batches, output writing. A subclass provides ``_dispatch_bucket``,
    which enqueues one micro-batch on the card and returns at once with a
    handle (no synchronize, ``.cpu()`` or ``.item()``), and
    ``_finalize_bucket``, which copies its result to the host and
    postprocesses each request; and sets ``fs``, ``batch`` and ``bucket``.

    ``pipeline`` runs them at depth 1: micro-batch k+1 is dispatched before
    k is finalized, so the host's enqueueing of k+1 overlaps k's device time
    and k's copy to the host. The stdin and watch loops (``process``) and
    the HTTP worker share it."""

    def _run_bucket(self, mixes):
        """Unpipelined: warmup and one-shot callers."""
        return self._finalize_bucket(self._dispatch_bucket(mixes))

    def validate(self, wav: np.ndarray, sr: int):
        """An error message for a request that must not join a micro-batch,
        or None. A (2, n) row would make the batch's stack raise and fail
        the other requests in it."""
        if sr != self.fs:
            return f"sample rate {sr} != model {self.fs}"
        if wav.ndim != 2 or wav.shape[0] != 1:
            return f"expected mono (1, n), got shape {tuple(wav.shape)}"
        if wav.shape[-1] < 1:
            return "empty signal"
        return None

    def chunks(self, items, length):
        """``items`` grouped by length bucket (shortest first) and cut into
        micro-batches of up to ``batch``."""
        groups = {}
        for item in items:
            groups.setdefault(-(-length(item) // self.bucket), []).append(item)
        return [group[off:off + self.batch] for _, group in sorted(groups.items())
                for off in range(0, len(group), self.batch)]

    def pipeline(self, items, wav):
        """Separate ``items`` (``wav(item)`` is its (1, n) signal) in the
        micro-batches of ``chunks``, through the depth-1 pipeline; yields
        (chunk, estimates, error, latency s, finalize wait s) per
        micro-batch, estimates None where its dispatch or finalize raised:
        the error fails only its own chunk. The latency runs from the
        dispatch to the estimates, and so includes the overlap with the
        next micro-batch's dispatch: a pipeline latency, not a compute
        time."""

        def settle(chunk, handle, t0):
            t_fin = time.perf_counter()
            try:
                ests, err = self._finalize_bucket(handle), None
            except Exception as e:
                ests, err = None, e
            done = time.perf_counter()
            return chunk, ests, err, done - t0, done - t_fin

        pending = None  # (chunk, handle, t0)
        for chunk in self.chunks(items, lambda item: wav(item).shape[-1]):
            t0 = time.perf_counter()
            try:
                handle, err = self._dispatch_bucket([wav(item) for item in chunk]), None
            except Exception as e:
                handle, err = None, e
            if pending is not None:
                yield settle(*pending)
                pending = None
            if err is not None:
                yield chunk, None, err, 0.0, 0.0
            else:
                pending = (chunk, handle, t0)
        if pending is not None:
            yield settle(*pending)

    def process(self, paths, output_dir: Path):
        """Separate the wav files ``paths``; yields (path, ok, message)."""
        items = []
        for p in paths:
            p = Path(p)
            try:
                wav, sr = load_wav(p)
                err = self.validate(wav, sr)
            except Exception as e:  # an unreadable file must not stop serving
                yield p, False, f"{type(e).__name__}: {e}"
                continue
            if err is not None:
                yield p, False, err
            else:
                items.append((p, wav))

        for chunk, ests, err, latency, wait in self.pipeline(items, lambda item: item[1]):
            if err is not None:
                for p, _ in chunk:
                    yield p, False, f"{type(err).__name__}: {err}"
                continue
            for (p, _), est in zip(chunk, ests):
                try:  # a failed write fails only its own file
                    for src in range(est.shape[0]):
                        save_wav(output_dir / f"s{src}" / f"{p.stem}.wav", est[src:src + 1], self.fs)
                except Exception as e:
                    yield p, False, f"write failed: {type(e).__name__}: {e}"
                    continue
                yield p, True, f"pipeline latency {latency:.3f}s/{len(chunk)}-batch, finalize wait {wait:.3f}s"


class SeparationEngine(_EngineBase):
    """Micro-batching separation engine around a live model. Micro-batch k
    draws from a generator seeded by (seed, k)."""

    def __init__(self, model, batch: int = 4, bucket_s: float = 1.0, seed: int = 0,
                 sampler_kwargs=None, predictor: str = "reverse_diffusion", corrector: str = "ald2"):
        self.model = model
        self.batch = batch
        self.fs = int(model.config["fs"])
        self.bucket = max(int(bucket_s * self.fs), 1)
        self.seed = seed
        self.n_req = 0
        self.predictor = predictor
        self.corrector = corrector
        self.sampler_kwargs = dict(sampler_kwargs or {})

    def warmup(self, seconds) -> None:
        """Run one request of each length: loads the kernels (built with nvcc
        at first use) before the first real request."""
        for s in seconds:
            self._run_bucket([np.zeros((1, int(s * self.fs)), np.float32) + 1e-3])
            log.info("warmup: ran the %.1f s bucket", s)

    def _dispatch_bucket(self, mixes):
        """Enqueue the separation of (1, n) signals of one length bucket;
        returns the handle for ``_finalize_bucket``."""
        lens = [m.shape[-1] for m in mixes]
        padded = -(-max(lens) // self.bucket) * self.bucket
        rows, means, stds = normalize_rows_host(mixes, padded)
        rows += [np.zeros_like(rows[0])] * (self.batch - len(rows))
        device = self.model.device
        mix_n = torch.from_numpy(np.stack(rows))
        if device.type == "cuda":
            mix_n = mix_n.pin_memory().to(device, non_blocking=True)
        self.n_req += 1
        sampler = self.model.get_pc_sampler(
            self.predictor, self.corrector, mix_n,
            generator=step_generator(self.seed, self.n_req, device), **self.sampler_kwargs)
        est, _ = sampler()
        return est, means, stds, mixes, lens

    def _finalize_bucket(self, handle):
        """The copy to the host, denormalization and projection -> a list of
        (n_src, n)."""
        est, means, stds, mixes, lens = handle
        est = est.float().cpu().numpy()
        return [scale_output(mixes[j][None], est[j:j + 1, :, :lens[j]] * stds[j] + means[j])[0]
                for j in range(len(mixes))]


class ArtifactEngine(_EngineBase):
    """Serving from an export artifact of the port (``export.py``): no
    config, checkpoint or model code, one static (batch, n_samples)
    contract and the sampler baked in at export. A request of up to
    n_samples is a zero-padded row whose length goes in as the artifact's
    n_valid, so that its normalization statistics come from its true span,
    as the live engine's do on the host; filler rows are full-length zeros.
    Micro-batch k draws from the seed (seed, k)."""

    def __init__(self, sep, seed: int = 0):
        self.sep = sep
        self.fs = int(sep.meta["fs"])
        self.batch = sep.batch
        self.bucket = sep.n_samples  # one static length
        self.seed = seed
        self.n_req = 0

    def warmup(self, seconds=()) -> None:
        """Run the artifact once (its length is baked in): loads the kernels
        before the first real request."""
        self._run_bucket([np.zeros((1, self.bucket), np.float32) + 1e-3])
        log.info("warmup: ran the artifact's static shape")

    def validate(self, wav: np.ndarray, sr: int):
        err = super().validate(wav, sr)
        if err is None and wav.shape[-1] > self.bucket:
            return f"{wav.shape[-1]} samples, more than the artifact's static {self.bucket}"
        return err

    def _dispatch_bucket(self, mixes):
        lens = [m.shape[-1] for m in mixes]
        n = self.bucket
        rows = [np.pad(np.asarray(m, np.float32), ((0, 0), (0, n - m.shape[-1]))) for m in mixes]
        n_valid = lens + [n] * (self.batch - len(rows))
        rows += [np.zeros((1, n), np.float32)] * (self.batch - len(rows))
        self.n_req += 1
        seed = (self.seed * 1_000_003 + self.n_req) & 0x7FFFFFFF
        est = self.sep.call(seed, np.stack(rows), np.asarray(n_valid, np.int64))
        return est, mixes, lens

    def _finalize_bucket(self, handle):
        est, mixes, lens = handle
        est = est.float().cpu().numpy()
        return [scale_output(mixes[j][None], est[j:j + 1, :, :lens[j]])[0] for j in range(len(mixes))]


def _is_artifact(path: Path) -> bool:
    """Whether ``path`` is an export artifact of the port, by its magic,
    whatever its name."""
    from ..export import _MAGIC

    try:
        with open(path, "rb") as f:
            return f.read(len(_MAGIC)) == _MAGIC
    except OSError:
        return False


def _engine_from_args(args):
    model_path = resolve_model_path(args.model)
    device = resolve_device(args.device)
    if _is_artifact(model_path):
        from ..export import load_separator

        reject_baked_flags(sampler_flag_map(args), "sampler settings are baked into the artifact at export "
                           "time (cli/export_model.py); re-export to change them")
        eng = ArtifactEngine(load_separator(model_path, device=device), seed=args.seed)
        log.info("artifact engine: batch=%d n_samples=%d fs=%d (--batch and --bucket-s do not apply: the "
                 "artifact's static contract rules)", eng.batch, eng.bucket, eng.fs)
        return eng
    reject_artifact(model_path)
    model = load_model(model_path, device=device)
    apply_pinned_sampler(args, model.config)
    kw = {k: v for k, v in (("N", args.N), ("snr", args.snr), ("corrector_steps", args.corrector_steps),
                            ("schedule", getattr(args, "schedule", None))) if v is not None}
    return SeparationEngine(model, batch=args.batch, bucket_s=args.bucket_s, seed=args.seed,
                            sampler_kwargs=kw, predictor=args.predictor or "reverse_diffusion",
                            corrector=args.corrector or "ald2")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Long-running separation service: stdin line protocol, --watch drop folder or --http")
    parser.add_argument("output_dir", type=Path)
    parser.add_argument("--model", type=Path, default=Path("fakufaku/diffsep"),
                        help="run dir, checkpoint file, reference .ckpt, or an export artifact "
                        "(cli/export_model.py)")
    parser.add_argument("--watch", type=Path, default=None, help="poll this directory for new wav files")
    parser.add_argument("--http", default=None, metavar="HOST:PORT",
                        help="serve over HTTP: POST /v1/separate (wav body -> multi-channel wav), "
                        "GET /healthz, GET /metrics (cli/serve_http.py)")
    parser.add_argument("--http-queue", type=int, default=64, help="pending-request cap before 503 (http)")
    parser.add_argument("--http-timeout-s", type=float, default=600.0, help="per-request timeout (http)")
    parser.add_argument("--poll-s", type=float, default=1.0)
    parser.add_argument("--batch", type=int, default=4, help="micro-batch size (requests per sampler run)")
    parser.add_argument("--bucket-s", type=float, default=1.0, help="length-bucket granularity in seconds")
    parser.add_argument("--warmup-s", type=float, nargs="*", default=[],
                        help="run one request of each of these lengths (seconds) at startup")
    parser.add_argument("-N", type=int, default=None)
    parser.add_argument("--snr", type=float, default=None)
    parser.add_argument("--corrector-steps", type=int, default=None)
    parser.add_argument("--predictor", default=None, help="default: reverse_diffusion")
    parser.add_argument("--corrector", default=None, help="default: ald2")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--once", action="store_true",
                        help="watch mode: process what is there, then exit")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    if args.http is not None and args.watch is not None:
        raise SystemExit("--http and --watch are mutually exclusive")

    engine = _engine_from_args(args)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    if args.warmup_s:
        engine.warmup(args.warmup_s)
    if args.http is not None:
        from .serve_http import HTTPSeparationServer

        host, _, port = args.http.rpartition(":")
        HTTPSeparationServer(engine, host=host or "127.0.0.1", port=int(port), max_queue=args.http_queue,
                             timeout_s=args.http_timeout_s).serve_forever()
    elif args.watch is not None:
        _watch_loop(engine, args)
    else:
        _stdin_loop(engine, args)


def _watch_loop(engine, args):
    # keyed by (path, mtime_ns, size): a new file dropped under a name done
    # before is a new request
    done = set()
    attempts: dict = {}  # identity -> failed attempts
    sizes: dict = {}  # path -> size at the last poll
    while True:
        candidates, idents, present = [], {}, set()
        for p in sorted(args.watch.glob("*.wav")):
            # presence comes from the listing: a failed stat (a file removed
            # meanwhile, a network file system's hiccup) must not drop the
            # path's bookkeeping and separate it again
            present.add(p)
            try:
                st = p.stat()
            except OSError:
                continue
            ident = (p, st.st_mtime_ns, st.st_size)
            idents[p] = ident
            if ident in done or attempts.get(ident, 0) >= MAX_ATTEMPTS:
                continue
            # a file still being copied in changes size between polls
            if not args.once and sizes.get(p) != st.st_size:
                sizes[p] = st.st_size
                continue
            candidates.append(p)
        # forget paths that left the folder, so a long run does not grow
        done = {d for d in done if d[0] in present}
        attempts = {k: v for k, v in attempts.items() if k[0] in present}
        sizes = {k: v for k, v in sizes.items() if k in present}
        for p, ok, msg in engine.process(candidates, args.output_dir):
            ident = idents[p]
            if ok:
                done.add(ident)
            else:
                # retried on later polls, up to a cap: a transient error must
                # not blacklist a request
                attempts[ident] = attempts.get(ident, 0) + 1
                if attempts[ident] >= MAX_ATTEMPTS:
                    msg += f" (giving up after {MAX_ATTEMPTS} attempts)"
            print("DONE" if ok else "ERROR", p, msg, flush=True)
        if args.once:
            return
        time.sleep(args.poll_s)


def _stdin_loop(engine, args):
    """The stdin line protocol, micro-batched: after a blocking read of one
    request, the lines already pending (up to ``--batch``) join it. The fd
    is read directly: ``readline()`` would pull pending lines into Python's
    buffer, where ``select()`` cannot see them, and a writer sending many
    lines in one write would get batches of one."""
    fd = sys.stdin.fileno()
    state = {"buf": b"", "eof": False}
    lines: list = []

    def pull(block: bool) -> None:
        if state["eof"]:
            return
        if not block and not select.select([fd], [], [], 0.05)[0]:
            return
        chunk = os.read(fd, 65536)
        if not chunk:
            state["eof"] = True
            if state["buf"]:  # a last line without a newline
                lines.append(state["buf"].decode(errors="replace").strip())
                state["buf"] = b""
            return
        state["buf"] += chunk
        *complete, state["buf"] = state["buf"].split(b"\n")
        lines.extend(c.decode(errors="replace").strip() for c in complete)

    while not (state["eof"] and not lines):
        if not lines:
            pull(block=True)
            continue
        while sum(1 for line in lines if line) < args.batch and not state["eof"]:
            before = (len(lines), len(state["buf"]))
            pull(block=False)
            if (len(lines), len(state["buf"])) == before:
                break  # nothing more is pending
        paths = []
        while lines and len(paths) < args.batch:
            line = lines.pop(0)
            if line:
                paths.append(line)
        if paths:
            for p, ok, msg in engine.process(paths, args.output_dir):
                print("DONE" if ok else "ERROR", p, msg, flush=True)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
