"""Self-contained serving artifacts through ``torch.export``.

Counterpart of ``diffsep_tpu/export.py``. A separation (masked
normalization, the prior draw, N sampler steps, the denoise choice,
denormalization and the mask) is exported once, with the evaluation
weights, and shipped as one file; ``load_separator(path).call(seed, mix,
n_valid)`` serves it with no config, checkpoint or model code: the loader
needs only the registration of the hand kernels' custom ops
(``ops/conv3x3.py``, ``ops/fir_resample2x.py``), which the exported step
calls as graph nodes, so the kernels launch (and count) as in the live
model.

The JAX artifact is one StableHLO module around a ``lax.scan``. Unrolled
here, a 60-evaluation sampler would be a graph of some 170k nodes, so the
artifact holds three programs and a host loop:
  * prelude: (mix, n_valid, prior draw) -> (x, normalized mix, mean, std,
    predictor state); the normalization statistics come from each row's
    first n_valid samples (``model.separate_masked``);
  * step: one corrector update then one predictor update, (x, mix, t,
    t_next, dt, corrector draws, predictor draw, state) -> (x, x_mean,
    state), the score model's weights inside;
  * epilogue: (x, x_mean, mean, std, n_valid) -> the estimate, denoised
    or not, denormalized, zero past each row's n_valid.
``ExportedSeparator.call`` runs the step N times on the time grid stored
in the metadata. The noise enters as tensors, drawn by a generator seeded
with ``seed`` on the artifact's device in ``pc_sample``'s order (the
prior, then per step the corrector's draws and the predictor's), so
``call(seed, ...)`` equals ``separate_masked(generator=
torch.Generator(device).manual_seed(seed), ...)`` on the device it was
exported on.

Format (one file, little-endian):
    8 bytes   magic b"DSTORCH\\n" (the JAX package's is b"DSEXP01\\n")
    4 bytes   uint32 length of the JSON metadata
    ...       JSON metadata: the serving contract (spec_version, batch,
              n_samples, n_speakers, fs), the sampler, the time grid, the
              device, param_bytes, and the byte length of each program
    ...       the prelude, step and epilogue, each a ``torch.export.save``
              archive

The shapes are static, (batch, n_samples): pad or chunk on the caller's
side (``cli/serve.py``'s ``ArtifactEngine`` pads rows and passes their
lengths as n_valid). An artifact serves on the device type it was
exported on; loading it for another raises.
"""
from __future__ import annotations

import contextlib
import inspect
import io
import json
import struct
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .ops import conv3x3 as _conv3x3  # noqa: F401  (registers torch.ops.diffsep.conv3x3)
from .ops import fir_resample2x as _fir  # noqa: F401  (registers torch.ops.diffsep.fir_*2x)

Tensor = torch.Tensor

__all__ = ["ExportedSeparator", "export_separator", "load_separator"]

_MAGIC = b"DSTORCH\n"
SPEC_VERSION = 2  # the JAX artifact's contract of spec_version 2: per-row n_valid
# the settings of pc_sample that an artifact bakes in (its defaults where not given)
_SAMPLER_SETTINGS = ("predictor_name", "corrector_name", "N", "snr", "corrector_steps", "denoise", "schedule",
                     "probability_flow")


def _device_scope(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class _Prelude(nn.Module):
    def __init__(self, sde, predictor):
        super().__init__()
        self.sde, self.predictor = sde, predictor

    def forward(self, mix: Tensor, n_valid: Tensor, z: Tensor):
        from .train.losses import normalize_batch_masked

        n_valid = torch.clamp(n_valid.long(), 1, mix.shape[-1])
        mix_n, mean, std = normalize_batch_masked(mix, n_valid)
        x = self.sde.prior_sampling(mix_n, z=z)
        state = list(self.predictor.init_state(x)) if self.predictor.has_state else []
        return x, mix_n, mean, std, state


class _Step(nn.Module):
    def __init__(self, score_model: nn.Module, predictor, corrector, named_schedule: bool):
        super().__init__()
        self.score_model = score_model
        self.predictor, self.corrector, self.named_schedule = predictor, corrector, named_schedule

    def forward(self, x: Tensor, y: Tensor, t: Tensor, t_next: Tensor, dt: Tensor, corrector_noise: list,
                predictor_noise: list, state: list):
        x, x_mean = self.corrector.update(x, t, y, corrector_noise)
        kw = dict(dt=dt if self.named_schedule else None, t_next=t_next,
                  z=predictor_noise[0] if predictor_noise else None)
        if self.predictor.has_state:
            x, x_mean, state = self.predictor.update(x, t, y, state=tuple(state), **kw)
            return x, x_mean, list(state)
        x, x_mean = self.predictor.update(x, t, y, **kw)
        return x, x_mean, []


class _Epilogue(nn.Module):
    def __init__(self, denoise: bool):
        super().__init__()
        self.denoise = denoise

    def forward(self, x: Tensor, x_mean: Tensor, mean: Tensor, std: Tensor, n_valid: Tensor):
        est = x_mean if self.denoise else x
        n_valid = torch.clamp(n_valid.long(), 1, est.shape[-1])
        mask = torch.arange(est.shape[-1], device=est.device)[None, None, :] < n_valid[:, None, None]
        return (est * std + mean) * mask.to(est.dtype)


def _to(t: Tensor, device: torch.device) -> Tensor:
    """``t`` on ``device``; from host memory to the card through pinned
    memory, so that the copy does not wait for the card."""
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _device_caches():
    """The ops' per-device constant caches: an entry made while tracing
    holds a fake tensor, which must not outlive the export."""
    from .ops import stft, upfirdn2d

    return (stft._device_const, upfirdn2d._flipped)


def export_separator(model, batch: int, n_samples: int, out_path=None, **sampler_kwargs) -> bytes:
    """Export ``model.separate_masked`` with the weights the model holds,
    on the model's device, for mixtures (batch, 1, n_samples). Keyword
    arguments override the model's sampler settings (predictor_name,
    corrector_name, N, snr, corrector_steps, denoise, schedule), as in
    ``model.separate``. Returns the artifact's bytes, also written to
    ``out_path`` where given."""
    from .models import layers
    from .sampling.correctors import CORRECTORS
    from .sampling.pc import make_timesteps, pc_sample
    from .sampling.predictors import PREDICTORS

    kw = model._sampler_kwargs(sampler_kwargs)
    eps = kw.pop("eps")
    unknown = set(kw) - set(_SAMPLER_SETTINGS)
    if unknown:
        raise TypeError(f"export_separator: sampler settings {sorted(unknown)} cannot be exported")
    defaults = inspect.signature(pc_sample).parameters
    sk = {k: kw.get(k, defaults[k].default) for k in _SAMPLER_SETTINGS}
    sde = model.sde if sk["N"] in (None, model.sde.N) else model.sde.copy(N=int(sk["N"]))
    sk["N"] = sde.N
    predictor = PREDICTORS[sk["predictor_name"]](sde, model.score_model, probability_flow=sk["probability_flow"])
    corrector = CORRECTORS[sk["corrector_name"]](sde, model.score_model, snr=sk["snr"],
                                                 n_steps=sk["corrector_steps"])
    ts, dts = make_timesteps(sde.T, eps, sde.N, sk["schedule"])
    ts_next = np.concatenate([ts[1:], ts[-1:]])

    dev = model.device
    ndim = sde.ndim
    mix = torch.zeros((batch, 1, n_samples), device=dev)
    n_valid = torch.full((batch,), n_samples, dtype=torch.int64, device=dev)
    z = torch.zeros((batch, ndim, n_samples), device=dev)
    t = torch.full((batch,), float(ts[0]), device=dev)
    dt = torch.full((), float(dts[0]), device=dev)
    modules = (_Prelude(sde, predictor), _Step(model.score_model, predictor, corrector, sk["schedule"] is not None),
               _Epilogue(bool(sk["denoise"])))
    programs = []
    with torch.no_grad(), layers.weights_in_graph(), _device_scope(dev):
        x, y, mean, std, state = modules[0](mix, n_valid, z)
        # one tensor object given twice would be traced as one input
        examples = ((mix, n_valid, z),
                    (x, y, t, t.clone(), dt, [z.clone() for _ in range(corrector.n_steps)],
                     [z.clone()] if predictor.needs_noise else [], state),
                    (x, x.clone(), mean, std, n_valid))
        try:
            for module, args in zip(modules, examples):
                buf = io.BytesIO()
                torch.export.save(torch.export.export(module, args), buf)
                programs.append(buf.getvalue())
        finally:
            for cache in _device_caches():
                cache.cache_clear()

    meta = {
        "spec_version": SPEC_VERSION,
        "batch": int(batch),
        "n_samples": int(n_samples),
        "n_speakers": int(ndim),
        "fs": int(model.config["fs"]),
        "sampler": dict(sk, eps=float(eps)),
        "timesteps": [float(v) for v in ts],
        "timesteps_next": [float(v) for v in ts_next],
        "dt": [float(v) for v in dts],
        "corrector_draws": int(corrector.n_steps),
        "predictor_draws": int(predictor.needs_noise),
        "device": dev.type,
        "torch_version": torch.__version__,
        "param_bytes": int(sum(p.numel() * p.element_size() for p in model.score_model.parameters())),
        "programs": [len(b) for b in programs],
    }
    mj = json.dumps(meta).encode()
    data = _MAGIC + struct.pack("<I", len(mj)) + mj + b"".join(programs)
    if out_path is not None:
        Path(out_path).write_bytes(data)
    return data


class ExportedSeparator:
    """A loaded artifact: ``call(seed, mix, n_valid)`` runs the exported
    separation on the artifact's device; ``meta`` holds its static contract
    (batch, n_samples, fs, the sampler)."""

    def __init__(self, meta: dict, programs, device: torch.device):
        self.meta = meta
        self.device = device
        self._prelude, self._step, self._epilogue = (p.module() for p in programs)

    @property
    def batch(self) -> int:
        return self.meta["batch"]

    @property
    def n_samples(self) -> int:
        return self.meta["n_samples"]

    @torch.no_grad()
    def call(self, seed: int, mix, n_valid=None, noise=None) -> Tensor:
        """The estimates (batch, n_speakers, n_samples) of mixtures (batch,
        1, n_samples) on the artifact's device. ``n_valid`` (one length per
        row, by default n_samples) marks each row's true length: its
        normalization statistics come from that span and its estimate is
        zero past it. ``noise`` hands in draws, in ``pc_sample``'s layout
        ("prior", "corrector", "predictor"), in place of the seeded
        generator's."""
        mix = torch.as_tensor(mix, dtype=torch.float32)
        b, n = self.batch, self.n_samples
        if tuple(mix.shape) != (b, 1, n):
            raise ValueError(f"exported artifact takes mix of shape {(b, 1, n)} (static serving contract), "
                             f"got {tuple(mix.shape)}; pad/chunk the batch and length on the caller side")
        n_valid = torch.full((b,), n, dtype=torch.int64) if n_valid is None else torch.as_tensor(n_valid).long()
        if tuple(n_valid.shape) != (b,):
            raise ValueError(f"n_valid must have shape ({b},), got {tuple(n_valid.shape)}")
        dev, meta = self.device, self.meta
        noise = noise or {}
        with _device_scope(dev):
            mix, n_valid = _to(mix, dev), _to(n_valid, dev)
            gen = torch.Generator(device=dev).manual_seed(int(seed))

            def draw(kind, *index):
                if kind in noise:
                    return torch.as_tensor(noise[kind])[index].to(device=dev, dtype=torch.float32)
                return torch.randn((b, meta["n_speakers"], n), generator=gen, device=dev)

            x, y, mean, std, state = self._prelude(mix, n_valid, draw("prior"))
            x_mean = x
            for i, (t, t_next, dt) in enumerate(zip(meta["timesteps"], meta["timesteps_next"], meta["dt"])):
                corrector_noise = [draw("corrector", i, j) for j in range(meta["corrector_draws"])]
                predictor_noise = [draw("predictor", i) for _ in range(meta["predictor_draws"])]
                x, x_mean, state = self._step(
                    x, y, torch.full((b,), t, device=dev), torch.full((b,), t_next, device=dev),
                    torch.full((), dt, device=dev), corrector_noise, predictor_noise, state)
            return self._epilogue(x, x_mean, mean, std, n_valid)


def load_separator(path_or_bytes, device=None) -> ExportedSeparator:
    """An artifact written by ``export_separator``, from a path or its
    bytes, on the device type it was exported on (``device``, where given,
    must be of that type)."""
    data = bytes(path_or_bytes) if isinstance(path_or_bytes, (bytes, bytearray)) else Path(path_or_bytes).read_bytes()
    if data[:len(_MAGIC)] != _MAGIC:
        raise ValueError("not a diffsep_tpu_torch export artifact (bad magic); expected a file written by "
                         "export_separator / cli.export_model")
    off = len(_MAGIC)
    (mlen,) = struct.unpack_from("<I", data, off)
    off += 4
    meta = json.loads(data[off:off + mlen].decode())
    if meta.get("spec_version") != SPEC_VERSION:
        raise ValueError(f"unsupported artifact spec_version {meta.get('spec_version')}")
    dev = torch.device(meta["device"] if device is None else device)
    if dev.type != meta["device"]:
        raise ValueError(f"the artifact was exported on {meta['device']} and serves there only, not on {dev}; "
                         "export it again on that device")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the artifact was exported on CUDA, which is not available here")
    off += mlen
    programs = []
    for size in meta["programs"]:
        programs.append(torch.export.load(io.BytesIO(data[off:off + size])))
        off += size
    return ExportedSeparator(meta, programs, dev)
