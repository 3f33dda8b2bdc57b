"""Model server core: load checkpoints, generate volumes, report status.

The port of ``ldm3d_tpu/serving/model_server.py``: ``load_model()`` builds
the two-stage pipeline from the training config and the port's ``.pt``
checkpoints on ``device`` (``cuda`` unless the caller asks for ``cpu``), and
``generate(num_samples, seed, ...)`` returns min-max normalised volumes as
base64 float32 (or NIfTI) with shape metadata; ``model_info()`` reports the
state.

What differs from the JAX server:

* The dummy model (random noise, for serving-infrastructure tests) is served
  only when the config, environment or checkpoint files are missing
  (``FileNotFoundError``). Every other load error propagates: a server
  without its CUDA device, out of device memory, or misconfigured never
  reports healthy while serving noise. Without CUDA, a ``device="cuda"``
  server raises at construction.
* A sampler variant is a scheduler and a Python loop, not a compiled
  program; the variant cache keeps the JAX server's contract (LRU bound, the
  server default pinned, one build per variant under concurrency).
* Noise comes from ``torch.Generator().manual_seed(seed)`` on the CPU and is
  moved to the device, so a seed gives the same noise on the CPU and the card
  (not the JAX server's volumes: the two frameworks draw differently).
* Device work (encode, sampler, decode) runs under one lock; the copy of the
  result to the host happens after the lock is released.
* ``spatial > 1`` (depth-sharded serving) is not ported and raises
  ``ValueError`` naming its ROADMAP.md item.

``sampler="distilled"`` serves the progressively-distilled student
(``cli.distill``) as the JAX server does: its weights and few-step GridDDIM
grid from the ``distilled`` checkpoint (``cli.common.load_distilled``), a
server without that checkpoint raising ``ValueError`` (no dummy), and every
request held to the student's grid: no other sampler, step count, guidance
or ``timestep_spacing``.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import logging
import threading
import time
import uuid
from typing import Any, Optional

import numpy as np
import torch

from ldm3d_torch.cli.common import (
    SAMPLERS,
    TIMESTEP_SPACINGS,
    default_sampler_steps,
    load_distilled,
    load_two_stage,
    make_sampling_scheduler,
    pin_fp32_precision,
    resolve_decode_chunk,
    resolve_device,
)

log = logging.getLogger("model_server")


class _RWGate:
    """Reader-writer gate: ``generate()`` calls are readers, ``load_model()``
    (the ``POST /model/reload`` admin op) is the writer, so a reload never
    swaps the pipeline under an in-flight request. Writer-preferring: once a
    reload waits, new requests queue behind it."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


def _squeeze_single_channel(arr: np.ndarray) -> np.ndarray:
    """Drop a trailing size-1 channel axis; keep multi-channel volumes whole."""
    return arr[..., 0] if arr.shape[-1] == 1 else arr


class _SamplerCacheEntry:
    """Cache slot for one sampler variant: ``fn is None`` while (or after a
    failed) build; ``ready`` is set once the owning thread published ``fn``
    or recorded ``error``."""

    __slots__ = ("fn", "error", "ready")

    def __init__(self):
        self.fn = None
        self.error: Optional[BaseException] = None
        self.ready = threading.Event()


class ModelServer:
    def __init__(self, config_file: Optional[str] = None, environment_file: Optional[str] = None,
                 sampler: str = "ddim", steps: Optional[int] = None, batch: int = 1,
                 spatial: int = 1, decode_chunk: "int | str" = 0,
                 timestep_spacing: Optional[str] = None, device: str = "cuda"):
        """``batch``: volumes per sampler call; requests for more run in
        chunks, shorter ones pad and trim, and concurrent single-volume
        requests to a deterministic sampler share calls through the
        micro-batcher, which waits up to 10 ms to fill one.
        ``device``: where the models run; raises without CUDA unless
        ``"cpu"``."""
        if int(spatial) > 1:
            raise ValueError("spatial > 1 (depth-sharded serving over several cards) is not "
                             "ported yet: ROADMAP.md queue A, item 11 ('Parallelism')")
        if timestep_spacing is not None and timestep_spacing not in TIMESTEP_SPACINGS:
            raise ValueError(f"timestep_spacing must be one of "
                             f"{'|'.join(TIMESTEP_SPACINGS)}, got {timestep_spacing!r}")
        if timestep_spacing == "karras" and sampler == "ddpm":
            raise ValueError("karras timestep_spacing is not available on the "
                             "ancestral ddpm sampler; use ddim, dpm, or dpm3")
        if isinstance(decode_chunk, str) and decode_chunk != "auto":
            raise ValueError(f"decode_chunk must be an int or 'auto', got {decode_chunk!r}")
        self.device = resolve_device(device)
        self.config_file = config_file
        self.environment_file = environment_file
        self.sampler = sampler
        # None = the sampler's default, resolved at load_model
        self.steps = steps
        # server-default grid spacing (None = the config's)
        self.timestep_spacing = timestep_spacing
        self.batch = max(1, int(batch))
        self.decode_chunk = decode_chunk if decode_chunk == "auto" else max(0, int(decode_chunk))
        self.model_loaded = False
        self.is_dummy = False
        self.load_time: Optional[float] = None
        self.patch_size = [32, 32, 32]
        self._lock = threading.Lock()
        # serialises device work: concurrent batch-B calls could exhaust
        # device memory together
        self._device_lock = threading.Lock()
        self._run = None  # sampler run fn of the server defaults
        self._batcher = None
        self._latent_shape = None
        self._cond_shape = None
        self._encode_condition = None
        self._sched_cfg: dict = {}
        self._rng_counter = 0
        # (sampler, steps, guidance, spacing) -> run fn, LRU-bounded with the
        # server default pinned
        self._sampler_cache: "dict[tuple, Any]" = {}
        self._sampler_cache_max = 8
        self._build_run = None
        self._reload_gate = _RWGate()

    # -- loading -------------------------------------------------------------

    def load_model(self) -> None:
        pin_fp32_precision()  # api_server.main reaches the pin here
        with self._reload_gate.write():
            t0 = time.time()
            if self._batcher is not None:  # reload: retire the old batcher
                self._batcher.close()
                self._batcher = None
            try:
                self._load_real()
                self.is_dummy = False
                log.info("loaded the two-stage pipeline on %s", self.device)
            except FileNotFoundError as e:
                # only missing artifacts fall back; a device, memory or
                # configuration error propagates
                log.warning("falling back to dummy model: %s", e)
                self._load_dummy()
                self.is_dummy = True
            self.model_loaded = True
            self.load_time = time.time() - t0

    def _load_real(self) -> None:
        from ldm3d_torch.diffusion import inferer
        from ldm3d_torch.utils import TrainContext, merge_configs_onto_args

        if not (self.config_file and self.environment_file):
            raise FileNotFoundError("no config/environment file configured")
        args = argparse.Namespace()
        merge_configs_onto_args(args, self.environment_file, self.config_file)
        sched_cfg = TrainContext(args).scheduler_config()
        self.patch_size = list(args.diffusion_train["patch_size"])
        if self.decode_chunk == "auto":
            self.decode_chunk = resolve_decode_chunk("auto", log, self.device)
        # fp32, as the JAX server serves the models' fp32
        ae, unet, latent, scale_factor = load_two_stage(args, self.device, torch.float32)
        distilled_sched = None
        if self.sampler == "distilled":
            try:
                unet, distilled_sched, dmeta = load_distilled(args.model_dir, unet, sched_cfg,
                                                              self.device)
            except FileNotFoundError as e:
                # a misconfiguration the user can act on, not a missing
                # artifact: no dummy model
                raise ValueError(
                    f"sampler='distilled' but no distilled checkpoint in "
                    f"{args.model_dir!r}: run ldm3d-distill first ({e})") from e
            scale_factor = float(dmeta.get("scale_factor", scale_factor))
            if self.steps is not None and int(self.steps) != int(dmeta["num_steps"]):
                raise ValueError(
                    f"the distilled student has a fixed {int(dmeta['num_steps'])}"
                    f"-step grid; --steps {self.steps} cannot apply to it")
            self.steps = int(dmeta["num_steps"])
            log.info("serving distilled student: %d-step grid %s", self.steps,
                     dmeta["timesteps"])
        if self.steps is None:
            self.steps = default_sampler_steps(self.sampler, sched_cfg)
        conditional = unet.in_channels > ae.latent_channels
        device = self.device
        self._sched_cfg = sched_cfg
        self._latent_shape = (*latent, ae.latent_channels)
        self._cond_shape = (*latent, unet.in_channels - ae.latent_channels) if conditional else None

        def encode_condition(vol: np.ndarray, gen: torch.Generator) -> torch.Tensor:
            eps = torch.randn((vol.shape[0], *self._latent_shape), generator=gen)
            with torch.no_grad():
                return ae.encode_stage_2_inputs(torch.from_numpy(vol).to(device), eps.to(device))

        def build_run(sampler_name: str, steps: int, guidance: float,
                      spacing: "str | None" = None):
            # None = server default (its timestep_spacing, else the config's)
            spacing = spacing if spacing is not None else self.timestep_spacing
            scheduler = (distilled_sched if sampler_name == "distilled"
                         else make_sampling_scheduler(sampler_name, steps, sched_cfg,
                                                      timestep_spacing=spacing))
            chunk = self.decode_chunk

            def run(noise, generator, condition, step_noises=None):
                # list contract: device tensors, not read back; the caller
                # copies them to the host outside _device_lock. A noisy
                # sampler draws from ``generator`` or takes ``step_noises``.
                lat = inferer.sample_latents(unet, scheduler, noise,
                                             condition if conditional else None,
                                             guidance_scale=guidance, generator=generator,
                                             step_noises=step_noises)
                lat = lat / torch.tensor(scale_factor, dtype=lat.dtype)
                with torch.no_grad():
                    if chunk and lat.shape[0] > chunk:
                        return [ae.decode_stage_2_outputs(lat[s:s + chunk])
                                for s in range(0, lat.shape[0], chunk)]
                    return [ae.decode_stage_2_outputs(lat)]

            return run

        self._encode_condition = encode_condition
        self._build_run = build_run
        self._sampler_cache = {}
        self._run = self._get_run(self.sampler, self.steps, 1.0, None)

        # micro-batcher only for deterministic samplers (ddim/dpm/dpm3): a
        # sample then depends on its own noise alone; ddpm's ancestral draws
        # would tie a request's output to its batch-mates
        if self.batch > 1 and self.sampler != "ddpm":
            from ldm3d_torch.serving.batcher import DynamicBatcher

            default_run = self._run

            def run_batched(noise_np, rng_seed, cond_np):
                noise = torch.from_numpy(noise_np).to(device)
                cond = torch.from_numpy(cond_np).to(device) if cond_np is not None else None
                with self._device_lock:
                    pending = default_run(noise, None, cond)
                return np.concatenate([p.float().cpu().numpy() for p in pending])

            self._batcher = DynamicBatcher(run_batched, self.batch, max_wait_ms=10.0)

    def _get_run(self, sampler_name: str, steps: int, guidance: float,
                 spacing: "str | None" = None):
        """Sampler run fn for a (sampler, steps, guidance, spacing) variant,
        cached: the ``_sampler_cache_max`` least recently used variants are
        kept, the server default pinned. A variant is built outside the cache
        lock; concurrent requests for the same new variant wait on the one
        build through a placeholder entry."""
        key = (sampler_name, int(steps), float(guidance), spacing)
        default_key = (self.sampler, self.steps, 1.0, None)
        with self._lock:
            entry = self._sampler_cache.get(key)
            if entry is not None and entry.fn is not None:
                # move-to-end: the insertion-ordered dict doubles as LRU order
                self._sampler_cache.pop(key)
                self._sampler_cache[key] = entry
                return entry.fn
            owner = entry is None
            if owner:
                entry = _SamplerCacheEntry()
                self._sampler_cache[key] = entry
                self._evict_locked(default_key)
        if not owner:
            entry.ready.wait()
            if entry.fn is None:
                raise RuntimeError(f"sampler variant {key} failed to build") from entry.error
            return entry.fn
        log.info("building sampler variant %s", key)
        try:
            fn = self._build_run(sampler_name, steps, guidance, spacing)
        except BaseException as e:
            with self._lock:
                self._sampler_cache.pop(key, None)
            entry.error = e
            entry.ready.set()
            raise
        with self._lock:
            entry.fn = fn
            # placeholders are never evicted: restore the bound now that a
            # completed entry exists
            self._evict_locked(default_key)
        entry.ready.set()
        return fn

    def _evict_locked(self, default_key: tuple) -> None:
        """Evict LRU completed non-default entries until the cache fits."""
        while len(self._sampler_cache) > self._sampler_cache_max:
            victim = next((k for k, e in self._sampler_cache.items()
                           if k != default_key and e.fn is not None), None)
            if victim is None:
                return
            del self._sampler_cache[victim]

    def _load_dummy(self) -> None:
        if self.steps is None:
            self.steps = 50
        self._cond_shape = None
        self._latent_shape = None
        self._run = None
        self._build_run = None
        self._sampler_cache = {}
        self._encode_condition = None

    # -- generation ----------------------------------------------------------

    def generate(self, num_samples: int = 1, seed: Optional[int] = None,
                 condition_volume: Optional[np.ndarray] = None,
                 inference_steps: Optional[int] = None,
                 guidance_scale: Optional[float] = None,
                 output_format: str = "base64",
                 sampler: Optional[str] = None,
                 timestep_spacing: Optional[str] = None) -> dict[str, Any]:
        """Sample ``num_samples`` volumes.

        A concat-conditional model takes ``condition_volume``, the low-count
        volume of shape ``patch_size`` (or ``(*patch_size, C)``) in [0, 1]; it
        is VAE-encoded once and conditions every sample. Without one the
        condition latents are drawn from N(0, 1), flagged as
        ``"conditioning": "random"``. ``inference_steps``, ``guidance_scale``,
        ``sampler`` and ``timestep_spacing`` override the server defaults; a
        sampler override without steps takes that sampler's default count.
        ``output_format``: "base64" (raw float32) or "nii" (a NIfTI-1 file,
        base64-encoded)."""
        with self._reload_gate.read():
            return self._generate(num_samples, seed, condition_volume, inference_steps,
                                  guidance_scale, output_format, sampler, timestep_spacing)

    def _generate(self, num_samples, seed, condition_volume, inference_steps, guidance_scale,
                  output_format, sampler, timestep_spacing) -> dict[str, Any]:
        if not self.model_loaded:
            raise RuntimeError("model not loaded")
        if output_format not in ("base64", "nii"):
            raise ValueError(f"output_format must be base64|nii, got {output_format!r}")
        if timestep_spacing not in (None, *TIMESTEP_SPACINGS):
            raise ValueError(f"timestep_spacing must be leading|trailing|karras, "
                             f"got {timestep_spacing!r}")
        if self.sampler == "distilled" and not self.is_dummy:
            # the student's weights and few-step grid are a unit
            if sampler not in (None, "distilled"):
                raise ValueError("server is running the distilled student; "
                                 "per-request sampler overrides are unavailable")
            if inference_steps is not None and int(inference_steps) != self.steps:
                raise ValueError(f"the distilled student has a fixed {self.steps}-step grid")
            if guidance_scale is not None and float(guidance_scale) != 1.0:
                raise ValueError("guidance is unavailable on the distilled student: its "
                                 "guidance level was fixed at distillation time "
                                 "(ldm3d-distill --guidance-distill bakes a weight in)")
            if timestep_spacing is not None:
                raise ValueError("timestep_spacing is unavailable on the distilled student: "
                                 "its weights and few-step grid are a unit")
        elif sampler == "distilled":
            raise ValueError("start the server with sampler='distilled' to serve "
                             "the distilled student")
        elif sampler is not None and sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {'|'.join(SAMPLERS)}, got {sampler!r}")
        sampler_name = sampler if sampler is not None else self.sampler
        if inference_steps is not None:
            steps = int(inference_steps)
        elif sampler_name != self.sampler and not self.is_dummy:
            steps = default_sampler_steps(sampler_name, self._sched_cfg)
        else:
            steps = self.steps
        guidance = float(guidance_scale) if guidance_scale is not None else 1.0
        if guidance != 1.0 and not self.is_dummy and self._cond_shape is None:
            # guidance is a no-op without conditioning: echo the applied 1.0
            log.info("guidance_scale %.2f ignored: unconditional model", guidance)
            guidance = 1.0
        # the grid spacing this request runs: request > server > config;
        # None for the dummy model and the distilled student's fixed grid
        applied_spacing = None
        if not self.is_dummy and sampler_name != "distilled":
            server_spacing = self.timestep_spacing or self._sched_cfg.get("timestep_spacing",
                                                                          "leading")
            applied_spacing = timestep_spacing or server_spacing
            if applied_spacing == "karras" and sampler_name == "ddpm":
                raise ValueError(
                    "karras timestep_spacing is not available on the ancestral ddpm sampler; "
                    "use ddim, dpm, or dpm3"
                    + ("" if timestep_spacing is not None else
                       " (this server's default spacing is karras — pass timestep_spacing="
                       "'leading' or 'trailing' with the ddpm request)"))
            if timestep_spacing == server_spacing:
                # the server default's own program
                timestep_spacing = None
        is_default = (sampler_name == self.sampler and steps == self.steps
                      and guidance == 1.0 and timestep_spacing is None)
        conditioning = "none"
        t0 = time.time()
        if self.is_dummy:
            with self._lock:
                rng = np.random.default_rng(seed)
                vols = rng.standard_normal((num_samples, *self.patch_size), dtype=np.float32)
                time.sleep(0.05)  # simulated latency, as the JAX dummy
        else:
            vols, conditioning = self._sample(num_samples, seed, condition_volume, is_default,
                                              sampler_name, steps, guidance, timestep_spacing)
        samples = []
        for v in vols:
            vmin, vmax = float(v.min()), float(v.max())
            norm = (v - vmin) / (vmax - vmin) if vmax > vmin else np.zeros_like(v)
            norm = norm.astype(np.float32)
            if output_format == "nii":
                from ldm3d_torch.utils.nifti import nifti_bytes

                payload = nifti_bytes(norm)
            else:
                payload = norm.tobytes()
            samples.append({"data": base64.b64encode(payload).decode("ascii"),
                            "shape": list(v.shape), "dtype": "float32",
                            "format": output_format})
        elapsed = time.time() - t0
        return {
            "samples": samples,
            "status": "success",
            "request_id": uuid.uuid4().hex,
            "generation_time": elapsed,
            "processing_time_ms": elapsed * 1000.0,
            "model_version": "dummy" if self.is_dummy else "ldm3d_torch",
            "num_samples": num_samples,
            "sampler": "dummy" if self.is_dummy else sampler_name,
            "inference_steps": steps,
            "guidance_scale": guidance,
            # the APPLIED spacing; None only for the dummy model
            "timestep_spacing": applied_spacing,
            "output_format": output_format,
            "conditioning": conditioning,
        }

    def _sample(self, num_samples, seed, condition_volume, is_default, sampler_name, steps,
                guidance, spacing) -> tuple[np.ndarray, str]:
        """Volumes ``(num_samples, *patch[, C])`` on the host, and how they
        were conditioned."""
        with self._lock:
            base = seed if seed is not None else self._rng_counter
            self._rng_counter += 1
        gen = torch.Generator().manual_seed(int(base))
        conditioning = "none"
        fixed_cond = None
        if self._cond_shape and condition_volume is not None:
            vol = np.asarray(condition_volume, np.float32)
            if vol.ndim == 3:
                vol = vol[..., None]
            if list(vol.shape[:3]) != list(self.patch_size):
                raise ValueError(f"condition volume shape {vol.shape} does not match "
                                 f"patch_size {self.patch_size}")
            with self._device_lock:
                fixed_cond = self._encode_condition(np.clip(vol[None], 0, 1), gen)
            conditioning = "provided"
        elif self._cond_shape:
            conditioning = "random"
        run = (self._run if is_default
               else self._get_run(sampler_name, steps, guidance, spacing))
        # the micro-batcher runs the server default only
        batcher = self._batcher if is_default else None
        if num_samples == 1 and batcher is not None:
            noise = torch.randn(self._latent_shape, generator=gen).numpy()
            cond = None
            if self._cond_shape:
                cond = (fixed_cond[0].float().cpu().numpy() if fixed_cond is not None
                        else torch.randn(self._cond_shape, generator=gen).numpy())
            vol_out = batcher.submit(noise, cond, rng_seed=base, timeout=600)
            return _squeeze_single_channel(np.asarray(vol_out, dtype=np.float32))[None], \
                conditioning
        b = self.batch
        cond_b = (fixed_cond.expand(b, *fixed_cond.shape[1:]) if fixed_cond is not None
                  else None)
        with self._device_lock:
            # every batch is queued on the device under the lock...
            pending = []
            for _ in range((num_samples + b - 1) // b):
                noise = torch.randn((b, *self._latent_shape), generator=gen).to(self.device)
                cond = cond_b
                if cond is None and self._cond_shape:
                    cond = torch.randn((b, *self._cond_shape), generator=gen).to(self.device)
                pending.extend(run(noise, gen, cond))
        # ...and read back after it is released
        vols = np.concatenate([_squeeze_single_channel(p.float().cpu().numpy())
                               for p in pending])
        return vols[:num_samples], conditioning

    def model_info(self) -> dict[str, Any]:
        if self.device.type == "cuda":
            devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        else:
            devices = ["cpu"]
        return {
            "loaded": self.model_loaded,
            "dummy": self.is_dummy,
            "load_time": self.load_time,
            "patch_size": self.patch_size,
            "sampler": self.sampler,
            "steps": self.steps,
            "timestep_spacing": self.timestep_spacing,  # None = the config's
            "backend": self.device.type,
            "device": str(self.device),
            "devices": devices,
            "micro_batching": (
                {"batch_size": self._batcher.batch_size,
                 "batches_run": self._batcher.batches_run,
                 "samples_run": self._batcher.samples_run}
                if self._batcher is not None else None),
        }
