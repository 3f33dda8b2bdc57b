"""Training pipeline orchestration: data-prep -> stage 1 -> stage 2 -> eval -> register.

The port of ``ldm3d_tpu/mlops/pipelines/training_pipeline.py`` (reference
``mlops/pipelines/azure_ml_pipeline.py``: a 4-step command DAG, :65-205, and
a batch-inference pipeline, :244):
  * local mode runs the port's CLIs in-process, step by step, with the
    artifacts handed over through ``model_dir`` (the cross-stage contract),
  * ``emit_cloud_spec`` renders the DAG as a vendor-neutral JSON job spec
    (steps, images, inputs/outputs) for GKE or another scheduler.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Optional

log = logging.getLogger("training_pipeline")

__all__ = ["TrainingPipeline", "BatchInferencePipeline", "PipelineStep"]


@dataclasses.dataclass
class PipelineStep:
    name: str
    fn: Any = None  # local callable
    command: str = ""  # cloud command string
    inputs: dict = dataclasses.field(default_factory=dict)
    outputs: dict = dataclasses.field(default_factory=dict)


class TrainingPipeline:
    def __init__(self, config_file: str, environment_file: str, model_dir: str,
                 eval_threshold: float = 0.8, registry=None, max_epochs: Optional[int] = None,
                 extra_flags: Optional[list[str]] = None):
        self.config_file = config_file
        self.environment_file = environment_file
        self.model_dir = model_dir
        self.eval_threshold = eval_threshold
        self.registry = registry
        self.max_epochs = max_epochs
        self.extra_flags = extra_flags or []

    # -- steps ---------------------------------------------------------------

    def _cli_argv(self) -> list[str]:
        argv = ["-c", self.config_file, "-e", self.environment_file]
        if self.max_epochs is not None:
            argv += ["--max-epochs", str(self.max_epochs)]
        return argv + self.extra_flags

    def step_data_prep(self) -> dict:
        """Validate data availability (or synthesize) before training."""
        import argparse

        from ldm3d_torch.data import prepare_dataloader
        from ldm3d_torch.utils import merge_configs_onto_args

        args = argparse.Namespace()
        merge_configs_onto_args(args, self.environment_file, self.config_file)
        if "--synthetic-data" in self.extra_flags:
            args.synthetic_data = True
        # same divisibility rule as the stage-1 trainer — a pre-flight check
        # that validates against a different constraint than the trainer
        # enforces would pass data the trainer then rejects
        size_divisible = 2 ** (len(args.autoencoder_def["channels"]) - 1)
        tl, vl = prepare_dataloader(args, 1, args.autoencoder_train["patch_size"],
                                    randcrop=True, size_divisible=size_divisible)
        return {"train_samples": len(tl.dataset), "val_samples": len(vl.dataset)}

    def step_train_autoencoder(self) -> dict:
        from ldm3d_torch.cli.train_autoencoder import main

        best = main(self._cli_argv())
        return {"best_val_recon_loss": float(best)}

    def step_train_diffusion(self) -> dict:
        from ldm3d_torch.cli.train_diffusion import main

        best = main(self._cli_argv())
        return {"best_val_diffusion_loss": float(best)}

    def step_evaluate(self, stage2_metrics: dict) -> dict:
        """Gate on model quality (CI gate parity: perf > threshold,
        ``mlops-pipeline.yml:212-227``).

        Runs the evaluation CLI (3-D SSIM/PSNR/MAE and the VAE-latent
        Fréchet distance over sampled validation pairs,
        :mod:`ldm3d_torch.cli.evaluate`); falls back to the loss-based
        proxy score ``1/(1+val_loss)`` if sampling-based eval fails (e.g. no
        validation pairs in a smoke run). The sampled path's result carries
        ``ssim``; the proxy's does not."""
        try:
            from ldm3d_torch.cli.evaluate import main as eval_main

            report = eval_main(self._cli_argv() + ["-n", "4", "--sampler", "ddim", "--steps", "8"])
            return {"score": report.score, "ssim": report.ssim, "psnr": report.psnr,
                    "frechet": report.frechet, "passed": report.passed(self.eval_threshold)}
        except SystemExit as e:
            if e.code == 2:  # argparse usage error = real integration bug
                raise
            # exit 3 = no validation batches (smoke run): use the proxy
            log.warning("sampling-based evaluation unavailable (exit %s); using loss proxy", e.code)
        except Exception as e:  # noqa: BLE001 — smoke runs may lack checkpoints
            log.warning("sampling-based evaluation unavailable (%s); using loss proxy", e)
        val = stage2_metrics.get("best_val_diffusion_loss", float("inf"))
        score = 1.0 / (1.0 + val)
        return {"score": score, "passed": score > self.eval_threshold}

    def step_register(self, eval_result: dict, metrics: dict) -> Optional[int]:
        if self.registry is None or not eval_result["passed"]:
            return None
        return self.registry.register("ldm3d-torch", self.model_dir, metrics)

    # -- execution -----------------------------------------------------------

    def run_local(self) -> dict:
        """Execute the full DAG in-process and return the artifact summary."""
        t0 = time.time()
        results: dict[str, Any] = {}
        results["data_prep"] = self.step_data_prep()
        log.info("data prep: %s", results["data_prep"])
        results["autoencoder"] = self.step_train_autoencoder()
        log.info("stage 1: %s", results["autoencoder"])
        results["diffusion"] = self.step_train_diffusion()
        log.info("stage 2: %s", results["diffusion"])
        results["evaluation"] = self.step_evaluate(results["diffusion"])
        log.info("evaluation: %s", results["evaluation"])
        version = self.step_register(results["evaluation"],
                                     {**results["autoencoder"], **results["diffusion"]})
        results["registered_version"] = version
        results["wall_time_s"] = time.time() - t0
        return results

    def emit_cloud_spec(self, image: str = "ldm3d-torch:latest",
                        accelerator: str = "nvidia-h100-80gb") -> dict:
        """Vendor-neutral DAG spec for cloud submission (GKE/Vertex/etc.)."""
        base = f"-c {self.config_file} -e {self.environment_file}"
        steps = [
            {"name": "data-prep", "command": f"python -m ldm3d_torch.mlops.pipelines.training_pipeline --step data_prep {base}",
             "accelerator": None},
            {"name": "train-autoencoder", "command": f"python -m ldm3d_torch.cli.train_autoencoder {base} --amp",
             "accelerator": accelerator, "outputs": {"model_dir": self.model_dir}},
            {"name": "train-diffusion", "command": f"python -m ldm3d_torch.cli.train_diffusion {base} --amp",
             "accelerator": accelerator, "depends_on": ["train-autoencoder"],
             "inputs": {"model_dir": self.model_dir}},
            {"name": "evaluate-register",
             "command": f"python -m ldm3d_torch.cli.evaluate {base} --sampler ddim --gate "
                        f"--threshold {self.eval_threshold}",
             "accelerator": accelerator, "depends_on": ["train-diffusion"],
             "inputs": {"model_dir": self.model_dir}},
        ]
        return {"image": image, "steps": steps}


class BatchInferencePipeline:
    """Batch-generation DAG (reference ``azure_ml_pipeline.py:244``'s
    batch-inference pipeline): one accelerator step running the real
    inference CLI over ``num_samples``, writing NIfTI volumes to
    ``output_dir`` from the registered/registered-dir checkpoints."""

    def __init__(self, config_file: str, environment_file: str,
                 num_samples: int = 8, sampler: str = "ddim", steps: int = 50,
                 batch: int = 0, extra_flags: Optional[list[str]] = None):
        self.config_file = config_file
        self.environment_file = environment_file
        self.num_samples = num_samples
        self.sampler = sampler
        self.steps = steps
        self.batch = batch  # 0 = auto (device-aligned, capped at 8)
        self.extra_flags = extra_flags or []

    def _batch(self, probe_devices: bool = True) -> int:
        """Device-aligned batch: a multiple of the CUDA device count, at most 8
        a device (the JAX package's rule), bounded by num_samples.

        ``probe_devices=False`` (cloud-spec emission) counts no devices: the
        local machine's says nothing about the target's, so the spec takes
        one device unless the caller passed an explicit ``batch``."""
        if self.batch > 0:
            return self.batch
        n_dev = 1
        if probe_devices:
            import torch

            n_dev = max(1, torch.cuda.device_count())
        return max(1, min(self.num_samples, 8 * n_dev) // n_dev * n_dev)

    def run_local(self) -> dict:
        from ldm3d_torch.cli.inference import main as infer_main

        t0 = time.time()
        batch = self._batch()
        num_calls = -(-self.num_samples // batch)
        argv = ["-c", self.config_file, "-e", self.environment_file,
                "--num", str(num_calls), "--batch", str(batch),
                "--sampler", self.sampler, "--steps", str(self.steps)] + self.extra_flags
        written = infer_main(argv)
        for surplus in written[self.num_samples:]:
            # padding of the final chunk: don't leave unrequested volumes for
            # downstream steps that glob output_dir
            try:
                os.remove(surplus)
            except OSError:
                pass
        return {"num_samples": self.num_samples, "sampler": self.sampler,
                "batch": batch, "files": written[:self.num_samples],
                "wall_time_s": time.time() - t0}

    def emit_cloud_spec(self, image: str = "ldm3d-torch:latest",
                        accelerator: str = "nvidia-h100-80gb") -> dict:
        batch = self._batch(probe_devices=False)
        cmd = (f"python -m ldm3d_torch.cli.inference -c {self.config_file} "
               f"-e {self.environment_file} --num {-(-self.num_samples // batch)} "
               f"--batch {batch} --sampler {self.sampler} --steps {self.steps}")
        return {"image": image,
                "steps": [{"name": "batch-inference", "command": cmd,
                           "accelerator": accelerator}]}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="run the training pipeline")
    p.add_argument("-c", "--config-file", required=True)
    p.add_argument("-e", "--environment-file", required=True)
    p.add_argument("--model-dir", default="./checkpoints")
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--emit-spec", action="store_true", help="print the cloud DAG spec and exit")
    p.add_argument("--step", default=None,
                   choices=("data_prep", "train_autoencoder", "train_diffusion", "evaluate"),
                   help="run ONE pipeline step (what the emitted cloud spec's "
                        "per-step commands invoke) instead of the whole DAG")
    p.add_argument("--batch-inference", type=int, default=0, metavar="N",
                   help="run the batch-inference pipeline for N samples instead of training")
    p.add_argument("--sampler", default="ddim", help="batch-inference sampler (ddpm/ddim/dpm)")
    p.add_argument("--steps", type=int, default=50, help="batch-inference sampler steps")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    extra = ["--synthetic-data"] if args.synthetic_data else []
    if args.batch_inference > 0:
        bpipe = BatchInferencePipeline(args.config_file, args.environment_file,
                                       num_samples=args.batch_inference,
                                       sampler=args.sampler, steps=args.steps,
                                       extra_flags=extra)
        if args.emit_spec:
            print(json.dumps(bpipe.emit_cloud_spec(), indent=2))
            return
        print(json.dumps(bpipe.run_local(), default=str))
        return
    pipe = TrainingPipeline(args.config_file, args.environment_file, args.model_dir,
                            max_epochs=args.max_epochs, extra_flags=extra)
    if args.emit_spec:
        print(json.dumps(pipe.emit_cloud_spec(), indent=2))
        return
    if args.step:
        step_fns = {
            "data_prep": pipe.step_data_prep,
            "train_autoencoder": pipe.step_train_autoencoder,
            "train_diffusion": pipe.step_train_diffusion,
            "evaluate": lambda: pipe.step_evaluate({}),
        }
        print(json.dumps(step_fns[args.step](), default=str))
        return
    results = pipe.run_local()
    print(json.dumps({k: v for k, v in results.items()}, default=str))


if __name__ == "__main__":
    main()
