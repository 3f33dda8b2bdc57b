"""Programmatic workspace setup: create and verify the GPU training estate.

The port of ``ldm3d_tpu/mlops/workspace.py`` (reference
``mlops/azure/setup_workspace.py``: a workspace, a GPU training cluster and a
CPU inference cluster, :1-138), on Google Cloud: drives ``gcloud`` to create
a GKE cluster, an NVIDIA H100 node pool for training and a CPU node pool for
serving, each only when it is missing, and verifies that everything is
provisioned.

The gcloud binary is injectable so tests drive the whole create/verify flow
against a fake executable; ``--dry-run`` prints the exact commands.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
from dataclasses import dataclass, field

log = logging.getLogger("workspace")

__all__ = ["WorkspaceConfig", "WorkspaceSetup", "WorkspaceError", "main"]


class WorkspaceError(RuntimeError):
    """gcloud is unavailable or a provisioning command failed."""


@dataclass
class WorkspaceConfig:
    project: str
    cluster: str = "ldm3d-cluster"
    region: str = "us-central1"
    zone: str = "us-central1-a"
    # GPU training pool: one H100 80GB a node (A3)
    gpu_pool: str = "gpu-train-pool"
    gpu_machine_type: str = "a3-highgpu-1g"
    gpu_accelerator: str = "nvidia-h100-80gb"
    gpu_count: int = 1
    gpu_nodes: int = 1
    # CPU serving pool (reference parity: separate inference cluster)
    cpu_pool: str = "cpu-serve-pool"
    cpu_machine_type: str = "n2-standard-16"
    cpu_min_nodes: int = 1
    cpu_max_nodes: int = 4
    labels: dict = field(default_factory=lambda: {"app": "ldm3d-torch"})


class WorkspaceSetup:
    def __init__(self, config: WorkspaceConfig, gcloud: str = "gcloud",
                 dry_run: bool = False):
        self.cfg = config
        self.gcloud = gcloud
        self.dry_run = dry_run
        self.commands_run: list[list[str]] = []

    # -- plumbing -------------------------------------------------------------

    def _run(self, *argv: str, timeout: float = 1800.0) -> str:
        cmd = [self.gcloud, *argv, "--project", self.cfg.project]
        self.commands_run.append(cmd)
        if self.dry_run:
            print(" ".join(cmd))
            return ""
        try:
            out = subprocess.run(cmd, check=True, capture_output=True, text=True,
                                 timeout=timeout)
        except FileNotFoundError as e:
            raise WorkspaceError(f"gcloud not found ({self.gcloud!r})") from e
        except subprocess.CalledProcessError as e:
            raise WorkspaceError(f"{' '.join(cmd)} failed: {e.stderr or e.stdout}") from e
        except subprocess.TimeoutExpired as e:
            raise WorkspaceError(f"{' '.join(cmd)} timed out") from e
        return out.stdout

    def _exists(self, *argv: str) -> bool:
        try:
            self._run(*argv)
            return True
        except WorkspaceError:
            return False

    # -- create ---------------------------------------------------------------

    def create_cluster(self) -> None:
        """GKE cluster (idempotent: describe first, like the reference's
        get-or-create workspace flow)."""
        if not self.dry_run and self._exists(
                "container", "clusters", "describe", self.cfg.cluster,
                "--region", self.cfg.region):
            log.info("cluster %s already exists", self.cfg.cluster)
            return
        log.info("creating cluster %s", self.cfg.cluster)
        self._run("container", "clusters", "create", self.cfg.cluster,
                  "--region", self.cfg.region,
                  "--num-nodes", "1",
                  "--labels", ",".join(f"{k}={v}" for k, v in self.cfg.labels.items()))

    def create_gpu_nodepool(self) -> None:
        """H100 node pool: the training counterpart of the reference's A100
        gpu-cluster (``workspace_config.yml:11``)."""
        if not self.dry_run and self._exists(
                "container", "node-pools", "describe", self.cfg.gpu_pool,
                "--cluster", self.cfg.cluster, "--region", self.cfg.region):
            log.info("GPU pool %s already exists", self.cfg.gpu_pool)
            return
        log.info("creating GPU node pool %s (%s, %d x %s)", self.cfg.gpu_pool,
                 self.cfg.gpu_machine_type, self.cfg.gpu_count, self.cfg.gpu_accelerator)
        self._run("container", "node-pools", "create", self.cfg.gpu_pool,
                  "--cluster", self.cfg.cluster, "--region", self.cfg.region,
                  "--machine-type", self.cfg.gpu_machine_type,
                  "--accelerator", f"type={self.cfg.gpu_accelerator},count={self.cfg.gpu_count},"
                                   "gpu-driver-version=default",
                  "--num-nodes", str(self.cfg.gpu_nodes),
                  "--spot")  # trainers resume from preemption (training/preemption.py)

    def create_cpu_nodepool(self) -> None:
        if not self.dry_run and self._exists(
                "container", "node-pools", "describe", self.cfg.cpu_pool,
                "--cluster", self.cfg.cluster, "--region", self.cfg.region):
            log.info("CPU pool %s already exists", self.cfg.cpu_pool)
            return
        log.info("creating CPU node pool %s", self.cfg.cpu_pool)
        self._run("container", "node-pools", "create", self.cfg.cpu_pool,
                  "--cluster", self.cfg.cluster, "--region", self.cfg.region,
                  "--machine-type", self.cfg.cpu_machine_type,
                  "--enable-autoscaling",
                  "--min-nodes", str(self.cfg.cpu_min_nodes),
                  "--max-nodes", str(self.cfg.cpu_max_nodes))

    # -- verify ---------------------------------------------------------------

    def verify(self) -> dict:
        """Check every component is provisioned; returns a status report
        (the reference's setup ends by printing workspace details)."""
        report = {}
        for name, argv in (
            ("cluster", ("container", "clusters", "describe", self.cfg.cluster,
                         "--region", self.cfg.region)),
            ("gpu_pool", ("container", "node-pools", "describe", self.cfg.gpu_pool,
                          "--cluster", self.cfg.cluster, "--region", self.cfg.region)),
            ("cpu_pool", ("container", "node-pools", "describe", self.cfg.cpu_pool,
                          "--cluster", self.cfg.cluster, "--region", self.cfg.region)),
        ):
            report[name] = "ok" if (self.dry_run or self._exists(*argv)) else "missing"
        report["ready"] = all(v == "ok" for k, v in report.items() if k != "ready")
        return report

    def setup(self) -> dict:
        if not self.dry_run and not (os.path.sep in self.gcloud or shutil.which(self.gcloud)):
            raise WorkspaceError(f"{self.gcloud!r} is not on PATH")
        self.create_cluster()
        self.create_gpu_nodepool()
        self.create_cpu_nodepool()
        return self.verify()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="create + verify the GKE/GPU training workspace")
    p.add_argument("--project", required=True)
    p.add_argument("--cluster", default="ldm3d-cluster")
    p.add_argument("--region", default="us-central1")
    p.add_argument("--gpu-count", type=int, default=1, choices=(1, 2, 4, 8),
                   help="H100 cards a training node (machine type a3-highgpu-<n>g)")
    p.add_argument("--dry-run", action="store_true", help="print gcloud commands only")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    cfg = WorkspaceConfig(project=args.project, cluster=args.cluster,
                          region=args.region, gpu_count=args.gpu_count,
                          gpu_machine_type=f"a3-highgpu-{args.gpu_count}g")
    ws = WorkspaceSetup(cfg, dry_run=args.dry_run)
    report = ws.setup()
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
