"""Model deployment: render and apply serving manifests with traffic splits.

The port of ``ldm3d_tpu/mlops/deployment/deploy_model.py`` (reference
``mlops/deployment/deploy_model.py``: register model, create the endpoint
and deployment with probes and a traffic split, :191-247), for Kubernetes:
renders Deployment/Service manifests for a model version from the registry,
supports blue/green traffic percentages, and (with ``kubectl``) applies them
and waits for the rollout. The container runs the port's server
(``python -m ldm3d_torch.serving.api_server``) on one NVIDIA GPU
(``nvidia.com/gpu: 1``). Manifests are written as JSON, which is YAML
(the port imports no YAML library), under ``.yaml`` names for ``kubectl``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
from typing import Optional

log = logging.getLogger("deploy_model")

__all__ = ["ModelDeployment", "DeployError", "main"]

_DEPLOYMENT_TMPL = {
    "apiVersion": "apps/v1",
    "kind": "Deployment",
    "metadata": {"name": "", "namespace": "ldm3d", "labels": {}},
    "spec": {
        "replicas": 2,
        "selector": {"matchLabels": {}},
        "template": {
            "metadata": {"labels": {}, "annotations": {
                "prometheus.io/scrape": "true", "prometheus.io/port": "8000",
                "prometheus.io/path": "/metrics"}},
            "spec": {
                "containers": [{
                    "name": "model-server",
                    "image": "",
                    "args": ["python", "-m", "ldm3d_torch.serving.api_server", "--port", "8000"],
                    "ports": [{"containerPort": 8000}],
                    "env": [],
                    "readinessProbe": {"httpGet": {"path": "/health", "port": 8000},
                                       "initialDelaySeconds": 30, "periodSeconds": 10},
                    "livenessProbe": {"httpGet": {"path": "/health", "port": 8000},
                                      "initialDelaySeconds": 60, "periodSeconds": 30},
                    "startupProbe": {"httpGet": {"path": "/health", "port": 8000},
                                     "failureThreshold": 30, "periodSeconds": 10},
                    "resources": {"limits": {"nvidia.com/gpu": "1"},
                                  "requests": {"cpu": "4", "memory": "16Gi"}},
                }],
                "nodeSelector": {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"},
            },
        },
    },
}


class DeployError(RuntimeError):
    """kubectl apply/rollout failed (or kubectl is unavailable)."""


class ModelDeployment:
    def __init__(self, registry=None, namespace: str = "ldm3d", out_dir: str = "./deploy_out",
                 kubectl: str = "kubectl"):
        """``kubectl``: binary used for apply/rollout — injectable so tests
        drive the live path against a fake executable."""
        self.registry = registry
        self.namespace = namespace
        self.out_dir = out_dir
        self.kubectl = kubectl
        os.makedirs(out_dir, exist_ok=True)

    def render(self, name: str, version: int, image: str, traffic_percent: int = 100,
               model_dir: Optional[str] = None, replicas: int = 2) -> dict:
        import copy

        manifest = copy.deepcopy(_DEPLOYMENT_TMPL)
        dep_name = f"{name}-v{version}"
        labels = {"app": name, "version": str(version)}
        manifest["metadata"].update({"name": dep_name, "namespace": self.namespace, "labels": labels})
        manifest["spec"]["replicas"] = replicas
        manifest["spec"]["selector"]["matchLabels"] = labels
        tmpl = manifest["spec"]["template"]
        tmpl["metadata"]["labels"] = labels
        container = tmpl["spec"]["containers"][0]
        container["image"] = image
        if model_dir:
            container["env"].append({"name": "MODEL_DIR", "value": model_dir})
        # Traffic routing that actually routes: plain Services can't split by
        # percentage (kube-proxy balances across whatever the selector
        # matches), so traffic_percent=100 pins the Service selector to THIS
        # version — a blue/green flip. Partial splits keep the selector on
        # the app (all versions) and scale this version's replica share to
        # approximate the split, recording the request in the annotation; a
        # mesh/ingress controller can consume the annotation for exact
        # weighting. Silently annotating while routing 50/50 (the previous
        # behavior) advertised a split that never happened.
        selector = dict(labels) if traffic_percent >= 100 else {"app": name}
        if 0 < traffic_percent < 100:
            manifest["spec"]["replicas"] = max(1, round(replicas * traffic_percent / 100))
        elif traffic_percent <= 0:
            manifest["spec"]["replicas"] = 0  # staged but serving nothing
        service = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name, "namespace": self.namespace,
                         "annotations": {"traffic-split": json.dumps({dep_name: traffic_percent})}},
            "spec": {"selector": selector, "ports": [{"port": 80, "targetPort": 8000}]},
        }
        return {"deployment": manifest, "service": service}

    def write_manifests(self, rendered: dict, stem: str) -> list[str]:
        paths = []
        for kind, manifest in rendered.items():
            p = os.path.join(self.out_dir, f"{stem}_{kind}.yaml")
            with open(p, "w") as f:
                json.dump(manifest, f, indent=2)  # JSON is YAML
                f.write("\n")
            paths.append(p)
        return paths

    def _kubectl(self, *argv: str, timeout: float = 600.0) -> str:
        cmd = [self.kubectl, *argv]
        try:
            out = subprocess.run(cmd, check=True, capture_output=True, text=True,
                                 timeout=timeout)
        except FileNotFoundError as e:
            raise DeployError(f"kubectl not found ({self.kubectl!r})") from e
        except subprocess.CalledProcessError as e:
            raise DeployError(f"{' '.join(cmd)} failed: {e.stderr or e.stdout}") from e
        except subprocess.TimeoutExpired as e:
            raise DeployError(f"{' '.join(cmd)} timed out after {timeout}s") from e
        return out.stdout

    def apply(self, paths: list[str], deployment_name: str,
              rollout_timeout: float = 600.0) -> None:
        """Apply rendered manifests and block until the Deployment rolls out.

        The live analog of the reference's end-to-end deployer — it creates
        the endpoint/deployment and waits for provisioning
        (``mlops/deployment/deploy_model.py:191-247``) rather than stopping at
        manifest generation. Raises :class:`DeployError` on any failure, so
        CI/pipelines gate on a *running* model server, not a rendered file."""
        for p in paths:
            log.info("kubectl apply -f %s", p)
            self._kubectl("apply", "-f", p)
        log.info("waiting for rollout of deployment/%s", deployment_name)
        self._kubectl("rollout", "status", f"deployment/{deployment_name}",
                      "-n", self.namespace, f"--timeout={int(rollout_timeout)}s",
                      timeout=rollout_timeout + 30.0)

    def deploy(self, name: str, image: str, stage: str = "Production",
               traffic_percent: int = 100, apply: bool = False,
               rollout_timeout: float = 600.0) -> dict:
        """Render (and optionally live-apply) a model-version deployment.

        With ``apply=True`` the manifests are pushed with kubectl and the call
        blocks until rollout completes; missing kubectl is an error — a
        requested live deploy must never silently degrade to render-only."""
        entry = self.registry.get(name, stage) if self.registry else None
        if self.registry is not None and entry is None:
            # a registry-backed deploy of a stage with no model must FAIL, not
            # quietly ship a v1 Deployment with no MODEL_DIR (promote a
            # version to the stage first, or deploy without --registry-dir)
            raise DeployError(f"no model named {name!r} at stage {stage!r} in the registry")
        version = entry["version"] if entry else 1
        model_dir = entry["checkpoint_dir"] if entry else None
        rendered = self.render(name, version, image, traffic_percent, model_dir)
        paths = self.write_manifests(rendered, f"{name}_v{version}")
        applied = False
        if apply:
            if not (os.path.sep in self.kubectl or shutil.which(self.kubectl)):
                raise DeployError(f"--apply requested but {self.kubectl!r} is not on PATH")
            self.apply(paths, f"{name}-v{version}", rollout_timeout)
            applied = True
        return {"version": version, "manifests": paths, "applied": applied}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="render/apply model-serving deployment manifests")
    p.add_argument("--name", default="ldm3d-server")
    p.add_argument("--image", required=True, help="container image for the model server")
    p.add_argument("--stage", default="Production", help="registry stage to deploy")
    p.add_argument("--traffic", type=int, default=100, help="traffic percent for this version")
    p.add_argument("--namespace", default="ldm3d")
    p.add_argument("--out-dir", default="./deploy_out")
    p.add_argument("--apply", action="store_true",
                   help="kubectl-apply the manifests and wait for rollout")
    p.add_argument("--rollout-timeout", type=float, default=600.0)
    p.add_argument("--registry-dir", default=None,
                   help="model registry root (ldm3d_torch.mlops.tracking)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    registry = None
    if args.registry_dir:
        from ldm3d_torch.mlops.tracking import ModelRegistry

        registry = ModelRegistry(args.registry_dir)
    dep = ModelDeployment(registry, namespace=args.namespace, out_dir=args.out_dir)
    result = dep.deploy(args.name, args.image, args.stage, args.traffic,
                        apply=args.apply, rollout_timeout=args.rollout_timeout)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
