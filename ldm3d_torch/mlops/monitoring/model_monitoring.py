"""Model monitoring: data drift (KS test + PSI) and performance thresholds.

The port of ``ldm3d_tpu/mlops/monitoring/model_monitoring.py`` (reference
``mlops/monitoring/model_monitoring.py``): per-feature drift by the
two-sample Kolmogorov-Smirnov test and the Population Stability Index with
severity bands (:244-305), performance threshold checks with alerts
(:163-221), an alert hook (:355) and JSON reports (:363), on numpy alone.

The port imports no scipy, so its KS test is the JAX module's numpy path
(the JAX module takes it when scipy is missing): the statistic is
``scipy.stats.ks_2samp``'s, the p-value the asymptotic
``2 exp(-2 n d^2)`` with ``n = n1 n2 / (n1 + n2)``, clipped to 1.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np

__all__ = ["DriftDetector", "ModelMonitoring"]


class DriftDetector:
    """KS + PSI drift detection between a reference and a current sample."""

    def __init__(self, psi_bins: int = 10, ks_alpha: float = 0.05):
        self.psi_bins = psi_bins
        self.ks_alpha = ks_alpha

    @staticmethod
    def _ks(reference: np.ndarray, current: np.ndarray) -> tuple[float, float]:
        a = np.sort(reference)
        b = np.sort(current)
        grid = np.concatenate([a, b])
        cdf_a = np.searchsorted(a, grid, side="right") / len(a)
        cdf_b = np.searchsorted(b, grid, side="right") / len(b)
        d = float(np.max(np.abs(cdf_a - cdf_b)))
        n = len(a) * len(b) / (len(a) + len(b))
        p = float(2 * np.exp(-2 * n * d * d))
        return d, min(1.0, p)

    def psi(self, reference: np.ndarray, current: np.ndarray) -> float:
        """Population Stability Index over quantile bins of the reference."""
        edges = np.quantile(reference, np.linspace(0, 1, self.psi_bins + 1))
        edges[0], edges[-1] = -np.inf, np.inf
        ref_frac = np.histogram(reference, edges)[0] / max(len(reference), 1)
        cur_frac = np.histogram(current, edges)[0] / max(len(current), 1)
        ref_frac = np.clip(ref_frac, 1e-6, None)
        cur_frac = np.clip(cur_frac, 1e-6, None)
        return float(np.sum((cur_frac - ref_frac) * np.log(cur_frac / ref_frac)))

    @staticmethod
    def severity(psi: float) -> str:
        """Reference severity bands: <0.1 none, <0.2 moderate, else severe."""
        if psi < 0.1:
            return "none"
        if psi < 0.2:
            return "moderate"
        return "severe"

    def check_feature(self, name: str, reference: np.ndarray, current: np.ndarray) -> dict:
        ks_stat, p_value = self._ks(np.ravel(reference), np.ravel(current))
        psi = self.psi(np.ravel(reference), np.ravel(current))
        return {
            "feature": name,
            "ks_statistic": ks_stat,
            "ks_pvalue": p_value,
            "ks_drift": p_value < self.ks_alpha,
            "psi": psi,
            "psi_severity": self.severity(psi),
        }


class ModelMonitoring:
    def __init__(self, report_dir: str = "./monitoring_reports",
                 thresholds: Optional[dict] = None,
                 alert_fn: Optional[Callable[[str, dict], None]] = None):
        self.report_dir = report_dir
        # parity with the reference's alert thresholds (latency 10s etc.)
        self.thresholds = {"max_latency_ms": 10_000.0, "max_error_rate": 0.05,
                           "min_throughput_rps": 0.0, **(thresholds or {})}
        self.alert_fn = alert_fn or (lambda kind, payload: None)
        self.detector = DriftDetector()
        os.makedirs(report_dir, exist_ok=True)

    def check_data_drift(self, reference: dict[str, np.ndarray],
                         current: dict[str, np.ndarray]) -> dict:
        results = [self.detector.check_feature(k, reference[k], current[k])
                   for k in reference if k in current]
        drifted = [r for r in results if r["ks_drift"] or r["psi_severity"] != "none"]
        report = {"timestamp": time.time(), "features": results,
                  "num_drifted": len(drifted), "drift_detected": bool(drifted)}
        if drifted:
            self.alert_fn("data_drift", report)
        return report

    def check_performance(self, metrics: dict) -> dict:
        """Threshold checks on real serving metrics (latency/error rate/rps)."""
        alerts = []
        lat = metrics.get("latency_ms")
        if lat is not None and lat > self.thresholds["max_latency_ms"]:
            alerts.append(f"latency {lat:.0f}ms > {self.thresholds['max_latency_ms']:.0f}ms")
        err = metrics.get("error_rate")
        if err is not None and err > self.thresholds["max_error_rate"]:
            alerts.append(f"error rate {err:.3f} > {self.thresholds['max_error_rate']}")
        rps = metrics.get("throughput_rps")
        if rps is not None and rps < self.thresholds["min_throughput_rps"]:
            alerts.append(f"throughput {rps:.2f} rps below minimum")
        report = {"timestamp": time.time(), "metrics": metrics, "alerts": alerts,
                  "healthy": not alerts}
        if alerts:
            self.alert_fn("performance", report)
        return report

    def generate_report(self, drift_report: Optional[dict] = None,
                        perf_report: Optional[dict] = None) -> str:
        report = {"generated_at": time.time(), "drift": drift_report, "performance": perf_report}
        path = os.path.join(self.report_dir, f"monitoring_{int(time.time())}.json")
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
        return path
