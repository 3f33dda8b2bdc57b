"""Batch-scoring entry points with the Azure-ML ``init()``/``run()`` contract.

The port of ``ldm3d_tpu/serving/score.py``: ``init()`` loads the model once
per worker from ``LDM_CONFIG_FILE`` / ``LDM_ENVIRONMENT_FILE`` (sampler
``LDM_SAMPLER``, steps ``LDM_STEPS``, device ``LDM_DEVICE``, default cuda);
``run(raw_data)`` takes a JSON string ``{"num_samples": N, "seed": S}`` and
returns a JSON string with base64 float32 volumes, or ``{"error": ...}``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

from ldm3d_torch.serving.model_server import ModelServer

log = logging.getLogger("score")

_server: Optional[ModelServer] = None


def init() -> None:
    """Load the model once (the scoring host calls this at worker start)."""
    global _server
    _server = ModelServer(os.environ.get("LDM_CONFIG_FILE"),
                          os.environ.get("LDM_ENVIRONMENT_FILE"),
                          os.environ.get("LDM_SAMPLER", "ddim"),
                          int(os.environ.get("LDM_STEPS", "50")),
                          device=os.environ.get("LDM_DEVICE", "cuda"))
    _server.load_model()
    log.info("score init complete (dummy=%s)", _server.is_dummy)


def run(raw_data: str) -> str:
    """Score one request; returns JSON."""
    if _server is None:
        return json.dumps({"error": "init() was not called"})
    try:
        payload = json.loads(raw_data) if raw_data else {}
    except json.JSONDecodeError as e:
        return json.dumps({"error": f"invalid JSON: {e}"})
    try:
        num = int(payload.get("num_samples", 1))
        result = _server.generate(num_samples=num, seed=payload.get("seed"))
        return json.dumps(result)
    except Exception as e:  # scoring must not crash the worker
        log.exception("generation failed")
        return json.dumps({"error": str(e)})


def test_local() -> dict:
    """Local smoke test of the init/run contract."""
    init()
    out = json.loads(run(json.dumps({"num_samples": 1, "seed": 0})))
    assert "samples" in out or "error" in out
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    print(json.dumps({k: v for k, v in test_local().items() if k != "samples"}))
