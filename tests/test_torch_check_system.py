"""The port's system advisor (``cli.check_system``) against the JAX one.

At 8, 16, 32 and 80 GiB a card, the recommendation has the JAX report's
keys and its tier: preset, batch, patch, amp and ``data_axis``. The remat
choice follows the port's own peak-memory model (calibrated on the H100),
and the written config is the JAX tool's for the same recommendation.
"""

import json

import pytest
import torch

from ldm3d_torch.cli import check_system as port
from ldm3d_tpu.cli import check_system as jax_cs

torch.set_num_threads(1)

TIER_KEYS = ("preset", "batch_size", "patch_size", "amp", "data_axis")


def _device(gib: int, n: int = 1) -> dict:
    return {"available": True, "platform": "gpu", "device_kind": "NVIDIA test card",
            "num_devices": n, "num_hosts": 1, "per_chip_hbm_bytes": gib * 2**30}


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("gib", [8, 16, 32, 80])
def test_recommendation_is_the_jax_tier(gib, n):
    dev = _device(gib, n)
    got, want = port.recommend_settings(dev, {}), jax_cs.recommend_settings(dev, {})
    assert set(got) == set(want)
    for key in TIER_KEYS:
        assert got[key] == want[key], key
    # the remat choice and the headroom follow the port's model
    no_remat = port.estimate_stage1_peak_bytes(got["batch_size"], got["patch_size"], False)
    fits = 1 - no_remat / dev["per_chip_hbm_bytes"] >= port._MIN_HEADROOM
    assert got["remat"] == (False if fits else "convs")
    peak = port.estimate_stage1_peak_bytes(got["batch_size"], got["patch_size"], got["remat"])
    assert got["estimated_peak_hbm_gb"] == round(peak / 2**30, 2)
    assert got["hbm_headroom_frac"] == round(1 - peak / dev["per_chip_hbm_bytes"], 3)
    assert "H100" in got["headroom_basis"]
    assert not any(word in " ".join(got["notes"]) for word in ("TPU", "MXU", "sublane", "v5e"))


def test_peak_model_is_calibrated_and_monotone():
    base = port.estimate_stage1_peak_bytes(2, [96] * 3, False)
    assert port._STAGE1_STATE_BYTES > 0 and port._STAGE1_ACT_BYTES_PER_VOXEL > 0
    assert port.estimate_stage1_peak_bytes(4, [96] * 3, False) > base
    assert port.estimate_stage1_peak_bytes(2, [112] * 3, False) > base
    full = port.estimate_stage1_peak_bytes(2, [96] * 3, "full")
    convs = port.estimate_stage1_peak_bytes(2, [96] * 3, "convs")
    assert full < base and convs < base
    assert port.estimate_stage1_peak_bytes(2, [96] * 3, True) == full
    assert len(port.CALIBRATION) >= 2


def test_small_card_takes_remat_convs_as_jax_does():
    """At 16 GiB the model leaves too little headroom for batch 8 @64^3
    unremated, so the port advises ``--remat convs``, as the JAX tool does."""
    dev = _device(16)
    got, want = port.recommend_settings(dev, {}), jax_cs.recommend_settings(dev, {})
    assert got["remat"] == want["remat"] == "convs"
    no_remat = port.estimate_stage1_peak_bytes(8, [64] * 3, False)
    assert 1 - no_remat / dev["per_chip_hbm_bytes"] < port._MIN_HEADROOM
    assert got["hbm_headroom_frac"] >= port._MIN_HEADROOM


def test_no_accelerator_falls_back_to_the_cpu_preset():
    got = port.recommend_settings({"available": False}, {"cpu_count": 4})
    want = jax_cs.recommend_settings({"available": False}, {"cpu_count": 4})
    assert {k: v for k, v in got.items() if k != "notes"} == \
        {k: v for k, v in want.items() if k != "notes"}


def test_probes_have_the_jax_keys():
    host, want = port.probe_host(), jax_cs.probe_host()
    assert set(host) == set(want)
    assert host["cpu_count"] >= 1 and host["ram_gb"] > 0 and host["disk_free_gb"] >= 0
    assert host["ram_gb"] == want["ram_gb"]
    dev = port.probe_devices()
    if torch.cuda.is_available():
        assert dev["platform"] == "gpu" and dev["per_chip_hbm_bytes"] > 0
    else:
        assert dev == {"available": False, "error": "no CUDA device is available"}


@pytest.mark.parametrize("gib", [8, 16, 80])
def test_config_file_is_the_jax_tools(tmp_path, gib):
    rec = port.recommend_settings(_device(gib), {})
    port.generate_config_file(rec, str(tmp_path / "port.json"))
    jax_cs.generate_config_file(rec, str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())


def test_launch_command_names_the_port():
    for remat, flag in ((False, ""), ("convs", " --remat convs"), ("full", " --remat")):
        rec = {"output": "c.json", "amp": True, "remat": remat}
        got = port.generate_launch_command(rec)
        assert got == jax_cs.generate_launch_command(rec).replace("ldm3d_tpu", "ldm3d_torch")
        assert got == f"python -m ldm3d_torch.cli.train_autoencoder -c c.json " \
                      f"-e environment.json --amp{flag}"


def test_main_writes_config_and_prints_json(tmp_path, capsys):
    out = tmp_path / "config_optimized.json"
    report = port.main(["--output", str(out), "--json"])
    cfg = json.loads(out.read_text())
    assert cfg["autoencoder_train"]["batch_size"] == report["recommendation"]["batch_size"]
    assert set(report) == {"devices", "host", "recommendation", "launch_command"}
    printed = json.loads(capsys.readouterr().out)
    assert printed["recommendation"]["preset"] == report["recommendation"]["preset"]
    assert "ldm3d_torch.cli.train_autoencoder" in report["launch_command"]
