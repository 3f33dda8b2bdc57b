"""Card twins of ``chip_smoke.py``'s parallel phase, at the micro preset.

``cuda``-marked: each needs a GPU and skips without one (the checks run on
the CPU in ``tests/test_torch_ddp.py`` and its siblings). Two ranks of the
port's launcher time-share ``cuda:0`` over gloo with CUDA tensors; the FSDP
check runs in the test process, a NCCL group of one. The rank functions are
``tools/dp_check.py``'s; the limits are the phase's: the ranks' mean
gradient within 5e-5 of the one-process gradient's largest |g|, every faulty
program's gradients at least 100 times that, ZeRO-1's update within 1e-2 of
the plain data-parallel step's largest |update| and a ZeRO-1 without its
gather at least 0.5 from it. No JAX here (the card's machine has none):
``python -m pytest --noconftest -q -m cuda tests/test_torch_dp_card.py``.
"""

import os
import sys

import pytest
import torch

from ldm3d_torch.parallel.launch import RankPool, group_of_one

sys.path.append(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "tools"))
import dp_check as D  # noqa: E402

PRESET = "config_micro_cpu.json"
TOL = 5e-5
ZERO_TOL, ZERO_FAULT_FLOOR = 1e-2, 0.5


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks run the port's CUDA kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [2, 1])
def test_two_ranks_on_one_card_average_the_one_process_gradient(stage):
    _needs_card()
    with RankPool(2, devices=["cuda:0", "cuda:0"], backend="gloo", timeout_s=300) as pool:
        res = pool.run(D.grads_check, PRESET, stage, 2, ae_patch=16)
    for r in res:
        assert r["ddp"] <= TOL, r
        assert all(r[fault] >= 100 * TOL for fault in D.FAULTS), r


@pytest.mark.cuda
def test_zero_step_on_one_card_matches_the_data_parallel_step():
    _needs_card()
    with RankPool(2, devices=["cuda:0", "cuda:0"], backend="gloo", timeout_s=300) as pool:
        res = pool.run(D.grads_check, PRESET, 2, 2, faults=False, zero=True)
    assert max(r["zero"] for r in res) <= ZERO_TOL and max(r["ddp"] for r in res) <= TOL
    assert min(r["zero_no_gather"] for r in res) >= ZERO_FAULT_FLOOR


@pytest.mark.cuda
def test_fsdp_on_one_rank_launches_the_unwrapped_kernels_and_checkpoints_bit_equal(tmp_path):
    _needs_card()
    with group_of_one("nccl"):
        res = D.fsdp_world1(PRESET, 2, str(tmp_path))
    assert res["checkpoint_bit_equal"] and res["sharded_params"] > 0
    assert res["plain_counts"] == res["fsdp_counts"]
    assert res["plain_counts"]["gn_sums"]["launches"] > 0
