"""The port's data-parallel arithmetic against the JAX package's functions.

No process group here (the multi-rank runs are ``tests/test_torch_ddp.py``
and its siblings): ``global_batch_size``, ``scale_lr_for_world``,
``MeshSpec.resolve`` and its error, the ZeRO placement rule
(``zero_spec_for``), the loader's and the latent cache's rank shards
against ``ldm3d_tpu.data``'s ``BatchLoader(num_hosts, host_id)`` and
``LatentCache.build(num_hosts, host_id)`` batches, and the launcher's
failure paths (a rank's exception, a hung rank, ``-g`` beyond the visible
GPUs, ``--multihost`` without torchrun's environment, and torchrun's
environment without ``--multihost``).
"""

import os
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dp_ranks as ranks

from ldm3d_torch.cli.common import build_parser, global_batch_size, launch_data_parallel
from ldm3d_torch.data.latent_cache import LatentCache
from ldm3d_torch.data.loader import BatchLoader
from ldm3d_torch.parallel import DataParallel, MeshSpec, dp_sample_placer, shard_batch
from ldm3d_torch.parallel.launch import RankPool
from ldm3d_torch.parallel.zero import zero_spec_for
from ldm3d_torch.training import scale_lr_for_world

torch.set_num_threads(1)


@pytest.mark.parametrize("per_device,world", [(1, 1), (2, 2), (3, 4), (5, 8)])
def test_global_batch_size_matches_jax(per_device, world):
    from ldm3d_tpu.cli.common import global_batch_size as jax_global_batch_size

    mesh = SimpleNamespace(shape={"data": world})
    assert global_batch_size(per_device, world) == jax_global_batch_size(per_device, mesh)


@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_scale_lr_for_world_matches_jax(world):
    from ldm3d_tpu.training.lr_schedules import scale_lr_for_world as jax_scale

    assert scale_lr_for_world(2.5e-5, world) == jax_scale(2.5e-5, world)


@pytest.mark.parametrize("spec,n", [((-1, 1, 1, 1), 8), ((2, 2, 1, 1), 4), ((-1, 2, 2, 1), 8),
                                    ((3, 1, 1, 1), 4), ((-1, 3, 1, 1), 8)])
def test_mesh_spec_resolve_matches_jax(spec, n):
    from ldm3d_tpu.parallel import MeshSpec as JaxMeshSpec

    try:
        want = JaxMeshSpec(*spec).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{str(e)}$"):
            MeshSpec(*spec).resolve(n)
    else:
        assert MeshSpec(*spec).resolve(n) == want


SHAPES = [(3, 3, 3, 4, 8), (8,), (2,), (4, 4), (7, 14), (64, 32, 3, 3, 3), (1, 1, 1), (6, 9, 12)]


@pytest.mark.parametrize("data", [2, 3, 4])
def test_zero_placement_rule_matches_jax(data):
    from ldm3d_tpu.parallel import zero_spec_for as jax_zero_spec_for

    for shape in SHAPES:
        spec = list(jax_zero_spec_for(np.zeros(shape, np.float32), data))
        want = spec.index("data") if "data" in spec else None
        assert zero_spec_for(shape, data) == want, shape


class _Dataset:
    """Samples whose values name their index (stacked as the loaders stack)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((2,), i, np.float32), "label": np.full((1,), -i, np.float32)}


@pytest.mark.parametrize("n,batch,hosts,kw", [
    (10, 4, 2, dict(shuffle=True, drop_last=True)),
    (13, 6, 3, dict(shuffle=True, drop_last=True)),
    (7, 4, 2, dict(shuffle=False, pad_partial=True)),
    (9, 2, 1, dict(shuffle=True, drop_last=True))])
def test_loader_rank_shards_match_jax_hosts(n, batch, hosts, kw):
    """Each rank's batches are JAX's host ``host_id``'s, epoch by epoch; end
    to end they are JAX's global batches."""
    from ldm3d_tpu.data.loader import BatchLoader as JaxBatchLoader

    for host in range(hosts):
        mine = BatchLoader(_Dataset(n), batch, seed=3, num_hosts=hosts, host_id=host, **kw)
        theirs = JaxBatchLoader(_Dataset(n), batch, seed=3, num_hosts=hosts, host_id=host, **kw)
        assert mine.batch_size == theirs.batch_size == batch // hosts
        assert mine.steps_per_epoch() == theirs.steps_per_epoch()
        for epoch in range(3):
            a, b = list(mine.epoch(epoch)), list(theirs.epoch(epoch))
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.keys() == y.keys()
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])


def test_loader_refuses_a_batch_the_ranks_do_not_divide():
    from ldm3d_tpu.data.loader import BatchLoader as JaxBatchLoader

    with pytest.raises(ValueError) as theirs:
        JaxBatchLoader(_Dataset(8), 5, num_hosts=2, host_id=0)
    with pytest.raises(ValueError, match=f"^{theirs.value}$"):
        BatchLoader(_Dataset(8), 5, num_hosts=2, host_id=0)


def test_latent_cache_rank_shards_match_jax_hosts():
    """A stand-in encoder (mu = 2x, sigma = |x| + 1 over the first channel),
    the same in both frameworks: each rank caches JAX host ``host_id``'s
    contiguous shard and yields its epochs."""
    import flax.linen as nn

    from ldm3d_tpu.data.latent_cache import LatentCache as JaxLatentCache

    class JaxEnc(nn.Module):
        dtype: jnp.dtype = jnp.float32

        def encode(self, x):
            return 2.0 * x[..., :1], jnp.abs(x[..., :1]) + 1.0

        def __call__(self, x):
            return self.encode(x)

    class TorchEnc(torch.nn.Module):
        def encode(self, x):
            return 2.0 * x[..., :1], x[..., :1].abs() + 1.0

    rng = np.random.default_rng(0)
    data = [{"image": rng.uniform(0, 1, (2, 2, 2, 1)).astype(np.float32),
             "label": rng.uniform(0, 1, (2, 2, 2, 1)).astype(np.float32)} for _ in range(9)]
    for host in range(3):
        theirs = JaxLatentCache.build(JaxEnc(), {}, data, 3, seed=4, num_hosts=3, host_id=host)
        mine = LatentCache.build(TorchEnc(), data, 3, "cpu", seed=4, num_hosts=3, host_id=host)
        assert len(mine) == len(theirs) == 3 and mine.batch_size == theirs.batch_size == 1
        for epoch in range(2):
            for x, y in zip(mine.epoch(epoch), theirs.epoch(epoch), strict=True):
                for k in x:
                    np.testing.assert_allclose(x[k], y[k], rtol=1e-6)


def test_shard_batch_and_the_sample_placer():
    dp = DataParallel(world=2, rank=1)
    x = np.arange(8).reshape(4, 2)
    np.testing.assert_array_equal(shard_batch({"x": x}, dp)["x"], x[2:])
    with pytest.raises(ValueError, match="^global batch 3 not divisible by data axis 2$"):
        dp.shard(np.zeros(3))
    place, n = dp_sample_placer(4, dp)
    assert n == 2 and np.array_equal(place(x), x[2:])
    place, n = dp_sample_placer(3, dp)  # not divisible: every rank samples the whole batch
    assert n == 1 and place(x) is x
    assert dp_sample_placer(4)[1] == 1  # no process group


def test_rank_pool_raises_a_ranks_error_and_kills_a_hung_pool():
    with RankPool(2, threads=1, timeout_s=20) as pool:
        assert pool.run(sum, [1, 2]) == [3, 3]
        with pytest.raises(KeyError, match="rank one"):
            pool.run(ranks.raise_on_rank_one)
        assert not any(p.is_alive() for p in pool._procs)
    with RankPool(2, threads=1, timeout_s=3) as pool:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="every rank was killed"):
            pool.run(ranks.sleep, 60)
        assert time.monotonic() - t0 < 20 and not any(p.is_alive() for p in pool._procs)


def test_launch_refuses_more_cards_than_visible_and_multihost_without_torchrun(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    args = build_parser("x").parse_args(["-g", "2"])  # --device cuda, no card here
    with pytest.raises(ValueError, match=f"^requested 2 devices, only "
                                         f"{torch.cuda.device_count()} visible$"):
        launch_data_parallel(args, None, [])
    args = build_parser("x").parse_args(["--multihost", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="--multihost needs torchrun's environment"):
        launch_data_parallel(args, None, [])
    assert launch_data_parallel(build_parser("x").parse_args(["--device", "cpu"]), None,
                                []) == (False, None)


def test_torchrun_environment_without_multihost_raises(monkeypatch):
    """A process group is joined only when ``--multihost`` asks, as in JAX:
    torchrun's variables alone (a stray scheduler's, say) raise with a hint."""
    for var, value in (("RANK", "0"), ("WORLD_SIZE", "2"), ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", "1")):
        monkeypatch.setenv(var, value)
    for argv in (["--device", "cpu"], ["-g", "2", "--device", "cpu"]):
        with pytest.raises(RuntimeError, match="but --multihost is not: pass --multihost"):
            launch_data_parallel(build_parser("x").parse_args(argv), None, [])
    assert not torch.distributed.is_initialized()


def test_ranks_never_load_a_half_written_kernel_library(tmp_path, monkeypatch):
    """Ranks that build the same kernel library at once each compile into a
    file named by their process id and swap it in whole (``os.replace``), so
    a rank that loads ``build/ldm3d_torch/lib*.so`` finds a complete library
    or none: nvcc never writes the final path."""
    from ldm3d_torch.ops import _kernels

    from pathlib import Path

    outputs = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            outputs.append(out)
            Path(out).write_bytes(b"library")
            self.returncode = 0

        def communicate(self):
            return "ptxas info", ""

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_kernels.subprocess, "Popen", FakeNvcc)
    (lib,) = _kernels.build_libraries(["groupnorm_sums.cu"])
    assert outputs and all(o != str(lib) and o.endswith(f".{os.getpid()}.tmp") for o in outputs)
    assert lib.read_bytes() == b"library" and not list(tmp_path.glob("*.tmp"))
    assert _kernels.build_libraries(["groupnorm_sums.cu"]) == [lib] and len(outputs) == 1
