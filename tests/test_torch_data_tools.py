"""The port's data tools against the JAX package's, on the CPU.

``cli.prepare_data`` (``prepare``, ``load_volume``, ``fit_to_shape``,
``list_pairs``), ``obs.visualize.normalize_image_to_uint8``,
``data.transforms.scale_intensity_percentiles`` and the native NPZ loader
(``data.native_loader`` over ``csrc/npz_loader.cpp``, and the dataset's
``use_native`` path with its load counter) are held to their JAX
counterparts: file and array outputs bit-equal, the percentile scaling
within 1e-6.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm3d_torch.cli import prepare_data as port_prep
from ldm3d_torch.data import native_loader as port_native
from ldm3d_torch.data import npz_dataset as port_ds
from ldm3d_torch.data.transforms import scale_intensity_percentiles as port_scale
from ldm3d_torch.obs import normalize_image_to_uint8 as port_u8
from ldm3d_tpu.cli import prepare_data as jax_prep
from ldm3d_tpu.data import native_loader as jax_native
from ldm3d_tpu.data.npz_dataset import NPZPairDataset as JaxDataset
from ldm3d_tpu.data.transforms import scale_intensity_percentiles as jax_scale
from ldm3d_tpu.obs.visualize import normalize_image_to_uint8 as jax_u8
from ldm3d_tpu.utils.nifti import write_nifti

torch.set_num_threads(1)

SCALE_TOL = 1e-6


@pytest.fixture(autouse=True)
def _no_nibabel(monkeypatch):
    """JAX's ``load_volume`` tries nibabel first; both packages then read
    NIfTI with their own ``read_nifti``."""
    monkeypatch.setitem(sys.modules, "nibabel", None)


def _volume_dirs(root, rng):
    """Ragged low/high volumes in every format, one unpaired stem each side."""
    low, high = root / "low", root / "high"
    low.mkdir()
    high.mkdir()
    shapes = {"a": (20, 18, 22), "b": (16, 16, 16), "c": (14, 24, 19), "d": (18, 18, 12),
              "e": (17, 15, 16)}
    writers = {"a": "npy", "b": "npz", "c": "nii", "d": "nii.gz", "e": "npz_arr_0"}
    for stem, shape in shapes.items():
        for d in (low, high):
            vol = (rng.standard_normal(shape) * 100 + 20).astype(np.float32)
            kind = writers[stem]
            if kind == "npy":
                np.save(d / f"{stem}.npy", vol[None])  # a singleton channel, squeezed
            elif kind == "npz":
                np.savez(d / f"{stem}.npz", arr0=vol)
            elif kind == "npz_arr_0":
                np.savez(d / f"{stem}.npz", vol.astype(np.float64))
            else:
                write_nifti(str(d / f"{stem}.{kind}"), vol)
    np.save(low / "only_low.npy", np.zeros((4, 4, 4), np.float32))
    np.save(high / "only_high.npy", np.zeros((4, 4, 4), np.float32))
    return str(low), str(high)


@pytest.mark.parametrize("shape, val_fraction, seed", [((16, 16, 16), 0.4, 0),
                                                       ((12, 20, 16), 0.2, 3),
                                                       (None, 0.0, 1)])
def test_prepare_writes_the_jax_dataset(tmp_path, shape, val_fraction, seed):
    rng = np.random.default_rng(7)
    if shape is None:  # no fitting: the pairs must share one shape per pair only
        low, high = tmp_path / "low", tmp_path / "high"
        low.mkdir()
        high.mkdir()
        for stem, s in (("x", (8, 9, 10)), ("y", (11, 7, 6))):
            np.save(low / f"{stem}.npy", rng.standard_normal(s).astype(np.float32))
            np.save(high / f"{stem}.npy", rng.standard_normal(s).astype(np.float32))
        low, high = str(low), str(high)
    else:
        low, high = _volume_dirs(tmp_path, rng)
    out_j, out_p = tmp_path / "jax", tmp_path / "port"
    counts_j = jax_prep.prepare(low, high, str(out_j), shape=shape, val_fraction=val_fraction,
                                seed=seed)
    counts_p = port_prep.prepare(low, high, str(out_p), shape=shape, val_fraction=val_fraction,
                                 seed=seed)
    assert counts_p == counts_j
    for split in ("train", "val"):
        files_j = sorted(os.listdir(out_j / split)) if (out_j / split).exists() else []
        files_p = sorted(os.listdir(out_p / split)) if (out_p / split).exists() else []
        assert files_p == files_j
        for name in files_j:
            with np.load(out_j / split / name) as a, np.load(out_p / split / name) as b:
                assert list(b.keys()) == list(a.keys()) == ["arr0"]
                assert b["arr0"].dtype == a["arr0"].dtype == np.float32
                assert np.array_equal(b["arr0"], a["arr0"])


def test_prepare_main_and_shape_mismatch(tmp_path, capsys):
    rng = np.random.default_rng(0)
    low, high = _volume_dirs(tmp_path, rng)
    counts = port_prep.main(["--low-dir", low, "--high-dir", high, "--out", str(tmp_path / "o"),
                             "--shape", "16", "16", "16", "--val-fraction", "0.2"])
    assert counts == {"train": 4, "val": 1}
    assert "done: {'train': 4, 'val': 1}" in capsys.readouterr().out
    np.save(os.path.join(high, "a.npy"), np.zeros((3, 3, 3), np.float32))
    for prep in (jax_prep, port_prep):
        with pytest.raises(ValueError, match="shape mismatch"):
            prep.prepare(low, high, str(tmp_path / "bad"))


def test_list_pairs_skips_unpaired_stems(tmp_path, caplog):
    low, high = _volume_dirs(tmp_path, np.random.default_rng(1))
    pairs = port_prep.list_pairs(low, high)
    assert pairs == jax_prep.list_pairs(low, high)
    assert [p[0] for p in pairs] == ["a", "b", "c", "d", "e"]
    assert "skipping 2 unpaired volumes" in caplog.text
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        port_prep.list_pairs(low, str(empty))


def test_load_volume_is_jax_in_every_format(tmp_path):
    low, _ = _volume_dirs(tmp_path, np.random.default_rng(2))
    for name in sorted(os.listdir(low)):
        path = os.path.join(low, name)
        a, b = jax_prep.load_volume(path), port_prep.load_volume(path)
        assert b.dtype == a.dtype == np.float32
        assert np.array_equal(b, a), name
    bad = tmp_path / "four_d.npy"
    np.save(bad, np.zeros((2, 3, 4, 5), np.float32))
    for prep in (jax_prep, port_prep):
        with pytest.raises(ValueError, match="expected a 3-D volume"):
            prep.load_volume(str(bad))
        with pytest.raises(ValueError, match="unsupported volume format"):
            prep.load_volume(str(tmp_path / "x.mha"))


@pytest.mark.parametrize("shape, target", [((10, 7, 9), (8, 8, 8)), ((5, 12, 6), (9, 4, 6)),
                                           ((3, 3, 3), (7, 2, 3))])
def test_fit_to_shape_is_jax(shape, target):
    vol = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    a, b = jax_prep.fit_to_shape(vol, target), port_prep.fit_to_shape(vol, target)
    assert b.shape == a.shape == target
    assert np.array_equal(b, a)


@pytest.mark.parametrize("case", ["unit", "negative", "large", "constant"])
def test_normalize_image_to_uint8_is_jax(case):
    rng = np.random.default_rng(4)
    image = {"unit": rng.random((6, 7)), "negative": rng.standard_normal((5, 5, 5)) * 3,
             "large": rng.random((4, 9)) * 900, "constant": np.full((3, 3), -2.0)}[case]
    a, b = jax_u8(image), port_u8(image)
    assert b.dtype == a.dtype == np.uint8
    assert np.array_equal(b, a)


@pytest.mark.parametrize("shape, kwargs", [
    ((2, 17, 13, 11, 1), {}),
    ((3, 8, 8, 8, 2), {"lower": 2.5, "upper": 97.0, "b_min": -1.0, "b_max": 2.0}),
    ((2, 20, 24, 16, 1), {"lower": 1.0, "upper": 99.0}),
    ((1, 9, 10, 11, 1), {"lower": 0.0, "upper": 100.0, "b_min": 0.5, "b_max": 0.75}),
])
def test_scale_intensity_percentiles_is_jax(shape, kwargs):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(shape) * 300 + 50).astype(np.float32)
    x[-1] = 7.0  # a constant volume: the 1e-8 denominator clamp
    want = np.asarray(jax_scale(jnp.asarray(x), **kwargs))
    got = port_scale(torch.from_numpy(x), **kwargs)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert np.abs(got.numpy() - want).max() <= SCALE_TOL


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    """Pair files of every payload the native parser takes."""
    d = tmp_path_factory.mktemp("native_pairs")
    rng = np.random.default_rng(6)
    base = (rng.standard_normal((2, 10, 12, 14)) * 50).astype(np.float32)
    files = {}
    for name, save in {
        "stored_f4": lambda p: np.savez(p, arr0=base),
        "compressed_f4": lambda p: np.savez_compressed(p, arr0=base),
        "arr_0_f8": lambda p: np.savez(p, base.astype(np.float64)),
        "compressed_f8": lambda p: np.savez_compressed(p, arr_0=base.astype(np.float64)),
        "int16": lambda p: np.savez(p, arr0=base.astype(np.int16)),
        "three_vols": lambda p: np.savez(p, arr0=np.concatenate([base, base[:1] + 1])),
    }.items():
        path = str(d / f"{name}.npz")
        save(path)
        files[name] = path
    return files


def _numpy_pair(path):
    with np.load(path) as data:
        key = "arr0" if "arr0" in data else "arr_0"
        arr = data[key]
    return arr[0].astype(np.float32), arr[1].astype(np.float32)


def test_native_library_builds_here():
    assert port_native.available() and jax_native.available()


@pytest.mark.parametrize("name", ["stored_f4", "compressed_f4", "arr_0_f8", "compressed_f8",
                                  "int16", "three_vols"])
def test_native_load_pair_is_jax_and_numpy(pair_files, name):
    path = pair_files[name]
    got = port_native.load_pair(path)
    want = jax_native.load_pair(path)
    ref = _numpy_pair(path)
    assert port_native.pair_dims(path) == jax_native.pair_dims(path) == (2, 10, 12, 14)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == np.float32
        assert np.array_equal(g, w) and np.array_equal(g, r)


def test_native_load_batch_is_jax_and_numpy(pair_files):
    paths = list(pair_files.values())
    got = port_native.load_batch(paths, (10, 12, 14), num_threads=3)
    want = jax_native.load_batch(paths, (10, 12, 14), num_threads=3)
    assert got.shape == (len(paths), 2, 10, 12, 14)
    assert np.array_equal(got, want)
    for i, p in enumerate(paths):
        assert np.array_equal(got[i], np.stack(_numpy_pair(p)))
    assert port_native.load_batch(paths, (10, 12, 15)) is None  # a shape mismatch fails


@pytest.mark.parametrize("malformed", ["fortran", "big_endian", "five_d"])
def test_a_file_the_native_parser_refuses_takes_the_numpy_path(tmp_path, pair_files,
                                                               malformed):
    base = np.load(pair_files["stored_f4"])["arr0"]
    path = str(tmp_path / f"{malformed}.npz")
    arr = {"fortran": np.asfortranarray(base), "big_endian": base.astype(">f4"),
           "five_d": base[..., None]}[malformed]
    np.savez(path, arr0=arr)
    assert port_native.load_pair(path) is None
    before = dict(port_ds.load_counts)
    low, high = port_ds.load_pair(path)
    assert port_ds.load_counts == {"native": before["native"], "numpy": before["numpy"] + 1}
    assert np.array_equal(low, np.asarray(arr[0], np.float32))
    assert np.array_equal(high, np.asarray(arr[1], np.float32))


def test_dataset_reads_natively_as_jax_does(pair_files):
    files = [pair_files[k] for k in ("stored_f4", "compressed_f4", "int16")]
    port_native_ds = port_ds.NPZPairDataset(files, patch_size=[8, 8, 8])
    port_numpy_ds = port_ds.NPZPairDataset(files, patch_size=[8, 8, 8], use_native=False)
    jax_ds = JaxDataset(files, patch_size=[8, 8, 8], use_native=True)
    before = dict(port_ds.load_counts)
    for i in range(len(files)):
        a, b, c = port_native_ds[i], port_numpy_ds[i], jax_ds[i]
        for key in ("image", "label"):
            assert np.array_equal(a[key], b[key]) and np.array_equal(a[key], c[key])
    assert port_ds.load_counts == {"native": before["native"] + len(files),
                                   "numpy": before["numpy"] + len(files)}
