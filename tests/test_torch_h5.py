"""The port's HDF5 module (video_gcp_torch/data/h5.py) against h5py: it reads
what h5py writes (contiguous, and chunked with gzip and shuffle), h5py reads
what it writes, both bit for bit, and a layout outside its subset raises
with a message that names what it found."""
import h5py
import numpy as np
import pytest

from video_gcp_torch.data import h5


def _trajectories(rng, n=2, t=6):
    data = {"traj_per_file": n}
    for i in range(n):
        data[f"traj{i}/images"] = rng.randint(0, 256, (t, 1, 16, 16, 3)).astype(np.uint8)
        data[f"traj{i}/states"] = rng.randn(t, 5)
        data[f"traj{i}/actions"] = rng.randn(t - 1, 2).astype(np.float32)
        data[f"traj{i}/pad_mask"] = (np.arange(t) < t - i).astype(np.float64)
    data["nested/deeper/ints"] = rng.randint(-2 ** 40, 2 ** 40, (3, 4)).astype(np.int64)
    data["scalar_float"] = np.float64(2.5)
    return data


def _assert_same(got, want):
    assert np.asarray(got).dtype == np.asarray(want).dtype
    assert np.asarray(got).shape == np.asarray(want).shape
    assert np.asarray(got).tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("storage", [
    dict(),
    dict(compression="gzip", shuffle=True),
    dict(compression="gzip", compression_opts=9, chunks=True),
])
def test_reads_what_h5py_writes(tmp_path, storage):
    data = _trajectories(np.random.RandomState(0))
    path = tmp_path / "traj_0.h5"
    with h5py.File(path, "w") as f:
        for k, v in data.items():
            f.create_dataset(k, data=v, **(storage if np.ndim(v) else {}))
    with h5.File(path, "r") as f:
        assert list(f) == ["nested", "scalar_float", "traj0", "traj1", "traj_per_file"]
        assert list(f["traj1"]) == ["actions", "images", "pad_mask", "states"]
        assert "traj1/images" in f and "traj2/images" not in f and "traj0/x" not in f
        assert isinstance(f["traj_per_file"][()], np.int64)
        for k, v in data.items():
            _assert_same(f[k][()], v)
        assert f["traj0/images"].shape == (6, 1, 16, 16, 3)


def test_reads_a_group_of_many_members(tmp_path):
    """More members than one symbol table node holds (8), in both
    directions."""
    data = {f"g/d{i:02d}": np.arange(i, dtype=np.int64) for i in range(40)}
    for writer in ("h5py", "port"):
        path = tmp_path / f"{writer}.h5"
        with (h5py.File if writer == "h5py" else h5.File)(path, "w") as f:
            for k, v in data.items():
                f.create_dataset(k, data=v)
        with h5py.File(path, "r") as hf, h5.File(path, "r") as f:
            assert list(f["g"]) == sorted(f"d{i:02d}" for i in range(40)) == list(hf["g"])
            for k, v in data.items():
                _assert_same(f[k][()], v)
                _assert_same(hf[k][()], v)


@pytest.mark.parametrize("dtype", [np.uint8, np.int64, np.float32, np.float64])
def test_h5py_reads_what_the_port_writes(tmp_path, dtype):
    rng = np.random.RandomState(1)
    data = _trajectories(rng)
    data["typed/array"] = (rng.rand(4, 3, 2) * 100).astype(dtype)
    data["typed/scalar"] = dtype(7)
    path = tmp_path / "port.h5"
    with h5.File(path, "w") as f:
        for k, v in data.items():
            f.create_dataset(k, data=v)
    with h5py.File(path, "r") as f:
        assert sorted(f["typed"]) == ["array", "scalar"]
        for k, v in data.items():
            _assert_same(f[k][()], v)
    with h5.File(path, "r") as f:  # and the port reads itself
        for k, v in data.items():
            _assert_same(f[k][()], v)


@pytest.mark.parametrize("make, message", [
    (lambda p: h5py.File(p, "w", libver="latest").create_dataset("x", data=1),
     "superblock version 3"),
    (lambda p: h5py.File(p, "w").create_dataset("x", data=np.ones(8), chunks=(4,),
                                                compression="lzf"),
     "filter 32000"),
    (lambda p: h5py.File(p, "w").create_dataset("x", data=np.ones(8), chunks=(4,),
                                                fletcher32=True),
     "filter 3"),
    (lambda p: h5py.File(p, "w").create_dataset("x", data=np.ones(4, ">f4")),
     "big-endian"),
    (lambda p: h5py.File(p, "w").create_dataset("x", data=np.ones(4, bool)),
     "datatype class 8"),
    (lambda p: h5py.File(p, "w").create_dataset("x", data="text"),
     "datatype class 9"),
    (lambda p: h5py.File(p, "w").create_dataset("x", shape=(4,), dtype="f4"),
     "never written"),
])
def test_outside_the_subset_raises_naming_it(tmp_path, make, message):
    path = tmp_path / "x.h5"
    make(path)
    h5py.File(path, "r").close()  # written and closed
    with pytest.raises(ValueError, match=message):
        with h5.File(path, "r") as f:
            f["x"][()]


def test_writing_outside_the_subset_raises(tmp_path):
    with h5.File(tmp_path / "x.h5", "w") as f:
        with pytest.raises(ValueError, match="bool"):
            f.create_dataset("b", data=np.ones(3, bool))
        f.create_dataset("a/b", data=1)
        with pytest.raises(ValueError, match="exists"):
            f.create_dataset("a/b", data=2)
        with pytest.raises(ValueError, match="is a dataset"):
            f.create_dataset("a/b/c", data=2)
