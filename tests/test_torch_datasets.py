"""The port's h5 datasets against the JAX package's, on the same h5 files
(written with h5py as tests/test_infra.py and tests/test_training.py write
them) with both datasets' `_rng` seeded alike: the windows, end_ind,
pad_mask, states and actions are equal, the stored frames resized alike
(the port's INTER_AREA against cv2's), the maze's re-rendered frames within
1 uint8 level; the render cache and its LRU cap; the global and folder
splits; and `raster.resize_linear` against cv2.resize. The nav_25rooms
case reads its spec and dataset class from both packages' nav_25rooms
configs unchanged: T=200 windows of the 5x5 maze, re-rendered."""
import cv2
import h5py
import numpy as np
import pytest

import video_gcp_torch.data.configs.nav_25rooms as t_nav25
import video_gcp_torch.data.datasets as t_ds
import video_gcp_tpu.data.configs.nav_25rooms as j_nav25
import video_gcp_tpu.data.datasets as j_ds
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.planning.infra import raster
from video_gcp_tpu.core.attrdict import AttrDict as JAttrDict

T_FILE, T = 14, 10  # frames stored per trajectory, the window's length
RENDER_TOL = 1  # uint8 levels, re-rendered maze frames (measured max: 0)
T_FILE_25 = 210  # nav_25rooms: frames stored per trajectory, for T=200 windows


def _write(root, n_files=6, traj_per_file=2, img=24, state_dim=5, folders=False,
           t_file=T_FILE):
    rng = np.random.RandomState(0)
    for i in range(n_files):
        d = root / "hdf5" / ("train", "val")[i % 2] if folders else root
        d.mkdir(parents=True, exist_ok=True)
        with h5py.File(d / f"traj_{i}.h5", "w") as f:
            f.create_dataset("traj_per_file", data=traj_per_file)
            for j in range(traj_per_file):
                n_real = t_file - (i + j) % 6  # some trajectories padded
                pad = (np.arange(t_file) < n_real).astype(np.float64)
                f.create_dataset(f"traj{j}/images",
                                 data=rng.randint(0, 256, (t_file, 1, img, img, 3), np.uint8))
                f.create_dataset(f"traj{j}/states",
                                 data=rng.uniform(-0.4, 0.4, (t_file, state_dim)) * pad[:, None])
                f.create_dataset(f"traj{j}/actions", data=rng.randn(t_file - 1, 2) * 0.1)
                f.create_dataset(f"traj{j}/pad_mask", data=pad)


def _conf(attrdict, **kw):
    return attrdict(dataset_spec=attrdict(max_seq_len=T, split=attrdict(
        train=0.5, val=0.5, test=0.0)), n_rooms=9, crop_window=40, **kw)


def _pair(name, root, phase, mpar):
    if name == "Nav25Rooms":  # the configs' own class and spec
        jset = j_nav25.Nav25Rooms(str(root), dict(mpar), j_nav25.config, phase)
        tset = t_nav25.Nav25Rooms(str(root), dict(mpar), t_nav25.config, phase)
    else:
        jset = getattr(j_ds, name)(str(root), dict(mpar), _conf(JAttrDict), phase)
        tset = getattr(t_ds, name)(str(root), dict(mpar), _conf(AttrDict), phase)
    jset._rng, tset._rng = np.random.RandomState(7), np.random.RandomState(7)
    return jset, tset


def _compare(jex, tex, frame_tol):
    assert set(jex) == set(tex), (sorted(jex), sorted(tex))
    worst = 0
    for k in jex:
        j, t = np.asarray(jex[k]), np.asarray(tex[k])
        assert j.shape == t.shape and j.dtype == t.dtype, (k, j.shape, t.shape)
        if j.dtype == np.uint8:
            worst = max(worst, int(np.abs(j.astype(int) - t).max(initial=0)))
        else:
            np.testing.assert_array_equal(j, t, err_msg=k)
    assert worst <= frame_tol, worst
    return worst


@pytest.mark.parametrize("name, frame_tol", [
    ("GlobalSplitVarLenVideoDataset", 0),  # stored frames, INTER_AREA 24 -> 16
    ("MazeTopRenderedGlobalSplitVarLenVideoDataset", RENDER_TOL),
    ("Nav25Rooms", RENDER_TOL),  # re-rendered too, in the 5x5 maze
])
@pytest.mark.parametrize("phase, randomize", [("train", False), ("train", True),
                                              ("val", False)])
def test_examples_match_jax(tmp_path, name, frame_tol, phase, randomize):
    nav25 = name == "Nav25Rooms"
    _write(tmp_path, t_file=T_FILE_25 if nav25 else T_FILE)
    # nav_25rooms: its 32x32 frames and T=200 windows; its split (0.994 /
    # 0.006) puts 5 of the 6 files in train, 1 in val
    mpar = dict(img_sz=32 if nav25 else 16, randomize_length=randomize,
                randomize_start=randomize)
    jset, tset = _pair(name, tmp_path, phase, mpar)
    n = (10 if phase == "train" else 2) if nav25 else 6
    assert jset.filenames == tset.filenames and len(jset) == len(tset) == n
    for epoch in range(2):  # the second reads the RAM and render caches
        for i in range(len(jset)):
            _compare(jset[i], tset[i], frame_tol)
    assert tset[0].traj_seq.shape == ((200, 32, 32, 3) if nav25 else (T, 16, 16, 3))


def test_render_cache_hits_and_skips_stored_images(tmp_path):
    _write(tmp_path)
    _, tset = _pair("MazeTopRenderedGlobalSplitVarLenVideoDataset", tmp_path, "val",
                    dict(img_sz=16))
    first = tset[0]
    assert "images" not in tset._cache[0]  # the stored frames are never read
    assert np.asarray(first.traj_seq).std() > 0.01
    calls = []
    render = tset._render_env.render_traj_top_down_u8
    tset._render_env.render_traj_top_down_u8 = lambda *a: (calls.append(1), render(*a))[1]
    np.testing.assert_array_equal(tset[0].traj_seq, first.traj_seq)
    assert not calls


def test_render_cache_lru_cap_evicts(tmp_path, monkeypatch):
    monkeypatch.setenv("GCP_RENDER_CACHE_MB", "0.01")  # 10 kB; one example is 7.7 kB
    _write(tmp_path)
    _, tset = _pair("MazeTopRenderedGlobalSplitVarLenVideoDataset", tmp_path, "val",
                    dict(img_sz=16))
    for i in range(len(tset)):
        tset[i]
        assert len(tset._render_cache) == 1
        assert tset._render_cache_bytes <= tset._render_cache_cap
    calls = []
    render = tset._render_env.render_traj_top_down_u8
    tset._render_env.render_traj_top_down_u8 = lambda *a: (calls.append(1), render(*a))[1]
    tset[len(tset) - 1]  # the most recent key: a hit
    assert not calls
    tset[0]  # evicted: drawn again
    assert calls == [1]


def test_splits_choose_the_same_files(tmp_path):
    _write(tmp_path / "global", n_files=10, traj_per_file=1)
    _write(tmp_path / "folders", n_files=10, traj_per_file=1, folders=True)
    for phase in ("train", "val"):
        for name, root in (("GlobalSplitVarLenVideoDataset", tmp_path / "global"),
                           ("FolderSplitVarLenVideoDataset", tmp_path / "folders")):
            jset, tset = _pair(name, root, phase, dict(img_sz=24))
            assert tset.filenames == jset.filenames and len(tset.filenames) == 5
            assert tset.traj_per_file == jset.traj_per_file == 1


def test_maze_dataset_keeps_xy_states(tmp_path):
    _write(tmp_path)
    jset, tset = _pair("MazeGlobalSplitVarLenVideoDataset", tmp_path, "val",
                       dict(img_sz=16, use_convs=False))
    _compare(jset[1], tset[1], 0)
    assert tset[1].traj_seq.shape == (T, 2)


def test_dataset_spec_written_by_either_package_loads(tmp_path):
    """A spec of the JAX package's saver (an AttrDict of video_gcp_tpu,
    imported through the port's config hook) and one of the port's (a
    plain dict) both load, as the JAX package loads them."""
    for i, (head, ctor) in enumerate((
            ("from video_gcp_tpu.core.attrdict import AttrDict\n", "AttrDict"),
            ("", "dict"))):
        d = tmp_path / str(i)
        d.mkdir()
        (d / "dataset_spec.py").write_text(
            f"{head}dataset_spec = {ctor}(max_seq_len=100, state_dim=5, n_actions=2)\n")
        spec = t_ds.BaseVideoDataset.get_dataset_spec(d)
        assert type(spec) is AttrDict and spec == dict(max_seq_len=100, state_dim=5,
                                                        n_actions=2)
        assert spec == j_ds.BaseVideoDataset.get_dataset_spec(str(d))


RESIZE_LINEAR_TOL = 1e-5  # absolute, values in [0, 1]; measured max 3.2e-6


@pytest.mark.parametrize("src, dst", [((128, 128), (32, 32)), ((128, 128), (64, 64)),
                                      ((128, 128), (48, 40)), ((16, 16), (40, 24))])
def test_resize_linear_matches_opencv(src, dst):
    rng = np.random.RandomState(0)
    for img in (rng.rand(*src).astype(np.float32), rng.rand(*src, 3).astype(np.float32)):
        want = cv2.resize(img, (dst[1], dst[0]))
        got = raster.resize_linear(img, dst[1], dst[0])
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= RESIZE_LINEAR_TOL


@pytest.mark.parametrize("src, dst", [((80, 80), (128, 128)), ((7, 13), (100, 80)),
                                      ((24, 24), (16, 16))])
def test_resize_area_matches_opencv_both_ways(src, dst):
    """Upscaling too: the 9-room data generation stores 80x80 renders at
    128x128."""
    img = np.random.RandomState(1).randint(0, 256, src + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(
        raster.resize_area(img, dst[1], dst[0]),
        cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA))
