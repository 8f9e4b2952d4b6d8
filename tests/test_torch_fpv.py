"""First-person and textured rendering of the port (video_gcp_torch/
planning/infra/envs/fpv.py, the textured layout, EgocentricMultiroom2dEnv)
against the JAX package and OpenCV, on the CPU. No texture pack is in the
repository: the tests write their PNG tiles with cv2.imwrite (RGB, grey and
RGBA files), as the nav datasets' pack would hold them.

Everything is held equal to the last bit: the procedural textures (seeded
by zlib.crc32 and np.random.RandomState), the ray casts and renders (the
same float64 numpy), the PNG decode against cv2.imread, and the uint8
bilinear resize against cv2.resize, whose fixed-point weights and rounding
raster.resize_linear reproduces."""
import zlib

import cv2
import numpy as np
import pytest

from video_gcp_torch.planning.infra import raster
from video_gcp_torch.planning.infra.envs import fpv as p_fpv
from video_gcp_torch.planning.infra.envs import layout as p_layout
from video_gcp_torch.planning.infra.envs import multiroom2d as p_env
from video_gcp_tpu.planning.infra.envs import fpv as j_fpv
from video_gcp_tpu.planning.infra.envs import layout as j_layout
from video_gcp_tpu.planning.infra.envs import multiroom2d as j_env

ROOMS = 9
ENV_PARAMS = dict(init_pos=None, goal_pos=None, n_rooms=ROOMS, heading_smoothing=0.1,
                  crop_window=40)


def _names_of_every_kind():
    """One texture name per pattern family (crc32 % 5)."""
    names = {}
    for name in p_layout.TEXTURE_FILE_ORDER:
        names.setdefault(zlib.crc32(name.encode()) % 5, name)
    assert len(names) == 5
    return [names[k] for k in range(5)]


@pytest.mark.parametrize("name", _names_of_every_kind())
def test_procedural_texture_equals_jax(name):
    for size in (16, 64):
        np.testing.assert_array_equal(p_fpv.procedural_texture(name, size),
                                      j_fpv.procedural_texture(name, size))


def _pack(tmp_path, n=ROOMS, size=(40, 52)):
    """The first n tiles of the texture order as PNGs written by OpenCV:
    3-channel, grey and 4-channel files in turn."""
    rng = np.random.RandomState(0)
    for i, name in enumerate(p_layout.TEXTURE_FILE_ORDER[:n]):
        ch = (3, 1, 4)[i % 3]
        img = rng.randint(0, 256, size + ((ch,) if ch > 1 else ())).astype(np.uint8)
        img[: size[0] // 3] = img[:1]  # smooth rows: libpng filters them
        cv2.imwrite(str(tmp_path / name), img)
    return str(tmp_path)


def test_png_decode_and_uint8_resize_equal_opencv(tmp_path):
    _pack(tmp_path, n=3)
    for name in p_layout.TEXTURE_FILE_ORDER[:3]:
        path = str(tmp_path / name)
        want = cv2.imread(path)[:, :, ::-1]
        got = raster.read_png(path)
        np.testing.assert_array_equal(got, want)
        for size in ((64, 64), (17, 23), (20, 26), (100, 90)):  # down, 2x, up
            np.testing.assert_array_equal(raster.resize_linear(got, *size),
                                          cv2.resize(np.ascontiguousarray(want), size))
    grey = np.random.RandomState(1).randint(0, 256, (9, 11)).astype(np.uint8)
    np.testing.assert_array_equal(raster.resize_linear(grey, 30, 7), cv2.resize(grey, (30, 7)))


@pytest.mark.parametrize("textures", ["off", "procedural", "pack"])
def test_cast_and_render_equal_jax(tmp_path, textures):
    tex_dir = _pack(tmp_path) if textures == "pack" else None
    kw = dict(img_size=24, textures=textures, texture_dir=tex_dir)
    port, ref = p_fpv.FirstPersonRenderer(3, **kw), j_fpv.FirstPersonRenderer(3, **kw)
    if textures != "off":
        np.testing.assert_array_equal(port._textures, ref._textures)
    rng = np.random.RandomState(2)
    for _ in range(4):
        pos, heading = rng.uniform(-1.2, 1.2, 2), rng.uniform(-np.pi, np.pi)
        for a, b in zip(port.cast(pos, heading), ref.cast(pos, heading), strict=True):
            np.testing.assert_array_equal(a, b)
        goal = pos + 0.4 * np.array([np.cos(heading), np.sin(heading)])
        for g in (None, goal):
            got, want = port.render(pos, heading, g), ref.render(pos, heading, g)
            assert got.dtype == np.uint8 and got.shape == (24, 24, 3)
            np.testing.assert_array_equal(got, want)


def test_pack_mode_without_the_pack_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="texture pack missing"):
        p_fpv.FirstPersonRenderer(3, img_size=8, textures="pack", texture_dir=str(tmp_path))


def test_textured_layout_equals_jax(tmp_path):
    tex_dir = _pack(tmp_path)
    np.testing.assert_array_equal(p_layout.draw_layout_overview(3, 20, texture_dir=tex_dir),
                                  j_layout.draw_layout_overview(3, 20, texture_dir=tex_dir))


@pytest.mark.parametrize("textures", ["off", "auto"])
def test_egocentric_env_reset_and_step_equal_jax(textures):
    hp = dict(ENV_PARAMS, fpv_img_size=32, fpv_textures=textures)
    penv, jenv = p_env.EgocentricMultiroom2dEnv(dict(hp)), j_env.EgocentricMultiroom2dEnv(dict(hp))
    np.random.seed(0)
    pobs, _ = penv.reset()
    np.random.seed(0)
    jobs, _ = jenv.reset()
    assert pobs.images.shape == (1, 32, 32, 3)
    rng = np.random.RandomState(3)
    for _ in range(5):
        for key in ("images", "state", "qpos_full"):
            np.testing.assert_array_equal(pobs[key], jobs[key], err_msg=key)
        action = rng.randn(2) * 0.05
        pobs, jobs = penv.step(action), jenv.step(action)
