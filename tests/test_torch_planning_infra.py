"""The port's planning infrastructure against OpenCV and against the JAX
package, on the CPU.

- `raster` against cv2: the maze's walls (axis-aligned, thickness 3, also
  across the border), the agent and goal discs (thickness 10 and 20, on
  uint8 and float32 images, at and past the borders) and oblique lines of
  thickness 4 inside the image: pixel for pixel equal. (An oblique line
  that leaves the image is not held to OpenCV's pixels, see raster.py;
  nothing on the planning paths draws one.) INTER_AREA 80->32,
  80->16 and 32->16 equal in uint8, and in float32 but 80->16 within 2.4e-7
  (2 ulp at 1.0, OpenCV's summation order of a block). PNG both ways:
  the port's files read by cv2 and cv2's files read by the port give the
  same pixels, and every PNG filter type decodes.
- The layout image, the env's reset and step observations, and a PRM expert
  trajectory through `GeneralAgent.sample`, in the 9-, 16- and 25-room
  mazes: equal to the JAX package's under the same `np.random.seed`.
- `RawSaver` -> `BenchmarkAgent._load_raw_data`, across the two packages in
  both directions.
- Pickles both ways: the JAX package's task pickle read by the port in a
  process that loads no `video_gcp_tpu`; the port's score pickles read by
  the JAX package's `compute_control_perf` and `combine_scores` and by
  scripts/control_ab_table.py with the same results as the JAX package's
  own.
"""
import importlib.util
import os
import pickle
import shutil
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from video_gcp_torch.core.attrdict import AttrDict, load_pickle
from video_gcp_torch.evaluation.compute_control_perf import compute_control_perf
from video_gcp_torch.planning.infra import raster
from video_gcp_torch.planning.infra.agent import general_agent as p_agent
from video_gcp_torch.planning.infra.agent.savers import RawSaver
from video_gcp_torch.planning.infra.envs import layout as p_layout
from video_gcp_torch.planning.infra.envs import multiroom2d as p_env
from video_gcp_torch.planning.infra.policy.prm_policy.prm_policy import PrmPolicy
from video_gcp_torch.planning.infra.sim import benchmarks as p_bench
from video_gcp_tpu.evaluation.compute_control_perf import (
    compute_control_perf as j_compute_control_perf,
)
from video_gcp_tpu.planning.infra.agent import general_agent as j_agent
from video_gcp_tpu.planning.infra.agent.savers import RawSaver as JRawSaver
from video_gcp_tpu.planning.infra.envs import layout as j_layout
from video_gcp_tpu.planning.infra.envs import multiroom2d as j_env
from video_gcp_tpu.planning.infra.policy.prm_policy.prm_policy import (
    PrmPolicy as JPrmPolicy,
)
from video_gcp_tpu.planning.infra.sim import benchmarks as j_bench

REPO = Path(__file__).resolve().parent.parent
LOG_EP74 = REPO / "experiments/control/9room/gcp_tree/log_ep74"
ENV_PARAMS = dict(init_pos=None, goal_pos=None, n_rooms=9, heading_smoothing=0.1,
                  crop_window=40)
TOL_AREA_F32 = 2.4e-7


@pytest.fixture(autouse=True)
def no_textures(monkeypatch):
    monkeypatch.delenv("GCP_DATA_DIR", raising=False)


def _both(img, draw):
    a, b = img.copy(), img.copy()
    draw(cv2, a)
    draw(raster, b)
    return a, b


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_walls_and_discs_equal_opencv(dtype):
    rng = np.random.RandomState(0)
    scale = 255 if dtype == np.uint8 else 1.0
    color = tuple(np.array([0.2, 0.7, 1.0]) * scale)
    for _ in range(300):
        h, w = rng.randint(8, 90, 2)
        img = (rng.rand(h, w, 3) * scale).astype(dtype)
        x, y = int(rng.randint(-12, w + 12)), int(rng.randint(-12, h + 12))
        for thickness in (10, 20):  # discs, at and past the borders
            a, b = _both(img, lambda m, im: m.line(im, (x, y), (x, y), color, thickness))
            assert np.array_equal(a, b), (h, w, x, y, thickness)
        end = ((x, int(rng.randint(-5, h + 5))) if rng.rand() < 0.5
               else (int(rng.randint(-5, w + 5)), y))  # a wall, also across the border
        a, b = _both(img, lambda m, im: m.line(im, (x, y), end, color, 3))
        assert np.array_equal(a, b), (h, w, (x, y), end)


def test_oblique_lines_equal_opencv_inside_the_image():
    """render_top_down's trajectory segments: oblique, thickness 4, inside
    the maze image with their caps."""
    rng = np.random.RandomState(1)
    for _ in range(400):
        h, w = rng.randint(16, 80, 2)
        img = np.zeros((h, w, 3), np.uint8)
        th = int(rng.choice([2, 4, 5]))
        p0 = (int(rng.randint(th, w - th)), int(rng.randint(th, h - th)))
        p1 = (int(rng.randint(th, w - th)), int(rng.randint(th, h - th)))
        a, b = _both(img, lambda mod, im: mod.line(im, p0, p1, (255, 0, 0), th))
        assert np.array_equal(a, b), (h, w, p0, p1, th)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("src, size", [(80, 32), (80, 16), (32, 16)])
def test_resize_area_equals_opencv(dtype, src, size):
    """80 -> 32 and 80 -> 16: the env's crop to the 9-room and the toy
    frames; 32 -> 16: 9-room start/goal frames to the toy's."""
    rng = np.random.RandomState(size)
    worst = 0.0
    for i in range(20):
        if dtype == np.uint8:
            img = (rng.randint(0, 256, (src, src, 3)) if i % 2 else
                   rng.randint(0, 4, (src, src, 3)) * 85).astype(np.uint8)  # ties
        else:
            img = rng.rand(src, src, 3).astype(np.float32)
        want = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
        got = raster.resize_area(img, size, size)
        assert got.dtype == want.dtype and got.shape == want.shape
        worst = max(worst, float(np.abs(got.astype(np.float64) - want).max()))
    tol = TOL_AREA_F32 if (dtype, src, size) == (np.float32, 80, 16) else 0.0
    assert worst <= tol, worst


def test_env_frames_resize_like_opencv():
    env = p_env.TopdownMultiroom2dEnv(dict(ENV_PARAMS))
    np.random.seed(0)
    obs, _ = env.reset()
    frame = obs.images[0]
    assert frame.shape == (80, 80, 3) and frame.dtype == np.uint8
    assert np.array_equal(raster.resize_area(frame, 32, 32),
                          cv2.resize(frame, (32, 32), interpolation=cv2.INTER_AREA))


def _png_with_filters(path, img):
    """An RGB PNG whose row y uses filter type y % 5 (an encoder for the
    test alone: cv2 chooses the filters itself)."""
    h, w, c = img.shape
    x = img.astype(np.int32).reshape(h, w * c)
    rows, prev = [], np.zeros(w * c, np.int32)
    for y in range(h):
        cur, kind = x[y], y % 5
        a = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        b = prev
        cc = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        rows.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


def test_png_both_ways(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (37, 29, 3)).astype(np.uint8)
    img[:10] = np.arange(29)[None, :, None] * 8  # smooth rows: cv2 filters them
    raster.write_png(tmp_path / "port.png", img)
    assert np.array_equal(cv2.imread(str(tmp_path / "port.png"))[..., ::-1], img)
    cv2.imwrite(str(tmp_path / "cv.png"), img[..., ::-1])
    assert np.array_equal(raster.read_png(tmp_path / "cv.png"), img)
    _png_with_filters(tmp_path / "filters.png", img)
    assert np.array_equal(cv2.imread(str(tmp_path / "filters.png"))[..., ::-1], img)
    assert np.array_equal(raster.read_png(tmp_path / "filters.png"), img)


N_ROOMS = [9, 16, 25]  # the 3x3, 4x4 and 5x5 mazes of the experiment configs


@pytest.mark.parametrize("n_rooms", N_ROOMS)
def test_layout_image_and_env_equal_jax(n_rooms):
    side = int(np.sqrt(n_rooms))
    assert np.array_equal(p_layout.draw_layout_overview(side, 256),
                          j_layout.draw_layout_overview(side, 256))
    params = dict(ENV_PARAMS, n_rooms=n_rooms)
    penv = p_env.TopdownMultiroom2dEnv(dict(params))
    jenv = j_env.TopdownMultiroom2dEnv(dict(params))
    for seed in range(3):
        np.random.seed(seed)
        pobs, preset = penv.reset()
        np.random.seed(seed)
        jobs, jreset = jenv.reset()
        for key in ("images", "state", "topdown_image", "qpos_full"):
            assert np.array_equal(pobs[key], jobs[key]), key
        assert {k: np.asarray(v).tolist() for k, v in preset.items()} == \
            {k: np.asarray(v).tolist() for k, v in jreset.items()}
        rng = np.random.RandomState(seed)
        for _ in range(30):
            action = rng.randn(2) * 0.04
            pobs, jobs = penv.step(action), jenv.step(action)
            for key in ("images", "state", "topdown_image"):
                assert np.array_equal(pobs[key], jobs[key]), key
        assert penv.eval()["final_dist"] == jenv.eval()["final_dist"]


def _expert_rollout(agent_mod, policy_cls, env_cls, seed, n_rooms=9):
    np.random.seed(seed)
    agent = agent_mod.GeneralAgent(dict(
        env=(env_cls, dict(ENV_PARAMS, n_rooms=n_rooms)), T=40, make_final_gif=False,
        image_height=32, image_width=32))
    policy = policy_cls(dict(agent._hp), dict(max_traj_length=40),
                        **agent.env.env_policy_params())
    return agent.sample(policy, 0)


@pytest.mark.parametrize("n_rooms", N_ROOMS)
def test_prm_expert_trajectory_equals_jax(n_rooms):
    for seed in (0, 1):
        p_data, p_obs, p_out = _expert_rollout(p_agent, PrmPolicy,
                                               p_env.TopdownMultiroom2dEnv, seed, n_rooms)
        j_data, j_obs, j_out = _expert_rollout(j_agent, JPrmPolicy,
                                               j_env.TopdownMultiroom2dEnv, seed, n_rooms)
        assert len(p_out) == len(j_out) > 1
        assert np.array_equal(np.stack([o["actions"] for o in p_out]),
                              np.stack([o["actions"] for o in j_out]))
        for key in ("images", "state", "qpos_full"):
            assert np.array_equal(p_obs[key], j_obs[key]), key
        assert p_obs["images"].shape[2:] == (32, 32, 3)


def _benchmark_agent(agent_mod, env_mod, confs):
    return agent_mod.BenchmarkAgent(dict(
        env=(env_mod.TopdownMultiroom2dEnv, dict(ENV_PARAMS)), T=20,
        image_height=16, image_width=16, start_goal_confs=str(confs)))


def test_raw_saver_round_trip_across_packages(tmp_path):
    _, obs, out = _expert_rollout(p_agent, PrmPolicy, p_env.TopdownMultiroom2dEnv, 3)
    RawSaver(str(tmp_path / "port")).save_traj(0, None, obs, out)
    JRawSaver(str(tmp_path / "jax")).save_traj(0, None, obs, out)
    frames = sorted((tmp_path / "port/raw/traj_group0/traj0/images0").iterdir())
    assert len(frames) == obs["images"].shape[0]
    for writer in ("port", "jax"):
        confs = tmp_path / writer / "raw"
        p, j = _benchmark_agent(p_agent, p_env, confs), _benchmark_agent(j_agent, j_env, confs)
        assert np.array_equal(p._demo_images, j._demo_images), writer
        assert np.array_equal(p._goal_image, j._goal_image)
        assert np.array_equal(p._goal, j._goal)
        assert np.array_equal(p._reset_state, j._reset_state)
        # 32x32 frames to 16x16: the integer-factor INTER_AREA
        first = raster.read_png(confs / "traj_group0/traj0/images0/im_0.png")
        assert np.array_equal(p._demo_images[0, 0] * 255.0,
                              cv2.resize(first, (16, 16), interpolation=cv2.INTER_AREA))


_READ_JAX_TASK = f"""
import sys
from video_gcp_torch.core.attrdict import AttrDict, load_pickle
task = load_pickle("{LOG_EP74}/task_0.pkl")
assert type(task["reset_state"]) is AttrDict, type(task["reset_state"])
assert len(task["full_traj"]) > 1 and task["goal_image"].shape[-3:] == (32, 32, 3)
scores = load_pickle("{LOG_EP74}/scores_0to19.pkl")
assert len(scores["final_dist"]) == 20
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "flax", "video_gcp_tpu")))
"""


def test_port_reads_jax_pickles_without_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _READ_JAX_TASK], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def test_unpickler_refuses_other_jax_classes(tmp_path):
    from video_gcp_tpu.core.params import ParamDict as JParamDict

    path = tmp_path / "x.pkl"
    path.write_bytes(pickle.dumps(JParamDict(a=1)))
    with pytest.raises(pickle.UnpicklingError, match="JAX package"):
        load_pickle(path)


def test_load_pickle_tells_the_packages_apart(tmp_path):
    """allow_jax=False refuses the JAX package's task pickle and reads the
    port's own, which holds the port's AttrDict."""
    with pytest.raises(pickle.UnpicklingError, match="JAX package"):
        load_pickle(LOG_EP74 / "task_0.pkl", allow_jax=False)
    task = load_pickle(LOG_EP74 / "task_0.pkl")
    path = tmp_path / "task_0.pkl"
    path.write_bytes(pickle.dumps(task))
    again = load_pickle(path, allow_jax=False)
    assert type(again["reset_state"]) is AttrDict
    assert np.array_equal(again["goal_image"], task["goal_image"])


def _control_ab_table():
    spec = importlib.util.spec_from_file_location(
        "control_ab_table", REPO / "scripts/control_ab_table.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_score_pickles_read_by_the_jax_package(tmp_path):
    """The port re-writes the JAX package's 20 scored tasks through its own
    combine_scores; every reader computes what it computes from the JAX
    package's own file."""
    (tmp_path / "jax").mkdir()
    shutil.copy(LOG_EP74 / "scores_0to19.pkl", tmp_path / "jax")
    ref = j_compute_control_perf(pickle.load(open(LOG_EP74 / "scores_0to19.pkl", "rb")))
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    shutil.copy(LOG_EP74 / "scores_0to19.pkl", port_dir / "scores_0to19.pkl")
    p_bench.combine_scores(str(port_dir))
    os.remove(port_dir / "scores_0to19.pkl")
    os.rename(port_dir / "scores_combined.pkl", port_dir / "scores_0to19.pkl")
    with open(port_dir / "scores_0to19.pkl", "rb") as f:
        port_scores = pickle.load(f)
    assert type(port_scores["reset_state"][0]) is AttrDict  # the port's class
    assert j_compute_control_perf(port_scores) == ref
    assert compute_control_perf(load_pickle(port_dir / "scores_0to19.pkl")) == ref
    combined = j_bench.combine_scores(str(port_dir))
    assert np.array_equal(combined["final_dist"], port_scores["final_dist"])
    ab = _control_ab_table()
    p_succ, p_r2g = ab.per_task(ab._load_merged(str(port_dir), ["scores_0to19.pkl"]), 9, 200)
    j_succ, j_r2g = ab.per_task(ab._load_merged(str(tmp_path / "jax"), ["scores_0to19.pkl"]),
                                9, 200)
    assert np.array_equal(p_succ, j_succ) and np.array_equal(p_r2g, j_r2g)
