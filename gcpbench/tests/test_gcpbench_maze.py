"""The plan cell's traffic: the benchmark's copy of the maze renders what
the port's env and benchmark agent render, pixel for pixel."""
import json

import numpy as np
import pytest

from gcpbench import maze
from gcpbench.tests.conftest import ROOT


@pytest.fixture
def env(monkeypatch):
    monkeypatch.delenv("GCP_DATA_DIR", raising=False)  # flat room colours
    from video_gcp_torch.planning.infra.envs.multiroom2d import TopdownMultiroom2dEnv
    return TopdownMultiroom2dEnv(dict(n_rooms=9, heading_smoothing=0.1, crop_window=40,
                                      init_pos=None, goal_pos=None))


@pytest.mark.parametrize("seed", [0, 1])
def test_the_copy_renders_as_the_env_and_the_agent(env, seed):
    from video_gcp_torch.planning.infra import raster
    view = maze.TopDown(9, 40, 256, 32)
    rng = np.random.default_rng(seed)
    for _ in range(12):
        rooms = rng.choice(9, 2, replace=False)
        start, goal = (view.room_center(r) + (rng.random(2) - 0.5)
                       * (maze.ROOM_SIZE - 3 * maze.ROBOT_SIZE) for r in rooms)
        obs, _ = env.reset(np.concatenate([start, [0.0], goal]))
        want = raster.resize_area(obs.images[0], 32, 32)
        assert np.array_equal(view.observe(start, goal), want)
        assert env._layout.coords2ridx(*start) == rooms[0]
        assert env._layout.coords2ridx(*goal) == rooms[1]


def test_the_mix_draws_pairs_in_two_rooms(env):
    mix = json.loads((ROOT / "gcpbench/traffic/maze9_pairs.json").read_text())
    pairs = maze.pairs(dict(mix, pairs=4), 32)
    assert len(pairs) == 4 and all(a.shape == b.shape == (32, 32, 3) for a, b in pairs)
    assert all(a.dtype == np.uint8 and not np.array_equal(a, b) for a, b in pairs)
    again = maze.pairs(dict(mix, pairs=4), 32)
    assert all(np.array_equal(a, c) and np.array_equal(b, d)
               for (a, b), (c, d) in zip(pairs, again))
