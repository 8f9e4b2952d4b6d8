"""The PyTorch port stands alone: it loads the unchanged experiment configs,
builds and loads the trained 9-room model and runs a forward pass without
importing jax, flax or video_gcp_tpu; and its entry point runs on the card
unless asked for the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from video_gcp_torch.load import load_model

REPO = Path(__file__).resolve().parent.parent
CONF = "experiments/prediction/9room/gcp_tree"

_SCRIPT = f"""
import sys
import numpy as np
import torch
import video_gcp_torch
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.load import load_model
from video_gcp_torch.training.config import build_hparams, load_config

bundle = load_config("{CONF}")
assert bundle.configuration["model"].__module__ == "video_gcp_torch.models.tree"
assert build_hparams(bundle)["hierarchy_levels"] == 7
model = load_model("{CONF}", weights="{CONF}/pretrained_ep74.npz", device="cpu")
rng = np.random.RandomState(0)
inputs = AttrDict(I_0=torch.from_numpy(rng.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8)),
                  I_g=torch.from_numpy(rng.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8)))
with torch.inference_mode():
    out = model(inputs, phase="plan", pred_length=True,
                generator=torch.Generator().manual_seed(0))
assert torch.isfinite(out.timeline_images).all()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "video_gcp_tpu"))
print("LOADED", loaded)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def test_load_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(REPO / CONF)


_PLANNING_SCRIPT = f"""
import sys
import numpy as np
from video_gcp_torch.evaluation.compute_control_perf import compute_control_perf
from video_gcp_torch.planning import planner_policy
from video_gcp_torch.planning.run import ControlManager, load_control_config

control = load_control_config("experiments/control/9room/gcp_tree/mod_hyper.py")
assert control["policy"]["type"] is planner_policy.ImageCEMPolicy
data_gen = load_control_config("experiments/data_gen/nav_9rooms_start_goal/mod_hyper.py")
agent = data_gen["agent"]["type"](dict(data_gen["agent"]))
policy = data_gen["policy"]["type"](dict(agent._hp), dict(data_gen["policy"]),
                                    **agent.env.env_policy_params())
np.random.seed(0)
data, obs, out = agent.sample(policy, 0)
assert obs["images"].shape[2:] == (32, 32, 3) and len(out) > 1
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "video_gcp_tpu", "cv2"))
print("LOADED", loaded)
"""


def test_planning_imports_no_jax_and_no_opencv():
    """The planning CLI's modules, both experiment configs it runs, and a PRM
    expert episode in the env load no jax, flax, video_gcp_tpu or cv2."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("GCP_DATA_DIR", None)
    proc = subprocess.run([sys.executable, "-c", _PLANNING_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def test_planning_run_defaults_to_the_card(monkeypatch, tmp_path):
    from video_gcp_torch.planning.run import ControlManager

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path))
    monkeypatch.setenv("GCP_DATA_DIR", str(tmp_path))
    conf = tmp_path / "experiments/control/toy/gcp_tree/mod_hyper.py"
    conf.parent.mkdir(parents=True)
    conf.write_text((REPO / "experiments/control/toy/gcp_tree/mod_hyper.py").read_text())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ControlManager([str(conf)]).run()


def test_planner_policy_defaults_to_the_card(monkeypatch):
    from video_gcp_torch.planning.run import load_control_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    policy = load_control_config(REPO / "experiments/control/9room/gcp_tree/mod_hyper.py")[
        "policy"]
    weights = str(REPO / CONF / "pretrained_ep74.npz")
    cem = dict(policy["cem_params"], cost_config=dict(policy["cem_params"]["cost_config"],
                                                      load_epoch=weights))
    conf = dict(policy, load_epoch=weights, cem_params=cem)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        policy["type"](dict(T=200), conf)
    planner = policy["type"](dict(T=200, device="cpu"), conf)  # asked for the CPU
    assert next(planner.planner.parameters()).device.type == "cpu"


@pytest.mark.parametrize("gpu_id, ngpu, devices, want", [
    (0, 1, 4, ["cuda:0", "cuda:0", "cuda:0"]),
    (0, 2, 4, ["cuda:0", "cuda:1", "cuda:0"]),
    (1, 4, 2, ["cuda:1", "cuda:0", "cuda:1"]),
])
def test_planning_workers_spread_over_the_cards(monkeypatch, gpu_id, ngpu, devices, want):
    from video_gcp_torch.planning.run import worker_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: devices)
    assert [worker_device("cuda", gpu_id, ngpu, i) for i in range(3)] == want
    assert worker_device("cpu", gpu_id, ngpu, 1) == "cpu"
