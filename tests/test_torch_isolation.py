"""The PyTorch port stands alone: it loads the unchanged experiment configs,
builds and loads the trained 9-room model and runs a forward pass without
importing jax, flax or video_gcp_tpu; its data modules, datasets and the
sequential model also without h5py or cv2; and its entry point runs on the
card unless asked for the CPU."""
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
for name in ("gcp_tree", "gcp_sequential"):  # the 25-room control benchmark
    conf = load_control_config(f"experiments/control/25room/{{name}}/mod_hyper.py")
    assert conf["policy"]["type"] is planner_policy.ImageCEMPolicy
    assert conf["agent"]["env"][1]["n_rooms"] == 25 and conf["agent"]["T"] == 400
    assert conf["policy"]["cem_params"]["sampler"].__module__.startswith("video_gcp_torch.")
for rooms, t in ((25, 200), (16, 100)):  # the PRM expert's h5 data in the larger mazes
    conf = load_control_config(f"experiments/data_gen/nav_{{rooms}}rooms/mod_hyper.py")
    assert conf["agent"]["env"][1]["n_rooms"] == rooms and conf["agent"]["T"] == t
    assert conf["policy"]["type"].__module__.startswith("video_gcp_torch.")
    assert conf["agent"]["type"].__module__.startswith("video_gcp_torch.")
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
    """The planning CLI's modules, the experiment configs it runs (the 9-room
    control and start/goal configs, both 25-room control configs, the
    nav_25rooms and nav_16rooms data generation), and a PRM expert episode
    in the env load no jax, flax, video_gcp_tpu or cv2."""
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


_DATA_SCRIPT = """
import sys, tempfile
from pathlib import Path
import numpy as np
import torch
import video_gcp_torch.data
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.data import h5
from video_gcp_torch.data.configs import nav_25rooms, nav_25rooms_long
from video_gcp_torch.data.configs.nav_9rooms import Nav9Rooms, config
from video_gcp_torch.evaluation.eval_binding import dense_sample
from video_gcp_torch.planning.infra.agent.general_agent import BenchmarkAgentLoadHDF5
from video_gcp_torch.planning.infra.agent.savers import HDF5Saver
from video_gcp_torch.training.config import build_hparams, load_config
from video_gcp_torch.training.trainer import ModelTrainer

d = Path(tempfile.mkdtemp())
t = 12
with h5.File(d / "traj_0.h5", "w") as f:
    f.create_dataset("traj_per_file", data=1)
    f.create_dataset("traj0/images", data=np.zeros((t, 1, 128, 128, 3), np.uint8))
    f.create_dataset("traj0/states", data=np.tile(np.linspace(-0.3, 0.3, t)[:, None], (1, 5)))
    f.create_dataset("traj0/actions", data=np.zeros((t - 1, 2)))
    f.create_dataset("traj0/pad_mask", data=np.ones(t))
conf = AttrDict(config, dataset_spec=AttrDict(config.dataset_spec, max_seq_len=t,
                                              split=AttrDict(train=1.0, val=0.0, test=0.0)))
ex = Nav9Rooms(str(d), dict(img_sz=32), conf, "train")[0]
assert ex.traj_seq.shape == (t, 32, 32, 3) and ex.traj_seq.std() > 0.01

bundle = load_config("experiments/prediction/9room/gcp_sequential")
assert bundle.configuration["model"].__module__ == "video_gcp_torch.models.sequential"
assert bundle.data_conf.dataset_spec.dataset_class is Nav9Rooms
# its config at a cut width and horizon: the call proves what it imports
hp = build_hparams(bundle).overwrite(dict(ngf=4, nz_mid_lstm=32, nz_mid=32, nz_enc=32,
                                          n_lstm_layers=1, max_seq_len=t))
model = bundle.configuration["model"](hp)
rng = np.random.RandomState(0)
inputs = AttrDict(I_0=torch.from_numpy(rng.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8)),
                  I_g=torch.from_numpy(rng.randint(0, 256, (1, 32, 32, 3)).astype(np.uint8)))
with torch.inference_mode():
    out = model(inputs, phase="plan", pred_length=True,
                generator=torch.Generator().manual_seed(0))
assert out.timeline_images.shape == (1, t, 32, 32, 3)
assert torch.isfinite(out.timeline_images).all()
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "video_gcp_tpu", "h5py", "cv2"))
print("LOADED", loaded)
"""


def test_data_and_sequential_modules_import_no_jax_h5py_or_opencv():
    """The h5 module, the datasets and their configs, the sequential model
    (9room/gcp_sequential's config at a cut width, one plan call), the trainer and the
    h5 benchmark agent load no jax, flax, video_gcp_tpu, h5py or cv2."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _DATA_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


_BC_SCRIPT = """
import sys, tempfile
from pathlib import Path
import numpy as np
import torch
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.models.bc import BCModel
from video_gcp_torch.models.hyperparameters import default_hparams
from video_gcp_torch.planning.infra.policy.bc_policy import BehavioralCloningPolicy

params = dict(n_actions=2, img_sz=16, reactive=False)
hp = default_hparams()
hp.overwrite(dict(params, batch_size=1))
exp = Path(tempfile.mkdtemp())
(exp / "weights/weights_ep0").mkdir(parents=True)
torch.save(dict(model=BCModel(dict(hp)).state_dict(), optimizer={}, step=0),
           exp / "weights/weights_ep0/state.pt")
policy = BehavioralCloningPolicy(dict(T=10, device="cpu"),
                                 dict(params=params, checkpt_path=str(exp)))
images = np.zeros((3, 1, 16, 16, 3), np.uint8)  # [T, camera, H, W, C]
for t in range(2):
    out = policy.act(t=t, i_tr=0, images=images, goal_image=images[:1])
assert out.actions.shape == (2,) and policy.hidden_var is not None
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "video_gcp_tpu"))
print("LOADED", loaded)
"""


def test_bc_model_and_policy_import_no_jax():
    """models/bc.py and planning/infra/policy/bc_policy.py: a recurrent BC
    policy restored from a port checkpoint acts twice without jax, flax or
    video_gcp_tpu."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _BC_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def test_bc_policy_defaults_to_the_card(monkeypatch, tmp_path):
    from video_gcp_torch.models.bc import BCModel
    from video_gcp_torch.models.hyperparameters import default_hparams
    from video_gcp_torch.planning.infra.policy.bc_policy import BehavioralCloningPolicy

    params = dict(n_actions=2, img_sz=16)
    hp = default_hparams()
    hp.overwrite(dict(params, batch_size=1))
    (tmp_path / "weights/weights_ep0").mkdir(parents=True)
    torch.save(dict(model=BCModel(dict(hp)).state_dict(), optimizer={}, step=0),
               tmp_path / "weights/weights_ep0/state.pt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = dict(params=params, checkpt_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BehavioralCloningPolicy(dict(T=10), conf)
    policy = BehavioralCloningPolicy(dict(T=10, device="cpu"), conf)  # asked for the CPU
    assert next(policy.model.parameters()).device.type == "cpu"


_EXTRAS_SCRIPT = """
import sys, tempfile
from pathlib import Path
sys.modules["cv2"] = None  # an import of OpenCV fails
import numpy as np
import torch
from video_gcp_torch.evaluation import fvd, lpips, visualization
from video_gcp_torch.evaluation.eval_binding import greedy_exist_select, greedy_l2_match
from video_gcp_torch.models import dlm
from video_gcp_torch.models.nets import RecurrentSeqEncoder
from video_gcp_torch.planning.infra.envs.multiroom2d import EgocentricMultiroom2dEnv
from video_gcp_torch.training import finetune_inv_mdl

d = Path(tempfile.mkdtemp())
rng = np.random.RandomState(0)
seqs = np.tanh(rng.randn(6, 4, 3, 16, 16)).astype(np.float32)
np.save(d / "gt_seq_0.npy", seqs)
np.save(d / "gen_images_0.npy", seqs[::-1].copy())
assert np.isfinite(fvd.compute_fvd(str(d / "gt_seq_0.npy"), str(d / "gen_images_0.npy"),
                                   device="cpu"))
assert np.isfinite(lpips.compute_lpips(str(d / "gt_seq_0.npy"), str(d / "gen_images_0.npy"),
                                       device="cpu"))
env = EgocentricMultiroom2dEnv(dict(n_rooms=9, fpv_img_size=16, fpv_textures="procedural"))
obs, _ = env.reset()
assert obs.images.shape == (1, 16, 16, 3)
assert visualization.plot_balanced_tree(np.zeros((1, 7, 4, 4, 3))).shape == (12, 16, 3)
assert greedy_exist_select(torch.rand(2, 7), torch.tensor([3, 9]), 10).sum() == 4 + 7
assert greedy_l2_match(torch.rand(2, 7, 5), torch.tensor([4, 2]), 3)[0].shape == (2, 7)
enc = RecurrentSeqEncoder(dict(nz_enc=4), bidirectional=True)
assert enc(torch.zeros(2, 3, 4)).shape == (2, 3, 4)
raw = torch.zeros(1, 2, 2, dlm.n_dlm_channels(3))
assert dlm.sample(raw, torch.Generator().manual_seed(0), 3).shape == (1, 2, 2, 3)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "video_gcp_tpu"))
print("LOADED", loaded)
"""


def test_eval_extras_fpv_and_finetune_import_no_jax_or_opencv():
    """FVD, LPIPS (their proxies end to end on the CPU), the plots, the
    greedy schemes, the recurrent sequence encoder, dlm.sample, the
    first-person env and the fine-tune load no jax, flax or video_gcp_tpu,
    and need no OpenCV."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("GCP_DATA_DIR", None)
    env.pop("GCP_I3D_WEIGHTS", None)
    env.pop("GCP_LPIPS_WEIGHTS", None)
    proc = subprocess.run([sys.executable, "-c", _EXTRAS_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("module, argv", [
    ("evaluation.fvd", ["."]),
    ("evaluation.lpips", ["."]),
    ("training.finetune_inv_mdl", ["--path", "experiments/prediction/toy_random/gcp_tree_widegap",
                                   "--base", "none", "--epochs", "1"]),
])
def test_eval_extras_and_finetune_default_to_the_card(monkeypatch, module, argv):
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"video_gcp_torch.{module}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
