"""The paper's 25-room long-horizon path in the port against the JAX package,
on the CPU: experiments/control/25room/gcp_tree (8-level hierarchical CEM,
rates [10, 10], prune_final, horizon 200, T=400 env steps) and
experiments/control/25room/gcp_sequential (flat CEM on the same tree).

- The planner hparams both packages build from the two 25-room control
  configs: equal apart from class values.
- An untied L=8 tree (255 nodes, max_seq_len 200, a 3-layer split_linear
  TreeLSTM) at small widths (16x16 frames, ngf 4, 16-wide latents), with
  weights from a seed in the flax structure of a training init: one 'plan'
  call of 10 candidates with injected z, the planner's call, within
  TOL_PLAN_CALL of JAX's outputs.
- One whole `ImageCEMPolicy._plan` of each 25-room planner on that model,
  its CEM settings read from the configs (only the latent width action_dim
  and the learned cost's widths cut), under one np.random seed. Every
  ranking that picks a latent or a plan is held to its margin: the gap
  between the JAX side's neighbouring costs must exceed twice the largest
  difference between the two sides' costs, so that float error cannot have
  decided it. Then the same frozen latents, the plan within
  tests/test_torch_planning.py's TOLS (images 2e-4, latents 5e-4, actions
  1e-4) and its cost within TOL_COST (1e-5) of max(1, |cost|) plus 1e-4,
  test_whole_plan_matches_jax's bound.
- `compute_control_perf` at n_rooms=25 and max_seq_len=400 (the 25-room
  agent's T) on synthetic trajectories: equal across the packages.
- One task of control/25room/gcp_tree through planning.run on the CPU from
  the port's initialisation of the config's model at cut widths (see
  TINY_WIDTHS), with start/goal configurations that the port's PRM expert
  makes in the 25-room maze, cut to TASK_T = 120 env steps of the config's
  400 for the CPU's time (see TASK_T).

The model calls run with length_pred_weight 0: the 'plan' call then keeps
the given end_ind (base.py:get_end_ind), since torch cannot replay JAX's
length draw. Torch runs on one thread, as the suite's other files do.
"""
import pickle
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_baselines import CostLog, _check_rankings
from test_torch_planning import (
    TOL_COST,
    TOLS,
    _ag_params,
    _ArgminLog,
    _hp,
    _jax_cost_fn,
    _max_diff,
)
from test_torch_train import _seeded_params
from video_gcp_torch.core.attrdict import AttrDict, load_pickle
from video_gcp_torch.evaluation.compute_control_perf import compute_control_perf
from video_gcp_torch.models.hyperparameters import default_hparams as p_default_hparams
from video_gcp_torch.models.tree import TreeModel as PTree
from video_gcp_torch.planning import planner_policy as p_policy
from video_gcp_torch.planning import tree_optimizer as p_opt
from video_gcp_torch.planning.cem import cost_fcn as p_cost
from video_gcp_torch.planning.infra.envs.layout import define_layout
from video_gcp_torch.planning.run import ControlManager
from video_gcp_torch.planning.run import load_control_config as p_load_control_config
from video_gcp_torch.training.checkpoint import flax_to_torch
from video_gcp_tpu.core.attrdict import AttrDict as JAttrDict
from video_gcp_tpu.evaluation.compute_control_perf import (
    compute_control_perf as j_compute_control_perf,
)
from video_gcp_tpu.models.hyperparameters import default_hparams as j_default_hparams
from video_gcp_tpu.models.tree import TreeModel as JTree
from video_gcp_tpu.planning import planner_policy as j_policy
from video_gcp_tpu.planning import tree_optimizer as j_opt
from video_gcp_tpu.planning.cem import cost_fcn as j_cost
from video_gcp_tpu.planning.cem.simulator import GCPImageSimulator as JSim
from video_gcp_tpu.planning.run import load_control_config as j_load_control_config

REPO = Path(__file__).resolve().parent.parent
CONTROL = {"gcp_tree": "experiments/control/25room/gcp_tree/mod_hyper.py",
           "gcp_sequential": "experiments/control/25room/gcp_sequential/mod_hyper.py"}
START_GOAL = "experiments/data_gen/nav_9rooms_start_goal/mod_hyper.py"
IMG, L, T, NZ, WIDTH = 16, 8, 200, 8, 16  # T: the configs' max_seq_len and horizon
N_NODES = 2 ** L - 1
SMALL = dict(img_sz=IMG, ngf=4, nz_mid_lstm=WIDTH, nz_mid=WIDTH, nz_enc=WIDTH, nz_vae=NZ,
             length_pred_weight=0.0, attach_cost_mdl=True)
TOL_PLAN_CALL = 1e-5  # absolute, every output of the 'plan' call (measured ~1.2e-6)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plain(hp):
    """Class values by name: the packages' classes differ by module."""
    return {k: v.__name__ if isinstance(v, type) else _plain(v) if isinstance(v, dict)
            else v for k, v in hp.items()}


@pytest.mark.parametrize("name", list(CONTROL))
def test_planner_hparams_equal_jax(name):
    jconf = j_load_control_config(CONTROL[name])["policy"]
    pconf = p_load_control_config(CONTROL[name])["policy"]
    assert _plain(_hp(p_default_hparams, pconf["params"])) == \
        _plain(_hp(j_default_hparams, jconf["params"]))
    assert _plain(pconf["cem_params"]) == _plain(jconf["cem_params"])
    assert pconf["cem_planner"].__name__ == jconf["cem_planner"].__name__
    hp = _hp(p_default_hparams, pconf["params"])
    assert (hp["hierarchy_levels"], hp["untied_layers"], hp["max_seq_len"]) == (L, True, T)
    assert pconf["cem_params"]["horizon"] == T
    assert p_load_control_config(CONTROL[name])["agent"]["T"] == 400


def _small_params(package):
    load = p_load_control_config if package == "port" else j_load_control_config
    return dict(load(CONTROL["gcp_tree"])["policy"]["params"], **SMALL)


@pytest.fixture(scope="module")
def small():
    """The 25-room planner's model at small widths, weights from a seed,
    and the JAX simulator that every test here shares (its one compiled
    graph serves every candidate count up to 10)."""
    jmodel = JTree(hp=dict(_hp(j_default_hparams, _small_params("jax"))))
    rng = np.random.RandomState(0)
    seq = jnp.asarray(rng.rand(2, T, IMG, IMG, 3) * 2 - 1, jnp.float32)
    params = _seeded_params(jmodel, JAttrDict(  # no z: inference weights too
        traj_seq=seq, I_0=seq[:, 0], I_g=seq[:, -1], end_ind=jnp.array([T - 1, T - 1]),
        pad_mask=jnp.ones((2, T)), actions=jnp.zeros((2, T - 1, 2)),
        traj_seq_states=jnp.zeros((2, T, 2))))
    pmodel = PTree(dict(_hp(p_default_hparams, _small_params("port"))))
    pmodel.load_state_dict(flax_to_torch(params), strict=True)
    return jmodel, params, pmodel.eval(), JSim(jmodel, params, append_latent=True)


@pytest.fixture(scope="module")
def small_exp(small, tmp_path_factory):
    exp = tmp_path_factory.mktemp("small25_exp")
    (exp / "weights/weights_ep0").mkdir(parents=True)
    torch.save(dict(model=small[2].state_dict(), optimizer={}, step=0),
               exp / "weights/weights_ep0/state.pt")
    return exp


def test_untied_l8_plan_call_matches_jax(small):
    """The planner's first call: 10 candidates, each 255 injected latents,
    start and goal in the planner's [-1, 1] range, end_ind T - 1."""
    _, params, pmodel, jsim = small
    rng = np.random.RandomState(1)
    n = 10
    inputs = dict(I_0=np.repeat(rng.rand(1, IMG, IMG, 3) * 2 - 1, n, 0).astype(np.float32),
                  I_g=np.repeat(rng.rand(1, IMG, IMG, 3) * 2 - 1, n, 0).astype(np.float32),
                  start_ind=np.zeros(n, np.int32), end_ind=np.full(n, T - 1, np.int32),
                  z=rng.randn(n, N_NODES, NZ).astype(np.float32))
    jsim._pad_bucket = n  # the planner's calls share this one compiled graph
    jout = jax.device_get(jsim._run(jsim._params, JAttrDict(
        {k: jnp.asarray(v) for k, v in inputs.items()}), jax.random.PRNGKey(0)))
    with torch.inference_mode():
        pout = pmodel(AttrDict({k: torch.from_numpy(v) for k, v in inputs.items()}),
                      phase="plan", mode="prior")
    assert np.array_equal(pout.end_ind.numpy(), inputs["end_ind"])  # kept
    assert pout.tree.images.shape == (n, N_NODES, IMG, IMG, 3)
    diffs = {}
    for k in ("timeline_images", "timeline_latents", "actions", "regressed_state"):
        assert pout[k].shape == jout[k].shape, k
        diffs[k] = _max_diff(pout[k], jout[k])
    assert pout.timeline_images.shape == (n, T, IMG, IMG, 3)
    print("25-room plan call", diffs)
    assert max(diffs.values()) < TOL_PLAN_CALL, diffs


def _policies(name, small, small_exp):
    """The port's ImageCEMPolicy from the small checkpoint and the JAX
    policy's planner around the shared simulator, both with the config's
    CEM settings, the latents (action_dim) and the learned cost at the
    small widths."""
    jmodel, params, _, jsim = small
    pconf = p_load_control_config(CONTROL[name])["policy"]
    jconf = j_load_control_config(CONTROL[name])["policy"]
    cost = dict(input_dim=WIDTH, cost_params=dict(nz_mid=WIDTH))
    policy = p_policy.ImageCEMPolicy(dict(_ag_params(), T=400), dict(
        params=_small_params("port"), checkpt_path=str(small_exp),
        cem_planner=pconf["cem_planner"], closed_loop_execution=True,
        cem_params=AttrDict(pconf["cem_params"], action_dim=NZ, cost_config=AttrDict(
            cost, checkpt_path=str(small_exp)))))
    jp = j_policy.ImageCEMPolicy.__new__(j_policy.ImageCEMPolicy)
    jp._cem_planner = jconf["cem_planner"](
        dict(jconf["cem_params"], action_dim=NZ, max_seq_len=T, cost_config=dict(
            model_fn=_jax_cost_fn(params, dict(nz_mid=WIDTH)), input_dim=WIDTH)), jsim)
    return policy, jp


def _plan_inputs():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 256, (IMG, IMG, 3)).astype(np.uint8),
            rng.rand(1, IMG, IMG, 3).astype(np.float32))


def _compare_plans(policy, jp):
    assert policy.image_plan.shape == np.asarray(jp.image_plan).shape
    assert _max_diff(policy.image_plan, jp.image_plan) < TOLS["images"]
    assert _max_diff(policy.latent_plan, jp.latent_plan) < TOLS["latents"]
    assert _max_diff(policy.action_plan, jp.action_plan) < TOLS["actions"]
    assert abs(float(policy.plan_cost) - float(jp.plan_cost)) < \
        TOL_COST * max(1.0, abs(float(jp.plan_cost))) + 1e-4


def test_whole_25room_hierarchical_plan_matches_jax(small, small_exp, monkeypatch):
    """control/25room/gcp_tree: 3 iterations (layers 0 and 1 of 10
    candidates each, then the final layer's n_ll_samples), prune_final."""
    policy, jp = _policies("gcp_tree", small, small_exp)
    image, goal_image = _plan_inputs()
    logs, schedules = {}, {}
    for name, pol, mod in (("port", policy, p_opt), ("jax", jp, j_opt)):
        logs[name] = _ArgminLog()
        monkeypatch.setattr(mod, "np", logs[name])
        sim = pol._cem_planner._simulator if name == "jax" else pol._cem_simulator
        calls = schedules[name] = []
        rollout = type(sim).rollout
        monkeypatch.setattr(type(sim), "rollout", lambda s, st, g, z, n, _r=rollout, _c=calls:
                            _c.append(len(z)) or _r(s, st, g, z, n))
        np.random.seed(11)
        pol._plan(image, goal_image, 0)
    assert schedules["port"] == schedules["jax"] and schedules["port"][:2] == [10, 10]
    pcalls, jcalls = logs["port"].calls, logs["jax"].calls
    assert len(pcalls) == len(jcalls) > 3
    for p, j in zip(pcalls, jcalls):
        fin = np.isfinite(j)
        assert np.array_equal(fin, np.isfinite(p))
        diff = float(np.abs(p[fin] - j[fin]).max())
        gap = np.diff(np.sort(j[fin])[:2])
        margin = float(gap[0]) if len(gap) else np.inf
        assert margin > 2 * diff, (margin, diff)  # float error cannot decide
        assert np.argmin(p) == np.argmin(j)
    popt = policy._cem_planner._sampler._optimizer
    jopt = jp._cem_planner._sampler._optimizer
    assert np.array_equal(popt._frozen_z, jopt._frozen_z)
    assert popt._frozen_z.shape == (N_NODES, NZ)
    _compare_plans(policy, jp)


def test_whole_25room_flat_plan_matches_jax(small, small_exp, monkeypatch):
    """control/25room/gcp_sequential: the tree's 255 latents as flat
    Gaussians, one iteration of 5 candidates, elite_frac 1.0, the wrapped
    learned cost."""
    policy, jp = _policies("gcp_sequential", small, small_exp)
    image, goal_image = _plan_inputs()
    logs, nexts = {}, {}
    for name, pol, cost_mod in (("port", policy, p_cost), ("jax", jp, j_cost)):
        logs[name] = CostLog(monkeypatch, [cost_mod.ImageWrappedLearnedCostFcn])
        np.random.seed(11)
        pol._plan(image, goal_image, 0)
        nexts[name] = np.random.rand()
    assert nexts["port"] == nexts["jax"]  # the same draws, in order
    _check_rankings(logs["port"].calls, logs["jax"].calls, n_ranked=1)  # the best one
    _compare_plans(policy, jp)


def test_compute_control_perf_at_25_rooms():
    """Synthetic tasks in the 5x5 maze: some end in the goal's room, the
    rest pay max_seq_len; rooms to the goal and traversed through the 25
    rooms' doors."""
    layout = define_layout(5, None)
    rng = np.random.RandomState(0)
    data = dict(full_traj=[], reset_state=[])
    for i in range(12):
        start, goal = rng.uniform(-0.48, 0.48, (2, 2))
        end = goal + rng.uniform(-0.02, 0.02, 2) if i % 3 == 0 else rng.uniform(-0.48, 0.48, 2)
        path = np.concatenate([np.linspace(start, end, rng.randint(5, 40)),
                               np.zeros((rng.randint(5, 40), 3))[:, :2] + end])
        data["full_traj"].append(np.concatenate([path, rng.rand(len(path), 1)], 1))
        data["reset_state"].append(AttrDict(goal=np.concatenate([rng.rand(2), goal])))
    assert len({layout.coords2ridx(*t[-1][:2]) for t in data["full_traj"]}) > 3
    got = compute_control_perf(data, n_rooms=25, max_seq_len=400)
    want = j_compute_control_perf(data, n_rooms=25, max_seq_len=400)
    assert got == want
    assert 0 < got["success_rate"] < 1 and got["rooms_to_goal_mean"] > 1
    assert got != compute_control_perf(data)  # the 3x3 maze's rooms differ


# the control run's model: the config's 25-room planner (untied, L=8, 3-layer
# TreeLSTM, 32x32 frames) with narrower LSTM, decoder and latents; nz_enc and
# nz_mid stay, since the config's learned cost reads 128-wide latents with a
# 128-wide MLP; the CEM's action_dim is the latent width nz_vae
TINY_WIDTHS = {"'ngf': 16,": "'ngf': 4,", "'nz_mid_lstm': 512,": "'nz_mid_lstm': 16,",
               "'nz_vae': 256,": "'nz_vae': 8,", "action_dim=256,": "action_dim=8,"}
# env steps of the CPU task, cut from the config's 400: a _plan's four
# simulator calls decode up to 2,550 nodes of 32x32 through the logistic
# mixture, ~10 s on one CPU thread, and T=400 made 5 of them (58 s). The
# first plan ends before step TASK_T, so the closed loop runs past its end
# and replans, as the 25-room task does after its 200-frame plans
TASK_T = 120


def _copy(rel, root, replace=None):
    text = (REPO / rel).read_text()
    for old, new in (replace or {}).items():
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    dst = root / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(text)
    return dst


def test_25room_control_task_on_the_cpu(tmp_path, monkeypatch):
    """Start/goal configuration 0 of the 25-room maze from the port's PRM
    expert (nav_9rooms_start_goal's config at n_rooms 25 and T=200, as
    chip_smoke.py writes it), then task 0 of control/25room/gcp_tree on the
    CPU, TASK_T env steps, from the port's initialisation at TINY_WIDTHS."""
    monkeypatch.setenv("GCP_DATA_DIR", str(tmp_path / "data"))
    monkeypatch.setenv("GCP_EXP_DIR", str(tmp_path / "exp"))
    start_goal = _copy(START_GOAL, tmp_path, {
        "'n_rooms': 9,": "'n_rooms': 25,", "T=100,": "T=200,",
        "'/nav_9rooms/start_goal_configs'": "'/nav_25rooms/start_goal_configs'"})
    ControlManager([str(start_goal), "--device", "cpu", "--start_idx", "0", "--end_idx", "0",
                    "--seed", "0"]).run()
    confs = tmp_path / "data/nav_25rooms/start_goal_configs/raw/traj_group0/traj0"
    assert (confs / "obs_dict.pkl").is_file() and (confs / "images0/im_0.png").is_file()

    shutil.copytree(REPO / "experiments/prediction/base_configs",
                    tmp_path / "experiments/prediction/base_configs")
    control = _copy(CONTROL["gcp_tree"], tmp_path, dict(TINY_WIDTHS, **{"T=400,": f"T={TASK_T},"}))
    policy = p_load_control_config(control)["policy"]
    hp = p_default_hparams()
    hp.overwrite(dict(policy["params"], batch_size=1, attach_cost_mdl=True))
    torch.manual_seed(0)
    ckpt = Path(policy["checkpt_path"]) / "weights/weights_ep0"
    ckpt.mkdir(parents=True)
    torch.save(dict(model=PTree(dict(hp)).state_dict(), optimizer={}, step=0),
               ckpt / "state.pt")

    plans = []  # the env step of each _plan and its plan's length
    plan = p_policy.ImageCEMPolicy._plan
    monkeypatch.setattr(p_policy.ImageCEMPolicy, "_plan", lambda s, img, goal, t: (
        plan(s, img, goal, t), plans.append((t, len(s.latent_plan))))[0])
    ControlManager([str(control), "--device", "cpu", "--start_idx", "0", "--end_idx", "0",
                    "--seed", "0"]).run()
    log = control.parent / "log"
    task = load_pickle(log / "task_0.pkl")
    traj = np.asarray(task["full_traj"], np.float64)
    assert len(traj) == TASK_T + 1 and np.isfinite(traj).all()
    assert task["goal_image"].shape == (1, 32, 32, 3)
    assert len(plans) > 1 and plans[1][0] > 0 and all(n <= T + 1 for _, n in plans), plans
    with open(log / "scores_0to0.pkl", "rb") as f:
        want = j_compute_control_perf(pickle.load(f), n_rooms=25, max_seq_len=400)
    perf = compute_control_perf(load_pickle(log / "scores_0to0.pkl"), n_rooms=25,
                                max_seq_len=400)
    assert perf == want and all(np.isfinite(v) for v in perf.values())
    print(f"25-room task: {len(traj)} states, _plan at (step, plan length) {plans}, {perf}")
