"""The GCP tree's level loop and its CUDA graphs
(video_gcp_torch/models/loop_graph.py) where the graphs do not engage: on the
CPU, at small widths (tied, untied and attentive trees), torch on one
thread. The graphed path itself runs on the card (tests/test_torch_cuda.py);
here, the equivalence it rests on and the calls it must leave alone:

- the loop fed noise pre-drawn by `draw_noise` into the buffers the graph
  reads gives the eager loop's outputs bit for bit, draws what the eager
  levels' `Gaussian.sample` calls draw, and leaves the generator where they
  leave it;
- CPU, no_grad, prior-mode and injected-z forwards never capture and leave
  the graph counters as they are; with the key forced (as on a card),
  prior-mode and injected-z calls still run eagerly and only a posterior
  training call warms up;
- the key moves when any parameter of any level module moves (untied);
- a tree or a VRNN that FSDP2 split runs its loop eagerly, even where the
  key is forced, since FSDP gathers the parameters the loop reads anew in
  every step.
"""
import copy

import numpy as np
import pytest
import torch

from video_gcp_torch import tracing
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.distributions import Gaussian
from video_gcp_torch.models import loop_graph
from video_gcp_torch.models.hyperparameters import default_hparams
from video_gcp_torch.models.loop_graph import draw_noise, signature
from video_gcp_torch.models.sequential import SequentialModel
from video_gcp_torch.models.tree import TreeModel

B, T, IMG, NZ_VAE = 2, 10, 16, 8
BALANCED = dict(batch_size=B, max_seq_len=T, img_sz=IMG, hierarchy_levels=3, nz_enc=16,
                nz_vae=NZ_VAE, nz_mid=16, nz_mid_lstm=16, ngf=4, matching_type="balanced",
                seq_enc="conv", tree_lstm="split_linear", lstm_init="mlp",
                decoder_distribution="gaussian")
VARIANTS = {
    "tied": BALANCED,
    "untied": dict(BALANCED, untied_layers=True),
    "attentive": dict(BALANCED, hierarchy_levels=4, matching_type="dtw_image",
                      attentive_inference=True, learn_matching_temp=False, tree_lstm="sum"),
}
GRAPH_COUNTERS = ("tree_graph.captures", "tree_graph.replays")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(variant):
    hp = default_hparams()
    hp.overwrite(VARIANTS[variant])
    torch.manual_seed(0)
    return TreeModel(dict(hp)).train()


def _batch():
    rng = np.random.RandomState(0)
    seq = torch.from_numpy((rng.rand(B, T, IMG, IMG, 3) * 2 - 1).astype(np.float32))
    return AttrDict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[:, -1],
                    end_ind=torch.tensor([T - 1, 6]), pad_mask=torch.ones(B, T))


def _level_inputs(model):
    inputs = model.run_encoder(model.preprocess_inputs(_batch()))
    return model.level_inputs(inputs, inputs.end_ind)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_predrawn_noise_is_the_eager_draws(monkeypatch, variant):
    model = _model(variant)
    drawn = []
    reparametrize = Gaussian.reparametrize
    monkeypatch.setattr(Gaussian, "reparametrize",
                        lambda g, eps: drawn.append(eps) or reparametrize(g, eps))
    eager_gen, noise_gen = (torch.Generator().manual_seed(7) for _ in range(2))
    with torch.no_grad():
        region = _level_inputs(model)
        eager = model.level_loop(*region, eps=None, mode="posterior", generator=eager_gen)
        depth = model.depth
        assert len(drawn) == depth
        noise = model.level_noise(eager)
        assert [tuple(n.shape) for n in noise] == [(B, 2 ** d, NZ_VAE) for d in range(depth)]
        draw_noise(noise_gen, noise)
        for a, b in zip(noise, drawn):
            assert torch.equal(a, b)
        assert torch.equal(noise_gen.get_state(), eager_gen.get_state())
        # the loop fed the pre-drawn noise (as the graph runs it) is the eager loop
        fed = model.level_loop(*region, eps=noise, mode="posterior", generator=None)
    assert len(fed) == len(eager) == (8 if variant == "attentive" else 7)
    for a, b in zip(eager, fed):
        assert torch.equal(a, b)
    assert len(drawn) == 2 * depth  # the fed loop reparametrizes each level's noise


CALLS = {
    "cpu_grad": dict(grad=True, phase="train", mode="posterior"),
    "no_grad": dict(grad=False, phase="train", mode="posterior"),
    "prior": dict(grad=True, phase="test", mode="prior"),
    "injected_z": dict(grad=True, phase="test", mode="posterior", z=True),
}


def _forward(model, call, gen):
    batch = _batch()
    if call.get("z"):
        batch.z = torch.randn(B, 2 ** model.depth - 1, NZ_VAE, generator=gen)
    with torch.set_grad_enabled(call["grad"]):
        return model(batch, phase=call["phase"], mode=call["mode"], generator=gen)


@pytest.mark.parametrize("call", list(CALLS))
def test_calls_off_the_graph_path_never_capture(call):
    model = _model("untied")
    before = {k: tracing.COUNTS[k] for k in GRAPH_COUNTERS}
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        out = _forward(model, CALLS[call], gen)
        assert out.tree.e_g_prime.requires_grad == CALLS[call]["grad"]
    assert {k: tracing.COUNTS[k] - v for k, v in before.items()} == dict.fromkeys(
        GRAPH_COUNTERS, 0)
    graphs = model.level_graph
    assert graphs.key is None and graphs.graphs is None and graphs.noise is None
    assert copy.deepcopy(model).level_graph is not graphs


@pytest.mark.parametrize("call", ["cpu_grad", "prior", "injected_z"])
def test_only_posterior_training_calls_reach_the_key(monkeypatch, call):
    """With the key forced, as a card's would be, one call: prior-mode and
    injected-z calls stay eager and leave the graph state empty; a
    posterior call with autograd recording is the warm-up, which keeps the
    noise buffers of the next call."""
    monkeypatch.setattr(loop_graph, "_key", lambda inputs, module, mode: ("key", mode))
    model = _model("untied")
    before = {k: tracing.COUNTS[k] for k in GRAPH_COUNTERS}
    _forward(model, CALLS[call], torch.Generator().manual_seed(0))
    graphs = model.level_graph
    if CALLS[call].get("z") or CALLS[call]["mode"] == "prior":
        assert graphs.key is None and graphs.noise is None
    else:
        assert graphs.key == ("key", "posterior") and graphs.graphs is None
        assert [tuple(n.shape) for n in graphs.noise] == [
            (B, 2 ** d, NZ_VAE) for d in range(model.depth)]
    assert {k: tracing.COUNTS[k] - v for k, v in before.items()} == dict.fromkeys(
        GRAPH_COUNTERS, 0)


@pytest.mark.parametrize("level", range(VARIANTS["untied"]["hierarchy_levels"]))
def test_the_key_moves_with_any_level_parameter(level):
    model = _model("untied")
    assert len(model.tree_levels) == model.depth
    with torch.no_grad():
        region = _level_inputs(model)
    key = signature(region, model.tree_levels, "posterior")
    assert signature(region, model.tree_levels, "posterior") == key
    assert signature(region, model.tree_levels, "prior") != key
    params = list(model.tree_levels[level].parameters())
    weight = params[len(params) // 2]
    weight.data = weight.data.clone()  # the same values in new storage
    moved = signature(region, model.tree_levels, "posterior")
    assert moved != key
    weight.requires_grad_(False)
    assert signature(region, model.tree_levels, "posterior") not in (key, moved)
    # each input's shape enters the key too
    wider = [None if t is None else torch.cat([t, t]) for t in region]
    weight.requires_grad_(True)
    assert signature(wider, model.tree_levels, "posterior") != moved


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A one-rank gloo process group and its mesh, for FSDP2 on the CPU."""
    import torch.distributed as dist
    from video_gcp_torch.parallel.mesh import make_mesh
    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "store"),
                            rank=0, world_size=1)
    try:
        yield make_mesh(1, device_type="cpu")
    finally:
        dist.destroy_process_group()


VRNN = dict(batch_size=B, max_seq_len=T, img_sz=IMG, ngf=4, nz_mid_lstm=16, n_lstm_layers=2,
            nz_mid=16, nz_enc=16, nz_vae=NZ_VAE, one_step_planner="continuous",
            dense_rec_type="svg", hierarchy_levels=0, decoder_distribution="gaussian")


@pytest.mark.parametrize("kind", ["tree", "sequential"])
def test_a_model_that_fsdp_split_runs_its_loop_eagerly(monkeypatch, one_rank_mesh, kind):
    """With the key forced, as a card's would be: a posterior training
    forward of the model warms its loop's graphs up; once FSDP2 has split
    the model (every parameter but the scalars a DTensor between steps,
    gathered into plain tensors for each forward) the same forward leaves them empty."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import DTensor
    monkeypatch.setattr(loop_graph, "_key", lambda inputs, module, mode: ("key", mode))
    if kind == "tree":
        model = _model("untied")
    else:
        hp = default_hparams()
        hp.overwrite(VRNN)
        torch.manual_seed(0)
        model = SequentialModel(dict(hp)).train()
    graphs = model.level_graph if kind == "tree" else model.rollout_graph
    call = CALLS["cpu_grad"]
    _forward(model, call, torch.Generator().manual_seed(0))
    assert graphs.key == ("key", "posterior") and graphs.noise is not None
    graphs.key = graphs.noise = None
    scalars = {p for p in model.parameters() if p.dim() == 0}  # FSDP2 splits none
    fully_shard(model, mesh=one_rank_mesh, ignored_params=scalars)
    assert loop_graph.sharded(model)
    assert all(isinstance(p, DTensor) for p in model.parameters() if p not in scalars)
    before = {k: tracing.COUNTS[k] for k in GRAPH_COUNTERS}
    for seed in range(2):
        out = _forward(model, call, torch.Generator().manual_seed(seed))
        out.losses.total.value.backward()
    assert graphs.key is None and graphs.graphs is None and graphs.noise is None
    assert {k: tracing.COUNTS[k] - v for k, v in before.items()} == dict.fromkeys(
        GRAPH_COUNTERS, 0)
