"""The sequential VRNN's rollout and its CUDA graphs
(video_gcp_torch/models/loop_graph.py) where the graphs do not engage:
on the CPU, at the small widths of tests/test_torch_sequential.py, torch on
one thread. The graphed path itself runs on the card
(tests/test_torch_cuda.py); here, the equivalence it rests on:

- on the CPU, with autograd recording or under no_grad, a rollout never
  captures (the graph counters stay 0, the graph state stays empty) and the
  eager loop draws through `Gaussian.sample` once a step;
- `draw_noise` draws what per-step `Gaussian.sample` calls draw from the
  same seeded generator, in the posterior and the prior mode, and leaves
  the generator where they leave it; the loop fed that noise gives the
  eager loop's outputs bit for bit.
"""
import copy

import numpy as np
import pytest
import torch

from video_gcp_torch import tracing
from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.core.distributions import Gaussian
from video_gcp_torch.models.hyperparameters import default_hparams
from video_gcp_torch.models.loop_graph import draw_noise
from video_gcp_torch.models.sequential import SequentialModel

B, T, IMG, NZ_VAE, NZ_ENC = 2, 8, 16, 8, 32
SMALL = dict(batch_size=B, max_seq_len=T, img_sz=IMG, ngf=4, nz_mid_lstm=32,
             n_lstm_layers=2, nz_mid=32, nz_enc=NZ_ENC, nz_vae=NZ_VAE,
             one_step_planner="continuous", dense_rec_type="svg", hierarchy_levels=0,
             decoder_distribution="gaussian")
GRAPH_COUNTERS = ("rollout.graph_captures", "rollout.graph_replays")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model():
    hp = default_hparams()
    hp.overwrite(SMALL)
    torch.manual_seed(0)
    return SequentialModel(dict(hp))


def _batch():
    rng = np.random.RandomState(0)
    seq = torch.from_numpy((rng.rand(B, T, IMG, IMG, 3) * 2 - 1).astype(np.float32))
    return AttrDict(traj_seq=seq, I_0=seq[:, 0], I_g=seq[:, -1],
                    end_ind=torch.tensor([T - 1, 5]), pad_mask=torch.ones(B, T))


def _rollout_inputs(seed=1):
    """(state, x, context, x_primes, more, z) of a small rollout."""
    g = torch.Generator().manual_seed(seed)
    e_0, e_g = (torch.randn(B, NZ_ENC, generator=g) for _ in range(2))
    state = torch.randn(B, 2 * 2 * 32, generator=g)
    x_primes = torch.randn(B, T, NZ_ENC, generator=g)
    return [state, e_0, torch.cat([e_0, e_g], -1), x_primes, None, None]


@pytest.mark.parametrize("grad", [True, False])
def test_cpu_rollouts_never_capture_and_sample_once_a_step(monkeypatch, grad):
    model = _model()
    samples = []
    sample = Gaussian.sample
    monkeypatch.setattr(Gaussian, "sample",
                        lambda g, gen: samples.append(g.mu.shape) or sample(g, gen))
    before = {k: tracing.COUNTS[k] for k in GRAPH_COUNTERS + ("rollout.steps",)}
    gen = torch.Generator().manual_seed(0)
    with torch.set_grad_enabled(grad):
        for _ in range(3):
            out = model(_batch(), phase="test", mode="posterior", generator=gen)
            assert out.dense_rec.encodings.requires_grad == grad
    assert samples == [(B, NZ_VAE)] * (3 * (T - 1))
    assert {k: tracing.COUNTS[k] - v for k, v in before.items()} == {
        "rollout.graph_captures": 0, "rollout.graph_replays": 0,
        "rollout.steps": 3 * (T - 1)}
    graphs = model.rollout_graph
    assert graphs.key is None and graphs.graphs is None
    assert copy.deepcopy(model).rollout_graph is not graphs


@pytest.mark.parametrize("mode", ["posterior", "prior"])
def test_predrawn_noise_is_the_eager_draws(monkeypatch, mode):
    model = _model()
    drawn = []
    reparametrize = Gaussian.reparametrize
    monkeypatch.setattr(Gaussian, "reparametrize",
                        lambda g, eps: drawn.append(eps) or reparametrize(g, eps))
    eager_gen, noise_gen = (torch.Generator().manual_seed(7) for _ in range(2))
    with torch.no_grad():
        eager = model.rollout(*_rollout_inputs(), eps=None, mode=mode, generator=eager_gen)
        assert len(drawn) == T - 1
        noise = torch.empty(T - 1, B, NZ_VAE).unbind(0)
        draw_noise(noise_gen, noise)
        assert torch.equal(torch.stack(noise), torch.stack(drawn))
        assert torch.equal(noise_gen.get_state(), eager_gen.get_state())
        # the loop fed the pre-drawn noise (as the graph runs it) is the eager loop
        fed = model.rollout(*_rollout_inputs(), eps=noise, mode=mode, generator=None)
    for a, b in zip(eager, fed):
        assert torch.equal(a, b)
    assert len(drawn) == 2 * (T - 1)  # the fed loop reparametrizes each step's noise


def test_noise_needs_a_generator():
    """A rollout that draws without a generator is left to the eager loop,
    whose `Gaussian.sample` refuses it."""
    from video_gcp_torch.models.sequential import rollout_noise
    model = _model()
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        model.rollout_graph(model.rollout, _rollout_inputs(), model.cell, "posterior", None,
                            rollout_noise)
