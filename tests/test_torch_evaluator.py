"""The port's top-of-100 Evaluator (video_gcp_torch/evaluation/evaluator.py)
against the JAX package's Evaluator, on the CPU.

- One sampled forward plus its metrics: the 9-room GCP-tree at full width
  with the ep74 weights on 2 examples, with injected z (torch cannot replay
  JAX's random stream), the 'basic' scheme. Dense prediction and all nodes
  within 2e-4 (the f32 image tolerance of tests/test_torch_tree.py), the
  per-sequence metrics within 1e-4 relative to max(1, |value|).
- The protocol's bookkeeping on a stub model whose output depends only on
  the sample's index, on both sides: the JAX stub finds the index of the
  key it is given in the table of keys its Evaluator draws, the port's
  counts its calls. Every sample's metrics (1e-5 relative), the best
  sample per sequence, the summary, results_{it}.txt, the printed CSV line
  and the channel-first .npy dumps (names, shapes and values) agree.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gcp_torch.core.attrdict import AttrDict
from video_gcp_torch.evaluation.eval_logger import FileEvalLogger, TBEvalLogger
from video_gcp_torch.evaluation.evaluator import Evaluator
from video_gcp_torch.load import load_model
from video_gcp_torch.training.logger import Logger
from video_gcp_tpu.core.attrdict import AttrDict as JAttrDict
from video_gcp_tpu.evaluation.evaluator import Evaluator as JEvaluator

from test_torch_tree import CONF, WEIGHTS, _jax_ep74

IMG_TOL = 2e-4
METRIC_TOL = 1e-4
STUB_TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())


def test_ep74_sample_and_metrics_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    b, t = 2, 100
    traj = rng.randint(0, 256, (b, t, 32, 32, 3)).astype(np.uint8)
    end = np.array([99, 60])
    batch = dict(traj_seq=traj, I_0=traj[:, 0], I_g=traj[np.arange(b), end],
                 end_ind=end, pad_mask=(np.arange(t)[None] <= end[:, None]).astype(np.float32),
                 z=rng.randn(b, 127, 256).astype(np.float32))
    tmodel = load_model(CONF, weights=WEIGHTS, device="cpu")
    ev = Evaluator(tmodel, str(tmp_path / "t"), {}, t, "basic")
    t_in = AttrDict({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    t_in.traj_seq = t_in.traj_seq.float() / 127.5 - 1.0
    m, gen, full = ev._eval_sample(t_in, None)

    jmodel, params = _jax_ep74()
    j_ev = JEvaluator(jmodel, str(tmp_path / "j"), {}, t, "basic")
    j_batch = JAttrDict({k: jnp.asarray(v.astype(np.int32) if k == "end_ind" else v)
                         for k, v in batch.items()})
    j_m, j_gen, j_full = j_ev._eval_sample(params, j_batch, jax.random.PRNGKey(0))
    assert gen.shape == (b, t, 32, 32, 3) and full.shape == (b, 127, 32, 32, 3)
    assert np.abs(gen.numpy() - np.asarray(j_gen)).max() < IMG_TOL
    assert np.abs(full.numpy() - np.asarray(j_full)).max() < IMG_TOL
    for k in ("mse", "psnr", "ssim"):
        assert m[k].shape == (b,)
        assert _rel(m[k].numpy(), j_m[k]) < METRIC_TOL, (k, m[k], j_m[k])


# ---------------------------------------------------------------------------
# the protocol's bookkeeping on a stub model
# ---------------------------------------------------------------------------

B, T, DEPTH, IMG, TOP_OF = 3, 12, 4, 16, 100
N_RAND = Evaluator.N_PLOTTED_ELEMENTS


def _stub_data():
    rng = np.random.RandomState(11)
    n = 2 ** DEPTH - 1
    traj = (rng.rand(B, T, IMG, IMG, 3) * 2 - 1).astype(np.float32)
    # the nodes of sample s: GT-like frames plus noise of a per-sample scale
    base = np.repeat(traj[:, :1], n, 1)
    scale = rng.rand(TOP_OF + N_RAND, B, 1, 1, 1, 1) * 0.8
    noise = rng.randn(TOP_OF + N_RAND, B, n, IMG, IMG, 3)
    table = np.clip(base[None] + scale * noise, -1, 1).astype(np.float32)
    keep = rng.rand(B, n) < 0.5
    keep[:, 0] = True
    end = np.array([T - 1, 7, 4])
    batch = dict(traj_seq=traj, I_0=traj[:, 0], I_g=traj[np.arange(B), end], end_ind=end,
                 pad_mask=(np.arange(T)[None] <= end[:, None]).astype(np.float32))
    return table, keep, batch


class TorchStub:
    """Sample index = number of calls so far."""

    def __init__(self, table, keep):
        self.table, self.keep, self.calls = table, keep, 0

    def __call__(self, inputs, phase, mode, generator=None):
        assert (phase, mode) == ("test", "prior") and set(inputs) <= {
            "I_0", "I_g", "end_ind", "start_ind", "z"}
        images = torch.from_numpy(self.table[self.calls])
        self.calls += 1
        return AttrDict(tree=AttrDict(images=images), end_ind=inputs.end_ind,
                        prune_keep=torch.from_numpy(self.keep))


class JaxStub:
    """Sample index = row of the table of keys the JAX Evaluator draws."""

    def __init__(self, table, keep, rng):
        keys = [jax.random.split(jax.random.fold_in(rng, s), 20) for s in range(0, TOP_OF, 20)]
        keys += [jax.random.fold_in(rng, 10_000 + i)[None] for i in range(N_RAND)]
        self.keys = jnp.concatenate(keys, 0)
        self.table, self.keep = jnp.asarray(table), jnp.asarray(keep)

    def apply(self, params, inputs, phase, mode, pred_length=False, rngs=None):
        idx = jnp.argmax(jnp.all(self.keys == rngs["sample"][None], axis=1))
        return JAttrDict(tree=JAttrDict(images=self.table[idx]), end_ind=inputs.end_ind,
                         prune_keep=self.keep)


def _numbers(text):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e-?\d+)?", text)]


@pytest.mark.parametrize("scheme", ["basic", "pruned_dtw"])
def test_top_of_100_bookkeeping_and_dumps_match_jax(tmp_path, capsys, scheme):
    table, keep, batch = _stub_data()
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    ev = Evaluator(TorchStub(table, keep), str(tdir), {}, T, scheme)
    res = ev.eval(AttrDict({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}),
                  torch.Generator())
    rng = jax.random.PRNGKey(7)
    j_ev = JEvaluator(JaxStub(table, keep, rng), str(jdir), {}, T, scheme)
    j_res = j_ev.eval({}, JAttrDict({k: jnp.asarray(v) for k, v in batch.items()}), rng)

    for k in ("mse", "psnr", "ssim"):
        assert res.metrics[k].shape == (B, TOP_OF)
        assert _rel(res.metrics[k], j_res.metrics[k]) < STUB_TOL, k
    best = res.metrics["mse"].argmin(1)
    assert len(set(best)) > 1  # the best sample differs between sequences
    for k in ("best_gen", "best_full", "gt_seq"):
        np.testing.assert_array_equal(res[k], j_res[k], err_msg=k)
    assert len(res.rand_seqs) == N_RAND
    for a, b in zip(res.rand_seqs, j_res.rand_seqs):
        np.testing.assert_array_equal(a, b)
    # the best sample is no worse than any sample, per sequence
    assert (res.metrics["mse"].min(1) == res.metrics["mse"][np.arange(B), best]).all()

    capsys.readouterr()
    summary = ev.dump_results(3)
    t_csv = capsys.readouterr().out.strip().splitlines()[-1]
    j_summary = j_ev.dump_results(3)
    j_csv = capsys.readouterr().out.strip().splitlines()[-1]
    assert summary.keys() == j_summary.keys()
    assert _rel([summary[k] for k in summary], [j_summary[k] for k in summary]) < STUB_TOL
    assert len(t_csv.split(",")) == len(j_csv.split(",")) == 9
    assert _rel([float(x) for x in t_csv.split(",")],
                [float(x) for x in j_csv.split(",")]) < STUB_TOL
    t_txt = (tdir / "metrics/results_3.txt").read_text()
    j_txt = (jdir / "metrics/results_3.txt").read_text()
    assert re.sub(r"-?\d[\d.e+-]*", "#", t_txt) == re.sub(r"-?\d[\d.e+-]*", "#", j_txt)
    assert np.abs(np.array(_numbers(t_txt)) - _numbers(j_txt)).max() <= 2e-6

    names = sorted(f for f in os.listdir(jdir / "metrics") if f.endswith(".npy"))
    assert names == ["full_gen_seq_3.npy", "gen_images_3.npy", "gt_seq_3.npy",
                     "seq_samples_3.npy"]
    assert sorted(f for f in os.listdir(tdir / "metrics") if f.endswith(".npy")) == names
    for f in names:
        got, want = np.load(tdir / "metrics" / f), np.load(jdir / "metrics" / f)
        assert got.shape == want.shape and got.shape[-3] == 3, f  # [.., C, H, W]
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert np.load(tdir / "metrics/gt_seq_3.npy").shape == (B, T - 1, 3, IMG, IMG)
    assert len(os.listdir(tdir / "metrics/gt_vs_best/it_3")) == B  # the strips
    assert ev.full_evaluation is None  # reset for the next evaluation


def test_tb_eval_logger_writes_scalars_images_and_gifs(tmp_path):
    logger = Logger(str(tmp_path / "events"))
    ev_logger = TBEvalLogger(str(tmp_path / "metrics"), logger)
    vals = np.random.RandomState(0).rand(4, 10)
    ev_logger.log_metric("mse", vals, vals.min(1), 7)
    ev_logger.log_image(np.zeros((8, 24, 3)), "gt_vs_best", 0, 7)
    ev_logger.log_gif(np.zeros((5, 8, 8, 3)), "best_gen", 0, 7)
    logger.close()
    import json
    records = [json.loads(line) for line in open(tmp_path / "events/events.jsonl")]
    tags = [r["tag"] for r in records]
    assert tags[:4] == ["_eval/metric/mse/top10_mean", "_eval/verbose/mse/top10_std",
                        "_eval/verbose/mse/all10_mean", "_eval/verbose/mse/all10_std"]
    for r, ext in zip(records[4:], ("png", "gif")):
        assert r["step"] == 7 and r["file"].endswith(ext)
        assert (tmp_path / "events" / r["file"]).stat().st_size > 0
    assert isinstance(FileEvalLogger(str(tmp_path / "f")), FileEvalLogger)
