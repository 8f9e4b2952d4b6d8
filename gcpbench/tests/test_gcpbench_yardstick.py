"""The yardstick's arithmetic against shapes worked by hand, and each
configuration's FLOP count against FlopCounterMode on the reference."""
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gcpbench import generate, yardstick
from gcpbench.reference import model as ref
from gcpbench.tests.conftest import ROOT, TINY


def test_k1_k2_bounds_at_the_decoders_top_site():
    # [2032, 32, 32, 16] f32: K1 reads x and writes y (2 x 133,169,152 bytes)
    # plus scale and bias (128 bytes); K2 reads x and dy and writes dx, plus
    # the parameters and their gradients (256 bytes)
    shape = (2032, 32, 32, 16)
    assert yardstick.k1_bound_s(shape) == pytest.approx(266_338_432 / 3.35e12)
    assert yardstick.k2_bound_s(shape) == pytest.approx(399_507_712 / 3.35e12)
    # in float32 the bytes always bound it: 10 operations an element take
    # less time than its 8 bytes
    assert yardstick.k1_bound_s((1, 1, 1, 16)) == pytest.approx(256 / 3.35e12)


def test_train_sites_of_the_two_trees():
    hp = dict(img_sz=32, ngf=16, hierarchy_levels=7)
    sites = yardstick.train_gn_sites(hp, 16, 100)
    assert len(sites) == 20
    assert sites[0] == (1600, 16, 16, 16) and sites[5] == (16, 16, 16, 16)
    assert sites[-1] == (16 * 127, 32, 32, 16)
    # the 500-frame tree's summed bounds, as PERF.md's K1/K2 table has them
    hp["hierarchy_levels"] = 9
    sites = yardstick.train_gn_sites(hp, 16, 500)
    assert sum(map(yardstick.k1_bound_s, sites)) * 1e3 == pytest.approx(0.6221, abs=1e-4)
    assert sum(map(yardstick.k2_bound_s, sites)) * 1e3 == pytest.approx(0.9331, abs=1e-4)


def test_dtw_bytes():
    # C [16, 511, 500] f32 read once, 16 x 500 int64 matches written
    assert yardstick.dtw_bytes(16, 511, 500) == 16_352_000 + 64_000


def test_leaf_gap_and_moving_leaves():
    ref_n = {"a": 1.0, "b": 2.0, "c": 1e-9}
    assert yardstick.moving_leaves(ref_n) == ["a", "b"]
    # c's gap is measured against the median leaf's norm, not its own
    assert yardstick.leaf_gap({"a": 1.0, "b": 2.0, "c": 1e-6}, ref_n) == pytest.approx(1e-6 - 1e-9)
    assert yardstick.leaf_gap({"a": 1.1, "b": 2.0, "c": 0.0}, ref_n, ["a", "b"]) == \
        pytest.approx(0.1 / 1.5)


def _count(hp, batch: int) -> tuple:
    torch.manual_seed(0)
    model = ref.build(hp, "cpu").train()
    mix = dict(seq_len=hp["max_seq_len"], batch=batch, pool_batches=1)
    data = generate.sequences(mix, hp["img_sz"], batch, 0, "cpu")
    with FlopCounterMode(display=False) as fc:
        out = model(ref.AttrDict(data), phase="train", mode="posterior",
                    generator=torch.Generator().manual_seed(0), step=0)
        out.losses.total.value.backward()
    train = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(ref.AttrDict({k: data[k] for k in ("I_0", "I_g", "end_ind")}), phase="test",
              mode="prior", generator=torch.Generator().manual_seed(0))
    return train, fc.get_total_flops()


@pytest.mark.parametrize("name", ["gcp_tree.9room", "gcp_tree.25room_long"])
def test_flops_per_example_are_linear_in_the_batch(name):
    hp = dict(json.loads((ROOT / f"gcpbench/configs/{name}.json").read_text())["hparams"],
              **TINY)
    one, two = _count(hp, 1), _count(hp, 2)
    assert two == (2 * one[0], 2 * one[1])


@pytest.mark.parametrize("name", ["gcp_tree.9room", "gcp_tree.25room_long"])
def test_stored_flops_are_the_references_count(name):
    config = json.loads((ROOT / f"gcpbench/configs/{name}.json").read_text())
    train, prior = _count(config["hparams"], 1)
    assert config["flops"] == {"train_step_per_example": train,
                               "prior_forward_per_example": prior}
