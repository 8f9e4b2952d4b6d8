"""Per-worker trajectory loop + score aggregation.

Reference: gcp/planning/infra/sim/benchmarks.py:10-87 + util/combine_score.py.
A copy of planning/infra/sim/benchmarks.py of the JAX package; it reads
task and score pickles of either package with the port's unpickler.
"""
from __future__ import annotations

import glob
import os
import pickle
from collections import OrderedDict

import numpy as np

from video_gcp_torch.core.attrdict import load_pickle


def heartbeat() -> None:
    """Touch $GCP_HEARTBEAT, when it is set, so that an external watchdog can
    tell slow progress from a hung run."""
    path = os.environ.get("GCP_HEARTBEAT")
    if path:
        try:
            with open(path, "a"):
                os.utime(path, None)
        except OSError:
            pass

from video_gcp_torch.planning.infra.agent.general_agent import BenchmarkAgent
from video_gcp_torch.planning.infra.sim.simulator import Sim


def run_trajectories(conf=None, iex=-1, gpu_id=None, ngpu=1):
    log_dir = conf["log_dir"]
    sim = Sim(conf, gpu_id=gpu_id, ngpu=ngpu)

    if iex == -1:
        i_traj = conf["start_index"]
        nruns = conf["end_index"]
    else:
        i_traj = nruns = iex

    stats_lists = OrderedDict()
    result_file = os.path.join(
        log_dir, f"results_{conf['start_index']}to{conf['end_index']}.txt"
    )
    pkl_file = os.path.join(
        log_dir, f"scores_{conf['start_index']}to{conf['end_index']}.pkl"
    )

    # Per-task score files make benchmark runs stall-resilient: a crashed or
    # killed run resumes at the first task without a task_{i}.pkl, paying one
    # task, not the whole range. Benchmark-only: for data generation the h5
    # trajectory is the product, so skipping take_sample would skip saving it.
    # Both packages log beside the same config, so a task the JAX package ran
    # is refused rather than reported as the port's.
    benchmark = isinstance(sim.agent, BenchmarkAgent)
    while i_traj <= nruns:
        heartbeat()
        task_file = os.path.join(log_dir, f"task_{i_traj}.pkl")
        if benchmark and os.path.isfile(task_file):
            try:
                agent_data = load_pickle(task_file, allow_jax=False)
            except pickle.UnpicklingError as e:
                raise RuntimeError(
                    f"{e}; run the port from a copy of the config, or move "
                    f"{log_dir} away") from None
        else:
            agent_data = sim.take_sample(i_traj)
            if agent_data is None:
                i_traj += 1
                continue
            agent_data.pop("demo_images", None)
            if benchmark:
                with open(task_file, "wb") as f:
                    pickle.dump(agent_data, f)
        stat_arrays = OrderedDict()
        for key in agent_data.keys():
            stats_lists.setdefault(key, []).append(agent_data[key])
            try:
                stat_arrays[key] = np.array(stats_lists[key])
            except Exception:
                stat_arrays[key] = stats_lists[key]
        i_traj += 1
        with open(pkl_file, "wb") as f:
            pickle.dump(stat_arrays, f)
        if isinstance(sim.agent, BenchmarkAgent) and "improvement" in stat_arrays:
            write_scores(conf, result_file, stat_arrays, i_traj)
    sim.flush()


def write_scores(conf, result_file, stat, i_traj=None):
    """Benchmark stats text dump (combine_score.py:11-60)."""
    improvement = np.asarray(stat["improvement"])
    final_dist = np.asarray(stat["final_dist"])
    initial_dist = np.asarray(stat["initial_dist"]) if "initial_dist" in stat else None
    sorted_ind = improvement.argsort(0)[::-1]

    mean_imp, med_imp = np.mean(improvement), np.median(improvement)
    mean_dist, med_dist = np.mean(final_dist), np.median(final_dist)
    n = max(final_dist.shape[0], 1)

    os.makedirs(os.path.dirname(result_file) or ".", exist_ok=True)
    with open(result_file, "w") as f:
        f.write(f"standard error of the mean (SEM) {np.std(final_dist) / np.sqrt(n)}\n")
        f.write("---\n")
        f.write(f"overall best pos improvement: {improvement[sorted_ind[0]]} of traj {sorted_ind[0]}\n")
        f.write(f"overall worst pos improvement: {improvement[sorted_ind[-1]]} of traj {sorted_ind[-1]}\n")
        f.write(f"average pos improvemnt: {mean_imp}\n")
        f.write(f"median pos improvement {med_imp}\n")
        f.write(f"standard deviation of population {np.std(improvement)}\n")
        f.write(f"standard error of the mean (SEM) {np.std(improvement) / np.sqrt(n)}\n")
        f.write("---\n")
        f.write(f"average pos score: {mean_dist}\n")
        f.write(f"median pos score {med_dist}\n")
        f.write("---\n")
        f.write(f"mean imp, med imp, mean dist, med dist {mean_imp}, {med_imp}, {mean_dist}, {med_dist}\n")
        if initial_dist is not None:
            f.write("---\n")
            f.write(f"average initial dist: {np.mean(initial_dist)}\n")
            f.write(f"median initial dist: {np.median(initial_dist)}\n")
        f.write("----------------------\n")
        f.write("traj: improv, final_d, rank\n")
        f.write("----------------------\n")
        for rank, idx in enumerate(sorted_ind):
            f.write(f"{idx}: {improvement[idx]}, {final_dist[idx]}, {rank}\n")


def combine_scores(log_dir, out_file="results_combined.txt"):
    """Merge per-worker score pkls (combine_score.py:combine_scores)."""
    pkls = sorted(glob.glob(os.path.join(log_dir, "scores_*.pkl")))
    combined = OrderedDict()
    for p in pkls:
        stat = load_pickle(p)
        for k, v in stat.items():
            if isinstance(v, np.ndarray):
                combined.setdefault(k, []).append(v)
    combined = {k: np.concatenate(v) for k, v in combined.items()}
    if "improvement" in combined:
        write_scores({}, os.path.join(log_dir, out_file), combined)
    with open(os.path.join(log_dir, "scores_combined.pkl"), "wb") as f:
        pickle.dump(combined, f)
    return combined


def main():
    """CLI: python -m video_gcp_torch.planning.infra.sim.benchmarks <log_dir>
    merges per-worker score pkls (combine_score.py __main__)."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("log_dir")
    args = p.parse_args()
    combined = combine_scores(args.log_dir)
    if "improvement" in combined:
        print(f"mean improvement: {np.mean(combined['improvement']):.4f}")
        print(f"mean final dist:  {np.mean(combined['final_dist']):.4f}")


if __name__ == "__main__":
    main()
