"""Control benchmark metrics from planning score dumps.

Reference: gcp/evaluation/compute_control_perf.py:10-73. Reads a
`scores_*.pkl` produced by the benchmark loop, computes success rate (final
room == goal room), penalized path length (failures pay max_seq_len) and
rooms-to-goal / rooms-traversed via the BFS room planner.

CLI: python -m video_gcp_torch.evaluation.compute_control_perf --path <pkl>
        [--n_rooms 9] [--n_tasks 100] [--max_seq_len 200] [--coord_scale 1.0]
coord_scale=27 with mirrored y reproduces the reference's miniworld-frame
conversion; the native 2-D env already reports layout coordinates (scale 1).

A copy of evaluation/compute_control_perf.py of the JAX package; it reads
the score pickles of either package with the port's unpickler.
"""
from __future__ import annotations

import argparse

import numpy as np

from video_gcp_torch.core.attrdict import load_pickle
from video_gcp_torch.planning.infra.envs.layout import define_layout, plan_room_seq


def n_room_path(start, end, layout):
    return len(plan_room_seq(start, end, layout.doors))


def compute_control_perf(data, n_rooms=9, n_tasks=None, max_seq_len=200,
                         coord_scale=1.0, mirror_y=False):
    rooms_per_side = int(np.sqrt(n_rooms))
    layout = define_layout(rooms_per_side, None)
    paths = data["full_traj"]
    if n_tasks is None:
        n_tasks = len(paths)

    def convert(p):
        p = np.asarray(p[:2], np.float64) / coord_scale
        if mirror_y:
            p[1] *= -1
        return p

    success, rooms_to_goal, rooms_traversed = 0, [], []
    penalized_length = 0.0
    for i in range(n_tasks):
        reset = data["reset_state"][i]
        goal_pos = convert(np.asarray(reset["goal"])[-2:])
        final_pos = convert(paths[i][-1])
        start_pos = convert(paths[i][0])
        goal_room = layout.coords2ridx(goal_pos[0], goal_pos[1])
        final_room = layout.coords2ridx(final_pos[0], final_pos[1])
        start_room = layout.coords2ridx(start_pos[0], start_pos[1])

        if final_room == goal_room:
            success += 1
        path = np.stack([convert(p) for p in paths[i]])
        path_len = np.sum(np.linalg.norm(path[1:] - path[:-1], axis=-1))
        penalized_length += path_len if final_room == goal_room else max_seq_len

        rooms_to_goal.append(n_room_path(final_room, goal_room, layout))
        rooms_traversed.append(n_room_path(start_room, final_room, layout))

    return dict(
        success_rate=success / n_tasks,
        penalized_cost=penalized_length / n_tasks,
        rooms_to_goal_mean=float(np.mean(rooms_to_goal)),
        rooms_to_goal_std=float(np.std(rooms_to_goal)),
        rooms_traversed_mean=float(np.mean(rooms_traversed)),
        rooms_traversed_std=float(np.std(rooms_traversed)),
    )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--path", required=True, help="path to scores pkl")
    p.add_argument("--n_rooms", default=9, type=int)
    p.add_argument("--n_tasks", default=None, type=int)
    p.add_argument("--max_seq_len", default=200, type=int)
    p.add_argument("--coord_scale", default=1.0, type=float)
    p.add_argument("--mirror_y", default=0, type=int)
    args = p.parse_args()
    data = load_pickle(args.path)
    res = compute_control_perf(data, args.n_rooms, args.n_tasks,
                               args.max_seq_len, args.coord_scale,
                               bool(args.mirror_y))
    print(f"Success: \t{res['success_rate']}")
    print(f"Cost: \t{res['penalized_cost']:.2f}")
    print("")
    print(f"Room2Goal: \t{res['rooms_to_goal_mean']}\t{res['rooms_to_goal_std']}")
    print(f"RTravers: \t{res['rooms_traversed_mean']}\t{res['rooms_traversed_std']}")


if __name__ == "__main__":
    main()
