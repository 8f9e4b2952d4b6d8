"""Probabilistic roadmap planning: KD-tree roadmap + Dijkstra search.

Reference: gcp/planning/infra/policy/prm_policy/prm.py (a PythonRobotics
fork). Fresh implementation on scipy.cKDTree with vectorized edge collision
checks: sample points (incl. start/goal), connect k-NN edges that clear the
wall point cloud by the robot radius, run Dijkstra with a configurable edge
cost.

A numpy copy of planning/infra/policy/prm_policy/prm.py of the JAX package.
"""
from __future__ import annotations

import heapq

import numpy as np
from scipy.spatial import cKDTree


def is_collision(p, q, rr, obstacle_tree, max_edge_len):
    """Edge (p -> q) collides if any interpolated point is within rr of an
    obstacle or the edge exceeds max_edge_len."""
    d = np.linalg.norm(q - p)
    if d > max_edge_len:
        return True
    n_steps = max(int(np.ceil(d / rr)), 1)
    pts = p[None] + (q - p)[None] * np.linspace(0, 1, n_steps + 1)[:, None]
    dists, _ = obstacle_tree.query(pts)
    return bool((dists <= rr).any())


def edges_collide(starts, ends, rr, obstacle_tree, max_edge_len):
    """Batched edge collision: [E, 2] start/end points -> [E] bool.

    All edges are sampled at a uniform resolution finer than rr (the
    per-edge spacing is length/ceil(max_edge_len/rr) <= rr), so the check is
    at least as strict as the reference's per-edge rr-spaced walk, with ONE
    KD-tree query for the whole batch instead of one per edge."""
    lengths = np.linalg.norm(ends - starts, axis=1)
    too_long = lengths > max_edge_len
    n_pts = max(int(np.ceil(max_edge_len / rr)) + 1, 2)
    ts = np.linspace(0.0, 1.0, n_pts)
    # [E, n_pts, 2]
    pts = starts[:, None, :] + (ends - starts)[:, None, :] * ts[None, :, None]
    dists, _ = obstacle_tree.query(pts.reshape(-1, 2))
    hits = (dists.reshape(len(starts), n_pts) <= rr).any(axis=1)
    return hits | too_long


def generate_roadmap(sample_x, sample_y, rr, obstacle_tree, params):
    """k-NN roadmap over the samples (prm.py:125-160), batched: the k-NN
    candidate edges for every node are collision-checked in a single
    vectorized query."""
    pts = np.stack([sample_x, sample_y], axis=1)
    n = len(pts)
    tree = cKDTree(pts)
    k = min(params["n_knn"] + 1, n)
    _, idxs = tree.query(pts, k=k)
    idxs = np.atleast_2d(idxs)
    src = np.repeat(np.arange(n), k - 1)
    dst = idxs[:, 1:].reshape(-1)
    collide = edges_collide(pts[src], pts[dst], rr, obstacle_tree,
                            params["max_edge_len"])
    road_map = [[] for _ in range(n)]
    for i, j, bad in zip(src, dst, collide):
        if not bad:
            road_map[i].append(int(j))
    return road_map


def dijkstra_planning(sx, sy, gx, gy, road_map, sample_x, sample_y, cost_fcn):
    """Dijkstra over the roadmap; start = index -2, goal = index -1
    (appended last by sample ordering below). Returns (path_x, path_y,
    success)."""
    n = len(sample_x)
    start, goal = n - 2, n - 1
    dist = np.full(n, np.inf)
    parent = np.full(n, -1, dtype=int)
    dist[start] = 0.0
    heap = [(0.0, start)]
    visited = np.zeros(n, dtype=bool)
    while heap:
        d, u = heapq.heappop(heap)
        if visited[u]:
            continue
        visited[u] = True
        if u == goal:
            break
        for v in road_map[u]:
            if visited[v]:
                continue
            step = np.hypot(sample_x[v] - sample_x[u], sample_y[v] - sample_y[u])
            nd = d + cost_fcn(step)
            if nd < dist[v]:
                dist[v] = nd
                parent[v] = u
                heapq.heappush(heap, (nd, v))
    if not visited[goal]:
        return [], [], False
    path = [goal]
    while path[-1] != start:
        path.append(parent[path[-1]])
    path = path[::-1]
    return [sample_x[i] for i in path], [sample_y[i] for i in path], True


def PRM_planning(sx, sy, gx, gy, ox, oy, rr, params, n_samples,
                 sampled_points=None):
    """Full PRM query (prm.py:82-94). sampled_points = ([px], [py]) or None
    for uniform sampling in the bounding box."""
    obstacle_tree = cKDTree(np.stack([ox, oy], axis=1))
    if sampled_points is None:
        lo_x, hi_x = min(ox), max(ox)
        lo_y, hi_y = min(oy), max(oy)
        px, py = [], []
        while len(px) < n_samples:
            tx = lo_x + np.random.rand() * (hi_x - lo_x)
            ty = lo_y + np.random.rand() * (hi_y - lo_y)
            d, _ = obstacle_tree.query([tx, ty])
            if d > rr:
                px.append(tx)
                py.append(ty)
        sampled_points = (px, py)
    sample_x = list(sampled_points[0]) + [sx, gx]
    sample_y = list(sampled_points[1]) + [sy, gy]
    road_map = generate_roadmap(sample_x, sample_y, rr, obstacle_tree, params)
    rx, ry, success = dijkstra_planning(
        sx, sy, gx, gy, road_map, sample_x, sample_y, params["cost_fcn"]
    )
    return rx, ry, success
