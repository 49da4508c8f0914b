"""Dynamic octree refinement: split, resample, prune.

Counterpart of ``mega_nerf_viewer_tpu/ops/refine.py`` (the reference's
tree surgery, ``cuda_renderer.cpp:205-381``, and its edit kernels,
``renderer_kernel.cu:63-213``):

  * :func:`expand_voxels` — take the most-voted leaves (host vote
    aggregation, where the reference syncs to the host too), give each a
    child chunk at the array tail, and fill the children with the mean of
    ``samples_per_corner`` MLP evaluations at uniform random points.
  * :func:`get_more_samples` — more MLP samples for under-sampled
    leaves, folded in by an f32 incremental mean with one f16 rounding.
  * :func:`prune_tree` — delete never-visited chunks: rewire the parent
    and child links by the cumulative shift, then compact by a stable
    permutation gather.
  * :func:`expand_voxels_jit` — the expand with the vote aggregation on
    the device (:func:`aggregate_split_votes_device`), the JAX package's
    fast path; the name is kept so a reader finds its counterpart.

Trees are not edited in place: each edit returns a new :class:`N3Tree`
(the arrays are a few MB, and the caller may still hold the old tree).
Randomness: every function that draws takes a ``torch.Generator`` and,
optionally, the uniform draws themselves (``rnd``) in the shape that JAX
draws them, so that a test can hand both packages the same numbers.  The
MLP products run as ``torch.bmm`` (``models.meganerf``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.meganerf import cluster_ids_from_yz, mlp_forward_all
from ..n3tree.tree import N3Tree
from ..options import RenderOptions
from .fp import fma_f32, ipow_f32

MAX_WALK_LEVELS = 24


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


# ----------------------------------------------------------------------
# Vote aggregation (host)
# ----------------------------------------------------------------------
def aggregate_split_votes(split_vote, split_batch_size: int) -> np.ndarray:
    """Top split candidates from per-ray votes (``refine.py:54-77``,
    reference ``cuda_renderer.cpp:206-226``): the valid rows, unique
    rows with their counts, count > 1, sorted by (-count, priority,
    chunk, child), the head.  Returns int32 [K, 2] = (chunk, child)."""
    votes = _host(split_vote)
    votes = votes[votes[:, 1] >= 0]
    if len(votes) == 0:
        return np.zeros((0, 2), np.int32)
    uniq, counts = np.unique(votes, axis=0, return_counts=True)
    keep = counts > 1
    uniq, counts = uniq[keep], counts[keep]
    if len(uniq) == 0:
        return np.zeros((0, 2), np.int32)
    rows = np.concatenate([-counts[:, None].astype(np.float32), uniq],
                          axis=1)
    order = np.lexsort(tuple(rows[:, c] for c in range(rows.shape[1] - 1,
                                                       -1, -1)))
    rows = rows[order][:split_batch_size]
    return rows[:, 2:4].astype(np.int32)


def aggregate_sample_votes(sample_vote, split_batch_size: int) -> np.ndarray:
    """Top resample candidates, lowest sample count first
    (``refine.py:80-89``).  Returns int32 [K, 2] = (chunk, child)."""
    votes = _host(sample_vote)
    votes = votes[votes[:, 1] >= 0]
    if len(votes) == 0:
        return np.zeros((0, 2), np.int32)
    uniq = np.unique(votes, axis=0)
    return uniq[:split_batch_size, 1:3].astype(np.int32)


# ----------------------------------------------------------------------
# Voxel corners by a parent walk
# ----------------------------------------------------------------------
def node_corners(child_parent: torch.Tensor, chunk: torch.Tensor,
                 cidx: torch.Tensor, N: int,
                 max_levels: int = MAX_WALK_LEVELS):
    """Tree-space corner and depth of leaf voxels by a parent walk
    (``refine.py:96-131``, reference ``renderer_kernel.cu:99-123``): peel
    the three base-N digits of ``chunk * N^3 + cidx``, fold them into the
    corner, hop to ``parent[chunk]``.  Returns (corner [K, 3] f32 in
    [0, 1], depth [K] i32); the voxel side is ``N ** -(depth + 1)``."""
    N3 = N ** 3
    dev = chunk.device
    packed = chunk.to(torch.int64) * N3 + cidx.to(torch.int64)
    K = packed.shape[0]
    corner = torch.zeros((K, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros((K,), dtype=torch.int32, device=dev)
    done = torch.zeros((K,), dtype=torch.bool, device=dev)
    n_par = child_parent.numel()
    for _ in range(max_levels):
        cur_chunk = torch.div(packed, N3, rounding_mode="floor")
        rem = packed % N3
        digits = torch.stack([torch.div(rem, N * N, rounding_mode="floor"),
                              torch.div(rem, N, rounding_mode="floor") % N,
                              rem % N], -1).to(torch.float32)
        corner = torch.where(done[:, None], corner, (corner + digits) / N)
        at_root = cur_chunk == 0
        stay = done | at_root
        nxt = child_parent[cur_chunk.clamp(0, n_par - 1)].to(torch.int64)
        packed = torch.where(stay, packed, nxt)
        depth = torch.where(stay, depth, depth + 1)
        done = stay
    return corner, depth


def _mlp_samples(tree: N3Tree, opt: RenderOptions, corner_world, side,
                 rnd: torch.Tensor):
    """MLP inputs at ``corner_world + rnd * side / scale`` (``rnd`` [..., 3]
    uniform, ``corner_world`` and ``side`` broadcast to it), with the
    top-down view direction (1, 0, 0) and the appearance id as the model
    takes them (``renderer_kernel.cu:136-152``).  Returns (samples
    [..., dim], xyz [..., 3])."""
    xyz = fma_f32(rnd, side / tree.scale, corner_world)
    cols = [xyz]
    if opt.need_viewdir:
        vd = torch.zeros_like(xyz)
        vd[..., 0] = 1.0
        cols.append(vd)
    if opt.appearance_embedding != -1:
        cols.append(torch.full(xyz.shape[:-1] + (1,),
                               float(opt.appearance_embedding),
                               dtype=torch.float32, device=xyz.device))
    return torch.cat(cols, -1), xyz


def _uniform(shape, generator, rnd, dev) -> torch.Tensor:
    if rnd is not None:
        rnd = torch.as_tensor(rnd, dtype=torch.float32, device=dev)
        if tuple(rnd.shape) != tuple(shape):
            raise ValueError(f"rnd has shape {tuple(rnd.shape)}, expected "
                             f"{tuple(shape)}")
        return rnd
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=dev)


def _make_samples(tree: N3Tree, model, opt: RenderOptions,
                  chunk: torch.Tensor, cidx: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  rnd: Optional[torch.Tensor] = None):
    """Uniform random MLP inputs inside the given leaf voxels
    (``refine.py:134-162``).  ``rnd`` [K, spc, 3].  Returns (samples
    [K, spc, dim] f32, cluster_ids [K, spc] i32)."""
    spc = opt.samples_per_corner
    K = chunk.shape[0]
    corner, depth = node_corners(tree.parent, chunk, cidx, tree.N)
    side = ipow_f32(tree.N, -(depth + 1))
    corner_world = (corner - tree.offset[None, :]) / tree.scale[None, :]
    rnd = _uniform((K, spc, 3), generator, rnd, tree.device)
    samples, xyz = _mlp_samples(tree, opt, corner_world[:, None, :],
                                side[:, None, None], rnd)
    return samples, model.cluster_ids_device(xyz[..., 1:3])


def _child_corners(tree: N3Tree, pc: torch.Tensor, pcc: torch.Tensor):
    """World corners [K, N^3, 3] and side [K] of the N^3 children that
    splitting the leaves (pc, pcc) creates (``refine.py:202-213``)."""
    N, N3 = tree.N, tree.N3
    corner_p, depth_p = node_corners(tree.parent, pc, pcc, N)
    side = ipow_f32(N, -(depth_p + 2))
    slots = torch.arange(N3, device=pc.device)
    slot_off = torch.stack([torch.div(slots, N * N, rounding_mode="floor"),
                            torch.div(slots, N, rounding_mode="floor") % N,
                            slots % N], -1).to(torch.float32)
    corner_c = corner_p[:, None, :] + slot_off[None] * side[:, None, None]
    corner_world = (corner_c - tree.offset) / tree.scale
    return corner_world, side


def _replace(tree: N3Tree, **kw) -> N3Tree:
    return dataclasses.replace(tree, **kw)


# ----------------------------------------------------------------------
# Expand (split)
# ----------------------------------------------------------------------
def expand_voxels(tree: N3Tree, model, opt: RenderOptions, split_vote,
                  visit_tracker: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  rnd: Optional[torch.Tensor] = None,
                  verbose: bool = False):
    """Split the most-voted leaves (``refine.py:168-256``, reference
    ``cuda_renderer.cpp:205-278``).  ``rnd`` [K * N^3, spc, 3] (K the
    number of candidates) replaces the generator's draws.  Returns (tree,
    visit_tracker, n_added); 0 added (no candidate, or the candidates do
    not fit: the reference's "Full") tells the caller to resample."""
    to_split = aggregate_split_votes(split_vote, opt.split_batch_size)
    if verbose:
        print(f"Split candidates: {len(to_split)}")
    if len(to_split) == 0:
        return tree, visit_tracker, 0
    cap = int(tree.capacity)
    if cap + len(to_split) > tree.max_capacity:
        if verbose:
            print("Full")
        return tree, visit_tracker, 0

    dev = tree.device
    N3 = tree.N3
    D = tree.data_dim
    K = len(to_split)
    to_split = torch.as_tensor(to_split, device=dev).long()
    pc, pcc = to_split[:, 0], to_split[:, 1]
    abs_chunk = cap + torch.arange(K, device=dev)
    corner_world, side = _child_corners(tree, pc, pcc)
    spc = opt.samples_per_corner
    rnd = _uniform((K * N3, spc, 3), generator, rnd, dev)
    samples, xyz = _mlp_samples(
        tree, opt, corner_world.reshape(K * N3, 1, 3),
        side.repeat_interleave(N3)[:, None, None], rnd)
    cluster_ids = model.cluster_ids_device(xyz[..., 1:3])
    results = model.query_device(cluster_ids.reshape(-1),
                                 samples.reshape(K * N3 * spc, -1))
    new_data = results.reshape(K * N3, spc, -1)[..., :D].mean(1)

    child = tree.child.clone()
    parent = tree.parent.clone()
    data = tree.data.clone()
    counts = tree.sample_counts.clone()
    tracker = visit_tracker.clone()
    child[pc, pcc] = (abs_chunk - pc).to(torch.int32)
    parent[abs_chunk] = (pc * N3 + pcc).to(torch.int32)
    tracker[abs_chunk] = visit_tracker[pc]
    data[cap:cap + K] = new_data.reshape(K, N3, D).to(torch.float16)
    counts[cap:cap + K] = spc
    if verbose:
        print(f"Added: {K}, total size: {cap + K}")
    return (_replace(tree, child=child, parent=parent, data=data,
                     sample_counts=counts, capacity=cap + K), tracker, K)


# ----------------------------------------------------------------------
# Resample
# ----------------------------------------------------------------------
def get_more_samples(tree: N3Tree, model, opt: RenderOptions, sample_vote,
                     generator: Optional[torch.Generator] = None,
                     rnd: Optional[torch.Tensor] = None,
                     verbose: bool = False) -> N3Tree:
    """More MLP samples for under-sampled leaves, folded in by an
    incremental mean (``refine.py:262-306``, reference
    ``cuda_renderer.cpp:280-341``): ``old + (sum_new - spc * old) /
    (count + spc)`` in f32, written with one f16 rounding.  ``rnd``
    [K, spc, 3] replaces the generator's draws."""
    to_sample = aggregate_sample_votes(sample_vote, opt.split_batch_size)
    if verbose:
        print(f"Sample candidates: {len(to_sample)}")
    if len(to_sample) == 0:
        return tree
    dev = tree.device
    D = tree.data_dim
    spc = opt.samples_per_corner
    K = len(to_sample)
    to_sample = torch.as_tensor(to_sample, device=dev).long()
    chunk, cidx = to_sample[:, 0], to_sample[:, 1]
    samples, cluster_ids = _make_samples(tree, model, opt, chunk, cidx,
                                         generator, rnd)
    results = model.query_device(cluster_ids.reshape(-1),
                                 samples.reshape(K * spc, -1))
    new_sum = results.reshape(K, spc, -1)[..., :D].sum(1)

    node = chunk * tree.N3 + cidx
    data_flat = tree.data.reshape(-1, D).clone()
    counts_flat = tree.sample_counts.reshape(-1).clone()
    old = data_flat[node].to(torch.float32)
    new_counts = counts_flat[node].to(torch.float32) + spc
    new_mean = old + (new_sum - spc * old) / new_counts[:, None]
    data_flat[node] = new_mean.to(torch.float16)
    counts_flat[node] += spc
    return _replace(tree, data=data_flat.reshape(tree.data.shape),
                    sample_counts=counts_flat.reshape(
                        tree.sample_counts.shape))


# ----------------------------------------------------------------------
# Prune
# ----------------------------------------------------------------------
def prune_tree(tree: N3Tree, visit_tracker: torch.Tensor,
               verbose: bool = False) -> Tuple[N3Tree, torch.Tensor]:
    """Delete never-visited chunks and compact (``refine.py:312-336``,
    reference ``cuda_renderer.cpp:343-381``).  Returns (tree, a fresh
    visit tracker with only the root marked)."""
    cap = int(tree.capacity)
    to_delete = visit_tracker[:cap] == 0
    num_to_delete = int(to_delete.sum())
    if verbose:
        print("Pruning")
    fresh = torch.zeros_like(visit_tracker)
    fresh[0] = 1
    if num_to_delete == 0:
        if verbose:
            print("Nothing can be pruned")
        return tree, fresh
    new_tree = _prune_compact(tree, to_delete, cap, cap - num_to_delete)
    if verbose:
        print(f"Pruning finished - reclaimed: {num_to_delete}")
    return new_tree, fresh


def _prune_compact(tree: N3Tree, to_delete: torch.Tensor, cap: int,
                   n_keep: int) -> N3Tree:
    """Rewire and compact (``refine.py:339-390``, reference
    ``adjust_parents_and_children_kernel``, ``renderer_kernel.cu:63-86``):
    a deleted chunk's pointer at its parent becomes 0; a kept chunk c with
    parent p has its offset changed by ``shifts[p] - shifts[c]`` and its
    packed parent lowered by ``shifts[p] * N^3``; then the kept rows move
    to the front in order (a stable sort) and the rest are zeroed."""
    N3 = tree.N3
    dev = tree.device
    max_cap = tree.max_capacity
    shifts = torch.cumsum(to_delete.to(torch.int32), 0, dtype=torch.int32)
    chunks = torch.arange(cap, device=dev)
    parent = tree.parent[:cap].long()
    pc = torch.div(parent, N3, rounding_mode="floor")
    pcc = parent % N3
    child = tree.child.clone()
    # chunk 0's parent entry is the self-referential packed 0
    dele = to_delete & (chunks > 0)
    child[pc[dele], pcc[dele]] = 0
    keep = ~to_delete & (chunks > 0)
    adjust = shifts[pc] - shifts
    child.index_put_((pc[keep], pcc[keep]), adjust[keep], accumulate=True)
    new_parent = tree.parent.clone()
    new_parent[:cap] += torch.where(keep, -shifts[pc] * N3,
                                    torch.zeros_like(shifts))

    key = torch.full((max_cap,), 2, dtype=torch.int32, device=dev)
    key[:cap] = to_delete.to(torch.int32)
    perm = torch.sort(key, stable=True).indices

    def take_rows(a):
        out = a[perm]
        out[n_keep:] = 0
        return out

    return _replace(tree, data=take_rows(tree.data), child=take_rows(child),
                    parent=take_rows(new_parent),
                    sample_counts=take_rows(tree.sample_counts),
                    capacity=n_keep)


# ----------------------------------------------------------------------
# Refinement with the vote aggregation on the device
# ----------------------------------------------------------------------
def aggregate_split_votes_device(split_vote: torch.Tensor, N3: int, K: int):
    """Top-K split aggregation on the device (``refine.py:396-442``): the
    policy of :func:`aggregate_split_votes` (count > 1, most votes first,
    shallowest depth next, then the node id) as one stable sort of the
    packed node ids, run lengths from a flipped ``cummin`` of the run
    starts, and two stable sorts.  Returns (nodes i32 [K] packed
    ``chunk * N3 + child``, priority f32 [K], valid bool [K]) with the
    valid entries first."""
    i32 = torch.int32
    dev = split_vote.device
    valid_in = split_vote[:, 1] >= 0
    packed = (split_vote[:, 1].to(i32) * N3 + split_vote[:, 2].to(i32))
    packed = torch.where(valid_in, packed, torch.full_like(packed, -1))
    Rn = packed.shape[0]
    order_rays = torch.sort(packed, stable=True).indices
    sp = packed[order_rays]
    pos = torch.arange(Rn, dtype=i32, device=dev)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          sp[1:] != sp[:-1]])
    start_or_big = torch.where(is_start, pos, torch.full_like(pos, Rn))
    from_right = torch.flip(torch.cummin(torch.flip(start_or_big, (0,)),
                                         0).values, (0,))
    next_start = torch.cat([from_right[1:],
                            torch.full((1,), Rn, dtype=i32, device=dev)])
    counts = next_start - pos
    prio = split_vote[:, 0][order_rays]
    keep = is_start & (sp >= 0) & (counts > 1)
    neg_count = torch.where(keep, -counts,
                            torch.full_like(counts, torch.iinfo(i32).max))
    i1 = torch.sort(prio, stable=True).indices
    i2 = torch.sort(neg_count[i1], stable=True).indices
    order = i1[i2][:K]
    return sp[order], prio[order], keep[order]


def expand_voxels_jit(tree: N3Tree, params, grid_dim, min_position,
                      pos_range, opt: RenderOptions, split_vote: torch.Tensor,
                      visit_tracker: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      rnd: Optional[torch.Tensor] = None, mlp_apply=None):
    """The expand with the vote aggregation on the device
    (``refine.py:445-532``): top-K candidates, the wholesale abort when
    they do not fit, child allocation and the MLP fill.  ``mlp_apply
    (params, cluster_ids, x)`` defaults to the all-clusters forward, as in
    JAX.  ``rnd`` [K, N^3, spc, 3] (K = ``split_batch_size``) replaces
    the generator's draws.  The number added is read back to the host, to
    keep ``tree.capacity`` an int.  Returns (tree, visit_tracker,
    n_added)."""
    if mlp_apply is None:
        mlp_apply = mlp_forward_all
    dev = tree.device
    N3 = tree.N3
    D = tree.data_dim
    K = opt.split_batch_size
    spc = opt.samples_per_corner
    nodes, _, valid = aggregate_split_votes_device(split_vote, N3, K)
    cap = int(tree.capacity)
    n_new = int(valid.sum())
    if cap + n_new > tree.max_capacity:
        n_new = 0              # the reference's "Full"
    rnd = _uniform((K, N3, spc, 3), generator, rnd, dev)
    if n_new == 0:
        return tree, visit_tracker, 0

    nodes = nodes.long()
    pc = torch.div(nodes, N3, rounding_mode="floor").clamp(
        0, tree.max_capacity - 1)
    pcc = (nodes % N3).clamp(0, N3 - 1)
    corner_world, side = _child_corners(tree, pc, pcc)
    samples, xyz = _mlp_samples(tree, opt, corner_world[:, :, None, :],
                                side[:, None, None, None], rnd)
    flat_xyz = xyz.reshape(-1, 3)
    cluster_ids = cluster_ids_from_yz(flat_xyz[:, 1], flat_xyz[:, 2],
                                      grid_dim, min_position, pos_range)
    results = mlp_apply(params, cluster_ids, samples.reshape(K * N3 * spc,
                                                             -1))
    new_data = results[:, :D].reshape(K, N3, spc, D).mean(2)

    # the valid candidates come first: they take chunks cap .. cap+n_new
    pc, pcc = pc[:n_new], pcc[:n_new]
    abs_chunk = cap + torch.arange(n_new, device=dev)
    child = tree.child.clone()
    parent = tree.parent.clone()
    tracker = visit_tracker.clone()
    child[pc, pcc] = (abs_chunk - pc).to(torch.int32)
    parent[abs_chunk] = (pc * N3 + pcc).to(torch.int32)
    tracker[abs_chunk] = visit_tracker[pc]
    data = tree.data.clone()
    data[abs_chunk] = new_data[:n_new].to(torch.float16)
    counts = tree.sample_counts.clone()
    counts[abs_chunk] = spc
    child[abs_chunk] = 0                 # new chunks are all leaves
    return (_replace(tree, child=child, parent=parent, data=data,
                     sample_counts=counts, capacity=cap + n_new),
            tracker, n_new)
