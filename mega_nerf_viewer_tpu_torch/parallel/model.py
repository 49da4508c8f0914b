"""Tensor-parallel Mega-NeRF MLP inference over the ``model`` axis.

Counterpart of ``mega_nerf_viewer_tpu/parallel/model.py``: Megatron-style
alternating column and row partitioning of the stacked per-cluster
weights.  Even layers are column-parallel (each rank holds a slice of the
output features, the activations become feature-sharded, ReLU applies
locally); odd layers are row-parallel (each rank holds the matching slice
of the input features, and one ``all_reduce(SUM)`` over the model
sub-group adds the partial products before the bias).  Models with skip
layers are replicated: a skip re-injects the replicated input into a
feature-sharded activation.  The products run in full f32
(``models.meganerf._f32_matmul``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.meganerf import MLPParams, _f32_matmul
from .mesh import MODEL_AXIS, Mesh, all_reduce


def tp_layer_kind(l: int, n_layers: int, skips: Tuple[int, ...] = ()) -> str:
    """'col', 'row' or 'rep' for layer ``l`` (``model.py:27-39``): the last
    layer of an odd count is replicated, and so is every layer of a model
    with skips."""
    if skips:
        return "rep"
    if l == n_layers - 1 and n_layers % 2 == 1:
        return "rep"
    return "col" if l % 2 == 0 else "row"


def tp_param_specs(params: MLPParams, mesh: Mesh,
                   axis: str = MODEL_AXIS) -> MLPParams:
    """This rank's share of the stacked weights (JAX's partition specs,
    ``model.py:42-57``, applied): column layers keep the rank's slice of
    the output features (weights and biases), row layers the slice of the
    input features (the bias whole), replicated layers everything.  A
    sharded width must divide by the axis size."""
    k, j = mesh.shape[axis], mesh.index(axis)
    n = params.n_layers
    weights, biases = [], []
    for l, (w, b) in enumerate(zip(params.weights, params.biases)):
        kind = tp_layer_kind(l, n, params.skips)
        dim = {"col": 2, "row": 1}.get(kind)
        if dim is not None and w.shape[dim] % k:
            raise ValueError(f"layer {l} ({kind}) width {w.shape[dim]} does "
                             f"not split over the '{axis}' axis of size {k}")
        if kind == "col":
            cols = slice(j * w.shape[2] // k, (j + 1) * w.shape[2] // k)
            w, b = w[:, :, cols], b[:, cols]
        elif kind == "row":
            w = w[:, j * w.shape[1] // k:(j + 1) * w.shape[1] // k, :]
        weights.append(w.contiguous())
        biases.append(b.contiguous())
    return MLPParams(weights, biases, params.skips)


def mlp_forward_tp(params: MLPParams, cluster: int, x: torch.Tensor,
                   axis: str = MODEL_AXIS, *, mesh: Mesh) -> torch.Tensor:
    """One cluster's forward with ``params`` = this rank's share
    (:func:`tp_param_specs`); ``x`` [n, in] and the output are replicated
    over the model axis (``model.py:60-84``).  ``mesh`` (port-only,
    required) is the mesh whose ``axis`` the shares split over; JAX reads
    it from the enclosing ``shard_map``."""
    n_layers = params.n_layers
    group = mesh.group(axis)
    h = x
    with _f32_matmul():
        for l in range(n_layers):
            kind = tp_layer_kind(l, n_layers, params.skips)
            if l in params.skips:
                h = torch.cat([h, x], dim=-1)
            out = h @ params.weights[l][cluster]
            if kind == "row":
                out = all_reduce(out, "sum", group)
            h = out + params.biases[l][cluster]
            if l < n_layers - 1:
                h = torch.relu(h)
    return h


def mlp_forward_all_tp(params: MLPParams, cluster_ids: torch.Tensor,
                       x: torch.Tensor, axis: str = MODEL_AXIS, *,
                       mesh: Mesh) -> torch.Tensor:
    """Every cluster's tensor-parallel forward on every sample, then a
    select by ``cluster_ids`` (``model.py:87-94``; the all-clusters route
    of ``models.meganerf.mlp_forward_all``).  ``mesh`` as in
    :func:`mlp_forward_tp`."""
    C = params.n_clusters
    x0 = x.unsqueeze(0).expand(C, -1, -1)
    h = x0
    n_layers = params.n_layers
    group = mesh.group(axis)
    with _f32_matmul():
        for l in range(n_layers):
            kind = tp_layer_kind(l, n_layers, params.skips)
            if l in params.skips:
                h = torch.cat([h, x0], dim=-1)
            out = torch.bmm(h, params.weights[l])
            if kind == "row":
                out = all_reduce(out, "sum", group)
            h = out + params.biases[l][:, None]
            if l < n_layers - 1:
                h = torch.relu(h)
    n = x.shape[0]
    return h[cluster_ids.long(), torch.arange(n, device=x.device)]
