"""Mega-NeRF MLP container: batched-matmul inference + TorchScript loading.

Counterpart of ``mega_nerf_viewer_tpu/models/meganerf.py``; analogue of
the reference's LibTorch model layer (``src/renderer/cuda_renderer.cpp:
518-543`` load_model, ``:165-203`` query_submodules).  The reference keeps
a TorchScript module per spatial cluster; here the submodules' weights
are converted once into stacked weights with one leading cluster axis and
inference is batched matrix products, in full f32 (TF32 off) because the
reference is f32.  Both parameter kinds have one ``forward(x, cids,
out=None)`` that runs each layer as one :func:`mlp_gemm`: on the card the
port's fused product kernel (``csrc/mlp_gemm.cu``), which reads each
group's cluster weights in place and does the bias, the ReLU and the
concatenations inside the product; its plain version on the CPU.

Container contract (reference ``cuda_renderer.cpp:518-543``):
  * attrs ``grid_dim`` (int[2]), ``min_position`` / ``max_position``
    (float[3]), ``centroids`` (count == number of submodules),
    ``need_viewdir`` (bool), ``need_appearance_embedding`` (bool)
  * submodules ``sub_module_<i>``: input ``[n, 3(+3)(+1)]`` =
    [xyz, (viewdir), (appearance)], second arg ``False``; output
    ``[n, data_dim + 1]``.

Submodule structures that convert (each verified by replaying its forward
within 1e-4 on seeded rows):
  * a Linear/ReLU stack, its input re-injected after the hidden state at
    any layer whose input width exceeds the running width by the input's
    (``cat[h, x]``): :class:`MLPParams`;
  * Mega-NeRF's ``NeRF`` (``mega_nerf/models/nerf.py``) with an SH head
    and an appearance embedding and no direction encoding (``pos_dir_dim``
    0, ``appearance_dim`` > 0, ``affine_appearance`` off), recognised by
    its parameter names (``xyz_encodings.<i>.0``, ``sigma``,
    ``xyz_encoding_final``, ``embedding_a``, ``dir_a_encoding.0``,
    ``rgb``) and the encoding's ``freq_bands``, with a ReLU or shifted
    softplus sigma activation: :class:`NeRFParams`.  Its input is
    ``[xyz, appearance id]``.

Both kinds run through :func:`query_grouped`.  A ``NeRF`` with a
direction encoding, an affine appearance or no appearance embedding, and
any other graph, falls back to eager TorchScript (``meganerf.py:434-456``):
its frozen submodules run on the model's device through
:meth:`MegaNeRFModel.query`, the cluster-sorted loop of the reference's
``query_submodules``, and guided sampling takes the host reconstruction
path (``ops/guided.py``).

Cluster id for a point is a 2-D cell over (y, z):
``g1 * grid_dim[1] + g2`` (reference ``rt_core.cuh:541-549``).

The query records the span ``model.query`` (``route`` ``chunked`` or
``all``, ``rows`` the rows handed in) and the counters ``mlp_queries`` and
``mlp_rows`` (rows the forward computed, pad rows included) while a
profiler session runs (``utils/profiling.py``);
``mlp_samples`` (real samples) is counted where they are known:
:meth:`MegaNeRFModel.query_device` and the guided fast path.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import kernels
from ..device import resolve_device
from ..utils import profiling

# batches at or above this size take the chunked route (meganerf.py:236)
CHUNKED_MIN = 1 << 16
CHUNK = 1 << 13
# the chunked forward runs at most this many rows at a time (whole chunks),
# so that its activations stay bounded: about 4.5 KB a row at Mill 19's
# widths, 9.3 GB a block
BLOCK_ROWS = 1 << 21


class MLPParams(nn.Module):
    """Stacked per-cluster MLP weights.

    ``weights[l]: f32[n_clusters, in_l, out_l]``, ``biases[l]:
    f32[n_clusters, out_l]`` (buffers ``w<l>``, ``b<l>``).  ``skips`` marks
    layers whose input is ``concat([h, x0])`` (NeRF-style reinjection).
    """

    def __init__(self, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor], skips=()):
        super().__init__()
        if len(weights) != len(biases) or not weights:
            raise ValueError("need one bias per weight, at least one layer")
        self.n_layers = len(weights)
        for l, (w, b) in enumerate(zip(weights, biases)):
            self.register_buffer(f"w{l}", w.to(torch.float32).contiguous())
            self.register_buffer(f"b{l}", b.to(torch.float32).contiguous())
        self.skips = tuple(int(s) for s in skips)

    @property
    def weights(self) -> list:
        return [getattr(self, f"w{l}") for l in range(self.n_layers)]

    @property
    def biases(self) -> list:
        return [getattr(self, f"b{l}") for l in range(self.n_layers)]

    @property
    def n_clusters(self) -> int:
        return self.w0.shape[0]

    @property
    def input_dim(self) -> int:
        return self.w0.shape[1]

    @property
    def output_dim(self) -> int:
        return self.weights[-1].shape[2]

    @property
    def device(self) -> torch.device:
        return self.w0.device

    def forward(self, x: torch.Tensor, cids: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The stack on ``G = len(cids)`` groups of rows, group ``g``
        cluster ``cids[g]``'s (i64).  ``x`` f32 [1 or G, n, in] (a leading
        1 is shared by every group).  Each layer is one :func:`mlp_gemm`,
        a skip layer reading ``cat[h, x]`` as two sources, every layer but
        the last with the ReLU.  Returns f32 [G, n, out], into ``out`` when
        given."""
        h = x
        L = self.n_layers
        for l in range(L):
            h = mlp_gemm(h, getattr(self, f"w{l}"), getattr(self, f"b{l}"),
                         cids, l < L - 1,
                         a2=x if l in self.skips else None,
                         out=out if l == L - 1 else None)
        return h


def params_from_numpy(weights, biases, skips=(), device=None) -> MLPParams:
    """The port's :class:`MLPParams` from host arrays, e.g. the JAX
    model's: ``params_from_numpy([np.asarray(w) for w in p.weights],
    [np.asarray(b) for b in p.biases], p.skips)``."""
    device = resolve_device(device)
    return MLPParams(
        [torch.from_numpy(np.asarray(w, np.float32)).to(device)
         for w in weights],
        [torch.from_numpy(np.asarray(b, np.float32)).to(device)
         for b in biases], skips)


@contextlib.contextmanager
def _f32_matmul():
    """Full-f32 matrix products for the block (TF32 would move outputs by
    about 1e-3); the caller's setting is restored after."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class NeRFParams(nn.Module):
    """Stacked per-cluster weights of Mega-NeRF's ``NeRF``
    (``mega_nerf/models/nerf.py``) with an SH head, an appearance
    embedding and no direction encoding.

    For an input row ``[p (3), appearance id]``: ``g = [p, sin(f_0 p),
    cos(f_0 p), ...]`` over ``freq_bands`` (the encoding, ``3 + 6F``
    wide); ``h = g``, then for each trunk layer ``l``: ``h = cat[g, h]``
    where ``l`` is in ``skips`` (the encoding first), ``h = ReLU(h W_l +
    b_l)``; ``sigma = act(h W_s + b_s)``; ``f = h W_f + b_f``; ``a`` the
    cluster's appearance row of the id; ``c = ReLU(cat[f, a] W_g + b_g)
    W_c + b_c``; the output ``cat[c, sigma]``.

    Buffers: ``freq_bands`` f32 [F]; the trunk ``w<l>`` [C, in, out],
    ``b<l>`` [C, out]; ``sigma_w``, ``final_w``, ``dir_a_w``, ``rgb_w``
    [C, in, out] with their ``*_b`` [C, out]; ``appearance`` [C, A, E].
    ``sigma_activation``: ``relu`` or ``softplus`` (Mega-NeRF's shifted
    softplus, ``softplus(x - 1)``)."""

    HEADS = ("sigma", "final", "dir_a", "rgb")

    def __init__(self, freq_bands: torch.Tensor, trunk_w, trunk_b, skips,
                 heads: dict, appearance: torch.Tensor,
                 sigma_activation: str = "relu"):
        super().__init__()
        if sigma_activation not in ("relu", "softplus"):
            raise ValueError(f"sigma_activation {sigma_activation!r}")
        f32 = torch.float32
        self.register_buffer("freq_bands", freq_bands.to(f32).contiguous())
        self.n_layers = len(trunk_w)
        for l, (w, b) in enumerate(zip(trunk_w, trunk_b)):
            self.register_buffer(f"w{l}", w.to(f32).contiguous())
            self.register_buffer(f"b{l}", b.to(f32).contiguous())
        for k in self.HEADS:
            w, b = heads[k]
            self.register_buffer(f"{k}_w", w.to(f32).contiguous())
            self.register_buffer(f"{k}_b", b.to(f32).contiguous())
        self.register_buffer("appearance", appearance.to(f32).contiguous())
        self.skips = tuple(int(s) for s in skips)
        self.sigma_activation = sigma_activation

    @property
    def n_clusters(self) -> int:
        return self.w0.shape[0]

    @property
    def output_dim(self) -> int:
        return self.rgb_w.shape[2] + 1

    @property
    def device(self) -> torch.device:
        return self.w0.device

    def trunk(self, l: int) -> tuple:
        """(weight, bias) of trunk layer ``l``."""
        return getattr(self, f"w{l}"), getattr(self, f"b{l}")

    def head(self, k: str) -> tuple:
        """(weight, bias) of the head ``k`` of :attr:`HEADS`."""
        return getattr(self, f"{k}_w"), getattr(self, f"{k}_b")

    def forward(self, x: torch.Tensor, cids: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The model on ``G = len(cids)`` groups of rows, group ``g``
        cluster ``cids[g]``'s (i64).  ``x`` f32 [1 or G, n, 4] (a leading 1
        is shared by every group).  Each layer is one :func:`mlp_gemm`: the
        skip reads ``[g, h]`` and the colour branch ``[f, appearance row]``
        as two sources, and the rgb and sigma heads write columns 0.. and
        the last of the output.  Returns f32 [G, n, out], into ``out`` when
        given."""
        G, n = cids.shape[0], x.shape[1]
        g = encode_positions(x[..., :3], self.freq_bands)
        if out is None:
            out = g.new_empty((G, n, self.output_dim))
        h = g
        for l in range(self.n_layers):
            w, b = self.trunk(l)
            h = mlp_gemm(g, w, b, cids, True, a2=h) if l in self.skips \
                else mlp_gemm(h, w, b, cids, True)
        relu_sigma = self.sigma_activation == "relu"
        mlp_gemm(h, *self.head("sigma"), cids, relu_sigma, out=out,
                 col=out.shape[2] - 1)
        if not relu_sigma:
            sigma = out[..., -1:]
            sigma.copy_(torch.nn.functional.softplus(sigma - 1.0))
        f = mlp_gemm(h, *self.head("final"), cids, False)
        d = mlp_gemm(f, *self.head("dir_a"), cids, True,
                     table=self.appearance, ids=x[..., 3])
        mlp_gemm(d, *self.head("rgb"), cids, False, out=out, col=0)
        return out


def nerf_params_from_numpy(arrays: dict, skips, sigma_activation="relu",
                           device=None) -> NeRFParams:
    """:class:`NeRFParams` from host arrays: ``freq_bands`` [F],
    ``trunk_w`` / ``trunk_b`` (lists, [C, in, out] / [C, out]),
    ``<head>_w`` / ``<head>_b`` for ``sigma``, ``final``, ``dir_a`` and
    ``rgb``, and ``appearance`` [C, A, E]."""
    device = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return NeRFParams(
        t(arrays["freq_bands"]), [t(w) for w in arrays["trunk_w"]],
        [t(b) for b in arrays["trunk_b"]], skips,
        {k: (t(arrays[f"{k}_w"]), t(arrays[f"{k}_b"]))
         for k in NeRFParams.HEADS},
        t(arrays["appearance"]), sigma_activation)


def encode_positions(p: torch.Tensor, freq_bands: torch.Tensor
                     ) -> torch.Tensor:
    """Mega-NeRF's ``Embedding``: ``[p, sin(f_0 p), cos(f_0 p), sin(f_1
    p), ...]`` along the last axis."""
    fp = p[..., None, :] * freq_bands[:, None]
    sc = torch.stack([torch.sin(fp), torch.cos(fp)], -2)
    return torch.cat([p, sc.reshape(*p.shape[:-1], -1)], -1)


def mlp_gemm(a, w, b, cids, relu, a2=None, table=None, ids=None, out=None,
             col=0):
    """One fused product of the model's forward, on the rows of ``G =
    len(cids)`` groups, group ``g`` cluster ``cids[g]``'s: ``act(cat[a,
    second] W[c] + b[c])``, ``act`` ReLU or none, with the second source
    ``a2``'s rows, or the rows ``table[c, clamp(int(ids))]`` of the
    cluster's appearance table, or none; a source with a leading 1 is
    shared by every group.  The result goes to columns ``col ..`` of
    ``out`` [G, n, ldo] (a new [G, n, n_out] when ``out`` is None), which
    is returned.  The CUDA kernel (``kernels.mlp_gemm``) for CUDA tensors,
    the plain version for CPU tensors; shapes as
    ``kernels.check_mlp_gemm``."""
    if a.device.type != "cpu":
        return kernels.mlp_gemm(a, w, b, cids, relu, a2, table, ids, out,
                                col)
    kernels.check_mlp_gemm(a, w, b, cids, a2, table, ids, out, col)
    return mlp_gemm_reference(a, w, b, cids, relu, a2, table, ids, out, col)


def mlp_gemm_reference(a, w, b, cids, relu, a2=None, table=None, ids=None,
                       out=None, col=0):
    """:func:`mlp_gemm` as plain torch ops: the groups' weights and biases
    gathered, the sources concatenated, one batched product with the bias
    (TF32 off), then the ReLU."""
    G = cids.shape[0]
    src = [a.expand(G, -1, -1)]
    if a2 is not None:
        src.append(a2.expand(G, -1, -1))
    if table is not None:
        t = table[cids]
        i = ids.long().clamp(0, t.shape[1] - 1).expand(G, -1)
        src.append(torch.gather(t, 1, i[..., None].expand(-1, -1,
                                                          t.shape[2])))
    with _f32_matmul():
        y = torch.baddbmm(b[cids][:, None, :], torch.cat(src, -1)
                          if len(src) > 1 else src[0], w[cids])
    if relu:
        y.relu_()
    if out is None:
        return y
    out[..., col:col + y.shape[2]] = y
    return out


def mlp_forward(params, cluster: int, x: torch.Tensor) -> torch.Tensor:
    """Forward ``x [n, in]`` through the model of one ``cluster`` (either
    parameter kind)."""
    cids = torch.full((1,), cluster, dtype=torch.int64, device=x.device)
    return params.forward(x.contiguous()[None], cids)[0]


def mlp_forward_all(params, cluster_ids: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Every cluster's model on every sample, then a select by
    ``cluster_ids`` (the small-batch route: C x the products, no sort)."""
    h = params.forward(x.contiguous()[None],
                       torch.arange(params.n_clusters, device=x.device))
    return h[cluster_ids.long(), torch.arange(x.shape[0], device=x.device)]


def mlp_forward_chunked(params, x_al: torch.Tensor, chunk_cids: torch.Tensor,
                        chunk: int) -> torch.Tensor:
    """Cluster-pure chunked batched forward (``meganerf.py:142-179``).

    ``x_al`` f32 [nb*chunk, in]: cluster-sorted samples, each cluster's
    segment padded to a ``chunk`` multiple, so every chunk is one
    cluster's (``chunk_cids`` [nb]).  The forward runs in blocks of at most
    :data:`BLOCK_ROWS` rows (whole chunks), written into one output; each
    chunk reads its cluster's weights.  Pad rows hold garbage."""
    nb = x_al.shape[0] // chunk
    x = x_al.reshape(nb, chunk, x_al.shape[-1]).contiguous()
    cids = chunk_cids.long().contiguous()
    out = x_al.new_empty((nb, chunk, params.output_dim))
    per = max(1, BLOCK_ROWS // chunk)
    for b0 in range(0, nb, per):
        b1 = min(nb, b0 + per)
        params.forward(x[b0:b1], cids[b0:b1], out[b0:b1])
    return out.reshape(nb * chunk, -1)


def mlp_forward_grouped(params: MLPParams, sorted_x: torch.Tensor,
                        group_sizes) -> torch.Tensor:
    """Grouped MLP over cluster-sorted samples (``meganerf.py:84-116``), the
    ``ragged_dot`` reference: each layer multiplies each cluster's
    contiguous segment by that cluster's bias-augmented weights ``[w; b]``
    (the activations gain a ones column).  ``group_sizes`` [n_clusters]
    are read on the host; rows past their sum come out 0, as
    ``ragged_dot`` leaves them.  Returns f32 [n, out_dim] in the sorted
    order."""
    sizes = [int(g) for g in torch.as_tensor(group_sizes).tolist()]
    n = sorted_x.shape[0]
    h = sorted_x
    x0 = sorted_x
    L = params.n_layers
    with _f32_matmul():
        for l in range(L):
            if l in params.skips:
                h = torch.cat([h, x0], dim=-1)
            w_aug = torch.cat([params.weights[l],
                               params.biases[l][:, None, :]], dim=1)
            h_aug = torch.cat([h, h.new_ones((n, 1))], dim=-1)
            out = h.new_zeros((n, w_aug.shape[2]))
            off = 0
            for c, g in enumerate(sizes):
                out[off:off + g] = h_aug[off:off + g] @ w_aug[c]
                off += g
            h = torch.relu(out) if l < L - 1 else out
    return h


def _query_grouped(params: MLPParams, cluster_ids: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Sort-once grouped dispatch through :func:`mlp_forward_grouped`
    (``meganerf.py:119-139``): one stable sort by cluster id, the grouped
    products, the inverse permutation.  Samples in any order, outputs in
    the same order.  The reference path beside :func:`query_grouped`, the
    production dispatcher."""
    C = params.n_clusters
    ids = cluster_ids.long().clamp(0, C - 1)
    perm = torch.sort(ids, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    group_sizes = torch.bincount(ids, minlength=C)
    return mlp_forward_grouped(params, x[perm], group_sizes)[inv]


def _query_chunked(params: MLPParams, cluster_ids: torch.Tensor,
                   x: torch.Tensor, chunk: int) -> torch.Tensor:
    """Sort-once chunked dispatch (``meganerf.py:182-228``): samples in
    any order -> outputs in the same order.  The aligned buffer has the
    static bound ``(ceil(n/chunk) + C) * chunk`` rows, so nothing here
    waits on the card."""
    C = params.n_clusters
    n = x.shape[0]
    dev = x.device
    ids = cluster_ids.long().clamp(0, C - 1)
    perm = torch.sort(ids, stable=True).indices
    sorted_x = x[perm]
    counts = torch.zeros(C, dtype=torch.int64, device=dev).index_add_(
        0, ids, torch.ones_like(ids))
    cum = torch.cumsum(counts, 0)
    seg_start = cum - counts
    cnt_al = torch.div(counts + chunk - 1, chunk,
                       rounding_mode="floor") * chunk
    al_start = torch.cumsum(cnt_al, 0) - cnt_al
    P_al = (-(-n // chunk) + C) * chunk
    s = torch.arange(P_al, device=dev)
    # cluster of each aligned slot; the tail slack clips to the last one
    c_s = (torch.searchsorted(al_start, s, right=True) - 1).clamp(0, C - 1)
    off = s - al_start[c_s]
    k = seg_start[c_s] + torch.minimum(off, (counts[c_s] - 1).clamp_min(0))
    x_al = sorted_x[k.clamp(0, n - 1)]
    chunk_cids = c_s.reshape(-1, chunk)[:, 0]
    profiling.count("mlp_rows", P_al)
    out_al = mlp_forward_chunked(params, x_al, chunk_cids, chunk)
    # aligned slot of sorted rank r, written back to the caller's order
    r = torch.arange(n, device=dev)
    c_r = (torch.searchsorted(seg_start, r, right=True) - 1).clamp(0, C - 1)
    s_r = al_start[c_r] + (r - seg_start[c_r])
    out = torch.empty((n, out_al.shape[1]), dtype=out_al.dtype, device=dev)
    out[perm] = out_al[s_r]
    return out


def query_grouped(params, cluster_ids: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Shape-adaptive grouped dispatch: the chunked route for 2^16 samples
    or more, the all-clusters select below (``meganerf.py:231-240``).
    ``params`` is either kind (:class:`MLPParams`, :class:`NeRFParams`).
    The span ``model.query`` and the counters ``mlp_queries`` and
    ``mlp_rows`` come from shapes the host holds."""
    n = x.shape[0]
    route = "chunked" if n >= CHUNKED_MIN else "all"
    with profiling.annotate("model.query", route=route, rows=n):
        profiling.count("mlp_queries")
        if route == "chunked":
            return _query_chunked(params, cluster_ids, x, CHUNK)
        profiling.count("mlp_rows", params.n_clusters * n)
        ids = cluster_ids.long().clamp(0, params.n_clusters - 1)
        return mlp_forward_all(params, ids, x)


def cluster_ids_from_yz(y, z, grid_dim, min_position, pos_range):
    """The spatial cluster-id grid over world (y, z) in f32
    (``rt_core.cuh:541-549``): one home for the clip/scale/linearize
    policy, shared by the guided reconstruction and the model.  The
    grid arguments may be host arrays or tensors on ``y``'s device."""
    dev = y.device
    gd = torch.as_tensor(grid_dim, device=dev).to(torch.int32)
    gdf = gd.to(torch.float32)
    mp = torch.as_tensor(min_position, device=dev).to(torch.float32)
    rg = torch.as_tensor(pos_range, device=dev).to(torch.float32)
    g1 = torch.minimum(torch.maximum((y - mp[1]) / rg[1] * gdf[0],
                                     gdf.new_zeros(())),
                       gdf[0] - 1.0).to(torch.int32)
    g2 = torch.minimum(torch.maximum((z - mp[2]) / rg[2] * gdf[1],
                                     gdf.new_zeros(())),
                       gdf[1] - 1.0).to(torch.int32)
    return g1 * gd[1] + g2


# ----------------------------------------------------------------------
class MegaNeRFModel:
    def __init__(self, params: MLPParams, grid_dim, min_position,
                 max_position, need_viewdir: bool,
                 need_appearance_embedding: bool,
                 torch_modules: Optional[list] = None):
        self.params = params
        self.grid_dim = np.asarray(grid_dim, np.int32).reshape(2)
        self.min_position = np.asarray(
            min_position, np.float32).reshape(-1)[:3]
        self.max_position = np.asarray(
            max_position, np.float32).reshape(-1)[:3]
        self.range = self.max_position - self.min_position
        self.need_viewdir = bool(need_viewdir)
        self.need_appearance_embedding = bool(need_appearance_embedding)
        # the eager TorchScript fallback's frozen submodules (None when the
        # container converted)
        self._torch_modules = torch_modules

    @property
    def n_clusters(self) -> int:
        return self.params.n_clusters

    @property
    def output_dim(self) -> int:
        return self.params.output_dim

    @property
    def device(self) -> torch.device:
        return self.params.device

    # ------------------------------------------------------------------
    def query_device(self, cluster_ids, samples) -> torch.Tensor:
        """Grouped dispatch on the model's device (:func:`query_grouped`).
        ``cluster_ids`` [n] int, ``samples`` [n, in_dim] -> f32
        [n, out_dim] in the input order.  A fallback model goes through
        :meth:`query` (``meganerf.py:299-300``)."""
        if self._torch_modules is not None:
            return self.query(cluster_ids, samples)
        dev = self.device
        profiling.count("mlp_samples", int(samples.shape[0]))
        return query_grouped(
            self.params, torch.as_tensor(cluster_ids, device=dev).reshape(-1),
            torch.as_tensor(samples, dtype=torch.float32, device=dev))

    def cluster_ids_device(self, points_yz: torch.Tensor) -> torch.Tensor:
        """Spatial cluster id from world (y, z), on the tensor's device."""
        return cluster_ids_from_yz(points_yz[..., 0], points_yz[..., 1],
                                   self.grid_dim, self.min_position,
                                   self.range)

    def cluster_ids_for_points(self, points_yz: np.ndarray) -> np.ndarray:
        """Spatial cluster id from world (y, z), on the host."""
        g1 = np.clip((points_yz[..., 0] - self.min_position[1])
                     / self.range[1] * self.grid_dim[0],
                     0, self.grid_dim[0] - 1.0).astype(np.int32)
        g2 = np.clip((points_yz[..., 1] - self.min_position[2])
                     / self.range[2] * self.grid_dim[1],
                     0, self.grid_dim[1] - 1.0).astype(np.int32)
        return (g1 * self.grid_dim[1] + g2).astype(np.int32)

    # ------------------------------------------------------------------
    def _forward_chunk(self, cluster: int, x: torch.Tensor) -> torch.Tensor:
        """One cluster's MLP on ``x`` (``meganerf.py:327-339``): the frozen
        TorchScript submodule of a fallback model, else :func:`mlp_forward`."""
        if self._torch_modules is not None:
            with torch.inference_mode():
                return self._torch_modules[cluster](x, False).float()
        return mlp_forward(self.params, cluster, x)

    def query(self, cluster_ids, samples, nerf_batch_size: int = 1024,
              batch_mult: int = 1) -> torch.Tensor:
        """Cluster-sorted chunked inference (``meganerf.py:341-378``), the
        loop of the reference's ``query_submodules``
        (``cuda_renderer.cpp:165-203``): sort the samples by cluster on the
        host, run each cluster's MLP over chunks of ``nerf_batch_size *
        batch_mult``, scatter the results back to the input order.  JAX
        pads each chunk to a power of two to bound its compiles; eager
        PyTorch has none to bound, and rows are independent, so chunks go
        as they are.  Returns f32 [n, out_dim] on the model's device."""
        dev = self.device
        ids = np.asarray(cluster_ids.cpu() if isinstance(
            cluster_ids, torch.Tensor) else cluster_ids).reshape(-1)
        x = torch.as_tensor(samples, dtype=torch.float32, device=dev)
        n = x.shape[0]
        out = torch.zeros((n, self.output_dim), dtype=torch.float32,
                          device=dev)
        if n == 0:
            return out
        order = np.argsort(ids, kind="stable")
        uniq, starts = np.unique(ids[order], return_index=True)
        ends = np.append(starts[1:], n)
        batch = max(1, nerf_batch_size * batch_mult)
        for cluster, s, e in zip(uniq, starts, ends):
            for off in range(s, e, batch):
                idx = torch.from_numpy(order[off:min(off + batch, e)]).to(dev)
                out[idx] = self._forward_chunk(int(cluster), x[idx])
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def synthetic(data_dim: int = 4, n_clusters: int = 4,
                  hidden: int = 32, n_layers: int = 3,
                  need_viewdir: bool = False,
                  need_appearance_embedding: bool = False,
                  grid_dim=(2, 2), min_position=(-1.0, -1.0, -1.0),
                  max_position=(1.0, 1.0, 1.0),
                  seed: int = 0, device=None) -> "MegaNeRFModel":
        """Random-weight model; the weights equal the JAX package's
        ``synthetic`` with the same arguments (same draws, same order)."""
        rng = np.random.RandomState(seed)
        in_dim = 3 + (3 if need_viewdir else 0) \
            + (1 if need_appearance_embedding else 0)
        dims = [in_dim] + [hidden] * (n_layers - 1) + [data_dim + 1]
        weights, biases = [], []
        for l in range(len(dims) - 1):
            weights.append(rng.randn(n_clusters, dims[l], dims[l + 1])
                           .astype(np.float32) / np.sqrt(dims[l]))
            biases.append(rng.randn(n_clusters, dims[l + 1])
                          .astype(np.float32) * 0.1)
        if int(np.prod(grid_dim)) != n_clusters:
            raise ValueError(f"grid_dim {grid_dim} does not hold "
                             f"{n_clusters} clusters")
        return model_from_numpy(weights, biases, (), grid_dim, min_position,
                                max_position, need_viewdir,
                                need_appearance_embedding, device=device)

    @staticmethod
    def from_torchscript(container_path: str, verify: bool = True,
                         device=None) -> "MegaNeRFModel":
        """Load and convert a TorchScript Mega-NeRF container (reference
        ``Impl::load_model``, cuda_renderer.cpp:518-543).  Submodules that
        are not a Linear/ReLU stack (with skips) replaying within 1e-4 of
        their forward fall back to eager TorchScript
        (``meganerf.py:434-456``): they are frozen on the model's device and
        run through :meth:`query`; the placeholder ``params`` carry the
        output width that one probe forward reads."""
        device = resolve_device(device)
        container = torch.jit.load(str(container_path), map_location="cpu")
        n = int(container.centroids.shape[0])
        need_viewdir = bool(container.need_viewdir)
        need_appearance = bool(container.need_appearance_embedding)
        modules = []
        for i in range(n):
            m = getattr(container, f"sub_module_{i}")
            m.eval()
            modules.append(m)
        in_dim = 3 + (3 if need_viewdir else 0) + (1 if need_appearance else 0)
        grid = (container.grid_dim.numpy(), container.min_position.numpy(),
                container.max_position.numpy())
        # the parameters are read before torch.jit.freeze folds them into
        # the graph (meganerf.py:427-429)
        params = _convert_modules(modules, in_dim, verify=verify)
        if params is not None:
            return MegaNeRFModel(params.to(device), *grid, need_viewdir,
                                 need_appearance)
        out_dim = _probe_output_dim(modules[0], in_dim)
        frozen = [torch.jit.freeze(m.to(device)) if isinstance(
            m, torch.jit.ScriptModule) else m.to(device) for m in modules]
        return MegaNeRFModel(_dummy_params(len(modules), in_dim, out_dim,
                                           device),
                             *grid, need_viewdir, need_appearance,
                             torch_modules=frozen)


def model_from_numpy(weights, biases, skips, grid_dim, min_position,
                     max_position, need_viewdir: bool,
                     need_appearance_embedding: bool,
                     device=None) -> MegaNeRFModel:
    """A whole :class:`MegaNeRFModel` from host arrays and the container
    attributes (e.g. the JAX model's ``params``, ``grid_dim``,
    ``min_position``, ``max_position`` and flags)."""
    return MegaNeRFModel(params_from_numpy(weights, biases, skips, device),
                         grid_dim, min_position, max_position,
                         need_viewdir, need_appearance_embedding)


def nerf_model_from_numpy(arrays: dict, skips, grid_dim, min_position,
                          max_position, sigma_activation: str = "relu",
                          device=None) -> MegaNeRFModel:
    """A whole :class:`MegaNeRFModel` of Mega-NeRF ``NeRF`` submodules from
    host arrays (:func:`nerf_params_from_numpy`) and the container's grid;
    its input is ``[xyz, appearance id]`` (no view direction)."""
    return MegaNeRFModel(
        nerf_params_from_numpy(arrays, skips, sigma_activation, device),
        grid_dim, min_position, max_position, False, True)


def _probe_output_dim(module, in_dim: int) -> int:
    """The output width of a submodule from one forward of a zero row
    (``meganerf.py:440-449``): a fallback model's placeholder ``params``
    must carry it, since :meth:`MegaNeRFModel.query` sizes its result by
    ``output_dim``."""
    probe = torch.zeros(1, in_dim)
    with torch.inference_mode():
        try:
            y = module(probe, False)
        except Exception:      # a forward that takes the samples alone
            y = module(probe)
    return int(y.shape[-1])


def _dummy_params(n_clusters: int, in_dim: int, out_dim: int = 4,
                  device=None) -> MLPParams:
    """One zero layer of the right widths (``meganerf.py:553-557``): the
    placeholder weights of a fallback model."""
    device = resolve_device(device)
    return MLPParams(
        [torch.zeros((n_clusters, in_dim, out_dim), device=device)],
        [torch.zeros((n_clusters, out_dim), device=device)])


def _convert_modules(modules, in_dim: int, verify: bool = True):
    """Extract the Linear stacks of TorchScript modules into
    :class:`MLPParams` (``meganerf.py:459-532``), Mega-NeRF ``NeRF``
    submodules into :class:`NeRFParams` (:func:`_convert_nerf`), or None
    when they do not convert.  A layer whose input width exceeds the
    running width by exactly ``in_dim`` is a skip reinjection of the raw
    input."""
    if _is_nerf(modules[0]):
        return _convert_nerf(modules, in_dim, verify)
    all_layers = []
    skips_per_module = []
    for m in modules:
        named = dict(m.named_parameters())
        layers = []
        for name, p in m.named_parameters():
            if name.endswith("weight") and p.dim() == 2:
                b = named.get(name[:-len("weight")] + "bias")
                layers.append((p.detach().cpu().numpy(),
                               None if b is None
                               else b.detach().cpu().numpy()))
        skips = []
        h = in_dim
        for l, (w, _) in enumerate(layers):
            out_d, in_d = w.shape
            if in_d == h + in_dim:
                skips.append(l)
            elif in_d != h:
                return None
            h = out_d
        if not layers:
            return None
        all_layers.append(layers)
        skips_per_module.append(tuple(skips))

    shapes = [tuple(w.shape for w, _ in ls) for ls in all_layers]
    if len(set(shapes)) != 1 or len(set(skips_per_module)) != 1:
        return None
    weights, biases = [], []
    for l in range(len(all_layers[0])):
        weights.append(np.stack([ls[l][0].T for ls in all_layers])
                       .astype(np.float32))
        biases.append(np.stack([
            ls[l][1] if ls[l][1] is not None
            else np.zeros(ls[l][0].shape[0], np.float32)
            for ls in all_layers]).astype(np.float32))
    params = params_from_numpy(weights, biases, skips_per_module[0],
                               device="cpu")
    x = torch.from_numpy(
        np.random.RandomState(0).randn(8, in_dim).astype(np.float32))
    return params if not verify or _replays(params, modules, x) else None


def _replays(params, modules, x: torch.Tensor) -> bool:
    """Whether each cluster's converted forward gives its module's output
    on ``x`` within 1e-4."""
    for c, m in enumerate(modules):
        # no_grad, not inference_mode: a scripted graph that ran with
        # autograd on may then refuse inference tensors
        with torch.no_grad():
            want = m(x, False)
        got = mlp_forward(params, c, x)
        if want.shape != got.shape or not torch.allclose(
                want, got, rtol=1e-4, atol=1e-4):
            return False
    return True


# the parameters of a Mega-NeRF ``NeRF`` (``mega_nerf/models/nerf.py``)
# with an SH head, an appearance embedding and no direction encoding
_NERF_HEADS = {"sigma": "sigma", "final": "xyz_encoding_final",
               "dir_a": "dir_a_encoding.0", "rgb": "rgb"}
_NERF_ACTIVATIONS = {"ReLU": "relu", "ShiftedSoftplus": "softplus"}


def _is_nerf(module) -> bool:
    names = {n for n, _ in module.named_parameters()}
    return "xyz_encodings.0.0.weight" in names and "embedding_a.weight" \
        in names and all(f"{p}.weight" in names
                         for p in _NERF_HEADS.values())


def _convert_nerf(modules, in_dim: int,
                  verify: bool = True) -> Optional[NeRFParams]:
    """Mega-NeRF ``NeRF`` submodules into :class:`NeRFParams`, or None
    when one has a part the port does not run (a direction encoding, an
    affine appearance, another sigma activation), their shapes differ or
    they do not replay.  A trunk layer whose input width exceeds the
    layer width by the encoding's is a skip of the encoding."""
    if in_dim != 4:
        return None
    per = []
    for m in modules:
        named = {n: p.detach().cpu().numpy()
                 for n, p in m.named_parameters()}
        act = getattr(getattr(m, "sigma_activation", None), "original_name",
                      type(getattr(m, "sigma_activation", None)).__name__)
        freqs = getattr(getattr(m, "embedding_xyz", None), "freq_bands",
                        None)
        if any(n.startswith("affine.") for n in named) \
                or act not in _NERF_ACTIVATIONS or freqs is None:
            return None
        trunk = []
        while f"xyz_encodings.{len(trunk)}.0.weight" in named:
            k = f"xyz_encodings.{len(trunk)}.0."
            trunk.append((named[k + "weight"], named[k + "bias"]))
        heads = {k: (named[p + ".weight"], named[p + ".bias"])
                 for k, p in _NERF_HEADS.items()}
        per.append((np.asarray(torch.as_tensor(freqs), np.float32), trunk,
                    heads, named["embedding_a.weight"],
                    _NERF_ACTIVATIONS[act]))
    freqs, trunk, heads, _, act = per[0]
    enc = 3 + 6 * freqs.shape[0]
    width = trunk[0][0].shape[0]
    skips = []
    for l, (w, _) in enumerate(trunk):
        if l and w.shape == (width, width + enc):
            skips.append(l)
        elif w.shape != (width, enc if l == 0 else width):
            return None
    if heads["dir_a"][0].shape[1] != width + per[0][3].shape[1]:
        return None             # a direction encoding in the colour branch
    sig = [(f.tobytes(), [w.shape for w, _ in t],
            {k: v[0].shape for k, v in h.items()}, e.shape, a)
           for f, t, h, e, a in per]
    if any(s_ != sig[0] for s_ in sig):
        return None

    def stack(get):
        return np.stack([get(p) for p in per]).astype(np.float32)
    arrays = {"freq_bands": freqs,
              "trunk_w": [stack(lambda p, l=l: p[1][l][0].T)
                          for l in range(len(trunk))],
              "trunk_b": [stack(lambda p, l=l: p[1][l][1])
                          for l in range(len(trunk))],
              "appearance": stack(lambda p: p[3])}
    for k in NeRFParams.HEADS:
        arrays[f"{k}_w"] = stack(lambda p, k=k: p[2][k][0].T)
        arrays[f"{k}_b"] = stack(lambda p, k=k: p[2][k][1])
    params = nerf_params_from_numpy(arrays, skips, act, device="cpu")
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(8, 3), rng.randint(
        0, per[0][3].shape[0], (8, 1))], 1).astype(np.float32)
    return params if not verify or _replays(
        params, modules, torch.from_numpy(x)) else None
