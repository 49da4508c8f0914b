"""N3Tree: the PlenOctree sparse voxel octree as a dataclass of tensors.

Counterpart of ``mega_nerf_viewer_tpu/n3tree/tree.py`` (reference:
``src/n3tree/n3tree.cpp``, ``include/n3tree/n3tree.hpp``,
``include/data_spec.hpp:25-50``).  The data model is the same contract:

  * ``data: f16[max_capacity, N^3, data_dim]`` — per-leaf payload, SH
    coefficients channel-major with sigma LAST (``rt_core.cuh:231``).
  * ``child: i32[max_capacity, N^3]`` — RELATIVE chunk offset to the child
    chunk; 0 means leaf (``rt_core.cuh:146-153``).
  * ``parent: i32[max_capacity]`` — packed ``parent_chunk*N^3 + slot``.
  * ``sample_counts: i16[max_capacity, N^3]`` — initialised to 8.
  * ``scale: f32[3]``, ``offset: f32[3]`` — world->tree map
    ``q = offset + scale * x``.
  * ``capacity`` — live chunk count (a Python int here); arrays are
    over-allocated to ``max_capacity`` with a zero tail.

For this renderer the octree *is* the weights: :func:`tree_from_numpy`
carries a tree across from the JAX package's arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .data_format import DataFormat


@dataclasses.dataclass(frozen=True)
class N3Tree:
    data: torch.Tensor           # f16 [max_capacity, N^3, data_dim]
    child: torch.Tensor          # i32 [max_capacity, N^3]
    parent: torch.Tensor         # i32 [max_capacity]
    sample_counts: torch.Tensor  # i16 [max_capacity, N^3]
    scale: torch.Tensor          # f32 [3]
    offset: torch.Tensor         # f32 [3]
    capacity: int
    N: int = 2
    data_dim: int = 4
    data_format: DataFormat = dataclasses.field(default_factory=DataFormat)

    @property
    def N3(self) -> int:
        return self.N ** 3

    @property
    def max_capacity(self) -> int:
        return self.data.shape[0]

    @property
    def basis_dim(self) -> int:
        return self.data_format.basis_dim

    @property
    def device(self) -> torch.device:
        return self.data.device

    def pack_index(self, nd: int, i: int, j: int, k: int) -> int:
        """Pack (chunk, i, j, k) into a flat node id (``n3tree.cpp:331-335``)."""
        if not (0 <= i < self.N and 0 <= j < self.N and 0 <= k < self.N):
            raise ValueError(f"child index ({i}, {j}, {k}) outside N={self.N}")
        return nd * self.N3 + i * self.N * self.N + j * self.N + k

    def unpack_index(self, packed: int) -> Tuple[int, int, int, int]:
        """Inverse of :meth:`pack_index` (``n3tree.cpp:337-345``)."""
        k = packed % self.N
        packed //= self.N
        j = packed % self.N
        packed //= self.N
        i = packed % self.N
        packed //= self.N
        return packed, i, j, k

    def save_npz(self, path: str) -> None:
        """Write the live chunks back in the svox schema (``tree.py:182-214``
        of the JAX package; the reference never writes a tree).  Column 1 of
        ``parent_depth`` holds each chunk's depth, found by a fixpoint over
        the parent chain (root 0); the loader reads column 0 only."""
        cap = int(self.capacity)
        parent = self.parent[:cap].cpu().numpy()
        parent_depth = np.zeros((cap, 2), dtype=np.int32)
        parent_depth[:, 0] = parent
        pc = np.clip(parent // self.N3, 0, max(cap - 1, 0))
        depth = np.zeros(cap, dtype=np.int32)
        nonroot = np.arange(cap) > 0
        for _ in range(64):
            nd = np.where(nonroot, depth[pc] + 1, 0).astype(np.int32)
            if np.array_equal(nd, depth):
                break
            depth = nd
        parent_depth[:, 1] = depth
        np.savez(
            path,
            data_dim=np.int64(self.data_dim),
            data_format=np.str_(self.data_format.to_string()),
            invradius3=self.scale.cpu().numpy().astype(np.float32),
            offset=self.offset.cpu().numpy().astype(np.float32),
            child=self.child[:cap].cpu().numpy().reshape(
                cap, self.N, self.N, self.N),
            parent_depth=parent_depth,
            data=self.data[:cap].cpu().numpy().astype(np.float16),
            sample_counts=self.sample_counts[:cap].cpu().numpy(),
        )

    def gen_wireframe(self, max_depth: int = 4) -> np.ndarray:
        """World-space AABBs of the leaves, and of the nodes at
        ``max_depth``, as ``[n_boxes, 6]`` f32 (min_xyz, max_xyz), in the
        order of a depth-first walk of ``child[:capacity]`` on the host
        (``tree.py:219-255`` of the JAX package; reference
        ``N3Tree::gen_wireframe``, ``n3tree.cpp:324-329``, which emits GL
        line vertices instead)."""
        child = self.child[: int(self.capacity)].cpu().numpy()
        scale = self.scale.cpu().numpy()
        offset = self.offset.cpu().numpy()
        N = self.N
        boxes = []

        def rec(nodeid: int, xi: int, yi: int, zi: int, depth: int,
                gridsz: int) -> None:
            cnt = 0
            for i in range(xi * N, (xi + 1) * N):
                for j in range(yi * N, (yi + 1) * N):
                    for k in range(zi * N, (zi + 1) * N):
                        c = int(child[nodeid, cnt])
                        if c == 0 or depth >= max_depth:
                            lo = (np.array([i, j, k], np.float32) / gridsz
                                  - offset) / scale
                            hi = (np.array([i + 1, j + 1, k + 1], np.float32)
                                  / gridsz - offset) / scale
                            boxes.append(np.concatenate([lo, hi]))
                        else:
                            rec(nodeid + c, i, j, k, depth + 1, gridsz * N)
                        cnt += 1

        rec(0, 0, 0, 0, 0, N)
        if not boxes:
            return np.zeros((0, 6), np.float32)
        return np.stack(boxes).astype(np.float32)

    @staticmethod
    def from_arrays(data: np.ndarray, child: np.ndarray,
                    parent: np.ndarray, scale: np.ndarray,
                    offset: np.ndarray, data_format: DataFormat,
                    sample_counts: Optional[np.ndarray] = None,
                    max_capacity: Optional[int] = None,
                    capacity: Optional[int] = None,
                    device=None) -> "N3Tree":
        """Build a tree from host arrays, zero-padding to ``max_capacity``
        (``N3Tree::move_to_device``, ``n3tree.cpp:207-246``)."""
        device = resolve_device(device)
        cap = int(data.shape[0]) if capacity is None else int(capacity)
        n3 = int(child.shape[1])
        n = round(n3 ** (1.0 / 3.0))
        if n * n * n != n3:
            raise ValueError(f"child.shape[1]={n3} is not a cube")
        max_cap = cap if max_capacity is None else int(max_capacity)
        if max_cap < cap:
            raise ValueError("max_capacity smaller than current capacity")

        def _pad(a: np.ndarray) -> np.ndarray:
            out = np.zeros((max_cap,) + a.shape[1:], dtype=a.dtype)
            out[:cap] = a[:cap]
            return out

        if sample_counts is None:
            sample_counts = np.full((cap, n3), 8, dtype=np.int16)
        return tree_from_numpy(
            data=_pad(data.astype(np.float16)),
            child=_pad(child.astype(np.int32)),
            parent=_pad(parent.astype(np.int32)),
            sample_counts=_pad(sample_counts.astype(np.int16)),
            scale=scale, offset=offset, capacity=cap,
            data_format=data_format, device=device)

    @staticmethod
    def open(path: str, max_capacity: Optional[int] = None,
             bounds_only: bool = False, vq_bug_compat: bool = True,
             device=None) -> "N3Tree":
        """Load a PlenOctree ``.npz`` in the svox schema (``N3Tree::open``
        + ``load_npz``, ``n3tree.cpp:16-205``).  ``bounds_only`` keeps the
        root chunk with all leaves (``main.cpp:529-539``).  The arrays are
        read by the native loader when it is available (``native.py``),
        else by numpy, as in the JAX package (``tree.py:155-160``)."""
        if not str(path).endswith(".npz"):
            raise ValueError("expected a .npz file")
        device = resolve_device(device)
        from .. import native
        npz = None
        if native.available():
            try:
                npz = native.load_npz(str(path))
            except RuntimeError:
                npz = None
        if npz is not None:
            host = load_npz_host(npz, vq_bug_compat=vq_bug_compat)
        else:
            with np.load(path, allow_pickle=False) as npz:
                host = load_npz_host(npz, vq_bug_compat=vq_bug_compat)
        (data, child, parent, scale, offset, data_format,
         sample_counts) = host
        if bounds_only:
            data = data[:1]
            child = np.zeros_like(child[:1])
            parent = parent[:1]
            if sample_counts is not None:
                sample_counts = sample_counts[:1]
        return N3Tree.from_arrays(
            data, child, parent, scale, offset, data_format,
            sample_counts=sample_counts, max_capacity=max_capacity,
            device=device)


def tree_from_numpy(*, data, child, parent, sample_counts, scale, offset,
                    capacity: int, data_format, device=None) -> N3Tree:
    """The port's tree from already-padded host arrays.

    This is how a scene crosses from the JAX package:
    ``tree_from_numpy(data=np.asarray(jax_tree.data), ...,
    capacity=int(jax_tree.capacity), data_format=jax_tree.data_format)``.
    ``data_format`` may be any object with ``format`` and ``basis_dim``."""
    device = resolve_device(device)
    data_format = DataFormat(format=data_format.format,
                             basis_dim=int(data_format.basis_dim))
    child = np.asarray(child, np.int32)
    n = round(child.shape[1] ** (1.0 / 3.0))
    data = np.asarray(data, np.float16)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return N3Tree(
        data=t(data, np.float16),
        child=t(child, np.int32),
        parent=t(parent, np.int32),
        sample_counts=t(sample_counts, np.int16),
        scale=t(np.asarray(scale).reshape(3), np.float32),
        offset=t(np.asarray(offset).reshape(3), np.float32),
        capacity=int(capacity),
        N=n,
        data_dim=int(data.shape[2]),
        data_format=data_format,
    )


# ----------------------------------------------------------------------
# Host-side npz decoding (numpy; same as the JAX package's loader)
# ----------------------------------------------------------------------
def _decode_data_format(npz):
    """Read data_dim and the data_format string (svox saves it as UTF-32,
    ``n3tree.cpp:33-37``; numpy decodes '<U' natively)."""
    data_dim = int(np.asarray(npz["data_dim"]).reshape(-1)[0])
    arr = np.asarray(npz["data_format"])
    if arr.dtype.kind in ("U", "S"):
        s = arr.reshape(-1)[0]
        if isinstance(s, bytes):
            s = s.decode("utf-8")
    else:
        s = arr.tobytes()[::4].decode("ascii")
    return data_dim, DataFormat.parse(str(s))


def load_npz_host(npz, vq_bug_compat: bool = True):
    """Decode an svox npz into host arrays (``N3Tree::load_npz``,
    ``n3tree.cpp:28-205``).

    Returns (data f16, child i32 [cap, N^3], parent i32, scale f32[3],
    offset f32[3], data_format, sample_counts i16 or None).  VQ colours
    decode from ``quant_colors`` + ``quant_map`` (+ ``data_retained``);
    ``vq_bug_compat=True`` replicates the reference writing every basis
    to index ``channel * n_basis`` (``n3tree.cpp:145,161``), ``False``
    uses the intended ``channel * n_basis + basis``.
    """
    data_dim, data_format = _decode_data_format(npz)
    if "invradius3" in npz:
        scale = np.asarray(npz["invradius3"], dtype=np.float32).reshape(3)
    else:
        scale = np.full(
            3, float(np.asarray(npz["invradius"]).reshape(-1)[0]),
            dtype=np.float32)
    offset = np.asarray(npz["offset"], dtype=np.float32).reshape(3)

    child_node = np.asarray(npz["child"])
    n = int(child_node.shape[1])
    n3 = n * n * n
    child = child_node.reshape(child_node.shape[0], n3).astype(np.int32)

    parent_depth = np.asarray(npz["parent_depth"])
    if parent_depth.itemsize != 4:
        raise ValueError("parent_depth must be 4-byte ints")
    parent = parent_depth.reshape(parent_depth.shape[0], -1)[:, 0].astype(
        np.int32)

    if "quant_colors" in npz:
        data = _decode_vq(npz, data_dim, n3, vq_bug_compat)
    else:
        data_node = np.asarray(npz["data"])
        if data_node.dtype != np.float16:
            raise ValueError("data must be stored in half precision")
        data = data_node.reshape(data_node.shape[0], n3, data_dim)

    if data.shape[0] != parent.shape[0]:
        raise ValueError("data and parent sizes not aligned")
    if data.shape[0] != child.shape[0]:
        raise ValueError("data and child sizes not aligned")
    sample_counts = None
    if "sample_counts" in npz:
        sc = np.asarray(npz["sample_counts"])
        if sc.shape[0] == data.shape[0]:
            sample_counts = sc.reshape(sc.shape[0], -1).astype(np.int16)
    return data, child, parent, scale, offset, data_format, sample_counts


def _decode_vq(npz, data_dim: int, n3: int, bug_compat: bool) -> np.ndarray:
    """VQ colour decode (reference ``n3tree.cpp:109-175``): the native
    decoder when it is available (``tree.py:363-366`` of the JAX package),
    else vectorized numpy."""
    quant_colors = np.asarray(npz["quant_colors"])       # [nq, 65536, 3] f16
    if quant_colors.dtype != np.float16:
        raise ValueError("codebook must be stored in half precision")
    quant_map = np.asarray(npz["quant_map"]).astype(np.int64)  # [nq, cap, N3]
    n_basis_q = quant_map.shape[0]
    if quant_colors.shape[0] != n_basis_q:
        raise ValueError("codebook and map basis numbers does not match")
    retained = np.asarray(npz["data_retained"]) if "data_retained" in npz \
        else None
    n_retain = retained.shape[0] if retained is not None else 0
    n_basis = n_basis_q + n_retain
    capacity = quant_map.shape[1]

    from .. import native
    if native.available():
        sigma_arr = np.asarray(npz["sigma"]).reshape(capacity, n3)
        return native.vq_decode(
            np.asarray(npz["quant_map"]), quant_colors,
            retained.reshape(n_retain, capacity, n3).astype(np.float16)
            if retained is not None else None,
            sigma_arr, data_dim, bug_compat=bug_compat)

    data = np.zeros((capacity, n3, data_dim), dtype=np.float16)
    decoded = quant_colors[np.arange(n_basis_q)[:, None, None],
                           quant_map]                     # [nq, cap, N3, 3]
    for b in range(n_basis_q):
        basis = n_retain + b
        for ch in range(3):
            idx = ch * n_basis if bug_compat else ch * n_basis + basis
            data[:, :, idx] = decoded[b, :, :, ch]
    if n_retain:
        # the reference reads retain_ptr[b*cap*N3 + i*N3 + j + channel]:
        # three consecutive scalars of the flat [n_retain, cap, N3] buffer
        flat = retained.reshape(-1)
        base = (np.arange(n_retain)[:, None, None] * capacity * n3
                + np.arange(capacity)[None, :, None] * n3
                + np.arange(n3)[None, None, :])
        for b in range(n_retain):
            for ch in range(3):
                idx = ch * n_basis if bug_compat else ch * n_basis + b
                src = np.minimum(base[b] + ch, flat.shape[0] - 1)
                data[:, :, idx] = flat[src]
    sigma = np.asarray(npz["sigma"]).reshape(capacity, n3)
    data[:, :, data_dim - 1] = sigma
    return data
