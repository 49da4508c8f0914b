"""A fixture model for the benchmark's tests: per-cluster Linear/ReLU
stacks with a skip of the input, at a test's size.

``spec`` (a configuration's ``model`` block): ``weights_seed``,
``grid_dim``, ``min_position``, ``max_position``, ``need_viewdir``,
``need_appearance_embedding``, ``input_dim``, ``hidden``, ``layers`` (the
hidden layers), ``skips`` (layers whose input is the hidden state and the
input side by side) and ``output_dim``.  The weights are drawn by numpy
from ``weights_seed`` alone.
"""

import numpy as np
import torch


def arrays(spec: dict) -> tuple:
    """(weights [C, in, out], biases [C, out]) of every layer, f32."""
    rng = np.random.default_rng(int(spec["weights_seed"]))
    C = int(np.prod(spec["grid_dim"]))
    x_dim = int(spec["input_dim"])
    dims = [x_dim] + [int(spec["hidden"])] * int(spec["layers"]) \
        + [int(spec["output_dim"])]
    weights, biases = [], []
    for l in range(len(dims) - 1):
        fan_in = dims[l] + (x_dim if l in spec["skips"] else 0)
        gain = 2.0 if l < len(dims) - 2 else 1.0
        weights.append((rng.standard_normal((C, fan_in, dims[l + 1]))
                        * np.sqrt(gain / fan_in)).astype(np.float32))
        biases.append((rng.standard_normal((C, dims[l + 1])) * 0.1)
                      .astype(np.float32))
    return weights, biases


def build(spec: dict, device):
    """The port's model from the arrays."""
    from mega_nerf_viewer_tpu_torch.models.meganerf import model_from_numpy
    weights, biases = arrays(spec)
    return model_from_numpy(
        weights, biases, tuple(spec["skips"]), spec["grid_dim"],
        spec["min_position"], spec["max_position"], spec["need_viewdir"],
        spec["need_appearance_embedding"], device=device)


def reference(spec: dict, device):
    """The plain forward ``(cluster_ids [n], x [n, in], dtype) -> f32
    [n, out]``: each cluster's rows through its stack, in ``dtype``
    (float32 with TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights, biases = arrays(spec)
    ws = [torch.as_tensor(w, device=device) for w in weights]
    bs = [torch.as_tensor(b, device=device) for b in biases]
    skips = set(spec["skips"])

    def forward(cluster_ids, x, dtype=torch.float32):
        out = torch.zeros((x.shape[0], ws[-1].shape[2]), dtype=torch.float32,
                          device=x.device)
        for c in torch.unique(cluster_ids).tolist():
            rows = torch.nonzero(cluster_ids == c).reshape(-1)
            x0 = x[rows].to(dtype)
            h = x0
            for l, (w, b) in enumerate(zip(ws, bs)):
                if l in skips:
                    h = torch.cat([h, x0], -1)
                h = h @ w[c].to(dtype) + b[c].to(dtype)
                if l < len(ws) - 1:
                    h = torch.relu(h)
            out[rows] = h.float()
        return out
    return forward
