"""Mega-NeRF's per-cluster model (Turki et al., "Mega-NeRF", CVPR 2022;
``mega_nerf/models/nerf.py``, class ``NeRF``) with an SH head, an
appearance embedding and no direction encoding.

``spec`` (a configuration's ``model`` block): ``weights_seed``,
``grid_dim``, ``min_position``, ``max_position``, ``need_viewdir``
(false), ``need_appearance_embedding`` (true), and ``nerf.py``'s options
``pos_xyz_dim``, ``pos_dir_dim`` (0), ``layers``, ``skip_layers``,
``layer_dim``, ``appearance_dim``, ``affine_appearance`` (false),
``appearance_count``, ``rgb_dim``, ``xyz_dim`` (3) and
``sigma_activation`` (``relu`` or ``softplus``).  The weights are drawn by
numpy from ``weights_seed`` alone: the ReLU layers (the trunk, the colour
branch) He-normal, the heads (sigma, ``xyz_encoding_final``, rgb) at a
gain of 1, biases N(0, 0.1^2), the appearance table N(0, 1) as
``nn.Embedding`` draws it.

For a row ``[p (3), appearance id]``: ``g = [p, sin(f_0 p), cos(f_0 p),
...]`` with ``f = 2 ** linspace(0, F - 1, F)``; ``h = g``; each trunk
layer ``l``: ``h = cat[g, h]`` if ``l`` is a skip, then ``h = ReLU(W_l h
+ b_l)``; ``sigma = act(W_s h + b_s)``; ``f = W_f h + b_f``; ``a =
E[id]``; ``c = W_c ReLU(W_g cat[f, a] + b_g) + b_c``; out ``cat[c,
sigma]``.
"""

import numpy as np
import torch

HEADS = ("sigma", "final", "dir_a", "rgb")


def _check(spec: dict) -> None:
    if int(spec.get("pos_dir_dim", 0)) or spec.get("affine_appearance") \
            or spec.get("need_viewdir") or int(spec["xyz_dim"]) != 3 \
            or not int(spec["appearance_dim"]):
        raise ValueError("the model block asks for a part this model file "
                         "does not hold (a direction encoding, an affine "
                         "appearance, view directions or no appearance)")


def widths(spec: dict) -> dict:
    """Each product's (in, out) width: ``trunk`` (a list) and the heads."""
    _check(spec)
    enc = 3 + 6 * int(spec["pos_xyz_dim"])
    W = int(spec["layer_dim"])
    skips = set(spec["skip_layers"])
    trunk = [(enc if l == 0 else W + (enc if l in skips else 0), W)
             for l in range(int(spec["layers"]))]
    return {"trunk": trunk, "sigma": (W, 1), "final": (W, W),
            "dir_a": (W + int(spec["appearance_dim"]), W // 2),
            "rgb": (W // 2, int(spec["rgb_dim"]))}


def arrays(spec: dict) -> dict:
    """Host arrays of every cluster, f32: ``freq_bands``, ``trunk_w`` /
    ``trunk_b`` (lists of [C, in, out] / [C, out]), ``<head>_w`` /
    ``<head>_b`` and ``appearance`` [C, appearance_count,
    appearance_dim]."""
    rng = np.random.default_rng(int(spec["weights_seed"]))
    C = int(np.prod(spec["grid_dim"]))
    wd = widths(spec)

    def layer(fan_in, fan_out, gain):
        w = rng.standard_normal((C, fan_in, fan_out)) * np.sqrt(gain / fan_in)
        b = rng.standard_normal((C, fan_out)) * 0.1
        return w.astype(np.float32), b.astype(np.float32)
    F = int(spec["pos_xyz_dim"])
    out = {"freq_bands": (2.0 ** np.linspace(0, F - 1, F)).astype(np.float32),
           "trunk_w": [], "trunk_b": []}
    for fan_in, fan_out in wd["trunk"]:
        w, b = layer(fan_in, fan_out, 2.0)
        out["trunk_w"].append(w)
        out["trunk_b"].append(b)
    for k in HEADS:
        out[f"{k}_w"], out[f"{k}_b"] = layer(*wd[k], 2.0 if k == "dir_a"
                                             else 1.0)
    out["appearance"] = rng.standard_normal(
        (C, int(spec["appearance_count"]), int(spec["appearance_dim"]))
    ).astype(np.float32)
    return out


def build(spec: dict, device):
    """The port's model from the arrays."""
    from mega_nerf_viewer_tpu_torch.models.meganerf import \
        nerf_model_from_numpy
    return nerf_model_from_numpy(
        arrays(spec), tuple(spec["skip_layers"]), spec["grid_dim"],
        spec["min_position"], spec["max_position"],
        spec["sigma_activation"], device=device)


def reference(spec: dict, device):
    """The plain forward ``(cluster_ids [n], x [n, 4], dtype) -> f32
    [n, 3 * basis + 1]``: each cluster's rows through its model, the
    encoding in float32 and everything after it in ``dtype`` (float32 with
    TF32 off; a lower ``dtype`` is the reference viewer's autocast, which
    leaves sin and cos in float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    a = arrays(spec)

    def t(v):
        return torch.as_tensor(v, device=device)
    freqs = t(a["freq_bands"])
    trunk = [(t(w), t(b)) for w, b in zip(a["trunk_w"], a["trunk_b"])]
    heads = {k: (t(a[f"{k}_w"]), t(a[f"{k}_b"])) for k in HEADS}
    table = t(a["appearance"])
    skips = set(spec["skip_layers"])
    softplus = spec["sigma_activation"] == "softplus"

    def forward(cluster_ids, x, dtype=torch.float32):
        out = torch.zeros((x.shape[0], heads["rgb"][0].shape[2] + 1),
                          dtype=torch.float32, device=x.device)

        def lin(h, wb, c):
            return h @ wb[0][c].to(dtype) + wb[1][c].to(dtype)
        for c in torch.unique(cluster_ids).tolist():
            rows = torch.nonzero(cluster_ids == c).reshape(-1)
            p = x[rows, :3]
            enc = [p]
            for f in freqs:
                enc += [torch.sin(f * p), torch.cos(f * p)]
            g = torch.cat(enc, -1).to(dtype)
            h = g
            for l, wb in enumerate(trunk):
                if l in skips:
                    h = torch.cat([g, h], -1)
                h = torch.relu(lin(h, wb, c))
            s = lin(h, heads["sigma"], c)
            s = torch.nn.functional.softplus(s - 1) if softplus \
                else torch.relu(s)
            f = lin(h, heads["final"], c)
            emb = table[c][x[rows, 3].long()].to(dtype)
            g2 = torch.relu(lin(torch.cat([f, emb], -1), heads["dir_a"], c))
            out[rows] = torch.cat([lin(g2, heads["rgb"], c), s], -1).float()
        return out
    return forward


def work(spec: dict) -> tuple:
    """(operations a row, bytes a row, bytes of the weights) of the
    products: 2 per multiply-add; a row's f32 input read and output
    written by each product; each weight and bias read once."""
    wd = widths(spec)
    prods = wd["trunk"] + [wd[k] for k in HEADS]
    ops = 2 * sum(i * o for i, o in prods)
    row_bytes = 4 * sum(i + o for i, o in prods)
    C = int(np.prod(spec["grid_dim"]))
    weight_bytes = 4 * C * sum(i * o + o for i, o in prods)
    return ops, row_bytes, weight_bytes
