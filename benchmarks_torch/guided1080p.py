"""``benchmarks/guided1080p.py`` through the port: guided ray sampling at
1080p on one CUDA card.

It measures the two phases the reference exposes
(cuda_renderer.cpp:107-139):

* invalidation latency: the collect march (kernels B and C), the compact
  reconstruction and the grouped MLP query (``torch.bmm``), first
  unordered, then in the ``(steps, ns)`` order of the first invalidation's
  hints, then segmented by the CDF budgets of its sample counts; median of
  3, each forced by one scalar read;
* the steady composite: the compact cache composited by kernel D, warmed
  twice, then 10 frames.

The scene is JAX's: ``shell_tree(depth=8, basis_dim=1, sigma_inside=400)``
and a synthetic 8-cluster Mega-NeRF model, 8 layers of 256 (seed 0).

Usage: python benchmarks_torch/guided1080p.py [max_guided_samples] [tree.npz]
(the optional npz runs the guided pipeline on that artifact; the model then
matches its data_dim).  Prints ONE JSON line:

  {"metric": "guided_sampling_1080p", "invalidation_ms": ms,
   "invalidation_segmented_ms": ms, "mlp_samples": n,
   "composite_compact_ms": ms, "max_guided_samples": S}

and, with an npz, ``tree`` and ``chunks``.  JAX's ``composite_pallas_ms``
has no counterpart: JAX times two compositors, its XLA scan and its Pallas
kernel, and ``composite_frame``'s ``use_pallas`` picks between them.  In the
port that switch is inert and the card has one compositor, kernel D, the
Pallas kernel's counterpart; ``composite_compact_ms`` times it.  JAX's
check that its gate did not fall back to XLA has no counterpart either:
here the script raises unless kernel D's launch count rose inside the
timed window (on the card).

Environment: ``_overrides_torch`` (``BENCH_FORCE_CPU``, ``BENCH_WH``,
``BENCH_DEPTH``).  On stderr: the card and its power limit, and the kernel
launches of the run.
"""

import os
import sys
import time
from types import SimpleNamespace

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import _overrides_torch
from _overrides_torch import GUIDED_MODEL


def run(S=32, tree_path=None, width=1920, height=1080, depth=8,
        device=None):
    """The protocol on ``device`` (``None``: the card).  Returns (record
    without ``smoke``, namespace of the caches, the order, the segments and
    the composite frame)."""
    import torch
    import mega_nerf_viewer_tpu_torch as P
    from mega_nerf_viewer_tpu_torch import kernels
    from mega_nerf_viewer_tpu_torch.device import resolve_device
    from mega_nerf_viewer_tpu_torch.ops import accel, guided
    dev = resolve_device(device)
    cs = min(1920, width)
    if tree_path:
        tree = P.N3Tree.open(tree_path, device=dev)
    else:
        tree = P.shell_tree(depth=depth, basis_dim=1, sigma_inside=400.0,
                            device=dev)
    lm = accel.build_leaf_map(tree)
    model = P.MegaNeRFModel.synthetic(data_dim=int(tree.data_dim),
                                      device=dev, **GUIDED_MODEL)
    opt = P.RenderOptions(max_guided_samples=S, need_viewdir=True,
                          use_guided_sampling=True)
    cam = _overrides_torch.camera(width, height, 1111.0)
    skip_table = P.build_skip_table(tree, opt.sigma_thresh)

    # warm; the first invalidation also yields the per-ray sample counts
    # and collect steps that order the later collect marches
    cache = guided.collect_and_query_fast(tree, lm, model, cam, opt,
                                          chunk_size=cs,
                                          skip_table=skip_table)
    float(cache["results_c"].sum())
    ns_h = cache["num_samples"].cpu().numpy()
    order = accel.order_from_hints(cache["collect_steps"].cpu(), ns_h)
    order = tuple(o.to(dev) for o in order)
    cache = guided.collect_and_query_fast(tree, lm, model, cam, opt,
                                          chunk_size=cs,
                                          skip_table=skip_table,
                                          order=order)
    float(cache["results_c"].sum())     # warm the ordered path

    def time_invalidation(**kw):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            c = guided.collect_and_query_fast(
                tree, lm, model, cam, opt, chunk_size=cs,
                skip_table=skip_table, order=order, **kw)
            float(c["results_c"].sum())   # force the card
            ts.append((time.perf_counter() - t0) * 1000.0)
        return c, sorted(ts)[1]

    cache, invalidation_ms = time_invalidation()
    n_samples = int(cache["num_samples"].sum())

    # the CDF-budget segmented collect (the Viewer's, once hints exist)
    segs = guided.segments_from_ns_hints(ns_h, S)
    cache_s = guided.collect_and_query_fast(
        tree, lm, model, cam, opt, chunk_size=cs,
        skip_table=skip_table, order=order, segments=segs)
    float(cache_s["results_c"].sum())   # warm (escalation settles here)
    cache_s, invalidation_seg_ms = time_invalidation(segments=segs)
    n_samples_seg = int(cache_s["num_samples"].sum())
    assert n_samples_seg == n_samples, (n_samples_seg, n_samples)

    def comp():
        img = guided.composite_frame(tree, cam, opt, cache)
        return float(img.sum()), img

    comp()                               # warm
    comp()
    before = kernels.LAUNCHES["compact_composite"]
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        _, img = comp()
    composite_ms = (time.perf_counter() - t0) / n * 1000
    launched = kernels.LAUNCHES["compact_composite"] - before
    if dev.type == "cuda" and launched < n:
        raise RuntimeError(f"kernel D launched {launched} times in the "
                           f"{n} timed composites")

    record = {
        "metric": "guided_sampling_1080p",
        "invalidation_ms": round(invalidation_ms, 1),
        "invalidation_segmented_ms": round(invalidation_seg_ms, 1),
        "mlp_samples": n_samples,
        "composite_compact_ms": round(composite_ms, 1),
        "max_guided_samples": S,
    }
    if tree_path:
        record["tree"] = os.path.basename(tree_path)
        record["chunks"] = int(tree.capacity)
    return record, SimpleNamespace(
        cache=cache, cache_s=cache_s, order=order, segments=segs,
        n_samples_seg=n_samples_seg, img=img)


def main():
    S = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    tree_path = sys.argv[2] if len(sys.argv) > 2 else None
    width, height, depth, smoke, dev = _overrides_torch.apply(1920, 1080, 8)
    record, ns = run(S, tree_path, width, height, depth, dev)
    _overrides_torch.emit(record, dev, smoke)
    print(f"# mlp_samples: ordered {record['mlp_samples']}, segmented "
          f"{ns.n_samples_seg}", file=sys.stderr)


if __name__ == "__main__":
    main()
