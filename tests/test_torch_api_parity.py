"""The port's public API against the JAX package's.

A call written against ``mega_nerf_viewer_tpu``, positional or by keyword,
either binds the same meaning in ``mega_nerf_viewer_tpu_torch`` or raises
``TypeError``.  For every module of the JAX package that has a
counterpart: its ``__all__`` is the port's, and every public function and
every public method of a public class defined there exists in the port,
with JAX's parameter names first, in JAX's order, and the same method kind
(or, for ``Viewer.get_backend``, one that answers on the class and on an
instance).  Parameters the port adds come after JAX's and are among
``PORT_ONLY``.  ``ALLOWED`` names what deliberately differs, each with its
reason (an entry naming a class covers its methods); a case holds that
each entry still differs, so the list cannot go stale.  The last cases call the repaired signatures the JAX way.
"""

import importlib
import inspect
import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mega_nerf_viewer_tpu as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu.ops import render as JR
from mega_nerf_viewer_tpu.options import RenderOptions
from mega_nerf_viewer_tpu_torch.ops import accel as PA
from mega_nerf_viewer_tpu_torch.ops import guided as PG
from mega_nerf_viewer_tpu_torch.ops import render as PR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPKG, PPKG = J.__name__, P.__name__

# trailing parameters the port adds after JAX's: the torch device, the
# draws that replace JAX's threefry keys, the async flags' copy, the sync
# redo's repair of the queued frame, and the mesh (with the axis its shares
# split over) that JAX's shard_map implies
PORT_ONLY = {"device", "generator", "rnd", "on_flags", "return_repair",
             "mesh", "axis"}

# qualified names (relative to the package) that deliberately differ:
# JAX machinery with no torch meaning
ALLOWED = {
    "ops.refine.expand_voxels":
        "JAX's threefry `key` becomes a torch `generator` and the draws `rnd`",
    "ops.refine.get_more_samples":
        "JAX's threefry `key` becomes a torch `generator` and the draws `rnd`",
    "ops.refine.expand_voxels_jit":
        "JAX's threefry `key` becomes a torch `generator` and the draws `rnd`",
    "utils.tuning.device_tuning":
        "takes a torch device, not a TPU kind string",
    "parallel.multihost.initialize":
        "JAX's `**kw` go to jax.distributed; the port takes a backend and "
        "a device",
    "parallel.render.segmented_shard_body":
        "a shard_map body: one process per device lays out its rank's "
        "inputs otherwise",
    "ops.accel.dyn_knobs":
        "JAX's knobs as traced values; the port compiles nothing per value",
    "ops.accel.normalize_static":
        "JAX's knobs as traced values; the port compiles nothing per value",
    "ops.pallas_march":
        "Pallas module: the port's prepass kernel is ops/skip_prepass.py",
    "ops.pallas_composite":
        "Pallas module: the port's compositors are ops/compact_composite.py "
        "and ops/padded_composite.py",
    "utils.profiling.FrameStats":
        "the port's spans and counters take its place (recorded(), and "
        "trace()'s JSON lines)",
    "utils.profiling.annotate":
        "the port's span takes attributes (`frame=`, the Viewer's `path`)",
}


def _jax_modules():
    names = [JPKG]
    names += [m.name for m in pkgutil.walk_packages(J.__path__, JPKG + ".")]
    return sorted(n[len(JPKG) + 1:] for n in names)


MODULES = _jax_modules()


def _module(pkg, rel):
    return importlib.import_module(f"{pkg}.{rel}" if rel else pkg)


def _params(f):
    return list(inspect.signature(f).parameters)


def _kind(cls, name):
    attr = inspect.getattr_static(cls, name)
    if isinstance(attr, staticmethod):
        return "static"
    if isinstance(attr, classmethod):
        return "class"
    if inspect.isfunction(attr):
        return "instance"
    return "other"


def _public(mod, rel):
    """(qualified name, JAX callable, method kind or None) of each public
    function and public method of a public class defined in the JAX module
    ``mod``."""
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) \
                != mod.__name__:
            continue
        q = f"{rel}.{name}" if rel else name
        if inspect.isclass(obj):
            for mn, mo in vars(obj).items():
                if mn.startswith("_") and mn != "__init__":
                    continue
                if inspect.isfunction(mo) or isinstance(
                        mo, (staticmethod, classmethod)):
                    out.append((f"{q}.{mn}", getattr(obj, mn),
                                _kind(obj, mn)))
        elif inspect.isfunction(obj) or (callable(obj)
                                         and hasattr(obj, "__wrapped__")):
            out.append((q, obj, None))
    return out


def _port_of(q):
    """The port's object for the qualified name ``q``, or None."""
    parts = q.split(".")
    for i in range(len(parts), -1, -1):
        try:
            obj = _module(PPKG, ".".join(parts[:i]))
        except ImportError:
            continue
        for p in parts[i:]:
            obj = getattr(obj, p, None)
            if obj is None:
                return None
        return obj
    return None


def _mismatch(q, jobj, kind):
    """Why the port's counterpart of ``q`` differs, or None."""
    pobj = _port_of(q)
    if pobj is None:
        return "missing in the port"
    if kind is not None:
        pcls = _port_of(q.rsplit(".", 1)[0])
        name = q.rsplit(".", 1)[1]
        pkind = _kind(pcls, name)
        if pkind != kind:
            # a descriptor that answers on the class and on an instance
            # (Viewer.get_backend: JAX's staticmethod)
            if not (pkind == "other" and kind == "static"
                    and _params(getattr(pcls, name)) == _params(jobj)):
                return f"method kind {pkind}, JAX {kind}"
    jp, pp = _params(jobj), _params(pobj)
    if pp[:len(jp)] != jp:
        return f"parameters {pp}, JAX {jp}"
    extra = set(pp[len(jp):]) - PORT_ONLY
    if extra:
        return f"port-only parameters {sorted(extra)} not in PORT_ONLY"
    return None


@pytest.mark.parametrize("rel", [m for m in MODULES if m not in ALLOWED])
def test_module_matches_jax(rel):
    jm = _module(JPKG, rel)
    pm = _module(PPKG, rel)
    jall = getattr(jm, "__all__", None)
    if jall is not None:
        missing = [n for n in jall if not hasattr(pm, n)]
        assert not missing, f"{rel}: {missing} missing in the port"
        assert set(getattr(pm, "__all__", ())) == set(jall), rel
    faults = {}
    for q, jobj, kind in _public(jm, rel):
        if q in ALLOWED or q.rsplit(".", 1)[0] in ALLOWED:
            continue
        why = _mismatch(q, jobj, kind)
        if why:
            faults[q] = why
    assert not faults, faults


@pytest.mark.parametrize("q", sorted(ALLOWED))
def test_allowed_entry_still_differs(q):
    """An ``ALLOWED`` entry that no longer differs must leave the list."""
    assert ALLOWED[q]
    if q in MODULES:
        with pytest.raises(ImportError):
            _module(PPKG, q)
        return
    rel, name = q.rsplit(".", 1)
    entry = [e for e in _public(_module(JPKG, rel), rel)
             if e[0] == q or e[0].rsplit(".", 1)[0] == q]
    assert entry, f"{q} is no longer public in the JAX package"
    assert any(_mismatch(*e) is not None for e in entry), \
        f"{q} no longer differs"


def test_ops_exports_jax_names():
    from mega_nerf_viewer_tpu_torch.ops import (  # noqa: F401
        DEFAULT_SEGMENTS, FastRenderResult, render_frame, oracle)
    import mega_nerf_viewer_tpu.ops as JO
    import mega_nerf_viewer_tpu_torch.ops as PO
    assert PO.__all__ == JO.__all__
    assert PO.oracle.trace_ray is not None
    assert render_frame is PR.render_frame


def test_composite_background_positional_rgb():
    """JAX's third parameter is ``bg_rgb``: a positional [R, 3] colour."""
    rng = np.random.RandomState(0)
    out = rng.uniform(-0.1, 1.1, size=(300, 4)).astype(np.float32)
    rgb = rng.uniform(0, 1, size=(300, 3)).astype(np.float32)
    want = np.asarray(JR.composite_background(
        jnp.asarray(out), RenderOptions(), jnp.asarray(rgb)))
    got = PR.composite_background(torch.as_tensor(out), P.RenderOptions(),
                                  torch.as_tensor(rgb)).numpy()
    assert float(np.abs(got - want).max()) <= 1e-6
    # and the fourth is the scalar background
    want = np.asarray(JR.composite_background(
        jnp.asarray(out), RenderOptions(), None, 0.25))
    got = PR.composite_background(torch.as_tensor(out), P.RenderOptions(),
                                  None, 0.25).numpy()
    assert float(np.abs(got - want).max()) <= 1e-6


@pytest.fixture(scope="module")
def scene():
    tree = P.sphere_tree(basis_dim=4, depth=4, device="cpu")
    cam = P.Camera(32, 24, 30.0)
    cam.center = np.array([-1.4, 0.1, 1.3], np.float32)
    cam._update()
    lm = P.build_leaf_map(tree)
    tab = P.build_skip_table(tree, 1e-2)
    return tree, lm, tab, cam, P.RenderOptions()


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_render_frame_fast_positional_order(scene):
    """JAX's positional order after ``order``: unroll, need_votes."""
    tree, lm, tab, cam, opt = scene
    order = PA.block_permutation(cam.width, cam.height, 8, device="cpu")
    pos = PA.render_frame_fast(tree, lm, cam, opt, 32, 256, 8, None, order,
                               4, False)
    kw = PA.render_frame_fast(tree, lm, cam, opt, max_dense=32,
                              chunk_size=256, block=8, order=order)
    assert len(pos) == 3 and _equal(pos, kw)
    votes = PA.render_frame_fast(tree, lm, cam, opt, 32, 256, 8, None,
                                 order, 1, True, False, True)
    assert len(votes) == 6                  # img, ov, steps, sv, pv, nrec
    assert _equal(votes[:3], kw)


def _knob_calls(scene):
    tree, lm, tab, cam, opt = scene
    order = PA.block_permutation(cam.width, cam.height, 8, device="cpu")
    dirs, cen = P.ops.screen2worlddir(
        cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy,
        torch.as_tensor(cam.transform, dtype=torch.float32))
    segs = ((0.5, 16), (0.5, 32))

    def rays(**kw):
        return PA.render_rays_fast(tree, lm, dirs, dirs, cen, opt,
                                   max_dense=32, skip_table=tab, **kw)

    def fast(**kw):
        return PA.render_frame_fast(tree, lm, cam, opt, max_dense=32,
                                    chunk_size=256, order=order,
                                    skip_table=tab, **kw)

    def seg(**kw):
        return PA.render_frame_fast_segmented(
            tree, lm, cam, opt, order, segs, 256, skip_table=tab, **kw)

    def motion(**kw):
        return PA.render_frame_motion(tree, lm, cam, opt, order[0], segs,
                                      256, skip_table=tab, **kw)

    def comp(**kw):
        gt = P.sphere_tree(basis_dim=1, depth=3, device="cpu")
        model = P.MegaNeRFModel.synthetic(data_dim=4, n_clusters=4,
                                          need_viewdir=True, device="cpu")
        gopt = P.RenderOptions(max_guided_samples=8, need_viewdir=True)
        c = P.collect_and_query_fast(gt, P.build_leaf_map(gt), model, cam,
                                     gopt, chunk_size=256)
        return PG.composite_frame(gt, cam, gopt, c, **kw)

    return {
        "render_rays_fast.unroll": (rays, dict(unroll=4)),
        "render_frame_fast.unroll": (fast, dict(unroll=2)),
        "render_frame_fast.dynamic_knobs": (fast,
                                            dict(dynamic_knobs=True)),
        "render_frame_fast_segmented.unroll": (seg, dict(unroll=2)),
        "render_frame_fast_segmented.dynamic_knobs": (
            seg, dict(dynamic_knobs=True)),
        "render_frame_motion.unroll": (motion, dict(unroll=2)),
        "render_frame_motion.dynamic_knobs": (motion,
                                              dict(dynamic_knobs=True)),
        "composite_frame.use_pallas": (comp, dict(use_pallas=False)),
    }


@pytest.mark.parametrize("case", [
    "render_rays_fast.unroll", "render_frame_fast.unroll",
    "render_frame_fast.dynamic_knobs", "render_frame_fast_segmented.unroll",
    "render_frame_fast_segmented.dynamic_knobs",
    "render_frame_motion.unroll", "render_frame_motion.dynamic_knobs",
    "composite_frame.use_pallas"])
def test_jax_only_knob_is_inert(scene, case):
    """JAX's compile knobs are accepted and change nothing."""
    fn, kw = _knob_calls(scene)[case]
    assert _equal(fn(**kw), fn())


def test_get_backend_on_class_and_instance():
    """JAX's ``Viewer.get_backend`` is a staticmethod; the port's answers
    the default device on the class and the viewer's on an instance."""
    assert P.Viewer.get_backend() == ("CUDA" if torch.cuda.is_available()
                                      else "CPU")
    assert P.Viewer(device="cpu").get_backend() == "CPU"
    assert J.Viewer.get_backend() == "CPU"


PARALLEL = r"""
import sys, torch
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu_torch import parallel
from mega_nerf_viewer_tpu_torch.models.meganerf import mlp_forward
import torch.distributed as dist
m = parallel.default_mesh(None, 1, device="cpu")
assert dist.get_world_size() == 1 and m.shape == {"rays": 1, "model": 1}
assert m.device == torch.device("cpu")
assert parallel.default_mesh(["cpu"], 1) is m        # JAX's device list
assert parallel.default_mesh(devices=["cpu"], model_parallel=1) is m
r = parallel.make_mesh((1,), (parallel.RAY_AXIS,), devices=["cpu"])
assert r.shape == {"rays": 1}
params = P.MegaNeRFModel.synthetic(data_dim=4, n_clusters=4, hidden=16,
                                   n_layers=4, device="cpu").params
local = parallel.tp_param_specs(params, m)
x = torch.randn(5, params.weights[0].shape[1], generator=torch.Generator()
                .manual_seed(0))
for call in (lambda: parallel.mlp_forward_tp(local, 1, x, "model"),
             lambda: parallel.mlp_forward_all_tp(local, torch.zeros(5), x,
                                                 "model")):
    try:
        call()
        sys.exit("a JAX positional call bound the axis to the mesh")
    except TypeError:
        pass
got = parallel.mlp_forward_tp(local, 1, x, "model", mesh=m)
assert torch.allclose(got, mlp_forward(params, 1, x), atol=1e-6)
ids = torch.tensor([0, 1, 1, 0, 1])
got = parallel.mlp_forward_all_tp(local, ids, x, parallel.MODEL_AXIS, mesh=m)
want = torch.stack([mlp_forward(params, int(c), x[i:i + 1])[0]
                    for i, c in enumerate(ids)])
assert torch.allclose(got, want, atol=1e-5)
t = {"a": torch.arange(4), "b": [torch.ones(2)]}
b = parallel.multihost.broadcast(pytree=t)
assert torch.equal(b["a"], t["a"]) and torch.equal(b["b"][0], t["b"][0])
c = parallel.multihost.replicate(pytree=t, mesh=m)
assert torch.equal(c["a"], t["a"])
dist.destroy_process_group()
print("ok")
"""


def test_parallel_jax_calls():
    """``default_mesh(devices, model_parallel)``, JAX's device list,
    ``mlp_forward_tp``'s fourth parameter (the axis, with the mesh
    keyword-only), and ``broadcast``/``replicate``'s ``pytree``, in a
    world of one on the CPU in its own process."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-c", PARALLEL], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
