"""The benchmark's generator copies against the repository's generators:
array-equal; the reference's SH basis against the port's."""

import numpy as np
import pytest
import torch

from perfbench import scenes
from perfbench.reference import render as ref


@pytest.mark.parametrize("basis_dim", (9, 16))
def test_shell_arrays_equal_shell_tree(basis_dim):
    import mega_nerf_viewer_tpu_torch as P
    t = P.shell_tree(depth=6, basis_dim=basis_dim, sigma_inside=400.0,
                     device="cpu")
    data, child, parent, depths = scenes.shell_arrays(
        depth=6, basis_dim=basis_dim, sigma_inside=400.0)
    cap = int(t.capacity)
    assert cap == data.shape[0]
    np.testing.assert_array_equal(t.data[:cap].numpy(), data)
    np.testing.assert_array_equal(t.child[:cap].numpy(), child)
    np.testing.assert_array_equal(t.parent[:cap].numpy(), parent)


def test_aerial_npz_equals_bench_torch_artifact(tmp_path):
    import bench_torch
    theirs = str(tmp_path / "theirs.npz")
    bench_torch.aerial_artifact(theirs, depth=8)
    spec = {"generator": "aerial_field", "depth": 8, "basis_dim": 4,
            "sigma": 120.0}
    ours, built = scenes.ensure_scene(str(tmp_path / "cache"), spec)
    assert built > 0
    with np.load(theirs) as a, np.load(ours) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # a second call finds the file
    assert scenes.ensure_scene(str(tmp_path / "cache"), spec) == (ours, 0.0)


def test_load_svox_reads_what_the_port_opens(tmp_path):
    import mega_nerf_viewer_tpu_torch as P
    spec = {"generator": "shell", "depth": 4, "basis_dim": 4,
            "radius": 0.35, "sigma": 40.0}
    path, _ = scenes.ensure_scene(str(tmp_path), spec)
    host = scenes.load_svox(path)
    t = P.N3Tree.open(path, device="cpu")
    np.testing.assert_array_equal(host["data"], t.data.numpy())
    np.testing.assert_array_equal(host["child"], t.child.numpy())
    np.testing.assert_array_equal(host["scale"], t.scale.numpy())
    np.testing.assert_array_equal(host["offset"], t.offset.numpy())
    assert host["basis_dim"] == 4


@pytest.mark.parametrize("basis_dim", (1, 4, 9, 16))
def test_reference_sh_basis_equals_the_ports(basis_dim):
    from mega_nerf_viewer_tpu_torch.ops.sh import eval_sh_basis
    g = torch.Generator().manual_seed(5)
    d = torch.randn(4096, 3, generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    torch.testing.assert_close(ref.sh_basis(basis_dim, d),
                               eval_sh_basis(basis_dim, d), rtol=0,
                               atol=1e-6)
