"""The port's native data-path runtime (``mega_nerf_viewer_tpu_torch.native``,
``native/nerfview_native.cpp`` built with g++ at first use): the cases of
``tests/test_native.py`` against the port's own build, and the port's
loader against the JAX package's on the repo's fixtures (arrays equal)."""

import os

import numpy as np
import pytest

import mega_nerf_viewer_tpu.n3tree as J
import mega_nerf_viewer_tpu_torch as P
from mega_nerf_viewer_tpu.n3tree import tree as JT
from mega_nerf_viewer_tpu_torch import native
from mega_nerf_viewer_tpu_torch.n3tree import tree as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def test_built_from_source_into_the_checkout():
    assert native.available(), native.build_error()
    path = native.library_path()
    assert str(path).startswith(os.path.join(REPO, "build", "native"))
    assert path.exists() and native.SOURCE.name == "nerfview_native.cpp"
    assert "-march=native" not in native.CXX_FLAGS


def test_npz_parity_stored_and_deflate(tmp_path, rng):
    arrs = dict(
        f16=rng.randn(37, 8, 28).astype(np.float16),
        i32=rng.randint(-1000, 1000, (129, 3)).astype(np.int32),
        i64scalar=np.int64(42),
        f64=np.float64(0.125),
        u16=rng.randint(0, 65535, (4, 9)).astype(np.uint16),
        s=np.str_("SH16"),
    )
    for name, saver in [("s.npz", np.savez),
                        ("c.npz", np.savez_compressed)]:
        p = str(tmp_path / name)
        saver(p, **arrs)
        out = native.load_npz(p)
        got_np = np.load(p)
        for k in arrs:
            if k == "s":
                assert str(out[k]) == "SH16"
            else:
                np.testing.assert_array_equal(out[k], got_np[k])


def _vq_numpy(decode, npz, data_dim, n3, bug_compat, module, monkeypatch):
    """``decode`` on its numpy path (the native switch turned off)."""
    with monkeypatch.context() as m:
        m.setattr(module, "available", lambda: False)
        return decode(npz, data_dim, n3, bug_compat)


def test_vq_decode_parity(rng, monkeypatch):
    """The port's native decode equals its numpy decode and the JAX
    package's numpy decode, both index layouts."""
    from mega_nerf_viewer_tpu import native as jnative
    cap, n3 = 17, 8
    for n_basis_q, n_retain in [(1, 0), (2, 0), (2, 1)]:
        n_basis = n_basis_q + n_retain
        data_dim = 3 * n_basis + 1
        codebook = rng.randn(n_basis_q, 65536, 3).astype(np.float16)
        qmap = rng.randint(0, 65536, (n_basis_q, cap, n3)).astype(np.uint16)
        sigma = rng.rand(cap, n3).astype(np.float16)
        retained = (rng.randn(n_retain, cap, n3).astype(np.float16)
                    if n_retain else None)
        npz = dict(quant_colors=codebook, quant_map=qmap, sigma=sigma)
        if retained is not None:
            npz["data_retained"] = retained
        for bug_compat in (True, False):
            got = native.vq_decode(qmap, codebook, retained, sigma,
                                   data_dim, bug_compat=bug_compat)
            np.testing.assert_array_equal(
                PT._decode_vq(npz, data_dim, n3, bug_compat), got)
            np.testing.assert_array_equal(_vq_numpy(
                PT._decode_vq, npz, data_dim, n3, bug_compat, native,
                monkeypatch), got)
            np.testing.assert_array_equal(_vq_numpy(
                JT._decode_vq, npz, data_dim, n3, bug_compat, jnative,
                monkeypatch), got)


@pytest.mark.parametrize("name", ["digger_sh4.npz", "digger_vq.npz",
                                  "saved"])
def test_tree_open_uses_native(tmp_path, monkeypatch, name):
    """``N3Tree.open`` reads through the native loader (and VQ archives
    through the native decode); the arrays equal the JAX package's."""
    if name == "saved":
        path = str(tmp_path / "t.npz")
        J.sphere_tree(basis_dim=4, depth=3).save_npz(path)
    else:
        path = os.path.join(FIXTURES, name)
    calls = []
    load = native.load_npz
    monkeypatch.setattr(native, "load_npz",
                        lambda p: calls.append(p) or load(p))
    pt = P.N3Tree.open(path, device="cpu")
    jt = J.N3Tree.open(path)
    assert calls == [path]
    cap = int(jt.capacity)
    assert pt.capacity == cap
    for k in ("data", "child", "parent", "sample_counts"):
        np.testing.assert_array_equal(getattr(pt, k)[:cap].numpy(),
                                      np.asarray(getattr(jt, k))[:cap])
    assert str(pt.data_format) == str(jt.data_format)


def test_open_falls_back_to_numpy(tmp_path, monkeypatch):
    """Without the library the numpy path is the loader's behaviour."""
    path = os.path.join(FIXTURES, "digger_vq.npz")
    want = P.N3Tree.open(path, device="cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    got = P.N3Tree.open(path, device="cpu")
    for k in ("data", "child", "parent"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(want, k).numpy())


def test_argsort_counts_matches_numpy(rng):
    keys = rng.randint(0, 500, 100000).astype(np.int32)
    perm, inv = native.argsort_counts(keys)
    want = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(perm, want)
    np.testing.assert_array_equal(inv, np.argsort(want, kind="stable"))
    np.testing.assert_array_equal(perm[inv], np.arange(len(keys)))
    with pytest.raises(RuntimeError):
        native.argsort_counts(np.array([-1, 2], np.int32))


def test_corrupt_oversized_payload_fails_cleanly(tmp_path):
    """A member whose payload exceeds its npy geometry raises instead of
    overflowing the destination buffer."""
    p = str(tmp_path / "evil.npz")
    np.savez(p, big=np.arange(4096, dtype=np.int64))
    raw = bytearray(open(p, "rb").read())
    idx = raw.find(b"(4096,)")
    assert idx > 0
    raw[idx:idx + 7] = b"(16,)  "
    open(p, "wb").write(bytes(raw))
    with pytest.raises(RuntimeError):
        native.load_npz(p)


def test_truncated_archive_fails_cleanly(tmp_path, rng):
    p = tmp_path / "t.npz"
    np.savez_compressed(p, a=rng.randn(512, 16).astype(np.float32),
                        b=np.arange(4096, dtype=np.int32))
    raw = p.read_bytes()
    cut = p.with_suffix(".cut.npz")
    cut.write_bytes(raw[:1000] + raw[4000:])
    with pytest.raises(RuntimeError):
        native.load_npz(str(cut))


def test_vq_decode_validates_geometry(rng):
    qm = rng.randint(0, 10, (2, 4, 8)).astype(np.uint16)
    qc = rng.randn(2, 65536, 3).astype(np.float16)
    sg = rng.randn(4, 8).astype(np.float16)
    with pytest.raises(ValueError):
        native.vq_decode(qm, qc, None, sg, data_dim=4)   # needs >= 7
    with pytest.raises(ValueError):
        native.vq_decode(qm, qc[:, :100], None, sg, data_dim=7)


@pytest.mark.parametrize("compressed", [False, True])
def test_npz_fuzz_sizes_dtypes(tmp_path, rng, compressed):
    """Entry sizes straddling the 4096-byte header probe and odd shapes and
    dtypes, stored and deflated: every byte equal to numpy's."""
    arrays = {
        "empty": np.zeros((0, 3), np.float32),
        "one": np.float32([[3.25]]),
        "probe_minus": rng.randint(0, 255, 4000).astype(np.uint8),
        "probe_plus": rng.randn(600).astype(np.float64),
        "big": rng.randn(333, 77).astype(np.float32),
        "halfs": rng.randn(1000).astype(np.float16),
        "ints": rng.randint(-2**40, 2**40, (57, 3)).astype(np.int64),
        "bools": rng.rand(129) > 0.5,
        "fmt": np.str_("SH16"),
    }
    p = tmp_path / ("c.npz" if compressed else "s.npz")
    (np.savez_compressed if compressed else np.savez)(str(p), **arrays)
    got = native.load_npz(str(p))
    want = np.load(str(p))
    for k in arrays:
        if k == "fmt":
            assert str(got[k]) == "SH16"
            continue
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg=k)
