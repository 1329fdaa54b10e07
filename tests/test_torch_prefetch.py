"""The port's host loader against the JAX package, on the CPU: the native
host ops (data/_native) on both routes, PrefetchLoader, and
parallel/mesh.prefetch_to_device over a finite loader."""

import json
import threading

import numpy as np
import PIL.Image
import pytest
import torch

from ide3d_tpu.data import CameraLabeledDataset as JCameraLabeledDataset
from ide3d_tpu.data import PrefetchLoader as JPrefetchLoader
from ide3d_tpu.data import _native as JN
from ide3d_tpu_torch.data import CameraLabeledDataset, PrefetchLoader
from ide3d_tpu_torch.data import _native as N
from ide3d_tpu_torch.parallel.mesh import prefetch_to_device
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)
from torch_tmp import drop_tmp_path  # noqa: F401 (an autouse fixture)

NORM_ATOL = 1e-6  # tests/test_data.py's tolerance for normalize


@pytest.fixture(scope="module")
def toy_dataset(tmp_path_factory):
    """tests/test_data.py's toy set: 6 labelled 32² images with 19-class masks."""
    root = tmp_path_factory.mktemp("imgs")
    segroot = tmp_path_factory.mktemp("segs")
    rng = np.random.RandomState(0)
    labels = {}
    for i in range(6):
        name = f"img{i:08d}.png"
        PIL.Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)).save(root / name)
        PIL.Image.fromarray(rng.randint(0, 19, (32, 32), dtype=np.uint8)).save(segroot / name)
        lab = np.zeros(25, np.float32)
        lab[:16] = np.eye(4, dtype=np.float32).reshape(-1)
        lab[1] = 0.25
        lab[16:] = [4.2647, 0, 0.5, 0, 4.2647, 0.5, 0, 0, 1]
        labels[name] = lab.tolist()
    with open(root / "dataset.json", "w") as f:
        json.dump({"labels": list(labels.items())}, f)
    return str(root), str(segroot)


@pytest.fixture(params=["native", "numpy"])
def host_route(request, monkeypatch):
    """Runs a test on the C++ route and on the numpy route."""
    if request.param == "numpy":
        monkeypatch.setattr(N, "_lib", lambda: None)
    assert N.route() == request.param, N.build_error()
    return request.param


def test_host_ops_match_jax(host_route):
    """onehot_seg, normalize_img and batch_assemble against the JAX package's
    C++ host ops: one-hot exactly, flips included, ids 19 and 255 mapped to
    class 0 as JAX's C++ route maps them; normalize within 1e-6."""
    assert JN.get() is not None, f"the JAX package's C++ host ops did not build: {JN._build_error}"
    rng = np.random.RandomState(0)
    mask = rng.randint(0, 19, (24, 40)).astype(np.uint8)
    mask[0, :3] = [19, 255, 18]
    img = rng.randint(0, 256, (24, 40, 3)).astype(np.uint8)
    for flip in (False, True):
        oh = N.onehot_seg(mask, 19, flip=flip)
        assert oh.dtype == np.float32 and oh.shape == (24, 40, 19)
        np.testing.assert_array_equal(oh, JN.onehot_seg(mask, 19, flip=flip))
        ni = N.normalize_img(img, flip=flip)
        assert ni.dtype == np.float32 and np.isfinite(ni).all()
        np.testing.assert_allclose(ni, JN.normalize_img(img, flip=flip), atol=NORM_ATOL, rtol=0)
    oh = N.onehot_seg(mask, 19)
    assert (np.argmax(oh[0, :3], -1) == [0, 0, 18]).all()
    ib, sb = N.batch_assemble([img, img[::-1]], [mask, mask[::-1]], [0, 1])
    jb, jsb = JN.batch_assemble([img, np.ascontiguousarray(img[::-1])],
                                [mask, np.ascontiguousarray(mask[::-1])], [0, 1])
    np.testing.assert_allclose(ib, jb, atol=NORM_ATOL, rtol=0)
    np.testing.assert_array_equal(sb, jsb)
    ib, sb = N.batch_assemble([img], None, [1])
    assert sb is None
    np.testing.assert_array_equal(ib[0], N.normalize_img(img, flip=True))


def test_host_ops_routes_are_bit_equal():
    """The numpy route rounds as the C++ route does, and maps ids >= 19 as it
    does: a batch of three 64² samples, two flipped."""
    assert N.route() == "native", N.build_error()
    rng = np.random.RandomState(1)
    imgs = [rng.randint(0, 256, (64, 64, 3)).astype(np.uint8) for _ in range(3)]
    segs = [rng.randint(0, 256, (64, 64)).astype(np.uint8) for _ in range(3)]
    native = N.batch_assemble(imgs, segs, [0, 1, 1])
    plain = (np.stack([N._normalize_numpy(i, f) for i, f in zip(imgs, (0, 1, 1))]),
             np.stack([N._onehot_numpy(s, 19, f) for s, f in zip(segs, (0, 1, 1))]))
    for a, b in zip(native, plain):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("host_id", [0, 1])
def test_prefetch_loader_matches_jax(toy_dataset, host_route, host_id):
    """PrefetchLoader at one thread yields JAX's PrefetchLoader's batches on the
    same files and seed, each host of a 2-host split, across an epoch."""
    root, segroot = toy_dataset
    kw = dict(batch_size=4, seed=3, num_threads=1, prefetch=2, host_id=host_id, num_hosts=2)
    port = PrefetchLoader(CameraLabeledDataset(root, segroot, resolution=32, xflip=True), **kw)
    ref = JPrefetchLoader(JCameraLabeledDataset(root, segroot, resolution=32, xflip=True), **kw)
    try:
        for _ in range(4):  # 6 items a host: the second batch crosses the epoch
            got, want = next(port), next(ref)
            assert sorted(got) == sorted(want) == ["c", "img", "seg"]
            assert got["img"].shape == (4, 32, 32, 3) and got["seg"].shape == (4, 32, 32, 19)
            assert got["img"].dtype == got["seg"].dtype == got["c"].dtype == np.float32
            assert np.isfinite(got["img"]).all()
            np.testing.assert_allclose(got["img"], want["img"], atol=NORM_ATOL, rtol=0)
            np.testing.assert_array_equal(got["seg"], want["seg"])
            np.testing.assert_array_equal(got["c"], want["c"])
    finally:
        port.close()
        ref.close()
    assert not any(t.is_alive() for t in port._threads)


def test_prefetch_loader_raises_a_worker_error(toy_dataset):
    """A worker's error is raised by next(), not lost with its thread."""
    root, segroot = toy_dataset
    ds = CameraLabeledDataset(root, segroot, resolution=32)

    def broken(i):
        raise OSError(f"unreadable item {i}")

    ds.raw_item = broken
    loader = PrefetchLoader(ds, batch_size=2, num_threads=2)
    try:
        with pytest.raises(OSError, match="unreadable item"):
            next(loader)
    finally:
        loader.close()


def test_prefetch_to_device_ends_on_a_finite_loader():
    """Over a finite list of 2 batches, prefetch_to_device yields both and
    ends (JAX's hangs there), under a timeout of the test's own."""
    batches = [{"img": np.full((2, 4, 4, 3), i, np.uint8), "c": np.full((2, 25), i, np.float32)}
               for i in range(2)]
    got = []
    worker = threading.Thread(target=lambda: got.extend(prefetch_to_device(batches, "cpu")),
                              daemon=True)
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive(), "prefetch_to_device did not end on a finite loader"
    assert len(got) == 2
    for b, want in zip(got, batches):
        for k in want:
            assert isinstance(b[k], torch.Tensor)
            np.testing.assert_array_equal(b[k].numpy(), want[k])
