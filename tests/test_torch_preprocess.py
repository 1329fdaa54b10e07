"""Real-photo preprocessing in the port against the JAX package, on the CPU.

The port's data/preprocess.py (the pose math and the POS-aligned crop),
models/face_recon.py (Deep3DFaceRecon's ResNet-50), models/mtcnn.py (the
P-, R- and O-Net and the cascade), io.load_torch_state_dict and the
preprocess_in_the_wild and dataset_tool CLIs, each held to the JAX package on
the same inputs (made from a seed with numpy) and the same state dicts:
the pose math within 1e-6, the crops bit-equal, the nets within 1e-5 x
max(1, |output|) in fp32, values checked finite first.

The cascade is discontinuous (its thresholds 0.6 / 0.7 / 0.7, NMS, the
rounding of boxes), so it is compared only where no probability that meets a
threshold lies within 1e-4 of it; the test asserts that margin."""

import io
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import ide3d_tpu.data.preprocess as jpre
import ide3d_tpu.models.face_recon as jfr
import ide3d_tpu.models.mtcnn as jmt
import ide3d_tpu_torch.data.preprocess as tpre
import ide3d_tpu_torch.models.face_recon as tfr
import ide3d_tpu_torch.models.mtcnn as tmt
from ide3d_tpu_torch.io import load_torch_state_dict
from ide3d_tpu_torch.io.from_jax import load_jax_params
from test_mtcnn import onet_sd, pnet_sd, rnet_sd
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)
from torch_tmp import drop_tmp_path  # noqa: F401 (an autouse fixture)

NET_TOL = 1e-5


def _close(name, got, ref, tol=NET_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), f"{name}: non-finite values"
    assert got.shape == ref.shape, f"{name}: {got.shape} vs {ref.shape}"
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{name}: max abs err {err} > {tol} x {scale}"


def _face_layout(rs, size: int, frac: float = 0.35):
    """Five landmarks (y down) at a frontal FFHQ layout: the BFM standard
    landmarks scaled to `frac` of the image, jittered."""
    lm = jpre.LM3D_STD[:, :2] * (frac * size) + size / 2
    lm[:, 1] = size - 1 - lm[:, 1]
    return lm + rs.randn(5, 2) * 0.01 * size


# ------------------------------------------------------------------- pose math


def test_face_recon_to_pose_matches_jax():
    rs = np.random.RandomState(0)
    for _ in range(8):
        angle, trans = rs.randn(3) * 0.3, rs.randn(3) * 0.2
        want = jpre.face_recon_to_pose(angle, trans)
        got = tpre.face_recon_to_pose(angle, trans)
        _close("face_recon_to_pose", got, want, 1e-6)
        np.testing.assert_allclose(tpre.euler_to_rotation(angle), jpre.euler_to_rotation(angle),
                                   atol=1e-6)


def test_fix_pose_and_flip_yaw_match_jax():
    rs = np.random.RandomState(1)
    for _ in range(8):
        pose = jpre.face_recon_to_pose(rs.randn(3) * 0.3, rs.randn(3) * 0.2)
        for name in ("fix_pose", "fix_pose_orig", "flip_yaw"):
            _close(name, getattr(tpre, name)(pose), getattr(jpre, name)(pose), 1e-6)
    np.testing.assert_array_equal(tpre.fix_intrinsics(np.eye(3)), jpre.fix_intrinsics(np.eye(3)))


@pytest.mark.parametrize("mode,mirror", [("cor", False), ("orig", True)])
def test_make_dataset_labels_matches_jax(mode, mirror):
    rs = np.random.RandomState(2)
    cams = {f"img{i:05d}.png": {
        "pose": jpre.face_recon_to_pose(rs.randn(3) * 0.3, rs.randn(3) * 0.2).tolist(),
        "intrinsics": np.eye(3).tolist()} for i in range(4)}
    want = jpre.make_dataset_labels(cams, mode=mode, mirror=mirror)["labels"]
    got = tpre.make_dataset_labels(cams, mode=mode, mirror=mirror)["labels"]
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) == 4 * (1 + mirror)
    _close("labels", [v for _, v in got], [v for _, v in want], 1e-6)


def test_convert_face_recon_mats_matches_jax(tmp_path):
    """Deep3DFaceRecon .mat files (angle [1, 3], trans [1, 3]) -> cameras.json."""
    import scipy.io

    rs = np.random.RandomState(3)
    for i in range(3):
        scipy.io.savemat(str(tmp_path / f"p{i}.mat"),
                         {"angle": rs.randn(1, 3) * 0.3, "trans": rs.randn(1, 3) * 0.2})
    (tmp_path / "notes.txt").write_text("not a .mat")
    want = jpre.convert_face_recon_mats(str(tmp_path))
    got = tpre.convert_face_recon_mats(str(tmp_path), str(tmp_path / "cameras.json"))
    assert sorted(got) == sorted(want) == ["p0.jpg", "p1.jpg", "p2.jpg"]
    for k in want:
        _close(k, got[k]["pose"], want[k]["pose"], 1e-6)
        np.testing.assert_array_equal(got[k]["intrinsics"], want[k]["intrinsics"])
    assert json.load(open(tmp_path / "cameras.json")) == got


@pytest.mark.parametrize("size,kw", [
    (300, {}),  # the 512² training recrop (BICUBIC to scale, LANCZOS to 512)
    (257, dict(target_size=224.0, rescale_factor=102.0, center_crop_size=224, output_size=224)),
])
def test_align_crop_bit_equal(size, kw):
    rs = np.random.RandomState(4)
    img = rs.randint(0, 256, (size, size + 13, 3), np.uint8)
    lm = _face_layout(rs, size)
    got, want = tpre.align_crop(img, lm, **kw), jpre.align_crop(img, lm, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    lm68 = rs.rand(68, 2) * size  # the 68-point input reduces to the same 5
    np.testing.assert_array_equal(tpre.extract_5p(lm68), jpre.extract_5p(lm68))


# ------------------------------------------------------------------ FaceReconNet


def _face_recon_sd(seed: int = 0) -> dict:
    """A Deep3DFaceRecon-shaped state dict (torch layout, numpy) with BN
    statistics and the `num_batches_tracked` counters a real epoch_20.pth has;
    convs N(0, 1 / fan_in) so activations stay O(1) through the 50 layers."""
    rs = np.random.RandomState(seed)
    sd = {}
    for name, t in tfr.FaceReconNet().state_dict().items():
        shape, last = tuple(t.shape), name.rsplit(".", 1)[-1]
        if last == "weight" and len(shape) == 4:
            a = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif last == "running_var":
            a = 1.0 + 0.1 * np.abs(rs.randn(*shape))
        elif last == "weight":
            a = 1.0 + 0.1 * rs.randn(*shape)
        else:
            a = 0.1 * rs.randn(*shape)
        sd[name] = a.astype(np.float32)
        if last == "running_var":
            sd[name[: -len("running_var")] + "num_batches_tracked"] = np.array(7, np.int64)
    return sd


@pytest.fixture(scope="module")
def face_recon(tmp_path_factory):
    """(state dict, JAX coefficients at 64², the input) for one random state dict."""
    sd = _face_recon_sd()
    jnet, jparams = jfr.import_face_recon(sd)
    x = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    return sd, np.asarray(jax.jit(jnet)(jparams, jnp.asarray(x))), x


def test_face_recon_net_matches_jax(face_recon):
    sd, want, x = face_recon
    net = tfr.import_face_recon(sd, device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 257)
    _close("FaceReconNet 64²", got, want)
    groups = tfr.split_coeffs(torch.from_numpy(got))
    assert {k: v.shape[1] for k, v in groups.items()} == {
        "id": 80, "exp": 64, "tex": 80, "angle": 3, "gamma": 27, "trans": 3}
    _close("coeffs_to_pose_label", tfr.coeffs_to_pose_label(got),
           jfr.coeffs_to_pose_label(got), 1e-6)


@pytest.mark.parametrize("nesting", ["net_recon", "state_dict"])
def test_face_recon_file_through_the_reader(face_recon, tmp_path, nesting):
    """epoch_20.pth as torch.save writes it, nested as Deep3DFaceRecon's
    training checkpoint ({'net_recon': sd, ...}) or as {'state_dict': sd}:
    the port's reader unwraps it and the net computes the JAX coefficients."""
    sd, want, x = face_recon
    path = str(tmp_path / "epoch_20.pth")
    torch.save({nesting: {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 20}, path)
    read = load_torch_state_dict(path)
    assert sorted(read) == sorted(sd)
    net = tfr.import_face_recon(read, device="cpu")
    with torch.no_grad():
        _close("FaceReconNet from file", net(torch.from_numpy(x)).numpy(), want)
    # the same nesting handed to import_face_recon directly
    tfr.import_face_recon({"net_recon": {k: torch.from_numpy(v) for k, v in sd.items()}},
                          device="cpu")


def test_face_recon_init_is_seeded():
    a, b = tfr.FaceReconNet().init(3), tfr.FaceReconNet().init(3)
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    assert not torch.equal(a.backbone.conv1.weight, tfr.FaceReconNet().init(4).backbone.conv1.weight)


# ------------------------------------------------------------------------ MTCNN


@pytest.fixture(scope="module")
def mtcnn_sds():
    return {"pnet": {k: v.numpy() for k, v in pnet_sd().items()},
            "rnet": {k: v.numpy() for k, v in rnet_sd().items()},
            "onet": {k: v.numpy() for k, v in onet_sd().items()}}


@pytest.mark.parametrize("name,shape", [("pnet", (2, 21, 27, 3)), ("pnet", (1, 64, 80, 3)),
                                        ("rnet", (3, 24, 24, 3)), ("onet", (2, 48, 48, 3))])
def test_mtcnn_nets_match_jax(mtcnn_sds, tmp_path, name, shape):
    """Each net on the JAX test's state dicts, read back from torch.save files
    by the port's reader; odd P-Net inputs exercise the ceil-mode pools."""
    jparams = jmt.import_mtcnn(*(mtcnn_sds[n] for n in ("pnet", "rnet", "onet")))[name]
    path = str(tmp_path / f"{name}.pt")
    torch.save({k: torch.from_numpy(v) for k, v in mtcnn_sds[name].items()}, path)
    sds = {n: mtcnn_sds[n] for n in ("pnet", "rnet", "onet")}
    sds[name] = load_torch_state_dict(path)
    net = tmt.import_mtcnn(sds["pnet"], sds["rnet"], sds["onet"], device="cpu")[name]
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    want = {"pnet": jmt.PNet(), "rnet": jmt.RNet(), "onet": jmt.ONet()}[name](jparams, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(f"{name} output {i}", g.numpy(), np.asarray(w))


def test_mtcnn_init_shapes_and_seed():
    nets = tmt.init(0, device="cpu")
    with torch.no_grad():
        probs, reg = nets["pnet"](torch.zeros(1, 12, 12, 3))
        assert probs.shape == (1, 1, 1, 2) and reg.shape == (1, 1, 1, 4)
        probs, reg = nets["rnet"](torch.zeros(1, 24, 24, 3))
        assert probs.shape == (1, 2) and reg.shape == (1, 4)
        probs, reg, lmk = nets["onet"](torch.zeros(1, 48, 48, 3))
        assert probs.shape == (1, 2) and reg.shape == (1, 4) and lmk.shape == (1, 10)
    again = tmt.init(0, device="cpu")
    for n in nets:
        for (k, v), w in zip(nets[n].state_dict().items(), again[n].state_dict().values()):
            assert torch.equal(v, w), (n, k)
    assert float(nets["pnet"].prelu1.weight[0]) == 0.25


def test_mtcnn_box_functions_match_jax():
    rs = np.random.RandomState(7)
    xy = rs.rand(40, 2) * 60
    wh = rs.rand(40, 2) * 30 + 2
    boxes = np.concatenate([xy, xy + wh, rs.rand(40, 1)], axis=1).astype(np.float32)
    for method in ("union", "min"):
        for thr in (0.3, 0.5, 0.7):
            np.testing.assert_array_equal(tmt.nms(boxes, thr, method), jmt.nms(boxes, thr, method))
    assert len(tmt.nms(np.zeros((0, 5), np.float32), 0.5)) == 0
    np.testing.assert_array_equal(tmt.rerec(boxes), jmt.rerec(boxes))
    reg = (rs.randn(40, 4) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(tmt.apply_regression(boxes, reg), jmt.apply_regression(boxes, reg))
    probs = rs.rand(9, 11).astype(np.float32)
    preg = (rs.randn(9, 11, 4) * 0.1).astype(np.float32)
    for scale, thr in ((0.6, 0.6), (0.3, 0.9), (0.5, 1.1)):
        np.testing.assert_array_equal(tmt.generate_bounding_boxes(probs, preg, scale, thr),
                                      jmt.generate_bounding_boxes(probs, preg, scale, thr))


def test_mtcnn_crop_resize_matches_jax():
    """Box crops zero-padded at the borders, shrunk (antialiased) and enlarged
    to 24² and 48²; a box wholly outside the image gives zeros."""
    rs = np.random.RandomState(8)
    img = (rs.rand(40, 50, 3).astype(np.float32) - 0.5) * 2
    boxes = np.array([[3, 4, 30, 31, 0.9], [-6, -3, 20, 23, 0.8], [30.4, 20.6, 60.2, 50.4, 0.7],
                      [10, 10, 17, 17, 0.6], [70, 70, 90, 90, 0.5]], np.float32)
    for size in (24, 48):
        want = jmt._crop_resize(img, boxes, size)
        got = tmt._crop_resize(torch.from_numpy(img), boxes, size).numpy()
        _close(f"crop_resize {size}", got, want)
        assert not got[-1].any()
    # a box its regression turned inside out: the port crops nothing (zeros),
    # where the JAX function raises (ROADMAP Queue 3)
    flipped = np.array([[20, 20, 12, 30, 0.9]], np.float32)
    with pytest.raises(ValueError):
        jmt._crop_resize(img, flipped, 24)
    assert not tmt._crop_resize(torch.from_numpy(img), flipped, 24).any()


@pytest.fixture(scope="module")
def detector_params():
    """The JAX test's random-init nets, the class logits biased toward 'face'
    ([-b, b] with b = 0.5, 1, 1) so that boxes pass all three stages."""
    key = jax.random.PRNGKey(0)
    p = jax.tree_util.tree_map(np.array, {"pnet": jmt.PNet().init(key), "rnet": jmt.RNet().init(key),
                                          "onet": jmt.ONet().init(key)})
    for net, head, b in (("pnet", "conv4_1", 0.5), ("rnet", "dense5_1", 1.0), ("onet", "dense6_1", 1.0)):
        p[net][head]["bias"] = np.array([-b, b], np.float32)
    return p


def test_detect_faces_matches_jax(detector_params, tmp_path):
    """The JAX test's 64x80 image through both cascades: the same boxes and
    confidences (1e-5) and keypoints (1e-4 px), after asserting that no
    probability the port's nets give lies within 1e-4 of its threshold. At
    min_face_size 40 (two pyramid levels): the JAX cascade compiles a resize
    for each distinct box size, ~20 s at the default 20."""
    img = (np.random.RandomState(0).rand(64, 80, 3) * 255).astype(np.uint8)
    want = jmt.MTCNN(params=detector_params, min_face_size=40).detect_faces(img)
    nets = {n: load_jax_params(cls(), detector_params[n]).eval()
            for n, cls in (("pnet", tmt.PNet), ("rnet", tmt.RNet), ("onet", tmt.ONet))}
    seen = {n: [] for n in nets}
    for n, net in nets.items():
        net.register_forward_hook(lambda m, i, out, n=n: seen[n].append(out[0][..., 1].flatten()))
    got = tmt.MTCNN(nets, min_face_size=40).detect_faces(img)
    for n, t in zip(("pnet", "rnet", "onet"), (0.6, 0.7, 0.7)):
        probs = torch.cat(seen[n]).numpy()
        assert probs.size and (probs >= t).any(), n
        margin = float(np.abs(probs - t).min())
        assert margin > 1e-4, f"{n}: a probability lies {margin} from the threshold {t}"
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == {"box", "confidence", "keypoints"} and g["box"] == w["box"]
        assert abs(g["confidence"] - w["confidence"]) <= 1e-5
        assert list(g["keypoints"]) == list(tmt.KEYPOINT_NAMES)
        _close("keypoints", list(g["keypoints"].values()), list(w["keypoints"].values()), 1e-4)
    # write_detection: the biggest face, five 'x y' lines
    path = str(tmp_path / "det.txt")
    assert tmt.write_detection(got, path, min_confidence=0.5)
    assert np.loadtxt(path).shape == (5, 2)
    assert not tmt.write_detection(got, path, min_confidence=0.999)
    assert not tmt.write_detection([], path)


# -------------------------------------------------------------------------- CLIs


def _write_photos(root, n: int, size: int) -> list:
    """n photos and, for all but the last, cached detections at a frontal
    layout; the last goes through the cascade (random nets find no face)."""
    rs = np.random.RandomState(9)
    names = []
    for i in range(n):
        name = f"photo{i}"
        PIL.Image.fromarray(rs.randint(0, 256, (size, size, 3), np.uint8)).save(
            os.path.join(root, name + (".png" if i % 2 else ".jpg")), quality=95)
        if i < n - 1:
            os.makedirs(os.path.join(root, "detections"), exist_ok=True)
            np.savetxt(os.path.join(root, "detections", name + ".txt"), _face_layout(rs, size))
        names.append(name)
    return names


def test_preprocess_in_the_wild_matches_jax(tmp_path):
    """Both CLIs on copies of one folder, with the same pnet/rnet/onet.pt and
    epoch_20.pth files (the MTCNN nets from the port's init(0)): the same
    crops (bit-equal) and dataset.json labels (1e-5); the uncached photo is
    skipped by both. The checkpoint is a flat
    state dict: the JAX CLI's reader does not unwrap {'net_recon': sd} (the
    port's does: test_face_recon_file_through_the_reader)."""
    from ide3d_tpu.apps import preprocess_in_the_wild as jcli
    from ide3d_tpu_torch.apps import preprocess_in_the_wild as tcli

    weights = tmp_path / "weights"
    weights.mkdir()
    for name, net in tmt.init(0, device="cpu").items():
        torch.save(net.state_dict(), str(weights / f"{name}.pt"))
    recon = str(weights / "epoch_20.pth")
    torch.save({k: torch.from_numpy(v) for k, v in _face_recon_sd(1).items()}, recon)
    dirs = {}
    for key in ("jax", "port"):
        dirs[key] = str(tmp_path / key)
        os.makedirs(dirs[key])
        names = _write_photos(dirs[key], 2, 96)
    common = ["--mtcnn", str(weights), "--face-recon", recon]
    jcli.main(["--indir", dirs["jax"]] + common)
    tcli.main(["--indir", dirs["port"], "--device", "cpu"] + common)

    js, ts = (json.load(open(os.path.join(dirs[k], "crop", "dataset.json"))) for k in ("jax", "port"))
    assert [n for n, _ in ts["labels"]] == [n for n, _ in js["labels"]] == [
        f"{n}.png" for n in names[:-1]]
    _close("labels", [v for _, v in ts["labels"]], [v for _, v in js["labels"]])
    for n in names[:-1]:
        got, want = (np.asarray(PIL.Image.open(os.path.join(dirs[k], "crop", n + ".png")))
                     for k in ("port", "jax"))
        assert got.shape == (512, 512, 3)
        np.testing.assert_array_equal(got, want)
    assert not os.path.exists(os.path.join(dirs["port"], "detections", names[-1] + ".txt"))


def test_dataset_tool_matches_jax(tmp_path):
    """Both CLIs on one folder with masks, labels and --mirror: the same zip
    entries and decoded arrays; the port's ImageFolderDataset reads it back."""
    from ide3d_tpu.apps import dataset_tool as jtool
    from ide3d_tpu_torch.apps import dataset_tool as ttool
    from ide3d_tpu_torch.data.dataset import ImageFolderDataset

    src, msk = tmp_path / "src", tmp_path / "msk"
    src.mkdir()
    msk.mkdir()
    rs = np.random.RandomState(10)
    labels = []
    for i in range(3):
        name = f"a{i}.png"
        PIL.Image.fromarray(rs.randint(0, 256, (40, 40, 3), np.uint8)).save(src / name)
        PIL.Image.fromarray(rs.randint(0, 19, (40, 40), np.uint8)).save(msk / name)
        pose = jpre.face_recon_to_pose(rs.randn(3) * 0.3, rs.randn(3) * 0.2)
        labels.append([name, np.concatenate([pose.reshape(-1), jpre.FFHQ_INTRINSICS_NORMALIZED.reshape(-1)]).tolist()])
    with open(src / "dataset.json", "w") as f:
        json.dump({"labels": labels}, f)
    for key, tool in (("jax", jtool), ("port", ttool)):
        tool.main(["--source", str(src), "--dest", str(tmp_path / f"{key}.zip"), "--resolution", "32",
                   "--masks", str(msk), "--mirror"])
    for suffix in (".zip", "_seg.zip"):
        with zipfile.ZipFile(tmp_path / f"jax{suffix}") as zj, zipfile.ZipFile(tmp_path / f"port{suffix}") as zt:
            assert zt.namelist() == zj.namelist()
            for n in zj.namelist():
                if n.endswith(".png"):
                    np.testing.assert_array_equal(np.asarray(PIL.Image.open(io.BytesIO(zt.read(n)))),
                                                  np.asarray(PIL.Image.open(io.BytesIO(zj.read(n)))))
                else:
                    assert json.loads(zt.read(n)) == json.loads(zj.read(n))
    ds = ImageFolderDataset(str(tmp_path / "port.zip"), seg_path=str(tmp_path / "port_seg.zip"),
                            resolution=32, load_seg=True)
    assert len(ds) == 6
    img, seg, label = ds[1]
    assert img.shape == (32, 32, 3) and label.shape == (25,) and np.isfinite(label).all()
    np.testing.assert_array_equal(np.asarray(img), np.asarray(ds[0][0])[:, ::-1])


def test_state_dict_reader_rejects_legacy_files_and_runs_no_code(tmp_path):
    """A pre-zip torch file raises ValueError; a file with an object whose
    unpickling would run code is read as data (the object becomes a stub)."""
    legacy = str(tmp_path / "legacy.pt")
    torch.save({"w": torch.ones(2)}, legacy, _use_new_zipfile_serialization=False)
    with pytest.raises(ValueError, match="not a torch.save zip file"):
        load_torch_state_dict(legacy)
    path = str(tmp_path / "mixed.pt")
    torch.save({"state_dict": {"w": torch.arange(3.0)}, "opts": _RunsCode()}, path)
    _CALLS.clear()
    sd = load_torch_state_dict(path)
    assert list(sd) == ["w"] and torch.equal(sd["w"], torch.arange(3.0)) and not _CALLS


_CALLS = []


def _record_call(*args):
    _CALLS.append(args)
    return args


class _RunsCode:
    def __reduce__(self):
        return (_record_call, ("ran",))


def test_preprocess_entry_points_reach_the_cpu_only_when_asked(monkeypatch):
    """preprocess_in_the_wild and the new loaders default to the card;
    nothing falls back to the CPU when it is missing."""
    import inspect

    from ide3d_tpu_torch.apps import preprocess_in_the_wild
    from ide3d_tpu_torch.io import tf_legacy, torch_import

    class _Stop(Exception):
        pass

    for fn in (tmt.init, tmt.import_mtcnn, tfr.import_face_recon, torch_import.load_network_pkl,
               tf_legacy.import_tf_generator, tf_legacy.import_tf_discriminator,
               tf_legacy.convert_tf_payload):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    seen = []

    def fake_import(*sds, device):
        seen.append(torch.device(device))
        raise _Stop

    monkeypatch.setattr(torch_import, "load_torch_state_dict", lambda path: {})
    monkeypatch.setattr(tmt, "import_mtcnn", fake_import)
    for extra, want in (([], "cuda"), (["--device", "cpu"], "cpu")):
        with pytest.raises(_Stop):
            preprocess_in_the_wild.main(["--indir", "x", "--mtcnn", "m", "--face-recon", "f",
                                         *extra])
        assert seen.pop() == torch.device(want)


# The trained-weight tools of tools/ and the port modules they import inside
# their functions (tests/test_torch_tools.py reads their import statements).
TOOL_IMPORTS = (
    "torch_import_and_verify", "torch_eval_trained_encoder", "torch_painter_trained_demo",
    "torch_trained_workflow", "ide3d_tpu_torch.apps.common", "ide3d_tpu_torch.apps.gen_images",
    "ide3d_tpu_torch.apps.calc_metrics", "ide3d_tpu_torch.apps.infer_hybrid_encoder",
    "ide3d_tpu_torch.apps.painter", "ide3d_tpu_torch.io.checkpoint",
    "ide3d_tpu_torch.io.torch_import", "ide3d_tpu_torch.metrics.features",
    "ide3d_tpu_torch.render.camera", "ide3d_tpu_torch.utils.seg",
    "ide3d_tpu_torch.data.dataset", "ide3d_tpu_torch.models.discriminator",
    "ide3d_tpu_torch.models.generator", "ide3d_tpu_torch.ops.ray_march",
    "ide3d_tpu_torch.render.renderer", "ide3d_tpu_torch.train.gan")


def test_new_modules_import_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, 'tools'); "
            "import ide3d_tpu_torch.apps.preprocess_in_the_wild, "
            "ide3d_tpu_torch.apps.dataset_tool, ide3d_tpu_torch.io.tf_legacy, "
            f"ide3d_tpu_torch.models.stylegan2, {', '.join(TOOL_IMPORTS)}; "
            "print('jax' in sys.modules, 'ide3d_tpu' in sys.modules)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip() == "False False"
