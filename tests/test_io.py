"""I/O tests: COLMAP binary parsing against hand-built fixtures, 3DGS PLY
round-trip, scale auto-detection, and point-cloud initialization."""

import struct

import numpy as np
import pytest

from gaussiansplatting.config import InitConfig
from gaussiansplatting.io import colmap, images, init, ply


# ---------- COLMAP fixtures ----------

def write_cameras_bin(path, cams):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam_id, model_id, w, h, params in cams:
            f.write(struct.pack("<Ii", cam_id, model_id))
            f.write(struct.pack("<QQ", w, h))
            f.write(struct.pack(f"<{len(params)}d", *params))


def write_images_bin(path, imgs):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for img_id, q, t, cam_id, name, n2d in imgs:
            f.write(struct.pack("<I", img_id))
            f.write(struct.pack("<7d", *q, *t))
            f.write(struct.pack("<I", cam_id))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", n2d))
            f.write(b"\x00" * (n2d * 24))


def write_points_bin(path, pts):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for pid, xyz, rgb, err, track in pts:
            f.write(struct.pack("<Q", pid))
            f.write(struct.pack("<3d", *xyz))
            f.write(struct.pack("<3B", *rgb))
            f.write(struct.pack("<d", err))
            f.write(struct.pack("<Q", track))
            f.write(b"\x00" * (track * 8))


@pytest.fixture
def colmap_dir(tmp_path, rng):
    write_cameras_bin(
        tmp_path / "cameras.bin",
        [
            (1, 1, 640, 480, [500.0, 510.0, 320.0, 240.0]),   # PINHOLE
            (2, 2, 800, 600, [450.0, 400.0, 300.0, 0.01]),    # SIMPLE_RADIAL (f,cx,cy,k)
        ],
    )
    q = np.array([0.9, 0.1, 0.2, 0.0])
    q /= np.linalg.norm(q)
    write_images_bin(
        tmp_path / "images.bin",
        [
            (1, list(q), [0.1, 0.2, 3.0], 1, "img_001.jpg", 5),
            (2, [1.0, 0, 0, 0], [0.0, 0.0, 4.0], 2, "img_002.jpg", 0),
        ],
    )
    pts = []
    for i in range(20):
        xyz = rng.uniform(-1, 1, 3)
        pts.append((i, list(xyz), [int(50 + i), 100, 200], 0.5, i % 4))
    write_points_bin(tmp_path / "points3D.bin", pts)
    return tmp_path


def test_colmap_loading(colmap_dir):
    data = colmap.load_colmap(str(colmap_dir))
    assert len(data.cameras) == 2
    cam1 = data.cameras[1]
    assert (cam1.fx, cam1.fy, cam1.cx, cam1.cy) == (500.0, 510.0, 320.0, 240.0)
    cam2 = data.cameras[2]
    assert cam2.fx == cam2.fy == 450.0  # SIMPLE_RADIAL: f, cx, cy
    assert (cam2.cx, cam2.cy) == (400.0, 300.0)

    assert len(data.images) == 2
    assert data.images[0].name == "img_001.jpg"
    assert data.images[0].camera_id == 1
    np.testing.assert_allclose(data.images[0].translation, [0.1, 0.2, 3.0], atol=1e-6)

    assert data.points.shape == (20, 3)
    np.testing.assert_allclose(data.point_colors[0], [50 / 255, 100 / 255, 200 / 255])
    np.testing.assert_allclose(data.point_errors, 0.5)


def test_scene_extent(colmap_dir):
    data = colmap.load_colmap(str(colmap_dir))
    extent = colmap.compute_scene_extent(data)
    # two cameras -> extent = 1.1 * half the distance between their centers
    from gaussiansplatting.core.camera import camera_world_position

    c1 = camera_world_position(data.images[0].quat_wxyz, data.images[0].translation)
    c2 = camera_world_position(data.images[1].quat_wxyz, data.images[1].translation)
    np.testing.assert_allclose(extent, 1.1 * np.linalg.norm(c1 - c2) / 2, rtol=1e-5)


# ---------- PLY ----------

def _random_cloud(rng, n=32):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return ply.GaussianCloud(
        means=rng.uniform(-2, 2, (n, 3)).astype(np.float32),
        log_scales=rng.uniform(-5, 1, (n, 3)).astype(np.float32),
        quats=q,
        raw_opacities=rng.uniform(-4, 4, (n,)).astype(np.float32),
        sh=rng.normal(size=(n, 4, 3)).astype(np.float32),
    )


def test_ply_roundtrip(tmp_path, rng):
    cloud = _random_cloud(rng)
    path = str(tmp_path / "out.ply")
    n = ply.export_gaussian_ply(path, cloud)
    assert n == 32
    back = ply.load_gaussian_ply(path)
    np.testing.assert_allclose(back.means, cloud.means, atol=1e-6)
    np.testing.assert_allclose(back.log_scales, cloud.log_scales, atol=1e-6)
    np.testing.assert_allclose(back.quats, cloud.quats, atol=1e-6)
    np.testing.assert_allclose(back.raw_opacities, cloud.raw_opacities, atol=1e-6)
    np.testing.assert_allclose(back.sh, cloud.sh, atol=1e-6)


def test_ply_skips_invalid_positions(tmp_path, rng):
    cloud = _random_cloud(rng, n=8)
    cloud.means[3, 0] = np.nan
    path = str(tmp_path / "bad.ply")
    n = ply.export_gaussian_ply(path, cloud)
    assert n == 7
    back = ply.load_gaussian_ply(path)
    assert back.means.shape[0] == 7


def test_ply_linear_scale_autodetect(tmp_path, rng):
    cloud = _random_cloud(rng, n=16)
    cloud.log_scales = rng.uniform(0.01, 0.9, (16, 3)).astype(np.float32)  # linear!
    path = str(tmp_path / "linear.ply")
    ply.export_gaussian_ply(path, cloud)
    back = ply.load_gaussian_ply(path)
    np.testing.assert_allclose(
        back.log_scales, np.log(cloud.log_scales), rtol=1e-5
    )


def test_cloud_from_params(rng):
    from gaussiansplatting.core import gaussians as G

    cloud = _random_cloud(rng, n=8)
    params = G.from_arrays(
        cloud.means, cloud.log_scales, cloud.quats, cloud.raw_opacities,
        cloud.sh, capacity=16,
    )
    back = ply.cloud_from_params(params)
    assert back.means.shape == (8, 3)
    np.testing.assert_allclose(back.means, cloud.means)


# ---------- init ----------

def test_init_small_cloud_knn(rng):
    pts = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    colors = rng.uniform(0, 1, (100, 3)).astype(np.float32)
    cloud = init.gaussians_from_points(pts, colors, scene_extent=2.0)
    assert cloud.means.shape == (100, 3)
    # isotropic log scales within the clamp range
    assert np.all(cloud.log_scales[:, 0] == cloud.log_scales[:, 1])
    lo = np.log(1e-4 * 2.0) - 1e-5
    hi = np.log(0.1 * 2.0) + 1e-5
    assert np.all(cloud.log_scales >= lo) and np.all(cloud.log_scales <= hi)
    # raw opacity 0, identity quats, DC from color
    np.testing.assert_allclose(cloud.raw_opacities, 0.0)
    np.testing.assert_allclose(cloud.quats[:, 0], 1.0)
    from gaussiansplatting.core.transforms import SH_C0

    np.testing.assert_allclose(
        cloud.sh[:, 0, :], (colors - 0.5) / SH_C0, rtol=1e-5
    )
    np.testing.assert_allclose(cloud.sh[:, 1:, :], 0.0)


def test_init_median_mode(rng):
    pts = rng.uniform(-1, 1, (12000, 3)).astype(np.float32)
    cfg = InitConfig()
    scales_ref = init.initial_scales(pts, cfg, knn_mode="reference")
    assert np.unique(scales_ref).size == 1  # one median for everyone
    scales_exact = init.initial_scales(pts, cfg, knn_mode="exact")
    assert np.unique(scales_exact).size > 100


def test_knn_mean_distance_exact():
    pts = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3.5, 0, 0]], np.float32)
    d = init.knn_mean_distances(pts, k=2)
    np.testing.assert_allclose(d, [1.5, 1.0, 1.25, 2.0], rtol=1e-6)


# ---------- images ----------

def test_image_roundtrip(tmp_path, rng):
    img = rng.uniform(0, 1, (16, 20, 3)).astype(np.float32)
    p = str(tmp_path / "t.png")
    images.save_png(p, img)
    back = images.load_image(p)
    assert back.shape == (16, 20, 3)
    np.testing.assert_allclose(back, img, atol=1 / 255 + 1e-6)
    # resize path
    back2 = images.load_image(p, target_size=(10, 8))
    assert back2.shape == (8, 10, 3)


def _png_bytes(rows, width, height, ctype):
    """Assemble a PNG from already-filtered scanlines (filter byte first)."""
    import zlib

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(rows)))
            + chunk(b"IEND", b""))


def _filter_rows(img, ftype):
    """Reference PNG filtering (spec section 9), one byte at a time."""
    h, stride = img.shape[0], img.shape[1] * img.shape[2]
    bpp = img.shape[2]
    flat = img.reshape(h, stride).astype(int)
    out = []
    prior = [0] * stride
    for r in range(h):
        cur = list(flat[r])
        out.append(ftype)
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((cur[i] - pred) % 256)
        prior = cur
    return out


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_png_decoder_reads_each_filter_type(rng, ftype):
    img = rng.integers(0, 256, (6, 11, 3), dtype=np.uint8)
    data = _png_bytes(_filter_rows(img, ftype), 11, 6, 2)
    np.testing.assert_array_equal(images.decode_png(data), img)


@pytest.mark.parametrize("width", [1, 7, 33])
@pytest.mark.parametrize("channels", [3, 4], ids=["rgb", "rgba"])
def test_png_encode_decode_roundtrip(tmp_path, rng, channels, width):
    img = rng.integers(0, 256, (5, width, channels), dtype=np.uint8)
    data = images.encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(images.decode_png(data), img)
    # load_image drops alpha and scales to [0, 1]
    p = tmp_path / "t.png"
    p.write_bytes(data)
    np.testing.assert_allclose(images.load_image(str(p)),
                               img[..., :3] / 255.0, atol=1e-7)


def test_non_png_without_pillow_names_pil(tmp_path, monkeypatch):
    import sys

    p = tmp_path / "view.jpg"
    p.write_bytes(b"\xff\xd8\xff\xe0 not decoded natively")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        images.load_image(str(p))


def test_ppm(tmp_path):
    img = np.zeros((4, 5, 3), np.float32)
    img[..., 0] = 1.0
    p = str(tmp_path / "t.ppm")
    images.save_ppm(p, img)
    with open(p, "rb") as f:
        data = f.read()
    assert data.startswith(b"P6\n5 4\n255\n")
    assert data[11:14] == b"\xff\x00\x00"


def test_find_image(tmp_path):
    (tmp_path / "a.JPG").write_bytes(b"")
    assert images.find_image(str(tmp_path), "a.jpg").endswith("a.JPG")
    assert images.find_image(str(tmp_path), "missing.jpg") is None


def test_ply_official_3dgs_deg3_layout(tmp_path, rng):
    """A PLY with 45 channel-major f_rest fields (official-3DGS export layout)
    loads the band-1 coefficients from each channel's leading entries."""
    import struct as _struct

    n = 4
    base = ["x", "y", "z", "scale_0", "scale_1", "scale_2",
            "rot_0", "rot_1", "rot_2", "rot_3", "opacity",
            "f_dc_0", "f_dc_1", "f_dc_2"]
    rest = [f"f_rest_{i}" for i in range(45)]
    fields = base + rest
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {f}\n" for f in fields)
        + "end_header\n"
    )
    rows = []
    for i in range(n):
        vals = {f: 0.0 for f in fields}
        vals.update({"x": float(i), "y": 0.0, "z": 4.0,
                     "scale_0": -2.0, "scale_1": -2.0, "scale_2": -2.0,
                     "rot_0": 1.0, "opacity": 0.5,
                     "f_dc_0": 0.1, "f_dc_1": 0.2, "f_dc_2": 0.3})
        # channel-major band-1: R coeffs at 0..2, G at 15..17, B at 30..32
        for ch in range(3):
            for c in range(3):
                vals[f"f_rest_{ch * 15 + c}"] = float(10 * ch + c + 1)
        rows.append(_struct.pack(f"<{len(fields)}f", *[vals[f] for f in fields]))
    path = tmp_path / "official.ply"
    path.write_bytes(header.encode() + b"".join(rows))

    from gaussiansplatting.io.ply import load_gaussian_ply

    cloud = load_gaussian_ply(str(path))
    assert cloud.sh.shape == (n, 4, 3)
    # band coefficient c (1-indexed), channel ch -> value 10*ch + (c-1) + 1
    for c in range(1, 4):
        for ch in range(3):
            np.testing.assert_allclose(cloud.sh[:, c, ch], 10 * ch + c)


def test_native_lib_matches_python(tmp_path, rng):
    """The C++ points parser and grid kNN agree with the pure-Python path
    (native/gs_io.cpp, built at first use; skipped only on a host with no
    C++ compiler)."""
    from gaussiansplatting.io import native

    if native.get_lib() is None:
        pytest.skip("no C++ compiler to build native/gs_io.cpp")

    pts = []
    coords = rng.uniform(-2, 2, (60, 3))
    for i in range(60):
        pts.append((i, list(map(float, coords[i])), [10, 20, 30], 0.25, 2))
    path = str(tmp_path / "points3D.bin")
    write_points_bin(path, pts)

    from gaussiansplatting.io import colmap as colmap_mod

    n_pos, n_col, n_err = native.load_points_bin(path)
    p_pos, p_col, p_err = colmap_mod.load_points_bin(path)
    np.testing.assert_allclose(n_pos, p_pos, atol=1e-6)
    np.testing.assert_allclose(n_col, p_col, atol=1e-6)
    np.testing.assert_allclose(n_err, p_err, atol=1e-6)

    from gaussiansplatting.io.init import knn_mean_distances

    nd = native.knn_mean_dist(np.asarray(coords, np.float32), k=3)
    pd = knn_mean_distances(np.asarray(coords, np.float32), k=3)
    np.testing.assert_allclose(nd, pd, rtol=1e-5)


def test_ply_malformed_inputs(tmp_path):
    """Malformed PLYs fail with clear errors, not crashes or garbage."""
    from gaussiansplatting.io.ply import load_gaussian_ply

    cases = {
        "not_ply.ply": b"solid nope\n",
        "truncated_header.ply": b"ply\nformat binary_little_endian 1.0\n",
        "missing_fields.ply": (
            b"ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"end_header\n" + b"\x00" * 12
        ),
    }
    for name, payload in cases.items():
        path = tmp_path / name
        path.write_bytes(payload)
        with pytest.raises(ValueError):
            load_gaussian_ply(str(path))


def test_ply_truncated_body(tmp_path, rng):
    """A body shorter than the header promises loads the complete rows only
    (or raises) — never reads out of bounds."""
    from gaussiansplatting.io.ply import load_gaussian_ply
    from gaussiansplatting.io.ply import export_gaussian_ply, GaussianCloud

    cloud = _random_cloud(rng, n=8)
    path = str(tmp_path / "full.ply")
    export_gaussian_ply(path, cloud)
    blob = open(path, "rb").read()
    trunc = tmp_path / "trunc.ply"
    trunc.write_bytes(blob[: len(blob) - 40])
    try:
        out = load_gaussian_ply(str(trunc))
        assert out.means.shape[0] <= 8
    except ValueError:
        pass
