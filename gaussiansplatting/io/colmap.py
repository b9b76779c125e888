"""COLMAP binary sparse-reconstruction parsers.

Format semantics follow the reference loader (colmap_loader.cpp:26-230):
cameras.bin / images.bin / points3D.bin little-endian records, camera models
pinhole(0)/pinhole-fxfy(1)/simple-radial(2)/radial(3)/opencv(4) with the same
parameter-count table (colmap_loader.cpp:14-23), quaternions kept (w,x,y,z).

A C++ fast path (native/gs_io.cpp) handles the variable-length record walks;
this module falls back to pure numpy/struct parsing when the native library is
unavailable.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from gaussiansplatting.core.camera import camera_world_position, scene_extent

_PARAM_COUNT = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8}  # colmap_loader.cpp:14-23


@dataclasses.dataclass
class ColmapCamera:
    id: int
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


@dataclasses.dataclass
class ColmapImage:
    id: int
    quat_wxyz: np.ndarray   # [4]
    translation: np.ndarray  # [3]
    camera_id: int
    name: str


@dataclasses.dataclass
class ColmapData:
    cameras: dict[int, ColmapCamera]
    images: list[ColmapImage]
    points: np.ndarray        # [N, 3] float32
    point_colors: np.ndarray  # [N, 3] float32 in [0, 1]
    point_errors: np.ndarray  # [N] float32


def load_cameras_bin(path: str) -> dict[int, ColmapCamera]:
    cameras: dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cam_id, model_id = struct.unpack("<Ii", f.read(8))
            width, height = struct.unpack("<QQ", f.read(16))
            n_params = _PARAM_COUNT.get(model_id, 4)
            params = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            if model_id in (0, 2, 3):
                fx = fy = params[0]
                cx, cy = params[1], params[2]
            else:
                fx, fy, cx, cy = params[0], params[1], params[2], params[3]
            cameras[cam_id] = ColmapCamera(
                id=cam_id, width=int(width), height=int(height),
                fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
            )
    return cameras


def load_images_bin(path: str) -> list[ColmapImage]:
    images: list[ColmapImage] = []
    with open(path, "rb") as f:
        data = f.read()
    (num,) = struct.unpack_from("<Q", data, 0)
    off = 8
    for _ in range(num):
        image_id = struct.unpack_from("<I", data, off)[0]
        off += 4
        qw, qx, qy, qz, tx, ty, tz = struct.unpack_from("<7d", data, off)
        off += 56
        camera_id = struct.unpack_from("<I", data, off)[0]
        off += 4
        end = data.index(b"\x00", off)
        name = data[off:end].decode("utf-8")
        off = end + 1
        (n_points2d,) = struct.unpack_from("<Q", data, off)
        off += 8 + int(n_points2d) * 24  # skip (x, y, point3D_id) records
        images.append(
            ColmapImage(
                id=image_id,
                quat_wxyz=np.array([qw, qx, qy, qz], np.float32),
                translation=np.array([tx, ty, tz], np.float32),
                camera_id=camera_id,
                name=name,
            )
        )
    return images


def load_points_bin(path: str):
    with open(path, "rb") as f:
        data = f.read()
    (num,) = struct.unpack_from("<Q", data, 0)
    num = int(num)
    positions = np.empty((num, 3), np.float32)
    colors = np.empty((num, 3), np.float32)
    errors = np.empty((num,), np.float32)
    off = 8
    for i in range(num):
        x, y, z = struct.unpack_from("<3d", data, off + 8)
        r, g, b = struct.unpack_from("<3B", data, off + 32)
        (err,) = struct.unpack_from("<d", data, off + 35)
        (track_len,) = struct.unpack_from("<Q", data, off + 43)
        positions[i] = (x, y, z)
        colors[i] = (r / 255.0, g / 255.0, b / 255.0)
        errors[i] = err
        off += 51 + int(track_len) * 8
    return positions, colors, errors


def load_colmap(path: str) -> ColmapData:
    """Load a COLMAP sparse dir (cameras.bin, images.bin, points3D.bin),
    using the native C++ parser when available."""
    from gaussiansplatting.io import native

    points = native.load_points_bin(os.path.join(path, "points3D.bin"))
    if points is None:
        points = load_points_bin(os.path.join(path, "points3D.bin"))
    positions, colors, errors = points
    return ColmapData(
        cameras=load_cameras_bin(os.path.join(path, "cameras.bin")),
        images=load_images_bin(os.path.join(path, "images.bin")),
        points=positions,
        point_colors=colors,
        point_errors=errors,
    )


def compute_scene_extent(data: ColmapData, multiplier: float = 1.1) -> float:
    """1.1 * max camera distance from the camera centroid
    (colmap_loader.cpp:232-264)."""
    cam_pos = np.stack(
        [camera_world_position(im.quat_wxyz, im.translation) for im in data.images]
    )
    return scene_extent(cam_pos, multiplier)
