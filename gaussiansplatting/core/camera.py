"""Camera model: COLMAP (OpenCV, +z forward) pinhole cameras.

Reproduces the reference's view/projection construction
(mtl_engine.mm:637-682) and intrinsics rescaling to the ground-truth image
size (mtl_engine.mm:874-917), as a jit-friendly pytree.
"""

from __future__ import annotations

from gaussiansplatting.core import pytree
import jax.numpy as jnp
import numpy as np

from gaussiansplatting.core.transforms import quat_to_rotmat


@pytree.dataclass
class Camera:
    """One training view.  Array fields are pytree leaves; width/height are
    static aux data so jitted renderers can use them for shapes."""

    view: jnp.ndarray        # [4,4] world-to-camera (x_cam = view @ [x_world,1])
    proj: jnp.ndarray        # [4,4] projection (clip = proj @ cam)
    viewproj: jnp.ndarray    # [4,4] proj @ view
    cam_pos: jnp.ndarray     # [3] camera center in world space (-R^T t)
    fx: jnp.ndarray          # scalar focal x (pixels, at render resolution)
    fy: jnp.ndarray
    width: int = pytree.static_field()    # static render resolution
    height: int = pytree.static_field()


def view_matrix(quat_wxyz, translation) -> np.ndarray:
    """World-to-camera matrix from a COLMAP image pose (mtl_engine.mm:637-660).
    COLMAP stores x_cam = R x_world + t with q = (w,x,y,z)."""
    R = np.asarray(quat_to_rotmat(jnp.asarray(quat_wxyz, jnp.float32)))
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = R
    view[:3, 3] = np.asarray(translation, np.float32)
    return view


def projection_matrix(fx, fy, cx, cy, width, height, near=0.1, far=1000.0) -> np.ndarray:
    """COLMAP-intrinsics projection with w = view_z (mtl_engine.mm:662-682).

    ndc_x = (2fx/w)(vx/vz) + 2cx/w - 1, so screen_x = fx*vx/vz + cx after the
    (ndc*0.5+0.5)*size viewport mapping (tiled_shaders.metal:150-153).
    """
    proj = np.zeros((4, 4), dtype=np.float32)
    proj[0, 0] = 2.0 * fx / width
    proj[1, 1] = 2.0 * fy / height
    proj[0, 2] = 2.0 * cx / width - 1.0
    proj[1, 2] = 2.0 * cy / height - 1.0
    proj[2, 2] = far / (far - near)
    proj[2, 3] = -(far * near) / (far - near)
    proj[3, 2] = 1.0
    return proj


def make_camera(
    quat_wxyz,
    translation,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    cam_width: int,
    cam_height: int,
    render_width: int | None = None,
    render_height: int | None = None,
    near: float = 0.1,
    far: float = 1000.0,
) -> Camera:
    """Build a Camera, rescaling intrinsics to the render resolution exactly
    like the reference scales them to the GT texture (mtl_engine.mm:874-917)."""
    rw = int(render_width if render_width is not None else cam_width)
    rh = int(render_height if render_height is not None else cam_height)
    sx = rw / float(cam_width)
    sy = rh / float(cam_height)
    sfx, sfy, scx, scy = fx * sx, fy * sy, cx * sx, cy * sy

    view = view_matrix(quat_wxyz, translation)
    proj = projection_matrix(sfx, sfy, scx, scy, rw, rh, near, far)
    viewproj = (proj @ view).astype(np.float32)
    cam_pos = (-view[:3, :3].T @ view[:3, 3]).astype(np.float32)
    return Camera(
        view=jnp.asarray(view),
        proj=jnp.asarray(proj),
        viewproj=jnp.asarray(viewproj),
        cam_pos=jnp.asarray(cam_pos),
        fx=jnp.float32(sfx),
        fy=jnp.float32(sfy),
        width=rw,
        height=rh,
    )


def look_at_view(eye, target, up=(0.0, -1.0, 0.0)) -> tuple[np.ndarray, np.ndarray]:
    """COLMAP-convention look-at pose: returns (R, t) with x_cam = R x + t,
    +z forward, +y down in the image (reference viewer: Camera::getViewMatrix,
    camera.cpp:28-40, which uses a left-handed look-at for the same effect).

    ``up`` is the world up direction; the default (0,-1,0) matches COLMAP
    scenes, whose world y axis usually points down.
    """
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)

    fwd = target - eye
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    down = -up - fwd * np.dot(-up, fwd)
    n = np.linalg.norm(down)
    if n < 1e-6:  # looking straight along up: pick any perpendicular
        down = np.cross(fwd, np.array([1.0, 0.0, 0.0], np.float32))
        down /= np.linalg.norm(down)
    else:
        down = down / n
    right = np.cross(down, fwd)

    R = np.stack([right, down, fwd]).astype(np.float32)
    t = (-R @ eye).astype(np.float32)
    return R, t


def orbit_camera(
    center,
    radius: float,
    azimuth: float,
    elevation: float,
    fx: float,
    fy: float,
    width: int,
    height: int,
    up=(0.0, -1.0, 0.0),
    near: float = 0.1,
    far: float = 1000.0,
) -> Camera:
    """Spherical-orbit camera around ``center`` (reference: the orbit viewer's
    Camera with theta/phi/radius state, camera.hpp/cpp).  Azimuth/elevation in
    radians; elevation 0 is the equator, positive toward ``up``."""
    center = np.asarray(center, np.float32)
    up_v = np.asarray(up, np.float32)
    up_v = up_v / np.linalg.norm(up_v)
    # build an orthonormal frame around up
    a = np.array([1.0, 0.0, 0.0], np.float32)
    if abs(np.dot(a, up_v)) > 0.9:
        a = np.array([0.0, 0.0, 1.0], np.float32)
    e1 = np.cross(up_v, a)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(up_v, e1)

    offset = radius * (
        np.cos(elevation) * (np.cos(azimuth) * e1 + np.sin(azimuth) * e2)
        + np.sin(elevation) * up_v
    )
    eye = center + offset
    R, t = look_at_view(eye, center, up_v)
    quat = rotmat_to_quat_wxyz(R)
    return make_camera(
        quat_wxyz=quat,
        translation=t,
        fx=fx,
        fy=fy,
        cx=width / 2.0,
        cy=height / 2.0,
        cam_width=width,
        cam_height=height,
        near=near,
        far=far,
    )


def rotmat_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), Shepperd's method."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z], np.float32)
    return q / np.linalg.norm(q)


def camera_world_position(quat_wxyz, translation) -> np.ndarray:
    """Camera center C = -R^T t (colmap_loader.cpp:200-230)."""
    v = view_matrix(quat_wxyz, translation)
    return (-v[:3, :3].T @ v[:3, 3]).astype(np.float32)


def scene_extent(cam_positions: np.ndarray, multiplier: float = 1.1) -> float:
    """'nerf_normalization' radius: multiplier * max camera distance from the
    camera centroid (colmap_loader.cpp:232-264)."""
    cam_positions = np.asarray(cam_positions, np.float32)
    centroid = cam_positions.mean(axis=0)
    dist = np.linalg.norm(cam_positions - centroid, axis=1)
    return float(dist.max() * multiplier)
