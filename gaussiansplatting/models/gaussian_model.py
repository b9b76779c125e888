"""High-level model facade: the user-facing API of the framework.

The reference exposes everything through MTLEngine (mtl_engine.hpp:40-57:
init/loadGaussians/loadTrainingData/train/exportTrainingViews/getGaussians).
GaussianModel is the equivalent surface, minus windowing: construct from a
COLMAP scene or a 3DGS PLY, render any camera, train, checkpoint, export.

    model = GaussianModel.from_ply("scene.ply")
    img = model.render(camera)

    model = GaussianModel.from_colmap("scene/sparse/0")
    model.train(cameras, gt_images, epochs=155)
    model.save_ply("out.ply")
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from gaussiansplatting.config import Config
from gaussiansplatting.core.camera import Camera
from gaussiansplatting.core.gaussians import GaussianParams, from_arrays
from gaussiansplatting.train.state import TrainState


@dataclasses.dataclass
class GaussianModel:
    state: TrainState
    config: Config
    scene_extent: float = 1.0

    # ------------------------------------------------------------- creation

    @classmethod
    def from_params(
        cls, params: GaussianParams, config: Config | None = None,
        scene_extent: float = 1.0, seed: int = 0,
    ) -> "GaussianModel":
        from gaussiansplatting.train import state as state_mod

        return cls(
            state=state_mod.create(params, seed=seed),
            config=config or Config(),
            scene_extent=scene_extent,
        )

    @classmethod
    def from_ply(
        cls, path: str, config: Config | None = None, capacity: int | None = None
    ) -> "GaussianModel":
        from gaussiansplatting.io import ply as ply_mod

        cloud = ply_mod.load_gaussian_ply(path)
        params = from_arrays(
            cloud.means, cloud.log_scales, cloud.quats,
            cloud.raw_opacities, cloud.sh, capacity=capacity,
        )
        return cls.from_params(params, config)

    @classmethod
    def from_colmap(
        cls,
        colmap_dir: str,
        config: Config | None = None,
        capacity: int | None = None,
        knn_mode: str = "reference",
    ) -> "GaussianModel":
        """Initialize from SfM points exactly like the reference driver
        (gaussiansFromColmap, main.mm:59-187)."""
        from gaussiansplatting.io import colmap as colmap_mod
        from gaussiansplatting.io import init as init_mod

        cfg = config or Config()
        data = colmap_mod.load_colmap(colmap_dir)
        extent = colmap_mod.compute_scene_extent(data, cfg.init.extent_multiplier)
        cloud = init_mod.gaussians_from_points(
            data.points, data.point_colors, extent, cfg.init, knn_mode=knn_mode
        )
        params = from_arrays(
            cloud.means, cloud.log_scales, cloud.quats,
            cloud.raw_opacities, cloud.sh, capacity=capacity,
        )
        return cls.from_params(params, cfg, scene_extent=extent)

    @classmethod
    def from_checkpoint(cls, path: str) -> "GaussianModel":
        from gaussiansplatting.train import checkpoint as ckpt_mod

        state, cfg = ckpt_mod.load(path)
        return cls(state=state, config=cfg or Config())

    @classmethod
    def from_colmap_scene(
        cls, colmap_dir: str, images_dir: str,
        config: Config | None = None, downscale: int = 1,
        capacity: int | None = None,
    ) -> tuple["GaussianModel", list, list]:
        """One-call dataset + model assembly: returns (model, cameras,
        gt_images) ready for ``model.train(cameras, gt_images)``."""
        from gaussiansplatting.io.dataset import load_colmap_scene

        cfg = config or Config()
        scene = load_colmap_scene(
            colmap_dir, images_dir, cfg, downscale=downscale, capacity=capacity
        )
        model = cls.from_params(scene.params, cfg, scene_extent=scene.extent)
        return model, scene.cameras, scene.gt_images

    # ------------------------------------------------------------ inference

    @property
    def params(self) -> GaussianParams:
        return self.state.params

    @property
    def num_gaussians(self) -> int:
        return int(np.asarray(self.state.params.alive).sum())

    def render(self, camera: Camera) -> np.ndarray:
        """Render one view to a [H, W, 3] float32 array."""
        from gaussiansplatting.ops.rasterize import render as raster

        img, _ = jax.jit(raster, static_argnums=2)(
            self.state.params, camera, self.config.raster
        )
        return np.asarray(img)

    # ------------------------------------------------------------- training

    def train(
        self,
        cameras: list[Camera],
        gt_images: list,
        epochs: int | None = None,
        devices: int = 1,
        log_fn=None,
        metrics_fn=None,
    ) -> "GaussianModel":
        from gaussiansplatting.train import trainer

        self.state = trainer.train_loop(
            self.state, cameras, gt_images, self.config, self.scene_extent,
            num_epochs=epochs, log_fn=log_fn, metrics_fn=metrics_fn,
            mesh_devices=devices,
        )
        return self

    # ----------------------------------------------------------------- save

    def save_ply(self, path: str) -> int:
        from gaussiansplatting.io import ply as ply_mod

        return ply_mod.export_gaussian_ply(
            path, ply_mod.cloud_from_params(self.state.params)
        )

    def save_checkpoint(self, path: str) -> None:
        from gaussiansplatting.train import checkpoint as ckpt_mod

        ckpt_mod.save(path, self.state, self.config)
