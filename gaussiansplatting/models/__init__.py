from gaussiansplatting.models.gaussian_model import GaussianModel

__all__ = ["GaussianModel"]
