from .datasets import ArrayDataset, mini_imagenet, synthetic
from .sampler import EpisodeSampler
from .transforms import MEAN, STD, normalize

__all__ = ["ArrayDataset", "EpisodeSampler", "MEAN", "STD", "mini_imagenet",
           "normalize", "synthetic"]
