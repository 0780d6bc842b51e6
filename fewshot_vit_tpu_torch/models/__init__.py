"""Encoder zoo. Importing this package registers every encoder."""

from . import convnet4, deit, levit, lvvit, nest, resnet, resnet12, swin, visformer  # noqa: F401
from .common import global_avg_pool
from .convnet4 import ConvNet4
from .deit import VisionTransformer
from .levit import Levit
from .lvvit import LVViT
from .nest import Nest
from .quant import QuantConv, QuantDense, quantize_encoder_in_head
from .resnet import ResNet
from .resnet12 import ResNet12, ResNet12Drop
from .swin import SwinTransformer
from .visformer import Visformer

__all__ = ["ConvNet4", "LVViT", "Levit", "Nest", "QuantConv", "QuantDense", "ResNet",
           "ResNet12", "ResNet12Drop", "SwinTransformer", "VisionTransformer", "Visformer",
           "global_avg_pool", "quantize_encoder_in_head"]
