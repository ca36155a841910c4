"""Architecture configs (--arch <id>) and input shapes."""
from .registry import ARCHS, SHAPES, ShapeSpec, applicable, get_config  # noqa: F401
