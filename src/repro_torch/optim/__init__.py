from . import adamw, compress  # noqa: F401
