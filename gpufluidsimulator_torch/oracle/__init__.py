from . import numpy_ref  # noqa: F401
