"""One module per manipulator shape, found by its lower-case name:
`sdf(params, pos, rot, p)`, `normal(params, pos, rot, p)` in world space
and `bounding_radius(params)`. A configuration with a new shape adds a
module here."""
import importlib


def shape_module(shape: str):
    return importlib.import_module(f"{__name__}.{shape.lower()}")
