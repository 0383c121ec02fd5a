from .renderer import Renderer  # noqa: F401
