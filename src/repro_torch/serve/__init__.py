from .generate import generate, make_serve_step

__all__ = ["generate", "make_serve_step"]
