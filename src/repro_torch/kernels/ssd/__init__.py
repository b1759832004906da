from .kernel import ssd_chunked
from .ref import ssd_chunked_ref, ssd_ref

__all__ = ["ssd_chunked", "ssd_chunked_ref", "ssd_ref"]
