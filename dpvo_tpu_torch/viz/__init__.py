"""The map viewer: ``Viewer`` (PNG snapshots from a render thread and an
interactive HTML map), ``dense.backproject_and_filter`` and
``html_map.export_html``."""
from .viewer import Viewer

__all__ = ["Viewer"]
