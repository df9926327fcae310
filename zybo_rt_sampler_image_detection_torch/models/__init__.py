from . import yolo, nms, detect, sort, tracking, runner

__all__ = ["yolo", "nms", "detect", "sort", "tracking", "runner"]
