from .elastic import FailureEvent, WorkerPool

__all__ = ["FailureEvent", "WorkerPool"]
