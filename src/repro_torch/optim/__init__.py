from .optimizers import (Optimizer, SGDState, apply_updates,
                         clip_by_global_norm, sgd)

__all__ = ["Optimizer", "SGDState", "apply_updates", "clip_by_global_norm",
           "sgd"]
