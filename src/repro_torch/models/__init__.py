from .papertasks import (TASK_MODELS, TaskModel, make_task_model,
                         params_from_numpy, params_to_numpy)

__all__ = ["TASK_MODELS", "TaskModel", "make_task_model", "params_from_numpy",
           "params_to_numpy"]
