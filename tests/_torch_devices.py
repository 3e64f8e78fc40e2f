"""A tensor on a device the port's kernel routes do not take."""

import torch


class Elsewhere(torch.Tensor):
    """An f32 tensor of ``shape`` that says it lies on an XPU and holds no
    data: a kernel route must refuse it before any operation reaches it
    (CPU tensors take the plain versions, CUDA the kernels, meta the
    cost counter's route)."""

    @staticmethod
    def __new__(cls, *shape):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=torch.float32, device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} reached a tensor that holds no data")
