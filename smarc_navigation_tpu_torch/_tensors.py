"""Argument checks shared by the kernel wrappers: a kernel takes exactly
the device, dtype, shape and layout it was written for, and anything else
raises before a pointer reaches it."""

from __future__ import annotations

import ctypes

import torch


def check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t


def ptr(t) -> ctypes.c_void_p:
    """A tensor's data pointer for ctypes (NULL for None)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def device_index(device: torch.device) -> int:
    """The CUDA ordinal a kernel launch selects for a tensor's device."""
    return device.index if device.index is not None else torch.cuda.current_device()


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
