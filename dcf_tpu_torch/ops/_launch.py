"""The launch protocol shared by the kernels' wrappers.

A wrapper checks every tensor it hands a kernel (``check_u8``: uint8,
shape, device, contiguity and, on the card, alignment; ``check_words``
the same for packed int32 bit words), loads the kernel's
C entry point through ``_build.load`` and calls it on the device's current
stream through ``launch_checked``, which raises if the entry point
reports a CUDA error.  ``key_slices`` cuts a launch whose key index is
``gridDim.y`` (kernels B1-B6) into launches of at most 65,535 keys.
``launch_depths`` cuts a span of tree levels into launches of at most
``MAX_DEPTH`` levels (kernels B2, B5a and B6).
"""

from __future__ import annotations

import torch

from dcf_tpu_torch.errors import BackendUnavailableError, ShapeError

__all__ = ["MAX_DEPTH", "MAX_GRID_Y", "check_u8", "check_words",
           "key_slices", "launch_checked", "launch_depths"]

MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y
# Levels one launch of kernel B2 or B6 expands: the depths 1..3 that the
# switches of their C entry points (csrc/tree_expand.cu and
# csrc/evalall_expand.cu) instantiate.
MAX_DEPTH = 3


def check_u8(name: str, t: torch.Tensor, shape: tuple,
             device: torch.device, align: int = 1) -> None:
    """Raise ``ShapeError`` unless ``t`` is a contiguous uint8 tensor of
    ``shape`` on ``device`` (and, on the card, ``align``-byte aligned)."""
    _check(name, t, torch.uint8, shape, device, align)


def check_words(name: str, t: torch.Tensor, shape: tuple,
                device: torch.device) -> None:
    """``check_u8`` for packed bit words: a contiguous int32 tensor (the
    words' uint32 bit patterns) of ``shape`` on ``device``."""
    _check(name, t, torch.int32, shape, device, 4)


def _check(name, t, dtype, shape, device, align) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise ShapeError(
            f"{name} must be a {str(dtype).removeprefix('torch.')} tensor")
    if tuple(t.shape) != tuple(shape):
        raise ShapeError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if t.device != device:
        raise ShapeError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ShapeError(f"{name} must be contiguous")
    if device.type == "cuda" and t.data_ptr() % align:
        raise ShapeError(f"{name} must be {align}-byte aligned")


def launch_checked(name: str, fn, device: torch.device, *args) -> None:
    """Call a kernel's C entry point on ``device``'s current stream and
    raise if the launch reports a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise BackendUnavailableError(
            f"{name} launch failed with CUDA error {rc}")


def key_slices(k_num: int, limit: int = MAX_GRID_Y) -> list[tuple[int, int]]:
    """``(first key, keys)`` of consecutive slices of at most ``limit``
    keys that cover ``k_num`` keys in order: one launch each for a kernel
    whose key index is ``gridDim.y``, its key arrays offset by the first
    key's rows."""
    if limit < 1:
        raise ValueError(f"a slice holds at least one key, got {limit}")
    return [(k0, min(limit, k_num - k0)) for k0 in range(0, k_num, limit)]


def launch_depths(k0: int, k1: int,
                  most: int = MAX_DEPTH) -> list[tuple[int, int]]:
    """``(first level, depth)`` of the launches that expand levels
    k0..k1-1 (kernels B2 and B6; kernel B5a's with ``most=2``): ``most``
    levels each, the remainder in the first launch, so the large last
    levels always share one."""
    first = (k1 - k0) % most or most
    return [(k0, first)] + [(i, most) for i in range(k0 + first, k1, most)]
