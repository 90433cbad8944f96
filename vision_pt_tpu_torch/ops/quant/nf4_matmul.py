"""Fused NF4/FP4 dequant-matmul (kernel #9): the port's counterpart of
``vision_pt_tpu/ops/quant/pallas_nf4.py``, whose Pallas TPU kernel
``dequant_matmul_4bit`` it replaces.

``y = x @ dequant(W)^T`` with W (out, in) stored transposed and
deinterleaved: ``packed_t`` (in//2, out) uint8 holds input row r in the high
nibble of byte (r, o) and row r + in/2 in its low nibble; ``absmax_t``
(in//64, out) fp32 holds the scales. For each 64-row chunk j the product of
``x[:, chunk]`` with the UNSCALED codebook values is taken in fp32, times
``absmax_t[j]``, and added to an fp32 accumulator; the result is rounded once
to x's dtype. With bf16 x the codebook values are bf16 (the JAX package's
``_code_i16`` bit patterns), with fp16 x they are the fp32 codebook rounded
to fp16 (the JAX kernel casts its fp32 table to x's dtype), with fp32 x they
are fp32.

On a CUDA tensor :func:`dequant_matmul_4bit` launches the kernel in
``csrc/nf4_matmul.cu`` or raises; on a CPU tensor it runs
:func:`dequant_matmul_4bit_reference`, which takes the chunks in the kernel's
order (j, j + in/128, j + 1, ...: the two chunks of one byte row in turn) so
that it repeats the kernel's sums, and which the tests hold against the JAX
kernel in interpret mode.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .nf4 import CODEBOOKS, unpack_4bit

BLOCK = 64  # bnb absmax blocksize; also the per-chunk contraction width

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
_fns: dict[str, ctypes._CFuncPtr] = {}


def repack_deinterleaved(packed_bnb: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """bnb pair-packed (n//2, 1) -> kernel layout (in//2, out) uint8 where
    high nibbles are input rows [0, in/2) and low nibbles rows [in/2, in)."""
    out_dim, in_dim = shape
    codes = unpack_4bit(packed_bnb).reshape(out_dim, in_dim)
    left = codes[:, : in_dim // 2]
    right = codes[:, in_dim // 2 :]
    return np.ascontiguousarray(((left << 4) | right).astype(np.uint8).T)


def repack_bnb(deint_t: np.ndarray) -> np.ndarray:
    """Inverse of :func:`repack_deinterleaved` -> (n//2, 1) uint8."""
    deint = np.asarray(deint_t).T  # (out, in//2)
    out_dim, half = deint.shape
    codes = np.empty((out_dim, half * 2), dtype=np.uint8)
    codes[:, :half] = deint >> 4
    codes[:, half:] = deint & 0x0F
    flat = codes.reshape(-1)
    return ((flat[0::2] << 4) | flat[1::2]).reshape(-1, 1)


def kernel_supported(in_dim: int, out_dim: int) -> bool:
    return in_dim % (2 * BLOCK) == 0 and out_dim % 8 == 0


def _codebook(quant_type: str, dtype: torch.dtype, device) -> torch.Tensor:
    """The codebook in the kernel's operand type, x's own (rounded to
    nearest even from fp32, as ``_code_i16`` and the JAX kernel's cast)."""
    return torch.from_numpy(CODEBOOKS[quant_type]).to(device).to(dtype)


def dequant_matmul_4bit_reference(x, packed_t, absmax_t, quant_type: str = "nf4"):
    """Plain PyTorch version of the kernel, chunk by chunk in its order."""
    lead, in_dim = x.shape[:-1], x.shape[-1]
    out_dim = packed_t.shape[1]
    x2 = x.reshape(-1, in_dim).float()
    code = _codebook(quant_type, x.dtype, x.device).float()
    p = packed_t.long()
    w = torch.cat([code[p >> 4], code[p & 0x0F]], dim=0)  # (in, out) unscaled
    scales = absmax_t.float()
    acc = torch.zeros(x2.shape[0], out_dim, dtype=torch.float32, device=x.device)
    half = in_dim // (2 * BLOCK)
    for row in range(half):
        for j in (row, row + half):
            chunk = slice(j * BLOCK, (j + 1) * BLOCK)
            acc += (x2[:, chunk] @ w[chunk]) * scales[j]
    return acc.to(x.dtype).reshape(*lead, out_dim)


def _kernel_fn():
    """The C entry point of ``csrc/nf4_matmul.cu``, built and bound at first
    use."""
    if "fwd" not in _fns:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        fn = _build.load("nf4_matmul").vpt_nf4_matmul
        fn.argtypes = [ptr, ptr, ptr, ptr, i, i, i, ptr, i, ptr]
        fn.restype = ctypes.c_int
        _fns["fwd"] = fn
    return _fns["fwd"]


def _aligned(t: torch.Tensor, align: int) -> torch.Tensor:
    """``t`` contiguous with its data ``align``-byte aligned (a copy only
    for a view that is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % align == 0 else t.clone()


def dequant_matmul_4bit(x, packed_t, absmax_t, quant_type: str = "nf4"):
    """y[..., out] = x @ dequant(W).T for x (..., in) bf16, fp16 or fp32. Launches
    the CUDA kernel for a CUDA tensor and raises if it cannot; a CPU tensor
    gets the plain version."""
    if x.device.type == "cpu":
        return dequant_matmul_4bit_reference(x, packed_t, absmax_t, quant_type)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    in_dim = x.shape[-1]
    half_in, out_dim = packed_t.shape
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype}: the kernel takes bfloat16, float16 "
                         "or float32")
    if packed_t.dtype != torch.uint8 or absmax_t.dtype != torch.float32:
        raise ValueError("packed_t must be uint8 and absmax_t float32")
    if 2 * half_in != in_dim or tuple(absmax_t.shape) != (in_dim // BLOCK, out_dim):
        raise ValueError(
            f"shapes x {tuple(x.shape)} packed_t {tuple(packed_t.shape)} "
            f"absmax_t {tuple(absmax_t.shape)} do not match"
        )
    if not kernel_supported(in_dim, out_dim):
        raise ValueError(f"in {in_dim} % 128 and out {out_dim} % 8 must be 0")
    if packed_t.device != x.device or absmax_t.device != x.device:
        raise ValueError("x, packed_t and absmax_t must be on one device")
    if quant_type not in CODEBOOKS:
        raise ValueError(f"unknown quant type {quant_type}")
    lead = x.shape[:-1]
    x2 = _aligned(x.reshape(-1, in_dim), 16)
    packed_t, absmax_t = _aligned(packed_t, 8), _aligned(absmax_t, 4)
    rows = x2.shape[0]
    out = torch.empty(rows, out_dim, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out.reshape(*lead, out_dim)
    lut = (ctypes.c_float * 16)(*CODEBOOKS[quant_type].tolist())
    rc = _kernel_fn()(
        x2.data_ptr(), packed_t.data_ptr(), absmax_t.data_ptr(), out.data_ptr(),
        rows, in_dim, out_dim, ctypes.cast(lut, ctypes.c_void_p),
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dequant_matmul_4bit kernel launch failed: {rc}")
    dequant_matmul_4bit.launches += 1
    return out.reshape(*lead, out_dim)


# launches of the CUDA kernel (not of the plain version) since the last reset
dequant_matmul_4bit.launches = 0
